"""Device idle milliseconds a traced step inside the program's
``csvit.step.update`` span: the finite check, the clip, AdamW and the
statistics written back (portbench.spans)."""

from portbench.spans import idle_ms


def read(t):
    return idle_ms(t, "csvit.step.update")
