"""Device idle milliseconds a traced request inside the program's
``csvit.serve.output`` span: the copies to the host, which wait for the
forward (portbench.spans)."""

from portbench.spans import idle_ms


def read(t):
    return idle_ms(t, "csvit.serve.output")
