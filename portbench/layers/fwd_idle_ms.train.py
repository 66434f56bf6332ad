"""Device idle milliseconds a traced step inside the program's
``csvit.step.forward`` span: the step's forward (portbench.spans)."""

from portbench.spans import idle_ms


def read(t):
    return idle_ms(t, "csvit.step.forward")
