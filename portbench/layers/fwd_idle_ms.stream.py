"""Device idle milliseconds a traced request inside the program's
``csvit.serve.forward`` span: the session's forward (portbench.spans)."""

from portbench.spans import idle_ms


def read(t):
    return idle_ms(t, "csvit.serve.forward")
