"""Device idle milliseconds a traced step inside the program's
``csvit.step.cast`` span: the masters' and the images' compute-dtype copies
(portbench.spans)."""

from portbench.spans import idle_ms


def read(t):
    return idle_ms(t, "csvit.step.cast")
