"""Device idle milliseconds a traced step inside the program's
``csvit.step.backward`` span, whatever thread launched the kernels around
it (portbench.spans)."""

from portbench.spans import idle_ms


def read(t):
    return idle_ms(t, "csvit.step.backward")
