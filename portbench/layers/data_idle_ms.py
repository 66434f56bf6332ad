"""Device idle milliseconds a traced step inside the program's
``csvit.data.wait`` span: the wait for the loader's next batch
(portbench.spans)."""

from portbench.spans import idle_ms


def read(t):
    return idle_ms(t, "csvit.data.wait")
