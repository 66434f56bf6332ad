"""Device idle milliseconds a traced request inside the program's
``csvit.serve.input`` span: padding and the copies to the card
(portbench.spans)."""

from portbench.spans import idle_ms


def read(t):
    return idle_ms(t, "csvit.serve.input")
