"""Crops trained over the whole window over the window's seconds; a step
ends when its loss is on the host."""


def read(window):
    return sum(n for n, _ in window["units"]) / window["window_s"]
