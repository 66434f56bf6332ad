"""Crops returned as numpy over the whole window over the window's
seconds."""


def read(window):
    return sum(n for n, _ in window["units"]) / window["window_s"]
