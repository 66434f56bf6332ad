"""Seconds from the start of the process to the window's start: the model
build, weights, calibration and warm-up (and, in a checkout's first run,
the kernels' build)."""


def read(window):
    return window["setup_s"]
