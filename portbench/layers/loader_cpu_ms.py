"""CPU milliseconds a step of the threads beside the one that steps (the
loader's threads, its batching thread and the prefetch's copy thread), over
the window's steps: the data path's share of the host. The ``finetune``
traffic kind keeps it; elsewhere there is nothing to read."""


def read(t):
    return t.info.get("loader_cpu_ms")
