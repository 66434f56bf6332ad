"""The 95th percentile, over every request of the window, of the time from
the request's call to its numpy result; the median and the count go to
stderr."""

import sys

import numpy as np


def read(window):
    ms = np.asarray([s for _, s in window["units"]]) * 1e3
    p95 = float(np.percentile(ms, 95))
    print(f"serve latency: median {float(np.median(ms))!r} ms, p95 {p95!r} ms, "
          f"{ms.size} requests", file=sys.stderr)
    return p95
