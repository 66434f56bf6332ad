"""The program's own spans on a traced run's clock: what the readers of the
``csvit.*`` metrics share.

The program (cs_vit_tpu_torch) opens ``csvit.*`` ranges while a profiler
records: each train step, its phases and its host syncs, and the phases of
each served chunk (``cs_vit_tpu_torch/utils/profiling.py`` lists them). A
span's intervals are those of its host events on every thread, merged. The
device's idle time in a span is the part of the traced units' idle time
(the units minus the union of kernel, copy and memset intervals) that falls
inside those intervals. It is attributed by time, not by thread:
autograd's device thread launches the backward's kernels while the calling
thread sits in ``csvit.step.backward``. A program without these spans gives
no intervals, and its readers return None.

The profiler draws host calls and device events on one timeline, but on
the H100 the device's clock drifts from the host's within some captures, at
up to a few per cent: kernels are drawn up to tens of milliseconds before
the host call that launched them. The launches themselves keep the host's
clock (each lies inside the host op that made it). So before it finds the
idle time, :func:`busy` puts each device event back on the host's clock
from the launch it came from: a kernel cannot start before its launch, and
one launched on an empty queue starts a few microseconds after it. The
offset at each launch is the lower envelope of the kernels' start minus
launch, with a slope of at most ``DRIFT``; where that envelope lies below
zero, the events are moved later by it. A capture whose kernels all start
after their launches is read as it was drawn.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from .tracing import SYNC_CALLS, Trace, _inside, _merge

SYNC = "csvit.sync."
# the fastest drift that the realignment follows, device microseconds a host
# microsecond; the H100's captures drift at up to about 0.035
DRIFT = 0.05

Intervals = List[Tuple[float, float]]


def intervals(t: Trace, match: Callable[[str], bool]) -> Intervals:
    """The merged intervals of the host events whose name `match`es, on
    every thread."""
    return _merge([(e["ts"], e["ts"] + e["dur"]) for e in t.host if match(e["name"])])


def offsets(launches: List[float], starts: List[float]) -> List[float]:
    """How far the device's clock runs ahead of the host's at each launch
    (sorted, host microseconds), from the device events' starts: the lower
    envelope of start minus launch with slope ``DRIFT``, where it is below
    zero, else 0."""
    env = [s - l for l, s in zip(launches, starts)]
    for i in range(1, len(env)):
        env[i] = min(env[i], env[i - 1] + DRIFT * (launches[i] - launches[i - 1]))
    for i in range(len(env) - 2, -1, -1):
        env[i] = min(env[i], env[i + 1] + DRIFT * (launches[i + 1] - launches[i]))
    return [min(0.0, e) for e in env]


def busy(t: Trace) -> Intervals:
    """The merged device intervals launched in the traced units, on the
    host's clock (see the module's docstring)."""
    launched = sorted(((l["ts"], d) for d, l in t.issued if l is not None),
                      key=lambda ld: ld[0])
    off = offsets([ts for ts, _ in launched], [d["ts"] for _, d in launched])
    iv = [(d["ts"] - o, d["ts"] - o + d["dur"]) for (_, d), o in zip(launched, off)]
    iv += [(d["ts"], d["ts"] + d["dur"]) for d, l in t.issued if l is None]
    return _merge(iv)


def idle(t: Trace) -> Intervals:
    """The traced units minus :func:`busy`."""
    out, dev, j = [], busy(t), 0
    for u0, u1 in t.units:
        while j < len(dev) and dev[j][1] <= u0:
            j += 1
        a, k = u0, j
        while k < len(dev) and dev[k][0] < u1:
            if dev[k][0] > a:
                out.append((a, dev[k][0]))
            a = max(a, dev[k][1])
            k += 1
        if a < u1:
            out.append((a, u1))
    return out


def overlap(a: Intervals, b: Intervals) -> float:
    """The length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(t: Trace, name: str) -> Optional[float]:
    """Device idle milliseconds a traced unit inside span `name` (None
    without device events or without the span)."""
    if not t.n_units or not t.device_events():
        return None
    spans = intervals(t, lambda n: n == name)
    if not spans:
        return None
    return overlap(idle(t), spans) * 1e-3 / t.n_units


def unnamed_syncs(t: Trace) -> Optional[float]:
    """Host syncs (``tracing.SYNC_CALLS``) a traced unit outside every
    ``csvit.sync.*`` span; None without device events or without the
    program's ``csvit.step`` span."""
    if not t.n_units or not t.device_events() or not intervals(t, lambda n: n == "csvit.step"):
        return None
    named = intervals(t, lambda n: n.startswith(SYNC))
    syncs = [e["ts"] for e in t.host if e["name"] in SYNC_CALLS and t._in_unit(e["ts"])]
    return sum(1 for ts in syncs if not _inside(named, ts)) / t.n_units
