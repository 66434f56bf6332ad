"""The traced part of a ``--trace 1`` run and what the readers read from it.

After the untraced window, a few more units (steps or requests) run under
``torch.profiler`` (CPU and CUDA activity), each inside a ``pb.unit`` range.
The benchmark's own spans are ``record_function`` ranges opened and closed
by forward pre- and post-hooks on the program's modules (``pb.block`` on
each block of the backbone, ``pb.head.<name>`` on each top-level submodule of the
Poser but the backbone) and by the optimizer's step hooks (``pb.optim``);
they are attached for the traced units only. The profiler's Chrome trace is
written to a temporary file, read back, and deleted.

A kernel or copy belongs to a span when the host call that launched it
(the CUDA runtime or driver event with its correlation id) lies inside the
span, on the same thread; it belongs to a unit when the launch lies inside
the unit's range.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


class _Spans:
    """Forward hooks that wrap modules in ``record_function`` ranges."""

    def __init__(self):
        self.handles, self.open = [], defaultdict(list)

    def on_module(self, module: torch.nn.Module, name: str) -> None:
        def pre(mod, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self.open[id(mod)].append(rf)

        def post(mod, args, out):
            self.open[id(mod)].pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def on_optimizer(self, optimizer) -> None:
        def pre(opt, args, kwargs):
            rf = torch.profiler.record_function("pb.optim")
            rf.__enter__()
            self.open[id(opt)].append(rf)

        def post(opt, args, kwargs):
            self.open[id(opt)].pop().__exit__(None, None, None)

        self.handles += [optimizer.register_step_pre_hook(pre),
                         optimizer.register_step_post_hook(post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def capture(unit: Callable[[], object], n: int, modules: Iterable[Tuple[torch.nn.Module, str]],
            optimizer=None) -> Tuple[dict, float]:
    """Run `unit` `n` times under the profiler with the spans attached;
    returns the parsed Chrome trace and the host seconds the units took."""
    spans = _Spans()
    for mod, name in modules:
        spans.on_module(mod, name)
    if optimizer is not None:
        spans.on_optimizer(optimizer)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                with torch.profiler.record_function("pb.unit"):
                    unit()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    finally:
        spans.remove()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    return data, host_s


class Trace:
    """The events of a traced run, in microseconds, with the quantities the
    per-layer readers share. `info` carries the run's untraced time a unit
    (``unit_s``) and the cell's counts of work (FLOPs and bounds a unit)."""

    def __init__(self, chrome: dict, info: dict):
        self.info = info
        ev = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
        cat = lambda e: str(e.get("cat", "")).lower()  # noqa: E731
        self.device = [e for e in ev if cat(e) in DEVICE_CATS]
        self.launches = {}
        self.host = []
        for e in ev:
            c = cat(e)
            if c in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launches[corr] = e
            if c in LAUNCH_CATS or c in ("cpu_op", "user_annotation"):
                self.host.append(e)
        self.units = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                            if cat(e) == "user_annotation" and e["name"] == "pb.unit")
        self._unit_starts = [u[0] for u in self.units]
        # each device event with the launch that issued it (or None)
        self.issued = [(d, self.launches.get(d.get("args", {}).get("correlation")))
                       for d in self.device]
        self.issued = [(d, l) for d, l in self.issued
                       if self._in_unit(d["ts"] if l is None else l["ts"])]

    @property
    def n_units(self) -> int:
        return len(self.units)

    def _in_unit(self, ts: float) -> bool:
        i = bisect.bisect_right(self._unit_starts, ts) - 1
        return i >= 0 and ts <= self.units[i][1]

    def spans(self, match: Callable[[str], bool]) -> Dict[object, List[Tuple[float, float]]]:
        """Intervals of the host events whose name `match`es, by thread,
        merged."""
        by_tid = defaultdict(list)
        for e in self.host:
            if match(e["name"]):
                by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
        return {t: _merge(iv) for t, iv in by_tid.items()}

    def device_us_under(self, match: Callable[[str], bool], cats=("kernel",)) -> float:
        """Device microseconds of the events launched inside host events
        named by `match`, over the traced units."""
        spans = self.spans(match)
        total = 0.0
        for d, launch in self.issued:
            if launch is None or str(d.get("cat", "")).lower() not in cats:
                continue
            iv = spans.get(launch.get("tid"))
            if iv and _inside(iv, launch["ts"]):
                total += d["dur"]
        return total

    def device_events(self, cats=DEVICE_CATS, name: Optional[Callable[[str], bool]] = None):
        return [d for d, _ in self.issued
                if str(d.get("cat", "")).lower() in cats and (name is None or name(d["name"]))]

    def kernels_per_unit(self) -> Optional[float]:
        """Device kernels a traced unit (None without any)."""
        n = len(self.device_events(("kernel",)))
        return n / self.n_units if n and self.n_units else None

    def count_host(self, names: Iterable[str]) -> int:
        """Host calls named in `names` inside the traced units."""
        names = set(names)
        return sum(1 for e in self.host if e["name"] in names and self._in_unit(e["ts"]))

    def busy_us(self) -> float:
        """The union of the device intervals inside the traced units."""
        iv = _merge([(d["ts"], d["ts"] + d["dur"]) for d, _ in self.issued])
        return sum(_overlap(iv, u) for u in self.units)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle device time inside the traced units, summed by what the host
        was doing when each gap began (its innermost host event), longest
        first."""
        iv = _merge([(d["ts"], d["ts"] + d["dur"]) for d, _ in self.issued])
        gaps = []
        for u0, u1 in self.units:
            t = u0
            for a, b in iv:
                if b <= t:
                    continue
                if a >= u1:
                    break
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if t < u1:
                gaps.append((t, u1))
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        sums = defaultdict(float)
        for g0, g1 in gaps:
            label, best = "(none)", None
            for e in reversed(host[:bisect.bisect_right(starts, g0)][-400:]):
                if e["ts"] + e["dur"] >= g0 and e["name"] != "pb.unit" and (
                        best is None or e["dur"] < best):
                    label, best = e["name"], e["dur"]
            sums[label] += (g1 - g0) * 1e-6
        return sorted(sums.items(), key=lambda kv: -kv[1])

    def top_device_ops(self) -> List[Tuple[str, float]]:
        sums = defaultdict(float)
        for d, _ in self.issued:
            sums[d["name"]] += d["dur"] * 1e-6
        return sorted(sums.items(), key=lambda kv: -kv[1])


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _inside(merged, t) -> bool:
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def _overlap(merged, window) -> float:
    w0, w1 = window
    return sum(max(0.0, min(b, w1) - max(a, w0)) for a, b in merged)
