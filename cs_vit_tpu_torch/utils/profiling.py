"""Profiling and step timing (port of ``cs_vit_tpu/utils/profiling.py``).

The reference only timed iterations with datetime deltas
(`scripts/finetune.py:206,271-282`). :func:`trace` records a
``torch.profiler`` trace, the port's ``jax.profiler.start_trace``, and
:func:`annotate` names a span in it. The meter reads the host clock, so a
step that ends without waiting for the card is timed as it was issued: the
port's train step waits for its loss's finiteness on every step.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the CPU and, where a card is
    present, of CUDA activity; on exit it is written as a Chrome trace
    (``chrome://tracing``, Perfetto) to ``<log_dir>/trace_<pid>.json``. The
    profiler is handed to the caller, whose ``trace_path`` names the file
    once the block has ended."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = None
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """Named trace span for host-side phases."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Throughput meter; call update(batch_size) once per step."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.steps = 0
        self.samples = 0
        self.t0: Optional[float] = None

    def update(self, batch_size: int):
        self.steps += 1
        if self.steps == self.warmup:
            self.t0 = time.monotonic()
        elif self.steps > self.warmup:
            self.samples += batch_size

    @property
    def samples_per_sec(self) -> float:
        if self.t0 is None or self.samples == 0:
            return 0.0
        return self.samples / (time.monotonic() - self.t0)
