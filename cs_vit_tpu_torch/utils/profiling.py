"""Profiling and step timing (port of ``cs_vit_tpu/utils/profiling.py``).

The reference only timed iterations with datetime deltas
(`scripts/finetune.py:206,271-282`). :func:`trace` records a
``torch.profiler`` trace, the port's ``jax.profiler.start_trace``, and
:func:`annotate` names a span in it. The meter reads the host clock, so a
step that ends without waiting for the card is timed as it was issued: the
port's train step waits for its loss's finiteness on every step.

The program's own spans, all opened through :func:`annotate` and recorded
only while a profiler records on the calling thread (under :func:`trace`,
or any ``torch.profiler.profile``):

* ``csvit.step`` (``train/step.py``), one train step, with
  ``csvit.step.cast`` (the parameters' and images' compute-dtype copies),
  ``csvit.step.forward``, ``csvit.step.backward`` and ``csvit.step.update``;
  under the last ``csvit.step.clip`` and ``csvit.step.optim`` (AdamW);
* ``csvit.optim.multi_tensor`` and ``csvit.optim.per_leaf``
  (``train/optim.py``), inside ``csvit.step.clip`` and ``csvit.step.optim``:
  the norm, the clip or AdamW by the multi-tensor kernels (on a card) or by
  the per-leaf code (on the CPU);
* ``csvit.sync.<site>``, each place where a train step makes the host wait
  for the card, one sync a span: ``finite`` (the loss's finiteness,
  ``train/step.py``), ``clip`` (the per-leaf clip's branch,
  ``train/optim.py``: only on the CPU),
  ``mano_parents`` and ``mano_bottom`` (a list index and a constant row
  copied to the card from pageable memory, ``mano/layer.py``), ``bone_src``
  and ``bone_dst`` (the bones' list indices, ``core/joints.py``); the last
  four run in every forward, served ones too;
* ``csvit.serve.input`` (padding and the copies to the card),
  ``csvit.serve.forward`` and ``csvit.serve.output`` (the copies to the
  host, which wait for the forward), one each for every chunk of
  ``PoserSession.predict_crops`` (``serving.py``);
* ``csvit.data.wait`` (``cli/finetune.py``, ``cli/evaluate.py``), the wait
  for the loader's next batch.

The profiler writes each span on the timeline of the kernels and copies it
launches, so the card's idle time can be put down to the span that was
open on the host. On the H100 the device's clock can drift from the host's
by milliseconds over a capture of a second or two; the benchmark's readers
(``portbench/spans.py``) put the device's events back on the host's clock
from their launches.
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


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named span of the host, as a context manager: a
    ``torch.profiler.record_function`` range while a profiler records on
    this thread, else one shared null context, which costs a flag's read and
    enters no ``RecordFunction``."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
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
