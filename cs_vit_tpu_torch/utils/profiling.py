"""Step timing (port of ``cs_vit_tpu/utils/profiling.py``: ``StepTimer``;
the trace helpers wait for ROADMAP queue 1, item 7).

The reference only timed iterations with datetime deltas
(`scripts/finetune.py:206,271-282`). The meter reads the host clock, so a
step that ends without waiting for the card is timed as it was issued: the
port's train step waits for its loss's finiteness on every step.
"""

from __future__ import annotations

import time
from typing import Optional


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
