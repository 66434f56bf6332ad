"""Train state (port of ``cs_vit_tpu/train/state.py``).

The model holds the f32 master parameters and the BatchNorm running
statistics, the optimizer its AdamW moments; ``step`` counts accepted
updates. The train step updates all of them in place.
"""

from __future__ import annotations

import dataclasses

import torch

from .optim import PhaseAdamW


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: PhaseAdamW
    step: int = 0
    epoch: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: PhaseAdamW) -> "TrainState":
        return cls(model=model, optimizer=optimizer)
