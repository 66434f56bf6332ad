"""This process's place in a ``torch.distributed`` world: the port's
counterparts of ``jax.process_index`` and ``jax.process_count`` (0 and 1
when no process group is initialised)."""

from __future__ import annotations

import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
