"""Joint-order utilities (port of ``cs_vit_tpu/core/joints.py``)."""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate


@lru_cache(maxsize=None)
def reorder_indices(origin: Tuple[str, ...], target: Tuple[str, ...]) -> np.ndarray:
    """Static index map such that joints[..., idx, :] is in `target` order."""
    if len(origin) != len(target):
        raise ValueError("Origin and target joint lists must have same length")
    if set(origin) != set(target):
        raise ValueError("Origin and target joint lists must contain same joints")
    origin_map = {name: idx for idx, name in enumerate(origin)}
    return np.asarray([origin_map[name] for name in target], dtype=np.int32)


def reorder_joints(
    joints: torch.Tensor, origin: Sequence[str], target: Sequence[str]
) -> torch.Tensor:
    """Reorder [..., J, D] joints from `origin` name order to `target` order."""
    idx = torch.as_tensor(reorder_indices(tuple(origin), tuple(target)), dtype=torch.long,
                          device=joints.device)
    return torch.index_select(joints, -2, idx)


def mean_connection_length(
    joints: torch.Tensor, connection: Sequence[Tuple[int, int]]
) -> torch.Tensor:
    """Mean bone length over `connection` pairs; joints [..., J, 3] -> [...].
    On a card each list index is copied there from pageable memory, and the
    host waits for the copy."""
    with annotate("csvit.sync.bone_src"):
        src = joints[..., [a for a, _ in connection], :]
    with annotate("csvit.sync.bone_dst"):
        dst = joints[..., [b for _, b in connection], :]
    return torch.mean(torch.linalg.vector_norm(src - dst, dim=-1), dim=-1)
