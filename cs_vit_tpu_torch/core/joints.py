"""Joint-order utilities (port of ``cs_vit_tpu/core/joints.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def mean_connection_length(
    joints: torch.Tensor, connection: Sequence[Tuple[int, int]]
) -> torch.Tensor:
    """Mean bone length over `connection` pairs; joints [..., J, 3] -> [...]."""
    src = joints[..., [a for a, _ in connection], :]
    dst = joints[..., [b for _, b in connection], :]
    return torch.mean(torch.linalg.vector_norm(src - dst, dim=-1), dim=-1)
