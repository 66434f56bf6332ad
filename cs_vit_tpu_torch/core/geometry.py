"""Rotation-representation conversions as plain tensor functions.

Port of ``cs_vit_tpu/core/geometry.py``: the same branch-free formulas (every
data-dependent choice is a ``torch.where``), so results agree with the JAX
functions element for element up to float rounding.

Conventions: quaternions are (w, x, y, z) real-part-first; axis-angle is a
3-vector whose magnitude is the rotation angle (radians, CCW about the axis);
matrices act on column vectors (y = R @ v).
"""

from __future__ import annotations

import math

import torch

_EPS_NORMALIZE = 1e-12


def _normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2-normalize along `dim` (clamped denominator, F.normalize style)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=_EPS_NORMALIZE)


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a zero subgradient at x == 0."""
    sq = torch.sum(x * x, dim=dim)
    is_zero = sq == 0
    safe = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(safe))


def _stack33(entries, shape) -> torch.Tensor:
    return torch.stack(entries, dim=-1).reshape(tuple(shape) + (3, 3))


def rotation_matrix_z(rad: torch.Tensor) -> torch.Tensor:
    """Right-handed rotation about +z; `rad` has shape [...]; returns [..., 3, 3]."""
    c, s = torch.cos(rad), torch.sin(rad)
    z, o = torch.zeros_like(rad), torch.ones_like(rad)
    return _stack33([c, -s, z, s, c, z, z, z, o], rad.shape)


def rotation_matrix_x(rad: torch.Tensor) -> torch.Tensor:
    """Right-handed rotation about +x; shape as `rotation_matrix_z`."""
    c, s = torch.cos(rad), torch.sin(rad)
    z, o = torch.zeros_like(rad), torch.ones_like(rad)
    return _stack33([o, z, z, z, c, -s, z, s, c], rad.shape)


def rotation_matrix_y(rad: torch.Tensor, compat: bool = True) -> torch.Tensor:
    """Rotation about +y.

    ``compat=True`` (default) keeps the reference's non-standard fill
    (rows [sin, 0, cos; 0, 1, 0; cos, 0, -sin]) that checkpoints trained with
    ``global_positioning="orientation"`` depend on; ``compat=False`` gives the
    textbook right-handed y-rotation.
    """
    c, s = torch.cos(rad), torch.sin(rad)
    z, o = torch.zeros_like(rad), torch.ones_like(rad)
    if compat:
        return _stack33([s, z, c, z, o, z, c, z, -s], rad.shape)
    return _stack33([c, z, s, z, o, z, -s, z, c], rad.shape)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation representation (Zhou et al. 2019) -> rotation matrix.

    Gram-Schmidt on the two 3-vectors; rows of the result are the basis.
    """
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _normalize(a1)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = _normalize(b2)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> 6D representation (first two rows, flattened)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real part is non-negative."""
    return torch.where(quaternions[..., 0:1] < 0, -quaternions, quaternions)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with zero subgradient at x <= 0."""
    positive = x > 0
    safe = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(x))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> quaternions [..., 4] (w, x, y, z).

    Branch-free pytorch3d candidate selection: the candidate with the
    largest |q_i| is taken through a one-hot mask.
    """
    batch_dim = matrix.shape[:-2]
    m = matrix.reshape(batch_dim + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(m, dim=-1)

    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )

    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )

    flr = torch.full((), 0.1, dtype=q_abs.dtype, device=q_abs.device)
    quat_candidates = quat_by_rijk / (2.0 * torch.maximum(q_abs[..., None], flr))

    best = torch.argmax(q_abs, dim=-1)
    onehot = torch.nn.functional.one_hot(best, 4).to(quat_candidates.dtype)
    out = torch.sum(quat_candidates * onehot[..., None], dim=-2)
    return standardize_quaternion(out)


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternions [..., 4] (w, x, y, z) -> rotation matrices [..., 3, 3]."""
    r, i, j, k = torch.unbind(quaternions, dim=-1)
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ),
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternions [..., 4] -> axis-angle [..., 3]."""
    norms = torch.linalg.vector_norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    sin_half_over = 0.5 * torch.sinc(half_angles / math.pi)
    return quaternions[..., 1:] / sin_half_over


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> quaternions [..., 4] (w, x, y, z)."""
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    sin_half_over = 0.5 * torch.sinc(angles * 0.5 / math.pi)
    return torch.cat([torch.cos(angles * 0.5), axis_angle * sin_half_over], dim=-1)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3] (Rodrigues, branch-free)."""
    shape = axis_angle.shape
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)[..., None]

    rx, ry, rz = axis_angle[..., 0], axis_angle[..., 1], axis_angle[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(shape + (3,))
    K2 = K @ K

    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    angles_sq = angles * angles
    angles_sq = torch.where(angles_sq == 0, torch.ones_like(angles_sq), angles_sq)
    return (
        eye
        + torch.sinc(angles / math.pi) * K
        + ((1 - torch.cos(angles)) / angles_sq) * K2
    )


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> axis-angle [..., 3] (quaternion route)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))
