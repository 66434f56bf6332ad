"""Heatmap / projection / patch-transform utilities (vendored-IH26M parity;
port of ``cs_vit_tpu/ops/heatmap.py``).

Torch and numpy ports of the remaining InterWild-style numeric helpers
(`cs_vit/dataset/InterHand26M/utils/transforms.py:46-85` and
`utils/preprocessing.py:150-231`): differentiable soft-argmax over 2D/3D
heatmaps and fisheye-distorted projection (torch, on the inputs' device),
and the 3-point affine patch transform used for crop augmentation (numpy).
"""

from __future__ import annotations

import numpy as np
import torch


def soft_argmax_2d(heatmap2d: torch.Tensor) -> torch.Tensor:
    """[B, J, H, W] logits -> [B, J, 2] expected (x, y) coordinates."""
    B, J, H, W = heatmap2d.shape
    p = torch.softmax(heatmap2d.reshape(B, J, H * W), dim=2).reshape(B, J, H, W)
    accu_x = p.sum(dim=2) * torch.arange(W, dtype=p.dtype, device=p.device)
    accu_y = p.sum(dim=3) * torch.arange(H, dtype=p.dtype, device=p.device)
    return torch.stack([accu_x.sum(dim=2), accu_y.sum(dim=2)], dim=2)


def soft_argmax_3d(heatmap3d: torch.Tensor) -> torch.Tensor:
    """[B, J, D, H, W] logits -> [B, J, 3] expected (x, y, z) coordinates."""
    B, J, D, H, W = heatmap3d.shape
    p = torch.softmax(heatmap3d.reshape(B, J, -1), dim=2).reshape(B, J, D, H, W)
    accu_x = p.sum(dim=(2, 3)) * torch.arange(W, dtype=p.dtype, device=p.device)
    accu_y = p.sum(dim=(2, 4)) * torch.arange(H, dtype=p.dtype, device=p.device)
    accu_z = p.sum(dim=(3, 4)) * torch.arange(D, dtype=p.dtype, device=p.device)
    return torch.stack(
        [accu_x.sum(dim=2), accu_y.sum(dim=2), accu_z.sum(dim=2)], dim=2
    )


def distort_projection_fisheye(
    point: torch.Tensor,    # [B, J, 3] camera coords
    focal: torch.Tensor,    # [B, 2]
    princpt: torch.Tensor,  # [B, 2]
    D: torch.Tensor,        # [B, 4] distortion coefficients
) -> torch.Tensor:
    """Kannala-Brandt fisheye projection -> [B, J, 3] (u, v, z)."""
    z = point[:, :, 2]
    ndc = point[:, :, :2] / z[:, :, None]
    r = torch.sqrt(torch.sum(ndc**2, dim=2))
    theta = torch.arctan(r)
    theta_d = theta * (
        1
        + D[:, None, 0] * theta**2
        + D[:, None, 1] * theta**4
        + D[:, None, 2] * theta**6
        + D[:, None, 3] * theta**8
    )
    ndc = ndc * (theta_d / torch.clamp(r, min=1e-12))[:, :, None]
    u = ndc[:, :, 0] * focal[:, None, 0] + princpt[:, None, 0]
    v = ndc[:, :, 1] * focal[:, None, 1] + princpt[:, None, 1]
    return torch.stack([u, v, z], dim=2)


def _rotate_2d(pt: np.ndarray, rot_rad: float) -> np.ndarray:
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.asarray(
        [pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs], np.float32
    )


def gen_trans_from_patch(
    c_x: float, c_y: float,
    src_width: float, src_height: float,
    dst_width: float, dst_height: float,
    scale: float, rot_deg: float, inv: bool = False,
) -> np.ndarray:
    """2x3 affine mapping a (scaled, rotated) source patch to the dst rect.

    Port of ``gen_trans_from_patch_cv`` (preprocessing.py:174-207) without the
    cv2.getAffineTransform dependency: the transform is solved from the same
    3 point correspondences (center, center+down, center+right).
    """
    src_w, src_h = src_width * scale, src_height * scale
    rot_rad = np.pi * rot_deg / 180.0
    src_center = np.asarray([c_x, c_y], np.float32)
    src_down = _rotate_2d(np.asarray([0, src_h * 0.5], np.float32), rot_rad)
    src_right = _rotate_2d(np.asarray([src_w * 0.5, 0], np.float32), rot_rad)

    dst_center = np.asarray([dst_width * 0.5, dst_height * 0.5], np.float32)
    dst_down = np.asarray([0, dst_height * 0.5], np.float32)
    dst_right = np.asarray([dst_width * 0.5, 0], np.float32)

    src = np.stack([src_center, src_center + src_down, src_center + src_right])
    dst = np.stack([dst_center, dst_center + dst_down, dst_center + dst_right])
    if inv:
        src, dst = dst, src

    # solve [x y 1] @ M^T = dst for the 2x3 affine M
    A = np.concatenate([src, np.ones((3, 1), np.float32)], axis=1)
    M = np.linalg.solve(A, dst).T  # [2,3]
    return M.astype(np.float32)


def apply_affine(points: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """[N,2] points through a 2x3 affine."""
    pts = np.concatenate([points, np.ones((len(points), 1), points.dtype)], axis=1)
    return pts @ trans.T
