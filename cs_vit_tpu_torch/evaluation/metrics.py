"""Accuracy metrics (MPRPE / MPJPE-CS / MPJPE-RS / MPJPE-PA); copy of
``cs_vit_tpu/evaluation/metrics.py``.

Parity: `scripts/benchmark.py:7-61` — including the scale-aware Procrustes
alignment via orthogonal Procrustes on normalized point sets.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.linalg import orthogonal_procrustes


def align_w_scale(mtx1: np.ndarray, mtx2: np.ndarray, return_trafo: bool = False):
    """Align mtx2 [J,3] onto mtx1 [J,3] with rotation+scale+translation."""
    t1, t2 = mtx1.mean(0), mtx2.mean(0)
    mtx1_t = mtx1 - t1
    mtx2_t = mtx2 - t2
    s1 = np.linalg.norm(mtx1_t) + 1e-8
    mtx1_t = mtx1_t / s1
    s2 = np.linalg.norm(mtx2_t) + 1e-8
    mtx2_t = mtx2_t / s2
    R, s = orthogonal_procrustes(mtx1_t, mtx2_t)
    mtx2_t = np.dot(mtx2_t, R.T) * s
    mtx2_t = mtx2_t * s1 + t1
    if return_trafo:
        return R, s, s1, t1 - t2
    return mtx2_t


def compute_metrics(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    """gt/pred [N,21,3] in mm -> the four benchmark metrics (mm)."""
    gt_rel = gt - gt[:, :1]
    pred_rel = pred - pred[:, :1]

    mprpe = float(np.mean(np.sqrt(np.sum((gt[:, 0] - pred[:, 0]) ** 2, axis=-1))))
    mpjpe_cs = float(
        np.mean(np.mean(np.sqrt(np.sum((gt - pred) ** 2, axis=-1)), axis=-1))
    )
    mpjpe_rs = float(
        np.mean(np.mean(np.sqrt(np.sum((gt_rel - pred_rel) ** 2, axis=-1)), axis=-1))
    )

    errors_pa = []
    for ix in range(len(gt)):
        pred_align = align_w_scale(gt[ix], pred[ix])
        errors_pa.append(
            float(np.mean(np.sqrt(np.sum((gt[ix] - pred_align) ** 2, axis=-1))))
        )
    mpjpe_pa = float(np.mean(errors_pa))

    return {
        "mprpe": mprpe,
        "mpjpe_cs": mpjpe_cs,
        "mpjpe_rs": mpjpe_rs,
        "mpjpe_pa": mpjpe_pa,
    }


def reproject_pinhole(joint_cam: np.ndarray, focal: np.ndarray, princpt: np.ndarray):
    """Pinhole reprojection [.., J, 3] -> [.., J, 2] (ref `eval.py:273-283`)."""
    u = focal[..., :1] * joint_cam[..., 0] + princpt[..., :1] * joint_cam[..., 2]
    v = focal[..., 1:] * joint_cam[..., 1] + princpt[..., 1:] * joint_cam[..., 2]
    uv = np.stack([u, v], axis=-1)
    return uv / joint_cam[..., -1:]
