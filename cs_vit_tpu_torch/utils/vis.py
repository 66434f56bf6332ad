"""Host-side reprojection visualization (port of ``cs_vit_tpu/utils/vis.py``;
replaces the reference's ``Poser._vis``).

The reference re-reads and re-rotates source images from disk inside every
forward pass (`cs_vit/net/ti_poser.py:780-813`); here visualization is a
host utility, numpy in and numpy out, invoked only on logging steps and
drawing on the already-loaded crop patches. ``cv2`` is imported by the
function that draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..constants import TARGET_JOINTS_CONNECTION

_COLORS = {
    "red": (255, 0, 0),
    "green": (0, 255, 0),
    "blue": (0, 0, 255),
    "gray": (128, 128, 128),
    "white": (255, 255, 255),
    "black": (0, 0, 0),
}


def draw_hands_on_image_batch(
    imgs: np.ndarray,                    # [N,H,W,3] float [0,1]
    joints: np.ndarray,                  # [N,J,2] pixel xy
    connections: Optional[Sequence[Tuple[int, int]]] = None,
    joints_color: str = "red",
    connections_color: str = "gray",
) -> np.ndarray:
    """Skeleton overlay (ref `utils/img.py:393-456`), RGB in/out: connections
    2 px wide, joints as filled circles of radius 3 over them."""
    import cv2

    jc = _COLORS.get(joints_color, _COLORS["red"])
    cc = _COLORS.get(connections_color, _COLORS["gray"])
    out = (np.clip(imgs, 0, 1) * 255).astype(np.uint8).copy()
    for i in range(out.shape[0]):
        img = out[i]
        pts = joints[i]
        if connections is not None:
            for a, b in connections:
                p1 = tuple(int(v) for v in pts[a])
                p2 = tuple(int(v) for v in pts[b])
                cv2.line(img, p1, p2, cc, thickness=2)
        for p in pts:
            cv2.circle(img, (int(p[0]), int(p[1])), 3, jc, thickness=-1)
    return out.astype(np.float32) / 255.0


def reprojection_grid(
    patches: np.ndarray,        # [T,S,S,3] the model-input crops
    square_bboxes: np.ndarray,  # [T,4] xyxy
    joint_reproj_pred: np.ndarray,  # [T,J,2] full-image pixels
    joint_img_gt: Optional[np.ndarray] = None,  # [T,J,2]
) -> np.ndarray:
    """Draw pred (red) and GT (green, under the pred) joints on the crop
    patches, tiled in a row: [S, T*S, 3]."""
    scale = patches.shape[1] / (square_bboxes[:, 2] - square_bboxes[:, 0])[:, None, None]
    pred_local = (joint_reproj_pred - square_bboxes[:, None, :2]) * scale
    imgs = patches
    if joint_img_gt is not None:
        gt_local = (joint_img_gt - square_bboxes[:, None, :2]) * scale
        imgs = draw_hands_on_image_batch(
            imgs, gt_local, TARGET_JOINTS_CONNECTION, "green", "gray"
        )
    imgs = draw_hands_on_image_batch(
        imgs, pred_local, TARGET_JOINTS_CONNECTION, "red", "gray"
    )
    return np.concatenate(list(imgs), axis=1)


def training_reprojection_image(
    patches: np.ndarray,          # [K,T,S,S,3] float [0,1] model-input crops
    square_bboxes: np.ndarray,    # [K,T,4] xyxy
    focal: np.ndarray,            # [K,T,2]
    princpt: np.ndarray,          # [K,T,2]
    joint_cam_pred: np.ndarray,   # [K,T',21,3] camera-space mm
    joint_img_gt: Optional[np.ndarray] = None,  # [K,T,21,2] full-image px
    max_tiles: int = 8,
) -> np.ndarray:
    """Train-loop reprojection grid (ref `scripts/finetune.py:245-255`,
    `cs_vit/net/ti_poser.py:780-791`): pinhole-reproject the predictions and
    draw pred (red) and GT (green) skeletons on the crops, the first
    `max_tiles` (sample, frame) pairs tiled horizontally."""

    def flat(a):
        a = np.asarray(a, np.float32)
        return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])[:max_tiles]

    jc = flat(joint_cam_pred)
    f, c = flat(focal), flat(princpt)
    z = np.where(np.abs(jc[..., -1:]) < 1e-6, 1e-6, jc[..., -1:])
    uv = np.stack(
        [
            f[:, :1] * jc[..., 0] + c[:, :1] * jc[..., 2],
            f[:, 1:] * jc[..., 1] + c[:, 1:] * jc[..., 2],
        ],
        axis=-1,
    ) / z
    return reprojection_grid(
        flat(patches),
        flat(square_bboxes),
        uv,
        None if joint_img_gt is None else flat(joint_img_gt),
    )
