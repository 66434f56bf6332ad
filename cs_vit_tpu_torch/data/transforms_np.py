"""Host-side numpy transforms for the data pipeline (copy of
``cs_vit_tpu/data/transforms_np.py``).

Replaces the torchvision/kornia augmentation stack the reference runs inside
dataloader workers (`cs_vit/dataset/DexYCB.py:36-48,170-211`) with
numpy/cv2/scipy equivalents. Geometric parity (rotation math, bbox algebra)
is exact; photometric augs match torchvision's parameter distributions.
``cv2`` is imported by the functions that call it, so the module imports
without it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from ..ops.resample import (
    bbox_to_corners,
    crop_and_resize_np,
    expand_bbox_square,
)

# ---------------------------------------------------------------------------
# geometry (numpy mirrors of core.geometry, for the host pipeline)
# ---------------------------------------------------------------------------


def rotation_matrix_z_np(rad: np.ndarray) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    z = np.zeros_like(rad)
    o = np.ones_like(rad)
    return np.stack([c, -s, z, s, c, z, z, z, o], axis=-1).reshape(rad.shape + (3, 3))


def axis_angle_to_matrix_np(aa: np.ndarray) -> np.ndarray:
    shape = aa.shape
    return Rotation.from_rotvec(aa.reshape(-1, 3)).as_matrix().reshape(shape + (3,))


def matrix_to_axis_angle_np(mat: np.ndarray) -> np.ndarray:
    shape = mat.shape[:-2]
    return Rotation.from_matrix(mat.reshape(-1, 3, 3)).as_rotvec().reshape(shape + (3,))


# ---------------------------------------------------------------------------
# photometric augmentation (torchvision-distribution equivalents)
# ---------------------------------------------------------------------------


def _grayscale(img: np.ndarray) -> np.ndarray:
    return img[..., 0] * 0.2989 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def color_jitter(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.2,
    contrast: float = 0.2,
    saturation: float = 0.2,
    hue: float = 0.1,
) -> np.ndarray:
    """torchvision ColorJitter equivalent on float [...,H,W,3] in [0,1].

    The arithmetic is written in-place (same expression trees, so results are
    bitwise-identical to the naive form) — the jitter runs per item in loader
    threads and the extra temporaries cost ~1 ms/frame at 256px.
    """
    import cv2

    ops = list(rng.permutation(4))
    for op in ops:
        if op == 0 and brightness > 0:
            f = rng.uniform(1 - brightness, 1 + brightness)
            img = np.multiply(img, np.float32(f))
            np.clip(img, 0, 1, out=img)
        elif op == 1 and contrast > 0:
            f = rng.uniform(1 - contrast, 1 + contrast)
            mean = _grayscale(img).mean()
            img = np.multiply(img, np.float32(f))
            img += np.float32((1 - f) * mean)
            np.clip(img, 0, 1, out=img)
        elif op == 2 and saturation > 0:
            f = rng.uniform(1 - saturation, 1 + saturation)
            gray = _grayscale(img)[..., None]
            gray *= np.float32(1 - f)
            img = np.multiply(img, np.float32(f))
            img += gray
            np.clip(img, 0, 1, out=img)
        elif op == 3 and hue > 0:
            h = rng.uniform(-hue, hue)
            flat = np.ascontiguousarray(
                img.reshape((-1,) + img.shape[-3:]), np.float32
            )
            out = []
            for frame in flat:
                hsv = cv2.cvtColor(frame, cv2.COLOR_RGB2HSV)
                hsv[..., 0] = np.mod(hsv[..., 0] + h * 360.0, 360.0)
                out.append(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
            img = np.stack(out).reshape(img.shape)
            np.clip(img, 0, 1, out=img)
    return img.astype(np.float32, copy=False)


def random_photometric_aug(
    img: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """ColorJitter + RandomGrayscale(0.1) + GaussianBlur(p=0.2) + Solarize(p=0.2).

    Mirrors the reference aug stack (`DexYCB.py:36-48`); applied to a whole
    clip [...,H,W,3] with one parameter draw (torchvision batch semantics).
    """
    img = color_jitter(img, rng)
    if rng.uniform() < 0.1:
        img = np.repeat(_grayscale(img)[..., None], 3, axis=-1)
    if rng.uniform() < 0.2:
        import cv2

        sigma = rng.uniform(0.1, 2.0)
        flat = img.reshape((-1,) + img.shape[-3:])
        img = np.stack(
            [cv2.GaussianBlur(f, (3, 3), sigma) for f in flat]
        ).reshape(img.shape)
    if rng.uniform() < 0.2:
        out = img.copy()
        np.subtract(1.0, img, out=out, where=img >= 0.5)
        img = out
    return img.astype(np.float32, copy=False)


# ---------------------------------------------------------------------------
# the shared train-time global z-rotation augmentation
# ---------------------------------------------------------------------------


def rotation_augmentation(
    img_seq: np.ndarray,      # [T,H,W,3] float [0,1]
    joint_cam: np.ndarray,    # [T,J,3]
    joint_rel: np.ndarray,    # [T,J,3]
    joint_img: np.ndarray,    # [T,J,2]
    mano_pose: np.ndarray,    # [T,48]
    princpt: np.ndarray,      # [T,2]
    expansion_ratio: float,
    img_size: int,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """Global z-rotation about the principal point (one angle per clip).

    Exact port of the shared augmentation block
    (`cs_vit/dataset/DexYCB.py:170-211`, `HO3D.py:333-375`,
    `InterHand26MSeq.py:250-291`): rotate 3D joints and root pose, re-derive
    the 2D joints/bbox, and crop the ORIGINAL image with the back-rotated
    square corners so no resample happens twice.
    """
    T = img_seq.shape[0]
    rot_rad = np.full((T,), rng.uniform() * 2 * np.pi, np.float32)
    rot3 = rotation_matrix_z_np(rot_rad)                  # [T,3,3]
    rot2 = rot3[:, :2, :2].transpose(0, 2, 1)             # [T,2,2]

    joint_cam = joint_cam @ rot3
    joint_rel = joint_rel @ rot3
    root_mat = axis_angle_to_matrix_np(mano_pose[:, :3])
    root_mat = rot3.transpose(0, 2, 1) @ root_mat
    mano_pose = mano_pose.copy()
    mano_pose[:, :3] = matrix_to_axis_angle_np(root_mat)

    joint_img = (joint_img - princpt[:, None]) @ rot2.transpose(0, 2, 1) + princpt[:, None]
    bbox_tight = np.stack(
        [
            joint_img[:, :, 0].min(axis=1),
            joint_img[:, :, 1].min(axis=1),
            joint_img[:, :, 0].max(axis=1),
            joint_img[:, :, 1].max(axis=1),
        ],
        axis=-1,
    ).astype(np.float32)
    joint_bbox_img = joint_img - bbox_tight[:, None, :2]

    square_bboxes = expand_bbox_square(bbox_tight, expansion_ratio)
    corners = bbox_to_corners(square_bboxes)              # [T,4,2]
    corners_orig = (corners - princpt[:, None]) @ rot2 + princpt[:, None]
    patches = crop_and_resize_np(img_seq, corners_orig, (img_size, img_size))

    return {
        "rot_rad": rot_rad,
        "patches": patches,
        "square_bboxes": square_bboxes.astype(np.float32),
        "bbox_tight": bbox_tight,
        "joint_img": joint_img.astype(np.float32),
        "joint_bbox_img": joint_bbox_img.astype(np.float32),
        "joint_cam": joint_cam.astype(np.float32),
        "joint_rel": joint_rel.astype(np.float32),
        "mano_pose": mano_pose.astype(np.float32),
    }


def horizontal_flip_annotations(
    img_seq: np.ndarray,
    bbox_tight: np.ndarray,
    joint_img: np.ndarray,
    joint_bbox_img: np.ndarray,
    joint_cam: np.ndarray,
    joint_rel: np.ndarray,
    mano_pose: np.ndarray,
    princpt: np.ndarray,
) -> Tuple[np.ndarray, ...]:
    """Left->right hand mirroring (ref `DexYCB.py:153-167`)."""
    W = img_seq.shape[-2]
    if img_seq.dtype == np.uint8:
        import cv2

        # cv2.flip is ~11x faster than a negative-stride numpy copy on uint8
        # (bitwise-identical); float frames keep the numpy path (cv2 is
        # slower there).
        img_seq = np.stack([cv2.flip(f, 1) for f in img_seq])
    else:
        img_seq = img_seq[..., ::-1, :].copy()
    bbox_tight = bbox_tight.copy()
    bbox_w = bbox_tight[:, 2] - bbox_tight[:, 0]
    bbox_tight[:, 0], bbox_tight[:, 2] = (
        W - bbox_tight[:, 2].copy(),
        W - bbox_tight[:, 0].copy(),
    )
    joint_img = joint_img.copy()
    joint_img[..., 0] = W - joint_img[..., 0]
    joint_bbox_img = joint_bbox_img.copy()
    joint_bbox_img[..., 0] = bbox_w[:, None] - joint_bbox_img[..., 0]
    joint_cam = joint_cam.copy()
    joint_cam[..., 0] *= -1
    joint_rel = joint_rel.copy()
    joint_rel[..., 0] *= -1
    mano_pose = mano_pose.reshape(-1, 16, 3).copy()
    mano_pose[..., 1:] *= -1
    mano_pose = mano_pose.reshape(-1, 48)
    princpt = princpt.copy()
    princpt[:, 0] = W - princpt[:, 0]
    return (
        img_seq, bbox_tight, joint_img, joint_bbox_img,
        joint_cam, joint_rel, mano_pose, princpt,
    )
