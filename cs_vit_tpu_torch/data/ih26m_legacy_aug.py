"""Legacy IH26M (InterWild-style) train-time augmentation pipeline.

Completes the vendored preprocessing port
(`cs_vit/dataset/InterHand26M/utils/preprocessing.py:114-306`): random
scale/rotation/color/flip config, affine patch generation via the 3-point
transform (ops/heatmap.gen_trans_from_patch + cv2.warpAffine), and the
joint/MANO data transforms into heatmap-target space.

Config values (input/output shapes, 3D bbox size) mirror the vendored static
Config (`cs_vit/dataset/InterHand26M/config.py:13-71`) but are arguments here
instead of module globals. Copy of ``cs_vit_tpu/data/ih26m_legacy_aug.py``,
with ``cv2`` imported by the functions that call it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from ..ops.heatmap import gen_trans_from_patch


@dataclasses.dataclass(frozen=True)
class LegacyAugConfig:
    """Vendored-Config subset relevant to hand crops (config.py:26-33)."""

    input_img_shape: Tuple[int, int] = (512, 384)     # (H, W)
    output_body_hm_shape: Tuple[int, int, int] = (8, 64, 48)  # (D, H, W)
    bbox_3d_size: float = 2.0                         # meters


def get_aug_config(rng: Optional[np.random.Generator] = None):
    """Random scale/rot/color/flip draw (ref :114-127)."""
    r = rng or np.random.default_rng()
    scale = float(np.clip(r.standard_normal(), -1.0, 1.0)) * 0.25 + 1.0
    rot = float(np.clip(r.standard_normal(), -2.0, 2.0)) * 30 if r.uniform() <= 0.6 else 0.0
    color_scale = r.uniform(0.8, 1.2, size=3)
    do_flip = bool(r.uniform() <= 0.5)
    return scale, rot, color_scale, do_flip


def generate_patch_image(img, bbox_xywh, scale, rot_deg, do_flip, out_shape):
    """Affine crop to out_shape (H, W); returns (patch, trans, inv_trans).

    Ref :146-172. `img` is [H, W, 3] float or uint8; bbox is xywh.
    """
    import cv2

    img = np.asarray(img)
    H, W = img.shape[:2]
    cx = float(bbox_xywh[0] + 0.5 * bbox_xywh[2])
    cy = float(bbox_xywh[1] + 0.5 * bbox_xywh[3])
    bw, bh = float(bbox_xywh[2]), float(bbox_xywh[3])
    if do_flip:
        img = img[:, ::-1]
        cx = W - cx - 1
    trans = gen_trans_from_patch(cx, cy, bw, bh, out_shape[1], out_shape[0], scale, rot_deg)
    patch = cv2.warpAffine(
        np.ascontiguousarray(img, np.float32), trans,
        (int(out_shape[1]), int(out_shape[0])), flags=cv2.INTER_LINEAR,
    )
    inv_trans = gen_trans_from_patch(
        cx, cy, bw, bh, out_shape[1], out_shape[0], scale, rot_deg, inv=True
    )
    return patch.astype(np.float32), trans, inv_trans


def augmentation(
    img, bbox_xywh, data_split: str,
    enforce_flip: Optional[bool] = None,
    cfg: LegacyAugConfig = LegacyAugConfig(),
    rng: Optional[np.random.Generator] = None,
):
    """Train-time crop augmentation (ref :129-144). img values in [0, 255]."""
    if data_split == "train":
        scale, rot, color_scale, do_flip = get_aug_config(rng)
    else:
        scale, rot, color_scale, do_flip = 1.0, 0.0, np.ones(3), False
    if enforce_flip is not None:
        do_flip = enforce_flip
    patch, trans, inv_trans = generate_patch_image(
        img, bbox_xywh, scale, rot, do_flip, cfg.input_img_shape
    )
    patch = np.clip(patch * color_scale[None, None, :], 0, 255)
    return patch, trans, inv_trans, rot, do_flip


def _rot_aug_mat(rot_deg: float) -> np.ndarray:
    r = np.deg2rad(-rot_deg)
    return np.asarray(
        [[np.cos(r), -np.sin(r), 0], [np.sin(r), np.cos(r), 0], [0, 0, 1]],
        np.float32,
    )


def _to_heatmap_space(joint_img, img2bb_trans, cfg: LegacyAugConfig):
    joint_img = joint_img.copy()
    xy1 = np.concatenate([joint_img[:, :2], np.ones_like(joint_img[:, :1])], 1)
    joint_img[:, :2] = xy1 @ img2bb_trans.T
    joint_img[:, 0] *= cfg.output_body_hm_shape[2] / cfg.input_img_shape[1]
    joint_img[:, 1] *= cfg.output_body_hm_shape[1] / cfg.input_img_shape[0]
    joint_img[:, 2] = (
        (joint_img[:, 2] / (cfg.bbox_3d_size / 2) + 1) / 2.0
        * cfg.output_body_hm_shape[0]
    )
    return joint_img


def _truncation(joint_img, joint_valid, cfg: LegacyAugConfig):
    D, Hh, Wh = cfg.output_body_hm_shape
    inside = (
        (joint_img[:, 0] >= 0) & (joint_img[:, 0] < Wh)
        & (joint_img[:, 1] >= 0) & (joint_img[:, 1] < Hh)
        & (joint_img[:, 2] >= 0) & (joint_img[:, 2] < D)
    )
    return (joint_valid * inside.reshape(-1, 1)).astype(np.float32)


def process_hand_bbox(
    bbox_xyxy, do_flip: bool, img_shape, img2bb_trans,
    cfg: LegacyAugConfig = LegacyAugConfig(),
):
    """Hand bbox -> augmented heatmap space (ref `InterHand26M.py:297-341`).

    ``bbox_xyxy`` is [4] (xmin, ymin, xmax, ymax) in the original image, or
    None for an absent hand. Returns (bbox [2,2] tl/br in
    output_body_hm_shape coords, valid flag): the four corners are pushed
    through the crop affine, then re-boxed axis-aligned.
    """
    if bbox_xyxy is None:
        return np.array([[0, 0], [1, 1]], np.float32), 0.0
    xmin, ymin, xmax, ymax = np.asarray(bbox_xyxy, np.float32).reshape(4)
    if do_flip:
        # mirror then swap so xmin <= xmax again (ref :306-311)
        xmin, xmax = img_shape[1] - xmax - 1, img_shape[1] - xmin - 1
    corners = np.asarray(
        [[xmin, ymin], [xmax, ymin], [xmax, ymax], [xmin, ymax]], np.float32
    )
    xy1 = np.concatenate([corners, np.ones((4, 1), np.float32)], 1)
    corners = xy1 @ np.asarray(img2bb_trans, np.float32).T
    corners[:, 0] *= cfg.output_body_hm_shape[2] / cfg.input_img_shape[1]
    corners[:, 1] *= cfg.output_body_hm_shape[1] / cfg.input_img_shape[0]
    out = np.asarray(
        [[corners[:, 0].min(), corners[:, 1].min()],
         [corners[:, 0].max(), corners[:, 1].max()]], np.float32
    )
    return out, 1.0


def crop_img(img_hwc, bbox_center, bbox_size, squarify=True, avoid_zero=False):
    """Sub-crop of an (augmented) patch at its own resolution
    (ref `utils/preprocessing.py:60-88`; kornia crop_and_resize parity via
    ops.resample). ``img_hwc`` is [H, W, 3] float; center/size are
    (horizontal, vertical) pixel tuples. Output size equals the (squarified)
    bbox size — variable per item, like the reference.
    """
    w_center, h_center = float(bbox_center[0]), float(bbox_center[1])
    width, height = float(bbox_size[0]), float(bbox_size[1])
    if squarify:
        width = height = max(width, height)
    if avoid_zero:
        width = max(width, 2.0)
        height = max(height, 2.0)
    w_min, w_max = w_center - width / 2, w_center + width / 2
    h_min, h_max = h_center - height / 2, h_center + height / 2
    corners = np.asarray(
        [[w_min, h_min], [w_max, h_min], [w_max, h_max], [w_min, h_max]],
        np.float32,
    )
    from ..ops.resample import crop_and_resize_np

    out = crop_and_resize_np(
        np.ascontiguousarray(img_hwc, np.float32)[None], corners[None],
        (int(height), int(width)),
    )
    return out[0]


def resize_img(img_hwc, out_hw: Tuple[int, int]):
    """Bilinear resize standing in for the reference's externally-supplied
    ``post_transform`` (`InterHand26M.py:38,563`): items must be collatable,
    so hand crops are resized to a fixed shape."""
    import cv2

    return cv2.resize(
        np.ascontiguousarray(img_hwc, np.float32),
        (int(out_hw[1]), int(out_hw[0])), interpolation=cv2.INTER_LINEAR,
    )


def transform_db_data(
    joint_img, joint_cam, joint_valid, rel_trans,
    do_flip: bool, img_shape, flip_pairs: Sequence[Tuple[int, int]],
    img2bb_trans, rot_deg: float,
    cfg: LegacyAugConfig = LegacyAugConfig(),
    src_names: Optional[Sequence[str]] = None,
    dst_names: Optional[Sequence[str]] = None,
):
    """GT joints -> augmented crop/heatmap space (ref :233-270).

    joint_img is [J, 3] (u, v, root-relative depth); returns
    (joint_img_hm, joint_cam, joint_valid, joint_trunc, rel_trans).
    ``src_names``/``dst_names`` reorder the outputs between joint
    conventions (ref `transform_joint_to_other_db`, equal name sets here so
    it is a pure permutation); omitted = keep the input order.
    """
    joint_img = joint_img.copy()
    joint_cam = joint_cam.copy()
    joint_valid = joint_valid.copy()
    rel_trans = np.asarray(rel_trans, np.float32).copy()

    if do_flip:
        joint_cam[:, 0] = -joint_cam[:, 0]
        joint_img[:, 0] = img_shape[1] - 1 - joint_img[:, 0]
        rel_trans[1:3] = -rel_trans[1:3]
        for a, b in flip_pairs:
            joint_img[[a, b]] = joint_img[[b, a]]
            joint_cam[[a, b]] = joint_cam[[b, a]]
            joint_valid[[a, b]] = joint_valid[[b, a]]

    R = _rot_aug_mat(rot_deg)
    joint_cam = joint_cam @ R.T
    rel_trans = R @ rel_trans

    joint_img = _to_heatmap_space(joint_img, img2bb_trans, cfg)
    joint_trunc = _truncation(joint_img, joint_valid, cfg)
    if src_names is not None and dst_names is not None:
        from ..core.joints import reorder_indices

        idx = reorder_indices(tuple(src_names), tuple(dst_names))
        joint_img, joint_cam = joint_img[idx], joint_cam[idx]
        joint_valid, joint_trunc = joint_valid[idx], joint_trunc[idx]
    return joint_img, joint_cam, joint_valid, joint_trunc, rel_trans


def transform_mano_data(
    joint_img, joint_cam, mesh_cam, joint_valid, rel_trans, pose,
    img2bb_trans, rot_deg: float,
    cfg: LegacyAugConfig = LegacyAugConfig(),
):
    """MANO GT -> augmented space incl. root-pose rotation (ref :272-306)."""
    joint_img = joint_img.copy()
    pose = np.asarray(pose, np.float32).reshape(-1, 3).copy()

    R = _rot_aug_mat(rot_deg)
    mesh_cam = np.asarray(mesh_cam) @ R.T
    joint_cam = np.asarray(joint_cam) @ R.T
    rel_trans = R @ np.asarray(rel_trans, np.float32)

    # rotate the per-hand root poses (two 16-joint hands stacked)
    n_joints = pose.shape[0]
    for root_idx in (0, 16):
        if root_idx < n_joints:
            root_mat = Rotation.from_rotvec(pose[root_idx]).as_matrix()
            pose[root_idx] = Rotation.from_matrix(R @ root_mat).as_rotvec()

    joint_img = _to_heatmap_space(joint_img, img2bb_trans, cfg)
    joint_trunc = _truncation(joint_img, joint_valid, cfg)
    return joint_img, joint_cam, mesh_cam, joint_trunc, rel_trans, pose.reshape(-1)
