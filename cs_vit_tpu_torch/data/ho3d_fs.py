"""HO3D filesystem-variant dataset (meta/*.pkl per frame); copy of
``cs_vit_tpu/data/ho3d_fs.py`` (``cv2`` is imported where frames are read).

Parity: `cs_vit/dataset/HO3D.py:21-201` (``HO3D_FS``): scans
``<split>/<seq>/meta/*.pkl``, groups contiguous frame numbers, converts the
OpenGL-convention annotations (y/z negated), rotates the root pose by
R_x(pi), subtracts the ``mano_right_mean`` flat-hand mean, computes the bbox
from projected joints, and crops with the square-box eval path (no aug).
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Dict, List, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from ..constants import HO3D_JOINTS_ORDER, TARGET_JOINTS_ORDER
from ..core.joints import reorder_indices
from ..ops.resample import crop_with_square_box_np
from .base import SlidingWindowDataset
from .dexycb import load_image_rgb

_ASSET_DIR = osp.join(osp.dirname(__file__), "..", "assets")
_R_X_PI = np.asarray([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)


class HO3D_FS(SlidingWindowDataset):
    """30 FPS sequences read straight from the HO3D directory layout."""

    FPS_STEP_MS = 33.33333

    def __init__(
        self,
        root: str,
        num_frames: int,
        data_split: str,
        img_size: int = 224,
        expansion_ratio: float = 1.25,
    ):
        assert data_split in ("train", "evaluation")
        super().__init__(num_frames)
        self.root = root
        self.data_split = data_split
        self.img_size = img_size
        self.expansion_ratio = expansion_ratio
        self.rmano_pose_mean = np.load(
            osp.join(_ASSET_DIR, "mano_right_mean.npy")
        ).astype(np.float32)
        self._reorder = reorder_indices(HO3D_JOINTS_ORDER, TARGET_JOINTS_ORDER)

        # build contiguous-frame groups with valid annotations (ref :44-82)
        self.annot_seqs: List[List[Tuple[str, str]]] = []
        split_dir = osp.join(root, data_split)
        for seq in sorted(os.listdir(split_dir)):
            meta_dir = osp.join(split_dir, seq, "meta")
            if not osp.isdir(meta_dir):
                continue
            frames = sorted(
                f[:-4] for f in os.listdir(meta_dir) if f.endswith(".pkl")
            )
            group: List[Tuple[str, str]] = []
            prev = -1
            for name in frames:
                num = int(name)
                with open(osp.join(meta_dir, name + ".pkl"), "rb") as f:
                    annot = pickle.load(f)
                if any(
                    annot.get(k) is None
                    for k in ("handJoints3D", "camMat", "handPose", "handBeta")
                ):
                    continue
                pair = (
                    osp.join(data_split, seq, "rgb", name + ".jpg"),
                    osp.join(data_split, seq, "meta", name + ".pkl"),
                )
                if not group or prev + 1 == num:
                    group.append(pair)
                else:
                    if group:
                        self.annot_seqs.append(group)
                    group = [pair]
                prev = num
            if group:
                self.annot_seqs.append(group)

        self.build_index(
            [
                {"path_h5": i, "seq_length": len(seq)}
                for i, seq in enumerate(self.annot_seqs)
            ]
        )

    def __getitem__(self, ix: int) -> Dict:
        group_ix, off = self.locate(ix)
        seq = self.annot_seqs[self.seq_index[group_ix]["path_h5"]]
        frames = seq[off : off + self.num_frames]
        T = self.num_frames

        imgs, joint_cam, joint_img = [], [], []
        mano_pose = np.empty((T, 48), np.float32)
        mano_shape = np.empty((T, 10), np.float32)
        focal = np.empty((T, 2), np.float32)
        princpt = np.empty((T, 2), np.float32)
        for t, (img_rel, meta_rel) in enumerate(frames):
            imgs.append(load_image_rgb(osp.join(self.root, img_rel), as_float=False))
            with open(osp.join(self.root, meta_rel), "rb") as f:
                annot = pickle.load(f)
            jc = np.asarray(annot["handJoints3D"], np.float64) * np.asarray(
                [1, -1, -1], np.float64
            )
            joint_cam.append(jc * 1e3)  # mm
            proj = jc @ np.asarray(annot["camMat"], np.float64).T
            joint_img.append(proj[:, :2] / proj[:, 2:])
            cam = np.asarray(annot["camMat"], np.float64)
            focal[t] = (cam[0, 0], cam[1, 1])
            princpt[t] = (cam[0, 2], cam[1, 2])

            pose = np.asarray(annot["handPose"], np.float64).copy()
            root_mat = Rotation.from_rotvec(pose[:3]).as_matrix()
            pose[:3] = Rotation.from_matrix(_R_X_PI @ root_mat).as_rotvec()
            pose[3:] -= self.rmano_pose_mean
            mano_pose[t] = pose.astype(np.float32)
            mano_shape[t] = np.asarray(annot["handBeta"], np.float32)

        img_seq = np.stack(imgs)
        joint_cam = np.stack(joint_cam).astype(np.float32)
        joint_img = np.stack(joint_img).astype(np.float32)
        joint_rel = joint_cam - joint_cam[:, :1]

        # bbox from projected joints expanded 1.2x (ref :147-159)
        x1, x2 = joint_img[..., 0].min(1), joint_img[..., 0].max(1)
        y1, y2 = joint_img[..., 1].min(1), joint_img[..., 1].max(1)
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        wx, wy = (x2 - x1) / 2, (y2 - y1) / 2
        bbox_tight = np.stack(
            [cx - wx * 1.2, cy - wy * 1.2, cx + wx * 1.2, cy + wy * 1.2], axis=-1
        ).astype(np.float32)
        joint_bbox_img = joint_img - bbox_tight[:, None, :2]

        patches, bbox_scale_coef, square_bboxes = crop_with_square_box_np(
            img_seq, bbox_tight, self.expansion_ratio, self.img_size
        )

        reorder = self._reorder
        return {
            "imgs_path": [osp.join(self.root, p[0]) for p in frames],
            "flip": False,
            "patches": patches.astype(np.float32),
            "bbox_scale_coef": bbox_scale_coef,
            "square_bboxes": square_bboxes.astype(np.float32),
            "bbox_tight": bbox_tight,
            "joint_img": joint_img[:, reorder],
            "joint_bbox_img": joint_bbox_img[:, reorder],
            "joint_cam": joint_cam[:, reorder],
            "joint_rel": joint_rel[:, reorder],
            "mano_pose": mano_pose,
            "mano_shape": mano_shape,
            "timestamp": (np.arange(T) * self.FPS_STEP_MS).astype(np.float32),
            "focal": focal,
            "princpt": princpt,
        }
