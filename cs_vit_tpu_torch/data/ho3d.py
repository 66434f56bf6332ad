"""HO3D sequence dataset (H5-backed), numpy host pipeline (copy of
``cs_vit_tpu/data/ho3d.py``; ``h5py`` and ``cv2`` are imported where the
files are read, so the module imports without them).

Schema/behavior parity: `cs_vit/dataset/HO3D.py:204-401`.
H5 layout: ``{split}_ho3d_seq.h5`` with per-sequence precomputed
``img_path, bbox_tight, bbox_scale_coef, square_bboxes, joint_img,
joint_bbox_img, joint_cam, joint_rel, mano_pose, mano_shape, focal, princpt``.
Joints are stored in HO3D order and reordered to TARGET order here.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict

import numpy as np

from ..constants import HO3D_JOINTS_ORDER, TARGET_JOINTS_ORDER
from ..core.joints import reorder_indices
from ..ops.resample import crop_with_square_box_np
from .base import SlidingWindowDataset
from .dexycb import load_image_rgb, open_h5
from .transforms_np import random_photometric_aug, rotation_augmentation


class HO3D(SlidingWindowDataset):
    FPS_STEP_MS = 33.33333

    def __init__(
        self,
        root: str,
        num_frames: int,
        data_split: str,
        img_size: int = 224,
        expansion_ratio: float = 1.25,
        seed: int = 0,
        store=None,
    ):
        """`store`, when given, stands in for the HDF5 file (anything that
        answers ``store[path]`` and ``.items()`` as an ``h5py.File`` does)."""
        assert data_split in ("train", "evaluation")
        super().__init__(num_frames)
        self.root = root
        self.data_split = data_split
        self.img_size = img_size
        self.expansion_ratio = expansion_ratio
        self._seed = seed
        self._reorder = reorder_indices(HO3D_JOINTS_ORDER, TARGET_JOINTS_ORDER)

        self.h5 = store if store is not None else open_h5(
            osp.join(root, f"{data_split}_ho3d_seq.h5"))
        entries = [
            {"path_h5": f"/sequences/{name}", "seq_length": seq["img_path"].shape[0]}
            for name, seq in self.h5["sequences"].items()
        ]
        self.build_index(entries)

    def __getitem__(self, ix: int) -> Dict:
        group_ix, off = self.locate(ix)
        annot = self.h5[self.seq_index[group_ix]["path_h5"]]
        T = self.num_frames
        sl = slice(off, off + T)

        imgs_path = [osp.join(self.root, str(v, "utf8")) for v in annot["img_path"][sl]]
        read = lambda key: annot[key][sl].astype(np.float32)  # noqa: E731
        bbox_tight = read("bbox_tight")
        square_bboxes = read("square_bboxes")
        joint_img = read("joint_img")[:, self._reorder]
        joint_bbox_img = read("joint_bbox_img")[:, self._reorder]
        joint_cam = read("joint_cam")[:, self._reorder]
        joint_rel = read("joint_rel")[:, self._reorder]
        mano_pose = read("mano_pose")
        mano_shape = read("mano_shape")
        focal = read("focal")
        princpt = read("princpt")

        img_seq = np.stack([load_image_rgb(p, as_float=False) for p in imgs_path])

        rot_rad = np.zeros((T,), np.float32)
        if self.data_split == "train":
            rng = self._item_rng(ix)
            aug = rotation_augmentation(
                img_seq, joint_cam, joint_rel, joint_img, mano_pose, princpt,
                self.expansion_ratio, self.img_size, rng,
            )
            rot_rad = aug["rot_rad"]
            patches = random_photometric_aug(aug["patches"], rng)
            square_bboxes = aug["square_bboxes"]
            bbox_tight = aug["bbox_tight"]
            joint_img = aug["joint_img"]
            joint_bbox_img = aug["joint_bbox_img"]
            joint_cam = aug["joint_cam"]
            joint_rel = aug["joint_rel"]
            mano_pose = aug["mano_pose"]
        else:
            patches, _, square_bboxes = crop_with_square_box_np(
                img_seq, bbox_tight, self.expansion_ratio, self.img_size
            )

        return {
            "imgs_path": imgs_path,
            "flip": False,  # all HO3D hands are right hands
            "rot_rad": rot_rad,
            "patches": patches.astype(np.float32),
            "square_bboxes": square_bboxes.astype(np.float32),
            "bbox_tight": bbox_tight.astype(np.float32),
            "joint_img": joint_img,
            "joint_bbox_img": joint_bbox_img,
            "joint_cam": joint_cam,
            "joint_valid": np.ones(joint_cam.shape[:2], np.float32),
            "joint_rel": joint_rel,
            "mano_pose": mano_pose,
            "mano_shape": mano_shape,
            "timestamp": (np.arange(T) * self.FPS_STEP_MS).astype(np.float32),
            "focal": focal,
            "princpt": princpt,
        }
