"""InterHand2.6M sequence dataset (H5-backed), numpy host pipeline (copy of
``cs_vit_tpu/data/ih26m_seq.py``; ``h5py`` and ``cv2`` are imported where
the files are read, so the module imports without them).

Schema/behavior parity: `cs_vit/dataset/InterHand26M/InterHand26MSeq.py`.
H5 layout: ``annotations/<split>/seq.h5`` with hierarchy
``<capture>/<seq>/<cam>/<hand>/<frame_range>/annots/{img_path, frame_idx,
handedness, bbox_tight, joint_img, joint_bbox_img, joint_cam, joint_valid,
joint_rel, mano_pose, mano_shape, focal, princpt}``. Joints stored in IH26M
right-hand order; left hands are mirrored to right. Pickle index cache under
``__cache__/`` mirrors the reference's (`InterHand26MSeq.py:80-116`).
"""

from __future__ import annotations

import os.path as osp
import pickle
from pathlib import Path
from typing import Dict

import numpy as np

from ..constants import IH26M_RJOINTS_ORDER, TARGET_JOINTS_ORDER
from ..core.joints import reorder_indices
from ..ops.resample import crop_with_square_box_np
from .base import SlidingWindowDataset
from .dexycb import load_image_rgb, open_h5
from .transforms_np import (
    horizontal_flip_annotations,
    random_photometric_aug,
    rotation_augmentation,
)


class InterHand26MSeq(SlidingWindowDataset):
    FPS_STEP_MS = 200.0  # 5 fps

    def __init__(
        self,
        root: str,
        num_frames: int,
        data_split: str,
        img_size: int = 224,
        expansion_ratio: float = 2.0,
        seed: int = 0,
        cache_dir: str | None = None,
        store=None,
    ):
        """`store`, when given, stands in for the HDF5 file (anything that
        answers ``store[path]`` and ``.items()`` as an ``h5py.File`` does)."""
        assert data_split in ("train", "test")
        super().__init__(num_frames)
        self.root = root
        self.data_split = data_split
        self.img_size = img_size
        self.expansion_ratio = expansion_ratio
        self.img_path = osp.join(root, "images", data_split)
        self.annot_path = osp.join(root, "annotations", data_split)
        self._seed = seed
        self._reorder = reorder_indices(IH26M_RJOINTS_ORDER, TARGET_JOINTS_ORDER)

        self.h5 = store if store is not None else open_h5(osp.join(self.annot_path, "seq.h5"))

        cache_dir = cache_dir or osp.join(root, "__cache__")
        cache_file = osp.join(cache_dir, f"ih26mseq_{data_split}_{num_frames}.pkl")
        if osp.exists(cache_file):
            with open(cache_file, "rb") as f:
                entries = pickle.load(f)
        else:
            entries = []
            for capture_id, capture in self.h5.items():
                for seq_name, sequence in capture.items():
                    for cam_id, camera in sequence.items():
                        for handedness, hand in camera.items():
                            for fr_name, fr in hand.items():
                                entries.append({
                                    "path_h5": "/".join(
                                        (capture_id, seq_name, cam_id, handedness, fr_name)
                                    ),
                                    "seq_length": fr["annots"]["img_path"].shape[0],
                                })
            Path(cache_dir).mkdir(parents=True, exist_ok=True)
            with open(cache_file, "wb") as f:
                pickle.dump(entries, f)
        self.build_index(entries)

    def __getitem__(self, ix: int) -> Dict:
        group_ix, off = self.locate(ix)
        annot = self.h5[self.seq_index[group_ix]["path_h5"]]["annots"]
        T = self.num_frames
        sl = slice(off, off + T)

        img_path = [str(v, "utf8") for v in annot["img_path"][sl]]
        handedness = [str(v, "utf8") for v in annot["handedness"][sl]]
        read = lambda key: annot[key][sl].astype(np.float32)  # noqa: E731
        bbox_tight = read("bbox_tight")
        joint_img = read("joint_img")
        joint_bbox_img = read("joint_bbox_img")
        joint_cam = read("joint_cam")
        joint_valid = read("joint_valid")
        joint_rel = read("joint_rel")
        mano_pose = read("mano_pose")
        mano_shape = read("mano_shape")
        focal = read("focal")
        princpt = read("princpt")

        # per-frame photometric aug BEFORE crop (ref `InterHand26MSeq.py:209-216`)
        # train keeps float frames (photometric aug runs on the FULL frame
        # before the crop, ref `InterHand26MSeq.py:209-216`); eval stays uint8
        # so the crop kernel does the only float conversion.
        as_float = self.data_split == "train"
        img_seq = np.stack(
            [
                load_image_rgb(osp.join(self.img_path, p), as_float=as_float)
                for p in img_path
            ]
        )
        rng = self._item_rng(ix) if self.data_split == "train" else None
        if self.data_split == "train":
            img_seq = np.stack(
                [random_photometric_aug(f, rng) for f in img_seq]
            )

        flip = handedness[0][0] == "l"
        if flip:
            (
                img_seq, bbox_tight, joint_img, joint_bbox_img,
                joint_cam, joint_rel, mano_pose, princpt,
            ) = horizontal_flip_annotations(
                img_seq, bbox_tight, joint_img, joint_bbox_img,
                joint_cam, joint_rel, mano_pose, princpt,
            )

        # reorder IH26M -> TARGET, then recompute joint_rel (ref :234-249).
        # Deviation: the reference forgets to reorder joint_valid (it stays in
        # IH26M order while the joints move to TARGET order) — we reorder it
        # too, since the mask must follow its joints.
        joint_img = joint_img[:, self._reorder]
        joint_bbox_img = joint_bbox_img[:, self._reorder]
        joint_cam = joint_cam[:, self._reorder]
        joint_valid = joint_valid[:, self._reorder]
        joint_rel = joint_cam - joint_cam[:, :1]

        rot_rad = np.zeros((T,), np.float32)
        if self.data_split == "train":
            aug = rotation_augmentation(
                img_seq, joint_cam, joint_rel, joint_img, mano_pose, princpt,
                self.expansion_ratio, self.img_size, rng,
            )
            rot_rad = aug["rot_rad"]
            patches = aug["patches"]
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
            "imgs_path": [osp.join(self.img_path, p) for p in img_path],
            "flip": flip,
            "rot_rad": rot_rad,
            "patches": patches.astype(np.float32),
            "square_bboxes": square_bboxes.astype(np.float32),
            "bbox_tight": bbox_tight.astype(np.float32),
            "joint_img": joint_img.astype(np.float32),
            "joint_bbox_img": joint_bbox_img.astype(np.float32),
            "joint_cam": joint_cam.astype(np.float32),
            "joint_valid": joint_valid,
            "joint_rel": joint_rel.astype(np.float32),
            "mano_pose": mano_pose.astype(np.float32),
            "mano_shape": mano_shape,
            "timestamp": (np.arange(T) * self.FPS_STEP_MS).astype(np.float32),
            "focal": focal,
            "princpt": princpt,
        }
