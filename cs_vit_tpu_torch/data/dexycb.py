"""DexYCB sequence dataset (H5-backed), numpy host pipeline (copy of
``cs_vit_tpu/data/dexycb.py``; ``h5py`` and ``cv2`` are imported where the
files are read, so the module imports without them).

Schema/behavior parity: `cs_vit/dataset/DexYCB.py:17-244`.
H5 layout: ``{protocol}_{split}.h5`` with
``/sequences/<name>/{imgs_path, handedness, joint_2d, joint_3d, intrinsics,
pose_m, beta}``. PCA hand pose is expanded with ``mano_lr_pca.npz``.

Replicated quirk (flag ``compat_pose_slice``, default True): the reference
reads MANO pose from frames ``[0:T]`` instead of ``[ix:ix+T]``
(`DexYCB.py:144-147`); checkpointed training consumed that data.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict

import numpy as np

from ..ops.resample import crop_with_square_box_np
from .base import SlidingWindowDataset
from .transforms_np import (
    horizontal_flip_annotations,
    random_photometric_aug,
    rotation_augmentation,
)

_ASSET_DIR = osp.join(osp.dirname(__file__), "..", "assets")


def load_image_rgb(path: str, as_float: bool = True) -> np.ndarray:
    """Decode to RGB; ``as_float=False`` keeps uint8 (the crop and the
    flip take uint8 frames, and the crop converts to float itself)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img.astype(np.float32) / 255.0 if as_float else img


def open_h5(path: str):
    """The HDF5 file at `path`, open for reading."""
    import h5py

    return h5py.File(path, "r")


class DexYCB(SlidingWindowDataset):
    FPS_STEP_MS = 33.333

    def __init__(
        self,
        root: str,
        num_frames: int,
        protocol: str,
        data_split: str,
        img_size: int = 224,
        expansion_ratio: float = 1.25,
        compat_pose_slice: bool = True,
        seed: int = 0,
        store=None,
    ):
        """`store`, when given, stands in for the HDF5 file (anything that
        answers ``store[path]`` and ``.items()`` as an ``h5py.File`` does)."""
        super().__init__(num_frames)
        self.root = root
        self.protocol = protocol
        self.data_split = data_split
        self.img_size = img_size
        self.expansion_ratio = expansion_ratio
        self.compat_pose_slice = compat_pose_slice
        self._seed = seed

        pca = np.load(osp.join(_ASSET_DIR, "mano_lr_pca.npz"))
        self.mano_pca = {k: pca[k].astype(np.float32) for k in ("left", "right")}

        self.h5 = store if store is not None else open_h5(
            osp.join(root, f"{protocol}_{data_split}.h5"))
        entries = []
        for name, seq in self.h5["sequences"].items():
            entries.append(
                {"path_h5": f"/sequences/{name}", "seq_length": seq["imgs_path"].shape[0]}
            )
        self.build_index(entries)

    def __getitem__(self, ix: int) -> Dict:
        group_ix, off = self.locate(ix)
        annot = self.h5[self.seq_index[group_ix]["path_h5"]]
        T = self.num_frames

        imgs_path = [
            osp.join(self.root, str(v, "utf8"))
            for v in annot["imgs_path"][off : off + T]
        ]
        handedness = str(annot["handedness"][0], "utf-8")
        joint_img = annot["joint_2d"][off : off + T].astype(np.float32)
        joint_cam = annot["joint_3d"][off : off + T].astype(np.float32) * 1e3
        joint_rel = joint_cam - joint_cam[:, :1]
        intr = annot["intrinsics"][:].astype(np.float32).reshape(3, 3)
        focal = np.tile(np.asarray([intr[0, 0], intr[1, 1]], np.float32), (T, 1))
        princpt = np.tile(np.asarray([intr[0, 2], intr[1, 2]], np.float32), (T, 1))

        # tight bbox from 2D joints, expanded by 1.2 about center (ref :122-132)
        x1, x2 = joint_img[..., 0].min(1), joint_img[..., 0].max(1)
        y1, y2 = joint_img[..., 1].min(1), joint_img[..., 1].max(1)
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        wx, wy = (x2 - x1) / 2, (y2 - y1) / 2
        bbox_tight = np.stack(
            [cx - wx * 1.2, cy - wy * 1.2, cx + wx * 1.2, cy + wy * 1.2], axis=-1
        ).astype(np.float32)
        joint_bbox_img = joint_img - bbox_tight[:, None, :2]

        img_seq = np.stack([load_image_rgb(p, as_float=False) for p in imgs_path])  # [T,H,W,3] uint8

        # MANO: PCA coeffs -> full 45-d pose (ref :144-147, incl. [0:T] quirk)
        pose_slice = slice(0, T) if self.compat_pose_slice else slice(off, off + T)
        mano_pose = annot["pose_m"][pose_slice][:, :48].astype(np.float32)
        mano_pose = np.concatenate(
            [mano_pose[:, :3], mano_pose[:, 3:] @ self.mano_pca[handedness]], axis=1
        )
        mano_shape = np.tile(annot["beta"][:].astype(np.float32)[None], (T, 1))

        flip = handedness[0] == "l"
        if flip:
            (
                img_seq, bbox_tight, joint_img, joint_bbox_img,
                joint_cam, joint_rel, mano_pose, princpt,
            ) = horizontal_flip_annotations(
                img_seq, bbox_tight, joint_img, joint_bbox_img,
                joint_cam, joint_rel, mano_pose, princpt,
            )

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
            "flip": flip,
            "rot_rad": rot_rad,
            "patches": patches.astype(np.float32),       # [T,S,S,3] NHWC
            "square_bboxes": square_bboxes.astype(np.float32),
            "bbox_tight": bbox_tight.astype(np.float32),
            "joint_img": joint_img.astype(np.float32),
            "joint_bbox_img": joint_bbox_img.astype(np.float32),
            "joint_cam": joint_cam.astype(np.float32),
            "joint_valid": np.ones(joint_cam.shape[:2], np.float32),
            "joint_rel": joint_rel.astype(np.float32),
            "mano_pose": mano_pose.astype(np.float32),
            "mano_shape": mano_shape.astype(np.float32),
            "timestamp": (np.arange(T) * self.FPS_STEP_MS).astype(np.float32),
            "focal": focal,
            "princpt": princpt,
        }
