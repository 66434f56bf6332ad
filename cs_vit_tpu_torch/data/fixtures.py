"""Synthetic DexYCB store matching the real dataset's schema (port of the
DexYCB part of ``cs_vit_tpu/data/fixtures.py``).

Writes a tiny DexYCB tree with real JPEG images on disk so the full data path
(decode -> flip -> aug -> crop -> collate) runs without the licensed dataset.
From the same seed it writes the same files as the JAX package's
``make_synthetic_dexycb``: the same HDF5 datasets and the same JPEG bytes.
:func:`synthetic_dexycb_sequences` gives the same arrays without writing them.
``h5py`` and ``cv2`` are imported by the functions that write files.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Iterator, Tuple

import numpy as np


def _random_images(n: int, size: Tuple[int, int], rng) -> np.ndarray:
    """n uint8 [H,W,3] noise images, drawn one after another from `rng`."""
    return np.stack([(rng.uniform(size=(size[0], size[1], 3)) * 255).astype(np.uint8)
                     for _ in range(n)])


def _write_images(root: str, rel_paths, images: np.ndarray) -> None:
    import cv2

    for rel, img in zip(rel_paths, images):
        path = osp.join(root, rel)
        os.makedirs(osp.dirname(path), exist_ok=True)
        cv2.imwrite(path, img)


def _joints_2d3d(rng, T, img_hw, focal, princpt):
    """Random wrist trajectory with joints nearby, projected consistently."""
    J = 21
    root3d = np.stack(
        [
            rng.uniform(-50, 50, T),
            rng.uniform(-50, 50, T),
            rng.uniform(400, 600, T),
        ],
        axis=-1,
    )
    offsets = rng.uniform(-40, 40, size=(T, J, 3))
    offsets[:, 0] = 0
    joint_cam = root3d[:, None] + offsets  # mm
    z = joint_cam[..., 2]
    u = focal[0] * joint_cam[..., 0] / z + princpt[0]
    v = focal[1] * joint_cam[..., 1] / z + princpt[1]
    u = np.clip(u, 20, img_hw[1] - 20)
    v = np.clip(v, 20, img_hw[0] - 20)
    joint_img = np.stack([u, v], axis=-1)
    return joint_cam.astype(np.float32), joint_img.astype(np.float32)


def synthetic_dexycb_sequences(
    splits=("train", "test"),
    num_seqs: int = 2,
    seq_len: int = 8,
    img_hw=(120, 160),
    seed: int = 0,
) -> Iterator[Tuple[str, str, Dict[str, np.ndarray]]]:
    """(split, sequence name, arrays) in the order the store is written.

    The arrays are the sequence's HDF5 datasets (``imgs_path``,
    ``handedness``, ``joint_3d`` in metres, ``joint_2d``, ``intrinsics``,
    ``pose_m``, ``beta``) and ``images``, its uint8 frames before JPEG
    encoding. The draws from the one generator come in the JAX fixture's
    order, so both give the same values from the same seed."""
    rng = np.random.default_rng(seed)
    focal = (240.0, 240.0)
    princpt = (img_hw[1] / 2, img_hw[0] / 2)
    intr = np.asarray(
        [[focal[0], 0, princpt[0]], [0, focal[1], princpt[1]], [0, 0, 1]], np.float32,
    )
    for split in splits:
        for s in range(num_seqs):
            rels = [f"images/seq{s:03d}/{split}_{t:04d}.jpg" for t in range(seq_len)]
            images = _random_images(seq_len, img_hw, rng)
            jc, ji = _joints_2d3d(rng, seq_len, img_hw, focal, princpt)
            yield split, f"seq{s:03d}", {
                "images": images,
                "imgs_path": np.asarray([r.encode() for r in rels]),
                "handedness": np.asarray([b"right" if s % 2 == 0 else b"left"]),
                "joint_3d": jc / 1e3,  # metres
                "joint_2d": ji,
                "intrinsics": intr.reshape(-1),
                "pose_m": rng.normal(scale=0.3, size=(seq_len, 51)).astype(np.float32),
                "beta": rng.normal(scale=0.5, size=(10,)).astype(np.float32),
            }


def make_synthetic_dexycb(
    root: str,
    protocol: str = "s1",
    splits=("train", "test"),
    num_seqs: int = 2,
    seq_len: int = 8,
    img_hw=(120, 160),
    seed: int = 0,
) -> str:
    """Write ``<root>/{protocol}_{split}.h5`` and the JPEG frames; returns root."""
    import h5py

    os.makedirs(root, exist_ok=True)
    seqs = synthetic_dexycb_sequences(splits, num_seqs, seq_len, img_hw, seed)
    for split in splits:
        with h5py.File(osp.join(root, f"{protocol}_{split}.h5"), "w") as f:
            g = f.create_group("sequences")
            for _ in range(num_seqs):
                _, name, arrays = next(seqs)
                _write_images(root, [r.decode() for r in arrays["imgs_path"]], arrays["images"])
                seq = g.create_group(name)
                for key in ("imgs_path", "handedness", "joint_3d", "joint_2d", "intrinsics",
                            "pose_m", "beta"):
                    seq.create_dataset(key, data=arrays[key])
    return root
