"""Synthetic stores matching the real datasets' schemas (port of the
dataset fixtures of ``cs_vit_tpu/data/fixtures.py``).

Writes tiny DexYCB / HO3D / InterHand26MSeq / HO3D_FS / legacy InterHand2.6M
trees, and the TI pretraining sets' image folder, Ego4D and HInt trees, with
real JPEG images on disk so the full data path (decode -> flip ->
aug -> crop -> collate) runs without the licensed datasets. From the same seed
each ``make_synthetic_*`` writes the same files as the JAX package's function
of that name: the same HDF5 datasets, the same JPEG, pickle and JSON bytes.
The ``synthetic_*_sequences`` generators give the HDF5-backed stores' arrays
without writing them, and :class:`MemoryStore` holds them where the datasets
read an HDF5 file (their ``store=`` argument), for a machine without
``h5py``. ``h5py`` and ``cv2`` are imported by the functions that write
files.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np


def _random_images(n: int, size: Tuple[int, int], rng) -> np.ndarray:
    """n uint8 [H,W,3] noise images, drawn one after another from `rng`."""
    return np.stack([(rng.uniform(size=(size[0], size[1], 3)) * 255).astype(np.uint8)
                     for _ in range(n)])


def write_images(root: str, rel_paths, images: np.ndarray) -> None:
    """Write each uint8 [H,W,3] image to ``root/<rel path>`` (JPEG by the
    name's suffix), making the folders."""
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
                write_images(root, [r.decode() for r in arrays["imgs_path"]], arrays["images"])
                seq = g.create_group(name)
                for key in ("imgs_path", "handedness", "joint_3d", "joint_2d", "intrinsics",
                            "pose_m", "beta"):
                    seq.create_dataset(key, data=arrays[key])
    return root


class MemoryStore:
    """An HDF5 file's groups and datasets held in memory, read as the
    datasets read an ``h5py.File``: ``store[path]`` is a group (a
    MemoryStore) or an array, ``items()`` a group's members in name order."""

    def __init__(self, tree: Dict):
        self.tree = tree

    @classmethod
    def of(cls, groups: Iterable[Tuple[str, Dict[str, np.ndarray]]]) -> "MemoryStore":
        """A store holding each (group path, arrays) pair."""
        tree: Dict = {}
        for path, arrays in groups:
            node = tree
            for part in path.strip("/").split("/"):
                node = node.setdefault(part, {})
            node.update(arrays)
        return cls(tree)

    def __getitem__(self, path: str):
        node = self.tree
        for part in path.strip("/").split("/"):
            node = node[part]
        return MemoryStore(node) if isinstance(node, dict) else node

    def items(self):
        return [(k, self[k]) for k in sorted(self.tree)]


def _bbox_of(ji: np.ndarray) -> np.ndarray:
    return np.stack(
        [ji[..., 0].min(1), ji[..., 1].min(1), ji[..., 0].max(1), ji[..., 1].max(1)],
        axis=-1,
    ).astype(np.float32)


def synthetic_ho3d_sequences(
    splits=("train", "evaluation"),
    num_seqs: int = 2,
    seq_len: int = 8,
    img_hw=(120, 160),
    seed: int = 1,
) -> Iterator[Tuple[str, str, Dict[str, np.ndarray]]]:
    """(split, sequence name, arrays) of the HO3D store in the order it is
    written: the ``{split}_ho3d_seq.h5`` datasets of ``/sequences/<name>`` in
    the JAX fixture's order, and ``images``, the uint8 frames of
    ``img_path``. The draws come in the JAX fixture's order."""
    rng = np.random.default_rng(seed)
    focal = np.asarray([240.0, 240.0], np.float32)
    princpt = np.asarray([img_hw[1] / 2, img_hw[0] / 2], np.float32)
    for split in splits:
        for s in range(num_seqs):
            rels = [f"images/ho3d_seq{s:03d}/{split}_{t:04d}.jpg" for t in range(seq_len)]
            images = _random_images(seq_len, img_hw, rng)
            jc, ji = _joints_2d3d(rng, seq_len, img_hw, focal, princpt)
            bbox = _bbox_of(ji)
            side = np.maximum(bbox[:, 2] - bbox[:, 0], bbox[:, 3] - bbox[:, 1])
            c = (bbox[:, :2] + bbox[:, 2:]) / 2
            sq = np.concatenate([c - side[:, None] * 0.625, c + side[:, None] * 0.625], axis=1)
            yield split, f"seq{s:03d}", {
                "images": images,
                "img_path": np.asarray([r.encode() for r in rels]),
                "bbox_tight": bbox,
                "square_bboxes": sq.astype(np.float32),
                "bbox_scale_coef": (side * 1.25 / 224).astype(np.float32),
                "joint_img": ji,
                "joint_bbox_img": ji - bbox[:, None, :2],
                "joint_cam": jc,
                "joint_rel": jc - jc[:, :1],
                "mano_pose": rng.normal(scale=0.3, size=(seq_len, 48)).astype(np.float32),
                "mano_shape": rng.normal(scale=0.5, size=(seq_len, 10)).astype(np.float32),
                "focal": np.tile(focal, (seq_len, 1)),
                "princpt": np.tile(princpt, (seq_len, 1)),
            }


def make_synthetic_ho3d(
    root: str,
    splits=("train", "evaluation"),
    num_seqs: int = 2,
    seq_len: int = 8,
    img_hw=(120, 160),
    seed: int = 1,
) -> str:
    """Write ``<root>/{split}_ho3d_seq.h5`` and the JPEG frames; returns root."""
    import h5py

    os.makedirs(root, exist_ok=True)
    seqs = synthetic_ho3d_sequences(splits, num_seqs, seq_len, img_hw, seed)
    for split in splits:
        with h5py.File(osp.join(root, f"{split}_ho3d_seq.h5"), "w") as f:
            g = f.create_group("sequences")
            for _ in range(num_seqs):
                _, name, arrays = next(seqs)
                seq = g.create_group(name)
                write_images(root, [r.decode() for r in arrays["img_path"]], arrays["images"])
                for key, value in arrays.items():
                    if key != "images":
                        seq.create_dataset(key, data=value)
    return root


def synthetic_ih26mseq_sequences(
    splits=("train", "test"),
    seq_len: int = 8,
    img_hw=(120, 160),
    seed: int = 2,
) -> Iterator[Tuple[str, str, Dict[str, np.ndarray]]]:
    """(split, group path, arrays) of the InterHand26MSeq store in the order
    it is written: the ``annotations/<split>/seq.h5`` datasets of
    ``<group path>/annots`` in the JAX fixture's order (a right and a left
    hand), and ``images``, the uint8 frames of ``img_path`` (relative to
    ``images/<split>``). The draws come in the JAX fixture's order."""
    rng = np.random.default_rng(seed)
    focal = np.asarray([240.0, 240.0], np.float32)
    princpt = np.asarray([img_hw[1] / 2, img_hw[0] / 2], np.float32)
    cap, seqn, cam = "Capture0", "ROM01", "cam400002"
    for split in splits:
        for hand, hstr in (("right", b"right"), ("left", b"left")):
            rels = [f"{cap}/{seqn}/{cam}/{hand}_{t:04d}.jpg" for t in range(seq_len)]
            images = _random_images(seq_len, img_hw, rng)
            jc, ji = _joints_2d3d(rng, seq_len, img_hw, focal, princpt)
            bbox = _bbox_of(ji)
            yield split, f"{cap}/{seqn}/{cam}/{hand}/fr0", {
                "images": images,
                "img_path": np.asarray([r.encode() for r in rels]),
                "frame_idx": np.asarray([str(t).encode() for t in range(seq_len)]),
                "handedness": np.asarray([hstr] * seq_len),
                "bbox_tight": bbox,
                "joint_img": ji,
                "joint_bbox_img": ji - bbox[:, None, :2],
                "joint_cam": jc,
                "joint_valid": np.ones((seq_len, 21), np.float32),
                "joint_rel": jc - jc[:, :1],
                "mano_pose": rng.normal(scale=0.3, size=(seq_len, 48)).astype(np.float32),
                "mano_shape": rng.normal(scale=0.5, size=(seq_len, 10)).astype(np.float32),
                "focal": np.tile(focal, (seq_len, 1)),
                "princpt": np.tile(princpt, (seq_len, 1)),
            }


def make_synthetic_ih26mseq(
    root: str,
    splits=("train", "test"),
    seq_len: int = 8,
    img_hw=(120, 160),
    seed: int = 2,
) -> str:
    """Write ``<root>/annotations/<split>/seq.h5`` and the JPEG frames under
    ``<root>/images/<split>``; returns root."""
    import h5py

    seqs = synthetic_ih26mseq_sequences(splits, seq_len, img_hw, seed)
    for split in splits:
        annot_dir = osp.join(root, "annotations", split)
        os.makedirs(annot_dir, exist_ok=True)
        with h5py.File(osp.join(annot_dir, "seq.h5"), "w") as f:
            for _ in range(2):  # the right hand, then the left
                _, path, arrays = next(seqs)
                a = f.create_group(path).create_group("annots")
                write_images(osp.join(root, "images", split),
                              [r.decode() for r in arrays["img_path"]], arrays["images"])
                for key, value in arrays.items():
                    if key != "images":
                        a.create_dataset(key, data=value)
    return root


def make_synthetic_ho3d_fs(
    root: str,
    splits=("train", "evaluation"),
    num_seqs: int = 1,
    seq_len: int = 6,
    img_hw=(120, 160),
    seed: int = 3,
) -> str:
    """HO3D directory layout: <split>/<seq>/{rgb,meta} with per-frame pkls."""
    import pickle

    import cv2

    rng = np.random.default_rng(seed)
    cam = np.asarray(
        [[240.0, 0, img_hw[1] / 2], [0, 240.0, img_hw[0] / 2], [0, 0, 1]]
    )
    for split in splits:
        for s in range(num_seqs):
            seq_dir = osp.join(root, split, f"SEQ{s}")
            os.makedirs(osp.join(seq_dir, "rgb"), exist_ok=True)
            os.makedirs(osp.join(seq_dir, "meta"), exist_ok=True)
            for t in range(seq_len):
                img = (rng.uniform(size=(*img_hw, 3)) * 255).astype(np.uint8)
                cv2.imwrite(osp.join(seq_dir, "rgb", f"{t:04d}.jpg"), img)
                # OpenGL convention: y/z flipped relative to camera coords
                joints_cam = np.stack(
                    [
                        rng.uniform(-0.05, 0.05, 21),
                        rng.uniform(-0.05, 0.05, 21),
                        rng.uniform(0.4, 0.6, 21),
                    ],
                    axis=-1,
                )
                joints_gl = joints_cam * np.asarray([1, -1, -1])
                meta = {
                    "handJoints3D": joints_gl,
                    "camMat": cam,
                    "handPose": rng.normal(scale=0.3, size=48),
                    "handBeta": rng.normal(scale=0.5, size=10),
                }
                with open(osp.join(seq_dir, "meta", f"{t:04d}.pkl"), "wb") as f:
                    pickle.dump(meta, f)
    return root


def make_synthetic_ih26m_legacy(root: str, n_frames: int = 4, img_hw=(120, 160), seed: int = 7) -> str:
    """COCO-style InterHand2.6M annotation jsons + images (test split)."""
    import json

    import cv2

    rng = np.random.default_rng(seed)
    split = "test"
    annot_dir = osp.join(root, "annotations", split)
    os.makedirs(annot_dir, exist_ok=True)
    focal = [240.0, 240.0]
    princpt = [img_hw[1] / 2.0, img_hw[0] / 2.0]

    images, annotations, joints, mano = [], [], {"0": {}}, {"0": {}}
    cameras = {
        "0": {
            "campos": {"4": [0.0, 0.0, 0.0]},
            "camrot": {"4": np.eye(3).tolist()},
            "focal": {"4": focal},
            "princpt": {"4": princpt},
        }
    }
    for t in range(n_frames):
        rel = f"Capture0/ROM01/cam4/image{t:05d}.jpg"
        path = osp.join(root, "images", split, rel)
        os.makedirs(osp.dirname(path), exist_ok=True)
        cv2.imwrite(path, (rng.uniform(size=(*img_hw, 3)) * 255).astype(np.uint8))
        images.append(
            {
                "id": t, "file_name": rel, "width": img_hw[1], "height": img_hw[0],
                "capture": 0, "camera": "4", "frame_idx": t, "seq_name": "ROM01",
            }
        )
        # two hands in front of the camera (world == cam since R=I, t=0)
        jw = np.stack(
            [
                rng.uniform(-40, 40, 42),
                rng.uniform(-40, 40, 42),
                rng.uniform(400, 600, 42),
            ],
            axis=-1,
        )
        joints["0"][str(t)] = {
            "world_coord": jw.tolist(),
            "joint_valid": np.ones((42, 1)).tolist(),
        }
        mano["0"][str(t)] = {
            "right": {"pose": rng.normal(size=48).tolist(),
                      "shape": rng.normal(size=10).tolist(),
                      "trans": [0, 0, 0.5]},
            "left": {"pose": rng.normal(size=48).tolist(),
                     "shape": rng.normal(size=10).tolist(),
                     "trans": [0, 0, 0.5]},
        }
        annotations.append(
            {
                "id": t, "image_id": t,
                "joint_valid": np.ones((42, 1)).tolist(),
                "hand_type": "interacting" if t % 2 == 0 else "right",
            }
        )

    with open(osp.join(annot_dir, f"InterHand2.6M_{split}_data.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    with open(osp.join(annot_dir, f"InterHand2.6M_{split}_camera.json"), "w") as f:
        json.dump(cameras, f)
    with open(osp.join(annot_dir, f"InterHand2.6M_{split}_joint_3d.json"), "w") as f:
        json.dump(joints, f)
    with open(osp.join(annot_dir, f"InterHand2.6M_{split}_MANO_NeuralAnnot.json"), "w") as f:
        json.dump(mano, f)
    return root


def make_synthetic_image_folder(root: str, n: int = 6, img_hw=(90, 110), seed: int = 4) -> str:
    """A folder of `n` noise JPEGs (``data.pretrain.COCO2017``)."""
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img = (rng.uniform(size=(*img_hw, 3)) * 255).astype(np.uint8)
        cv2.imwrite(osp.join(root, f"img_{i:03d}.jpg"), img)
    return root


def make_synthetic_ego4d(root: str, n_frames: int = 3, img_hw=(100, 140), seed: int = 5) -> str:
    """``images/vid0/*.jpg`` and ``annotations/vid0.json`` with one hand box a
    frame (``data.pretrain.Ego4DHandImage``)."""
    import json

    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(osp.join(root, "images", "vid0"), exist_ok=True)
    os.makedirs(osp.join(root, "annotations"), exist_ok=True)
    annot = {}
    for t in range(n_frames):
        rel = f"vid0/frame_{t:04d}.jpg"
        img = (rng.uniform(size=(*img_hw, 3)) * 255).astype(np.uint8)
        cv2.imwrite(osp.join(root, "images", rel), img)
        annot[str(t)] = {
            "image_path": rel,
            "hands": [{"bbox": {"x_min": 0.3, "y_min": 0.3, "x_max": 0.6, "y_max": 0.7}}],
        }
    with open(osp.join(root, "annotations", "vid0.json"), "w") as f:
        json.dump(annot, f)
    return root


def make_synthetic_hint(root: str, part: str = "newdays", n: int = 4, img_hw=(100, 140),
                        seed: int = 6) -> str:
    """``TRAIN_<part>_img/im_*.{jpg,json}`` with one box an image
    (``data.pretrain.HIntHandImage``)."""
    import json

    import cv2

    rng = np.random.default_rng(seed)
    folder = osp.join(root, f"TRAIN_{part}_img")
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        img = (rng.uniform(size=(*img_hw, 3)) * 255).astype(np.uint8)
        cv2.imwrite(osp.join(folder, f"im_{i:03d}.jpg"), img)
        with open(osp.join(folder, f"im_{i:03d}.json"), "w") as f:
            json.dump([{"bbox": [[20.0, 25.0, 90.0, 85.0]]}], f)
    return root
