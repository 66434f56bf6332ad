"""Unlabelled image datasets for TI self-supervised pretraining (port of
``cs_vit_tpu/data/pretrain.py``).

* ``COCO2017`` (ref ``cs_vit/dataset/COCO2017.py``): a folder scan, then a
  random resized crop, flip, colour jitter and grayscale; one [S,S,3] image
  in [0,1].
* ``Ego4DHandImage`` (ref ``cs_vit/dataset/ego4d.py``): JSON hand boxes
  expanded 2x, a normalized-box crop with aspect adjustment; a pickle index
  cache.
* ``HIntHandImage`` (ref ``cs_vit/dataset/HInt.py``): per-image JSON box
  crops from the ego4d / epick / newdays parts.

The items are those of the JAX package's datasets, draw for draw (the same
per-(epoch, item) RNG). JPEG decode uses cv2, imported by the functions that
decode; a failed decode gives a zero image, as the reference's try/except.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..ops.resample import (
    bbox_to_corners,
    crop_and_resize_np,
    crop_with_normalized_box_np,
)
from .base import DeterministicItemRNG
from .transforms_np import color_jitter, _grayscale

_VALID_EXT = {".jpg", ".jpeg", ".png", ".webp"}


def _to_tuple(x) -> Tuple[int, int]:
    return (x, x) if isinstance(x, int) else tuple(x)


def _default_photo_aug(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """HFlip(0.5) + ColorJitter + RandomGrayscale(0.1) (shared aug stack)."""
    if rng.uniform() < 0.5:
        img = img[:, ::-1].copy()
    img = color_jitter(img, rng)
    if rng.uniform() < 0.1:
        img = np.repeat(_grayscale(img)[..., None], 3, axis=-1)
    return img.astype(np.float32)


def _random_resized_crop(
    img: np.ndarray, out_size: Tuple[int, int], rng: np.random.Generator,
    scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
) -> np.ndarray:
    """torchvision RandomResizedCrop parameter sampling + bilinear resize."""
    H, W = img.shape[:2]
    area = H * W
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = np.log(ratio)
        aspect = np.exp(rng.uniform(*log_ratio))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            i = rng.integers(0, H - h + 1)
            j = rng.integers(0, W - w + 1)
            crop = img[i : i + h, j : j + w]
            return _resize(crop, out_size)
    # fallback: center crop
    s = min(H, W)
    i, j = (H - s) // 2, (W - s) // 2
    crop = img[i : i + s, j : j + s]
    return _resize(crop, out_size)


def _resize(img: np.ndarray, out_size: Tuple[int, int]) -> np.ndarray:
    import cv2

    return cv2.resize(img, (out_size[1], out_size[0]), interpolation=cv2.INTER_LINEAR)


def _load_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


class COCO2017(DeterministicItemRNG):
    """Unlabeled image folder -> augmented [S,S,3] crops."""

    def __init__(
        self,
        img_dir: str,
        img_size=224,
        default_augment: bool = True,
        custom_transform: Optional[Callable] = None,
        seed: int = 0,
    ):
        self.img_dir = img_dir
        self.img_size = _to_tuple(img_size)
        self.default_augment = default_augment
        self.custom_transform = custom_transform
        self._seed = seed
        self.image_paths = [
            osp.join(root, f)
            for root, _, files in os.walk(img_dir)
            for f in files
            if osp.splitext(f)[1].lower() in _VALID_EXT
        ]
        self.image_paths.sort()

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        try:
            img = _load_rgb(self.image_paths[idx])
            if self.custom_transform:
                img = self.custom_transform(img)
            if self.default_augment:
                rng = self._item_rng(idx)
                img = _default_photo_aug(img, rng)
                img = _random_resized_crop(img, self.img_size, rng)
            else:
                img = _resize(img, self.img_size)
            return img.astype(np.float32)
        except Exception as e:  # zero image on decode failure (ref :92-94)
            print(f"Error loading {self.image_paths[idx]}: {e}")
            return np.zeros((*self.img_size, 3), np.float32)


class Ego4DHandImage(DeterministicItemRNG):
    """Hand crops from Ego4D frames with mediapipe-annotated bboxes."""

    def __init__(
        self,
        root: str,
        img_size=224,
        bbox_rescale: float = 2.0,
        default_augment: bool = True,
        custom_transform: Optional[Callable] = None,
        seed: int = 0,
        cache_dir: Optional[str] = None,
    ):
        self.root = Path(root)
        self.image_root = self.root / "images"
        self.annot_root = self.root / "annotations"
        self.bbox_rescale = bbox_rescale
        self.img_size = _to_tuple(img_size)
        self.default_augment = default_augment
        self.custom_transform = custom_transform
        self._seed = seed

        cache_dir = cache_dir or str(self.root / "__cache__")
        cache = osp.join(cache_dir, "ego4d.pkl")
        if osp.exists(cache):
            with open(cache, "rb") as f:
                self.annotations = pickle.load(f)
        else:
            self.annotations = []
            for annot_file in sorted(self.annot_root.iterdir()):
                if annot_file.suffix != ".json":
                    continue
                with open(annot_file) as f:
                    video_annot = json.load(f)
                for _, frame_annot in video_annot.items():
                    for bbox in frame_annot["hands"]:
                        self.annotations.append(
                            {
                                "frame_path": frame_annot["image_path"],
                                "bbox": [
                                    bbox["bbox"]["x_min"], bbox["bbox"]["y_min"],
                                    bbox["bbox"]["x_max"], bbox["bbox"]["y_max"],
                                ],
                            }
                        )
            Path(cache_dir).mkdir(parents=True, exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(self.annotations, f)

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, ix: int) -> np.ndarray:
        annot = self.annotations[ix]
        try:
            img = _load_rgb(str(self.image_root / annot["frame_path"]))
            # expand normalized bbox about center (ref utils/img.py:215-241)
            x1, y1, x2, y2 = annot["bbox"]
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            w, h = (x2 - x1) * self.bbox_rescale, (y2 - y1) * self.bbox_rescale
            box = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            crop = crop_with_normalized_box_np(img, box, self.img_size)
            if self.custom_transform:
                crop = self.custom_transform(crop)
            if self.default_augment:
                crop = _default_photo_aug(crop, self._item_rng(ix))
            return crop.astype(np.float32)
        except Exception as e:
            print(f"Error loading {annot['frame_path']}: {e}")
            return np.zeros((*self.img_size, 3), np.float32)


class HIntHandImage(DeterministicItemRNG):
    """HInt dataset hand crops (parts: ego4d / epick / newdays)."""

    def __init__(
        self,
        root: str,
        img_size=224,
        parts: Sequence[str] = (),
        default_augment: bool = True,
        custom_transform: Optional[Callable] = None,
        seed: int = 0,
        cache_dir: Optional[str] = None,
    ):
        assert parts, "HInt parts must be non-empty"
        self.root = Path(root)
        self.img_size = _to_tuple(img_size)
        self.default_augment = default_augment
        self.custom_transform = custom_transform
        self._seed = seed

        parts = sorted(parts)
        sub_folders = [osp.join(root, f"TRAIN_{s}_img") for s in parts]
        cache_dir = cache_dir or str(self.root / "__cache__")
        cache = osp.join(cache_dir, f"HInt-{'_'.join(parts)}.pkl")
        if osp.exists(cache):
            with open(cache, "rb") as f:
                self.annotations = pickle.load(f)
        else:
            self.annotations = []
            for folder in sub_folders:
                for filename in sorted(os.listdir(folder)):
                    if filename.endswith(".json"):
                        full = osp.join(folder, filename)
                        with open(full) as f:
                            full_annot = json.load(f)
                        bbox = tuple(full_annot[0]["bbox"][0])
                        self.annotations.append(
                            (osp.splitext(full)[0] + ".jpg", bbox)
                        )
            Path(cache_dir).mkdir(parents=True, exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(self.annotations, f)

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, ix: int) -> np.ndarray:
        img_path, box = self.annotations[ix]
        try:
            img = _load_rgb(img_path)
            H, W = img.shape[:2]
            nbox = [box[0] / W, box[1] / H, box[2] / W, box[3] / H]
            crop = crop_with_normalized_box_np(img, nbox, self.img_size)
            if self.custom_transform:
                crop = self.custom_transform(crop)
            if self.default_augment:
                crop = _default_photo_aug(crop, self._item_rng(ix))
            return crop.astype(np.float32)
        except Exception as e:
            print(f"Error loading {img_path}: {e}")
            return np.zeros((*self.img_size, 3), np.float32)
