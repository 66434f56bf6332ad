"""The program's fine-tune data path, built as ``cli.finetune.main`` builds
it: a synthetic DexYCB tree written with the program's fixture, the train
split, the loader and the feed of device batches. With ``program.py`` the
benchmark's only files that import the program."""

from __future__ import annotations

import os.path as osp
from typing import Dict, Iterator

import numpy as np
import torch

import cs_vit_tpu_torch
from cs_vit_tpu_torch.cli.common import build_loader
from cs_vit_tpu_torch.cli.finetune import device_batches
from cs_vit_tpu_torch.data import ConcatDataset, DexYCB
from cs_vit_tpu_torch.data.fixtures import MemoryStore, synthetic_dexycb_sequences, write_images

from . import program

# the seed of the split's augmentation draws (``DexYCB``'s default)
ITEM_SEED = 0


def dexycb_tree(root: str, sequences: int, frames: int, frame_hw, seed: int,
                repeat: int) -> Dict[str, Dict[str, np.ndarray]]:
    """Write the tree's JPEG frames under `root`; the train split's
    sequences by name (each listed `repeat` times, ``<name>.<r>``), their
    annotations as the HDF5 file would hold them."""
    groups = {}
    for _, name, arrays in synthetic_dexycb_sequences(("train",), sequences, frames,
                                                      tuple(frame_hw), seed):
        write_images(root, [r.decode() for r in arrays["imgs_path"]], arrays.pop("images"))
        groups.update({f"{name}.{r}": arrays for r in range(repeat)})
    return groups


def crop(config: dict) -> Dict[str, float]:
    """The crop the fine-tune's split makes: its size and expansion ratio."""
    cfg = program.finetune_config(config, "spatial")
    return {"img_size": cfg.img_size, "expansion_ratio": cfg.expansion_ratio}


def mano_pca() -> Dict[str, np.ndarray]:
    """The MANO pose PCA bases the split expands DexYCB's poses with."""
    path = osp.join(osp.dirname(cs_vit_tpu_torch.__file__), "assets", "mano_lr_pca.npz")
    with np.load(path) as pca:
        return {k: pca[k] for k in ("left", "right")}


def finetune_feed(config: dict, batch: int, root: str, groups, shuffle_seed: int,
                  device) -> Iterator[Dict[str, torch.Tensor]]:
    """The spatial fine-tune's device batches from the split of `groups`
    (frames under `root`), epoch after epoch from epoch 1: ``DexYCB`` at the
    configuration's crop, ``build_loader`` (shuffled from `shuffle_seed`,
    the configuration's loader threads, whole batches) and
    ``cli.finetune.device_batches`` (the patches cast to the train dtype on
    the host)."""
    cfg = program.finetune_config(config, "spatial")
    cfg.batch_size = batch
    store = MemoryStore.of((f"sequences/{n}", a) for n, a in groups.items())
    dataset = ConcatDataset([DexYCB(root, 1, "s1", "train", img_size=cfg.img_size,
                                    expansion_ratio=cfg.expansion_ratio, seed=ITEM_SEED,
                                    store=store)])
    loader = build_loader(cfg, dataset, shuffle=True)
    loader.seed = shuffle_seed
    dtype = getattr(torch, config["train"]["dtype"])
    epoch = 0
    while True:
        epoch += 1
        loader.set_epoch(epoch)
        yield from device_batches(loader, device, dtype)
