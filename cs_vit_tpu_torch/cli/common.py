"""Shared CLI plumbing: device choice, config tiers, model and dataset
construction (port of ``cs_vit_tpu/cli/common.py``).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..config import FinetuneConfig
from ..data import HO3D, ConcatDataset, DataLoader, DexYCB, InterHand26MSeq
from ..mano import ManoLayer, find_and_load
from ..models import Poser, PoserConfig
from ..parallel import make_mesh
from ..utils.dist import process_count, process_index

_ASSET_DIR = osp.join(osp.dirname(__file__), "..", "assets")


def load_or_create_config(exp: str, args_dict: dict, ckpt_root: str = "./checkpoints"
                          ) -> FinetuneConfig:
    """Reference precedence (`scripts/finetune.py:423-437`): an existing
    ``<ckpt_root>/<exp>/config.json`` wins over the CLI, except for
    ``epoch``; without one the CLI values fill a default config, which
    process 0 writes there. Unknown keys in the file are refused."""
    cfg_path = osp.join(ckpt_root, exp, "config.json")
    if osp.exists(cfg_path):
        cfg = FinetuneConfig.from_json_file(cfg_path)
        if "epoch" in args_dict and args_dict["epoch"] is not None:
            cfg.epoch = args_dict["epoch"]
        print("Config loaded from file")
    else:
        cfg = FinetuneConfig()
        cfg.update({k: v for k, v in args_dict.items() if hasattr(cfg, k)})
        if process_index() == 0:
            os.makedirs(osp.dirname(cfg_path), exist_ok=True)
            with open(cfg_path, "w") as f:
                f.write(cfg.to_json())
        print("Config loaded from command")
    return cfg


def resolve_device(device) -> torch.device:
    """The requested device; ``cuda`` without a usable card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_attention_impl(impl: str) -> str:
    """Validate a config's ``attention_impl``.

    ``"auto"`` stays ``"auto"``: each SwinV2 block then takes the CUDA kernels
    for CUDA tensors and the eager path for CPU tensors. The JAX package's
    ``"xla"`` is this package's ``"eager"``; ``"fused"``, ``"pallas"`` and
    ``"hybrid"`` keep their JAX meanings.
    """
    if impl == "xla":
        return "eager"
    if impl in ("auto", "eager", "fused", "pallas", "hybrid"):
        return impl
    raise ValueError(f"attention_impl {impl!r} is not available in cs_vit_tpu_torch")


def _backbone_arch_name(backbone: Optional[str]) -> str:
    """An arch name from either a name or a local HF checkpoint directory."""
    if not backbone:
        return "swinv2-tiny-256"
    if osp.isdir(backbone):
        with open(osp.join(backbone, "config.json")) as f:
            hf = json.load(f)
        return "swinv2-base-256" if hf.get("embed_dim", 96) >= 128 else "swinv2-tiny-256"
    return backbone


def poser_config_from(cfg: FinetuneConfig) -> PoserConfig:
    return PoserConfig(
        backbone=_backbone_arch_name(cfg.backbone),
        num_pose_query=cfg.num_joints,
        num_spatial_layer=cfg.num_spatial_layer,
        spatial_layer_type=cfg.spatial_layer_type,
        num_temporal_layer=cfg.num_temporal_layer,
        temporal_init_method=cfg.temporal_init_method,
        expansion_ratio=cfg.expansion_ratio,
        temporal_supervision=cfg.temporal_supervision,
        trope_scalar=cfg.trope_scalar,
        num_latent_layer=cfg.num_latent_layer,
        persp_embed_method=cfg.persp_embed_method,
        persp_decorate=cfg.persp_decorate,
        image_size=cfg.img_size,
        global_positioning=cfg.global_positioning,
        # tp > 1: the eager path (JAX's "xla"), which tensor parallelism
        # shards; a hand-written kernel has no partitioning rule
        attention_impl="eager" if getattr(cfg, "tp", 1) > 1
        else resolve_attention_impl(cfg.attention_impl),
        remat=cfg.remat,
    )


def build_model(cfg: FinetuneConfig, allow_synthetic_mano: bool = True) -> Poser:
    """The Poser of `cfg` on the CPU, parameters uninitialised (zeros and
    module defaults): load weights or call ``init_poser_weights`` next."""
    assets = find_and_load(
        cfg.mano_model_dir, is_rhand=True, allow_synthetic=allow_synthetic_mano
    )
    if assets.synthetic:
        print(
            "WARNING: using synthetic MANO assets (set MANO_MODEL_DIR or "
            "cfg.mano_model_dir for real FK outputs)"
        )
    mano = ManoLayer(assets, flat_hand_mean=False)
    jreg = np.load(osp.join(_ASSET_DIR, "sh_joint_regressor.npy"))
    return Poser(config=poser_config_from(cfg), mano=mano, j_regressor=jreg)


# safetensors dtype names -> torch dtypes
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU: an 8-byte
    little-endian header length, a JSON header (per tensor its dtype, shape
    and byte range, ranges counted from the end of the header), then the
    little-endian data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        if end == begin:
            out[name] = torch.empty(info["shape"], dtype=dtype)
        else:  # a copy of the range: aligned, writable, owned by the tensor
            out[name] = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype).reshape(
                info["shape"])
    return out


def load_backbone_params(backbone_dir: str, backbone: torch.nn.Module) -> bool:
    """Load pretrained HF Swinv2 weights from a local checkpoint directory
    (``model.safetensors``, else ``pytorch_model.bin``) into `backbone`,
    strictly; False when the directory holds neither file. The backbone's
    names are HF's, so each is taken as it is or under ``swinv2.``."""
    st_path = osp.join(backbone_dir, "model.safetensors")
    bin_path = osp.join(backbone_dir, "pytorch_model.bin")
    if osp.exists(st_path):
        sd, path = read_safetensors(st_path), st_path
    elif osp.exists(bin_path):
        sd, path = torch.load(bin_path, map_location="cpu", weights_only=True), bin_path
    else:
        return False
    picked = {}
    for name in backbone.state_dict():
        key = next((k for k in (name, "swinv2." + name) if k in sd), None)
        if key is None:
            raise KeyError(f"{name} (or swinv2.{name}) is not in {path}")
        picked[name] = sd[key]
    backbone.load_state_dict(picked, strict=True)
    return True


def build_datasets(cfg: FinetuneConfig, split: str) -> ConcatDataset:
    """ConcatDataset of the selected sources (ref `finetune.py:66-102`)."""
    num_frames = 1 if cfg.phase == "spatial" else (cfg.seq_len or 7)
    data = cfg.data if isinstance(cfg.data, (list, tuple)) else [cfg.data]
    datasets = []
    for name in data:
        if name == "interhand26m":
            datasets.append(
                InterHand26MSeq(
                    cfg.ih26mseq_root, num_frames,
                    "train" if split == "train" else "test",
                    img_size=cfg.img_size, expansion_ratio=cfg.expansion_ratio,
                )
            )
        elif name == "ho3d":
            datasets.append(
                HO3D(
                    cfg.ho3d_root, num_frames,
                    "train" if split == "train" else "evaluation",
                    img_size=cfg.img_size, expansion_ratio=cfg.expansion_ratio,
                )
            )
        elif name == "dexycb":
            datasets.append(
                DexYCB(
                    cfg.dexycb_root, num_frames, "s1",
                    "train" if split == "train" else "test",
                    img_size=cfg.img_size, expansion_ratio=cfg.expansion_ratio,
                )
            )
        else:
            raise ValueError(f"unknown dataset: {name}")
        print(f"Added {name}")
    return ConcatDataset(datasets)


def tp_mesh(cfg: FinetuneConfig):
    """The ``(data, model)`` mesh of ``cfg.tp`` > 1 over the world (None for
    ``tp`` 1): ``n_data`` x ``tp`` ranks, ``batch_size`` divisible by
    ``n_data`` (JAX's assert, ``cs_vit_tpu/cli/finetune.py:134``)."""
    if getattr(cfg, "tp", 1) <= 1:
        return None
    if process_count() % cfg.tp:
        raise ValueError(f"tp={cfg.tp} needs a world of n_data x {cfg.tp} processes (torchrun), "
                         f"not {process_count()}")
    mesh = make_mesh(n_model=cfg.tp)
    if cfg.batch_size % mesh.n_data:
        raise ValueError(f"batch {cfg.batch_size} not divisible by the data axis {mesh.n_data}")
    return mesh


def build_loader(cfg: FinetuneConfig, dataset, shuffle: bool, mesh=None) -> DataLoader:
    """The loader of this process's shard: one shard a rank, or under tensor
    parallelism (`mesh`) one a model group, whose ranks read the same rows
    (a model group is the counterpart of one JAX process)."""
    shards, index = ((process_count(), process_index()) if mesh is None
                     else (mesh.n_data, mesh.data_rank))
    return DataLoader(
        dataset,
        batch_size=cfg.batch_size,
        shuffle=shuffle,
        drop_last=True,  # every step sees batch_size, as in the JAX package
        seed=42,
        num_shards=shards,
        shard_index=index,
        num_workers=cfg.num_workers,
    )


def batch_to_device(host_batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A collated host batch as tensors on `device`, without the fields that
    are not model inputs (``imgs_path``, ``flip``)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host_batch.items() if k not in ("imgs_path", "flip")}
