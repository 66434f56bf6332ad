"""Shared plumbing: device choice, config -> model construction.

Port of the serving-side half of ``cs_vit_tpu/cli/common.py``.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Optional

import numpy as np
import torch

from ..config import FinetuneConfig
from ..mano import ManoLayer, find_and_load
from ..models import Poser, PoserConfig

_ASSET_DIR = osp.join(osp.dirname(__file__), "..", "assets")


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
        temporal_supervision=cfg.temporal_supervision,
        trope_scalar=cfg.trope_scalar,
        num_latent_layer=cfg.num_latent_layer,
        persp_embed_method=cfg.persp_embed_method,
        persp_decorate=cfg.persp_decorate,
        image_size=cfg.img_size,
        global_positioning=cfg.global_positioning,
        attention_impl=resolve_attention_impl(cfg.attention_impl),
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
