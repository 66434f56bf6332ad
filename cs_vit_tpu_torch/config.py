"""Experiment configuration (copy of ``cs_vit_tpu/config.py``).

Same fields, so a ``config.json`` written by either package loads in the
other. Unknown keys are refused, both by ``update`` and by
``from_json_file``. Serving reads the model fields, ``img_size``,
``expansion_ratio``, ``mano_model_dir`` and ``attention_impl``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union


@dataclass
class FinetuneConfig:
    # Experiments
    exp: Optional[str] = None
    epoch: int = 30

    # Model
    backbone: Optional[str] = None
    num_joints: int = 16
    num_spatial_layer: int = 6
    global_positioning: str = "direct"
    spatial_layer_type: str = "decoder"
    num_temporal_layer: int = 2
    temporal_init_method: str = "zero"
    img_size: int = 256
    expansion_ratio: float = 1.25
    trope_scalar: float = 20.0  # 20 ms -> 1 step
    num_latent_layer: Optional[int] = None
    persp_embed_method: str = "dense"
    persp_decorate: str = "query"

    # Dataset
    data: Optional[List[str]] = None
    seq_len: Optional[int] = None
    batch_size: Optional[int] = None
    ih26mseq_root: str = "/data/InterHand2.6M_5fps_batch1"
    ho3d_root: str = "/data/HO3D_v3"
    dexycb_root: str = "/data/dexycb"
    num_workers: int = 8

    # Train
    phase: str = "inference"
    temporal_supervision: str = "full"
    spatial_ckpt: Optional[str] = None
    lr: float = 1e-4
    lr_min: float = 1e-6
    lr_scheduler: Optional[str] = None
    warmup_epoch: int = 1
    cooldown_epoch: int = 10

    # Evaluation
    eval_ckpt: Optional[str] = None

    # Runtime knobs absent from the reference
    mano_model_dir: Optional[str] = None
    dtype: str = "float32"
    # "auto" (kernels on CUDA tensors, eager on CPU tensors) | "eager" |
    # "fused" | "pallas" | "hybrid"; the JAX name "xla" (= "eager") is accepted
    attention_impl: str = "auto"
    remat: bool = False
    tp: int = 1

    def update(self, other: Union["FinetuneConfig", Dict[str, Any]]):
        if isinstance(other, FinetuneConfig):
            merge = other.to_dict()
        elif isinstance(other, dict):
            merge = other
        else:
            raise TypeError("can only merge from Config/dict")
        for key, value in merge.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                raise KeyError(f"Unexpected key: {key}.")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), ensure_ascii=False, indent=4)

    @classmethod
    def from_json_file(cls, path: str) -> "FinetuneConfig":
        with open(path) as f:
            obj = json.load(f)
        cfg = cls()
        cfg.update(obj)
        return cfg
