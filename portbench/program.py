"""The system under test, cs_vit_tpu_torch, built from a configuration file
and filled with the run's weights, statistics and MANO tensors. The only
file of the benchmark that imports the program."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

from cs_vit_tpu_torch.cli.common import build_model
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.models.poser import phase_trainable_params
from cs_vit_tpu_torch.parallel import init_distributed
from cs_vit_tpu_torch.serving import PoserSession
from cs_vit_tpu_torch.train import TrainState, build_optimizer, make_train_step
from cs_vit_tpu_torch.train.optim import scaled_lr

from .backbones import kind as backbone_kind

_MANO = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "pose_mean")


def finetune_config(config: dict, phase: str, serve: bool = False) -> FinetuneConfig:
    m = config["model"]
    fields = dict(
        backbone=m["backbone"]["name"], img_size=m["img_size"], num_joints=m["num_joints"],
        num_spatial_layer=m["num_spatial_layer"], spatial_layer_type=m["spatial_layer_type"],
        num_temporal_layer=m["num_temporal_layer"], temporal_supervision=m["temporal_supervision"],
        trope_scalar=m["trope_scalar"], num_latent_layer=m["num_latent_layer"],
        persp_embed_method=m["persp_embed_method"], persp_decorate=m["persp_decorate"],
        global_positioning=m["global_positioning"], attention_impl=config["attention_impl"],
        phase=phase, lr=config["train"]["lr"], dtype=config["train"]["dtype"],
    )
    if serve:
        fields.update(config["serve"]["model"])
    return FinetuneConfig(**fields)


def _check_backbone(model, config: dict) -> None:
    """The program picks the backbone's widths by name: they have to be the
    configuration file's (the attributes its kind names)."""
    c, bb = model.backbone.config, config["model"]["backbone"]
    got = {k: _plain(getattr(c, k)) for k in backbone_kind(config["model"]).PROGRAM_CONFIG}
    want = {k: bb[k] for k in got}
    if got != want:
        raise ValueError(f"the program's {bb['name']} is {got}, the configuration states {want}")


def _plain(v):
    return list(v) if isinstance(v, tuple) else v


def _fill(model, weights, stats, mano) -> None:
    missing, unexpected = model.load_state_dict({**weights, **stats}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"weights do not match the program: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    with torch.no_grad():
        for name in _MANO:
            model.mano.get_buffer(name).copy_(mano[name])
        model.j_regressor.copy_(mano["j_regressor21"])


def session(config: dict, batch_size: int, seq_len: int, weights, stats, mano,
            device) -> PoserSession:
    """A serving session of the configuration's serving form."""
    cfg = finetune_config(config, "inference", serve=True)
    sess = PoserSession(cfg, batch_size=batch_size, seq_len=seq_len,
                        dtype=config["serve"]["dtype"], device=device)
    _check_backbone(sess.model, config)
    _fill(sess.model, weights, stats, mano)
    return sess


def train_state(config: dict, batch_size: int, weights, stats, mano, device,
                world: int = 1) -> Tuple:
    """(state, step, names) for the spatial phase: the model with f32
    masters on `device`, AdamW at the fine-tune's scaled rate for `world`
    cards and its clip, the step in the configuration's compute dtype (in a
    world that ``join_world`` joined, the program's data-parallel step);
    `names` maps each trained parameter to its name."""
    cfg = finetune_config(config, "spatial")
    model = build_model(cfg).to(device)
    _check_backbone(model, config)
    _fill(model, weights, stats, mano)
    tr = config["train"]
    optimizer = build_optimizer(model, "spatial", lr_for(config, batch_size, world),
                                tr["max_grad_norm"], tr["weight_decay"])
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, optimizer, "spatial",
                           compute_dtype=getattr(torch, tr["dtype"]))
    names = {id(p): n for n, p in phase_trainable_params(model, "spatial")}
    return state, step, names


def lr_for(config: dict, batch_size: int, world: int = 1) -> float:
    """The fine-tune's constant rate for `world` cards at `batch_size` a
    card."""
    return scaled_lr(config["train"]["lr"], world, batch_size)


def join_world(device) -> bool:
    """Join the world that the launcher's environment describes (the
    program's ``parallel.init_distributed``: NCCL on a card, gloo on the
    CPU); whether this process is in one."""
    return init_distributed(torch.device(device).type)


def block_modules(model, config: dict) -> list:
    """The backbone's blocks (its kind's program block class)."""
    module, name = backbone_kind(config["model"]).PROGRAM_BLOCK.rsplit(".", 1)
    block = getattr(importlib.import_module(module), name)
    return [m for m in model.modules() if isinstance(m, block)]


def head_modules(model) -> Dict[str, torch.nn.Module]:
    """The Poser's top-level submodules other than the backbone."""
    return {n: m for n, m in model.named_children() if n != "backbone"}
