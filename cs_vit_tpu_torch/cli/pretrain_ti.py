"""TI self-supervised pretraining entry point (port of
``cs_vit_tpu/cli/pretrain_ti.py``):

  python -m cs_vit_tpu_torch.cli.pretrain_ti --exp ti0 --mode tivit \\
      --data_root /data/coco2017 --dataset coco --epochs 10 --batch_size 64

Modes:
  tivit  TI-ViT latent isomorphism on a ViT encoder (AdamW on everything)
  dino   TI-DINO stage 'dino': the student's block MLPs learn (APLA,
         ``dino_stage_mask``), the teacher follows by EMA, the centre moves
  ti     TI-DINO stage 'ti': only the transformation group learns

The arguments and defaults are the JAX CLI's (ViT-B/16 widths, img 224,
b64), with ``--num_workers`` (host loader threads) and ``--device`` added.
Weights start from ``init_ti_weights`` (seeds 0 and 1); the scales and
angles come from a generator on the device, seeded 7 / 11 / 13 by mode as
the JAX CLI's keys are. One ``.pt`` checkpoint an epoch under
``./checkpoints/<exp>``, with the JAX CLI's keys: ``params`` (tivit; the
state dict holds the BatchNorm statistics too), ``student``, ``teacher``,
``trans``, ``center`` (dino) or ``trans`` (ti), and ``epoch``.

Under ``torchrun`` (``parallel.init_distributed``) the ranks compute what
the JAX CLI's one program over a data mesh computes on the global batch:
each rank reads its shard of the dataset, ``--batch_size`` rows a step;
every rank draws the scales and angles of the whole global batch from the
same generator and takes its own rows (:func:`rank_draws`); the
transformation groups' BatchNorms, the support loss and the DINO centre
take their statistics over every rank's rows (``parallel.sync_norm``); one
all-reduce a step averages the loss, the logs and the grads of the tensors
that have grads; rank 0 alone prints and writes checkpoints. The LoRA
dropout masks are each rank's own draws (``LORA_DROPOUT_SEED`` + rank).

  torchrun --nproc_per_node=2 -m cs_vit_tpu_torch.cli.pretrain_ti --mode tivit ...
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.base import DataLoader
from ..data.pretrain import COCO2017, Ego4DHandImage, HIntHandImage
from ..models.dinov2 import Dinov2Config
from ..models.ti import (
    TIDinoTransGroup,
    TIDinoViT,
    TIViT,
    dino_forward,
    dino_stage_mask,
    init_ti_weights,
    ti_draws,
    ti_forward,
    ti_stage_mask,
    update_teacher,
)
from ..models.vit import ViTConfig
from ..parallel import all_mean_, init_distributed
from ..train.checkpoint import cpu_state_dict, save_payload
from ..utils.dist import process_count, process_index
from ..utils.logging import nop, wrap_prefix_print
from .common import resolve_device

DRAW_SEEDS = {"tivit": 7, "dino": 11, "ti": 13}
LORA_DROPOUT_SEED = 8


def build_dataset(name: str, root: str, img_size: int):
    if name == "coco":
        return COCO2017(root, img_size=img_size)
    if name == "ego4d":
        return Ego4DHandImage(root, img_size=img_size)
    if name == "hint":
        return HIntHandImage(root, img_size=img_size, parts=["ego4d", "epick", "newdays"])
    raise ValueError(name)


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: betas 0.9/0.999, eps 1e-8, weight decay 1e-4."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def rank_draws(draws, batch: int):
    """This rank's (normal, uniform) draws for its `batch` rows: the draws of
    the world's whole global batch, from `draws` (a generator, which every
    rank seeds alike) or handed in, rows ``[rank * batch, (rank + 1) *
    batch)``. So two ranks draw what one process draws for both batches."""
    world, rank = process_count(), process_index()
    if isinstance(draws, torch.Generator):
        draws = ti_draws(batch * world, draws)
    normal, uniform = draws
    if normal.shape[0] != batch * world:
        raise ValueError(f"{normal.shape[0]} draws for a global batch of {batch * world}")
    rows = slice(rank * batch, (rank + 1) * batch)
    return normal[rows], uniform[rows]


def averaged(loss: torch.Tensor, logs: Dict, optimizer: torch.optim.Optimizer):
    """(loss, logs) detached, and the optimizer's grads, averaged over the
    world in one all-reduce: only the tensors that have grads (the identity
    without a process group)."""
    loss = loss.detach().clone()
    logs = {k: v.detach().clone() for k, v in logs.items()}
    grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    all_mean_([loss, *grads, *logs.values()])
    return loss, logs


def tivit_setup(args, device) -> Dict:
    cfg = ViTConfig(image_size=args.img_size, patch_size=args.patch_size,
                    hidden_size=args.hidden_size, num_hidden_layers=args.num_layers,
                    num_attention_heads=args.num_heads, intermediate_size=4 * args.hidden_size)
    model = TIViT(cfg, decoder_config=None, ti_loss=True, lora_rank=args.lora_rank or None)
    init_ti_weights(model, 0)
    model.to(device)
    return {"model": model, "optimizer": adamw(model.parameters(), args.lr)}


def dino_setup(args, device) -> Dict:
    cfg = Dinov2Config(image_size=args.img_size, patch_size=args.patch_size,
                       hidden_size=args.hidden_size, num_hidden_layers=args.num_layers,
                       num_attention_heads=args.num_heads)
    student = TIDinoViT(cfg)
    init_ti_weights(student, 0)
    teacher = copy.deepcopy(student).requires_grad_(False)
    num_p = args.img_size // args.patch_size
    trans = TIDinoTransGroup(embed_dim=args.hidden_size, num_heads=args.num_heads, num_p=num_p)
    init_ti_weights(trans, 1)
    center = torch.zeros(num_p * num_p, args.hidden_size)
    out = {"student": student.to(device), "teacher": teacher.to(device),
           "trans": trans.to(device), "center": center.to(device)}
    if args.mode == "dino":
        trans.requires_grad_(False)
        trained = []
        for name, p in student.named_parameters():
            p.requires_grad_(dino_stage_mask(name))
            if p.requires_grad:
                trained.append(p)
        out["optimizer"] = adamw(trained, args.lr)
    else:
        student.requires_grad_(False)
        out["optimizer"] = adamw([p for n, p in trans.named_parameters() if ti_stage_mask(n)],
                                 args.lr)
    return out


def make_tivit_step(run: Dict) -> Callable:
    """``step(images, draws, dropout_generator=None) -> (loss, logs)``: one
    AdamW step of every TI-ViT parameter; the latent group's BatchNorm
    statistics move. `images` are this rank's rows, `draws` a generator or
    the global batch's draws (:func:`rank_draws`)."""
    model, opt = run["model"], run["optimizer"]

    def step(images, draws, dropout_generator=None):
        opt.zero_grad(set_to_none=True)
        out = model(images, train=True, draws=rank_draws(draws, images.shape[0]),
                    dropout_generator=dropout_generator)
        out["loss"].backward()
        loss, logs = averaged(out["loss"], out["logs"]["scalar"], opt)
        opt.step()
        return loss, logs

    return step


def make_dino_step(run: Dict, teacher_momentum: float) -> Callable:
    """``step(images, draws) -> (loss, logs)``: one AdamW step of the
    student's MLPs, then the teacher's EMA and the new centre (in
    ``run["center"]``)."""
    student, teacher, trans, opt = (run[k] for k in ("student", "teacher", "trans",
                                                     "optimizer"))

    def step(images, draws):
        opt.zero_grad(set_to_none=True)
        loss, logs, new_center = dino_forward(student, teacher, trans, run["center"], images,
                                              rank_draws(draws, images.shape[0]))
        loss.backward()
        loss, logs = averaged(loss, logs, opt)
        opt.step()
        update_teacher(teacher, student, teacher_momentum)
        run["center"] = new_center.detach()
        return loss, logs

    return step


def make_ti_step(run: Dict) -> Callable:
    """``step(images, draws) -> (loss, logs)``: one AdamW step of the
    transformation group against the frozen teacher."""
    teacher, trans, opt = run["teacher"], run["trans"], run["optimizer"]

    def step(images, draws):
        opt.zero_grad(set_to_none=True)
        loss, logs = ti_forward(teacher, trans, images, rank_draws(draws, images.shape[0]))
        loss.backward()
        loss, logs = averaged(loss, logs, opt)
        opt.step()
        return loss, logs

    return step


def _payload(mode: str, run: Dict, epoch: int) -> Dict:
    if mode == "tivit":
        return {"params": cpu_state_dict(run["model"]), "epoch": epoch}
    if mode == "dino":
        return {"student": cpu_state_dict(run["student"]),
                "teacher": cpu_state_dict(run["teacher"]),
                "trans": cpu_state_dict(run["trans"]), "center": run["center"].cpu(),
                "epoch": epoch}
    return {"trans": cpu_state_dict(run["trans"]), "epoch": epoch}


def main(args, device="cuda", dataset=None, ckpt_root: str = "./checkpoints") -> Dict:
    """Pretrain for ``args.epochs`` epochs; returns the run (its modules,
    optimizer and centre) with ``losses``, one float a step. `dataset`
    replaces the one ``build_dataset`` would build ([S,S,3] float items)."""
    device = resolve_device(device)
    init_distributed(device)
    rank = process_index()
    print_ = wrap_prefix_print(f"[{rank}] ") if rank == 0 else nop
    if dataset is None:
        dataset = build_dataset(args.dataset, args.data_root, args.img_size)
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True, drop_last=True,
                        collate_fn=np.stack, num_workers=args.num_workers,
                        num_shards=process_count(), shard_index=rank)
    exp_dir = os.path.join(ckpt_root, args.exp)
    draws = torch.Generator(device).manual_seed(DRAW_SEEDS[args.mode])
    if args.mode == "tivit":
        run = tivit_setup(args, device)
        dropout = (torch.Generator(device).manual_seed(LORA_DROPOUT_SEED + rank)
                   if args.lora_rank else None)
        tivit_step = make_tivit_step(run)
        step = lambda images: tivit_step(images, draws, dropout)  # noqa: E731
    else:
        run = dino_setup(args, device)
        inner = (make_dino_step(run, args.teacher_momentum) if args.mode == "dino"
                 else make_ti_step(run))
        step = lambda images: inner(images, draws)  # noqa: E731
    run["losses"] = []
    for epoch in range(1, args.epochs + 1):
        loader.set_epoch(epoch)
        for it, images in enumerate(loader):
            batch = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)
            loss, logs = step(batch)
            run["losses"].append(float(loss))
            if (it + 1) % args.log_every == 0:
                shown = " ".join(f"{k}={float(v):.4f}" for k, v in logs.items())
                print_(f"E{epoch} it{it + 1} {shown}")
        if rank == 0:
            save_payload(exp_dir, epoch, _payload(args.mode, run, epoch))
            print_(f"writing checkpoint for epoch {epoch}")
    return run


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cs_vit_tpu_torch TI pretraining")
    p.add_argument("--exp", required=True)
    p.add_argument("--mode", required=True, choices=["tivit", "dino", "ti"])
    p.add_argument("--dataset", default="coco", choices=["coco", "ego4d", "hint"])
    p.add_argument("--data_root", required=True)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lora_rank", type=int, default=0)
    p.add_argument("--teacher_momentum", type=float, default=0.996)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--num_workers", type=int, default=0, help="host loader threads")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def cli(argv=None, dataset=None) -> Optional[Dict]:
    """Console entry point, same surface as ``python -m``."""
    args = build_argparser().parse_args(argv)
    return main(args, device=args.device, dataset=dataset)


if __name__ == "__main__":
    cli()
