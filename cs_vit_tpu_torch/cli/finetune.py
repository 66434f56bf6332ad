"""Training entry point (port of ``cs_vit_tpu/cli/finetune.py``; parity:
`scripts/finetune.py`).

python -m cs_vit_tpu_torch.cli.finetune --exp myexp --phase spatial \
    --temporal_supervision full --backbone swinv2-tiny-256 --data dexycb ...

The phase's train step (``train.make_train_step``, with its NaN skip and
grad clip) over the host loader's batches, a ``.pt`` checkpoint per epoch
with a ``checkpoint`` symlink, resume from that symlink, and the
warmup-cosine or constant lr. Batches reach the card through
``parallel.device_prefetch`` (pinned memory, a side stream, ``patches``
cast to the compute dtype on the host), as the JAX loop's do. A JAX orbax
checkpoint comes across through ``tools/export_torch_ckpt.py``.

Under ``torchrun`` (``parallel.init_distributed``) each rank reads its
shard of the data, the step averages across the ranks as JAX's
``shard_map`` step does, and rank 0 alone writes the config, logs and
checkpoints:

torchrun --nproc_per_node=1 -m cs_vit_tpu_torch.cli.finetune ...

With ``--tp N`` the world of ``n_data`` x N ranks is JAX's ``(data,
model)`` mesh (``parallel.tp``): each model group of N consecutive ranks
holds one copy of the Poser, Megatron-sharded, on the eager attention path,
and reads one shard of the data; the lr scales with ``n_data``; the
droppath and latent generators are seeded by the data rank, so that model
peers draw the same masks; the checkpoint is the one-process one, gathered
on rank 0, and a resume cuts it to the ranks' shards:

torchrun --nproc_per_node=4 -m cs_vit_tpu_torch.cli.finetune --tp 2 ...
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch

from ..config import FinetuneConfig
from ..models import init_poser_weights
from ..parallel import device_prefetch, init_distributed
from ..parallel import tp as tensor_parallel
from ..serving import INIT_SEED, load_checkpoint_state_dict
from ..train import (
    TrainState,
    build_optimizer,
    constant_schedule,
    latest_checkpoint,
    make_train_step,
    merge_params,
    restore_checkpoint,
    save_checkpoint,
    save_payload,
    scaled_lr,
    warmup_cosine_schedule,
)
from ..utils.dist import process_count, process_index
from ..utils.logging import TBLogger, nop, print_grouped_losses, wrap_prefix_print
from ..utils.profiling import StepTimer, annotate
from .common import (
    build_datasets,
    build_loader,
    build_model,
    load_backbone_params,
    load_or_create_config,
    resolve_device,
    tp_mesh,
)

# the droppath generator is seeded DROPPATH_SEED + data rank (the JAX loop's
# key 42 + process index), the latent draws' LATENT_SEED + data rank
DROPPATH_SEED, LATENT_SEED = 42, 1042


def main(cfg: FinetuneConfig, ckpt_root: str = "./checkpoints", log_every: int = 20,
         device="cuda", dataset=None) -> TrainState:
    """Train `cfg` for epochs ``start..cfg.epoch``, resuming after the last
    checkpoint of ``<ckpt_root>/<cfg.exp>``. `dataset` replaces the one
    ``build_datasets`` would build from `cfg` (same item schema)."""
    device = resolve_device(device)
    init_distributed(device)
    rank = process_index()
    is_main = rank == 0
    print_ = wrap_prefix_print(f"[{rank}] ") if is_main else nop
    exp_dir = os.path.join(ckpt_root, cfg.exp)
    mesh = tp_mesh(cfg)
    data_rank, n_data = (rank, process_count()) if mesh is None else (mesh.data_rank,
                                                                      mesh.n_data)

    # 1. data
    if dataset is None:
        dataset = build_datasets(cfg, "train")
    loader = build_loader(cfg, dataset, shuffle=True, mesh=mesh)
    steps_per_epoch = len(loader)

    # 2. model
    model = build_model(cfg)
    init_poser_weights(model, INIT_SEED)

    # pretrained HF backbone weights when --backbone is a checkpoint dir
    if cfg.backbone and os.path.isdir(cfg.backbone):
        if load_backbone_params(cfg.backbone, model.backbone):
            print_(f"loaded pretrained backbone from {cfg.backbone}")

    # temporal phase: start from the spatial checkpoint, strict=False
    if cfg.phase == "temporal" and cfg.spatial_ckpt:
        merged, skipped = merge_params(model.state_dict(),
                                       load_checkpoint_state_dict(cfg.spatial_ckpt))
        model.load_state_dict(merged, strict=True)
        print_(f"loaded spatial ckpt ({len(skipped)} unmatched leaves kept fresh)")
    model.to(device)
    if mesh is not None:
        tensor_parallel.shard_model(model, mesh)
        print_(f"tensor parallel: {mesh.n_data} x {mesh.n_model} ranks (data x model)")

    # 3. optimizer + schedule
    max_lr = scaled_lr(cfg.lr, n_data, cfg.batch_size)
    min_lr = scaled_lr(cfg.lr_min, n_data, cfg.batch_size)
    if cfg.lr_scheduler == "warmup":
        schedule = warmup_cosine_schedule(
            max_lr, min_lr, cfg.warmup_epoch, cfg.cooldown_epoch, steps_per_epoch
        )
    else:
        schedule = constant_schedule(max_lr)
    optimizer = build_optimizer(model, cfg.phase, schedule)
    if mesh is not None:
        tensor_parallel.shard_optimizer(optimizer, model, mesh)
    state = TrainState.create(model, optimizer)

    # 4. resume: model (strict), AdamW, step, then the epoch after the saved one
    start_epoch = 1
    latest = latest_checkpoint(exp_dir)
    if latest:
        print_(f"found checkpoints, resuming from {latest}")
        if mesh is None:
            restore_checkpoint(latest, state)
        else:
            tensor_parallel.restore_checkpoint(latest, state, mesh)
        start_epoch = state.epoch + 1

    # 5. the step
    compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else None
    train_step = make_train_step(model, optimizer, cfg.phase, compute_dtype=compute_dtype,
                                 mesh=mesh)
    tb = TBLogger(os.path.join(exp_dir, "tb_logs") if is_main else None, is_main)

    generator = torch.Generator(device).manual_seed(DROPPATH_SEED + data_rank)
    latent_generator = (torch.Generator(device).manual_seed(LATENT_SEED + data_rank)
                        if model.latent_trans is not None else None)

    for epoch in range(start_epoch, cfg.epoch + 1):
        t0 = datetime.datetime.now()
        print_(f"training for epoch {epoch}/{cfg.epoch}, start {t0:%Y-%m-%d_%H:%M:%S}")
        loader.set_epoch(epoch)
        t_log = time.monotonic()
        meter = StepTimer(warmup=2)
        loader_wait, t_ready = 0.0, time.perf_counter()
        batches = enumerate(device_prefetch(loader, device, patches_dtype=compute_dtype))
        while True:
            with annotate("csvit.data.wait"):
                item = next(batches, None)
            if item is None:
                break
            it, batch = item
            loader_wait += time.perf_counter() - t_ready
            state, metrics = train_step(state, batch, generator, latent_generator)
            meter.update(cfg.batch_size)

            if (it + 1) % log_every == 0:
                if bool(metrics["skipped"]):
                    print_("loss is nan, skipped batch")
                global_step = epoch * steps_per_epoch + it + 1
                lr_now = float(schedule(state.step))
                tb.scalars(metrics["scalar_logs"], global_step)
                tb.scalar("train/lr", lr_now, global_step)
                tb.scalar("train/grad", float(metrics["grad_norm"]), global_step)
                if tb.writer is not None:
                    tb.image("train/reprojection", reprojection_image(batch, metrics, cfg),
                             global_step)
                iter_time = (time.monotonic() - t_log) / log_every
                print_grouped_losses(
                    epoch, it, steps_per_epoch, iter_time, lr_now,
                    metrics["scalar_logs"], print_,
                )
                t_log = time.monotonic()
            t_ready = time.perf_counter()

        t1 = datetime.datetime.now()
        print_(
            f"epoch {epoch} ends at {t1:%Y-%m-%d_%H:%M:%S}, cost {t1 - t0}"
            f" ({meter.samples_per_sec:.1f} samples/s, "
            f"{loader_wait / max((t1 - t0).total_seconds(), 1e-9):.4f} of the wall waiting "
            "on the loader)"
        )

        state.epoch = epoch
        if mesh is not None:  # every rank gathers its model group's shards
            payload = tensor_parallel.full_checkpoint(state, mesh)
        if is_main:
            print_(f"writing checkpoint for epoch {epoch}")
            if mesh is None:
                save_checkpoint(exp_dir, epoch, state)
            else:
                save_payload(exp_dir, epoch, payload)
    tb.close()
    return state


def reprojection_image(batch, metrics, cfg: FinetuneConfig) -> np.ndarray:
    """The logging step's reprojection grid (ref `finetune.py:245-255`): the
    first ``min(4, batch)`` rows of the batch and of the step's predicted
    joints, copied to the host here and only here."""
    from ..utils.vis import training_reprojection_image

    k = min(4, cfg.batch_size)

    def host(t):
        return t[:k].float().cpu().numpy()

    return training_reprojection_image(
        host(batch["patches"]), host(batch["square_bboxes"]), host(batch["focal"]),
        host(batch["princpt"]), host(metrics["joint_cam_pred"]),
        host(batch["joint_img"]) if "joint_img" in batch else None)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cs_vit_tpu_torch finetune")
    p.add_argument("--exp", type=str, required=True)
    p.add_argument("--epoch", type=int, default=30)
    p.add_argument("--phase", type=str, required=True,
                   choices=["spatial", "temporal", "inference"])
    p.add_argument("--spatial_ckpt", type=str, default=None)
    p.add_argument("--temporal_supervision", type=str, required=True,
                   choices=["full", "realtime"])
    p.add_argument("--backbone", type=str, required=True)
    p.add_argument("--global_positioning", type=str, default="direct",
                   choices=["direct", "orientation"])
    p.add_argument("--num_latent_layer", type=int, default=None)
    p.add_argument("--spatial_layer_type", type=str, default="decoder",
                   choices=["decoder", "encoder"])
    p.add_argument("--temporal_init_method", type=str, default="zero",
                   choices=["zero", "random"])
    p.add_argument("--persp_embed_method", type=str, default="dense",
                   choices=["dense", "sparse"])
    p.add_argument("--persp_decorate", type=str, default="query",
                   choices=["query", "patch"])
    p.add_argument("--data", type=str, required=True, nargs="+",
                   choices=["interhand26m", "ho3d", "dexycb"])
    p.add_argument("--seq_len", type=int, default=7)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_min", type=float, default=1e-6)
    p.add_argument("--lr_scheduler", type=str, default="warmup",
                   choices=["warmup", "constant"])
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--ih26mseq_root", type=str, default=None)
    p.add_argument("--ho3d_root", type=str, default=None)
    p.add_argument("--dexycb_root", type=str, default=None)
    p.add_argument("--mano_model_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true", default=False)
    p.add_argument("--num_workers", type=int, default=None,
                   help="host loader threads (default: config, 8)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel size (the model axis of an n_data x tp world of "
                        "ranks; the eager attention path)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def cli(argv=None):
    """Console entry point (`csvit-torch-finetune`), same surface as `python -m`."""
    args = build_argparser().parse_args(argv)
    init_distributed(args.device)  # so that rank 0 alone writes the config
    np.random.seed(42)
    arg_dict = {k: v for k, v in vars(args).items() if v is not None and k != "device"}
    cfg = load_or_create_config(args.exp, arg_dict)
    main(cfg, device=args.device)


if __name__ == "__main__":
    cli()
