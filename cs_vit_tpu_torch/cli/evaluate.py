"""Evaluation -> HDF5 dump (port of ``cs_vit_tpu/cli/evaluate.py``; parity:
`scripts/eval.py`).

python -m cs_vit_tpu_torch.cli.evaluate --exp myexp --data dexycb --eval_ckpt <path>

The eval checkpoint is one of this package's ``.pt`` files (what
``cli.finetune`` writes, or ``tools/export_torch_ckpt.py`` from a JAX orbax
checkpoint).

With ``tp`` > 1 (the config's, or ``--tp``) the world is JAX's ``(data,
model)`` mesh (``parallel.tp``): each model group holds one sharded copy of
the Poser and reads one shard of the test split, and the gathers run over
the data group, so each row is written once:

torchrun --nproc_per_node=2 -m cs_vit_tpu_torch.cli.evaluate --tp 2 ...
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import numpy as np

from ..config import FinetuneConfig
from ..evaluation import (
    EvalH5Writer,
    gather_strings_to_host0,
    gather_to_host0,
    reproject_pinhole,
)
from ..models import init_poser_weights
from ..parallel import init_distributed
from ..parallel import tp as tensor_parallel
from ..serving import INIT_SEED, load_checkpoint_state_dict
from ..train import make_eval_step, merge_params
from ..utils.dist import process_index
from ..utils.logging import nop, wrap_prefix_print
from ..utils.profiling import annotate
from .common import (
    batch_to_device,
    build_datasets,
    build_loader,
    build_model,
    resolve_device,
    tp_mesh,
)


def main(cfg: FinetuneConfig, ckpt_root: str = "./checkpoints", h5_path: str | None = None,
         device="cuda", dataset=None, writer=None):
    """Predict every full batch of the test split and append it to the dump.

    `dataset` replaces the one ``build_datasets`` would build from `cfg`
    (same item schema); `writer` replaces the ``EvalH5Writer`` at `h5_path`
    (anything with its ``append`` and ``close``). Returns `h5_path`."""
    # eval protocol guard (ref `eval.py:198-201`)
    if not ((cfg.phase == "temporal" and cfg.temporal_supervision == "realtime")
            or cfg.phase == "spatial"):
        raise ValueError("eval supports spatial or temporal+realtime")
    device = resolve_device(device)
    init_distributed(device)
    mesh = tp_mesh(cfg)
    group = None if mesh is None else mesh.data_group

    is_main = process_index() == 0
    print_ = wrap_prefix_print(f"[{process_index()}] ") if is_main else nop

    if h5_path is None and writer is None:
        date_str = datetime.now().strftime("%Y%m%d")
        h5_path = os.path.join(
            ckpt_root, cfg.exp,
            f"eval_{cfg.data if isinstance(cfg.data, str) else cfg.data[0]}_"
            f"{cfg.phase}_{cfg.temporal_supervision}_{date_str}.h5",
        )
        os.makedirs(os.path.dirname(h5_path), exist_ok=True)

    if dataset is None:
        dataset = build_datasets(cfg, "test")
    loader = build_loader(cfg, dataset, shuffle=False, mesh=mesh)

    # latent constraints are train-only; eval drops them (ref `eval.py:146`)
    cfg.num_latent_layer = None
    model = build_model(cfg)
    init_poser_weights(model, INIT_SEED)
    if cfg.eval_ckpt:
        merged, skipped = merge_params(model.state_dict(),
                                       load_checkpoint_state_dict(cfg.eval_ckpt))
        model.load_state_dict(merged, strict=True)
        print_(f"loaded eval ckpt ({len(skipped)} unmatched leaves)")
    model.to(device).eval()
    if mesh is not None:
        tensor_parallel.shard_model(model, mesh)
    eval_step = make_eval_step(model, phase="inference")

    own_writer = writer is None
    if own_writer:
        writer = EvalH5Writer(h5_path)
    print_("evaluation starts")

    def flush(host_batch, imgs_path, predict_dev):
        """Copy to the host + reproject + gather + append for one batch."""
        joint_cam_pred = predict_dev["joint_cam"].float().cpu().numpy()  # [B,T',21,3]
        focal = host_batch["focal"][:, -joint_cam_pred.shape[1]:]
        princpt = host_batch["princpt"][:, -joint_cam_pred.shape[1]:]
        reproj_pred = reproject_pinhole(joint_cam_pred, focal, princpt)

        joint_cam_gt = host_batch["joint_cam"][:, -1]
        joint_reproj_gt = host_batch["joint_img"][:, -1]

        writer.append(
            gather_strings_to_host0(imgs_path, group),
            gather_to_host0(joint_cam_gt, group),
            gather_to_host0(joint_cam_pred[:, -1], group),
            gather_to_host0(joint_reproj_gt, group),
            gather_to_host0(reproj_pred[:, -1], group),
        )

    # one-batch software pipeline: batch N+1's forward is issued before
    # batch N's copy to the host, reprojection and append, so that host work
    # overlaps the card's
    pending = None
    batches, loader_wait = 0, 0.0
    t_start = time.perf_counter()
    host_batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        with annotate("csvit.data.wait"):
            host_batch = next(host_batches, None)
        loader_wait += time.perf_counter() - t0
        if host_batch is None:
            break
        imgs_path = [p[-1] for p in host_batch.pop("imgs_path")]
        host_batch.pop("flip", None)
        predict_dev = eval_step(batch_to_device(host_batch, device))
        if pending is not None:
            flush(*pending)
        pending = (host_batch, imgs_path, predict_dev)
        batches += 1
    if pending is not None:
        flush(*pending)
    wall = time.perf_counter() - t_start
    writer.close()
    print_(f"eval: {batches} batches of {cfg.batch_size} in {wall:.3f} s, "
           f"{1e3 * wall / max(batches, 1):.3f} ms a batch, "
           f"{loader_wait / wall:.4f} of the wall waiting on the loader")
    print_(f"eval dump written to {h5_path}" if own_writer else "eval rows handed to the writer")
    return h5_path


def cli(argv=None):
    """Console entry point (`csvit-torch-evaluate`), same surface as `python -m`."""
    p = argparse.ArgumentParser(prog="cs_vit_tpu_torch eval")
    p.add_argument("--exp", type=str, required=True)
    p.add_argument("--data", type=str, required=True,
                   choices=["interhand26m", "ho3d", "dexycb"])
    p.add_argument("--seq_len", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--eval_ckpt", type=str, required=True)
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel size (default: the config's)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = vars(p.parse_args(argv))
    device = args.pop("device")
    if args["tp"] is None:
        del args["tp"]

    cfg_path = os.path.join("./checkpoints", args["exp"], "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"missing {cfg_path}")
    cfg = FinetuneConfig.from_json_file(cfg_path)
    cfg.update(args)
    np.random.seed(42)
    main(cfg, device=device)


if __name__ == "__main__":
    cli()
