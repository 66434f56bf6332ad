"""One rank of the gloo worlds that ``tests/test_torch_tp.py`` starts
(``python tests/torch_tp_worker.py RANK WORLD PORT WORKDIR``), tensor
parallel at ``tp`` = 2: a ``(1, 2)`` mesh in a world of two, ``(2, 2)`` in a
world of four.

It reads ``WORKDIR/payload.pt`` (the tiny Poser, ``tiny``, and a second one
with droppath and a latent group, ``drop``: each its SwinV2 and Poser
configs and its weights under the port's names; a b4 batch; the DexYCB
fixture's root) and writes what it
saw to ``WORKDIR/w{WORLD}_rank{RANK}.pt``:

* ``jax``: one sharded f32 step on this data rank's rows of the batch (no
  droppath), gathered whole: loss, grad norm, parameters, statistics and
  AdamW moments;
* world of two: ``one`` (before the world exists) and ``drop``: the second
  Poser's step with droppath and latent draws from the same generator
  seeds, one process and sharded; ``local``, this rank's own state dict
  after ``drop``;
* the CLIs under ``--tp 2``: ``cli.finetune`` for an epoch, from scratch
  (``tp``) and resumed from a checkpoint written without tensor parallelism
  (``plain``), and ``cli.evaluate --tp 2`` (the command line in the world
  of two, into ``checkpoints/tp/``); in the world of two, rank 0
  then, alone: ``cli.finetune`` without tensor parallelism resumed from the
  TP checkpoint and from the one the ``plain`` run resumed from
  (``plain_ref``), and ``cli.evaluate`` without it.

One CPU thread, so that sums run in one order.
"""

import os
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

from cs_vit_tpu_torch.cli import evaluate, finetune
from cs_vit_tpu_torch.parallel import init_distributed, make_mesh
from cs_vit_tpu_torch.parallel import tp
from cs_vit_tpu_torch.train import TrainState, build_optimizer, make_train_step

from tests.torch_dp_worker import build, finetune_cfg

STATS = ("running_mean", "running_var")


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def generators(seed):
    return (torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed + 1000))


def step_once(payload, key, batch, mesh=None, gens=(None, None)):
    """One spatial step of the Poser `key` of the payload; the model, the
    state and the metrics."""
    model = build(payload[key])
    if mesh is not None:
        tp.shard_model(model, mesh)
    opt = build_optimizer(model, "spatial", payload["lr"])
    if mesh is not None:
        tp.shard_optimizer(opt, model, mesh)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, "spatial", mesh=mesh)
    state, metrics = step(state, tensors(batch), *gens)
    return model, state, metrics


def whole(model, state, metrics, mesh=None):
    """The step's results as one process holds them: every tensor whole."""
    specs = tp.model_specs(model)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, names = state.optimizer, {id(p): n for n, p in model.named_parameters()}
    moments = {k: {names[id(p)]: opt.state[p][k].clone() for p in opt.params()
                   if p in opt.state} for k in ("exp_avg", "exp_avg_sq")}
    if mesh is not None:
        params = tp.gather_state_dict(params, specs, mesh)
        moments = {k: tp.gather_state_dict(v, specs, mesh) for k, v in moments.items()}
    return {"params": params, "stats": {n: b.clone() for n, b in model.named_buffers()
                                        if n.endswith(STATS)},
            **moments, "step": state.step,
            **{k: metrics[k].clone() for k in ("loss", "grad_norm", "skipped")}}


def checkpoints(work, mesh_shape):
    """The checkpoint root of a world: the CLIs' default ``./checkpoints``
    (the workers run in WORKDIR) for the (1, 2) mesh."""
    return os.path.join(work, "checkpoints" if mesh_shape == "1x2" else "checkpoints_2x2")


def cli_runs(payload, work, mesh_shape):
    """cli.finetune and cli.evaluate under --tp 2 in the world: the (1, 2)
    world evaluates through the command line's ``--tp 2`` over a config
    written without it, the (2, 2) world through ``evaluate.main``."""
    ckpt_root = checkpoints(work, mesh_shape)
    out = {}
    state = finetune.main(finetune_cfg(payload, exp="tp", tp=2), ckpt_root=ckpt_root,
                          log_every=1000, device="cpu")
    out["tp_steps"] = state.step
    out["tp_local"] = {k: v.clone() for k, v in state.model.state_dict().items()}
    if mesh_shape == "1x2":
        state = finetune.main(finetune_cfg(payload, exp="plain", tp=2, epoch=2),
                              ckpt_root=ckpt_root, log_every=1000, device="cpu")
        out["plain_steps"] = state.step
    ckpt = os.path.join(ckpt_root, "tp", "checkpoint_1")
    if mesh_shape == "1x2":
        if dist.get_rank() == 0:
            with open(os.path.join(ckpt_root, "tp", "config.json"), "w") as f:
                f.write(finetune_cfg(payload, exp="tp").to_json())
        dist.barrier()  # rank 0 has written the checkpoints and the config
        evaluate.cli(["--exp", "tp", "--data", "dexycb", "--batch_size", "4", "--eval_ckpt",
                      ckpt, "--tp", "2", "--device", "cpu"])
    else:
        dist.barrier()  # rank 0 has written the checkpoints
        evaluate.main(finetune_cfg(payload, tp=2, eval_ckpt=ckpt), ckpt_root=ckpt_root,
                      h5_path=os.path.join(work, "eval_tp_2x2.h5"), device="cpu")
    return out


def main():
    rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    payload = torch.load(os.path.join(work, "payload.pt"), weights_only=False)
    shape = "1x2" if world == 2 else "2x2"
    ckpt_root = checkpoints(work, shape)
    out = {}
    if world == 2:
        out["one"] = whole(*step_once(payload, "drop", payload["batch"],
                                      gens=generators(5)))
        if rank == 0:  # an epoch without tensor parallelism, resumed in the world
            finetune.main(finetune_cfg(payload, exp="plain"), ckpt_root=ckpt_root,
                          log_every=1000, device="cpu")
            shutil.copytree(os.path.join(ckpt_root, "plain"),
                            os.path.join(ckpt_root, "plain_ref"), symlinks=True)

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    assert init_distributed("cpu")
    mesh = make_mesh(n_model=2)
    rows = slice(2 * mesh.data_rank, 2 * mesh.data_rank + 2) if world == 4 else slice(0, 4)
    batch = {k: v[rows] for k, v in payload["batch"].items()}
    out["jax"] = whole(*step_once(payload, "tiny", batch, mesh), mesh)
    if world == 2:
        model, state, metrics = step_once(payload, "drop", payload["batch"], mesh, generators(5))
        out["drop"] = whole(model, state, metrics, mesh)
        out["local"] = {k: v.clone() for k, v in model.state_dict().items()}
        out["specs"] = tp.model_specs(model)
    out.update(cli_runs(payload, work, shape))
    dist.destroy_process_group()
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        del os.environ[k]
    if world == 2 and rank == 0:
        for exp in ("tp", "plain_ref"):
            finetune.main(finetune_cfg(payload, exp=exp, epoch=2), ckpt_root=ckpt_root,
                          log_every=1000, device="cpu")
        evaluate.main(finetune_cfg(payload, eval_ckpt=os.path.join(ckpt_root, "tp",
                                                                   "checkpoint_1")),
                      ckpt_root=ckpt_root, h5_path=os.path.join(work, "eval_one.h5"),
                      device="cpu")
    torch.save(out, os.path.join(work, f"w{world}_rank{rank}.pt"))
    print("done")


if __name__ == "__main__":
    main()
