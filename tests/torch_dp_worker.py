"""One rank of the two-process gloo world that ``tests/test_torch_parallel.py``
starts (``python tests/torch_dp_worker.py RANK PORT WORKDIR``).

It reads ``WORKDIR/payload.pt`` (the port's tiny Poser as a reference state
dict, its config, a b4 batch as numpy arrays, the DexYCB fixture's root),
runs every case once and writes what it saw to ``WORKDIR/rank{RANK}.pt``:

* ``one``: a one-process step on the whole batch, before the world exists
* ``halves``: one step on this rank's half of the batch, in the world
* ``same``: one step on the whole batch, in the world
* ``nan``: one step on the halves with a NaN in rank 1's shard
* ``finetune``: the parameters and statistics ``cli.finetune`` leaves after
  two steps on this rank's shard of the fixture
* rank 0 also writes ``eval_world.h5`` (``cli.evaluate`` in the world) and,
  after the world is gone, ``eval_one.h5`` (one process)

One CPU thread, so that the one-process and the in-world steps sum in the
same order.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from cs_vit_tpu_torch.cli import evaluate, finetune
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.mano import ManoLayer, sh_joint_regressor, synthetic_assets
from cs_vit_tpu_torch.models import Poser, PoserConfig, SwinV2Config
from cs_vit_tpu_torch.parallel import init_distributed
from cs_vit_tpu_torch.train import (
    TrainState,
    build_optimizer,
    load_reference_state_dict,
    make_train_step,
)
from cs_vit_tpu_torch.utils.dist import process_count, process_index

STATS = ("running_mean", "running_var")


def build(payload):
    sw = SwinV2Config(**payload["swin"])
    assets = synthetic_assets(seed=1)
    model = Poser(PoserConfig(custom_swin=sw, **payload["poser"]), ManoLayer(assets),
                  sh_joint_regressor(assets))
    return load_reference_state_dict(model, payload["state_dict"])


def snapshot(model, state=None, metrics=None):
    out = {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
           "stats": {n: b.clone() for n, b in model.named_buffers() if n.endswith(STATS)}}
    if state is not None:
        opt, names = state.optimizer, {id(p): n for n, p in model.named_parameters()}
        for k in ("exp_avg", "exp_avg_sq"):
            out[k] = {names[id(p)]: opt.state[p][k].clone() for p in opt.params()
                      if p in opt.state}
        out.update(step=state.step, **{k: metrics[k].clone() for k in
                                       ("loss", "grad_norm", "skipped")})
    return out


def step_once(payload, batch):
    model = build(payload)
    state = TrainState.create(model, build_optimizer(model, "spatial", payload["lr"]))
    step = make_train_step(model, state.optimizer, "spatial")
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    return snapshot(model, state, metrics)


def finetune_cfg(payload, **over):
    cfg = FinetuneConfig(exp="dp", epoch=1, backbone="test", data=["dexycb"], seq_len=2,
                         batch_size=4, phase="spatial", temporal_supervision="full",
                         lr=1e-3, lr_scheduler="constant", img_size=32, num_workers=0,
                         dexycb_root=payload["dexycb_root"])
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def main():
    rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    payload = torch.load(os.path.join(work, "payload.pt"), weights_only=False)
    batch = payload["batch"]
    half = {k: v[2 * rank:2 * rank + 2] for k, v in batch.items()}
    out = {"one": step_once(payload, batch)}

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    assert init_distributed("cpu") and (process_index(), process_count()) == (rank, 2)
    out["halves"] = step_once(payload, half)
    out["same"] = step_once(payload, batch)
    bad = {k: v.copy() for k, v in half.items()}
    if rank == 1:
        bad["joint_cam"][0, 0, 0, 0] = np.nan
    out["nan"] = step_once(payload, bad)

    ckpt_root = os.path.join(work, "checkpoints")
    state = finetune.main(finetune_cfg(payload), ckpt_root=ckpt_root, log_every=1000,
                          device="cpu")
    out["finetune"] = snapshot(state.model)
    out["finetune_steps"] = state.step
    dist.barrier()  # rank 0 has written the checkpoint
    eval_cfg = finetune_cfg(payload, eval_ckpt=os.path.join(ckpt_root, "dp", "checkpoint"))
    evaluate.main(eval_cfg, ckpt_root=ckpt_root, h5_path=os.path.join(work, "eval_world.h5"),
                  device="cpu")
    dist.destroy_process_group()
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        del os.environ[k]
    if rank == 0:
        evaluate.main(eval_cfg, ckpt_root=ckpt_root, h5_path=os.path.join(work, "eval_one.h5"),
                      device="cpu")
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    print("done")


if __name__ == "__main__":
    main()
