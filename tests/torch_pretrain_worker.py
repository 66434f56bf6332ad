"""One rank of the two-process gloo world that
``tests/test_torch_pretrain_world.py`` starts (``python
tests/torch_pretrain_worker.py RANK PORT WORKDIR``).

It reads ``WORKDIR/payload.pt`` (each TI mode's weights under the port's
names, a b4 batch of images, each mode's draws for the whole batch, an
image folder), joins the world and runs, on its half of the batch:

* each mode's step of ``cli.pretrain_ti`` (``make_tivit_step``,
  ``make_dino_step``, ``make_ti_step``) once, from the same weights, with
  the draws of the whole batch (the step takes this rank's rows);
* ``cli.pretrain_ti`` itself for one epoch of the ``tivit`` mode over its
  shard of the image folder;

and writes what it saw to ``WORKDIR/rank{RANK}.pt``. One CPU thread.
"""

import os
import sys

import torch
import torch.distributed as dist

from cs_vit_tpu_torch.cli import pretrain_ti
from cs_vit_tpu_torch.parallel import init_distributed
from cs_vit_tpu_torch.train import load_reference_state_dict
from cs_vit_tpu_torch.utils.dist import process_count, process_index

# the CLI's arguments at the tests' size (hidden 16, 2 heads: the width at
# which tests/test_torch_latent.py holds the latent groups to 1e-5)
SMALL = ["--img_size", "32", "--patch_size", "8", "--hidden_size", "16", "--num_layers", "2",
         "--num_heads", "2", "--lr", "1e-3", "--device", "cpu"]
STATS = ("running_mean", "running_var")


def args_of(mode, *extra):
    return pretrain_ti.build_argparser().parse_args(
        ["--exp", f"world_{mode}", "--mode", mode, "--data_root", "none"] + SMALL + list(extra))


def build_run(mode, weights):
    """The CLI's setup of `mode` on the CPU, its weights (and the centre)
    replaced by `weights`."""
    args = args_of(mode)
    if mode == "tivit":
        run = pretrain_ti.tivit_setup(args, torch.device("cpu"))
        load_reference_state_dict(run["model"], weights["model"])
        step = pretrain_ti.make_tivit_step(run)
        return run, lambda images, draws: step(images, draws)
    run = pretrain_ti.dino_setup(args, torch.device("cpu"))
    for k in ("student", "teacher", "trans"):
        load_reference_state_dict(run[k], weights[k])
    run["center"] = weights["center"].clone()
    if mode == "dino":
        return run, pretrain_ti.make_dino_step(run, args.teacher_momentum)
    return run, pretrain_ti.make_ti_step(run)


def snapshot(mode, run, loss, logs):
    """Loss, logs, and each module's parameters, grads and BatchNorm
    statistics after the step (the centre for TI-DINO)."""
    out = {"loss": loss.clone(), "logs": {k: v.clone() for k, v in logs.items()}}
    for key in (("model",) if mode == "tivit" else ("student", "teacher", "trans")):
        m = run[key]
        out[key] = {
            "params": {n: p.detach().clone() for n, p in m.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None},
            "stats": {n: b.clone() for n, b in m.named_buffers() if n.endswith(STATS)},
        }
    if mode != "tivit":
        out["center"] = run["center"].clone()
    return out


def main():
    rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    payload = torch.load(os.path.join(work, "payload.pt"), weights_only=False)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    assert init_distributed("cpu") and (process_index(), process_count()) == (rank, 2)
    images = payload["images"][2 * rank:2 * rank + 2]
    out = {}
    for mode in ("tivit", "dino", "ti"):
        run, step = build_run(mode, payload["weights"][mode])
        loss, logs = step(images, payload["draws"][mode])
        out[mode] = snapshot(mode, run, loss, logs)

    os.chdir(work)
    run = pretrain_ti.cli(["--exp", "cli", "--mode", "tivit", "--data_root", payload["root"],
                           "--epochs", "1", "--batch_size", "2", "--log_every", "1"] + SMALL)
    out["cli"] = {"losses": run["losses"],
                  "state": {k: v.clone() for k, v in run["model"].state_dict().items()}}
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    print("done")


if __name__ == "__main__":
    main()
