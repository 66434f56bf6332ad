"""Statistics over a batch that is split across processes.

The JAX package runs TI pretraining, and its tensor-parallel fine-tune, as
one ``jax.jit`` program over a device mesh: a BatchNorm there normalises by
the statistics of the global batch, and a mean inside a loss is the mean of
every row. The port runs one process per shard of that batch, so these
functions take the same statistics across a ``torch.distributed`` group:

* :func:`global_moments`: the per-channel mean and (biased) variance of the
  rows of every rank. Its forward all-reduces the count, the sum and the sum
  of squares (summed in f64, so that E[x^2] - E[x]^2 does not cancel); its
  backward all-reduces the two grad sums, so that each rank's input grad is
  that of the global function. ``torch.nn.SyncBatchNorm`` is not used: it
  refuses CPU tensors, and the CPU tests run gloo ranks.
* :func:`world_mean`: the mean over the group of a per-rank value (a loss
  term's mean over the rank's rows, with every rank holding as many rows).

Both are meant for a step whose grads are then averaged over the same group
(``parallel.all_mean_``): their backward hands each rank the grad of the sum
over the ranks' losses, which the average turns into the grad of the global
mean loss. So :func:`world_mean`'s backward is the identity.

``models.modules.TorchBatchNorm`` takes its statistics here when its
``sync_group`` names a group (:func:`sync_batch_norms`): :data:`WORLD` is
the default group while one of more than one rank exists (TI pretraining's
transformation groups), or a group object (the data group of tensor
parallelism). Without a group of more than one rank both functions are the
one-process computation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

# the default group, while one of more than one rank exists
WORLD = "world"


def resolve_group(group) -> Optional[object]:
    """The process group that `group` names, or None when the statistics
    are this process's own: None, no process group, or a group of one."""
    if group is None or not (dist.is_available() and dist.is_initialized()):
        return None
    pg = dist.group.WORLD if group == WORLD else group
    return pg if dist.get_world_size(pg) > 1 else None


class _GlobalMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        xd = x.double()
        n = torch.tensor([float(x.shape[0])], dtype=torch.float64, device=x.device)
        stats = torch.cat([n, xd.sum(0), (xd * xd).sum(0)])
        dist.all_reduce(stats, group=group)
        C = x.shape[1]
        count = stats[:1].clone()
        mean = stats[1:1 + C] / count
        var = torch.clamp(stats[1 + C:] / count - mean * mean, min=0.0)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        ctx.save_for_backward(x, mean)
        ctx.group, ctx.count = group, count.to(x.dtype)
        ctx.mark_non_differentiable(count)
        return mean, var, count

    @staticmethod
    def backward(ctx, g_mean: torch.Tensor, g_var: torch.Tensor, _):
        x, mean = ctx.saved_tensors
        sums = torch.cat([g_mean, g_var]).contiguous()
        dist.all_reduce(sums, group=ctx.group)
        C = mean.shape[0]
        gm, gv = sums[:C], sums[C:]
        grad = (gm + 2.0 * gv * (x - mean)) / ctx.count
        return grad, None


def global_moments(x: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean [C], biased variance [C], row count [1] in f64) of `x` [N, C]
    over the rows of every rank of `group` (a resolved group of more than
    one rank). Nothing waits for the card."""
    return _GlobalMoments.apply(x, group)


class _WorldMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def world_mean(x: torch.Tensor, group=WORLD) -> torch.Tensor:
    """The mean over the ranks of `group` of each rank's `x` (the identity
    without a group of more than one rank); its backward is the identity,
    for a step that averages its grads over the group."""
    pg = resolve_group(group)
    return x if pg is None else _WorldMean.apply(x, pg)


def sync_batch_norms(module: torch.nn.Module, group) -> None:
    """Have every ``TorchBatchNorm`` under `module` take its batch
    statistics over `group` (None: this process's rows)."""
    for m in module.modules():
        if hasattr(m, "sync_group"):
            m.sync_group = group
