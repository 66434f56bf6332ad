"""The reference's spatial train steps: the loss, autograd, the clip of the
global norm at 5.0 (``g`` below the limit, else ``g / norm * 5``) and
AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 0.01 decoupled, bias
corrected), over the parameters the spatial phase trains; a trained
parameter the loss does not reach takes a zero gradient and decays.

A step of data parallelism over n ranks takes n shards, each one rank's
rows: each shard runs the forward on its own (its BatchNorms on its own
rows' statistics, its own droppath and latent draws) and the backward, and
the loss and the gradients are the shards' mean, before the clip."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .model import Poser, trained


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)


def reference_steps(model: Poser, steps: List[List[Dict[str, torch.Tensor]]], lr: float,
                    gens: List[Optional[torch.Generator]],
                    latent_gens: Optional[List[Optional[torch.Generator]]],
                    moments: Optional[Dict] = None, loss_rows=None) -> Dict:
    """Run one step on each of `steps` in turn (each a list of shards, one
    a rank), from the model's weights and from a fresh optimizer state, or
    from `moments` (``exp_avg`` and ``exp_avg_sq``, tensors by leaf name,
    and ``steps``, the updates taken). ``gens[r]`` draws shard r's droppath
    masks, ``latent_gens[r]`` (None: no latent group) its latent group's
    scales and angles. Returns ``losses`` (one float a step, the shards'
    mean), and on the CPU ``joints`` (the first step's predicted joints of
    shard 0), ``grads`` (each trained leaf's clipped gradient of the first
    step) and ``change`` (each trained leaf's change over all the steps).
    `loss_rows`: the loss is taken over these rows of each shard only, the
    forward over all (a planted fault)."""
    names = [n for n, _ in model.named_parameters() if trained(n)]
    params = [model.get_parameter(n) for n in names]
    start = [p.detach().clone() for p in params]
    if moments is None:
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        t0 = 0
    else:
        m = [moments["exp_avg"][n].to(p.device, copy=True) for n, p in zip(names, params)]
        v = [moments["exp_avg_sq"][n].to(p.device, copy=True) for n, p in zip(names, params)]
        t0 = moments["steps"]
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01
    losses, grads, first = [], {}, None
    for t, shards in enumerate(steps, start=t0 + 1):
        step_losses, gs = [], None
        for r, batch in enumerate(shards):
            loss, out = model.loss(batch, gens[r], latent_gens and latent_gens[r], loss_rows)
            part = torch.autograd.grad(loss, params, allow_unused=True)
            part = [torch.zeros_like(p) if g is None else g for p, g in zip(params, part)]
            step_losses.append(float(loss.detach()))
            if r == 0:
                joints, gs = out.detach(), part
            else:
                with torch.no_grad():
                    gs = [a + b for a, b in zip(gs, part)]
            del loss, out, part
        with torch.no_grad():
            if len(shards) > 1:
                gs = [g / len(shards) for g in gs]
            norm = torch.sqrt(sum((g * g).sum() for g in gs))
            if not bool(norm < 5.0):
                gs = [g / norm * 5.0 for g in gs]
            if first is None:
                grads = {n: _host(g) for n, g in zip(names, gs)}
                first = _host(joints)
            for p, g, mi, vi in zip(params, gs, m, v):
                p.mul_(1 - lr * wd)
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vi.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(mi, denom, value=-lr / (1 - b1 ** t))
        losses.append(sum(step_losses) / len(step_losses))
    change = {n: _host(p.detach() - s) for n, p, s in zip(names, params, start)}
    return {"losses": losses, "joints": first, "grads": grads, "change": change}
