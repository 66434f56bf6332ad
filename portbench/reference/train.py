"""The reference's spatial train steps: the loss, autograd, the clip of the
global norm at 5.0 (``g`` below the limit, else ``g / norm * 5``) and
AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 0.01 decoupled, bias
corrected), over the parameters the spatial phase trains; a trained
parameter the loss does not reach takes a zero gradient and decays."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .model import Poser, trained


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)


def reference_steps(model: Poser, batches: List[Dict[str, torch.Tensor]], lr: float,
                    gen: Optional[torch.Generator], latent_gen: Optional[torch.Generator],
                    moments: Optional[Dict] = None, loss_rows=None) -> Dict:
    """Run one step on each of `batches` in turn, from the model's weights
    and from a fresh optimizer state, or from `moments` (``exp_avg`` and
    ``exp_avg_sq``, tensors by leaf name, and ``steps``, the updates taken).
    `gen` draws the droppath masks, `latent_gen` the latent group's scales
    and angles. Returns ``losses`` (one float a step), and on the CPU
    ``joints`` (the first step's predicted joints), ``grads`` (each trained
    leaf's clipped gradient of the first step) and ``change`` (each trained
    leaf's change over all the steps). `loss_rows`: the loss is taken over
    these rows of each batch only, the forward over all (a planted fault)."""
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
    for t, batch in enumerate(batches, start=t0 + 1):
        loss, joints = model.loss(batch, gen, latent_gen, loss_rows)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]
        with torch.no_grad():
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
        losses.append(float(loss.detach()))
    change = {n: _host(p.detach() - s) for n, p, s in zip(names, params, start)}
    return {"losses": losses, "joints": first, "grads": grads, "change": change}
