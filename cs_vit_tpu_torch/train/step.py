"""The train and eval steps (port of ``cs_vit_tpu/train/step.py``, one device).

Mixed precision the JAX way: with ``compute_dtype=torch.bfloat16`` the
forward and backward run on bf16 copies of the f32 master parameters (the
model is called through ``torch.func.functional_call``), the images are cast
to bf16, and the loss, the BatchNorm statistics, the grads of the masters and
the optimizer state stay f32. A non-finite loss leaves the parameters, the
AdamW state and the BatchNorm running statistics untouched and does not
advance ``step``: the forward updates copies of the running statistics of
the BatchNorms the phase trains, which are written back only on an accepted
step; the other statistics are never written.

The phase decides what trains (``phase_trainable_params``): in
``"temporal"`` only the temporal encoders, whose BatchNorms run on batch
statistics, while the model runs the backbone and the spatial encoder
without autograd; the frozen parameters' compute-dtype copies are made
without autograd too.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from .optim import PhaseAdamW, global_norm
from .state import TrainState

_STAT_SUFFIXES = (".running_mean", ".running_var")


def make_train_step(
    model: torch.nn.Module, optimizer: PhaseAdamW, phase: str,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[..., Tuple[TrainState, Dict]]:
    """``step(state, batch, generator, latent_generator) -> (state,
    metrics)`` for `phase`.

    `batch` holds the ``Poser.forward`` inputs as tensors on the model's
    device; `generator` draws the droppath masks (None: no droppath),
    `latent_generator` the latent group's scales and angles (a model with a
    latent group needs one; the JAX step splits its key into these two
    streams). The
    metrics are the JAX step's: ``loss``, ``grad_norm`` (pre-clip, over the
    trainable parameters), ``skipped`` (1.0 on a non-finite loss),
    ``scalar_logs`` and ``joint_cam_pred``. After an accepted step each
    trainable parameter's ``.grad`` holds its clipped grad: zeros where the
    loss does not reach it (the encoder-type spatial layers before the last),
    so that AdamW's decay still applies there, as under JAX's masked AdamW.
    """
    if phase not in ("spatial", "temporal"):
        raise ValueError(f"phase must be 'spatial' or 'temporal', got {phase!r}")
    trainable = optimizer.params()
    trained_ids = {id(p) for p in trainable}
    # the running statistics of the BatchNorms whose scales the phase trains
    weights = dict(model.named_parameters())
    stat_names = [n for n, _ in model.named_buffers() if n.endswith(_STAT_SUFFIXES)
                  and id(weights[n.rsplit(".", 1)[0] + ".weight"]) in trained_ids]

    def cast(p):
        if compute_dtype is None or not p.is_floating_point():
            return p
        if id(p) in trained_ids:
            return p.to(compute_dtype)
        with torch.no_grad():
            return p.to(compute_dtype)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             latent_generator: Optional[torch.Generator] = None):
        params = {n: cast(p) for n, p in model.named_parameters()}
        if compute_dtype is not None:
            batch = {**batch, "patches": batch["patches"].to(compute_dtype)}
        stats = {n: model.get_buffer(n).clone() for n in stat_names}
        out = functional_call(model, {**params, **stats}, (batch, phase, generator, latent_generator))
        loss = out["loss"].float()
        grads = torch.autograd.grad(loss, trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainable, grads)]
        finite = bool(torch.isfinite(loss))
        if finite:
            for p, g in zip(trainable, grads):
                p.grad = g
            grad_norm = optimizer.clip_grads_()
            optimizer.scheduled_step()
            with torch.no_grad():
                for n, v in stats.items():
                    model.get_buffer(n).copy_(v)
            state.step += 1
        else:
            grad_norm = global_norm(grads)
        metrics = {
            "loss": loss.detach(),
            "grad_norm": grad_norm,
            "skipped": torch.tensor(0.0 if finite else 1.0),
            "scalar_logs": _detach(out["logs"]["scalar"]),
            "joint_cam_pred": out["predict"]["joint_cam"].detach().float(),
        }
        return state, metrics

    return step


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def make_eval_step(model: torch.nn.Module, phase: str = "inference"
                   ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``eval_step(batch) -> predictions`` (ref `scripts/eval.py:259-266`):
    ``Poser.predict`` with `phase` under ``torch.no_grad()``, on the
    parameters as the model stores them (the JAX eval step casts nothing
    either). `batch` holds tensors on the model's device."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return model.predict(batch["patches"], batch["square_bboxes"], batch["timestamp"],
                             batch["focal"], batch["princpt"], phase)

    return eval_step
