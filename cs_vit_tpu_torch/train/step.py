"""The train and eval steps (port of ``cs_vit_tpu/train/step.py``).

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

Data parallelism is JAX's ``shard_map`` step (`cs_vit_tpu/train/step.py:94-107`)
over a ``torch.distributed`` world: each rank runs the forward and backward
on its own rows, then the loss, every grad, the scalar logs and the fresh
BatchNorm statistics are averaged across the world in one collective
(``parallel.all_mean_``) before the step decides whether it is finite, so
that every rank takes the same branch. So each BatchNorm normalises a rank's
rows by that rank's own statistics, as under ``shard_map``, and the running
statistics move by their mean; the model is not wrapped in
``DistributedDataParallel``, whose buffer broadcast would copy rank 0's.
Without a process group the averaging is the identity.

Tensor parallelism (``parallel.tp``) is JAX's global-jit step over a
``(data, model)`` mesh: with ``mesh`` the model is sharded over the model
group, its BatchNorms normalise the global batch (over the data group), the
step averages over the data group only, and the optimizer's norm spans the
model group. Each model peer computes the grads of the replicated
parameters itself, and CUDA kernels that add with atomics (the backward of
an advanced index, such as the CPB table's gather) leave the peers' bits
apart; so the step first averages the replicated values (loss, their grads,
logs, fresh statistics) over the model group, and the peers' replicated
tensors stay bit-identical.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.func import functional_call

from ..parallel.mesh import all_mean_
from .optim import PhaseAdamW
from .state import TrainState

_STAT_SUFFIXES = (".running_mean", ".running_var")


def make_train_step(
    model: torch.nn.Module, optimizer: PhaseAdamW, phase: str,
    compute_dtype: Optional[torch.dtype] = None, mesh=None,
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
    `mesh` (a ``parallel.Mesh``): the model and `optimizer` are sharded for
    tensor parallelism, and the step averages over its data group.
    """
    if phase not in ("spatial", "temporal"):
        raise ValueError(f"phase must be 'spatial' or 'temporal', got {phase!r}")
    trainable = optimizer.params()
    trained_ids = {id(p) for p in trainable}
    # the running statistics of the BatchNorms whose scales the phase trains
    weights = dict(model.named_parameters())
    stat_names = [n for n, _ in model.named_buffers() if n.endswith(_STAT_SUFFIXES)
                  and id(weights[n.rsplit(".", 1)[0] + ".weight"]) in trained_ids]

    group = None if mesh is None else mesh.data_group

    def cast(p):
        if compute_dtype is None or not p.is_floating_point():
            return p
        if id(p) in trained_ids:
            return p.to(compute_dtype)
        with torch.no_grad():
            return p.to(compute_dtype)

    def local(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
              latent_generator: Optional[torch.Generator] = None) -> Dict:
        """This rank's part of the step: the loss, the grads of the trainable
        parameters (zeros where the loss does not reach them), the scalar
        logs, the fresh BatchNorm statistics and the predicted joints."""
        params = {n: cast(p) for n, p in model.named_parameters()}
        if compute_dtype is not None:
            batch = {**batch, "patches": batch["patches"].to(compute_dtype)}
        stats = {n: model.get_buffer(n).clone() for n in stat_names}
        out = functional_call(model, {**params, **stats},
                              (batch, phase, generator, latent_generator))
        loss = out["loss"].float()
        grads = torch.autograd.grad(loss, trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainable, grads)]
        return {"loss": loss.detach().clone(), "grads": grads,
                "scalar_logs": _detach(out["logs"]["scalar"]), "stats": stats,
                "joint_cam_pred": out["predict"]["joint_cam"].detach().float()}

    def averaged(part: Dict) -> List[torch.Tensor]:
        """The tensors of `part` that the world averages, in one order."""
        return [part["loss"], *part["grads"], *_leaves(part["scalar_logs"]),
                *part["stats"].values()]

    def update(state: TrainState, part: Dict) -> Tuple[TrainState, Dict]:
        """The rest of the step, from a (world-averaged) part: the finite
        check, the clip and AdamW, the statistics written back."""
        finite = bool(torch.isfinite(part["loss"]))
        if finite:
            for p, g in zip(trainable, part["grads"]):
                p.grad = g
            grad_norm = optimizer.clip_grads_()
            optimizer.scheduled_step()
            with torch.no_grad():
                for n, v in part["stats"].items():
                    model.get_buffer(n).copy_(v)
            state.step += 1
        else:
            grad_norm = optimizer.grad_norm(part["grads"])
        metrics = {
            "loss": part["loss"],
            "grad_norm": grad_norm,
            "skipped": torch.tensor(0.0 if finite else 1.0),
            "scalar_logs": part["scalar_logs"],
            "joint_cam_pred": part["joint_cam_pred"],
        }
        return state, metrics

    def replicated(part: Dict) -> List[torch.Tensor]:
        """The tensors of `part` that every model peer holds whole."""
        grads = [g for g, s in zip(part["grads"], optimizer.sharded) if not s]
        return [part["loss"], *grads, *_leaves(part["scalar_logs"]), *part["stats"].values()]

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             latent_generator: Optional[torch.Generator] = None):
        part = local(batch, generator, latent_generator)
        if mesh is not None:
            all_mean_(replicated(part), mesh.model_group)
        all_mean_(averaged(part), group)
        return update(state, part)

    # the pieces, for a caller that averages the parts itself (a one-process
    # emulation of a world)
    step.local, step.averaged, step.update = local, averaged, update
    return step


def _detach(tree):
    """A copy of a tree of tensors, off the graph."""
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach().clone()


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


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
