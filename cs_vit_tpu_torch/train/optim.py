"""Optimizer and learning-rate schedules (port of ``cs_vit_tpu/train/optim.py``).

* lr scaled by sqrt(world * batch / 44)
* AdamW, betas 0.9/0.999, eps 1e-8, weight decay 0.01, over the parameters
  the phase trains and no others (the frozen ones get no update and no decay,
  as optax's ``set_to_zero`` gives them)
* a clip of the trainable grads' global norm at 5.0 with optax's select
  (``g_norm < max_norm ? g : g / g_norm * max_norm``), which, unlike
  ``torch.nn.utils.clip_grad_norm_``, adds no 1e-6 to the norm; the pre-clip
  norm is what the train step logs
* linear warm-up -> cosine anneal -> constant, read at the count of updates
  taken so far, so with warm-up the first update has lr 0, as in optax
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import torch

from ..models.poser import Poser, phase_trainable_params

Schedule = Callable[[int], float]


def scaled_lr(base_lr: float, world_size: int, batch_size: int) -> float:
    """sqrt((world * per-host batch) / 44) * base_lr."""
    return math.sqrt(world_size * batch_size / 44.0) * base_lr


def warmup_cosine_schedule(
    max_lr: float, min_lr: float, warmup_epochs: int, annealing_epochs: int,
    steps_per_epoch: int,
) -> Schedule:
    """Linear warm-up -> cosine anneal to min_lr -> constant min_lr."""
    if warmup_epochs < 0 or annealing_epochs < 0:
        raise ValueError("epochs must be >= 0")
    if not (max_lr > min_lr >= 0.0 and steps_per_epoch > 0):
        raise ValueError("need max_lr > min_lr >= 0 and steps_per_epoch > 0")
    warmup_steps = warmup_epochs * steps_per_epoch
    annealing_steps = annealing_epochs * steps_per_epoch
    scaled_min = min_lr / max_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            factor = step / warmup_steps
        elif step < warmup_steps + annealing_steps:
            progress = (step - warmup_steps) / max(annealing_steps, 1)
            factor = scaled_min + (1 - scaled_min) * 0.5 * (1 + math.cos(math.pi * progress))
        else:
            factor = scaled_min
        return max_lr * factor

    return schedule


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr


class PhaseAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` over one phase's trainable parameters, with the
    JAX optimizer's schedule and grad clip (:meth:`clip_grads_`,
    :meth:`scheduled_step`).

    Under tensor parallelism (``parallel.tp.shard_optimizer``) ``sharded``
    marks the parameters that hold one shard of a tensor split over
    ``model_group``; :meth:`grad_norm` then sums their squares over the group
    and counts every replicated tensor once."""

    sharded: Optional[List[bool]] = None
    model_group = None

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: Union[Schedule, float],
                 max_grad_norm: float = 5.0, weight_decay: float = 0.01):
        self.schedule = learning_rate if callable(learning_rate) else constant_schedule(learning_rate)
        self.max_grad_norm = max_grad_norm
        super().__init__(list(params), lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)

    def params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def updates_taken(self) -> int:
        """The optimizer's own count of updates (0 before the first)."""
        for p in self.params():
            if "step" in self.state.get(p, {}):
                return int(self.state[p]["step"])
        return 0

    @torch.no_grad()
    def grad_norm(self, grads) -> torch.Tensor:
        """The global norm (f32) of `grads`, one per parameter in
        :meth:`params` order (None counts as zeros); under tensor parallelism
        the norm of the whole tensors, the same on every rank."""
        if self.sharded is None:
            return global_norm(g for g in grads if g is not None)
        replicated = [g for g, s in zip(grads, self.sharded) if g is not None and not s]
        shards = [g for g, s in zip(grads, self.sharded) if g is not None and s]
        sq = sum_of_squares(shards)
        torch.distributed.all_reduce(sq, group=self.model_group)
        return torch.sqrt(sum_of_squares(replicated).to(sq.device) + sq)

    @torch.no_grad()
    def clip_grads_(self) -> torch.Tensor:
        """Clip the parameters' grads in place by their global norm, optax's
        way; returns the pre-clip norm (f32). A parameter without a grad counts
        as zeros."""
        norm = self.grad_norm([p.grad for p in self.params()])
        if not bool(norm < self.max_grad_norm):
            for g in (p.grad for p in self.params() if p.grad is not None):
                g.copy_(g / norm.to(g.dtype) * self.max_grad_norm)
        return norm

    def scheduled_step(self) -> None:
        """One AdamW update at lr = schedule(updates taken so far)."""
        lr = float(self.schedule(self.updates_taken()))
        for group in self.param_groups:
            group["lr"] = lr
        self.step()


def sum_of_squares(tensors) -> torch.Tensor:
    """The sum of the squares of every element, in f32."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return sum(torch.sum(t.float() * t.float()) for t in tensors)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum_of_squares(tensors))


def build_optimizer(
    model: Poser, phase: str, learning_rate: Union[Schedule, float],
    max_grad_norm: float = 5.0, weight_decay: float = 0.01,
) -> PhaseAdamW:
    """AdamW over the parameters `phase` trains (``phase_trainable_params``)."""
    params = [p for _, p in phase_trainable_params(model, phase)]
    return PhaseAdamW(params, learning_rate, max_grad_norm, weight_decay)
