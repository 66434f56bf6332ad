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

On a card the norm, the clip and AdamW are one launch each over every
trained leaf (``ops.multi_tensor``): the clip's select runs on the card, so
the update waits for nothing. Every leaf of a card takes them: a grad in a
layout the kernels do not read (not dense, for the norm and the clip; neither
contiguous nor stored transposed, for AdamW) goes to them as a contiguous
copy, and a leaf they do not take at all (not f32, or on another device)
raises. On the CPU every leaf takes the per-leaf code
(``torch.optim.AdamW``'s own step, the clip's host branch). Under a profiler
the two paths are the ``csvit.optim.multi_tensor`` and
``csvit.optim.per_leaf`` spans, and the optimizer counts the leaves each path
updated (``leaves_multi_tensor``, ``leaves_per_leaf``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import torch

from ..models.poser import Poser, phase_trainable_params
from ..ops import multi_tensor as mt
from ..utils.profiling import annotate

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
        self.leaves_multi_tensor = 0  # AdamW updates of a leaf by the kernels
        self.leaves_per_leaf = 0      # and by the per-leaf code
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

    def _card(self) -> Optional[torch.device]:
        """The card the kernels run on: the first leaf's (None on the CPU)."""
        device = self.param_groups[0]["params"][0].device
        return device if device.type == "cuda" else None

    @torch.no_grad()
    def grad_norm(self, grads) -> torch.Tensor:
        """The global norm (f32) of `grads`, one per parameter in
        :meth:`params` order (None counts as zeros); under tensor parallelism
        the norm of the whole tensors, the same on every rank. On a card one
        launch of the kernels, on the CPU per leaf."""
        card = self._card()
        grads = [g if g is None or card is None or mt.dense(g) else g.contiguous()
                 for g in grads]
        sharded = self.sharded or [False] * len(grads)
        replicated = [g for g, s in zip(grads, sharded) if g is not None and not s]
        shards = [g for g, s in zip(grads, sharded) if g is not None and s]
        if card is not None:
            with annotate("csvit.optim.multi_tensor"):
                sq = mt.squares(replicated, shards)
            if self.sharded is None:
                return sq[2]
            rep, sq = sq[0], sq[1]
        else:
            with annotate("csvit.optim.per_leaf"):
                if self.sharded is None:
                    return global_norm(replicated)
                rep, sq = sum_of_squares(replicated), sum_of_squares(shards)
        torch.distributed.all_reduce(sq, group=self.model_group)
        return torch.sqrt(rep.to(sq.device) + sq)

    @torch.no_grad()
    def clip_grads_(self) -> torch.Tensor:
        """Clip the parameters' grads in place by their global norm, optax's
        way; returns the pre-clip norm (f32). A parameter without a grad counts
        as zeros. On a card the select runs there; on the CPU the branch is
        the host's (the ``csvit.sync.clip`` span)."""
        card = self._card()
        params = [p for p in self.params() if p.grad is not None]
        if card is not None:
            for p in params:
                if not mt.dense(p.grad):
                    p.grad = p.grad.contiguous()  # a layout the kernels do not read
        norm = self.grad_norm([p.grad for p in self.params()])
        grads = [p.grad for p in params]
        if card is not None:
            with annotate("csvit.optim.multi_tensor"):
                mt.clip_(grads, norm, self.max_grad_norm)
            return norm
        with annotate("csvit.optim.per_leaf"):
            with annotate("csvit.sync.clip"):
                below = bool(norm < self.max_grad_norm)
            if not below:
                for g in grads:
                    g.copy_(g / norm.to(g.dtype) * self.max_grad_norm)
        return norm

    def scheduled_step(self) -> None:
        """One AdamW update at lr = schedule(updates taken so far)."""
        lr = float(self.schedule(self.updates_taken()))
        for group in self.param_groups:
            group["lr"] = lr
        self.step()

    @torch.no_grad()
    def step(self) -> None:
        """One AdamW update of every parameter with a grad: on a card by the
        kernels, one launch a group and update count; on the CPU by
        ``torch.optim.AdamW``'s own step."""
        n = sum(p.grad is not None for p in self.params())
        if self._card() is None:
            with annotate("csvit.optim.per_leaf"):
                super().step()
            self.leaves_per_leaf += n
            return
        with annotate("csvit.optim.multi_tensor"):
            for group in self.param_groups:
                self._multi_tensor_step(group)
        self.leaves_multi_tensor += n

    def _multi_tensor_step(self, group: dict) -> None:
        """AdamW by the kernels over `group`'s parameters with a grad, their
        state made as ``torch.optim.AdamW`` makes it (a CPU step count, zero
        moments); one launch for each update count among them."""
        params = [p for p in group["params"] if p.grad is not None]
        for p in params:
            if not self.state[p]:
                self.state[p] = {
                    "step": torch.tensor(0.0),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
        steps = [self.state[p]["step"] for p in params]
        if not steps:
            return
        torch._foreach_add_(steps, 1)
        by_count = {}
        for p, t in zip(params, torch.stack(steps).tolist()):
            g, state = p.grad, self.state[p]
            if not (g.is_contiguous() or mt.transposed(g)):
                g = g.contiguous()  # a layout AdamW's kernel does not read
            by_count.setdefault(t, []).append((p, g, state["exp_avg"], state["exp_avg_sq"]))
        beta1, beta2 = group["betas"]
        for t, table in by_count.items():
            mt.adamw_(*map(list, zip(*table)), lr=group["lr"], beta1=beta1, beta2=beta2,
                      eps=group["eps"], weight_decay=group["weight_decay"], step=t)


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
