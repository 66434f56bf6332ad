"""Column-random update (port of ``cs_vit_tpu/train/sparse_update.py``; ref
``cs_vit/net/optim.py:6-31``).

The reference's sparse-update experiment: before each AdamW step, the grad of
every 2-D weight is masked to a random subset of its input columns: axis 1
of a torch ``[out, in]`` weight, as in the reference. Here the port follows
the reference and the JAX package's docstring, not the JAX package's code:
that masks axis 1 of a flax kernel, which is ``[in, out]``, so it keeps a
subset of the output features instead. The JAX package derives each leaf's
permutation from a counter-keyed key; here the columns are drawn from an
explicit ``torch.Generator``, one permutation per 2-D grad in parameter
order, or handed in (:func:`mask_columns_`).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def column_draw(num_columns: int, num_to_update: int, generator: torch.Generator
                ) -> torch.Tensor:
    """The first `num_to_update` of a random permutation of the columns."""
    perm = torch.randperm(num_columns, generator=generator, device=generator.device)
    return perm[:min(num_to_update, num_columns)]


@torch.no_grad()
def mask_columns_(grad: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Zero every column of the 2-D `grad` but `chosen`, in place."""
    mask = torch.zeros(grad.shape[1], dtype=grad.dtype, device=grad.device)
    mask[chosen.to(grad.device)] = 1.0
    grad.mul_(mask[None, :])
    return grad


class ColumnRandomUpdateAdamW(torch.optim.AdamW):
    """AdamW whose 2-D weights update only `num_columns_to_update` random
    columns a step: each step first masks the grads (:func:`mask_columns_`,
    columns from `generator`), then takes AdamW's step, so a masked column
    still decays. Weight decay defaults to optax's 1e-4."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 num_columns_to_update: int, generator: Optional[torch.Generator] = None,
                 **adamw_kwargs):
        adamw_kwargs.setdefault("weight_decay", 1e-4)  # optax.adamw's default
        super().__init__(params, lr=lr, **adamw_kwargs)
        self.num_columns_to_update = num_columns_to_update
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None and p.grad.dim() == 2:
                    mask_columns_(p.grad, column_draw(p.grad.shape[1],
                                                      self.num_columns_to_update,
                                                      self.generator))
        return super().step(closure)
