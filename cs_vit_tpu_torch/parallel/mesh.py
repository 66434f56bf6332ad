"""The data-parallel world (port of ``cs_vit_tpu/parallel/mesh.py`` and of
``cs_vit_tpu/cli/common.py:maybe_init_distributed``).

The JAX package runs one program over a ``data`` mesh axis and ``pmean``s
inside it. The port runs one process per card in a ``torch.distributed``
world, started by ``torchrun`` (or any launcher that sets its environment),
and averages with one collective: :func:`all_mean_`. ``utils/dist.py`` stays
the one source of this process's rank and of the world's size.
:func:`make_mesh` lays the world out as JAX's ``(data, model)`` mesh for
tensor parallelism (``parallel/tp.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..utils.dist import process_count, process_index

# torchrun's environment; without all of it there is no world to join
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device="cuda") -> bool:
    """Join the process group that ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) and
    return whether this process is in a group. Without that environment it
    does nothing; in a group already it changes nothing.

    NCCL for a CUDA `device`, gloo for the CPU; a CUDA rank takes card
    ``LOCAL_RANK`` as its current device.
    """
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def process_local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a global batch: rank i of N reads
    ``[i*B/N, (i+1)*B/N)``."""
    per = global_batch // process_count()
    i = process_index()
    return slice(i * per, (i + 1) * per)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world's ranks as a ``(data, model)`` grid (JAX's
    ``make_mesh(n_data, n_model)``, ``cs_vit_tpu/parallel/mesh.py:22-35``):
    rank ``d * n_model + m`` is data rank d, model rank m. A model group is
    ``n_model`` consecutive ranks, which hold one copy of the model between
    them; a data group is the ranks of one model rank, one in each copy."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The :class:`Mesh` of this process in the world (``n_data`` defaults to
    world / ``n_model``). Every rank builds every group, in one order, as
    ``torch.distributed.new_group`` needs; without a process group the world
    is this one process."""
    world, rank = process_count(), process_index()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world or n_data < 1:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks (launch n_data x n_model "
                         "processes, e.g. torchrun --nproc_per_node=N)")
    data_group = model_group = None
    if dist.is_available() and dist.is_initialized():
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
            if d == rank // n_model:
                model_group = g
        for m in range(n_model):
            g = dist.new_group(list(range(m, world, n_model)))
            if m == rank % n_model:
                data_group = g
    return Mesh(n_data, n_model, rank // n_model, rank % n_model, data_group, model_group)


@torch.no_grad()
def all_mean_(tensors: List[torch.Tensor], group=None) -> None:
    """Average `tensors` across the world (or across `group`) in place, in
    one collective over their f32 concatenation (``jax.lax.pmean`` over the
    ``data`` axis).

    Without a process group it is the identity. In a group it runs the
    collective even in a world of one. The mean is the f32 sum divided by
    the group's size, so in a group of two it does not depend on the order in
    which the two values are added.
    """
    if not tensors or not (dist.is_available() and dist.is_initialized()):
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view(t.shape))
        offset += n
