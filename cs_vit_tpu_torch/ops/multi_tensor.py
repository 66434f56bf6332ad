"""The train step's update over every trained leaf at once: CUDA kernels for
Hopper and their plain versions.

Replaces no TPU kernel: JAX's step runs optax's clip and AdamW inside its
jitted graph. The port's eager step launched them leaf by leaf; here each of
its three passes is one launch over a table of leaves
(``csrc/multi_tensor_adamw.cu``, whose header says what bounds them):

* :func:`squares` - the sums of squares of the replicated and of the
  sharded grads, and the norm of them all, in a fixed order (the same bits
  on every run)
* :func:`clip_` - optax's select ``norm < max ? g : g / norm * max`` in
  place, the norm read on the card
* :func:`adamw_` - ``torch.optim.AdamW``'s update, in its order of
  operations

Each wrapper launches its kernels for CUDA tensors and counts the call in
its ``launches`` attribute; for CPU tensors it runs the plain PyTorch version
beside it (``*_reference``), which repeats the kernels' arithmetic. The
kernels take f32 tensors on one card: parameters and moments contiguous
(:func:`takes`); the sum and the clip a grad in any dense layout, as they
take its elements in any order (:func:`takes_grad`); AdamW a grad
contiguous, or stored transposed (:func:`transposed`: the weight grad of a
product with the weight's transpose, as the block kernels' backward gives
it). A CUDA table with any other tensor raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import _build
from .fused_block import _check_launch, _is_cpu, _require, _stream

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("multi_tensor_adamw")
        lib.mt_squares_blocks.argtypes = ()
        lib.mt_squares.argtypes = (_I, _P, _P, _I, _P, _P, _P)
        lib.mt_clip.argtypes = (_I, _P, _P, _P, _F, _P)
        lib.mt_adamw.argtypes = (_I, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _F, _P)
        for fn in (lib.mt_squares_blocks, lib.mt_squares, lib.mt_clip, lib.mt_adamw):
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def takes(t: torch.Tensor, device: Optional[torch.device]) -> bool:
    """Whether the kernels take `t` on `device` (a CUDA device, or None for
    none) as a parameter or moment: a contiguous f32 tensor there."""
    return t.device == device and t.dtype == torch.float32 and t.is_contiguous()


def dense(t: torch.Tensor) -> bool:
    """Whether `t`'s elements fill its span of memory once each, in some
    order: contiguous up to an order of its dimensions."""
    if t.is_contiguous() or transposed(t):
        return True
    span = 1
    for stride, size in sorted((st, sz) for sz, st in zip(t.shape, t.stride()) if sz != 1):
        if stride != span:
            return False
        span *= size
    return True


def takes_grad(g: torch.Tensor, device: Optional[torch.device]) -> bool:
    """Whether the kernels take `g` on `device` as a grad: f32 there and
    :func:`dense`."""
    return g.device == device and g.dtype == torch.float32 and dense(g)


def transposed(g: torch.Tensor) -> bool:
    """Whether `g` is a 2-D tensor stored transposed (its transpose
    contiguous), which AdamW's kernel reads by tiles."""
    return g.dim() == 2 and g.stride() == (1, g.shape[0]) and not g.is_contiguous()


def _on_cpu(*columns: Sequence[torch.Tensor]) -> bool:
    """True for a table on the CPU; False for one that starts on a card
    (:func:`_table` then checks every tensor); raises for one that starts
    on the CPU and reaches a card."""
    return (columns[0][0].device.type == "cpu"
            and _is_cpu(*[t for column in columns for t in column]))


def _table(name: str, *columns: Sequence[torch.Tensor], grads: Optional[int] = None):
    """The device, the leaf count, a ctypes array of pointers a column and
    one of element counts; raises unless every tensor is one the kernels
    take on one card (column `grads` a grad, :func:`takes_grad`; the others
    :func:`takes`) and a leaf's tensors are of one shape."""
    n = len(columns[0])
    _require(all(len(c) == n for c in columns), f"{name}: columns of unequal length")
    device = columns[0][0].device if n else None
    for k, column in enumerate(columns):
        check = takes_grad if k == grads else takes
        for t in column:
            if not check(t, device):
                raise ValueError(f"{name} takes f32 CUDA tensors on one device, contiguous "
                                 "(a grad: dense)")
    for column in columns[1:]:
        for a, b in zip(columns[0], column):
            if a.shape != b.shape:
                raise ValueError(f"{name}: a leaf's tensors must share one shape")
    ptrs = [(ctypes.c_void_p * n)(*[t.data_ptr() for t in c]) for c in columns]
    sizes = (ctypes.c_longlong * n)(*[t.numel() for t in columns[0]])
    return device, n, ptrs, sizes


def reset_launch_counts() -> None:
    for fn in (squares, clip_, adamw_):
        fn.launches = 0


def launch_counts() -> dict:
    """Calls on CUDA tensors since the last reset, by wrapper (``squares``
    launches two kernels, the others one)."""
    return {fn.__name__: fn.launches for fn in (squares, clip_, adamw_)}


# ---------------------------------------------------------------------------
# squares: the global norm's sums


def squares_reference(replicated: List[torch.Tensor], sharded: List[torch.Tensor]
                      ) -> torch.Tensor:
    """Plain version: f32 ``[sum g^2 over replicated, over sharded, sqrt of
    both]``, the sums in f64 as the kernel takes them."""
    device = next((t.device for t in (*replicated, *sharded)), None)
    sums = [torch.zeros((), dtype=torch.float64, device=device) if not ts else
            torch.stack([t.double().square().sum() for t in ts]).sum()
            for ts in (replicated, sharded)]
    return torch.stack([*sums, (sums[0] + sums[1]).sqrt()]).float()


def squares(replicated: List[torch.Tensor], sharded: List[torch.Tensor]) -> torch.Tensor:
    """f32 ``[sum g^2 over replicated, over sharded, sqrt of both]`` on the
    grads' card: two launches (per-block partials, then one block adding
    them in a fixed order)."""
    tensors = [*replicated, *sharded]
    if not tensors or _on_cpu(tensors):
        return squares_reference(replicated, sharded)
    device, n, (ptrs,), sizes = _table("squares", tensors, grads=0)
    lib = _lib()
    partials = torch.empty(2 * lib.mt_squares_blocks(), dtype=torch.float64, device=device)
    out = torch.empty(3, dtype=torch.float32, device=device)
    rc = lib.mt_squares(n, ptrs, sizes, len(replicated), partials.data_ptr(), out.data_ptr(),
                        _stream(out))
    _check_launch("squares", rc)
    squares.launches += 1
    return out


# ---------------------------------------------------------------------------
# clip_: optax's select


def clip_reference_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """Plain version: each g becomes ``norm < max_norm ? g : g / norm *
    max_norm``, in place."""
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def clip_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """Clip `grads` in place by `norm` (one f32 on their card) with optax's
    select: one launch, no host branch."""
    if not grads or _on_cpu(grads, [norm]):
        return clip_reference_(grads, norm, max_norm)
    device, n, (ptrs,), sizes = _table("clip_", grads, grads=0)
    _require(takes(norm, device) and norm.numel() == 1,
             "clip_ takes the norm as one f32 on the grads' device")
    rc = _lib().mt_clip(n, ptrs, sizes, norm.data_ptr(), max_norm, _stream(norm))
    _check_launch("clip_", rc)
    clip_.launches += 1


# ---------------------------------------------------------------------------
# adamw_: torch.optim.AdamW's update


def _adamw_scalars(lr, beta1, beta2, eps, weight_decay, step):
    """The kernel's scalars, from Python floats as torch.optim.AdamW takes
    them: 1 - lr wd, 1 - b1, b2, 1 - b2, sqrt(1 - b2^t), eps, -lr / (1 - b1^t)."""
    return (1 - lr * weight_decay, 1 - beta1, beta2, 1 - beta2, (1 - beta2 ** step) ** 0.5,
            eps, -(lr / (1 - beta1 ** step)))


def adamw_reference_(params, grads, exp_avgs, exp_avg_sqs, *, lr: float, beta1: float,
                     beta2: float, eps: float, weight_decay: float, step: int) -> None:
    """Plain version: one AdamW update at update count `step` (t, counting
    this one), in place, in the kernel's order of operations."""
    decay, w1, b2, omb2, bc2_sqrt, eps, neg_step = _adamw_scalars(lr, beta1, beta2, eps,
                                                                  weight_decay, step)
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        p.mul_(decay)
        m.lerp_(g, w1)
        v.mul_(b2).addcmul_(g, g, value=omb2)
        p.addcdiv_(m, (v.sqrt() / bc2_sqrt).add_(eps), value=neg_step)


def adamw_(params, grads, exp_avgs, exp_avg_sqs, *, lr: float, beta1: float, beta2: float,
           eps: float, weight_decay: float, step: int) -> None:
    """One AdamW update of `params` (each with its grad and moments) at
    update count `step` (t, counting this one), in place: one launch. A
    grad is contiguous or :func:`transposed`."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay, step=step)
    if not params or _on_cpu(params, grads, exp_avgs, exp_avg_sqs):
        return adamw_reference_(params, grads, exp_avgs, exp_avg_sqs, **kw)
    _, n, ptrs, sizes = _table("adamw_", params, grads, exp_avgs, exp_avg_sqs, grads=1)
    rows = [0 if g.is_contiguous() else g.shape[0] if transposed(g) else -1 for g in grads]
    _require(-1 not in rows, "adamw_ takes a grad contiguous or stored transposed")
    rc = _lib().mt_adamw(n, *ptrs, sizes, (ctypes.c_int * n)(*rows), *_adamw_scalars(**kw),
                         _stream(params[0]))
    _check_launch("adamw_", rc)
    adamw_.launches += 1


reset_launch_counts()
