"""The products of the reference, in the precision a run asks for.

``"f32"``: float32 products with TF32 off (``reference_numerics`` turns it
off and restores the flags after). ``"fp8"``: the control, the nearest
precision below the bf16 that the configurations state: each operand of a
product rounded to float8 e4m3 with one scale per tensor (its largest
magnitude onto 448), the incoming gradient of the backward to float8 e5m2
(onto 57344), and the rounded values multiplied in float32, as an fp8
training or serving path would compute them. ``"bf16"``: the operands and
the incoming gradient rounded to bf16, the program's own precision, as a
witness.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_MODE = contextvars.ContextVar("portbench_reference_precision", default="f32")
MODES = ("f32", "bf16", "fp8")


@contextlib.contextmanager
def reference_numerics(mode: str = "f32"):
    """Run the reference's products in `mode`, with TF32 off."""
    if mode not in MODES:
        raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
    token = _MODE.set(mode)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        _MODE.reset(token)


def _round(x: torch.Tensor, dtype: torch.dtype, fmax) -> torch.Tensor:
    xf = x.float()
    if fmax is None:  # a type with float32's range
        return xf.to(dtype).float()
    amax = xf.detach().abs().amax().clamp(min=1e-30)
    scale = fmax / amax
    return (xf * scale).to(dtype).float() / scale


def _fit(grad: torch.Tensor, shape) -> torch.Tensor:
    return grad if grad.shape == shape else grad.sum_to_size(shape)


# operands forward, incoming gradient backward: (type, largest magnitude)
_ROUNDING = {"fp8": ((torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0)),
             "bf16": ((torch.bfloat16, None), (torch.bfloat16, None))}


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mode):
        fwd, ctx.bwd = _ROUNDING[mode]
        qa, qb = _round(a, *fwd), _round(b, *fwd)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, *ctx.bwd)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _fit(qg @ qb.transpose(-1, -2), qa.shape)
        if ctx.needs_input_grad[1]:
            gb = _fit(qa.transpose(-1, -2) @ qg, qb.shape)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the active precision."""
    mode = _MODE.get()
    if mode == "f32":
        return a @ b
    return _RoundedMatmul.apply(a, b, mode)


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """``x @ weight.T + bias`` in the active precision."""
    y = matmul(x, weight.t())
    return y if bias is None else y + bias
