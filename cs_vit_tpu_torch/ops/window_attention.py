"""Attention-only SwinV2 cosine window attention: a CUDA kernel for Hopper and
its plain version.

Port of the TPU kernel ``cs_vit_tpu/ops/window_attention.py:fused_window_attention``,
which ``attention_impl="pallas"`` (and ``"hybrid"`` for blocks with more than
one window) runs in place of the eager attention core. For every window
instance ``b_`` and head ``h``::

    out = softmax(q^ k^T * logit_scale[h] + bias[b_ % nW, h]) v

q^ and k^ are L2-normalised in f32 as ``q * rsqrt(sum q^2 + 1e-24)``, the
softmax takes the row max, p is rounded to v's dtype before p.v, the sums
are f32 and the output is in q's dtype. The bias (the CPB bias plus the shift
mask, combined by the caller) is ``[nW or 1, H, L, L]``. There is no backward,
as in the JAX package.

:func:`fused_window_attention` launches ``csrc/window_attention.cu`` for CUDA
tensors and counts the launch in its ``launches`` attribute; for CPU tensors
it runs :func:`fused_window_attention_reference`. A CUDA call the kernel does
not take raises, and so does one under autograd with an input that requires
grad: a silent autograd through nothing would be wrong.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_block import _DT_CODE, _check_launch, _is_cpu, _require, _stream

_HEAD_DIM = 32
_P, _I = ctypes.c_void_p, ctypes.c_int
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("window_attention")
        lib.fused_window_attn.argtypes = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
        lib.fused_window_attn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def reset_launch_counts() -> None:
    fused_window_attention.launches = 0


def launch_counts() -> dict:
    return {"fused_window_attention": fused_window_attention.launches}


def fused_window_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    logit_scale: torch.Tensor,
) -> torch.Tensor:
    """Plain version (the math of ``xla_window_attention`` with the Pallas
    kernel's rounding of p to v's dtype, which is no rounding in f32)."""
    nW = bias.shape[0]
    B_, H, L, _ = q.shape
    qf, kf = q.float(), k.float()
    qn = qf * torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-24)
    kn = kf * torch.rsqrt((kf * kf).sum(-1, keepdim=True) + 1e-24)
    s = (qn @ kn.transpose(-1, -2)) * logit_scale.float().reshape(1, H, 1, 1)
    s = (s.reshape(B_ // nW, nW, H, L, L) + bias.float()[None]).reshape(B_, H, L, L)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def fused_window_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    logit_scale: torch.Tensor,
) -> torch.Tensor:
    """q, k, v [B_, H, L, hd] in one dtype (bf16 or f32), bias [nW or 1, H, L,
    L] (bf16 or f32) with B_ a multiple of nW, logit_scale [H] f32 (already
    ``exp(clamp(., ln 100))``). Returns [B_, H, L, hd] in q's dtype. The kernel
    takes hd 32 and L in {16, 64, 256}, and bf16 operands 16-byte aligned."""
    tensors = (q, k, v, bias, logit_scale)
    if _is_cpu(*tensors):
        return fused_window_attention_reference(q, k, v, bias, logit_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "fused_window_attention has no backward (as in the JAX package): call it "
            "under torch.no_grad() or on inputs that do not require grad")
    B_, H, L, hd = q.shape
    nW = bias.shape[0]
    dt = q.dtype
    _require(dt in _DT_CODE, f"fused_window_attention takes bf16 or f32, got {dt}")
    _require(k.dtype == dt and v.dtype == dt, "q, k and v must share one dtype")
    _require(k.shape == q.shape and v.shape == q.shape, "q, k and v must share one shape")
    _require(hd == _HEAD_DIM, f"fused_window_attention kernel needs head_dim {_HEAD_DIM}")
    _require(L in (16, 64, 256), "fused_window_attention kernel needs L in {16, 64, 256}")
    _require(bias.dim() == 4 and bias.shape[1:] == (H, L, L) and B_ % nW == 0,
             "bias must be [nW or 1, H, L, L] with B_ a multiple of nW")
    _require(bias.dtype in _DT_CODE, f"bias must be bf16 or f32, got {bias.dtype}")
    _require(logit_scale.numel() == H and logit_scale.dtype == torch.float32,
             "logit_scale must be f32 with one value per head")
    _require(0 < B_ <= 65535, "fused_window_attention kernel takes 1 to 65535 window instances")
    _require(all(t.is_contiguous() for t in tensors),
             "fused_window_attention needs contiguous operands")
    _require(dt != torch.bfloat16 or all(t.data_ptr() % 16 == 0 for t in tensors),
             "the bf16 fused_window_attention kernel needs 16-byte aligned operands")
    out = torch.empty_like(q)
    rc = _lib().fused_window_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), logit_scale.data_ptr(),
        out.data_ptr(), B_, H, L, nW, _DT_CODE[dt], int(bias.dtype == torch.float32), _stream(q),
    )
    _check_launch("fused_window_attn", rc)
    fused_window_attention.launches += 1
    return out


reset_launch_counts()
