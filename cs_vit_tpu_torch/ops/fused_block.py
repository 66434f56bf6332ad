"""SwinV2 block forward: CUDA kernels for Hopper and their plain versions.

Port of the TPU kernel ``cs_vit_tpu/ops/fused_block.py:_pallas_forward``,
which computes a whole SwinV2 block in one Pallas call. Here the block is
seven launches of three hand-written kernels (``csrc/fused_block.cu``, whose
header explains the split and what bounds each kernel):

* :func:`gemm_bias_act` - ``act(A @ W + bias)`` with f32 accumulation
* :func:`window_attention` - cosine window attention over the ``[B,H,W,3C]``
  qkv tensor, the cyclic shift and the window partition done by index
* :func:`ln_residual` - ``res + dp * LN(z)`` with f32 statistics

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it runs the plain PyTorch version
beside it (``*_reference``), which repeats the kernel's arithmetic. There is
no fallback: a CUDA tensor the kernel does not take raises.

:func:`block_reference` mirrors ``_block_reference`` of the JAX package (the
whole block on pre-rolled windows), and :func:`fused_swin_block` keeps the
JAX entry point's signature and layout: NHWC ``[B,H,W,C]`` activations,
``[in, out]`` weights, the shift passed as ``shift=``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ATTN_HEAD_DIM = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gemm_bias_act": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ln_residual": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P),
    "swin_window_attn_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
}
_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("fused_block")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _is_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA, got {sorted(devices)}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def reset_launch_counts() -> None:
    for fn in (gemm_bias_act, ln_residual, window_attention, fused_swin_block):
        fn.launches = 0


def launch_counts() -> dict:
    return {
        fn.__name__: fn.launches
        for fn in (gemm_bias_act, ln_residual, window_attention, fused_swin_block)
    }


# ---------------------------------------------------------------------------
# gemm_bias_act
# ---------------------------------------------------------------------------


def gemm_bias_act_reference(
    a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    act: str = "none", out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version: f32 product of the (exact) upcast operands, f32 bias,
    optional exact-erf GELU, one rounding to `out_dtype`."""
    y = a.float() @ w.float() + bias.float()
    if act == "gelu":
        y = F.gelu(y)
    return y.to(out_dtype or a.dtype)


def gemm_bias_act(
    a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    act: str = "none", out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``act(a @ w + bias)``: a [M,K], w [K,N], bias [N], all one dtype
    (bf16 or f32); f32 accumulation; output in `out_dtype` (the input dtype
    or f32). bf16 needs K and N to be multiples of 8."""
    _require(act in ("none", "gelu"), f"act must be 'none' or 'gelu', got {act!r}")
    out_dtype = out_dtype or a.dtype
    if _is_cpu(a, w, bias):
        return gemm_bias_act_reference(a, w, bias, act, out_dtype)
    M, K = a.shape
    N = w.shape[1]
    dt = a.dtype
    _require(dt in _DT_CODE, f"gemm_bias_act takes bf16 or f32, got {dt}")
    _require(w.dtype == dt and bias.dtype == dt, "a, w and bias must share one dtype")
    _require(w.shape == (K, N) and bias.shape == (N,), "shapes must be a[M,K], w[K,N], bias[N]")
    _require(out_dtype in (dt, torch.float32), "out_dtype must be the input dtype or f32")
    _require(a.is_contiguous() and w.is_contiguous() and bias.is_contiguous(),
             "gemm_bias_act needs contiguous operands")
    if dt == torch.bfloat16:
        _require(K % 8 == 0 and N % 8 == 0, "bf16 gemm_bias_act needs K, N multiples of 8")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    rc = _lib().gemm_bias_act(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), M, N, K,
        _DT_CODE[dt], int(out_dtype == torch.float32), int(act == "gelu"), _stream(a),
    )
    _check_launch("gemm_bias_act", rc)
    gemm_bias_act.launches += 1
    return out


# ---------------------------------------------------------------------------
# ln_residual
# ---------------------------------------------------------------------------


def _layer_norm_f32(z: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """f32 LayerNorm with the kernels' statistics: E[z^2]-E[z]^2 clamped at 0."""
    zf = z.float()
    mean = zf.mean(-1, keepdim=True)
    var = torch.clamp((zf * zf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (zf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def ln_residual_reference(
    z: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    dp: Optional[torch.Tensor], dp_col: int, eps: float, out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``res + dp[b, dp_col] * LN(z)``, LN statistics in f32 as
    E[z^2]-E[z]^2 clamped at 0; dp None means 1. Returns (f32 result,
    `out_dtype` copy)."""
    ln = _layer_norm_f32(z, gamma, beta, eps)
    if dp is not None:
        ln = dp[:, dp_col].float().repeat_interleave(z.shape[0] // dp.shape[0])[:, None] * ln
    y = res.float() + ln
    return y, y.to(out_dtype)


def ln_residual(
    z: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    dp: Optional[torch.Tensor], dp_col: int, eps: float, out_dtype: torch.dtype,
    keep_f32: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``y = res + dp[b, dp_col] * (LN(z) * gamma + beta)`` row by row.

    z [M,C] f32 (the pre-norm GEMM output), res [M,C] in `out_dtype` or f32,
    gamma/beta [C] in `out_dtype`, dp [B,2] f32 per-image keep-scales with
    M/B rows per image, or None for scales of 1. Returns (y in `out_dtype`,
    y in f32 if `keep_f32`).
    """
    tensors = (z, res, gamma, beta) + (() if dp is None else (dp,))
    if _is_cpu(*tensors):
        y32, ydt = ln_residual_reference(z, res, gamma, beta, dp, dp_col, eps, out_dtype)
        return ydt, (y32 if keep_f32 else None)
    M, C = z.shape
    _require(out_dtype in _DT_CODE, f"ln_residual takes bf16 or f32, got {out_dtype}")
    _require(z.dtype == torch.float32, "z must be f32")
    _require(res.dtype in (out_dtype, torch.float32), "res must be f32 or the output dtype")
    _require(gamma.dtype == out_dtype and beta.dtype == out_dtype,
             "gamma and beta must be in the output dtype")
    _require(res.shape == (M, C) and gamma.shape == (C,) and beta.shape == (C,),
             "shapes must be z[M,C], res[M,C], gamma[C], beta[C]")
    if dp is not None:
        _require(dp.dtype == torch.float32 and dp.dim() == 2 and dp.shape[1] == 2
                 and M % dp.shape[0] == 0, "dp must be f32 [B,2] with M divisible by B")
    _require(all(t.is_contiguous() for t in tensors), "ln_residual needs contiguous operands")
    out_dt = torch.empty((M, C), dtype=out_dtype, device=z.device)
    out_f32 = torch.empty((M, C), dtype=torch.float32, device=z.device) if keep_f32 else None
    rc = _lib().ln_residual(
        z.data_ptr(), res.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if dp is None else dp.data_ptr(), dp_col, M if dp is None else M // dp.shape[0],
        None if out_f32 is None else out_f32.data_ptr(),
        out_dt.data_ptr(), M, C, float(eps), _DT_CODE[out_dtype],
        int(res.dtype == torch.float32), _stream(z),
    )
    _check_launch("ln_residual", rc)
    ln_residual.launches += 1
    return out_dt, out_f32


# ---------------------------------------------------------------------------
# window_attention
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*nW, ws*ws, C], windows in row-major grid order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(win: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = win.shape[-1]
    x = win.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def _cosine_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_bias: torch.Tensor,
    logit_scale: torch.Tensor, mask: Optional[torch.Tensor], dt: torch.dtype,
) -> torch.Tensor:
    """_block_reference's attention on [B_, heads, L, hd] windows; q/k f32,
    v in dt; mask [nW, L, L] over each image's window grid or None."""
    heads, L = q.shape[1], q.shape[2]
    qn = (q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24)).to(dt)
    kn = (k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-24)).to(dt)
    s = qn.float() @ kn.float().transpose(-1, -2)
    s = s * logit_scale.float().reshape(1, heads, 1, 1) + rel_bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(-1, nW, heads, L, L) + mask.float()[None, :, None]).reshape(-1, heads, L, L)
    p = torch.softmax(s, dim=-1)
    return (p.to(dt).float() @ v.float()).to(dt)


def window_attention_reference(
    qkv: torch.Tensor, rel_bias: torch.Tensor, logit_scale: torch.Tensor,
    mask: Optional[torch.Tensor], *, window_size: int, num_heads: int, shift: int = 0,
) -> torch.Tensor:
    """Plain version: roll by -shift, partition, cosine attention, reverse,
    roll back. qkv [B,H,W,3C] -> o [B,H,W,C] in qkv's dtype."""
    B, H, W, C3 = qkv.shape
    C, ws, dt = C3 // 3, window_size, qkv.dtype
    hd = C // num_heads
    x = torch.roll(qkv, shifts=(-shift, -shift), dims=(1, 2)) if shift else qkv
    win = window_partition(x, ws)                                  # [B_, L, 3C]
    L = ws * ws

    def heads_of(t):
        return t.reshape(-1, L, num_heads, hd).transpose(1, 2)

    q = heads_of(win[..., :C]).float()
    k = heads_of(win[..., C:2 * C]).float()
    v = heads_of(win[..., 2 * C:])
    o = _cosine_attention(q, k, v, rel_bias, logit_scale, mask, dt)
    o = window_reverse(o.transpose(1, 2).reshape(-1, L, C), ws, B, H, W)
    return torch.roll(o, shifts=(shift, shift), dims=(1, 2)) if shift else o


def window_attention(
    qkv: torch.Tensor, rel_bias: torch.Tensor, logit_scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None, *, window_size: int, num_heads: int, shift: int = 0,
) -> torch.Tensor:
    """SwinV2 cosine window attention on un-rolled tokens.

    qkv [B,H,W,3C] (q | k | v, heads contiguous within each), rel_bias
    [heads,L,L] (16*sigmoid CPB), logit_scale [heads] (already
    exp(clamp(., ln 100)), f32), mask [nW,L,L] additive or None; rel_bias
    and mask in qkv's dtype. Returns o [B,H,W,C] at the tokens' original
    positions. The kernel takes head_dim 32 and L = ws*ws in {16, 64, 256}.
    """
    tensors = (qkv, rel_bias, logit_scale) + (() if mask is None else (mask,))
    if _is_cpu(*tensors):
        return window_attention_reference(
            qkv, rel_bias, logit_scale, mask,
            window_size=window_size, num_heads=num_heads, shift=shift,
        )
    B, H, W, C3 = qkv.shape
    C, ws, dt = C3 // 3, window_size, qkv.dtype
    L = ws * ws
    _require(dt in _DT_CODE, f"window_attention takes bf16 or f32, got {dt}")
    _require(C3 == 3 * C and C == num_heads * _ATTN_HEAD_DIM,
             f"window_attention kernel needs head_dim {_ATTN_HEAD_DIM}")
    _require(H % ws == 0 and W % ws == 0, "H and W must be multiples of the window")
    _require(L in (16, 64, 256), "window_attention kernel needs ws in {4, 8, 16}")
    _require(rel_bias.shape == (num_heads, L, L) and rel_bias.dtype == dt,
             "rel_bias must be [heads, L, L] in qkv's dtype")
    _require(logit_scale.numel() == num_heads and logit_scale.dtype == torch.float32,
             "logit_scale must be f32 with one value per head")
    nW = (H // ws) * (W // ws)
    if mask is not None:
        _require(mask.shape == (nW, L, L) and mask.dtype == dt,
                 "mask must be [nW, L, L] in qkv's dtype")
    _require(all(t.is_contiguous() for t in tensors), "window_attention needs contiguous operands")
    out = torch.empty((B, H, W, C), dtype=dt, device=qkv.device)
    rc = _lib().swin_window_attn_fwd(
        qkv.data_ptr(), rel_bias.data_ptr(), None if mask is None else mask.data_ptr(),
        logit_scale.data_ptr(), out.data_ptr(), B, H, W, C, num_heads, ws, shift,
        _DT_CODE[dt], _stream(qkv),
    )
    _check_launch("swin_window_attn_fwd", rc)
    window_attention.launches += 1
    return out


# ---------------------------------------------------------------------------
# the whole block
# ---------------------------------------------------------------------------


def block_reference(
    x, wqkv, bqkv, wproj, bproj, ln1_scale, ln1_bias, w1, b1, w2, b2,
    ln2_scale, ln2_bias, rel_bias, logit_scale, dp, mask=None,
    *, window_size: int, num_heads: int, eps: float,
) -> torch.Tensor:
    """PyTorch mirror of ``_block_reference``: one block on x [B,H,W,C]
    already in shifted-window coordinates, dp [B,2] f32 keep-scales."""
    B, H, W, C = x.shape
    ws, heads = window_size, num_heads
    nW, L, hd, dt = (H // ws) * (W // ws), ws * ws, C // num_heads, x.dtype
    f32 = torch.float32
    win = window_partition(x, ws)                                        # [B_, L, C]
    qkv = (win.float() @ wqkv.float() + bqkv.float()).to(dt)

    def heads_of(t):
        return t.reshape(-1, L, heads, hd).transpose(1, 2)

    q = heads_of(qkv[..., :C]).float()
    k = heads_of(qkv[..., C:2 * C]).float()
    v = heads_of(qkv[..., 2 * C:])
    o = _cosine_attention(q, k, v, rel_bias, logit_scale, mask, dt)
    o = o.transpose(1, 2).reshape(-1, L, C)
    attn_out = o.float() @ wproj.float() + bproj.float()

    dp0 = dp[:, 0].to(f32).repeat_interleave(nW).reshape(-1, 1, 1)
    dp1 = dp[:, 1].to(f32).repeat_interleave(nW).reshape(-1, 1, 1)
    h1 = win.float() + dp0 * _layer_norm_f32(attn_out, ln1_scale, ln1_bias, eps)
    m = F.gelu(h1.to(dt).float() @ w1.float() + b1.float())
    m = m.to(dt).float() @ w2.float() + b2.float()
    y = (h1 + dp1 * _layer_norm_f32(m, ln2_scale, ln2_bias, eps)).to(dt)
    return window_reverse(y, ws, B, H, W)


def fused_swin_block(
    x: torch.Tensor,          # [B, H, W, C] (un-rolled; pass shift= instead)
    wqkv: torch.Tensor,       # [C, 3C]   (query | key | value)
    bqkv: torch.Tensor,       # [3C]      (key slice zero: no key bias in SwinV2)
    wproj: torch.Tensor,      # [C, C]
    bproj: torch.Tensor,      # [C]
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,   # [C]
    w1: torch.Tensor, b1: torch.Tensor,                # [C, Ch], [Ch]
    w2: torch.Tensor, b2: torch.Tensor,                # [Ch, C], [C]
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,   # [C]
    rel_bias: torch.Tensor,   # [heads, L, L]  16*sigmoid(CPB)
    logit_scale: torch.Tensor,  # [heads]      exp(clamp(., ln 100))
    mask: Optional[torch.Tensor] = None,           # [nH*nW, L, L] additive shift mask
    droppath_keep: Optional[torch.Tensor] = None,  # [B, 2] residual scales
    *,
    window_size: int,
    num_heads: int,
    eps: float = 1e-5,
    shift: int = 0,
) -> torch.Tensor:
    """One SwinV2 block forward as seven kernel launches (CUDA) or the same
    seven steps in their plain versions (CPU). Every tensor is in the
    activation dtype except logit_scale and droppath_keep (f32)."""
    B, H, W, C = x.shape
    M, dt = B * H * W, x.dtype
    dp = None if droppath_keep is None else droppath_keep.float().contiguous()
    x2 = x.reshape(M, C)
    qkv = gemm_bias_act(x2, wqkv, bqkv, out_dtype=dt)
    o = window_attention(
        qkv.reshape(B, H, W, 3 * C), rel_bias, logit_scale, mask,
        window_size=window_size, num_heads=num_heads, shift=shift,
    )
    proj = gemm_bias_act(o.reshape(M, C), wproj, bproj, out_dtype=torch.float32)
    h1_dt, h1 = ln_residual(proj, x2, ln1_scale, ln1_bias, dp, 0, eps, dt, keep_f32=True)
    m = gemm_bias_act(h1_dt, w1, b1, act="gelu", out_dtype=dt)
    m2 = gemm_bias_act(m, w2, b2, out_dtype=torch.float32)
    y, _ = ln_residual(m2, h1, ln2_scale, ln2_bias, dp, 1, eps, dt)
    if x.device.type == "cuda":
        fused_swin_block.launches += 1
    return y.reshape(B, H, W, C)


reset_launch_counts()
