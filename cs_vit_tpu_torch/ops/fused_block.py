"""SwinV2 block forward and backward: CUDA kernels for Hopper and their plain
versions.

Port of the TPU kernels ``cs_vit_tpu/ops/fused_block.py:_pallas_forward``
and ``:_pallas_backward``, which compute a whole SwinV2 block, and its VJP,
in one Pallas call each. Here the forward is seven launches of three
hand-written kernels (``csrc/fused_block.cu``) and the backward eleven
launches of four (``csrc/fused_block_bwd.cu``, plus one forward GEMM); each
source's header explains the split and what bounds each kernel:

* :func:`gemm_bias_act` - ``act(A @ W + bias)`` with f32 accumulation
* :func:`window_attention` - cosine window attention over the ``[B,H,W,3C]``
  qkv tensor, the cyclic shift and the window partition done by index
* :func:`ln_residual` - ``res + dp * LN(z)`` with f32 statistics
* :func:`gemm_dgrad` - ``round(dY) @ W^T`` with a GELU'-product or residual
  epilogue
* :func:`gemm_wgrad` - ``A^T @ round(dY)`` over all token rows, and the bias
  grad ``sum(dY)``
* :func:`ln_residual_bwd` - the LayerNorm-residual VJP and its scale/bias grads
* :func:`window_attention_bwd` - the attention VJP: dqkv, d rel_bias, d scale

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it runs the plain PyTorch version
beside it (``*_reference``), which repeats the kernel's arithmetic. There is
no fallback: a CUDA tensor the kernel does not take raises.

:func:`block_reference` and :func:`block_backward_reference` mirror
``_block_reference`` and ``_bwd_kernel`` of the JAX package (the whole block
on pre-rolled windows), and :func:`fused_swin_block` keeps the JAX entry
point's signature and layout: NHWC ``[B,H,W,C]`` activations, ``[in, out]``
weights, the shift passed as ``shift=``. When an input requires grad it runs
through :class:`FusedSwinBlock`, whose backward is the kernels above.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ATTN_HEAD_DIM = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fused_block": {
        "gemm_bias_act": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "ln_residual": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P),
        "swin_window_attn_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "fused_block_bwd": {
        "gemm_dgrad": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "gemm_wgrad": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "ln_residual_bwd": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, ctypes.c_float,
                            _I, _I, _I, _I, _P),
        "swin_window_attn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _P),
        "swin_window_attn_bwd_blocks": (_I, _I),
    },
}
_libs: dict = {}


def _lib(name: str = "fused_block") -> ctypes.CDLL:
    if name not in _libs:
        lib = _build.load(name)
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


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


def _sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of t's card: the GEMM tiles, split-K and
    LN-backward grids aim at filling them. Asked once per card: each GEMM
    launch needs it."""
    return _sm_count_of(t.device.index)


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _counted():
    return (gemm_bias_act, ln_residual, window_attention, fused_swin_block,
            gemm_dgrad, gemm_wgrad, ln_residual_bwd, window_attention_bwd, FusedSwinBlock)


def reset_launch_counts() -> None:
    for fn in _counted():
        fn.launches = 0


def launch_counts() -> dict:
    """Launches on CUDA tensors since the last reset, by wrapper;
    ``fused_swin_block`` counts block forwards and ``FusedSwinBlock`` block
    backwards."""
    return {fn.__name__: fn.launches for fn in _counted()}


def _aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# ---------------------------------------------------------------------------
# the bf16 wgmma GEMMs' tiles (gemm_bias_act, gemm_dgrad)
# ---------------------------------------------------------------------------

# output tiles (rows, columns) of the bf16 wgmma GEMMs, largest first; a
# ring of up to GEMM_STAGES stages of GEMM_DEPTH of the reduction in at most
# GEMM_RING_BYTES of shared memory (two blocks an SM)
GEMM_TILES = ((128, 128), (128, 64), (64, 64))
GEMM_DEPTH, GEMM_STAGES, GEMM_RING_BYTES = 64, 8, 110 * 1024


def _gemm_stage_bytes(kernel: str, bm: int, bn: int) -> int:
    """Shared memory of one ring stage of the bf16 `kernel` with a bm x bn
    output tile: GEMM_DEPTH of the reduction of the A rows (bf16 for
    gemm_bias_act, the f32 dY for gemm_dgrad) and of the W columns (bf16)."""
    a_bytes = {"gemm_bias_act": 2, "gemm_dgrad": 4}[kernel]
    return GEMM_DEPTH * (bm * a_bytes + bn * 2)


def _gemm_tiles(M: int, N: int, tile: Tuple[int, int]) -> int:
    """Output tiles of a bf16 gemm_bias_act or gemm_dgrad with an [M, N]
    output."""
    return -(-M // tile[0]) * -(-N // tile[1])


@functools.lru_cache(maxsize=None)
def _gemm_plan(kernel: str, M: int, N: int, R: int, sms: int) -> Tuple[int, int, int]:
    """(rows, columns, stages) of the output tile and operand ring of the
    bf16 `kernel` ("gemm_bias_act" or "gemm_dgrad") for an [M, N] output
    over a reduction of R, on a card of `sms` SMs. The tile is the largest
    whose tiles fill at least half of the SMs (a larger tile reads each
    operand row and column fewer times: at the Swin-B shapes they come
    mostly from L2), else the smallest. The ring takes as many stages as
    GEMM_RING_BYTES holds, at least two, and no more than the reduction
    has: two blocks an SM, so that one block's epilogue and loads overlap
    the other's products. (gemm_dgrad's 128-row tiles get two stages of
    40 or 48 KB; with three or more, one block an SM,
    cs_vit_tpu_torch/tools/gemm_sweep.py
    reads the step's input grads slower.) The kernels never split the
    reduction: every output element is one block's sum, and no partials
    are written."""
    bm, bn = next((t for t in GEMM_TILES if 2 * _gemm_tiles(M, N, t) >= sms), GEMM_TILES[-1])
    stages = max(2, GEMM_RING_BYTES // _gemm_stage_bytes(kernel, bm, bn))
    return bm, bn, min(stages, GEMM_STAGES, max(1, -(-R // GEMM_DEPTH)))


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
    or f32). bf16 needs K and N to be multiples of 8 and 16-byte aligned
    operands."""
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
        _require(_aligned16(a, w, bias),
                 "the bf16 gemm_bias_act kernel needs 16-byte aligned operands")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    rc = _lib().gemm_bias_act(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), M, N, K,
        _DT_CODE[dt], int(out_dtype == torch.float32), int(act == "gelu"),
        *_gemm_plan("gemm_bias_act", M, N, K, _sm_count(a)), _stream(a),
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
    positions. The kernel takes head_dim 32 and L = ws*ws in {16, 64, 256},
    and bf16 operands 16-byte aligned.
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
    _require(dt != torch.bfloat16 or _aligned16(*tensors),
             "the bf16 window_attention kernel needs 16-byte aligned operands")
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
# backward kernels
# ---------------------------------------------------------------------------


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of exact-erf GELU: Phi(x) + x * phi(x) (``_gelu_grad`` of the
    JAX kernel, with the exact erf)."""
    return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) + x * torch.exp(-0.5 * x * x) * 0.3989422804014327


def gemm_dgrad_reference(
    dy: torch.Tensor, w: torch.Tensor, aux: Optional[torch.Tensor] = None,
    epi: str = "none", out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version: dy rounded to w's dtype, f32 product with w^T, then
    ``* gelu'(aux)`` ("gelu") or ``+ aux`` ("add"), one rounding to `out_dtype`."""
    v = dy.to(w.dtype).float() @ w.float().t()
    if epi == "gelu":
        v = v * _gelu_grad(aux.float())
    elif epi == "add":
        v = v + aux.float()
    return v.to(out_dtype or w.dtype)


def gemm_dgrad(
    dy: torch.Tensor, w: torch.Tensor, aux: Optional[torch.Tensor] = None,
    epi: str = "none", out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``epi(round(dy) @ w^T)``: the input grad of a GEMM ``y = a @ w``.

    dy [M,N] f32 (rounded to w's dtype as it is read), w [K,N] in the
    forward's [in, out] layout, bf16 or f32. ``epi="gelu"``: times gelu'(aux)
    with aux [M,K] (the pre-GELU activation) in w's dtype; ``epi="add"``: plus
    aux [M,K] in w's dtype or f32. Output [M,K] in `out_dtype`, w's dtype
    or f32. bf16 needs 16-byte aligned operands.
    """
    _require(epi in ("none", "gelu", "add"), f"epi must be 'none', 'gelu' or 'add', got {epi!r}")
    _require((aux is None) == (epi == "none"), "aux is given exactly when epi is not 'none'")
    dt = w.dtype
    out_dtype = out_dtype or dt
    tensors = (dy, w) + (() if aux is None else (aux,))
    if _is_cpu(*tensors):
        return gemm_dgrad_reference(dy, w, aux, epi, out_dtype)
    M, N = dy.shape
    K = w.shape[0]
    _require(dt in _DT_CODE, f"gemm_dgrad takes bf16 or f32 weights, got {dt}")
    _require(dy.dtype == torch.float32, "dy must be f32")
    _require(w.shape == (K, N), "shapes must be dy[M,N], w[K,N]")
    _require(out_dtype in (dt, torch.float32), "out_dtype must be w's dtype or f32")
    if aux is not None:
        _require(aux.shape == (M, K), "aux must be [M,K]")
        allowed = (dt,) if epi == "gelu" else (dt, torch.float32)
        _require(aux.dtype in allowed, f"aux must be in {allowed}")
    _require(all(t.is_contiguous() for t in tensors), "gemm_dgrad needs contiguous operands")
    _require(N % 8 == 0 and K % 8 == 0, "gemm_dgrad needs K, N multiples of 8")
    _require(dt != torch.bfloat16 or _aligned16(*tensors),
             "the bf16 gemm_dgrad kernel needs 16-byte aligned operands")
    out = torch.empty((M, K), dtype=out_dtype, device=dy.device)
    rc = _lib("fused_block_bwd").gemm_dgrad(
        dy.data_ptr(), w.data_ptr(), None if aux is None else aux.data_ptr(), out.data_ptr(),
        M, N, K, _DT_CODE[dt], {"none": 0, "gelu": 1, "add": 2}[epi],
        int(aux is not None and aux.dtype == torch.float32), int(out_dtype == torch.float32),
        *_gemm_plan("gemm_dgrad", M, K, N, _sm_count(dy)), _stream(dy),
    )
    _check_launch("gemm_dgrad", rc)
    gemm_dgrad.launches += 1
    return out


def gemm_wgrad_reference(a: torch.Tensor, dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (a^T @ dy rounded to a's dtype, column sums of f32 dy)."""
    return a.float().t() @ dy.to(a.dtype).float(), dy.float().sum(0)


# bf16 gemm_wgrad (wgmma): output tiles of 128 x 128, 64 token rows a
# stage, one block per SM; a split takes at least WGRAD_MIN_ROWS rows
WGRAD_TILE, WGRAD_DEPTH, WGRAD_MIN_ROWS = 128, 64, 512


def _wgrad_tiles(K: int, N: int) -> int:
    """Output tiles of the bf16 gemm_wgrad kernel."""
    return -(-K // WGRAD_TILE) * -(-N // WGRAD_TILE)


def _wgrad_splits(M: int, K: int, N: int, sms: int, bf16: bool = True) -> Tuple[int, int]:
    """(splits, rows per split) of the token rows of a weight grad.

    bf16 (the wgmma kernel, one resident block per SM): no split where the
    output tiles fill a quarter of the `sms` SMs or more (their partials
    would cost more bytes than the idle SMs cost time); else as many splits
    as one wave of `sms` blocks holds beside the tiles, each of at least
    WGRAD_MIN_ROWS rows, a multiple of WGRAD_DEPTH rows (a split's stages
    never reach the next split's rows). f32 (SIMT, 64 x 64 tiles): a few
    blocks on each SM, at least 256 rows a split, a multiple of 32 rows.
    """
    if bf16:
        tiles = _wgrad_tiles(K, N)
        splits = 1 if 4 * tiles >= sms else max(1, min(sms // tiles, M // WGRAD_MIN_ROWS))
        quantum = WGRAD_DEPTH
    else:
        tiles = -(-K // 64) * -(-N // 64)
        splits, quantum = max(1, min(-(-4 * sms // tiles), M // 256)), 32
    rows = -(-M // splits)
    rows = -(-rows // quantum) * quantum
    return -(-M // rows), rows


def wgrad_partial_bytes(M: int, K: int, N: int, sms: int, bf16: bool = True) -> int:
    """Device-memory bytes of one gemm_wgrad call's split partials, written
    and read back (0 when the rows are not split)."""
    splits, _ = _wgrad_splits(M, K, N, sms, bf16)
    return 0 if splits == 1 else 2 * splits * (K * N + N) * 4


def gemm_wgrad(a: torch.Tensor, dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight and bias grads of a GEMM ``y = a @ w + b``: ``(a^T @
    round(dy), sum_rows dy)``, both f32, summed over all M rows.

    a [M,K] bf16 or f32, dy [M,N] f32 (rounded to a's dtype for the product,
    f32 for the bias sum). Returns (dw [K,N], db [N]).
    """
    if _is_cpu(a, dy):
        return gemm_wgrad_reference(a, dy)
    M, K = a.shape
    N = dy.shape[1]
    dt = a.dtype
    _require(dt in _DT_CODE, f"gemm_wgrad takes bf16 or f32, got {dt}")
    _require(dy.dtype == torch.float32 and dy.shape == (M, N), "dy must be f32 [M,N]")
    _require(a.is_contiguous() and dy.is_contiguous(), "gemm_wgrad needs contiguous operands")
    _require(N % 8 == 0 and K % 8 == 0, "gemm_wgrad needs K, N multiples of 8")
    _require(dt != torch.bfloat16 or _aligned16(a, dy),
             "the bf16 gemm_wgrad kernel needs 16-byte aligned operands")
    splits, rows = _wgrad_splits(M, K, N, _sm_count(a), dt == torch.bfloat16)
    out = torch.empty(K * N + N, dtype=torch.float32, device=a.device)
    part = out if splits == 1 else torch.empty((splits, K * N + N), dtype=torch.float32,
                                                device=a.device)
    rc = _lib("fused_block_bwd").gemm_wgrad(
        a.data_ptr(), dy.data_ptr(), part.data_ptr(), out.data_ptr(), M, N, K, splits, rows,
        _DT_CODE[dt], _stream(a),
    )
    _check_launch("gemm_wgrad", rc)
    gemm_wgrad.launches += 1
    return out[:K * N].view(K, N), out[K * N:]


def _layer_norm_bwd_f32(
    z: torch.Tensor, gz: torch.Tensor, gamma: torch.Tensor, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """VJP of ``LN(z) * gamma + beta`` (the kernels' statistics) given the
    f32 output grad gz [..., C]: (dz, dgamma, dbeta), f32, the parameter
    grads summed over every row."""
    zf = z.float()
    mean = zf.mean(-1, keepdim=True)
    var = torch.clamp((zf * zf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    r = torch.rsqrt(var + eps)
    zh = (zf - mean) * r
    zb = gz * gamma.float()
    dz = (zb - zb.mean(-1, keepdim=True) - zh * (zb * zh).mean(-1, keepdim=True)) * r
    rows = tuple(range(gz.dim() - 1))
    return dz, (gz * zh).sum(rows), gz.sum(rows)


def _dp_rows(dp: Optional[torch.Tensor], dp_col: int, M: int) -> torch.Tensor:
    if dp is None:
        return torch.ones((), dtype=torch.float32)
    return dp[:, dp_col].float().repeat_interleave(M // dp.shape[0])[:, None]


def ln_residual_bwd_reference(
    z: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor, dp: Optional[torch.Tensor],
    dp_col: int, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ln_residual_bwd`."""
    return _layer_norm_bwd_f32(z, g.float() * _dp_rows(dp, dp_col, z.shape[0]), gamma, eps)


def ln_residual_bwd(
    z: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor, dp: Optional[torch.Tensor],
    dp_col: int, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """VJP of :func:`ln_residual`'s ``y = res + dp[b, dp_col] * (LN(z) *
    gamma + beta)`` given g = dL/dy: (dz [M,C], dgamma [C], dbeta [C]), f32.

    z [M,C] f32 (the pre-norm input; statistics recomputed from it), g [M,C]
    in gamma's dtype or f32, gamma [C] bf16 or f32, dp [B,2] f32 or None.
    """
    tensors = (z, g, gamma) + (() if dp is None else (dp,))
    if _is_cpu(*tensors):
        return ln_residual_bwd_reference(z, g, gamma, dp, dp_col, eps)
    M, C = z.shape
    dt = gamma.dtype
    _require(dt in _DT_CODE, f"ln_residual_bwd takes bf16 or f32, got {dt}")
    _require(z.dtype == torch.float32, "z must be f32")
    _require(g.dtype in (dt, torch.float32) and g.shape == (M, C),
             "g must be [M,C] in gamma's dtype or f32")
    _require(gamma.shape == (C,), "gamma must be [C]")
    if dp is not None:
        _require(dp.dtype == torch.float32 and dp.dim() == 2 and dp.shape[1] == 2
                 and M % dp.shape[0] == 0, "dp must be f32 [B,2] with M divisible by B")
    _require(all(t.is_contiguous() for t in tensors), "ln_residual_bwd needs contiguous operands")
    blocks = max(1, min(-(-M // 8), 4 * _sm_count(z)))
    rows_per_block = -(-M // blocks)
    blocks = -(-M // rows_per_block)
    dz = torch.empty((M, C), dtype=torch.float32, device=z.device)
    part = torch.empty((blocks, 2 * C), dtype=torch.float32, device=z.device)
    out = torch.empty((2, C), dtype=torch.float32, device=z.device)
    rc = _lib("fused_block_bwd").ln_residual_bwd(
        z.data_ptr(), g.data_ptr(), gamma.data_ptr(), None if dp is None else dp.data_ptr(),
        dp_col, M if dp is None else M // dp.shape[0], dz.data_ptr(), part.data_ptr(),
        out.data_ptr(), M, C, float(eps), blocks, rows_per_block, _DT_CODE[dt],
        int(g.dtype == torch.float32), _stream(z),
    )
    _check_launch("ln_residual_bwd", rc)
    ln_residual_bwd.launches += 1
    return dz, out[0], out[1]


def _cosine_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    rel_bias: torch.Tensor, logit_scale: torch.Tensor, mask: Optional[torch.Tensor],
    dt: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """VJP of :func:`_cosine_attention` on [B_, heads, L, hd] windows (q, k f32,
    v and do in dt) at ``_bwd_kernel``'s rounding points: p and ds rounded to
    dt for their products, rel_bias's grad summing the f32 ds, rowsum(dp*p)
    taken as do . o. Returns (dq, dk, dv, d rel_bias [heads,L,L], d
    logit_scale [heads]), f32."""
    heads, L = q.shape[1], q.shape[2]
    rq = torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24)
    rk = torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-24)
    qf = q * rq
    qr, kr = qf.to(dt).float(), (k * rk).to(dt).float()
    lam = logit_scale.float().reshape(1, heads, 1, 1)
    s = (qr @ kr.transpose(-1, -2)) * lam + rel_bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(-1, nW, heads, L, L) + mask.float()[None, :, None]).reshape(-1, heads, L, L)
    p = torch.softmax(s, dim=-1).to(dt).float()
    vf, dof = v.float(), do.float()
    dv = p.transpose(-1, -2) @ dof
    rowsum = (dof * (p @ vf)).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - rowsum)
    dsr = ds.to(dt).float()
    qhb = dsr @ kr
    dscale = (qhb * qf).sum((0, 2, 3))
    qnb = lam * qhb
    dq = rq * (qnb - q * rq * rq * (qnb * q).sum(-1, keepdim=True))
    knb = lam * (dsr.transpose(-1, -2) @ qr)
    dk = rk * (knb - k * rk * rk * (knb * k).sum(-1, keepdim=True))
    return dq, dk, dv, ds.sum(0), dscale


def window_attention_bwd_reference(
    qkv: torch.Tensor, dout: torch.Tensor, rel_bias: torch.Tensor, logit_scale: torch.Tensor,
    mask: Optional[torch.Tensor], *, window_size: int, num_heads: int, shift: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`window_attention_bwd`."""
    B, H, W, C3 = qkv.shape
    C, ws, dt = C3 // 3, window_size, qkv.dtype
    L, hd = ws * ws, C // num_heads

    def windows(t):
        t = torch.roll(t, shifts=(-shift, -shift), dims=(1, 2)) if shift else t
        return window_partition(t, ws)

    def heads_of(t):
        return t.reshape(-1, L, num_heads, hd).transpose(1, 2)

    win, dow = windows(qkv), windows(dout)
    dq, dk, dv, drb, dscale = _cosine_attention_bwd(
        heads_of(win[..., :C]).float(), heads_of(win[..., C:2 * C]).float(),
        heads_of(win[..., 2 * C:]), heads_of(dow), rel_bias, logit_scale, mask, dt,
    )
    dwin = torch.cat([t.transpose(1, 2).reshape(-1, L, C) for t in (dq, dk, dv)], dim=-1)
    d = window_reverse(dwin, ws, B, H, W)
    d = torch.roll(d, shifts=(shift, shift), dims=(1, 2)) if shift else d
    return d, drb, dscale


def _attn_bwd_groups(resident: int, heads: int, nW: int, B: int) -> Tuple[int, int]:
    """(images per group, groups) of the bf16 attention backward: one block
    per (head, window position, group of images); enough groups for the
    `resident` blocks the card holds at once, and as few as that allows (the
    block's d rel_bias slab and its launch cost are per group), as
    ``csrc/window_attn_core.cuh:images_per_group`` plans the forward kernels'
    groups. The groups cover the B images in order, the last one possibly
    short."""
    groups = min(B, max(1, resident // (heads * nW)))
    per_group = -(-B // groups)
    return per_group, -(-B // per_group)


def attn_bwd_scratch_floats(B: int, nW: int, heads: int, L: int, groups: Optional[int]) -> int:
    """f32 elements of the attention backward's d rel_bias / d logit_scale
    partials: one [heads*L*L + heads] slot per window of every image (f32
    kernel, groups None), or per window position and image group (bf16)."""
    return (B * nW if groups is None else nW * groups) * (heads * L * L + heads)


_resident: dict = {}


def _attn_bwd_resident(t: torch.Tensor, ws: int, masked: bool) -> int:
    """Resident blocks of the bf16 attention backward on t's card, asked of
    the library once per device, window size and mask."""
    key = (t.device.index, ws, masked)
    if key not in _resident:
        with torch.cuda.device(t.device):
            n = _lib("fused_block_bwd").swin_window_attn_bwd_blocks(ws, int(masked))
        _check_launch("swin_window_attn_bwd (occupancy)", -n if n < 0 else 0)
        _resident[key] = n
    return _resident[key]


def window_attention_bwd(
    qkv: torch.Tensor, dout: torch.Tensor, rel_bias: torch.Tensor, logit_scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None, *, window_size: int, num_heads: int, shift: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """VJP of :func:`window_attention` given dout = dL/do [B,H,W,C] in qkv's
    dtype: (dqkv [B,H,W,3C], d rel_bias [heads,L,L] summed over every window,
    d logit_scale [heads]), all f32. Operands as for the forward; p is
    recomputed exactly as the forward kernel computes it."""
    tensors = (qkv, dout, rel_bias, logit_scale) + (() if mask is None else (mask,))
    kw = dict(window_size=window_size, num_heads=num_heads, shift=shift)
    if _is_cpu(*tensors):
        return window_attention_bwd_reference(qkv, dout, rel_bias, logit_scale, mask, **kw)
    B, H, W, C3 = qkv.shape
    C, ws, dt = C3 // 3, window_size, qkv.dtype
    L = ws * ws
    _require(dt in _DT_CODE, f"window_attention_bwd takes bf16 or f32, got {dt}")
    _require(C3 == 3 * C and C == num_heads * _ATTN_HEAD_DIM,
             f"window_attention_bwd kernel needs head_dim {_ATTN_HEAD_DIM}")
    _require(dout.shape == (B, H, W, C) and dout.dtype == dt, "dout must be [B,H,W,C] in qkv's dtype")
    _require(H % ws == 0 and W % ws == 0, "H and W must be multiples of the window")
    _require(L in (16, 64, 256), "window_attention_bwd kernel needs ws in {4, 8, 16}")
    _require(rel_bias.shape == (num_heads, L, L) and rel_bias.dtype == dt,
             "rel_bias must be [heads, L, L] in qkv's dtype")
    _require(logit_scale.numel() == num_heads and logit_scale.dtype == torch.float32,
             "logit_scale must be f32 with one value per head")
    nW = (H // ws) * (W // ws)
    if mask is not None:
        _require(mask.shape == (nW, L, L) and mask.dtype == dt,
                 "mask must be [nW, L, L] in qkv's dtype")
    _require(all(t.is_contiguous() for t in tensors), "window_attention_bwd needs contiguous operands")
    _require(dt != torch.bfloat16 or _aligned16(*tensors),
             "the bf16 window_attention_bwd kernel needs 16-byte aligned operands")
    per_group, groups = 0, None
    if dt == torch.bfloat16:
        per_group, groups = _attn_bwd_groups(_attn_bwd_resident(qkv, ws, mask is not None),
                                             num_heads, nW, B)
    per_window = num_heads * L * L + num_heads
    dqkv = torch.empty((B, H, W, C3), dtype=torch.float32, device=qkv.device)
    part = torch.empty(attn_bwd_scratch_floats(B, nW, num_heads, L, groups), dtype=torch.float32,
                       device=qkv.device)
    out = torch.empty(per_window, dtype=torch.float32, device=qkv.device)
    rc = _lib("fused_block_bwd").swin_window_attn_bwd(
        qkv.data_ptr(), dout.data_ptr(), rel_bias.data_ptr(),
        None if mask is None else mask.data_ptr(), logit_scale.data_ptr(), dqkv.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, H, W, C, num_heads, ws, shift, per_group,
        _DT_CODE[dt], _stream(qkv),
    )
    _check_launch("swin_window_attn_bwd", rc)
    window_attention_bwd.launches += 1
    return dqkv, out[:num_heads * L * L].view(num_heads, L, L), out[num_heads * L * L:]


# ---------------------------------------------------------------------------
# the whole block
# ---------------------------------------------------------------------------

OPERANDS = ("wqkv", "bqkv", "wproj", "bproj", "ln1_scale", "ln1_bias", "w1", "b1",
            "w2", "b2", "ln2_scale", "ln2_bias", "rel_bias", "logit_scale")


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


def block_backward_reference(
    g, x, wqkv, bqkv, wproj, bproj, ln1_scale, ln1_bias, w1, b1, w2, b2,
    ln2_scale, ln2_bias, rel_bias, logit_scale, dp, mask=None,
    *, window_size: int, num_heads: int, eps: float,
) -> tuple:
    """PyTorch mirror of ``_bwd_kernel``: the VJP of :func:`block_reference`
    for the cotangent g, with g and x [B,H,W,C] in shifted-window coordinates.

    Recomputes the forward, then backpropagates at the kernel's rounding
    points: every gradient that feeds a product is rounded to the compute
    dtype there (bias and LN grads sum the f32 values); m1 and gelu(m1), p,
    ds and the attention-output grad are in the compute dtype; gelu' uses the
    exact erf. Returns (dx, then the grads of wqkv ... logit_scale, each in its
    operand's dtype, then zeros for dp, and for mask when one is given).
    """
    B, H, W, C = x.shape
    ws, heads = window_size, num_heads
    nW, L, hd, dt = (H // ws) * (W // ws), ws * ws, C // num_heads, x.dtype

    def rnd(t):  # round to the compute dtype, back to f32
        return t.to(dt).float()

    def heads_of(t):
        return t.reshape(-1, L, heads, hd).transpose(1, 2)

    def unheads(t):
        return t.transpose(1, 2).reshape(-1, L, C)

    def wgrad(a, d):  # summed over windows and rows
        return rnd(a).reshape(-1, a.shape[-1]).t() @ rnd(d).reshape(-1, d.shape[-1])

    win = window_partition(x, ws).float()                                # [B_, L, C]
    gw = window_partition(g, ws).float()
    # forward recompute
    qkv = rnd(win @ wqkv.float() + bqkv.float())
    q, k, v = heads_of(qkv[..., :C]), heads_of(qkv[..., C:2 * C]), heads_of(qkv[..., 2 * C:])
    o = unheads(_cosine_attention(q, k, v.to(dt), rel_bias, logit_scale, mask, dt).float())
    proj = o @ wproj.float() + bproj.float()
    dp0 = dp[:, 0].float().repeat_interleave(nW).reshape(-1, 1, 1)
    dp1 = dp[:, 1].float().repeat_interleave(nW).reshape(-1, 1, 1)
    h1 = win + dp0 * _layer_norm_f32(proj, ln1_scale, ln1_bias, eps)
    m1 = rnd(h1) @ w1.float() + b1.float()
    mg = rnd(F.gelu(m1))
    m2 = mg @ w2.float() + b2.float()
    # backward
    m2b, dln2s, dln2b = _layer_norm_bwd_f32(m2, gw * dp1, ln2_scale, eps)
    m1b = (rnd(m2b) @ w2.float().t()) * _gelu_grad(rnd(m1))
    h1b = gw + rnd(m1b) @ w1.float().t()
    projb, dln1s, dln1b = _layer_norm_bwd_f32(proj, h1b * dp0, ln1_scale, eps)
    ab = rnd(rnd(projb) @ wproj.float().t())
    dq, dk, dv, drb, dscale = _cosine_attention_bwd(
        q, k, v.to(dt), heads_of(ab).to(dt), rel_bias, logit_scale, mask, dt)
    qkvb = torch.cat([unheads(dq), unheads(dk), unheads(dv)], dim=-1)
    dx = (h1b + rnd(qkvb) @ wqkv.float().t()).to(dt)
    grads = (
        wgrad(win, qkvb), qkvb.sum((0, 1)), wgrad(o, projb), projb.sum((0, 1)), dln1s, dln1b,
        wgrad(h1, m1b), m1b.sum((0, 1)), wgrad(mg, m2b), m2b.sum((0, 1)), dln2s, dln2b,
        drb, dscale,
    )
    operands = (wqkv, bqkv, wproj, bproj, ln1_scale, ln1_bias, w1, b1, w2, b2,
                ln2_scale, ln2_bias, rel_bias, logit_scale)
    out = (window_reverse(dx, ws, B, H, W),) + tuple(
        gr.to(op.dtype).reshape(op.shape) for gr, op in zip(grads, operands)
    ) + (torch.zeros_like(dp),)
    return out + ((torch.zeros_like(mask),) if mask is not None else ())


def _block_forward(x, wqkv, bqkv, wproj, bproj, ln1_scale, ln1_bias, w1, b1, w2, b2,
                   ln2_scale, ln2_bias, rel_bias, logit_scale, mask, dp,
                   window_size, num_heads, eps, shift, keep):
    """The seven forward launches (or their plain versions on the CPU). With
    `keep`, also returns what the backward reads: (qkv, o, proj, h1 in the
    compute dtype, gelu(m1), m2)."""
    B, H, W, C = x.shape
    M, dt = B * H * W, x.dtype
    x2 = x.reshape(M, C)
    qkv = gemm_bias_act(x2, wqkv, bqkv, out_dtype=dt)
    o = window_attention(
        qkv.reshape(B, H, W, 3 * C), rel_bias, logit_scale, mask,
        window_size=window_size, num_heads=num_heads, shift=shift,
    )
    proj = gemm_bias_act(o.reshape(M, C), wproj, bproj, out_dtype=torch.float32)
    h1_dt, h1 = ln_residual(proj, x2, ln1_scale, ln1_bias, dp, 0, eps, dt, keep_f32=True)
    mg = gemm_bias_act(h1_dt, w1, b1, act="gelu", out_dtype=dt)
    m2 = gemm_bias_act(mg, w2, b2, out_dtype=torch.float32)
    y, _ = ln_residual(m2, h1, ln2_scale, ln2_bias, dp, 1, eps, dt)
    return y.reshape(B, H, W, C), ((qkv, o, proj, h1_dt, mg, m2) if keep else None)


class FusedSwinBlock(torch.autograd.Function):
    """One SwinV2 block whose forward is :func:`_block_forward`'s seven
    launches and whose backward is the four backward kernels (eleven launches)
    plus one forward GEMM, or all of their plain versions on CPU tensors.

    Unlike ``_fused_block_fwd`` of the JAX package, which saves the block's
    inputs only and recomputes the forward in the backward kernel, the forward
    here saves its intermediates (qkv, the attention output, h1 and gelu(m1)
    in the compute dtype, the proj and MLP-2 outputs in f32: 26 bytes per
    token and channel in bf16, about 0.85 GB over the 24 blocks of a
    Swin-B-256 step at batch 8) and the backward recomputes only the
    pre-GELU MLP-1 output m1 (one GEMM). The operand grads are those of the operands handed
    in, in each operand's dtype; the grads of dp and mask are None.
    """

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, ln1_scale, ln1_bias, w1, b1, w2, b2,
                ln2_scale, ln2_bias, rel_bias, logit_scale, mask, dp,
                window_size, num_heads, eps, shift):
        y, saved = _block_forward(
            x, wqkv, bqkv, wproj, bproj, ln1_scale, ln1_bias, w1, b1, w2, b2,
            ln2_scale, ln2_bias, rel_bias, logit_scale, mask, dp,
            window_size, num_heads, eps, shift, keep=True)
        ctx.save_for_backward(x, wqkv, wproj, w1, b1, w2, ln1_scale, ln2_scale, rel_bias,
                              logit_scale, mask, dp, *saved)
        ctx.geom = (window_size, num_heads, eps, shift)
        ctx.dtypes = [t.dtype for t in (wqkv, bqkv, wproj, bproj, ln1_scale, ln1_bias,
                                        w1, b1, w2, b2, ln2_scale, ln2_bias, rel_bias,
                                        logit_scale)]
        return y

    @staticmethod
    def backward(ctx, gy):
        (x, wqkv, wproj, w1, b1, w2, ln1_scale, ln2_scale, rel_bias, logit_scale, mask, dp,
         qkv, o, proj, h1_dt, mg, m2) = ctx.saved_tensors
        window_size, num_heads, eps, shift = ctx.geom
        B, H, W, C = x.shape
        M, dt, f32 = B * H * W, x.dtype, torch.float32
        g = gy.to(dt).contiguous().reshape(M, C)
        m1 = gemm_bias_act(h1_dt, w1, b1, out_dtype=dt)
        m2b, dln2s, dln2b = ln_residual_bwd(m2, g, ln2_scale, dp, 1, eps)
        dw2, db2 = gemm_wgrad(mg, m2b)
        m1b = gemm_dgrad(m2b, w2, m1, epi="gelu", out_dtype=f32)
        dw1, db1 = gemm_wgrad(h1_dt, m1b)
        h1b = gemm_dgrad(m1b, w1, g, epi="add", out_dtype=f32)
        projb, dln1s, dln1b = ln_residual_bwd(proj, h1b, ln1_scale, dp, 0, eps)
        dwproj, dbproj = gemm_wgrad(o.reshape(M, C), projb)
        ab = gemm_dgrad(projb, wproj, out_dtype=dt)
        dqkv, drb, dscale = window_attention_bwd(
            qkv.reshape(B, H, W, 3 * C), ab.reshape(B, H, W, C), rel_bias, logit_scale, mask,
            window_size=window_size, num_heads=num_heads, shift=shift)
        dqkv = dqkv.reshape(M, 3 * C)
        dwqkv, dbqkv = gemm_wgrad(x.reshape(M, C), dqkv)
        dx = gemm_dgrad(dqkv, wqkv, h1b, epi="add", out_dtype=dt)
        if x.device.type == "cuda":
            FusedSwinBlock.launches += 1
        grads = (dwqkv, dbqkv, dwproj, dbproj, dln1s, dln1b, dw1, db1, dw2, db2,
                 dln2s, dln2b, drb, dscale.reshape(logit_scale.shape))
        return (dx.reshape(B, H, W, C),) + tuple(
            gr.to(d) for gr, d in zip(grads, ctx.dtypes)) + (None,) * 6


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
    activation dtype except logit_scale and droppath_keep (f32). When
    autograd records and an input requires grad, the block runs through
    :class:`FusedSwinBlock`, whose backward is the backward kernels."""
    dp = None if droppath_keep is None else droppath_keep.float().contiguous()
    ops = (wqkv, bqkv, wproj, bproj, ln1_scale, ln1_bias, w1, b1, w2, b2,
           ln2_scale, ln2_bias, rel_bias, logit_scale)
    x = x.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x,) + ops):
        y = FusedSwinBlock.apply(x, *ops, mask, dp, window_size, num_heads, eps, shift)
    else:
        y, _ = _block_forward(x, *ops, mask, dp, window_size, num_heads, eps, shift, keep=False)
    if x.device.type == "cuda":
        fused_swin_block.launches += 1
    return y


reset_launch_counts()
