"""Transformer building blocks for the Poser head (port of
``cs_vit_tpu/models/modules.py``).

Two reference quirks stay on by default, as in the JAX package:

* ``MHA`` multiplies attention scores by sqrt(head_dim) (``compat_scale``).
* Block norms are BatchNorm1d over channels, not LayerNorm.

Dtype flow follows flax: a ``Linear`` computes in the promotion of its input
and weight dtypes (a bf16 layer fed f32 runs in f32), and the norms take f32
statistics but hand back their input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sync_norm import global_moments, resolve_group


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``Dense`` dtype promotion."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """flax LayerNorm: f32 statistics as E[x^2]-E[x]^2 clamped at 0, output
    in the promotion of the input and parameter dtypes."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    out_dt = torch.promote_types(torch.promote_types(x.dtype, weight.dtype), bias.dtype)
    return y.to(out_dt)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` parameters with :func:`layer_norm` numerics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class TorchBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d over the last axis of a [..., C] input.

    The mode is the ``train`` argument, which the Poser sets from the phase
    as the JAX package does; ``nn.Module.training`` plays no part. With
    ``train=True`` the statistics are those of the batch, over every axis but
    the last, in f32: the biased variance normalises, and the running
    statistics move by momentum 0.1 (torch convention) towards the batch mean
    and the unbiased variance. The update writes into the running-statistic
    buffers in place, without autograd; a train step that may discard it
    hands the module copies of those buffers. Running statistics are f32
    buffers; the affine runs in f32 and the output keeps the input dtype.

    ``sync_group`` (None by default: this process's rows) names the process
    group whose ranks' rows the batch statistics span, as one ``jax.jit``
    program over a mesh normalises the global batch
    (``parallel.sync_norm``); it takes effect only in a group of more than
    one rank.
    """

    sync_group = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            group = resolve_group(self.sync_group)
            if group is None:
                axes = tuple(range(x.dim() - 1))
                n = xf.numel() // xf.shape[-1]
                mean = xf.mean(axes)
                var = ((xf - mean) ** 2).mean(axes)
            else:
                mean, var, n = global_moments(xf.reshape(-1, xf.shape[-1]), group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                unbiased = ((n / (n - 1.0).clamp(min=1.0)).float() if group is not None
                            else n / max(n - 1.0, 1.0))
                self.running_var.mul_(1 - m).add_(m * (var * unbiased))
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class MHA(nn.Module):
    """Multi-head attention with the reference's score scaling.

    ``compat_scale=True`` multiplies QK^T by sqrt(head_dim); ``False`` uses the
    standard 1/sqrt(head_dim). Softmax runs in f32 whatever the activation
    dtype. Queries and keys of two dtypes (bf16 queries over f32 patches)
    meet in the promoted dtype, as in the JAX package.

    The heads a call runs are as many as the query projection's outputs hold
    (``head_dim`` each): all of them, or under tensor parallelism
    (``parallel/tp.py``) this rank's share, at the full head width, so that
    the sqrt(head_dim) scale does not change.
    """

    def __init__(self, embed_dim: int, num_heads: int, compat_scale: bool = True):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.compat_scale = compat_scale
        self.query = Linear(embed_dim, embed_dim)
        self.key = Linear(embed_dim, embed_dim)
        self.value = Linear(embed_dim, embed_dim)
        self.output = Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        S = ctx.shape[1]
        hd = self.head_dim
        q = self.query(x)
        H = q.shape[-1] // hd
        q = q.reshape(B, L, H, hd).transpose(1, 2)
        k = self.key(ctx).reshape(B, S, H, hd).transpose(1, 2)
        v = self.value(ctx).reshape(B, S, H, hd).transpose(1, 2)
        scale = math.sqrt(hd) if self.compat_scale else 1.0 / math.sqrt(hd)
        dt = torch.promote_types(q.dtype, k.dtype)  # as jnp.einsum promotes
        scores = (q.to(dt) @ k.to(dt).transpose(-1, -2)) * scale
        weights = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = (weights @ v).transpose(1, 2).reshape(B, L, H * hd)
        return self.output(out)


class LoraCompatibleMHA(nn.Module):
    """Deprecated q/k/v-projected attention (ref
    ``transformer_module.py:209-232``): separate ``q_proj``, ``k_proj``,
    ``v_proj`` Linears, then a standard ``torch.nn.MultiheadAttention``
    (``mha``: fused in-projection, 1/sqrt(d_h) scaling, not :class:`MHA`'s
    sqrt-multiply quirk, out-projection). Kept so old checkpoints load;
    constructing it warns, as the reference and the JAX package do."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        import warnings

        warnings.warn("LoraCompatibleMHA has been deprecated. Use MHA instead.",
                      DeprecationWarning, stacklevel=2)
        assert embed_dim % num_heads == 0
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.mha = nn.MultiheadAttention(embed_dim, num_heads, batch_first=True)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor
                ) -> torch.Tensor:
        out, _ = self.mha(self.q_proj(query), self.k_proj(key), self.v_proj(value),
                          need_weights=False)
        return out


class FeedForwardNetwork(nn.Module):
    """Linear -> exact-erf GELU -> Linear (reference names ``net.0``/``net.2``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, 4 * dim), nn.GELU(), Linear(4 * dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, compat_scale: bool = True):
        super().__init__()
        self.attn = MHA(dim, num_heads, compat_scale)
        self.ffn = FeedForwardNetwork(dim)
        self.norm1 = TorchBatchNorm(dim)
        self.norm2 = TorchBatchNorm(dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.norm1(x, train)
        x = x + self.attn(y, y)
        return x + self.ffn(self.norm2(x, train))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, compat_scale: bool = True):
        super().__init__()
        self.self_atten = MHA(dim, num_heads, compat_scale)
        self.cross_atten = MHA(dim, num_heads, compat_scale)
        self.ffn = FeedForwardNetwork(dim)
        self.norm1 = TorchBatchNorm(dim)
        self.norm2 = TorchBatchNorm(dim)
        self.norm3 = TorchBatchNorm(dim)

    def forward(self, x: torch.Tensor, ref: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.norm1(x, train)
        x = x + self.self_atten(y, y)
        x = x + self.cross_atten(self.norm2(x, train), ref)
        return x + self.ffn(self.norm3(x, train))


class CrossAttnDecoder(nn.Module):
    """The realtime temporal layer: the last frame's query attends to every
    frame (``norm1`` -> ``cross_atten`` -> residual -> ``norm2`` -> ``ffn`` ->
    residual). Its BatchNorms see [B, 1, D] query tokens: batch statistics
    over B tokens."""

    def __init__(self, dim: int, num_heads: int, compat_scale: bool = True):
        super().__init__()
        self.cross_atten = MHA(dim, num_heads, compat_scale)
        self.ffn = FeedForwardNetwork(dim)
        self.norm1 = TorchBatchNorm(dim)
        self.norm2 = TorchBatchNorm(dim)

    def forward(self, x: torch.Tensor, ref: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x + self.cross_atten(self.norm1(x, train), ref)
        return x + self.ffn(self.norm2(x, train))


def rope_rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent feature pairs: x viewed as [..., d/2, 2]."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    x1, xb = x2[..., 0], x2[..., 1]
    return torch.stack([x1 * cos - xb * sin, x1 * sin + xb * cos], dim=-1).reshape(x.shape)


class PositionalEncoding(nn.Module):
    """Positional encoding, in one of two modes.

    ``"absolute"``: a learned table (reference ``pe.weight`` [max_len, D])
    added to the tokens. ``"trope"``: continuous-time RoPE with no
    parameters; token values (not q/k) are rotated pair by pair by the phase
    ``(t_last - t) * f_i`` with the frequency bank 10000^(-2i/D), phases and
    tables in f32, the result in the tokens' dtype.
    """

    def __init__(self, d_model: int, max_len: int = 512, mode: str = "absolute"):
        super().__init__()
        self.mode = mode
        if mode == "absolute":
            self.pe = nn.Embedding(max_len, d_model)
        elif mode == "trope":
            if d_model % 2:
                raise ValueError("d_model must be even for RoPE")
            inv_freq = 1.0 / (10000.0 ** (np.arange(0, d_model, 2, dtype=np.float32) / d_model))
            self.register_buffer("inv_freq", torch.from_numpy(inv_freq), persistent=False)
        else:
            raise ValueError(f"Unsupported position mode: {mode}")

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.mode == "absolute":
            return x + self.pe.weight[: x.shape[1]]
        if t is None:
            raise ValueError("t must be provided for 'trope' mode")
        freqs = (t[:, -1:] - t)[..., None].float() * self.inv_freq   # [B, T, D/2]
        # f32 phase tables must not promote bf16 activations
        return rope_rotate_pairs(x, torch.cos(freqs), torch.sin(freqs)).to(x.dtype)


class RoPE2DPositionalEncoding(nn.Module):
    """2D polar RoPE over a patch grid (port of the JAX module of that name).

    Adds a learned radial embedding (``embedding`` [num_point, D]: 32
    anchors, linearly interpolated by the normalised distance from the grid
    centre), then rotates feature pairs by theta(p, q) = atan2(dq, dp)
    scaled by a log-spaced frequency bank. The tables are built with numpy
    in f32 exactly as the JAX module builds them and kept as non-persistent
    buffers. The sum and the rotation run in f32 and the result keeps the
    patches' dtype: the JAX module lets its f32 tables promote bf16 patches
    to f32, which here stays a bf16 rounding of the same f32 result.
    """

    def __init__(self, embed_dim: int, num_p: int, num_q: int, num_point: int = 32,
                 freq_base: float = 10000.0):
        super().__init__()
        self.embed_dim, self.num_p, self.num_q = embed_dim, num_p, num_q
        self.embedding = nn.Parameter(torch.zeros(num_point, embed_dim))
        p, q = np.meshgrid(np.arange(num_p), np.arange(num_q), indexing="ij")
        center_p, center_q = (num_p - 1) / 2, (num_q - 1) / 2
        dp = p.astype(np.float32) - center_p
        dq = q.astype(np.float32) - center_q
        dist = np.sqrt(dp**2 + dq**2)
        max_dist = math.sqrt(center_p**2 + center_q**2)
        sample = np.clip(dist / max_dist, 0.0, 1.0) * (num_point - 1)
        theta = np.arctan2(dq, dp)
        half = embed_dim // 2
        freq = 1.0 / (freq_base ** (np.arange(half, dtype=np.float32) / half))
        pos_theta = np.einsum("pq,d->pqd", theta, freq)
        tables = {
            "cos": np.cos(pos_theta).astype(np.float32),                  # [p,q,D/2]
            "sin": np.sin(pos_theta).astype(np.float32),
            "floor": np.clip(np.floor(sample), 0, num_point - 1).astype(np.int64),
            "ceil": np.clip(np.ceil(sample), 0, num_point - 1).astype(np.int64),
            "alpha": (sample - np.floor(sample)).astype(np.float32)[..., None],
        }
        for name, value in tables.items():
            self.register_buffer(name, torch.from_numpy(value), persistent=False)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        B = patches.shape[0]
        x = patches.reshape(B, self.num_p, self.num_q, self.embed_dim)
        emb = self.embedding.float()
        dist_emb = emb[self.floor] * (1 - self.alpha) + emb[self.ceil] * self.alpha
        e2 = (x.float() + dist_emb).reshape(B, self.num_p, self.num_q, -1, 2)
        x1, x2 = e2[..., 0], e2[..., 1]
        rotated = torch.stack([self.cos * x1 - self.sin * x2, self.sin * x1 + self.cos * x2], -1)
        return rotated.reshape(B, self.num_p * self.num_q, self.embed_dim).to(patches.dtype)


def floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod``: the truncated remainder (exact), moved by `m` where its
    sign differs from `m`'s."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


class ContinuousAngleEmbedding(nn.Module):
    """Fourier features of a scalar with a learnable log-spaced frequency
    bank (``freq_base``, logspace(0, 1, num_freq) at init), then Linear ->
    exact GELU -> LayerNorm (eps 1e-5): reference names ``freq_base``,
    ``proj.0``, ``proj.2``. The angle is taken mod ``max_angle`` and mapped
    to [0, 2 pi); the features are ``[sin | cos]``."""

    def __init__(self, output_dim: int = 64, num_freq: int = 16,
                 max_angle: float = 2 * math.pi):
        super().__init__()
        self.max_angle = max_angle
        self.freq_base = nn.Parameter(
            torch.from_numpy(np.logspace(0, 1, num_freq, base=10.0).astype(np.float32)))
        self.proj = nn.Sequential(Linear(2 * num_freq, output_dim), nn.GELU(),
                                  LayerNorm(output_dim, eps=1e-5))

    def forward(self, angles: torch.Tensor) -> torch.Tensor:
        a = floor_mod(angles, self.max_angle) / self.max_angle * (2 * math.pi)
        scaled = a[..., None] * self.freq_base
        return self.proj(torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1))
