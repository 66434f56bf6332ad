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
    """

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            n = xf.numel() // xf.shape[-1]
            mean = xf.mean(axes)
            var = ((xf - mean) ** 2).mean(axes)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * (var * (n / max(n - 1.0, 1.0))))
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class MHA(nn.Module):
    """Multi-head attention with the reference's score scaling.

    ``compat_scale=True`` multiplies QK^T by sqrt(head_dim); ``False`` uses the
    standard 1/sqrt(head_dim). Softmax runs in f32 whatever the activation
    dtype.
    """

    def __init__(self, embed_dim: int, num_heads: int, compat_scale: bool = True):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.compat_scale = compat_scale
        self.query = Linear(embed_dim, embed_dim)
        self.key = Linear(embed_dim, embed_dim)
        self.value = Linear(embed_dim, embed_dim)
        self.output = Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        S = ctx.shape[1]
        H = self.num_heads
        hd = self.embed_dim // H
        q = self.query(x).reshape(B, L, H, hd).transpose(1, 2)
        k = self.key(ctx).reshape(B, S, H, hd).transpose(1, 2)
        v = self.value(ctx).reshape(B, S, H, hd).transpose(1, 2)
        scale = math.sqrt(hd) if self.compat_scale else 1.0 / math.sqrt(hd)
        scores = (q @ k.transpose(-1, -2)) * scale
        weights = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = (weights @ v).transpose(1, 2).reshape(B, L, self.embed_dim)
        return self.output(out)


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
