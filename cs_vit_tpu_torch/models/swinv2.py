"""SwinV2 encoder (port of ``cs_vit_tpu/models/swinv2.py``).

Parameter names follow ``transformers.Swinv2Model`` (``embeddings.*``,
``encoder.layers.S.blocks.B.attention.self.*`` ...), the names the JAX
package exports under ``backbone.``. Activations are NHWC, as in the JAX
package. SwinV2 semantics kept:

  - cosine attention: softmax(norm(q) norm(k)^T * exp(min(logit_scale, ln 100))
    + 16*sigmoid(CPB)), q and v biased, k not
  - residual post-norm: x + LN(attn(x)), x + LN(mlp(x))
  - per-stage window/shift clamped to the input resolution
  - patch merging concat order (0,0),(1,0),(0,1),(1,1) -> Linear(4C->2C) -> LN

``SwinV2Block`` runs one of three implementations: ``"eager"`` (the JAX
package's XLA path, op for op), ``"fused"`` (:func:`fused_swin_block`, the
CUDA kernels on CUDA tensors, forward and backward) or ``"pallas"`` (the
eager block around the attention-only kernel :func:`fused_window_attention`,
forward only, as the JAX ``"pallas"`` path; its output stays in q's dtype,
so bf16 activations are not promoted to f32 as on the eager path).
``"auto"`` picks ``"fused"`` for CUDA tensors and ``"eager"`` for CPU
tensors; ``"hybrid"`` picks ``"pallas"`` for a block with more than one
window and ``"eager"`` for the others, once, when the block is built.

Stochastic depth: block i of n drops its two residual branches per image with
rate ``linspace(0, drop_path_rate, n)[i]``, drawing from the
``torch.Generator`` handed to :meth:`SwinV2.forward` (none: deterministic).
Both implementations take the same draws: a [B, 2] keep mask per block, which
the eager path applies as ``x * mask / keep`` (the JAX ``DropPath``) and the
fused path hands the kernels as keep-scales ``mask / keep``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_block import fused_swin_block, window_partition, window_reverse
from ..ops.window_attention import fused_window_attention
from .modules import LayerNorm, Linear

ATTENTION_IMPLS = ("auto", "eager", "fused", "pallas", "hybrid")


@dataclasses.dataclass(frozen=True)
class SwinV2Config:
    image_size: int = 256
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 16
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    layer_norm_eps: float = 1e-5
    pretrained_window_sizes: Tuple[int, ...] = (0, 0, 0, 0)

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))


def swinv2_tiny_256(window_size: int = 16, **kw) -> SwinV2Config:
    """microsoft/swinv2-tiny-patch4-window16-256."""
    return SwinV2Config(
        embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
        window_size=window_size, **kw,
    )


def swinv2_base_256(window_size: int = 16, **kw) -> SwinV2Config:
    """microsoft/swinv2-base-patch4-window16-256."""
    return SwinV2Config(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
        window_size=window_size, **kw,
    )


def _holds(key, dt: torch.dtype, tensors) -> bool:
    """Whether a fused-operand cache key was made from these very tensors at
    their present versions, for compute dtype `dt`."""
    key_dt, refs = key
    return key_dt == dt and len(refs) == len(tensors) and all(
        r() is t and v == t._version for (r, v), t in zip(refs, tensors))


def _compute_window_shift(
    resolution: Tuple[int, int], window: int, shift: int
) -> Tuple[int, int]:
    """Clamp window to resolution; zero the shift when clamped (HF behavior)."""
    ws = min(resolution[0], resolution[1], window)
    sh = 0 if min(resolution) <= window else shift
    return ws, sh


def _relative_coords_table(window_size: int, pretrained_window_size: int) -> np.ndarray:
    """Log-spaced continuous relative coordinates, [(2w-1)^2, 2]."""
    rng = np.arange(-(window_size - 1), window_size, dtype=np.float32)
    table = np.stack(np.meshgrid(rng, rng, indexing="ij"), axis=-1)
    denom = (pretrained_window_size - 1) if pretrained_window_size > 0 else (window_size - 1)
    if denom > 0:
        table = table / denom
    table = table * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / math.log2(8.0)
    return table.reshape(-1, 2)


def _relative_position_index(window_size: int) -> np.ndarray:
    """Pairwise relative-position lookup indices, [w*w, w*w]."""
    coords = np.stack(
        np.meshgrid(np.arange(window_size), np.arange(window_size), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1).astype(np.int64)


def _shift_attn_mask(height: int, width: int, window_size: int, shift: int) -> np.ndarray:
    """Additive mask [nW, w*w, w*w] for shifted-window attention (-100 off-region)."""
    img_mask = np.zeros((height, width), dtype=np.float32)
    slices = (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for ws_ in slices:
            img_mask[hs, ws_] = count
            count += 1
    nh, nw = height // window_size, width // window_size
    mw = img_mask.reshape(nh, window_size, nw, window_size)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class Swinv2SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 pretrained_window_size: int = 0, qkv_bias: bool = True):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.continuous_position_bias_mlp = nn.Sequential(
            Linear(2, 512), nn.ReLU(), Linear(512, num_heads, bias=False)
        )
        self.query = Linear(dim, dim, bias=qkv_bias)
        self.key = Linear(dim, dim, bias=False)
        self.value = Linear(dim, dim, bias=qkv_bias)
        self.register_buffer(
            "relative_coords_table",
            torch.from_numpy(_relative_coords_table(window_size, pretrained_window_size)),
            persistent=False,
        )
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size).reshape(-1)),
            persistent=False,
        )

    def relative_position_bias(self) -> torch.Tensor:
        """CPB-MLP bias, [num_heads, L, L] with L = window_size**2."""
        table = self.continuous_position_bias_mlp(self.relative_coords_table)
        L = self.window_size * self.window_size
        bias = table[self.relative_position_index].reshape(L, L, self.num_heads)
        return 16.0 * torch.sigmoid(bias.permute(2, 0, 1))

    def logit_scale_value(self) -> torch.Tensor:
        """exp(min(logit_scale, ln 100)), [heads, 1, 1]."""
        return torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                kernel: bool = False) -> torch.Tensor:
        """x: [B_, L, C] window tokens; mask: [nW, L, L] additive or None;
        `kernel`: the attention core through :func:`fused_window_attention`
        (the JAX ``"pallas"`` path)."""
        B_, L, C = x.shape
        H, hd = self.num_heads, C // self.num_heads
        q = self.query(x).reshape(B_, L, H, hd).transpose(1, 2)
        k = self.key(x).reshape(B_, L, H, hd).transpose(1, 2)
        v = self.value(x).reshape(B_, L, H, hd).transpose(1, 2)
        if kernel:
            rel_bias = self.relative_position_bias()
            bias = rel_bias[None] if mask is None else rel_bias[None] + mask[:, None]
            out = fused_window_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         bias.contiguous(),
                                         self.logit_scale_value().reshape(-1).float())
            return out.transpose(1, 2).reshape(B_, L, C)
        qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
        kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-12)
        attn = (qn @ kn.transpose(-1, -2)) * self.logit_scale_value()
        attn = attn + self.relative_position_bias()[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, H, L, L) + mask[None, :, None]).reshape(B_, H, L, L)
        attn = torch.softmax(attn, dim=-1)
        # softmax of a promoted (f32) score matrix comes back in f32; the
        # product with v runs in their promotion, as jnp.einsum does
        dt = torch.promote_types(attn.dtype, v.dtype)
        return (attn.to(dt) @ v.to(dt)).transpose(1, 2).reshape(B_, L, C)


class _Dense(nn.Module):
    """Holds one ``dense`` Linear, giving the HF names ``*.dense.*``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.dense = Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class Swinv2Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 pretrained_window_size: int = 0, qkv_bias: bool = True):
        super().__init__()
        self.self = Swinv2SelfAttention(dim, num_heads, window_size,
                                        pretrained_window_size, qkv_bias)
        self.output = _Dense(dim, dim)


class SwinV2Block(nn.Module):
    def __init__(self, config: SwinV2Config, dim: int, resolution: Tuple[int, int],
                 num_heads: int, shift_size: int, pretrained_window_size: int = 0,
                 attention_impl: str = "auto", drop_path_rate: float = 0.0):
        super().__init__()
        self.config, self.dim, self.resolution = config, dim, resolution
        self.drop_path_rate = drop_path_rate
        self.num_heads = num_heads
        self.ws, self.sh = _compute_window_shift(resolution, config.window_size, shift_size)
        self.set_attention_impl(attention_impl)
        hidden = int(dim * config.mlp_ratio)
        self.attention = Swinv2Attention(dim, num_heads, self.ws, pretrained_window_size,
                                         config.qkv_bias)
        self.layernorm_before = LayerNorm(dim, eps=config.layer_norm_eps)
        self.intermediate = _Dense(dim, hidden)
        self.output = _Dense(hidden, dim)
        self.layernorm_after = LayerNorm(dim, eps=config.layer_norm_eps)
        mask = (
            torch.from_numpy(_shift_attn_mask(resolution[0], resolution[1], self.ws, self.sh))
            if self.sh > 0 else None
        )
        self.register_buffer("attn_mask", mask, persistent=False)
        # see _cached_fused_operands; the module list spares the key the cost
        # of a recursive parameters() walk on every forward
        self._fused_cache, self._own_modules = None, tuple(self.modules())

    def set_attention_impl(self, impl: str) -> None:
        """One of ``ATTENTION_IMPLS``; ``"hybrid"`` resolves here, per block."""
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {impl!r}")
        if impl == "hybrid":
            n_windows = (self.resolution[0] // self.ws) * (self.resolution[1] // self.ws)
            impl = "pallas" if n_windows > 1 else "eager"
        self.attention_impl = impl

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, H*W, C]; `generator` draws the droppath mask (None or a
        rate of 0: no droppath)."""
        impl = self.attention_impl
        if impl == "auto":
            impl = "fused" if x.device.type == "cuda" else "eager"
        keep = None
        if generator is not None and self.drop_path_rate > 0.0:
            p = torch.full((x.shape[0], 2), 1.0 - self.drop_path_rate, device=generator.device)
            keep = torch.bernoulli(p, generator=generator).to(x.device)
        if impl == "fused":
            return self._fused(x, keep)
        return self._eager(x, keep, kernel=impl == "pallas")

    def _drop_path(self, branch: torch.Tensor, keep: Optional[torch.Tensor], col: int):
        if keep is None:
            return branch
        mask = keep[:, col].to(branch.dtype).reshape(-1, *([1] * (branch.dim() - 1)))
        return branch * mask / (1.0 - self.drop_path_rate)

    def _eager(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
               kernel: bool = False) -> torch.Tensor:
        H, W = self.resolution
        B, _, C = x.shape
        ws, sh = self.ws, self.sh
        shortcut = x
        x = x.reshape(B, H, W, C)
        if sh > 0:
            x = torch.roll(x, shifts=(-sh, -sh), dims=(1, 2))
        windows = window_partition(x, ws)
        attn_out = self.attention.output(self.attention.self(windows, self.attn_mask, kernel))
        x = window_reverse(attn_out, ws, B, H, W)
        if sh > 0:
            x = torch.roll(x, shifts=(sh, sh), dims=(1, 2))
        x = x.reshape(B, H * W, C)
        x = shortcut + self._drop_path(self.layernorm_before(x), keep, 0)
        y = self.output(F.gelu(self.intermediate(x)))
        return x + self._drop_path(self.layernorm_after(y), keep, 1)

    def _fused_operands(self, dt: torch.dtype) -> dict:
        """The block's operands as :func:`fused_swin_block` takes them: [in, out]
        weights with q|k|v concatenated, all in `dt`, the CPB bias and shift
        mask in `dt`, the clamped logit scale in f32."""
        a = self.attention.self
        C = self.dim
        zero_b = torch.zeros(C, dtype=dt, device=a.query.weight.device)

        def w(lin):  # torch [out, in] -> [in, out]
            return lin.weight.to(dt).t().contiguous()

        def b(lin):
            return zero_b if lin.bias is None else lin.bias.to(dt)

        proj, mlp1, mlp2 = self.attention.output.dense, self.intermediate.dense, self.output.dense
        return dict(
            wqkv=torch.cat([w(a.query), w(a.key), w(a.value)], dim=1),
            bqkv=torch.cat([b(a.query), zero_b, b(a.value)]),
            wproj=w(proj), bproj=b(proj),
            ln1_scale=self.layernorm_before.weight.to(dt),
            ln1_bias=self.layernorm_before.bias.to(dt),
            w1=w(mlp1), b1=b(mlp1), w2=w(mlp2), b2=b(mlp2),
            ln2_scale=self.layernorm_after.weight.to(dt),
            ln2_bias=self.layernorm_after.bias.to(dt),
            rel_bias=a.relative_position_bias().to(dt).contiguous(),
            logit_scale=a.logit_scale_value().reshape(-1).float(),
            mask=None if self.attn_mask is None else self.attn_mask.to(dt),
        )

    def _cached_fused_operands(self, dt: torch.dtype) -> dict:
        """:meth:`_fused_operands`, built once per set of weights when no
        gradient is recorded (serving). The cache key holds a weak reference
        to each parameter and buffer with its version counter: a new tensor
        (a train step's fresh copy, even one on a recycled address), a
        moved, cast or loaded weight, or an in-place edit rebuilds it."""
        if torch.is_grad_enabled():
            return self._fused_operands(dt)
        tensors = [t for m in self._own_modules
                   for t in itertools.chain(m._parameters.values(), m._buffers.values())
                   if t is not None]
        cache = self._fused_cache
        if cache is None or not _holds(cache[0], dt, tensors):
            key = (dt, tuple((weakref.ref(t), t._version) for t in tensors))
            self._fused_cache = (key, self._fused_operands(dt))
        return self._fused_cache[1]

    def _fused(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        H, W = self.resolution
        B, _, C = x.shape
        # uniform compute dtype = Linear promotion of (input, params)
        dt = torch.promote_types(x.dtype, self.attention.self.query.weight.dtype)
        y = fused_swin_block(
            x.reshape(B, H, W, C).to(dt), **self._cached_fused_operands(dt),
            droppath_keep=None if keep is None else keep / (1.0 - self.drop_path_rate),
            window_size=self.ws, num_heads=self.num_heads,
            eps=self.config.layer_norm_eps, shift=self.sh,
        )
        return y.reshape(B, H * W, C)


class PatchMerging(nn.Module):
    """2x2 neighbourhood gather -> Linear(4C, 2C, no bias) -> LN.

    Concat segment s = 2*dw + dh holds pixel (2i+dh, 2j+dw): the order
    (0,0),(1,0),(0,1),(1,1), which the JAX package's stride-2 conv encodes
    as kernel tap [dh, dw] of the same ``reduction`` weight.
    """

    def __init__(self, dim: int, resolution: Tuple[int, int], eps: float = 1e-5):
        super().__init__()
        self.resolution = resolution
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.resolution
        B, _, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        return self.norm(self.reduction(x.reshape(B, (H // 2) * (W // 2), 4 * C)))


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: SwinV2Config):
        super().__init__()
        self.projection = nn.Conv2d(cfg.num_channels, cfg.embed_dim,
                                    kernel_size=cfg.patch_size, stride=cfg.patch_size)


class _Embeddings(nn.Module):
    def __init__(self, cfg: SwinV2Config):
        super().__init__()
        self.patch_embeddings = _PatchEmbeddings(cfg)
        self.norm = LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """NHWC images -> [B, (H/p)^2, D] patch tokens."""
        conv = self.patch_embeddings.projection
        dt = torch.promote_types(pixel_values.dtype, conv.weight.dtype)
        x = F.conv2d(
            pixel_values.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt),
            conv.bias.to(dt), stride=conv.stride,
        )
        x = x.flatten(2).transpose(1, 2)
        return self.norm(x)


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class _Encoder(nn.Module):
    def __init__(self, stages):
        super().__init__()
        self.layers = nn.ModuleList(stages)


class SwinV2(nn.Module):
    """Full SwinV2 encoder: images [B, H, W, 3] -> tokens [B, (H/32)^2, D]."""

    def __init__(self, config: SwinV2Config, attention_impl: str = "auto"):
        super().__init__()
        cfg = self.config = config
        self.embeddings = _Embeddings(cfg)
        res, dim = cfg.image_size // cfg.patch_size, cfg.embed_dim
        dpr = iter(np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist())
        stages = []
        for s in range(cfg.num_layers):
            blocks = [
                SwinV2Block(
                    cfg, dim, (res, res), cfg.num_heads[s],
                    shift_size=0 if i % 2 == 0 else cfg.window_size // 2,
                    pretrained_window_size=cfg.pretrained_window_sizes[s],
                    attention_impl=attention_impl, drop_path_rate=next(dpr),
                )
                for i in range(cfg.depths[s])
            ]
            down = None
            if s < cfg.num_layers - 1:
                down = PatchMerging(dim, (res, res), eps=cfg.layer_norm_eps)
                res, dim = res // 2, dim * 2
            stages.append(_Stage(blocks, down))
        self.encoder = _Encoder(stages)
        self.layernorm = LayerNorm(dim, eps=cfg.layer_norm_eps)

    def set_attention_impl(self, impl: str) -> None:
        for stage in self.encoder.layers:
            for blk in stage.blocks:
                blk.set_attention_impl(impl)

    def forward(self, pixel_values: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the blocks' droppath masks in block order; None
        runs deterministically (inference)."""
        x = self.embeddings(pixel_values)
        for stage in self.encoder.layers:
            for blk in stage.blocks:
                x = blk(x, generator)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return self.layernorm(x)


__all__ = [
    "ATTENTION_IMPLS", "PatchMerging", "SwinV2", "SwinV2Block", "SwinV2Config",
    "swinv2_base_256", "swinv2_tiny_256",
]
