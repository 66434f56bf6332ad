"""DINOv2 backbone for TI-DINO (port of ``cs_vit_tpu/models/dinov2.py``; ref
``ti_vit.py:281-338``) and for the Poser (``PoserConfig(backbone="dinov2-*")``).

``transformers.Dinov2Model``'s module names (``embeddings.*``,
``encoder.layer.N.{norm1, attention, layer_scale1, norm2, mlp,
layer_scale2}``, ``layernorm``), so a converted HF state dict loads with
``strict=True``: CLS + patch embedding, pre-norm blocks with LayerScale, a
GELU or SwiGLU MLP, and the backbone head that layer-norms the last hidden
state and returns the patches without the CLS token. HF's
``embeddings.mask_token``, which only DINOv2's masked pretraining reads, is
not carried: ``convert_hf_dinov2_state_dict`` leaves it out. When the patch
grid differs from the configured one, the patch position table is resized
bicubically as ``jax.image.resize`` does (Keys cubic, a = -0.5, half-pixel
centres, the kernel widened when shrinking).

Two attention paths, by ``attention_impl``: ``"eager"`` (the default, and
what TI-DINO runs) computes ``softmax(q k^T / sqrt(d_h)) v`` explicitly
with flax's LayerNorm numerics, as the JAX package does; ``"fused"`` calls
``F.scaled_dot_product_attention`` restricted to the flash, cuDNN and
memory-efficient backends (a fallback to the math backend, which would
build the [B, H, L, L] score matrix, raises) and ``F.layer_norm``, so that
autograd keeps no score matrix and no f32 copies of the norms' inputs;
``"auto"`` takes the fused path for CUDA tensors and the eager one on the
CPU. The backbone counts attention calls by path (``attn_fused``,
``attn_explicit``). Under a profiler each layer's fused attention call is a
``csvit.vit.attn`` span and its SwiGLU or GELU MLP (both linears) a
``csvit.vit.mlp`` span; the patch embedding and the position table's
resize are ``csvit.vit.embed``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..utils.profiling import annotate
from .modules import LayerNorm, Linear
from .vit import ViTAttention, _Layers, _PatchEmbeddings, check_names

ATTENTION_IMPLS = ("auto", "eager", "fused")
# the fused path's backends: none of them forms the score matrix
_FUSED_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                   SDPBackend.EFFICIENT_ATTENTION]


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    image_size: int = 518
    patch_size: int = 14
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6
    layerscale_value: float = 1.0
    use_swiglu_ffn: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of ``jax.image.resize(..., "bicubic")`` along one
    axis (antialiased: the kernel is widened by n_in / n_out when shrinking)."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(grid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[1, H, W, D] -> [1, h, w, D], ``jax.image.resize(..., method="bicubic")``."""
    wy = _resize_weights(grid.shape[1], h, grid.device).to(grid.dtype)
    wx = _resize_weights(grid.shape[2], w, grid.device).to(grid.dtype)
    return torch.einsum("bHWd,Hh,Ww->bhwd", grid, wy, wx)


class _Dinov2Embeddings(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, cfg.num_patches + 1,
                                                            cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg.num_channels, cfg.hidden_size,
                                                 cfg.patch_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, H, W, _ = pixel_values.shape
        x = self.patch_embeddings(pixel_values)
        h, w = H // cfg.patch_size, W // cfg.patch_size
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        pos = self.position_embeddings
        grid0 = int(cfg.num_patches**0.5)
        if (h, w) != (grid0, grid0):
            patch_pos = pos[:, 1:].reshape(1, grid0, grid0, cfg.hidden_size)
            patch_pos = resize_bicubic(patch_pos, h, w).reshape(1, h * w, cfg.hidden_size)
            pos = torch.cat([pos[:, :1], patch_pos], dim=1)
        return x + pos


class _LayerScale(nn.Module):
    def __init__(self, dim: int, value: float):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.full((dim,), float(value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.lambda1


class _Mlp(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        D = cfg.hidden_size
        self.swiglu = cfg.use_swiglu_ffn
        if self.swiglu:
            hidden = int(D * cfg.mlp_ratio * 2 / 3)
            hidden = (hidden + 7) // 8 * 8
            self.weights_in = Linear(D, 2 * hidden)
            self.weights_out = Linear(hidden, D)
        else:
            self.fc1 = Linear(D, D * cfg.mlp_ratio)
            self.fc2 = Linear(D * cfg.mlp_ratio, D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("csvit.vit.mlp"):
            return self._mlp(x)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            h1, h2 = self.weights_in(x).chunk(2, dim=-1)
            return self.weights_out(F.silu(h1) * h2)
        return self.fc2(F.gelu(self.fc1(x)))


class Dinov2Layer(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        D = cfg.hidden_size
        self.norm1 = LayerNorm(D, eps=cfg.layer_norm_eps)
        self.attention = ViTAttention(D, cfg.num_attention_heads)
        self.layer_scale1 = _LayerScale(D, cfg.layerscale_value)
        self.norm2 = LayerNorm(D, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(cfg)
        self.layer_scale2 = _LayerScale(D, cfg.layerscale_value)

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        """`fused`: the fused attention and norms (see the module's text)."""
        if not fused:
            x = x + self.layer_scale1(self.attention(self.norm1(x)))
            return x + self.layer_scale2(self.mlp(self.norm2(x)))
        x = x + self.layer_scale1(self._fused_attention(_layer_norm(self.norm1, x)))
        return x + self.layer_scale2(self.mlp(_layer_norm(self.norm2, x)))

    def _fused_attention(self, x: torch.Tensor) -> torch.Tensor:
        sa = self.attention.attention
        B, L, D = x.shape
        H = sa.num_heads
        q, k, v = (lin(x).reshape(B, L, H, D // H).transpose(1, 2)
                   for lin in (sa.query, sa.key, sa.value))
        with annotate("csvit.vit.attn"), sdpa_kernel(_FUSED_BACKENDS):
            o = F.scaled_dot_product_attention(q, k, v)
        return self.attention.output(o.transpose(1, 2).reshape(B, L, D))


def _layer_norm(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``F.layer_norm`` in the promotion of the input and parameter dtypes
    (what :func:`modules.layer_norm` returns), its statistics in f32."""
    dt = torch.promote_types(torch.promote_types(x.dtype, norm.weight.dtype), norm.bias.dtype)
    return F.layer_norm(x.to(dt), norm.normalized_shape, norm.weight.to(dt), norm.bias.to(dt),
                        norm.eps)


class Dinov2Backbone(nn.Module):
    """NHWC images [B,H,W,3] -> layer-normed patches without CLS [B, L, D].

    `attention_impl`: ``"eager"``, ``"fused"`` or ``"auto"`` (the module's
    text). ``forward(x, generator)`` takes the droppath generator as
    SwinV2's does and draws nothing from it: the published DINOv2 models
    fine-tune with ``drop_path_rate`` 0."""

    def __init__(self, config: Dinov2Config, attention_impl: str = "eager"):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"a DINOv2 backbone's attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {attention_impl!r}")
        self.config = config
        self.attention_impl = attention_impl
        self.attn_fused = 0     # attention calls by F.scaled_dot_product_attention
        self.attn_explicit = 0  # attention calls by the explicit softmax
        self.embeddings = _Dinov2Embeddings(config)
        self.encoder = _Layers(Dinov2Layer(config) for _ in range(config.num_hidden_layers))
        self.layernorm = LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fused = self.attention_impl == "fused" or (
            self.attention_impl == "auto" and pixel_values.is_cuda)
        with annotate("csvit.vit.embed"):
            x = self.embeddings(pixel_values)
        for layer in self.encoder.layer:
            x = layer(x, fused)
        n = len(self.encoder.layer)
        if fused:
            self.attn_fused += n
        else:
            self.attn_explicit += n
        return self.layernorm(x)[:, 1:]


def convert_hf_dinov2_state_dict(state_dict, config: Dinov2Config) -> dict:
    """A ``transformers`` ``Dinov2Model`` / ``Dinov2Backbone`` state dict as
    :class:`Dinov2Backbone` takes it: the same names, without a ``dinov2.``
    prefix or the unused ``embeddings.mask_token``."""
    sd = {k[len("dinov2."):] if k.startswith("dinov2.") else k: v
          for k, v in state_dict.items()}
    sd.pop("embeddings.mask_token", None)
    return check_names(sd, lambda: Dinov2Backbone(config), "Dinov2")


__all__ = ["Dinov2Backbone", "Dinov2Config", "Dinov2Layer", "convert_hf_dinov2_state_dict",
           "resize_bicubic"]
