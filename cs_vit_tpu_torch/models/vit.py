"""ViT encoder (MAE-style, CLS token) and the ViT-MAE decoder without masking,
with LoRA (port of ``cs_vit_tpu/models/vit.py``).

* :class:`ViTEncoder` is ``transformers.ViTModel`` without its pooler, under
  HF's module names (``embeddings.*``, ``encoder.layer.N.*``,
  ``layernorm``), so an HF ViT state dict loads with ``strict=True``:
  :func:`convert_hf_vit_state_dict` only strips a ``vit.`` prefix and
  checks the names.
* :class:`ViTMAEDecoderNoMask` is HF's ``ViTMAEDecoder`` with the masking
  taken out (ref ``transformer_module.py:383-519``), under its names
  (``decoder_embed``, ``decoder_layers.N.*``, ``decoder_norm``,
  ``decoder_pred``), with the fixed 2D sin-cos position table.
* :class:`LoRADense` adds peft's ``(alpha / r) * B A`` delta to a Linear on
  q, k and v (ref ``ti_vit.py:51-95``); :func:`merge_lora_params` folds the
  deltas into the weights (peft ``merge_and_unload``).

Images come in NHWC, as in the JAX package; the norms have flax's numerics
(``modules.layer_norm``), the attention is plain matmuls with a 1/sqrt(d_h)
softmax and the MLP an exact GELU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .modules import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class ViTMAEDecoderConfig:
    hidden_size: int = 768           # encoder width feeding the decoder
    decoder_hidden_size: int = 512
    decoder_num_hidden_layers: int = 8
    decoder_num_attention_heads: int = 16
    decoder_intermediate_size: int = 2048
    patch_size: int = 16
    num_channels: int = 3
    layer_norm_eps: float = 1e-12


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, add_cls_token: bool = False
                            ) -> np.ndarray:
    """Fixed 2D sin-cos position table (MAE convention), f32 numpy."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first (MAE convention)
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float32) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    pos = np.concatenate([emb_h, emb_w], axis=1)
    if add_cls_token:
        pos = np.concatenate([np.zeros([1, embed_dim]), pos], axis=0)
    return pos.astype(np.float32)


class LoRADense(Linear):
    """``y = x W^T + b + (alpha / r) (dropout(x) A^T) B^T`` with peft's layout:
    ``lora_A`` [r, in], ``lora_B`` [out, r] (zeros at init, so the delta
    starts at 0). Dropout on the LoRA input runs only when a generator is
    handed in, drawing its masks from it; without LoRA this is a Linear."""

    def __init__(self, in_features: int, out_features: int, lora_rank: Optional[int] = None,
                 lora_alpha: float = 32.0, lora_dropout: float = 0.1):
        super().__init__(in_features, out_features)
        self.lora_rank, self.lora_alpha, self.lora_dropout = lora_rank, lora_alpha, lora_dropout
        if lora_rank:
            self.lora_A = nn.Parameter(torch.empty(lora_rank, in_features))
            self.lora_B = nn.Parameter(torch.zeros(out_features, lora_rank))
            nn.init.kaiming_uniform_(self.lora_A, a=math.sqrt(5))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        y = super().forward(x)
        if not self.lora_rank:
            return y
        h = x
        if generator is not None and self.lora_dropout > 0:
            keep = 1.0 - self.lora_dropout
            mask = torch.bernoulli(torch.full(x.shape, keep, device=generator.device),
                                   generator=generator).to(x.device, x.dtype)
            h = x * mask / keep
        return y + (self.lora_alpha / self.lora_rank) * (h @ self.lora_A.T @ self.lora_B.T)


def merge_lora_params(state_dict: Mapping[str, torch.Tensor], lora_alpha: float = 32.0
                      ) -> Dict[str, torch.Tensor]:
    """Fold every ``{weight, lora_A, lora_B}`` triple into its weight (peft
    ``merge_and_unload``): the result loads into the model built without
    LoRA."""
    out = dict(state_dict)
    for key in list(state_dict):
        if key.endswith(".lora_A"):
            prefix = key[: -len("lora_A")]
            A, B = out.pop(prefix + "lora_A"), out.pop(prefix + "lora_B")
            out[prefix + "weight"] = state_dict[prefix + "weight"] + (lora_alpha / A.shape[0]) * (
                B @ A)
    return out


class _Dense(nn.Module):
    """A Linear held as ``.dense`` (HF's ``*.output.dense`` / ``intermediate.dense``)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.dense = Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class ViTSelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, lora_rank: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.query = LoRADense(hidden_size, hidden_size, lora_rank)
        self.key = LoRADense(hidden_size, hidden_size, lora_rank)
        self.value = LoRADense(hidden_size, hidden_size, lora_rank)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H

        def heads(t):
            return t.reshape(B, L, H, hd).transpose(1, 2)

        q = heads(self.query(x, generator))
        k = heads(self.key(x, generator))
        v = heads(self.value(x, generator))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        return (attn @ v).transpose(1, 2).reshape(B, L, D)


class ViTAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, lora_rank: Optional[int] = None):
        super().__init__()
        self.attention = ViTSelfAttention(hidden_size, num_heads, lora_rank)
        self.output = _Dense(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.output(self.attention(x, generator))


class ViTLayer(nn.Module):
    """Pre-norm transformer block (HF ``ViTLayer``)."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 eps: float = 1e-12, lora_rank: Optional[int] = None):
        super().__init__()
        self.attention = ViTAttention(hidden_size, num_heads, lora_rank)
        self.intermediate = _Dense(hidden_size, intermediate_size)
        self.output = _Dense(intermediate_size, hidden_size)
        self.layernorm_before = LayerNorm(hidden_size, eps=eps)
        self.layernorm_after = LayerNorm(hidden_size, eps=eps)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x), generator)
        return x + self.output(F.gelu(self.intermediate(self.layernorm_after(x))))


class _PatchEmbeddings(nn.Module):
    def __init__(self, num_channels: int, hidden_size: int, patch_size: int):
        super().__init__()
        self.projection = nn.Conv2d(num_channels, hidden_size, patch_size, stride=patch_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """NHWC images -> [B, h*w, D] patch tokens (row-major grid)."""
        x = self.projection(pixel_values.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


class _ViTEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, cfg.num_patches + 1,
                                                            cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg.num_channels, cfg.hidden_size,
                                                 cfg.patch_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embeddings(pixel_values)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class ViTEncoder(nn.Module):
    """HF ``ViTModel`` without the pooler: NHWC images [B,H,W,3] -> tokens
    [B, 1+L, D]. `generator` draws the LoRA dropout masks (None: none)."""

    def __init__(self, config: ViTConfig, lora_rank: Optional[int] = None):
        super().__init__()
        cfg = self.config = config
        self.embeddings = _ViTEmbeddings(cfg)
        self.encoder = _Layers(
            ViTLayer(cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
                     cfg.layer_norm_eps, lora_rank) for _ in range(cfg.num_hidden_layers))
        self.layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.embeddings(pixel_values)
        for layer in self.encoder.layer:
            x = layer(x, generator)
        return self.layernorm(x)


class ViTMAEDecoderNoMask(nn.Module):
    """MAE decoder without mask shuffling: tokens [B, 1+L, D_enc] -> per-patch
    pixels [B, L, p*p*C]. The sin-cos table is a fixed, non-persistent
    buffer."""

    def __init__(self, config: ViTMAEDecoderConfig, num_patches: int):
        super().__init__()
        cfg = self.config = config
        self.decoder_embed = Linear(cfg.hidden_size, cfg.decoder_hidden_size)
        pos = get_2d_sincos_pos_embed(cfg.decoder_hidden_size, int(num_patches**0.5),
                                      add_cls_token=True)
        self.register_buffer("decoder_pos_embed", torch.from_numpy(pos)[None], persistent=False)
        self.decoder_layers = nn.ModuleList(
            ViTLayer(cfg.decoder_hidden_size, cfg.decoder_num_attention_heads,
                     cfg.decoder_intermediate_size, cfg.layer_norm_eps)
            for _ in range(cfg.decoder_num_hidden_layers))
        self.decoder_norm = LayerNorm(cfg.decoder_hidden_size, eps=cfg.layer_norm_eps)
        self.decoder_pred = Linear(cfg.decoder_hidden_size, cfg.patch_size**2 * cfg.num_channels)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.decoder_embed(tokens) + self.decoder_pos_embed
        for layer in self.decoder_layers:
            x = layer(x)
        return self.decoder_pred(self.decoder_norm(x))[:, 1:]  # strip CLS


def _strip(state_dict: Mapping, prefix: str) -> Dict:
    return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in state_dict.items()}


def check_names(sd: Mapping, build, what: str) -> Dict:
    """`sd` as a dict, after checking that its names are those of the module
    `build()` makes (built without storage)."""
    with torch.device("meta"):
        want = set(build().state_dict())
    if set(sd) != want:
        raise KeyError(f"not a {what} state dict: missing {sorted(want - set(sd))[:5]}, "
                       f"unexpected {sorted(set(sd) - want)[:5]}")
    return dict(sd)


def convert_hf_vit_state_dict(state_dict: Mapping, config: ViTConfig) -> Dict:
    """A ``transformers.ViTModel`` state dict as :class:`ViTEncoder` takes it:
    the same names, without a ``vit.`` prefix or the pooler."""
    sd = {k: v for k, v in _strip(state_dict, "vit.").items() if not k.startswith("pooler.")}
    return check_names(sd, lambda: ViTEncoder(config), "ViTModel")


def convert_hf_mae_decoder_state_dict(state_dict: Mapping, config: ViTMAEDecoderConfig,
                                      num_patches: int) -> Dict:
    """An HF ``ViTMAEDecoder`` state dict as :class:`ViTMAEDecoderNoMask`
    takes it: the same names without a ``decoder.`` prefix, without the
    unused ``mask_token``, and without ``decoder_pos_embed``, which must be
    the fixed sin-cos table."""
    sd = _strip(state_dict, "decoder.")
    sd.pop("mask_token", None)
    pos = sd.pop("decoder_pos_embed", None)
    if pos is not None:
        want = get_2d_sincos_pos_embed(config.decoder_hidden_size, int(num_patches**0.5),
                                       add_cls_token=True)
        np.testing.assert_allclose(np.asarray(pos).reshape(-1), want.reshape(-1), atol=1e-6,
                                   err_msg="decoder_pos_embed")
    return check_names(sd, lambda: ViTMAEDecoderNoMask(config, num_patches), "ViTMAEDecoder")
