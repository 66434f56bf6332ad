"""The scale/rotation latent group acting on patch tokens (port of
``cs_vit_tpu/models/latent.py``: ``MLP3``,
``ScaleRotComplexEmbedTransformationGroup``, ``compose_sr``).

The group 2D-RoPEs the patch grid, modulates it as ``scale_emb * patches +
angle_emb`` and runs encoder blocks (``sr.N``). The reference's swapped
embedder chains stay on by default (``compat_swap=True``).
``ScaleRotTransformationGroup``, ``ImageLatentTransformerGroup`` and
``compose_hf_cr_hr`` serve TI pretraining only and are not ported here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .modules import ContinuousAngleEmbedding, EncoderBlock, Linear, RoPE2DPositionalEncoding


class MLP3(nn.Sequential):
    """Linear-ReLU-Linear-ReLU-Linear, width-preserving (reference names
    ``0``, ``2``, ``4``)."""

    def __init__(self, dim: int):
        super().__init__(Linear(dim, dim), nn.ReLU(), Linear(dim, dim), nn.ReLU(),
                         Linear(dim, dim))


class ScaleRotComplexEmbedTransformationGroup(nn.Module):
    """RoPE2D + multiplicative/additive scale-angle modulation + encoder
    blocks.

    ``compat_swap=True`` replicates the reference's wiring: the angle
    embedding goes through ``scale_linear`` and the scale embedding through
    ``angle_linear``. ``truncate`` runs only the first ``truncate`` blocks
    (at least one). The blocks' BatchNorms follow ``train``; the Poser runs
    the group on running statistics.
    """

    def __init__(self, num_layers: int = 1, embed_dim: int = 768, num_heads: int = 12,
                 num_p: int = 16, num_q: int = 16, compat_scale: bool = True,
                 compat_swap: bool = True):
        super().__init__()
        self.compat_swap = compat_swap
        self.rope2d = RoPE2DPositionalEncoding(embed_dim, num_p, num_q, 32)
        self.angle_embedder = ContinuousAngleEmbedding(embed_dim, num_freq=32)
        self.scale_embedder = ContinuousAngleEmbedding(embed_dim, num_freq=32)
        self.scale_linear = MLP3(embed_dim)
        self.angle_linear = MLP3(embed_dim)
        self.sr = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, compat_scale) for _ in range(num_layers))

    def forward(self, patches: torch.Tensor, scale_ratio: torch.Tensor,
                angle_rad: torch.Tensor, train: bool = False,
                truncate: Optional[int] = None) -> torch.Tensor:
        """patches [N, num_p * num_q, D], scale_ratio and angle_rad [N]."""
        x = self.rope2d(patches)
        angle_raw = self.angle_embedder(angle_rad)
        scale_raw = self.scale_embedder(scale_ratio)
        if self.compat_swap:
            angle_emb, scale_emb = self.scale_linear(angle_raw), self.angle_linear(scale_raw)
        else:
            angle_emb, scale_emb = self.angle_linear(angle_raw), self.scale_linear(scale_raw)
        x = scale_emb[:, None] * x + angle_emb[:, None]
        n = len(self.sr) if truncate is None else max(1, min(truncate, len(self.sr)))
        for layer in self.sr[:n]:
            x = layer(x, train)
        return x


def compose_sr(s1, r1, s2, r2):
    """Group law of the scale-rotation latent ops: scales multiply, angles add."""
    return s1 * s2, r1 + r2
