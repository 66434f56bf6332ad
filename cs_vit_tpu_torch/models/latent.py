"""Latent transformation groups acting on patch tokens (port of
``cs_vit_tpu/models/latent.py``).

* :class:`ScaleRotComplexEmbedTransformationGroup`, the Poser's latent group
  and TI-DINO's: it 2D-RoPEs the patch grid, modulates it as ``scale_emb *
  patches + angle_emb`` and runs encoder blocks (``sr.N``). The reference's
  swapped embedder chains stay on by default (``compat_swap=True``).
* :class:`ScaleRotTransformationGroup`, TI-ViT's: scale and angle embedding
  tokens prepended to the patches, encoder blocks, the two tokens stripped.
* :class:`ImageLatentTransformerGroup`, the legacy {flip, rotation,
  flip+rotation} group, and its composition law :func:`compose_hf_cr_hr`.
* :func:`compose_sr`, the scale-rotation group law.

Each group's encoder blocks take ``train``: BatchNorm on the batch's
statistics (moving the running ones) or on the running ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


class ScaleRotTransformationGroup(nn.Module):
    """Token-prepend variant (ref ``latent_transformers.py:166-245``):
    ``[scale_emb, angle_emb, patches]`` -> encoder blocks ``sr.N`` -> the
    two tokens stripped. Group law: ``compose_sr``."""

    def __init__(self, num_layers: int = 1, embed_dim: int = 768, num_heads: int = 12,
                 compat_scale: bool = True):
        super().__init__()
        self.angle_embedder = ContinuousAngleEmbedding(embed_dim, num_freq=32)
        self.scale_embedder = ContinuousAngleEmbedding(embed_dim, num_freq=32)
        self.sr = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, compat_scale) for _ in range(num_layers))

    def forward(self, patches: torch.Tensor, scale_ratio: torch.Tensor,
                angle_rad: torch.Tensor, train: bool = False) -> torch.Tensor:
        """patches [N, L, D], scale_ratio and angle_rad [N]."""
        angle_emb = self.angle_embedder(angle_rad)
        scale_emb = self.scale_embedder(scale_ratio)
        x = torch.cat([scale_emb[:, None].to(patches.dtype), angle_emb[:, None].to(patches.dtype),
                       patches], dim=1)
        for layer in self.sr:
            x = layer(x, train)
        return x[:, 2:]


class ImageLatentTransformerGroup(nn.Module):
    """Legacy latent group {horizontal flip, centre rotation, flip +
    rotation} (ref ``latent_transformers.py:11-163``): each op is a stack of
    encoder blocks (``hf.N``, ``cr.N``, ``hr.N``); the rotation ops prepend
    an angle-embedding token and strip it after."""

    def __init__(self, num_layers: int = 1, embed_dim: int = 768, num_heads: int = 12,
                 compat_scale: bool = True):
        super().__init__()
        self.angle_embedder = ContinuousAngleEmbedding(embed_dim, num_freq=32)
        for op in ("hf", "cr", "hr"):
            setattr(self, op, nn.ModuleList(
                EncoderBlock(embed_dim, num_heads, compat_scale) for _ in range(num_layers)))

    @staticmethod
    def _run(layers, x, train):
        for layer in layers:
            x = layer(x, train)
        return x

    def do_hf(self, patches: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self._run(self.hf, patches, train)

    def _rotated(self, layers, patches, angle_rad, train):
        if angle_rad is None:
            angle_rad = torch.zeros(patches.shape[0], dtype=patches.dtype, device=patches.device)
        emb = self.angle_embedder(angle_rad)
        x = torch.cat([emb[:, None].to(patches.dtype), patches], dim=1)
        return self._run(layers, x, train)[:, 1:]

    def do_cr(self, patches: torch.Tensor, angle_rad: Optional[torch.Tensor] = None,
              train: bool = False) -> torch.Tensor:
        return self._rotated(self.cr, patches, angle_rad, train)

    def do_hr(self, patches: torch.Tensor, angle_rad: Optional[torch.Tensor] = None,
              train: bool = False) -> torch.Tensor:
        return self._rotated(self.hr, patches, angle_rad, train)

    def forward(self, patches: torch.Tensor, angle_rad: Optional[torch.Tensor] = None,
                op: str = "cr", train: bool = False) -> torch.Tensor:
        if op == "hf":
            return self.do_hf(patches, train)
        return {"cr": self.do_cr, "hr": self.do_hr}[op](patches, angle_rad, train)


# Composition law of the legacy group (ref `latent_transformers.py:43-53`):
# (first op, second op) -> (result op, factor of angle 1, factor of angle 2).
_HF_CR_HR_LAW = {
    ("hf", "hf"): ("cr", 0, 0),
    ("hf", "cr"): ("hr", 0, 1),
    ("hf", "hr"): ("cr", 0, 1),
    ("cr", "hf"): ("hr", -1, 0),
    ("cr", "cr"): ("cr", 1, 1),
    ("cr", "hr"): ("hr", -1, 1),
    ("hr", "hf"): ("cr", -1, 0),
    ("hr", "cr"): ("hr", 1, 1),
    ("hr", "hr"): ("cr", -1, 1),
}


def compose_hf_cr_hr(op1: str, angle1, op2: str, angle2) -> Tuple[str, object]:
    """Compose two legacy latent ops -> (op, angle); None for no angles."""
    result_op, f1, f2 = _HF_CR_HR_LAW[(op1, op2)]
    if angle1 is None and angle2 is None:
        return result_op, None
    a1 = 0.0 if angle1 is None else f1 * angle1
    a2 = 0.0 if angle2 is None else f2 * angle2
    return result_op, a1 + a2
