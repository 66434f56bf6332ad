"""Transformation-isomorphic (TI) self-supervised pretraining (port of
``cs_vit_tpu/models/ti.py``; ref ``cs_vit/net/ti_vit.py``).

* :class:`TIViT` (ref ``TI_ViT``): a ViT-MAE encoder, an optional MAE
  reconstruction decoder, the latent isomorphism loss between the backbone
  of the transformed image and the transformation group applied to the
  backbone of the image, and the margin :func:`support_loss`.
* :class:`TIDinoViT` (ref ``TI_DinoViT``): a DINOv2 patch encoder.
* TI-DINO (ref ``TI_Dino``): :func:`dino_forward` (the student's DINO loss
  and the TI cross-view terms, with the teacher and the centre),
  :func:`ti_forward` (the TI stage: only the transformation group learns)
  and :func:`update_teacher` (EMA). The teacher is a second
  :class:`TIDinoViT` and the centre a tensor, both handed in.

The random scales and angles are draws handed in: ``draws`` is either a
``torch.Generator`` (:func:`ti_draws` then draws on its device) or the raw
``(normal, uniform)`` pair of shape [B] that the JAX package draws from its
key (``jax.random.normal`` and ``jax.random.uniform`` of the key's two
halves). ``stop_gradient`` is ``torch.no_grad()`` exactly where JAX puts it:
in :func:`dino_forward` the TI term carries no gradient to the student.

In a ``torch.distributed`` world of more than one rank, each holding as
many rows, the functions compute what the JAX package's one program over a
data mesh computes on the global batch: the transformation groups'
BatchNorms take the statistics of every rank's rows, the support loss's
mean token displacement and the DINO centre's mean are means over every
row (``parallel.sync_norm``), and the per-rank loss means become the global
mean once the step averages its grads and losses over the world.

Stage freezing is by parameter name: :func:`dino_stage_mask` trains only the
student's block MLPs (APLA), :func:`ti_stage_mask` all of the
transformation group.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..constants import IMAGENET_MEAN, IMAGENET_STD
from ..ops.resample import scale_rotate_img
from ..parallel.sync_norm import WORLD, sync_batch_norms, world_mean
from .dinov2 import Dinov2Backbone, Dinov2Config
from .latent import ScaleRotComplexEmbedTransformationGroup, ScaleRotTransformationGroup
from .vit import ViTConfig, ViTEncoder, ViTMAEDecoderConfig, ViTMAEDecoderNoMask

Draws = Union[torch.Generator, Tuple[torch.Tensor, torch.Tensor]]


def support_loss(tokens_delta: torch.Tensor, support: float, alpha: float = 1e-3
                 ) -> torch.Tensor:
    """Margin loss keeping the mean token displacement near `support`
    (ref :26-42): quadratic below it, logarithmic above. The mean spans
    every rank's rows in a world of more than one (``world_mean``)."""
    mean_norm = world_mean(torch.linalg.vector_norm(tokens_delta, dim=-1).mean())
    delta = support - mean_norm
    quad = alpha * delta**2
    log_term = -delta * torch.log(torch.clamp(mean_norm / support, min=1e-12))
    return torch.where(delta > -1e-6, quad, log_term)


def ti_draws(batch: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw (normal, uniform) draws of `batch` samples, on the generator's
    device."""
    normal = torch.randn(batch, generator=generator, device=generator.device)
    uniform = torch.rand(batch, generator=generator, device=generator.device)
    return normal, uniform


def scales_and_angles(draws: Draws, batch: int, clip: float, device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale 1 + clip(normal, -clip, clip), angle 2 pi uniform in radians)."""
    normal, uniform = ti_draws(batch, draws) if isinstance(draws, torch.Generator) else draws
    normal, uniform = normal.to(device), uniform.to(device)
    return torch.clamp(normal, -clip, clip) + 1.0, uniform * 2 * math.pi


def _normalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def _degrees(angle_rad: torch.Tensor) -> torch.Tensor:
    return angle_rad / math.pi * 180.0


class TIViT(nn.Module):
    """TI pretraining on a ViT-MAE encoder (ref ``TI_ViT``)."""

    def __init__(self, vit_config: ViTConfig, decoder_config: Optional[ViTMAEDecoderConfig] = None,
                 ti_loss: bool = True, lora_rank: Optional[int] = None,
                 compat_scale: bool = True):
        super().__init__()
        cfg = self.vit_config = vit_config
        self.ti_loss = ti_loss
        self.backbone = ViTEncoder(cfg, lora_rank=lora_rank)
        self.num_p = cfg.image_size // cfg.patch_size
        self.num_patches = self.num_p**2
        self.decoder = (ViTMAEDecoderNoMask(decoder_config, self.num_patches)
                        if decoder_config is not None else None)
        self.trans_grp = ScaleRotTransformationGroup(
            embed_dim=cfg.hidden_size, num_heads=cfg.num_attention_heads,
            compat_scale=compat_scale)
        sync_batch_norms(self.trans_grp, WORLD)
        self.support_distant = math.sqrt(cfg.hidden_size)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images [B,H,W,3] in [0,1] -> patches without CLS [B,L,D] (ref :267-278)."""
        return self.backbone(_normalize_imagenet(images))[:, 1:]

    def forward(self, images: torch.Tensor, train: bool = False, draws: Optional[Draws] = None,
                dropout_generator: Optional[torch.Generator] = None) -> Dict:
        """The losses of `images` [B,H,W,3] in [0,1]. `draws` gives the
        scales and angles (needed with ``ti_loss``); `dropout_generator` the
        LoRA dropout masks in training (None: no dropout)."""
        cfg = self.vit_config
        B = images.shape[0]
        gen = dropout_generator if train else None
        images_norm = _normalize_imagenet(images)
        tokens = self.backbone(images_norm, gen)
        patches_origin = tokens[:, 1:]
        zero = torch.zeros((), device=images.device)

        loss_recons, recons = zero, None
        if self.decoder is not None:
            recons = self.decoder(tokens)  # [B,L,p*p*3]
            p = cfg.patch_size
            target = images_norm.reshape(B, self.num_p, p, self.num_p, p, 3).permute(
                0, 1, 3, 2, 4, 5).reshape(B, self.num_patches, -1)
            loss_recons = torch.mean(torch.abs(recons - target))

        if self.ti_loss:
            if draws is None:
                raise ValueError("TIViT with ti_loss needs `draws` (a generator or the raw draws)")
            scale_coef, angle_rad = scales_and_angles(draws, B, 0.5, images.device)
            images_trans = scale_rotate_img(images_norm, scale_coef, _degrees(angle_rad))
            patches_of_trans = self.backbone(images_trans, gen)[:, 1:]
            trans_patches = self.trans_grp(patches_origin, scale_coef, angle_rad, train=train)
            loss_latent = torch.mean(torch.sum(torch.abs(trans_patches - patches_of_trans), -1))
            loss_support = support_loss(patches_origin - patches_of_trans, self.support_distant)
            loss = loss_latent + 1e-3 * loss_support + loss_recons
        else:
            loss_latent = loss_support = zero
            loss = loss_recons
        return {"loss": loss,
                "logs": {"scalar": {"total": loss, "latent": loss_latent,
                                    "support": loss_support, "recons": loss_recons}},
                "recons": recons}


class TIDinoViT(nn.Module):
    """DINOv2 patch encoder with ImageNet normalisation (ref ``TI_DinoViT``)."""

    def __init__(self, config: Dinov2Config, normalize: bool = True):
        super().__init__()
        self.normalize = normalize
        self.backbone = Dinov2Backbone(config)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.backbone(_normalize_imagenet(images) if self.normalize else images)


class TIDinoTransGroup(nn.Module):
    """TI-DINO's latent group: the complex-embed variant with 6 layers."""

    def __init__(self, embed_dim: int, num_heads: int, num_p: int, compat_scale: bool = True):
        super().__init__()
        self.trans_grp = ScaleRotComplexEmbedTransformationGroup(
            num_layers=6, embed_dim=embed_dim, num_heads=num_heads, num_p=num_p, num_q=num_p,
            compat_scale=compat_scale)
        sync_batch_norms(self.trans_grp, WORLD)

    def forward(self, patches: torch.Tensor, scale_ratio: torch.Tensor, angle_rad: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        return self.trans_grp(patches, scale_ratio, angle_rad, train)


def _transformed_pair(images: torch.Tensor, draws: Draws):
    B = images.shape[0]
    scale_coef, angle_rad = scales_and_angles(draws, B, 0.3, images.device)
    images_trans = scale_rotate_img(images, scale_coef, _degrees(angle_rad))
    return torch.cat([images, images_trans], dim=0), scale_coef, angle_rad


def dino_forward(student: TIDinoViT, teacher: TIDinoViT, trans: TIDinoTransGroup,
                 center: torch.Tensor, images: torch.Tensor, draws: Draws,
                 student_temp: float = 0.1, teacher_temp: float = 0.04,
                 center_momentum: float = 0.9) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """DINO + TI-DINO losses and the centre's EMA (ref ``dino_forward``
    :410-512): (loss, scalar logs, new centre [L, D]). Only the student's
    forward on the two views records a graph; the teacher and the TI
    cross-view terms run without autograd, as JAX stops their gradient."""
    B = images.shape[0]
    images_input, scale_coef, angle_rad = _transformed_pair(images, draws)
    student_out = student(images_input)
    with torch.no_grad():
        s_out_1 = trans(student_out[:B], scale_coef, angle_rad)
        s_out_2 = trans(student_out[B:], 1.0 / scale_coef, -angle_rad)
        teacher_out = teacher(images_input)
    t1, t2 = teacher_out[:B], teacher_out[B:]

    def ce(teacher_logits, student_logits):
        t = torch.softmax((teacher_logits - center[None]) / teacher_temp, dim=-1)
        ls = torch.log_softmax(student_logits / student_temp, dim=-1)
        return torch.mean(torch.sum(-t * ls, dim=-1))

    loss_dino = ce(t1, student_out[:B])
    loss_ti = ce(t1, s_out_2) + ce(t2, s_out_1)
    loss = loss_dino + 0.5 * loss_ti
    new_center = (center * center_momentum
                  + world_mean(teacher_out.mean(0)) * (1 - center_momentum))
    return loss, {"total": loss, "dino": loss_dino, "ti": loss_ti}, new_center


@contextlib.contextmanager
def _stats_kept(module: nn.Module):
    """Restore `module`'s BatchNorm running statistics on exit (JAX's
    ``mutable=["batch_stats"]`` whose update is dropped)."""
    saved = {n: b.clone() for n, b in module.named_buffers() if n.endswith(
        ("running_mean", "running_var"))}
    try:
        yield
    finally:
        with torch.no_grad():
            for n, b in saved.items():
                module.get_buffer(n).copy_(b)


def ti_forward(teacher: TIDinoViT, trans: TIDinoTransGroup, images: torch.Tensor,
               draws: Draws, teacher_temp: float = 0.04) -> Tuple[torch.Tensor, Dict]:
    """The TI stage (ref ``ti_foward`` :514-570): the group maps each view's
    teacher patches onto the other's, with BatchNorm on the batch's
    statistics and the running statistics left as they were; only the group
    records a graph."""
    B = images.shape[0]
    images_input, scale_coef, angle_rad = _transformed_pair(images, draws)
    with torch.no_grad():
        teacher_out = teacher(images_input)
    t1, t2 = teacher_out[:B], teacher_out[B:]
    with _stats_kept(trans):
        t1_to_2 = trans(t1, scale_coef, angle_rad, train=True)
        t2_to_1 = trans(t2, 1.0 / scale_coef, -angle_rad, train=True)

    def ce(t, s):
        return torch.mean(torch.sum(-torch.softmax(t / teacher_temp, dim=-1)
                                    * torch.log_softmax(s / teacher_temp, dim=-1), dim=-1))

    loss_ti = ce(t1, t2_to_1) + ce(t2, t1_to_2)
    return loss_ti, {"total": loss_ti, "ti": loss_ti}


@torch.no_grad()
def update_teacher(teacher: nn.Module, student: nn.Module, momentum: float) -> None:
    """EMA teacher update in place (ref :572-575): t <- t m + (1 - m) s."""
    students = dict(student.named_parameters())
    for name, t in teacher.named_parameters():
        t.copy_(t * momentum + (1 - momentum) * students[name])


def dino_stage_mask(name: str) -> bool:
    """APLA (ref ``init_apla`` :381-386): only the MLP leaves of each block
    (``fc1``/``fc2``, or ``weights_in``/``weights_out``) train."""
    return any(part in ("fc1", "fc2", "weights_in", "weights_out") for part in name.split("."))


def ti_stage_mask(name: str) -> bool:
    """Everything in the transformation group trains in the TI stage."""
    return True


@torch.no_grad()
def init_ti_weights(module: nn.Module, seed: int) -> None:
    """Seeded random weights with the JAX package's initialiser families:
    N(0, 0.02) clipped at 2 sigma for the CLS token and position tables,
    LeCun-normal kernels, zero biases and LoRA ``B``, unit norm scales and
    LayerScales, N(0, 1) RoPE2D radial embeddings, and the log-spaced
    ``freq_base`` of the angle embedders. Draws come from one CPU generator
    in parameter order, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("cls_token", "position_embeddings"):
            value = torch.clamp(torch.randn(p.shape, generator=gen) * 0.02, -0.04, 0.04)
        elif leaf == "freq_base":
            value = torch.from_numpy(np.logspace(0, 1, p.shape[0], base=10.0).astype(np.float32))
        elif name.endswith("rope2d.embedding"):
            value = torch.randn(p.shape, generator=gen)
        elif leaf in ("bias", "lora_B", "in_proj_bias"):
            value = torch.zeros(p.shape)
        elif p.dim() == 1:  # LayerNorm / BatchNorm scale, LayerScale
            value = torch.ones(p.shape)
        else:  # Linear [out, in], Conv [out, in, kh, kw], LoRA A [r, in]
            fan_in = int(np.prod(p.shape[1:]))
            value = torch.randn(p.shape, generator=gen) * fan_in ** -0.5
        p.copy_(value.to(p.dtype))
