"""Poser: camera-space MANO hand poser on a SwinV2 or a DINOv2 backbone.

Port of ``cs_vit_tpu/models/poser.py``: ImageNet normalisation, the SwinV2
backbone (or a DINOv2 one, ``backbone="dinov2-*"``: the heads then run at
its width, over its patches without the CLS token), the perspective input
(the dense ray grid or the sparse bbox corners) and its encoder, which
decorates the queries or the patches, the latent group's doubling of the
batch, the spatial encoder of either type, the temporal encoders in both
forms (``"full"``: every frame, absolute PE
and encoder blocks, also at T=1; ``"realtime"``: the last frame only,
continuous-time RoPE and cross-attention decoders), the pose/shape/root
heads, 6D -> axis-angle, the un-rotation of the latent half, the
``"orientation"`` re-positioning and MANO FK to camera-space joints in mm;
:meth:`Poser.forward` adds the training losses (:meth:`Poser.criterion`),
on both halves with the latent group.

With ``num_latent_layer`` set, each sample's patches are also transformed
by a random scale and rotation (:func:`latent_draws`, from the
``latent_generator`` argument, a ``torch.Generator`` apart from the
droppath one) through the frozen latent group on running statistics;
everything after the backbone then runs at 2B rows, the origin half first.
The backbone runs once, at B.

The phase is an argument, as in the JAX package, not module state:
``"spatial"`` runs the backbone with droppath (drawn from the
``torch.Generator`` passed in), the perspective encoder and the spatial
encoder with BatchNorm batch statistics, and skips the temporal encoders;
``"temporal"`` runs the backbone, the perspective encoder and the spatial
encoder under ``torch.no_grad()`` (what JAX's ``stop_gradient`` above them
amounts to: no autograd graph and no saved activations there) and the
temporal encoders' BatchNorms on batch statistics; ``"inference"`` uses running statistics and
no droppath, whatever ``nn.Module.training`` says.
:func:`phase_trainable_params` gives the parameters each phase trains.

Module names follow the reference state dict (``backbone.*`` in HF Swinv2
names, ``perspective_mlp.layer.N``, ``spatial_encoder.layers.N.*``,
``*_temporal_encoder.layers.N.*``, ``*_decoder.0``, ``latent_trans.*``), which is what
``cs_vit_tpu/train/convert.py:export_poser_state_dict`` emits.

The dtype flow is the JAX package's: images are normalised in f32 and cast
back to the activation dtype, and the perspective bias (computed in f32 from
f32 rays) is cast to the patch dtype before it decorates the queries or the
patches; where JAX promotes mixed dtypes (the latent half, the orientation
turn) the port promotes likewise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..constants import IMAGENET_MEAN, IMAGENET_STD, TARGET_JOINTS_CONNECTION
from ..core.geometry import (
    axis_angle_to_matrix,
    matrix_to_axis_angle,
    rotation_6d_to_matrix,
    rotation_matrix_x,
    rotation_matrix_y,
    safe_norm,
)
from ..core.joints import mean_connection_length
from ..mano.layer import ManoLayer
from .latent import ScaleRotComplexEmbedTransformationGroup
from .modules import (
    CrossAttnDecoder,
    DecoderBlock,
    EncoderBlock,
    Linear,
    PositionalEncoding,
    TorchBatchNorm,
)
from .dinov2 import Dinov2Backbone, Dinov2Config
from .swinv2 import SwinV2, SwinV2Config, swinv2_base_256, swinv2_tiny_256

PHASES = ("spatial", "temporal", "inference")

# the published DINOv2 backbones (facebook/dinov2-{size}): width, layers,
# heads and MLP; "dinov2-<size>-<patch>" names one (patch 14 as published)
DINOV2_SIZES = {
    "small": dict(hidden_size=384, num_hidden_layers=12, num_attention_heads=6),
    "base": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12),
    "large": dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16),
    "giant": dict(hidden_size=1536, num_hidden_layers=40, num_attention_heads=24,
                  use_swiglu_ffn=True),
}


@dataclasses.dataclass(frozen=True)
class PoserConfig:
    """Static architecture knobs (reference ``Poser.__init__`` args), with
    the JAX ``PoserConfig``'s rules: the latent group needs patch
    decoration."""

    backbone: str = "swinv2-tiny-256"
    num_pose_query: int = 16
    num_spatial_layer: int = 6
    spatial_layer_type: str = "decoder"     # "decoder" | "encoder"
    num_temporal_layer: int = 2
    temporal_init_method: str = "zero"      # "zero" | "random"
    expansion_ratio: float = 1.25           # carried, never read (as in JAX)
    temporal_supervision: str = "full"      # "full" | "realtime"
    trope_scalar: float = 20.0
    num_latent_layer: Optional[int] = None
    persp_embed_method: str = "dense"       # "dense" | "sparse"
    persp_decorate: str = "query"           # "query" | "patch"
    image_size: int = 256
    global_positioning: str = "direct"      # "direct" | "orientation"
    compat_scale: bool = True               # MHA sqrt(d_h)-multiply quirk
    compat_swap: bool = True                # latent embedder swap quirk
    custom_swin: Optional[SwinV2Config] = None
    attention_impl: str = "auto"            # "auto" | "eager" | "fused" | "pallas" | "hybrid"
    remat: bool = False                     # recompute backbone blocks in the backward
    custom_dinov2: Optional[Dinov2Config] = None

    def __post_init__(self):
        choices = {
            "spatial_layer_type": ("decoder", "encoder"),
            "temporal_init_method": ("zero", "random"),
            "temporal_supervision": ("full", "realtime"),
            "persp_embed_method": ("dense", "sparse"),
            "persp_decorate": ("query", "patch"),
            "global_positioning": ("direct", "orientation"),
        }
        for name, allowed in choices.items():
            if getattr(self, name) not in allowed:
                raise ValueError(f"PoserConfig.{name} must be one of {allowed}, "
                                 f"got {getattr(self, name)!r}")
        if self.num_latent_layer is not None and self.persp_decorate != "patch":
            raise ValueError("the latent group requires persp_decorate='patch' "
                             "(reference ti_poser.py:213-215)")
        if self.dinov2:
            for name, unsupported in (("remat", self.remat),
                                      ("num_latent_layer", self.num_latent_layer is not None),
                                      ("attention_impl", self.attention_impl in ("pallas",
                                                                                 "hybrid"))):
                if unsupported:
                    raise ValueError(f"a DINOv2 backbone does not take {name}="
                                     f"{getattr(self, name)!r}")
            self.dinov2_config()

    @property
    def dinov2(self) -> bool:
        """Whether the backbone is a DINOv2 one."""
        return self.custom_dinov2 is not None or self.backbone.lower().startswith("dinov2")

    def dinov2_config(self) -> Dinov2Config:
        """The DINOv2 backbone: ``custom_dinov2``, or the published model
        ``dinov2-<size>-<patch>`` names (its 518-px position table, LayerNorm
        eps 1e-6, LayerScale 1.0; SwiGLU for ``giant``)."""
        if self.custom_dinov2 is not None:
            return self.custom_dinov2
        parts = self.backbone.lower().split("-")
        if len(parts) != 3 or parts[1] not in DINOV2_SIZES or not parts[2].isdigit():
            raise ValueError(f"unknown backbone spec: {self.backbone} (DINOv2 names are "
                             f"dinov2-<{'|'.join(DINOV2_SIZES)}>-<patch>)")
        return Dinov2Config(patch_size=int(parts[2]), **DINOV2_SIZES[parts[1]])

    def swin_config(self) -> SwinV2Config:
        if self.custom_swin is not None:
            return self.custom_swin
        name = self.backbone.lower()
        if "base" in name:
            return swinv2_base_256(image_size=self.image_size, remat=self.remat)
        if "tiny" in name:
            return swinv2_tiny_256(image_size=self.image_size, remat=self.remat)
        if "test" in name:  # minimal arch for smoke tests / CI
            return SwinV2Config(
                image_size=self.image_size, embed_dim=8, depths=(1, 1),
                num_heads=(2, 2), window_size=4, drop_path_rate=0.0,
                pretrained_window_sizes=(0, 0), remat=self.remat,
            )
        raise ValueError(f"unknown backbone spec: {self.backbone}")

    @property
    def hidden_dim(self) -> int:
        if self.dinov2:
            return self.dinov2_config().hidden_size
        return self.swin_config().num_features

    @property
    def num_heads(self) -> int:
        if self.dinov2:
            return self.dinov2_config().num_attention_heads
        return self.swin_config().num_heads[-1]

    @property
    def num_p(self) -> int:
        """Patch tokens per side of the backbone's last stage."""
        if self.dinov2:
            return self.image_size // self.dinov2_config().patch_size
        sw = self.swin_config()
        return self.image_size // (sw.patch_size * 2 ** (sw.num_layers - 1))


class PerspectiveEncoder(nn.Module):
    """proj -> 3x[BN -> Linear -> ReLU] -> Linear (reference ``layer.0..9``)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.proj = Linear(in_dim, embed_dim)
        layers = []
        for _ in range(3):
            layers += [TorchBatchNorm(embed_dim), Linear(embed_dim, embed_dim), nn.ReLU()]
        self.layer = nn.Sequential(*layers, Linear(embed_dim, embed_dim))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.proj(x)
        for layer in self.layer:
            y = layer(y, train) if isinstance(layer, TorchBatchNorm) else layer(y)
        return y


class SpatialEncoder(nn.Module):
    """Query/patch fusion.

    ``layer_type="decoder"``: the query tokens attend to the patch tokens
    through chained decoder blocks. ``"encoder"``: encoder blocks over
    ``[query | patches]`` with the reference's ``x_embeb`` quirk: the layers
    do not chain, each consumes the same PE'd input and only the last
    layer's output survives, cut to the query tokens. Every layer still runs
    (its BatchNorm statistics move in training), and layers 0..n-2 get no
    gradient.
    """

    def __init__(self, embed_dim: int, num_heads: int, num_layer: int,
                 layer_type: str = "decoder", compat_scale: bool = True):
        super().__init__()
        self.layer_type = layer_type
        self.pe_spatial = PositionalEncoding(embed_dim)
        block = DecoderBlock if layer_type == "decoder" else EncoderBlock
        self.layers = nn.ModuleList(
            block(embed_dim, num_heads, compat_scale) for _ in range(num_layer)
        )

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.layer_type == "decoder":
            y = self.pe_spatial(x)
            for layer in self.layers:
                y = layer(y, ctx, train)
            return y
        y0 = self.pe_spatial(torch.cat([x, ctx], dim=1))  # promotes, as jnp.concatenate
        y = y0
        for layer in self.layers:
            y = layer(y0, train)
        return y[:, : x.shape[1]]


class TemporalEncoder(nn.Module):
    """Cross-frame fusion, then the (zero-initialised) ``zero_conv``
    projection; the caller adds the residual.

    ``target="full"``: absolute PE + encoder blocks over T, [B,T,D] out.
    ``target="realtime"``: continuous-time RoPE at ``timestamp /
    trope_scalar`` (no parameters), then cross-attention decoders whose query
    is the last frame, [B,1,D] out.
    """

    def __init__(self, embed_dim: int, num_heads: int, num_layer: int,
                 target: str = "full", trope_scalar: float = 20.0,
                 compat_scale: bool = True):
        super().__init__()
        self.target, self.trope_scalar = target, trope_scalar
        if target == "realtime":
            self.pe_temporal = PositionalEncoding(embed_dim, mode="trope")
            block = CrossAttnDecoder
        else:
            self.pe_temporal = PositionalEncoding(embed_dim)
            block = EncoderBlock
        self.layers = nn.ModuleList(
            block(embed_dim, num_heads, compat_scale) for _ in range(num_layer)
        )
        self.zero_conv = Linear(embed_dim, embed_dim, bias=False)

    def forward(self, x: torch.Tensor, timestamp: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if self.target == "realtime":
            if timestamp is None:
                raise ValueError("the realtime temporal encoder needs timestamps")
            x_seq = self.pe_temporal(x, timestamp / self.trope_scalar)
            y = x_seq[:, -1:]
            for layer in self.layers:
                y = layer(y, x_seq, train)
            return self.zero_conv(y)
        y = self.pe_temporal(x)
        for layer in self.layers:
            y = layer(y, train)
        return self.zero_conv(y)


def sample_persp_dir_vec(
    num_sample: int,
    bbox: torch.Tensor,     # [B,T,4] xyxy
    focal: torch.Tensor,    # [B,T,2]
    princpt: torch.Tensor,  # [B,T,2]
) -> torch.Tensor:
    """Dense perspective ray-direction grid, [B,T,p,p,2]."""
    p = num_sample
    grid = torch.linspace(0.5 / p, 1 - 0.5 / p, p, dtype=bbox.dtype, device=bbox.device)
    x_grid = bbox[:, :, 0:1] + (bbox[:, :, 2:3] - bbox[:, :, 0:1]) * grid
    y_grid = bbox[:, :, 1:2] + (bbox[:, :, 3:4] - bbox[:, :, 1:2]) * grid
    gx = x_grid[:, :, :, None].expand(*x_grid.shape, p)
    gy = y_grid[:, :, None, :].expand(*y_grid.shape[:2], p, p)
    g = torch.stack([gx, gy], dim=-1)                            # [B,T,p,p,2]
    directions = (g - princpt[:, :, None, None]) / focal[:, :, None, None]
    d3 = torch.cat([directions, torch.ones_like(directions[..., :1])], dim=-1)
    d3 = d3 / torch.linalg.vector_norm(d3, dim=-1, keepdim=True)
    return d3[..., :2]


def sparse_corner_coords(
    bbox: torch.Tensor,     # [B,T,4] xyxy
    focal: torch.Tensor,    # [B,T,2]
    princpt: torch.Tensor,  # [B,T,2]
) -> torch.Tensor:
    """Normalised bbox-corner coordinates, [B,T,2,2,2]: rows (top, bottom),
    columns (left, right), (u, v) last."""
    um = (bbox[:, :, 0] - princpt[:, :, 0]) / focal[:, :, 0]
    uM = (bbox[:, :, 2] - princpt[:, :, 0]) / focal[:, :, 0]
    vm = (bbox[:, :, 1] - princpt[:, :, 1]) / focal[:, :, 1]
    vM = (bbox[:, :, 3] - princpt[:, :, 1]) / focal[:, :, 1]
    top = torch.stack([torch.stack([um, vm], -1), torch.stack([uM, vm], -1)], dim=2)
    bottom = torch.stack([torch.stack([um, vM], -1), torch.stack([uM, vM], -1)], dim=2)
    return torch.stack([top, bottom], dim=2)


def latent_draws(batch: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent group's raw draws for `batch` samples, on the generator's
    device: (standard normal [batch], uniform [0, 1) [batch]). The JAX Poser
    draws them from its ``"latent"`` rng as ``normal(k1, (B,))`` and
    ``uniform(k2, (B,))``; the streams differ, so parity tests pin both."""
    normal = torch.randn(batch, generator=generator, device=generator.device)
    uniform = torch.rand(batch, generator=generator, device=generator.device)
    return normal, uniform


def derivative(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Central finite difference along `dim` (needs at least 3 frames)."""
    n = x.shape[dim]
    if n < 3:
        raise ValueError("derivative needs >=3 frames along the time axis")
    return (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2.0


class Poser(nn.Module):
    """Camera-space hand poser."""

    def __init__(self, config: PoserConfig, mano: ManoLayer, j_regressor: np.ndarray):
        super().__init__()
        cfg = self.config = config
        D = cfg.hidden_dim
        if cfg.dinov2:
            self.backbone = Dinov2Backbone(cfg.dinov2_config(), cfg.attention_impl)
        else:
            self.backbone = SwinV2(cfg.swin_config(), attention_impl=cfg.attention_impl)
        self.latent_trans = None
        if cfg.num_latent_layer is not None:
            self.latent_trans = ScaleRotComplexEmbedTransformationGroup(
                cfg.num_latent_layer, D, cfg.num_heads, cfg.num_p, cfg.num_p,
                cfg.compat_scale, cfg.compat_swap,
            )
        self.query_token = nn.Parameter(torch.zeros(3, D))
        persp_in = 16 * 16 * 2 if cfg.persp_embed_method == "dense" else 2 * 2 * 2
        self.perspective_mlp = PerspectiveEncoder(persp_in, D)
        self.spatial_encoder = SpatialEncoder(
            D, cfg.num_heads, cfg.num_spatial_layer, cfg.spatial_layer_type, cfg.compat_scale
        )
        for name in ("pose", "shape", "root"):
            setattr(self, f"{name}_temporal_encoder", TemporalEncoder(
                D, cfg.num_heads, cfg.num_temporal_layer, cfg.temporal_supervision,
                cfg.trope_scalar, cfg.compat_scale,
            ))
        self.pose_decoder = nn.Sequential(Linear(D, cfg.num_pose_query * 6))
        self.shape_decoder = nn.Sequential(Linear(D, 10))
        self.root_decoder = nn.Sequential(Linear(D, 3))
        self.mano = mano
        self.register_buffer(
            "j_regressor", torch.as_tensor(np.asarray(j_regressor), dtype=torch.float32),
            persistent=False,
        )
        self.register_buffer("img_mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("img_std", torch.tensor(IMAGENET_STD), persistent=False)

    def decode_pose(
        self,
        imgs: torch.Tensor,       # [B,T,H,W,3] in [0,1]
        timestamp: torch.Tensor,  # [B,T] ms
        persp_vec: torch.Tensor,  # [B,T,p,q,2]
        phase: str = "inference",
        generator: Optional[torch.Generator] = None,
        latent_generator: Optional[torch.Generator] = None,
    ):
        """Images -> (pose_aa [nB,T',16,3], shape [nB,T',10], root_norm
        [nB,T',3]); n is 2 with the latent group (the origin half first),
        else 1; T' is 1 with the realtime temporal encoders, else T.
        `generator` draws the backbone's droppath in the spatial phase,
        `latent_generator` the latent group's scales and angles."""
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        cfg = self.config
        B, T = imgs.shape[:2]
        n = 1
        spatial_train = phase == "spatial"
        # the temporal phase trains only the temporal encoders: no autograd
        # graph below them
        frozen = torch.no_grad() if phase == "temporal" else contextlib.nullcontext()
        with frozen:
            x = imgs.reshape((B * T,) + tuple(imgs.shape[2:]))
            # f32 statistics, activation dtype kept (f32 constants must not promote)
            x = ((x.float() - self.img_mean) / self.img_std).to(imgs.dtype)
            patches = self.backbone(x, generator if spatial_train else None)  # [BT,P,D]
            persp_bias = self.perspective_mlp(
                persp_vec.reshape(B * T, -1), spatial_train).to(patches.dtype)
            query = self.query_token[None].expand(B * T, -1, -1)
            if cfg.persp_decorate == "query":
                query = query + persp_bias[:, None]
            else:
                patches = patches + persp_bias[:, None]
            if self.latent_trans is not None:
                if latent_generator is None:
                    raise ValueError(
                        "a Poser with a latent group needs `latent_generator` (a "
                        "torch.Generator) for its scale and angle draws")
                normal, uniform = latent_draws(B, latent_generator)
                scale_coef = torch.clamp(normal, -0.3, 0.3).to(patches.device) + 1.0
                angle_rad = uniform.to(patches.device) * 2 * math.pi
                trans = self.latent_trans(patches, scale_coef.repeat_interleave(T),
                                          angle_rad.repeat_interleave(T), train=False)
                n = 2
                patches = torch.cat([patches, trans], dim=0)  # promotes, as jnp.concatenate
                query = torch.cat([query, query], dim=0)
                timestamp = torch.cat([timestamp, timestamp], dim=0)
            fused = self.spatial_encoder(query, patches, spatial_train)     # [nBT,3,D]

        q = fused.reshape(n * B, T, 3, -1).permute(2, 0, 1, 3)
        pose_q, shape_q, root_q = q[0], q[1], q[2]
        if phase != "spatial":
            temporal_train = phase == "temporal"
            if cfg.temporal_supervision == "full":
                pose_q = pose_q + self.pose_temporal_encoder(pose_q, train=temporal_train)
                shape_q = shape_q + self.shape_temporal_encoder(shape_q, train=temporal_train)
                root_q = root_q + self.root_temporal_encoder(root_q, train=temporal_train)
            else:
                ts = timestamp.reshape(n * B, T)
                pose_q = pose_q[:, -1:] + self.pose_temporal_encoder(pose_q, ts, temporal_train)
                shape_q = shape_q[:, -1:] + self.shape_temporal_encoder(shape_q, ts, temporal_train)
                root_q = root_q[:, -1:] + self.root_temporal_encoder(root_q, ts, temporal_train)
        T_out = pose_q.shape[1]

        pose_6d = self.pose_decoder(pose_q).reshape(n * B, T_out, cfg.num_pose_query, 6)
        pose_aa = matrix_to_axis_angle(rotation_6d_to_matrix(pose_6d))
        shape, root = self.shape_decoder(shape_q), self.root_decoder(root_q)
        if self.latent_trans is not None:
            pose_aa, root = self._unrotate(pose_aa, root, scale_coef, angle_rad, B)
        return pose_aa, shape, root

    @staticmethod
    def _unrotate(pose_aa, root, scale_coef, angle_rad, B):
        """Undo the latent scale and rotation on the transformed half (rows
        B:): the rotation about z by -angle on every joint's rotation and on
        the root, the scale on the root. Each output keeps its dtype."""
        T_out = pose_aa.shape[1]
        sin, cos = torch.sin(-angle_rad), torch.cos(-angle_rad)
        z, o = torch.zeros_like(cos), torch.ones_like(cos)
        rot_z = torch.stack([cos, -sin, z, sin, cos, z, z, z, o], dim=-1).reshape(B, 1, 3, 3)
        rot_z = rot_z.expand(B, T_out, 3, 3)
        dt = torch.promote_types(pose_aa.dtype, rot_z.dtype)
        mat = rot_z[:, :, None].to(dt) @ axis_angle_to_matrix(pose_aa[B:].to(dt))
        pose_aa = torch.cat([pose_aa[:B], matrix_to_axis_angle(mat).to(pose_aa.dtype)], dim=0)
        dt = torch.promote_types(root.dtype, rot_z.dtype)
        root_new = torch.einsum("btk,btkc->btc", root[B:].to(dt),
                                rot_z.transpose(-1, -2).to(dt)) / scale_coef[:, None, None]
        return pose_aa, torch.cat([root[:B], root_new.to(root.dtype)], dim=0)

    def pose_fk(self, pose_aa: torch.Tensor, shape: torch.Tensor,
                root_transl_norm: torch.Tensor):
        """MANO FK -> (joint_cam [B,T,21,3] mm, verts_cam [B,T,778,3] mm, root mm)."""
        B, T = pose_aa.shape[:2]
        flat_pose = pose_aa.reshape(B * T, -1)
        mano_out = self.mano(
            betas=shape.reshape(B * T, -1),
            global_orient=flat_pose[:, :3],
            hand_pose=flat_pose[:, 3:],
        )
        verts = mano_out["vertices"]                                     # [BT,778,3] m
        joints_mano = torch.einsum("nvd,jv->njd", verts, self.j_regressor)
        mean_len = mean_connection_length(joints_mano, TARGET_JOINTS_CONNECTION)
        mean_len = 1e3 * mean_len.reshape(B, T, 1)                       # mm
        root_transl = root_transl_norm * mean_len
        verts_cam = ((verts - joints_mano[:, :1]) * 1e3).reshape(B, T, -1, 3)
        verts_cam = verts_cam + root_transl[:, :, None]
        joint_cam = ((joints_mano - joints_mano[:, :1]) * 1e3).reshape(B, T, -1, 3)
        joint_cam = joint_cam + root_transl[:, :, None]
        return joint_cam, verts_cam, root_transl

    def predict(
        self,
        img_tensor: torch.Tensor,     # [B,T,H,W,3]
        square_bboxes: torch.Tensor,  # [B,T,4] xyxy
        timestamp: torch.Tensor,      # [B,T] ms (read by the "realtime" temporal mode)
        focal: torch.Tensor,          # [B,T,2]
        princpt: torch.Tensor,        # [B,T,2]
        phase: str = "inference",
        generator: Optional[torch.Generator] = None,
        latent_generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Public inference API (``phase="inference"``); the train step calls
        it with its phase. With the latent group every output has 2B rows,
        the origin half first.

        ``global_positioning="orientation"`` shifts the bboxes by their
        centre plus the principal point before the perspective input, then
        turns the root and the global orientation by
        ``rotation_matrix_y(roll) @ rotation_matrix_x(pitch)`` of the bbox
        centre's ray: the evident intent of the reference, whose
        ``matrix_to_axis_angle`` on an axis-angle vector is not replicated,
        with its non-standard ``rotation_matrix_y`` fill kept."""
        cfg = self.config
        center = None
        if cfg.global_positioning == "orientation":
            center = (square_bboxes[:, :, :2] + square_bboxes[:, :, 2:]) / 2.0
            shiftv = center + princpt
            square_bboxes = torch.cat(
                [square_bboxes[:, :, :2] - shiftv, square_bboxes[:, :, 2:] - shiftv], dim=-1)
        if cfg.persp_embed_method == "dense":
            directions = sample_persp_dir_vec(16, square_bboxes, focal, princpt)
        else:
            directions = sparse_corner_coords(square_bboxes, focal, princpt)
        pose_aa, shape, root_transl_norm = self.decode_pose(
            img_tensor, timestamp, directions, phase, generator, latent_generator)
        if center is not None:
            pose_aa, root_transl_norm = self._orient(pose_aa, root_transl_norm, center,
                                                     focal, princpt)
        joint_cam, verts_cam, root_transl = self.pose_fk(pose_aa, shape, root_transl_norm)
        return {
            "joint_cam": joint_cam,
            "verts_cam": verts_cam,
            "pose_aa": pose_aa,
            "shape": shape,
            "root_transl_norm": root_transl_norm,
            "root_transl": root_transl,
        }

    @staticmethod
    def _orient(pose_aa, root, center, focal, princpt):
        """The ``"orientation"`` turn of the root and of joint 0's rotation,
        over the predicted frames and repeated over both latent halves. The
        root takes the promoted dtype, pose_aa keeps its own (JAX's
        ``einsum`` and ``.at[].set``)."""
        v_half = (center[:, :, 1] - princpt[:, :, 1]) / focal[:, :, 1]
        u_half = (center[:, :, 0] - princpt[:, :, 0]) / focal[:, :, 0]
        T_out = pose_aa.shape[1]
        pitch, roll = torch.atan(v_half)[:, -T_out:], torch.atan(u_half)[:, -T_out:]
        trans = rotation_matrix_y(roll) @ rotation_matrix_x(pitch)
        trans = torch.cat([trans] * (pose_aa.shape[0] // trans.shape[0]), dim=0)
        dt = torch.promote_types(root.dtype, trans.dtype)
        root = torch.einsum("btnd,btd->btn", trans.to(dt), root.to(dt))
        dt = torch.promote_types(pose_aa.dtype, trans.dtype)
        root_mat = trans.to(dt) @ axis_angle_to_matrix(pose_aa[:, :, 0].to(dt))
        pose_aa = torch.cat([matrix_to_axis_angle(root_mat).to(pose_aa.dtype)[:, :, None],
                             pose_aa[:, :, 1:]], dim=2)
        return pose_aa, root

    def criterion(
        self, predict: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], phase: str,
    ):
        """Joint/shape losses on the supervised frames (the last one with the
        realtime temporal encoders, else all) and, in the temporal phase with
        ``"full"`` supervision, the smoothness term (``criterion`` of the JAX
        Poser). Returns (loss, logs)."""
        realtime = self.config.temporal_supervision == "realtime"

        def tsel(x):  # the supervised frames
            return x[:, -1:] if realtime else x

        pj, gj = tsel(predict["joint_cam"]), tsel(batch["joint_cam"])
        valid = tsel(batch["joint_valid"])
        loss_joint_cam = torch.mean(safe_norm(pj - gj) * valid)
        loss_joint_rel = torch.mean(
            safe_norm((pj - pj[:, :, :1]) - (gj - gj[:, :, :1])) * valid)
        loss_shape = torch.mean(torch.abs(tsel(predict["shape"]) - tsel(batch["mano_shape"])))
        if phase == "temporal" and not realtime:
            vel_p = derivative(pj, 1)
            vel_g = derivative(gj, 1)
            loss_vel = torch.mean(safe_norm(vel_p - vel_g))
            loss_accel = torch.mean(safe_norm(derivative(vel_p, 1) - derivative(vel_g, 1)))
            loss_temporal = 1e-2 * (loss_vel + loss_accel)
        else:
            loss_vel = loss_accel = loss_temporal = loss_joint_cam.new_zeros(())
        logs = {"cam": loss_joint_cam, "rel": loss_joint_rel, "shape": loss_shape,
                "loss_vel": loss_vel, "loss_accel": loss_accel}
        return loss_joint_cam + loss_joint_rel + loss_shape + loss_temporal, logs

    def forward(
        self, batch: Dict[str, torch.Tensor], phase: str = "spatial",
        generator: Optional[torch.Generator] = None,
        latent_generator: Optional[torch.Generator] = None,
    ) -> Dict:
        """Training forward: predict, then the losses. Returns ``{"loss",
        "logs": {"scalar": ...}, "predict"}`` as the JAX ``Poser.__call__``:
        with the latent group the loss is the origin half's plus 1e-2 times
        the transformed half's (both against the same targets), and
        ``predict`` is the origin half."""
        B = batch["patches"].shape[0]
        predict = self.predict(
            batch["patches"], batch["square_bboxes"], batch["timestamp"], batch["focal"],
            batch["princpt"], phase=phase, generator=generator,
            latent_generator=latent_generator,
        )
        origin = {k: v[:B] for k, v in predict.items()}
        loss_origin, origin_logs = self.criterion(origin, batch, phase)
        loss, loss_trans, trans_logs = loss_origin, loss_origin.new_zeros(()), {}
        if self.latent_trans is not None:
            loss_trans, trans_logs = self.criterion(
                {k: v[B:] for k, v in predict.items()}, batch, phase)
            loss = loss + 1e-2 * loss_trans
        return {
            "loss": loss,
            "logs": {"scalar": {
                "total": loss,
                "origin": {"origin": loss_origin, **origin_logs},
                "trans": {"trans": loss_trans, **trans_logs},
            }},
            "predict": origin,
        }


# the latent group trains in no phase (the reference never marks it trainable)
_PHASE_TRAINED = {
    "spatial": ("backbone", "perspective_mlp", "spatial_encoder",
                "pose_decoder", "shape_decoder", "root_decoder", "query_token"),
    "temporal": ("pose_temporal_encoder", "shape_temporal_encoder", "root_temporal_encoder"),
    "inference": (),
}


def phase_trainable_params(model: Poser, phase: str) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of every parameter `phase` trains, by top-level
    submodule as ``phase_trainable_mask`` of the JAX package marks them."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    trained = _PHASE_TRAINED[phase]
    return [(n, p) for n, p in model.named_parameters() if n.split(".", 1)[0] in trained]


@torch.no_grad()
def init_poser_weights(model: Poser, seed: int) -> None:
    """Seeded random weights with the JAX package's initialiser families:
    LeCun-normal kernels, zero biases, unit norm scales, logit scale ln 10,
    N(0, 1/D) query tokens, N(0, 1) positional tables and RoPE2D radial
    embedding, the log-spaced ``freq_base`` of the angle embedders, and zero
    ``zero_conv`` unless ``temporal_init_method="random"``; a DINOv2
    backbone's CLS token and position table N(0, 0.02) clipped at 2 sigma
    and its LayerScales at the configured value (TI-DINO's rules). Draws
    come from one CPU ``torch.Generator`` in parameter order, so a seed
    gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    zero_init = model.config.temporal_init_method == "zero"

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "query_token":
            value = normal(p.shape, p.shape[1] ** -0.5)
        elif name in ("backbone.embeddings.cls_token", "backbone.embeddings.position_embeddings"
                      ) and model.config.dinov2:
            value = torch.clamp(normal(p.shape, 0.02), -0.04, 0.04)
        elif leaf == "lambda1":  # a DINOv2 LayerScale
            value = torch.full(p.shape, model.backbone.config.layerscale_value)
        elif name.endswith("logit_scale"):
            value = torch.full(p.shape, float(np.log(10.0)))
        elif name.endswith(".pe.weight") or name.endswith("rope2d.embedding"):
            value = normal(p.shape, 1.0)
        elif leaf == "freq_base":
            value = torch.from_numpy(np.logspace(0, 1, p.shape[0], base=10.0).astype(np.float32))
        elif name.endswith("zero_conv.weight") and zero_init:
            value = torch.zeros(p.shape)
        elif leaf == "bias":
            value = torch.zeros(p.shape)
        elif p.dim() == 1:  # LayerNorm / BatchNorm scale
            value = torch.ones(p.shape)
        else:  # Linear [out, in] or Conv [out, in, kh, kw]
            fan_in = int(np.prod(p.shape[1:]))
            value = normal(p.shape, fan_in ** -0.5)
        p.copy_(value.to(p.dtype))
