"""Poser: camera-space MANO hand poser on a SwinV2 backbone.

Port of ``cs_vit_tpu/models/poser.py``: ImageNet normalisation, the SwinV2
backbone, the dense perspective ray grid and its encoder, the decoder-type
spatial encoder, the temporal encoders in both forms (``"full"``: every
frame, absolute PE and encoder blocks, also at T=1; ``"realtime"``: the
last frame only, continuous-time RoPE and cross-attention decoders), the
pose/shape/root heads, 6D -> axis-angle and MANO FK to camera-space joints
in mm; :meth:`Poser.forward` adds the training losses
(:meth:`Poser.criterion`).

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
``*_temporal_encoder.layers.N.*``, ``*_decoder.0``), which is what
``cs_vit_tpu/train/convert.py:export_poser_state_dict`` emits.

The dtype flow is the JAX package's: images are normalised in f32 and cast
back to the activation dtype, and the perspective bias (computed in f32 from
f32 rays) is cast to the patch dtype before it decorates the queries.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..constants import IMAGENET_MEAN, IMAGENET_STD, TARGET_JOINTS_CONNECTION
from ..core.geometry import matrix_to_axis_angle, rotation_6d_to_matrix, safe_norm
from ..core.joints import mean_connection_length
from ..mano.layer import ManoLayer
from .modules import (
    CrossAttnDecoder,
    DecoderBlock,
    EncoderBlock,
    Linear,
    PositionalEncoding,
    TorchBatchNorm,
)
from .swinv2 import SwinV2, SwinV2Config, swinv2_base_256, swinv2_tiny_256

PHASES = ("spatial", "temporal", "inference")


@dataclasses.dataclass(frozen=True)
class PoserConfig:
    """Static architecture knobs (reference ``Poser.__init__`` args).

    Options whose code paths later slices of the port bring (latent group,
    sparse perspective, patch decoration, encoder-type spatial layers,
    orientation positioning) are refused here rather than silently run as
    something else.
    """

    backbone: str = "swinv2-tiny-256"
    num_pose_query: int = 16
    num_spatial_layer: int = 6
    spatial_layer_type: str = "decoder"
    num_temporal_layer: int = 2
    temporal_init_method: str = "zero"      # "zero" | "random"
    temporal_supervision: str = "full"      # "full" | "realtime"
    trope_scalar: float = 20.0
    num_latent_layer: Optional[int] = None
    persp_embed_method: str = "dense"
    persp_decorate: str = "query"
    image_size: int = 256
    global_positioning: str = "direct"
    compat_scale: bool = True               # MHA sqrt(d_h)-multiply quirk
    custom_swin: Optional[SwinV2Config] = None
    attention_impl: str = "auto"            # "auto" | "eager" | "fused" | "pallas" | "hybrid"

    def __post_init__(self):
        unported = {
            "spatial_layer_type": (self.spatial_layer_type, "decoder"),
            "persp_embed_method": (self.persp_embed_method, "dense"),
            "persp_decorate": (self.persp_decorate, "query"),
            "global_positioning": (self.global_positioning, "direct"),
            "num_latent_layer": (self.num_latent_layer, None),
        }
        for name, (value, supported) in unported.items():
            if value != supported:
                raise NotImplementedError(
                    f"PoserConfig.{name}={value!r} is not ported yet (supported: {supported!r})"
                )
        if self.temporal_init_method not in ("zero", "random"):
            raise ValueError(f"temporal_init_method must be 'zero' or 'random'")
        if self.temporal_supervision not in ("full", "realtime"):
            raise ValueError("temporal_supervision must be 'full' or 'realtime'")

    def swin_config(self) -> SwinV2Config:
        if self.custom_swin is not None:
            return self.custom_swin
        name = self.backbone.lower()
        if "base" in name:
            return swinv2_base_256(image_size=self.image_size)
        if "tiny" in name:
            return swinv2_tiny_256(image_size=self.image_size)
        if "test" in name:  # minimal arch for smoke tests / CI
            return SwinV2Config(
                image_size=self.image_size, embed_dim=8, depths=(1, 1),
                num_heads=(2, 2), window_size=4, drop_path_rate=0.0,
                pretrained_window_sizes=(0, 0),
            )
        raise ValueError(f"unknown backbone spec: {self.backbone}")

    @property
    def hidden_dim(self) -> int:
        return self.swin_config().num_features

    @property
    def num_heads(self) -> int:
        return self.swin_config().num_heads[-1]


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
    """Query tokens attend to the patch tokens through decoder blocks."""

    def __init__(self, embed_dim: int, num_heads: int, num_layer: int,
                 compat_scale: bool = True):
        super().__init__()
        self.pe_spatial = PositionalEncoding(embed_dim)
        self.layers = nn.ModuleList(
            DecoderBlock(embed_dim, num_heads, compat_scale) for _ in range(num_layer)
        )

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.pe_spatial(x)
        for layer in self.layers:
            y = layer(y, ctx, train)
        return y


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
        self.backbone = SwinV2(cfg.swin_config(), attention_impl=cfg.attention_impl)
        self.query_token = nn.Parameter(torch.zeros(3, D))
        self.perspective_mlp = PerspectiveEncoder(16 * 16 * 2, D)
        self.spatial_encoder = SpatialEncoder(
            D, cfg.num_heads, cfg.num_spatial_layer, cfg.compat_scale
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
    ):
        """Images -> (pose_aa [B,T',16,3], shape [B,T',10], root_norm
        [B,T',3]); T' is 1 with the realtime temporal encoders, else T.
        `generator` draws the backbone's droppath in the spatial phase."""
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        cfg = self.config
        B, T = imgs.shape[:2]
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
            query = self.query_token[None].expand(B * T, -1, -1) + persp_bias[:, None]
            fused = self.spatial_encoder(query, patches, spatial_train)     # [BT,3,D]

        q = fused.reshape(B, T, 3, -1).permute(2, 0, 1, 3)
        pose_q, shape_q, root_q = q[0], q[1], q[2]
        if phase != "spatial":
            temporal_train = phase == "temporal"
            if cfg.temporal_supervision == "full":
                pose_q = pose_q + self.pose_temporal_encoder(pose_q, train=temporal_train)
                shape_q = shape_q + self.shape_temporal_encoder(shape_q, train=temporal_train)
                root_q = root_q + self.root_temporal_encoder(root_q, train=temporal_train)
            else:
                ts = timestamp.reshape(B, T)
                pose_q = pose_q[:, -1:] + self.pose_temporal_encoder(pose_q, ts, temporal_train)
                shape_q = shape_q[:, -1:] + self.shape_temporal_encoder(shape_q, ts, temporal_train)
                root_q = root_q[:, -1:] + self.root_temporal_encoder(root_q, ts, temporal_train)
        T_out = pose_q.shape[1]

        pose_6d = self.pose_decoder(pose_q).reshape(B, T_out, cfg.num_pose_query, 6)
        pose_aa = matrix_to_axis_angle(rotation_6d_to_matrix(pose_6d))
        return pose_aa, self.shape_decoder(shape_q), self.root_decoder(root_q)

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
    ) -> Dict[str, torch.Tensor]:
        """Public inference API (``phase="inference"``); the train step calls
        it with its phase."""
        directions = sample_persp_dir_vec(16, square_bboxes, focal, princpt)
        pose_aa, shape, root_transl_norm = self.decode_pose(
            img_tensor, timestamp, directions, phase, generator)
        joint_cam, verts_cam, root_transl = self.pose_fk(pose_aa, shape, root_transl_norm)
        return {
            "joint_cam": joint_cam,
            "verts_cam": verts_cam,
            "pose_aa": pose_aa,
            "shape": shape,
            "root_transl_norm": root_transl_norm,
            "root_transl": root_transl,
        }

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
    ) -> Dict:
        """Training forward: predict, then the losses. Returns ``{"loss",
        "logs": {"scalar": ...}, "predict"}`` as the JAX ``Poser.__call__``."""
        predict = self.predict(
            batch["patches"], batch["square_bboxes"], batch["timestamp"], batch["focal"],
            batch["princpt"], phase=phase, generator=generator,
        )
        loss, logs = self.criterion(predict, batch, phase)
        return {
            "loss": loss,
            "logs": {"scalar": {
                "total": loss,
                "origin": {"origin": loss, **logs},
                "trans": {"trans": loss.new_zeros(())},
            }},
            "predict": predict,
        }


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
    N(0, 1/D) query tokens, N(0, 1) positional tables, and zero ``zero_conv``
    unless ``temporal_init_method="random"``. Draws come from one CPU
    ``torch.Generator`` in parameter order, so a seed gives the same weights
    on every device."""
    gen = torch.Generator().manual_seed(seed)
    zero_init = model.config.temporal_init_method == "zero"

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "query_token":
            value = normal(p.shape, p.shape[1] ** -0.5)
        elif name.endswith("logit_scale"):
            value = torch.full(p.shape, float(np.log(10.0)))
        elif name.endswith(".pe.weight"):
            value = normal(p.shape, 1.0)
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
