"""A plain PyTorch Poser: the reference that decides ``correct``.

It imports nothing of the program. It computes in float32 (the products in
the precision of :mod:`.precision`), one operation after another, with no
kernel, no cache and no batching trick, and follows the published model and
the repository's documented quirks:

- The backbone: the configuration's kind (``portbench.backbones``), whose
  file holds its reference.
- The CS-ViT head: ImageNet normalisation; the dense 16 x 16 perspective
  ray grid and its BatchNorm MLP; three query tokens; a spatial encoder of
  decoder blocks (self-attention, cross-attention to the patches, FFN) or
  of encoder blocks over ``[queries | patches]`` in which every layer reads
  the same input and only the last survives; attention scores multiplied by
  sqrt(d_h); BatchNorm1d as block norm; temporal encoders, ``"full"``
  (absolute table, encoder blocks, every frame) or ``"realtime"``
  (continuous-time RoPE on the token values, cross-attention decoders whose
  query is the last frame), each followed by its ``zero_conv`` and added;
  pose (6D per joint), shape and root heads; 6D -> axis-angle.
- The latent group (CS-ViT's scale-rotation group): 2D polar RoPE of the
  patch grid, Fourier angle embeddings of the scale and angle through the
  swapped MLPs, ``scale_emb * x + angle_emb``, encoder blocks on running
  statistics; the scale ``clip(N(0,1), -0.3, 0.3) + 1`` and angle
  ``2 pi U[0,1)`` per sample (a normal then a uniform draw of B from the
  latent generator); the predictions of the transformed half turned back
  about z by the angle and the root divided by the scale.
- MANO linear blend skinning in float32 with the tensors it is handed, the
  21-joint regressor, joints relative to the wrist plus the root translation
  times the mean bone length, in mm; the losses (mean joint distance, mean
  wrist-relative distance, mean absolute shape error; the transformed half
  at 1e-2).

BatchNorm runs in one of three modes: ``"batch"`` (the batch's own
statistics, as in training), ``"running"`` (the running statistics), or
``"calibrate"`` (the batch's statistics, written into the running ones, so
that the running statistics become those of a calibration batch).

Parameter and buffer names are those of the reference state dict the
program also loads, so one state dict fills both.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..backbones import kind as backbone_kind
from .precision import linear, matmul

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# 20 bones over the 21 output joints (wrist, then thumb .. pinky 1..4)
BONES = ((0, 1), (0, 5), (0, 9), (0, 13), (0, 17), (1, 2), (2, 3), (3, 4), (5, 6), (6, 7),
         (7, 8), (9, 10), (10, 11), (11, 12), (13, 14), (14, 15), (15, 16), (17, 18),
         (18, 19), (19, 20))
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)


# ---------------------------------------------------------------- layers


class Linear(nn.Module):
    def __init__(self, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dout, din))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class BatchNorm(nn.Module):
    """BatchNorm over the last axis; eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x, mode: str):
        if mode == "running":
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = ((x - mean) ** 2).mean(axes)
            if mode == "calibrate":
                with torch.no_grad():
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


class Sequential(nn.Module):
    """Numbered children (state-dict names ``N.*``) run in order; ``None``
    entries are the parameterless ReLU / GELU positions."""

    def __init__(self, *layers, act=None):
        super().__init__()
        self.act = act
        for i, layer in enumerate(layers):
            if layer is not None:
                self.add_module(str(i), layer)
        self.n = len(layers)

    def forward(self, x):
        for i in range(self.n):
            m = self._modules.get(str(i))
            x = self.act(x) if m is None else m(x)
        return x


def relu(x):
    return torch.clamp(x, min=0.0)


class PatchConv(nn.Module):
    """The patch embedding's stride-p convolution, computed as the product
    of each p x p patch (channels, rows, columns) with the kernel."""

    def __init__(self, cin, cout, p):
        super().__init__()
        self.p = p
        self.weight = nn.Parameter(torch.zeros(cout, cin, p, p))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):  # NHWC -> [B, (H/p)(W/p), cout]
        B, H, W, C = x.shape
        p = self.p
        patches = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 5, 2, 4)
        return linear(patches.reshape(B, -1, C * p * p), self.weight.reshape(self.weight.shape[0], -1),
                      self.bias)


class Holder(nn.Module):
    """A named level of the state dict."""

    def __init__(self, **children):
        super().__init__()
        for k, v in children.items():
            setattr(self, k, v)


# ---------------------------------------------------------------- head


class MHA(nn.Module):
    """Scores multiplied by sqrt(d_h)."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.output = (Linear(dim, dim) for _ in range(4))

    def forward(self, x, ctx):
        B, L, D = x.shape
        S, H = ctx.shape[1], self.heads
        hd = D // H
        q = self.query(x).reshape(B, L, H, hd).transpose(1, 2)
        k = self.key(ctx).reshape(B, S, H, hd).transpose(1, 2)
        v = self.value(ctx).reshape(B, S, H, hd).transpose(1, 2)
        w = torch.softmax(matmul(q, k.transpose(-1, -2)) * math.sqrt(hd), dim=-1)
        return self.output(matmul(w, v).transpose(1, 2).reshape(B, L, D))


class FFN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = Sequential(Linear(dim, 4 * dim), None, Linear(4 * dim, dim), act=gelu)

    def forward(self, x):
        return self.net(x)


class EncoderBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.attn, self.ffn = MHA(dim, heads), FFN(dim)
        self.norm1, self.norm2 = BatchNorm(dim), BatchNorm(dim)

    def forward(self, x, mode):
        y = self.norm1(x, mode)
        x = x + self.attn(y, y)
        return x + self.ffn(self.norm2(x, mode))


class DecoderBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.self_atten, self.cross_atten, self.ffn = MHA(dim, heads), MHA(dim, heads), FFN(dim)
        self.norm1, self.norm2, self.norm3 = BatchNorm(dim), BatchNorm(dim), BatchNorm(dim)

    def forward(self, x, ref, mode):
        y = self.norm1(x, mode)
        x = x + self.self_atten(y, y)
        x = x + self.cross_atten(self.norm2(x, mode), ref)
        return x + self.ffn(self.norm3(x, mode))


class CrossAttnDecoder(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.cross_atten, self.ffn = MHA(dim, heads), FFN(dim)
        self.norm1, self.norm2 = BatchNorm(dim), BatchNorm(dim)

    def forward(self, x, ref, mode):
        x = x + self.cross_atten(self.norm1(x, mode), ref)
        return x + self.ffn(self.norm2(x, mode))


class AbsolutePE(nn.Module):
    def __init__(self, dim, max_len=512):
        super().__init__()
        self.pe = Holder(weight=nn.Parameter(torch.zeros(max_len, dim)))

    def forward(self, x):
        return x + self.pe.weight[: x.shape[1]]


def rope_values(x, t):
    """Continuous-time RoPE of token values: pair i of frame f turned by
    (t_last - t_f) * 10000^(-2i/D)."""
    D = x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ph = (t[:, -1:] - t)[..., None] * inv
    c, s = torch.cos(ph), torch.sin(ph)
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    a, b = x2[..., 0], x2[..., 1]
    return torch.stack([a * c - b * s, a * s + b * c], -1).reshape(x.shape)


class TemporalEncoder(nn.Module):
    def __init__(self, dim, heads, n, target, trope_scalar):
        super().__init__()
        self.target, self.trope_scalar = target, trope_scalar
        if target == "realtime":
            self.layers = nn.ModuleList(CrossAttnDecoder(dim, heads) for _ in range(n))
        else:
            self.pe_temporal = AbsolutePE(dim)
            self.layers = nn.ModuleList(EncoderBlock(dim, heads) for _ in range(n))
        self.zero_conv = Linear(dim, dim, bias=False)

    def forward(self, x, ts, mode):
        if self.target == "realtime":
            seq = rope_values(x, ts / self.trope_scalar)
            y = seq[:, -1:]
            for layer in self.layers:
                y = layer(y, seq, mode)
            return x[:, -1:] + self.zero_conv(y)
        y = self.pe_temporal(x)
        for layer in self.layers:
            y = layer(y, mode)
        return x + self.zero_conv(y)


class PerspectiveEncoder(nn.Module):
    def __init__(self, din, dim):
        super().__init__()
        self.proj = Linear(din, dim)
        self.layer = nn.ModuleDict()
        for i in range(3):
            self.layer[str(3 * i)] = BatchNorm(dim)
            self.layer[str(3 * i + 1)] = Linear(dim, dim)
        self.layer["9"] = Linear(dim, dim)

    def forward(self, x, mode):
        y = self.proj(x)
        for i in range(3):
            y = relu(self.layer[str(3 * i + 1)](self.layer[str(3 * i)](y, mode)))
        return self.layer["9"](y)


class SpatialEncoder(nn.Module):
    def __init__(self, dim, heads, n, kind):
        super().__init__()
        self.kind = kind
        self.pe_spatial = AbsolutePE(dim)
        block = DecoderBlock if kind == "decoder" else EncoderBlock
        self.layers = nn.ModuleList(block(dim, heads) for _ in range(n))

    def forward(self, query, patches, mode):
        if self.kind == "decoder":
            y = self.pe_spatial(query)
            for layer in self.layers:
                y = layer(y, patches, mode)
            return y
        y0 = self.pe_spatial(torch.cat([query, patches], 1))
        y = y0
        for layer in self.layers:
            y = layer(y0, mode)
        return y[:, : query.shape[1]]


class AngleEmbedding(nn.Module):
    def __init__(self, dim, num_freq=32):
        super().__init__()
        self.freq_base = nn.Parameter(torch.zeros(num_freq))
        self.proj = Sequential(Linear(2 * num_freq, dim), None, LayerNorm(dim), act=gelu)

    def forward(self, a):
        m = 2 * math.pi
        r = torch.fmod(a, m)
        r = torch.where((r != 0) & (r < 0), r + m, r)
        s = (r / m * m)[..., None] * self.freq_base
        return self.proj(torch.cat([torch.sin(s), torch.cos(s)], -1))


class Rope2D(nn.Module):
    def __init__(self, dim, num_p, num_point=32):
        super().__init__()
        self.dim, self.num_p = dim, num_p
        self.embedding = nn.Parameter(torch.zeros(num_point, dim))
        p, q = np.meshgrid(np.arange(num_p), np.arange(num_p), indexing="ij")
        c = (num_p - 1) / 2
        dp, dq = p.astype(np.float32) - c, q.astype(np.float32) - c
        sample = np.clip(np.sqrt(dp**2 + dq**2) / math.sqrt(2 * c * c), 0.0, 1.0) * (num_point - 1)
        half = dim // 2
        theta = np.einsum("pq,d->pqd", np.arctan2(dq, dp),
                          1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) / half)))
        for name, v in (("cos", np.cos(theta).astype(np.float32)),
                        ("sin", np.sin(theta).astype(np.float32)),
                        ("lo", np.clip(np.floor(sample), 0, num_point - 1).astype(np.int64)),
                        ("hi", np.clip(np.ceil(sample), 0, num_point - 1).astype(np.int64)),
                        ("frac", (sample - np.floor(sample)).astype(np.float32)[..., None])):
            self.register_buffer(name, torch.from_numpy(v), persistent=False)

    def forward(self, x):
        B, n = x.shape[0], self.num_p
        emb = self.embedding[self.lo] * (1 - self.frac) + self.embedding[self.hi] * self.frac
        e = (x.reshape(B, n, n, self.dim) + emb).reshape(B, n, n, -1, 2)
        a, b = e[..., 0], e[..., 1]
        r = torch.stack([self.cos * a - self.sin * b, self.sin * a + self.cos * b], -1)
        return r.reshape(B, n * n, self.dim)


def mlp3(dim):
    return Sequential(Linear(dim, dim), None, Linear(dim, dim), None, Linear(dim, dim), act=relu)


class LatentGroup(nn.Module):
    def __init__(self, n, dim, heads, num_p):
        super().__init__()
        self.rope2d = Rope2D(dim, num_p)
        self.angle_embedder, self.scale_embedder = AngleEmbedding(dim), AngleEmbedding(dim)
        self.scale_linear, self.angle_linear = mlp3(dim), mlp3(dim)
        self.sr = nn.ModuleList(EncoderBlock(dim, heads) for _ in range(n))

    def forward(self, patches, scale, angle, mode):
        x = self.rope2d(patches)
        # the angle's embedding through scale_linear, the scale's through
        # angle_linear (the released model's wiring)
        a_emb = self.scale_linear(self.angle_embedder(angle))
        s_emb = self.angle_linear(self.scale_embedder(scale))
        x = s_emb[:, None] * x + a_emb[:, None]
        for layer in self.sr:
            x = layer(x, mode)
        return x


# ---------------------------------------------------------------- geometry


def normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def rot6d_to_matrix(d6):
    b1 = normalize(d6[..., :3])
    a2 = d6[..., 3:]
    b2 = normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    return torch.stack((b1, b2, torch.linalg.cross(b1, b2, dim=-1)), dim=-2)


def matrix_to_axis_angle(m):
    """Through the quaternion of the best-conditioned candidate."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(m.reshape(*m.shape[:-2], 9), -1)
    sq = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                      1 - m00 - m11 + m22], -1)
    q_abs = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq))),
                        torch.zeros_like(sq))
    cands = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1)], -2)
    cands = cands / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    onehot = torch.nn.functional.one_hot(q_abs.argmax(-1), 4).to(cands.dtype)
    quat = (cands * onehot[..., None]).sum(-2)
    quat = torch.where(quat[..., :1] < 0, -quat, quat)
    n = torch.linalg.vector_norm(quat[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(n, quat[..., :1])
    return quat[..., 1:] / (0.5 * torch.sinc(half / math.pi))


def axis_angle_to_matrix(aa):
    """Rodrigues."""
    ang = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)[..., None]
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    o = torch.zeros_like(x)
    K = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(aa.shape + (3,))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    a2 = torch.where(ang == 0, torch.ones_like(ang), ang * ang)
    return eye + torch.sinc(ang / math.pi) * K + ((1 - torch.cos(ang)) / a2) * (K @ K)


def safe_norm(x):
    sq = (x * x).sum(-1)
    zero = sq == 0
    return torch.where(zero, torch.zeros_like(sq), torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


class Mano(nn.Module):
    """MANO LBS in float32 over the tensors handed to :meth:`load`."""

    def __init__(self):
        super().__init__()
        for name, shape in (("v_template", (778, 3)), ("shapedirs", (778, 3, 10)),
                            ("posedirs", (135, 778 * 3)), ("j_regressor", (16, 778)),
                            ("lbs_weights", (778, 16)), ("pose_mean", (48,))):
            self.register_buffer(name, torch.zeros(shape), persistent=False)

    def forward(self, betas, pose):  # [N,10], [N,48] -> vertices [N,778,3] m
        N = betas.shape[0]
        pose = pose + self.pose_mean
        v = self.v_template + torch.einsum("bl,vdl->bvd", betas, self.shapedirs)
        joints = torch.einsum("jv,bvd->bjd", self.j_regressor, v)
        rot = axis_angle_to_matrix(pose.reshape(N, 16, 3))
        feat = (rot[:, 1:] - torch.eye(3, device=pose.device)).reshape(N, -1)
        v = v + (feat @ self.posedirs).reshape(N, -1, 3)
        par = list(MANO_PARENTS)
        rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par[1:]]], 1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=pose.device).expand(N, 16, 1, 4)
        tm = torch.cat([torch.cat([rot, rel[..., None]], -1), bottom], -2)
        chain = [tm[:, 0]]
        for i in range(1, 16):
            chain.append(chain[par[i]] @ tm[:, i])
        tr = torch.stack(chain, 1)
        jh = torch.cat([joints, joints.new_zeros(N, 16, 1)], -1)
        corr = torch.einsum("bjik,bjk->bji", tr, jh)
        rel_tr = torch.cat([tr[..., :3], (tr[..., 3] - corr)[..., None]], -1)
        T = torch.einsum("vj,bjik->bvik", self.lbs_weights, rel_tr)
        vh = torch.cat([v, v.new_ones(N, v.shape[1], 1)], -1)
        return torch.einsum("bvik,bvk->bvi", T, vh)[..., :3]


# ---------------------------------------------------------------- Poser


def ray_grid(bbox, focal, princpt, p=16):
    """Unit ray directions through a p x p grid over each box, (x, y) of
    each; [B,T,p,p,2]."""
    g = torch.linspace(0.5 / p, 1 - 0.5 / p, p, dtype=bbox.dtype, device=bbox.device)
    xs = bbox[:, :, 0:1] + (bbox[:, :, 2:3] - bbox[:, :, 0:1]) * g
    ys = bbox[:, :, 1:2] + (bbox[:, :, 3:4] - bbox[:, :, 1:2]) * g
    grid = torch.stack([xs[:, :, :, None].expand(*xs.shape, p),
                        ys[:, :, None, :].expand(*ys.shape[:2], p, p)], -1)
    d = (grid - princpt[:, :, None, None]) / focal[:, :, None, None]
    d3 = torch.cat([d, torch.ones_like(d[..., :1])], -1)
    return (d3 / torch.linalg.vector_norm(d3, dim=-1, keepdim=True))[..., :2]


class Poser(nn.Module):
    """`cfg` is a configuration file's ``model`` section."""

    def __init__(self, cfg: dict):
        super().__init__()
        kind = backbone_kind(cfg)
        self.cfg = cfg
        D, H, num_p = kind.outputs(cfg)
        self.heads = H
        self.backbone = kind.Backbone(cfg["backbone"], cfg["img_size"])
        self.latent_trans = (LatentGroup(cfg["num_latent_layer"], D, H, num_p)
                             if cfg.get("num_latent_layer") else None)
        self.query_token = nn.Parameter(torch.zeros(3, D))
        self.perspective_mlp = PerspectiveEncoder(16 * 16 * 2, D)
        self.spatial_encoder = SpatialEncoder(D, H, cfg["num_spatial_layer"],
                                              cfg["spatial_layer_type"])
        for k in ("pose", "shape", "root"):
            setattr(self, f"{k}_temporal_encoder", TemporalEncoder(
                D, H, cfg["num_temporal_layer"], cfg["temporal_supervision"],
                cfg["trope_scalar"]))
        self.pose_decoder = Sequential(Linear(D, cfg["num_joints"] * 6))
        self.shape_decoder = Sequential(Linear(D, 10))
        self.root_decoder = Sequential(Linear(D, 3))
        self.mano = Mano()
        self.register_buffer("j_regressor", torch.zeros(21, 778), persistent=False)

    def predict(self, imgs, bbox, ts, focal, princpt, phase="inference",
                gen=None, latent_gen=None) -> Dict[str, torch.Tensor]:
        """`phase`: ``"spatial"`` (training: droppath from `gen`, batch
        statistics before the temporal encoders, which it skips),
        ``"inference"`` or ``"calibrate"``. With the latent group every
        output has 2B rows, the origin half first."""
        cfg = self.cfg
        B, T = imgs.shape[:2]
        mode = {"spatial": "batch", "inference": "running", "calibrate": "calibrate"}[phase]
        x = imgs.reshape(B * T, *imgs.shape[2:])
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        patches = self.backbone((x - mean) / std, gen if phase == "spatial" else None)
        persp = self.perspective_mlp(ray_grid(bbox, focal, princpt).reshape(B * T, -1), mode)
        query = self.query_token[None].expand(B * T, -1, -1)
        if cfg["persp_decorate"] == "query":
            query = query + persp[:, None]
        else:
            patches = patches + persp[:, None]
        n = 1
        if self.latent_trans is not None:
            normal = torch.randn(B, generator=latent_gen, device=latent_gen.device)
            uniform = torch.rand(B, generator=latent_gen, device=latent_gen.device)
            scale = torch.clamp(normal, -0.3, 0.3).to(x.device) + 1.0
            angle = uniform.to(x.device) * 2 * math.pi
            lmode = "calibrate" if phase == "calibrate" else "running"
            trans = self.latent_trans(patches, scale.repeat_interleave(T),
                                      angle.repeat_interleave(T), lmode)
            patches = torch.cat([patches, trans], 0)
            query = torch.cat([query, query], 0)
            ts = torch.cat([ts, ts], 0)
            n = 2
        fused = self.spatial_encoder(query, patches, mode)
        q = fused.reshape(n * B, T, 3, -1).permute(2, 0, 1, 3)
        qs = [q[0], q[1], q[2]]
        if phase != "spatial":
            qs = [getattr(self, f"{k}_temporal_encoder")(v, ts, mode)
                  for k, v in zip(("pose", "shape", "root"), qs)]
        To = qs[0].shape[1]
        pose = matrix_to_axis_angle(rot6d_to_matrix(
            self.pose_decoder(qs[0]).reshape(n * B, To, -1, 6)))
        shape, root = self.shape_decoder(qs[1]), self.root_decoder(qs[2])
        if n == 2:
            s, c = torch.sin(-angle), torch.cos(-angle)
            z, o = torch.zeros_like(c), torch.ones_like(c)
            rz = torch.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(B, 1, 3, 3).expand(B, To, 3, 3)
            turned = matrix_to_axis_angle(rz[:, :, None] @ axis_angle_to_matrix(pose[B:]))
            pose = torch.cat([pose[:B], turned], 0)
            root_t = torch.einsum("btk,btkc->btc", root[B:], rz.transpose(-1, -2)) / scale[:, None, None]
            root = torch.cat([root[:B], root_t], 0)
        return self.fk(pose, shape, root)

    def fk(self, pose, shape, root):
        N, T = pose.shape[:2]
        verts = self.mano(shape.reshape(N * T, -1), pose.reshape(N * T, -1))
        joints = torch.einsum("nvd,jv->njd", verts, self.j_regressor)
        bones = torch.stack([joints[:, a] - joints[:, b] for a, b in BONES], 1)
        mean_len = 1e3 * torch.linalg.vector_norm(bones, dim=-1).mean(-1).reshape(N, T, 1)
        root_t = root * mean_len
        jc = ((joints - joints[:, :1]) * 1e3).reshape(N, T, -1, 3) + root_t[:, :, None]
        return {"joint_cam": jc, "shape": shape}

    def loss(self, batch, gen=None, latent_gen=None, rows=None):
        """The spatial phase's training loss, and the predicted joints of
        the batch's own rows. `rows`: the loss's means are taken over these
        rows of the batch only."""
        B = batch["patches"].shape[0]
        out = self.predict(batch["patches"], batch["square_bboxes"], batch["timestamp"],
                           batch["focal"], batch["princpt"], "spatial", gen, latent_gen)

        def mean(t):
            return t.mean() if rows is None else t[rows].mean()

        def half(sl):
            pj, gj = out["joint_cam"][sl], batch["joint_cam"]
            valid = batch["joint_valid"]
            cam = mean(safe_norm(pj - gj) * valid)
            rel = mean(safe_norm((pj - pj[:, :, :1]) - (gj - gj[:, :, :1])) * valid)
            return cam + rel + mean((out["shape"][sl] - batch["mano_shape"]).abs())

        loss = half(slice(0, B))
        if self.latent_trans is not None:
            loss = loss + 1e-2 * half(slice(B, 2 * B))
        return loss, out["joint_cam"][:B]


def trained(name: str) -> bool:
    """Whether the spatial phase trains the parameter `name`."""
    return name.split(".", 1)[0] in ("backbone", "perspective_mlp", "spatial_encoder",
                                     "pose_decoder", "shape_decoder", "root_decoder",
                                     "query_token")
