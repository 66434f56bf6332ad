"""The backbone kind ``swinv2``: SwinV2 (Liu et al. 2022;
``microsoft/swinv2-base-patch4-window16-256``), as ``portbench.backbones``
asks of a kind.

The reference: 4x4 patch embedding, then per stage post-norm blocks of
cosine window attention (``softmax(norm(q) norm(k)^T exp(min(logit_scale,
ln 100)) + 16 sigmoid(CPB) + shift mask)``, q and v biased, k not; the
log-spaced continuous position bias MLP; window and shift clamped to the
stage's resolution) and a GELU MLP, patch merging (order (0,0), (1,0),
(0,1), (1,1)), a final LayerNorm; per-image stochastic depth of both
residual branches of block i with rate ``linspace(0, drop_path_rate,
n)[i]``, a [B, 2] Bernoulli keep mask per block with a nonzero rate, in
block order.

A block's bound is the larger of its FLOPs over the bf16 tensor-core peak
and its bytes over the memory bandwidth, where the bytes are its inputs read
once and its outputs written once in the compute dtype: x, the parameters
and y forward; x, dy, the parameters, dx and the parameter gradients for its
vector-Jacobian product. What an implementation saves or recomputes is not
counted.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from portbench.flops import Product, lin, forward_flops, step_flops
from portbench.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from portbench.reference.model import Holder, LayerNorm, Linear, PatchConv, Sequential, gelu, relu
from portbench.reference.precision import matmul

PROGRAM_CONFIG = ("embed_dim", "depths", "num_heads", "window_size", "patch_size", "mlp_ratio",
                  "drop_path_rate", "layer_norm_eps", "pretrained_window_sizes")
PROGRAM_BLOCK = "cs_vit_tpu_torch.models.swinv2.SwinV2Block"
_MLP_OUT = re.compile(r"backbone\..*\.blocks\.\d+\.output\.dense\.weight")


def outputs(model: dict):
    """(dim, heads, num_p) of the last stage."""
    bb = model["backbone"]
    n = len(bb["depths"])
    return (bb["embed_dim"] * 2 ** (n - 1), bb["num_heads"][-1],
            model["img_size"] // (bb["patch_size"] * 2 ** (n - 1)))


def block_leaf(name: str) -> bool:
    return ".blocks." in name


def mlp_out_weight(name: str) -> bool:
    return _MLP_OUT.fullmatch(name) is not None


# ---------------------------------------------------------------- reference


def window_partition(x, ws):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(win, ws, B, H, W):
    C = win.shape[-1]
    x = win.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def coords_table(ws: int) -> np.ndarray:
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    t = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    if ws > 1:
        t = t / (ws - 1)
    t = t * 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / math.log2(8.0)
    return t.reshape(-1, 2)


def relative_index(ws: int) -> np.ndarray:
    c = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).reshape(-1).astype(np.int64)


def shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    img = np.zeros((h, w), dtype=np.float32)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    n = 0
    for a in cuts:
        for b in cuts:
            img[a, b] = n
            n += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0).astype(np.float32)


class _SelfAttn(nn.Module):
    def __init__(self, dim, heads, ws):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.logit_scale = nn.Parameter(torch.zeros(heads, 1, 1))
        self.continuous_position_bias_mlp = Sequential(
            Linear(2, 512), None, Linear(512, heads, bias=False), act=relu)
        self.query = Linear(dim, dim)
        self.key = Linear(dim, dim, bias=False)
        self.value = Linear(dim, dim)
        self.register_buffer("table", torch.from_numpy(coords_table(ws)), persistent=False)
        self.register_buffer("index", torch.from_numpy(relative_index(ws)), persistent=False)

    def forward(self, x, mask):
        B_, L, C = x.shape
        H = self.heads
        hd = C // H

        def heads(t):
            return t.reshape(B_, L, H, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
        k = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-12)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        cpb = self.continuous_position_bias_mlp(self.table)[self.index]
        bias = 16.0 * torch.sigmoid(cpb.reshape(L, L, H).permute(2, 0, 1))
        a = matmul(q, k.transpose(-1, -2)) * scale + bias
        if mask is not None:
            nW = mask.shape[0]
            a = (a.reshape(B_ // nW, nW, H, L, L) + mask[None, :, None]).reshape(B_, H, L, L)
        out = matmul(torch.softmax(a, dim=-1), v)
        return out.transpose(1, 2).reshape(B_, L, C)


class _Dense(nn.Module):
    def __init__(self, din, dout):
        super().__init__()
        self.dense = Linear(din, dout)

    def forward(self, x):
        return self.dense(x)


class _Attention(nn.Module):
    def __init__(self, dim, heads, ws):
        super().__init__()
        self.self = _SelfAttn(dim, heads, ws)
        self.output = _Dense(dim, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim, res, heads, window, shift, rate, eps):
        super().__init__()
        self.res, self.rate = res, rate
        self.ws = min(res, window)
        self.sh = 0 if res <= window else shift
        self.attention = _Attention(dim, heads, self.ws)
        self.layernorm_before = LayerNorm(dim, eps)
        self.intermediate = _Dense(dim, 4 * dim)
        self.output = _Dense(4 * dim, dim)
        self.layernorm_after = LayerNorm(dim, eps)
        m = torch.from_numpy(shift_mask(res, res, self.ws, self.sh)) if self.sh else None
        self.register_buffer("mask", m, persistent=False)

    def forward(self, x, gen: Optional[torch.Generator]):
        B, _, C = x.shape
        H = W = self.res
        keep = None
        if gen is not None and self.rate > 0.0:
            p = torch.full((B, 2), 1.0 - self.rate, device=gen.device)
            keep = torch.bernoulli(p, generator=gen).to(x.device) / (1.0 - self.rate)

        def dropped(branch, col):
            return branch if keep is None else branch * keep[:, col, None, None]

        y = x.reshape(B, H, W, C)
        if self.sh:
            y = torch.roll(y, shifts=(-self.sh, -self.sh), dims=(1, 2))
        win = self.attention.output(self.attention.self(window_partition(y, self.ws), self.mask))
        y = window_reverse(win, self.ws, B, H, W)
        if self.sh:
            y = torch.roll(y, shifts=(self.sh, self.sh), dims=(1, 2))
        x = x + dropped(self.layernorm_before(y.reshape(B, H * W, C)), 0)
        y = self.output(gelu(self.intermediate(x)))
        return x + dropped(self.layernorm_after(y), 1)


class PatchMerging(nn.Module):
    def __init__(self, dim, res, eps):
        super().__init__()
        self.res = res
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim, eps)

    def forward(self, x):
        B, _, C = x.shape
        x = x.reshape(B, self.res, self.res, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.norm(self.reduction(x.reshape(B, -1, 4 * C)))


class Backbone(nn.Module):
    """SwinV2: the patches of the last stage after the final LayerNorm."""

    def __init__(self, bb: dict, image_size: int):
        super().__init__()
        eps, C, p = bb["layer_norm_eps"], bb["embed_dim"], bb["patch_size"]
        depths, heads, window = bb["depths"], bb["num_heads"], bb["window_size"]
        self.embeddings = Holder(patch_embeddings=Holder(projection=PatchConv(3, C, p)),
                                  norm=LayerNorm(C, eps))
        rates = iter(np.linspace(0, bb["drop_path_rate"], sum(depths)).tolist())
        res = image_size // p
        stages = []
        for s, (depth, h) in enumerate(zip(depths, heads)):
            blocks = nn.ModuleList(
                SwinBlock(C, res, h, window, 0 if i % 2 == 0 else window // 2, next(rates), eps)
                for i in range(depth))
            down = None
            if s < len(depths) - 1:
                down = PatchMerging(C, res, eps)
                res, C = res // 2, 2 * C
            stages.append(Holder(blocks=blocks, downsample=down))
        self.encoder = Holder(layers=nn.ModuleList(stages))
        self.layernorm = LayerNorm(C, eps)

    def forward(self, x, gen=None):
        x = self.embeddings.norm(self.embeddings.patch_embeddings.projection(x))
        for stage in self.encoder.layers:
            for blk in stage.blocks:
                x = blk(x, gen)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return self.layernorm(x)


# ---------------------------------------------------------------- work


def stages(model: dict):
    """(resolution, channels, heads, window) per stage."""
    bb = model["backbone"]
    res = model["img_size"] // bb["patch_size"]
    C, out = bb["embed_dim"], []
    for s, h in enumerate(bb["num_heads"]):
        ws = min(res, bb["window_size"])
        out.append((res, C, h, ws))
        res, C = res // 2, 2 * C
    return out


def block_products(res, C, h, ws, images, train) -> List[Product]:
    """One SwinV2 block over `images` images."""
    M, L, T = images * res * res, ws * ws, (2 * ws - 1) ** 2
    t = train
    return [
        lin("qkv", 3 * M, C, C, t, t),  # three products of the same shape
        ("scores", 2.0 * M * L * C, t, t),
        ("attn_v", 2.0 * M * L * C, t, t),
        lin("proj", M, C, C, t, t),
        lin("fc1", M, C, 4 * C, t, t),
        lin("fc2", M, 4 * C, C, t, t),
        lin("cpb1", T, 2, 512, False, t),
        lin("cpb2", T, 512, h, t, t),
    ]


def block_params(C, h) -> int:
    return 12 * C * C + 8 * C + 4 * C + h + 3 * 512 + 512 * h


def products(model: dict, images: int, train: bool) -> List[Product]:
    """The patch embedding, the blocks and the patch mergings."""
    bb = model["backbone"]
    t = train
    p = bb["patch_size"]
    res0 = model["img_size"] // p
    out = [lin("patch_embed", images * res0 * res0, 3 * p * p, bb["embed_dim"], False, t)]
    st = stages(model)
    for s, (res, C, h, ws) in enumerate(st):
        for _ in range(bb["depths"][s]):
            out += [(f"block{s}." + n, f, a, b)
                    for n, f, a, b in block_products(res, C, h, ws, images, t)]
        if s < len(st) - 1:
            out.append(lin(f"merge{s}", images * (res // 2) ** 2, 4 * C, 2 * C, t, t))
    return out


def block_bounds(model: dict, images: int) -> Dict[str, float]:
    bb = model["backbone"]
    fwd = bwd = 0.0
    for s, (res, C, h, ws) in enumerate(stages(model)):
        act = images * res * res * C * 2.0
        par = block_params(C, h) * 2.0
        prods = block_products(res, C, h, ws, images, True)
        f = forward_flops(prods)
        b = step_flops(prods) - f
        for _ in range(bb["depths"][s]):
            fwd += max(f / BF16_FLOPS, (2 * act + par) / HBM_BYTES_PER_S)
            bwd += max(b / BF16_FLOPS, (3 * act + 2 * par) / HBM_BYTES_PER_S)
    return {"fwd_s": fwd, "bwd_s": bwd}
