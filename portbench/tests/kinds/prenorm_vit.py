"""A test-only backbone kind ``prenorm_vit``: a plain pre-norm ViT (patch
embedding, a learned position table, blocks of global multi-head attention
and a GELU MLP, each as ``x + f(LayerNorm(x))``, a final LayerNorm), as the
next configuration's backbone would bring it; it shows that a kind is new
files only. No program runs it: ``PROGRAM_BLOCK`` names no class of it.

Configuration keys: ``embed_dim``, ``depth``, ``num_heads``,
``patch_size``, ``mlp_ratio``, ``layer_norm_eps``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from portbench.flops import Product, forward_flops, lin, step_flops
from portbench.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from portbench.reference.model import Holder, LayerNorm, Linear, PatchConv, Sequential, gelu
from portbench.reference.precision import matmul

PROGRAM_CONFIG = ("embed_dim", "depth", "num_heads", "patch_size", "mlp_ratio",
                  "layer_norm_eps")
PROGRAM_BLOCK = "no_program.Block"


def outputs(model: dict):
    bb = model["backbone"]
    return bb["embed_dim"], bb["num_heads"], model["img_size"] // bb["patch_size"]


def block_leaf(name: str) -> bool:
    return ".blocks." in name


def mlp_out_weight(name: str) -> bool:
    return name.startswith("backbone.blocks.") and name.endswith(".mlp.2.weight")


class Block(nn.Module):
    def __init__(self, dim, heads, hidden, eps):
        super().__init__()
        self.heads = heads
        self.norm1, self.norm2 = LayerNorm(dim, eps), LayerNorm(dim, eps)
        self.qkv, self.proj = Linear(dim, 3 * dim), Linear(dim, dim)
        self.mlp = Sequential(Linear(dim, hidden), None, Linear(hidden, dim), act=gelu)

    def forward(self, x):
        B, L, D = x.shape
        H = self.heads
        q, k, v = self.qkv(self.norm1(x)).reshape(B, L, 3, H, D // H).permute(2, 0, 3, 1, 4)
        a = torch.softmax(matmul(q, k.transpose(-1, -2)) / math.sqrt(D // H), dim=-1)
        x = x + self.proj(matmul(a, v).transpose(1, 2).reshape(B, L, D))
        return x + self.mlp(self.norm2(x))


class Backbone(nn.Module):
    def __init__(self, bb: dict, image_size: int):
        super().__init__()
        D, p = bb["embed_dim"], bb["patch_size"]
        self.patch = PatchConv(3, D, p)
        self.pos = Holder(weight=nn.Parameter(torch.zeros((image_size // p) ** 2, D)))
        self.blocks = nn.ModuleList(
            Block(D, bb["num_heads"], int(D * bb["mlp_ratio"]), bb["layer_norm_eps"])
            for _ in range(bb["depth"]))
        self.norm = LayerNorm(D, bb["layer_norm_eps"])

    def forward(self, x, gen=None):
        x = self.patch(x) + self.pos.weight
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


def _block(M, L, D, hidden, t) -> List[Product]:
    return [lin("qkv", M, D, 3 * D, t, t), ("scores", 2.0 * M * L * D, t, t),
            ("attn_v", 2.0 * M * L * D, t, t), lin("proj", M, D, D, t, t),
            lin("fc1", M, D, hidden, t, t), lin("fc2", M, hidden, D, t, t)]


def _shape(model: dict, images: int):
    bb = model["backbone"]
    L = (model["img_size"] // bb["patch_size"]) ** 2
    return bb, images * L, L, bb["embed_dim"], int(bb["embed_dim"] * bb["mlp_ratio"])


def products(model: dict, images: int, train: bool) -> List[Product]:
    bb, M, L, D, hidden = _shape(model, images)
    p = bb["patch_size"]
    out = [lin("patch_embed", M, 3 * p * p, D, False, train)]
    for i in range(bb["depth"]):
        out += [(f"block{i}." + n, f, a, b) for n, f, a, b in _block(M, L, D, hidden, train)]
    return out


def block_bounds(model: dict, images: int) -> Dict[str, float]:
    bb, M, L, D, hidden = _shape(model, images)
    prods = _block(M, L, D, hidden, True)
    f, act = forward_flops(prods), M * D * 2.0
    par = (4 * D * D + 2 * D * hidden + 9 * D + hidden) * 2.0
    fwd = max(f / BF16_FLOPS, (2 * act + par) / HBM_BYTES_PER_S)
    bwd = max((step_flops(prods) - f) / BF16_FLOPS, (3 * act + 2 * par) / HBM_BYTES_PER_S)
    return {"fwd_s": bb["depth"] * fwd, "bwd_s": bb["depth"] * bwd}
