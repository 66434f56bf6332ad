"""The backbone kind ``dinov2``: DINOv2 ViT (Oquab et al. 2023,
arXiv:2304.07193; ``facebook/dinov2-giant``), as ``portbench.backbones``
asks of a kind.

The reference follows the published layer equations (HF ``Dinov2Model``):
a stride-p patch convolution, the CLS token, a learned position table made
for ``image_size`` (37 x 37 patches and the CLS at 518 px); then per layer

    x = x + lambda1 * Attn(LN1(x)),   x = x + lambda2 * MLP(LN2(x))

with global multi-head attention ``softmax(q k^T / sqrt(d_h)) v`` (q, k
and v biased, an output projection), LayerScale vectors lambda1 and
lambda2, and a SwiGLU MLP (``weights_in`` to two halves h1, h2 of the
hidden width, ``weights_out(silu(h1) * h2)``; the hidden width
``int(D * mlp_ratio * 2 / 3)`` rounded up to a multiple of 8) or a GELU
one (``fc1``, ``fc2``); a final LayerNorm, and the patches without the CLS
token. Departures, each the program's documented rule: the position table
is resized to another patch grid bicubically as ``jax.image.resize`` does
(Keys cubic, a = -0.5, half-pixel centres, the kernel widened when
shrinking) where HF calls ``F.interpolate(..., mode="bicubic")``; the
LayerNorm's variance is E[x^2] - E[x]^2 (flax's); no stochastic depth (the
published ``drop_path_rate`` is 0, so ``gen`` draws nothing); no
``mask_token``, as in the program (only masked pretraining reads it).

The layers run over chunks of at most ``CHUNK`` images, each under
``torch.utils.checkpoint`` (non-reentrant) when autograd records, so that
a b48 ViT-g step fits on one card in float32: the mathematics is that of
the whole batch at once.

A block's bound is the larger of its FLOPs over the bf16 tensor-core peak
and its bytes over the memory bandwidth, the bytes its inputs read once and
its outputs written once in bf16 (x, the parameters and y forward; x, dy,
the parameters, dx and the parameter gradients backward). ``block_bounds``
also gives the attention core's (``attn_fwd_s``: q, k, v read and the
output written; ``attn_bwd_s``: q, k, v, the output and its gradient read,
the gradients of q, k and v written) and the MLP's forward (``mlp_fwd_s``:
both linears, the input, their parameters and the output).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.flops import Product, forward_flops, lin, step_flops
from portbench.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from portbench.reference.model import Holder, LayerNorm, Linear, PatchConv, gelu
from portbench.reference.precision import _MODE, matmul, reference_numerics

PROGRAM_CONFIG = ("image_size", "patch_size", "num_channels", "hidden_size",
                  "num_hidden_layers", "num_attention_heads", "mlp_ratio", "layer_norm_eps",
                  "layerscale_value", "use_swiglu_ffn")
PROGRAM_BLOCK = "cs_vit_tpu_torch.models.dinov2.Dinov2Layer"
# images a checkpointed chunk of the layers takes at once
CHUNK = 8


def outputs(model: dict):
    bb = model["backbone"]
    return bb["hidden_size"], bb["num_attention_heads"], model["img_size"] // bb["patch_size"]


def block_leaf(name: str) -> bool:
    return ".encoder.layer." in name


def mlp_out_weight(name: str) -> bool:
    return (name.startswith("backbone.encoder.layer.")
            and name.endswith((".mlp.weights_out.weight", ".mlp.fc2.weight")))


def mlp_hidden(bb: dict) -> int:
    """The MLP's hidden width (SwiGLU: each half's)."""
    D = bb["hidden_size"]
    if bb["use_swiglu_ffn"]:
        return (int(D * bb["mlp_ratio"] * 2 / 3) + 7) // 8 * 8
    return int(D * bb["mlp_ratio"])


# ---------------------------------------------------------------- reference


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out]: ``jax.image.resize``'s bicubic weights along one axis."""
    scale = n_out / n_in
    widen = max(1.0 / scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) / scale - 0.5
    w = _keys_cubic((sample[None] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
                    / widen)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None], w, torch.zeros_like(w))


class Embeddings(nn.Module):
    def __init__(self, bb: dict):
        super().__init__()
        D, p = bb["hidden_size"], bb["patch_size"]
        self.p, self.grid = p, bb["image_size"] // p
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.position_embeddings = nn.Parameter(torch.zeros(1, self.grid ** 2 + 1, D))
        self.patch_embeddings = Holder(projection=PatchConv(bb["num_channels"], D, p))

    def forward(self, x):
        B, H, W, _ = x.shape
        h, w = H // self.p, W // self.p
        D = self.cls_token.shape[-1]
        x = torch.cat([self.cls_token.expand(B, -1, -1), self.patch_embeddings.projection(x)], 1)
        pos = self.position_embeddings
        if (h, w) != (self.grid, self.grid):
            table = pos[:, 1:].reshape(1, self.grid, self.grid, D)
            wy = resize_weights(self.grid, h).to(x.device)
            wx = resize_weights(self.grid, w).to(x.device)
            table = torch.einsum("bHWd,Hh,Ww->bhwd", table, wy, wx).reshape(1, h * w, D)
            pos = torch.cat([pos[:, :1], table], 1)
        return x + pos


class _SelfAttention(nn.Module):
    def __init__(self, D, heads):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value = Linear(D, D), Linear(D, D), Linear(D, D)

    def forward(self, x):
        B, L, D = x.shape
        H = self.heads

        def split(t):
            return t.reshape(B, L, H, D // H).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        a = torch.softmax(matmul(q, k.transpose(-1, -2)) / math.sqrt(D // H), dim=-1)
        return matmul(a, v).transpose(1, 2).reshape(B, L, D)


class _Dense(nn.Module):
    def __init__(self, din, dout):
        super().__init__()
        self.dense = Linear(din, dout)

    def forward(self, x):
        return self.dense(x)


class _LayerScale(nn.Module):
    def __init__(self, D):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(D))

    def forward(self, x):
        return x * self.lambda1


class _Mlp(nn.Module):
    def __init__(self, bb: dict):
        super().__init__()
        D, hidden = bb["hidden_size"], mlp_hidden(bb)
        self.swiglu = bb["use_swiglu_ffn"]
        if self.swiglu:
            self.weights_in, self.weights_out = Linear(D, 2 * hidden), Linear(hidden, D)
        else:
            self.fc1, self.fc2 = Linear(D, hidden), Linear(hidden, D)

    def forward(self, x):
        if not self.swiglu:
            return self.fc2(gelu(self.fc1(x)))
        h1, h2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(h1 * torch.sigmoid(h1) * h2)


class Layer(nn.Module):
    def __init__(self, bb: dict):
        super().__init__()
        D, eps = bb["hidden_size"], bb["layer_norm_eps"]
        self.norm1, self.norm2 = LayerNorm(D, eps), LayerNorm(D, eps)
        self.attention = Holder(attention=_SelfAttention(D, bb["num_attention_heads"]),
                                output=_Dense(D, D))
        self.layer_scale1, self.layer_scale2 = _LayerScale(D), _LayerScale(D)
        self.mlp = _Mlp(bb)

    def forward(self, x):
        a = self.attention.output(self.attention.attention(self.norm1(x)))
        x = x + self.layer_scale1(a)
        return x + self.layer_scale2(self.mlp(self.norm2(x)))


class Backbone(nn.Module):
    """DINOv2: the patches after the final LayerNorm, without the CLS."""

    def __init__(self, bb: dict, image_size: int):
        super().__init__()
        self.embeddings = Embeddings(bb)
        self.encoder = Holder(layer=nn.ModuleList(Layer(bb)
                                                  for _ in range(bb["num_hidden_layers"])))
        self.layernorm = LayerNorm(bb["hidden_size"], bb["layer_norm_eps"])

    def _layers(self, x, mode):
        # the products' precision, set again for a recomputation on autograd's thread
        with reference_numerics(mode):
            for layer in self.encoder.layer:
                x = layer(x)
        return x

    def forward(self, x, gen=None):
        x = self.embeddings(x)
        mode = _MODE.get()
        if torch.is_grad_enabled():
            x = torch.cat([checkpoint(self._layers, c, mode, use_reentrant=False)
                           for c in x.split(CHUNK)])
        else:
            x = torch.cat([self._layers(c, mode) for c in x.split(CHUNK)])
        return self.layernorm(x)[:, 1:]


# ---------------------------------------------------------------- work


def _shape(model: dict, images: int):
    """(backbone, grid side, tokens an image, token rows, width, MLP hidden)."""
    bb = model["backbone"]
    n = model["img_size"] // bb["patch_size"]
    L = n * n + 1
    return bb, n, L, images * L, bb["hidden_size"], mlp_hidden(bb)


def _layer(M, L, D, hidden, swiglu, t) -> List[Product]:
    mlp = ([lin("weights_in", M, D, 2 * hidden, t, t), lin("weights_out", M, hidden, D, t, t)]
           if swiglu else
           [lin("fc1", M, D, hidden, t, t), lin("fc2", M, hidden, D, t, t)])
    return [lin("qkv", 3 * M, D, D, t, t),  # three products of the same shape
            ("scores", 2.0 * M * L * D, t, t), ("attn_v", 2.0 * M * L * D, t, t),
            lin("proj", M, D, D, t, t)] + mlp


def products(model: dict, images: int, train: bool) -> List[Product]:
    """The patch embedding, the position table's resize (a product with
    constant weights along each axis, as ``torch.einsum`` pairs them) and
    the layers."""
    bb, n, L, M, D, hidden = _shape(model, images)
    p, g = bb["patch_size"], bb["image_size"] // bb["patch_size"]
    t = train
    out = [lin("patch_embed", images * n * n, bb["num_channels"] * p * p, D, False, t)]
    if n != g:
        out += [("pos_resize.rows", 2.0 * g * g * D * n, t, False),
                ("pos_resize.cols", 2.0 * n * g * D * n, t, False)]
    for i in range(bb["num_hidden_layers"]):
        out += [(f"layer{i}." + k, f, a, b)
                for k, f, a, b in _layer(M, L, D, hidden, bb["use_swiglu_ffn"], t)]
    return out


def _bound(flop, nbytes) -> float:
    return max(flop / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def block_bounds(model: dict, images: int) -> Dict[str, float]:
    bb, n, L, M, D, hidden = _shape(model, images)
    swiglu = bb["use_swiglu_ffn"]
    prods = _layer(M, L, D, hidden, swiglu, True)
    f, act = forward_flops(prods), M * D * 2.0
    mlp_par = (D * hidden * (3 if swiglu else 2) + hidden * (2 if swiglu else 1) + D) * 2.0
    par = (4 * D * D + 4 * D) * 2.0 + 6 * D * 2.0 + mlp_par  # attention, norms, scales, MLP
    core = [x for x in prods if x[0] in ("scores", "attn_v")]
    core_f = forward_flops(core)
    mlp = prods[-2:]
    depth = bb["num_hidden_layers"]
    return {"fwd_s": depth * _bound(f, 2 * act + par),
            "bwd_s": depth * _bound(step_flops(prods) - f, 3 * act + 2 * par),
            "attn_fwd_s": depth * _bound(core_f, 4 * act),
            "attn_bwd_s": depth * _bound(step_flops(core) - core_f, 8 * act),
            "mlp_fwd_s": depth * _bound(forward_flops(mlp), 2 * act + mlp_par)}


__all__ = ["Backbone", "CHUNK", "PROGRAM_BLOCK", "PROGRAM_CONFIG", "block_bounds", "block_leaf",
           "mlp_out_weight", "outputs", "products", "resize_weights"]
