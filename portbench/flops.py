"""Operations and bytes of the model's work, from a configuration's shapes.

Every product of the reference is listed with its forward FLOPs (2 per
multiply-add) and whether the backward of a spatial train step forms the
gradient of its first operand, its second, or neither; the backward adds
the forward's FLOPs once for each. Elementwise work, norms and softmax are
not counted: the counts are those of ``torch.utils.flop_counter`` over the
reference, which the tests hold them to.

A SwinV2 block's bound is the larger of its FLOPs over the bf16 tensor-core
peak and its bytes over the memory bandwidth, where the bytes are its
inputs read once and its outputs written once in the compute dtype: x, the
parameters and y forward; x, dy, the parameters, dx and the parameter
gradients for its vector-Jacobian product. What an implementation saves or
recomputes is not counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .peaks import BF16_FLOPS, HBM_BYTES_PER_S

# (name, forward FLOPs, grad of operand a, grad of operand b)
Product = Tuple[str, float, bool, bool]


def _lin(name, rows, din, dout, ga, gb) -> Product:
    return (name, 2.0 * rows * din * dout, ga, gb)


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
        _lin("qkv", 3 * M, C, C, t, t),  # three products of the same shape
        ("scores", 2.0 * M * L * C, t, t),
        ("attn_v", 2.0 * M * L * C, t, t),
        _lin("proj", M, C, C, t, t),
        _lin("fc1", M, C, 4 * C, t, t),
        _lin("fc2", M, 4 * C, C, t, t),
        _lin("cpb1", T, 2, 512, False, t),
        _lin("cpb2", T, 512, h, t, t),
    ]


def block_params(C, h) -> int:
    return 12 * C * C + 8 * C + 4 * C + h + 3 * 512 + 512 * h


def _attn_block(pre, rows, lq, lk, D, self_attn, t_params, g_in, g_ctx) -> List[Product]:
    """q from `lq` tokens, k and v from `lk` tokens, over `rows` sequences;
    output projection; `g_in`/`g_ctx` whether the inputs need gradients."""
    q, k = rows * lq, rows * lk
    g_q = g_in or t_params
    g_kv = (g_in if self_attn else g_ctx) or t_params
    return [
        _lin(pre + "q", q, D, D, g_in, t_params),
        _lin(pre + "k", k, D, D, g_in if self_attn else g_ctx, t_params),
        _lin(pre + "v", k, D, D, g_in if self_attn else g_ctx, t_params),
        (pre + "scores", 2.0 * q * lk * D, g_q, g_kv),
        (pre + "attn_v", 2.0 * q * lk * D, g_q or g_kv, g_kv),
        _lin(pre + "out", q, D, D, g_q or g_kv, t_params),
    ]


def _ffn(pre, tokens, D, g_in, t) -> List[Product]:
    return [_lin(pre + "fc1", tokens, D, 4 * D, g_in, t),
            _lin(pre + "fc2", tokens, 4 * D, D, g_in or t, t)]


def poser_products(model: dict, rows: int, frames: int, train: bool) -> List[Product]:
    """The reference Poser's products for `rows` samples of `frames`
    frames: inference (``train`` False) or the spatial train step's forward
    with its gradient flags (the latent group then doubles the rows after
    the backbone)."""
    bb = model["backbone"]
    N = rows * frames
    t = train
    out: List[Product] = []
    p = bb["patch_size"]
    res0 = model["img_size"] // p
    out.append(_lin("patch_embed", N * res0 * res0, 3 * p * p, bb["embed_dim"], False, t))
    st = stages(model)
    for s, (res, C, h, ws) in enumerate(st):
        for _ in range(bb["depths"][s]):
            out += [(f"block{s}." + n, f, a, b)
                    for n, f, a, b in block_products(res, C, h, ws, N, t)]
        if s < len(st) - 1:
            out.append(_lin(f"merge{s}", N * (res // 2) ** 2, 4 * C, 2 * C, t, t))
    D = st[-1][1]
    P = st[-1][0] ** 2
    # perspective MLP
    out.append(_lin("persp.proj", N, 512, D, False, t))
    out += [_lin(f"persp.{i}", N, D, D, t, t) for i in range(4)]
    n = 1
    latent = train and model.get("num_latent_layer")
    if latent:
        for e in ("angle", "scale"):
            out.append(_lin(f"latent.{e}_embed", N, 64, D, False, False))
            out += [_lin(f"latent.{e}_mlp{i}", N, D, D, False, False) for i in range(3)]
        for i in range(model["num_latent_layer"]):
            out += _attn_block(f"latent.sr{i}.", N, P, P, D, True, False, t, t)
            out += _ffn(f"latent.sr{i}.", N * P, D, t, False)
        n = 2
    R = n * N  # rows after the latent group
    if model["spatial_layer_type"] == "decoder":
        for i in range(model["num_spatial_layer"]):
            out += _attn_block(f"spatial{i}.self.", R, 3, 3, D, True, t, t, t)
            out += _attn_block(f"spatial{i}.cross.", R, 3, P, D, False, t, t, t)
            out += _ffn(f"spatial{i}.", R * 3, D, t, t)
    else:
        for i in range(model["num_spatial_layer"]):
            g = t and i == model["num_spatial_layer"] - 1  # only the last layer's output is used
            out += _attn_block(f"spatial{i}.", R, 3 + P, 3 + P, D, True, g, g, g)
            out += _ffn(f"spatial{i}.", R * (3 + P), D, g, g)
    To = frames
    if not train:  # the temporal encoders (inference only)
        for k in ("pose", "shape", "root"):
            for i in range(model["num_temporal_layer"]):
                if model["temporal_supervision"] == "realtime":
                    out += _attn_block(f"{k}_temporal{i}.", rows, 1, frames, D, False,
                                       False, False, False)
                    out += _ffn(f"{k}_temporal{i}.", rows, D, False, False)
                else:
                    out += _attn_block(f"{k}_temporal{i}.", rows, frames, frames, D, True,
                                       False, False, False)
                    out += _ffn(f"{k}_temporal{i}.", rows * frames, D, False, False)
            To = 1 if model["temporal_supervision"] == "realtime" else frames
            out.append(_lin(f"{k}_zero_conv", rows * To, D, D, False, False))
    rt = n * rows * To  # rows of the heads and the hand model
    out += [_lin("pose_head", rt, D, model["num_joints"] * 6, t, t),
            _lin("shape_head", rt, D, 10, t, t), _lin("root_head", rt, D, 3, t, t)]
    J = model["num_joints"]
    if latent:  # the transformed half turned back
        half = rt // 2
        out += [("unrotate.rodrigues", 2.0 * 27 * half * J, t, t),
                ("unrotate.turn", 2.0 * 27 * half * J, False, t),
                ("unrotate.root", 2.0 * 9 * half, t, False)]
    V = 778
    out += [("mano.shape", 2.0 * rt * 10 * V * 3, t, False),
            ("mano.joints", 2.0 * rt * 16 * V * 3, False, t),
            ("mano.rodrigues", 2.0 * 27 * rt * 16, t, t),
            ("mano.posedirs", 2.0 * rt * 135 * V * 3, t, False),
            ("mano.chain", 2.0 * 64 * 15 * rt, t, t),
            ("mano.correction", 2.0 * 16 * 16 * rt, t, t),
            ("mano.skin", 2.0 * V * 16 * 16 * rt, False, t),
            ("mano.verts", 2.0 * 16 * V * rt, t, t),
            ("joints21", 2.0 * rt * 21 * V * 3, t, False)]
    return out


def forward_flops(products: List[Product]) -> float:
    return sum(f for _, f, _, _ in products)


def step_flops(products: List[Product]) -> float:
    """Forward plus backward of a train step."""
    return sum(f * (1 + ga + gb) for _, f, ga, gb in products)


def block_bounds(model: dict, images: int) -> Dict[str, float]:
    """Seconds: the sum over the backbone's blocks of each block's bound,
    forward and vector-Jacobian product, in bf16."""
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
