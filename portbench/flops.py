"""Operations and bytes of the model's work, from a configuration's shapes.

Every product of the reference is listed with its forward FLOPs (2 per
multiply-add) and whether the backward of a spatial train step forms the
gradient of its first operand, its second, or neither; the backward adds
the forward's FLOPs once for each. Elementwise work, norms and softmax are
not counted: the counts are those of ``torch.utils.flop_counter`` over the
reference, which the tests hold them to.

The backbone's products and its blocks' bounds are its kind's
(``portbench.backbones``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .backbones import kind as backbone_kind

# (name, forward FLOPs, grad of operand a, grad of operand b)
Product = Tuple[str, float, bool, bool]


def lin(name, rows, din, dout, ga, gb) -> Product:
    return (name, 2.0 * rows * din * dout, ga, gb)


def _attn_block(pre, rows, lq, lk, D, self_attn, t_params, g_in, g_ctx) -> List[Product]:
    """q from `lq` tokens, k and v from `lk` tokens, over `rows` sequences;
    output projection; `g_in`/`g_ctx` whether the inputs need gradients."""
    q, k = rows * lq, rows * lk
    g_q = g_in or t_params
    g_kv = (g_in if self_attn else g_ctx) or t_params
    return [
        lin(pre + "q", q, D, D, g_in, t_params),
        lin(pre + "k", k, D, D, g_in if self_attn else g_ctx, t_params),
        lin(pre + "v", k, D, D, g_in if self_attn else g_ctx, t_params),
        (pre + "scores", 2.0 * q * lk * D, g_q, g_kv),
        (pre + "attn_v", 2.0 * q * lk * D, g_q or g_kv, g_kv),
        lin(pre + "out", q, D, D, g_q or g_kv, t_params),
    ]


def _ffn(pre, tokens, D, g_in, t) -> List[Product]:
    return [lin(pre + "fc1", tokens, D, 4 * D, g_in, t),
            lin(pre + "fc2", tokens, 4 * D, D, g_in or t, t)]


def poser_products(model: dict, rows: int, frames: int, train: bool) -> List[Product]:
    """The reference Poser's products for `rows` samples of `frames`
    frames: inference (``train`` False) or the spatial train step's forward
    with its gradient flags (the latent group then doubles the rows after
    the backbone)."""
    kind = backbone_kind(model)
    N = rows * frames
    t = train
    out: List[Product] = kind.products(model, N, t)
    D, _, num_p = kind.outputs(model)
    P = num_p ** 2
    # perspective MLP
    out.append(lin("persp.proj", N, 512, D, False, t))
    out += [lin(f"persp.{i}", N, D, D, t, t) for i in range(4)]
    n = 1
    latent = train and model.get("num_latent_layer")
    if latent:
        for e in ("angle", "scale"):
            out.append(lin(f"latent.{e}_embed", N, 64, D, False, False))
            out += [lin(f"latent.{e}_mlp{i}", N, D, D, False, False) for i in range(3)]
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
            out.append(lin(f"{k}_zero_conv", rows * To, D, D, False, False))
    rt = n * rows * To  # rows of the heads and the hand model
    out += [lin("pose_head", rt, D, model["num_joints"] * 6, t, t),
            lin("shape_head", rt, D, 10, t, t), lin("root_head", rt, D, 3, t, t)]
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
    forward and vector-Jacobian product, in bf16 (its kind's)."""
    return backbone_kind(model).block_bounds(model, images)
