"""What a run hands to the program and to the reference alike: weights,
MANO tensors and calibrated BatchNorm statistics, all made from the seed.

Weights come from one normal draw on the device, sliced leaf by leaf in
the reference's parameter order: LeCun-normal matrices (the temporal
``zero_conv`` too, nonzero as a trained checkpoint has it, so that the
temporal encoders change the output), except the query and key projections
of the head's attention, drawn d_h^-1/2 times smaller: that attention
multiplies its scores by sqrt(d_h), so at LeCun scale the scores of
calibrated inputs spread by d_h (32 at Swin-B's width) and the attention
is all but hard, and any rounding, bf16's or the reference's own, flips
its choices and moves the joints by tens to hundreds of mm; at this scale
they spread by about 1, as in a model that trains; biases N(0, 0.02^2), norm scales
1 + N(0, 0.02^2), logit scales ln 10, query tokens N(0, 1/D), position
tables N(0, 1), angle-embedding frequency banks logspace(0, 1). Served
weights are rounded to bf16, the type they are served in, and both sides
take the rounded values.

MANO: the licensed pickle is not in the repository, so a synthetic hand of
MANO's shapes (778 vertices, 16 joints, 10 shape and 135 pose-corrective
directions) is drawn from the seed, with joints regressed from soft vertex
neighbourhoods and skinning weights soft over the nearest joints; the
21-joint regressor adds the five fingertip vertices.

BatchNorm statistics: one reference forward over a calibration batch of
the cell's own traffic in the ``"calibrate"`` mode sets every running mean
and variance to the batch's, as a trained checkpoint holds statistics of
its data. Uncalibrated (mean 0, variance 1) the sqrt(d_h)-scaled decoder
attention turns rounding into large output differences.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import numpy as np
import torch

from .reference import Poser, reference_numerics

# fingertip vertices of MANO's mesh and the 21-joint output order
_FINGERTIPS = {"Thumb_4": 745, "Index_4": 317, "Middle_4": 445, "Ring_4": 556, "Pinky_4": 673}
_MANO_ORDER = ("Wrist", "Index_1", "Index_2", "Index_3", "Middle_1", "Middle_2", "Middle_3",
               "Pinky_1", "Pinky_2", "Pinky_3", "Ring_1", "Ring_2", "Ring_3",
               "Thumb_1", "Thumb_2", "Thumb_3")
_TARGET_ORDER = ("Wrist", "Thumb_1", "Thumb_2", "Thumb_3", "Thumb_4", "Index_1", "Index_2",
                 "Index_3", "Index_4", "Middle_1", "Middle_2", "Middle_3", "Middle_4",
                 "Ring_1", "Ring_2", "Ring_3", "Ring_4", "Pinky_1", "Pinky_2", "Pinky_3",
                 "Pinky_4")


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for stream `tag` of run seed `seed`."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _head_qk(name: str) -> bool:
    """A query or key projection of the head's multi-head attention (not
    the backbone's cosine attention, whose scores ignore q's and k's
    scale)."""
    return (not name.startswith("backbone.")
            and name.endswith(("query.weight", "key.weight")))


def make_weights(model: Poser, seed: int, device, served: bool) -> Dict[str, torch.Tensor]:
    """Every parameter of `model`'s schema, by name, f32 on `device`."""
    named = list(model.named_parameters())
    head_dim = model.query_token.shape[1] // model.heads
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device).manual_seed(derive(seed, "weights"))
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, p in named:
        z = draw[at:at + p.numel()].reshape(p.shape)
        at += p.numel()
        leaf = name.rsplit(".", 1)[-1]
        if name == "query_token":
            w = z * p.shape[1] ** -0.5
        elif leaf == "logit_scale":
            w = torch.full_like(z, math.log(10.0))
        elif name.endswith("pe.weight") or name.endswith("rope2d.embedding"):
            w = z
        elif leaf == "freq_base":
            w = torch.logspace(0, 1, p.shape[0], device=device)
        elif leaf == "bias":
            w = 0.02 * z
        elif p.dim() == 1:
            w = 1.0 + 0.02 * z
        else:
            w = z * math.prod(p.shape[1:]) ** -0.5
            if _head_qk(name):
                w = w * head_dim ** -0.5
        out[name] = w.to(torch.bfloat16).float() if served else w
    return out


def make_mano(seed: int, device) -> Dict[str, torch.Tensor]:
    """A synthetic MANO hand; names as the reference's ``mano`` buffers,
    plus ``j_regressor21``."""
    rng = np.random.default_rng(derive(seed, "mano"))
    V, J = 778, 16
    v = rng.normal(scale=0.03, size=(V, 3))
    v[:, 2] += 0.1
    shapedirs = rng.normal(scale=0.002, size=(V, 3, 10))
    posedirs = rng.normal(scale=0.0005, size=(135, V * 3))
    reg = np.zeros((J, V))
    for j, a in enumerate(rng.choice(V, size=J, replace=False)):
        w = np.exp(-(np.linalg.norm(v - v[a], axis=-1) / 0.01) ** 2)
        reg[j] = w / w.sum()
    d = np.linalg.norm(v[:, None] - (reg @ v)[None], axis=-1)
    lbs = np.exp(-d / 0.02 + (d / 0.02).min(axis=1, keepdims=True))
    lbs /= lbs.sum(axis=1, keepdims=True)
    pose_mean = np.concatenate([np.zeros(3), rng.normal(scale=0.05, size=45)])
    reg21 = np.zeros((21, V))
    for i, name in enumerate(_TARGET_ORDER):
        if name in _FINGERTIPS:
            reg21[i, _FINGERTIPS[name]] = 1.0
        else:
            reg21[i] = reg[_MANO_ORDER.index(name)]
    arrays = {"v_template": v, "shapedirs": shapedirs, "posedirs": posedirs,
              "j_regressor": reg, "lbs_weights": lbs, "pose_mean": pose_mean,
              "j_regressor21": reg21}
    return {k: torch.as_tensor(a, dtype=torch.float32, device=device) for k, a in arrays.items()}


def load_reference(model: Poser, weights, mano, stats=None) -> Poser:
    """Fill the reference with the run's tensors (statistics optional)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
        for name, t in (stats or {}).items():
            model.get_buffer(name).copy_(t)
        for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
                     "pose_mean"):
            model.mano.get_buffer(name).copy_(mano[name])
        model.j_regressor.copy_(mano["j_regressor21"])
    return model


def calibrate(model: Poser, inputs, latent_seed: int) -> Dict[str, torch.Tensor]:
    """Running statistics of every BatchNorm from one calibration forward
    over `inputs` (``predict``'s first five arguments), on the CPU."""
    dev = next(model.parameters()).device
    lgen = torch.Generator(dev).manual_seed(latent_seed) if model.latent_trans is not None else None
    with torch.no_grad(), reference_numerics("f32"):
        model.predict(*inputs, phase="calibrate", latent_gen=lgen)
    return {n: b.detach().cpu().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}
