"""Backbone kinds (``portbench.backbones``): a kind that is new files only
runs through the reference Poser, the weights and the FLOP counts; an
unknown kind names the file it looked for; and the ``swinv2`` kind gives
the four one-card cells what they had before kinds existed (values pinned
at the commit before the move: the full-size counts and bounds exactly,
the tiny size's weights to the bit and its reference outputs to
rounding)."""

import hashlib
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import backbones, flops
from portbench.cell import load_cell
from portbench.inputs import crops
from portbench.reference import Poser, reference_numerics, reference_steps, trained
from portbench.tests.tiny import tiny_cell
from portbench.weights import calibrate, load_reference, make_mano, make_weights

KINDS = Path(__file__).resolve().parent / "kinds"
VIT = {"kind": "prenorm_vit", "name": "tiny-vit", "embed_dim": 16, "depth": 2, "num_heads": 2,
       "patch_size": 8, "mlp_ratio": 4.0, "layer_norm_eps": 1e-6}
INPUTS = ("patches", "square_bboxes", "timestamp", "focal", "princpt")


@pytest.fixture
def test_kinds(monkeypatch):
    monkeypatch.setattr(backbones, "HERE", KINDS)


@pytest.mark.parametrize("train", [False, True])
def test_new_kind_runs_through_reference_weights_and_flops(test_kinds, train):
    m = dict(load_cell("poser-train-b64").config["model"], img_size=32, backbone=VIT,
             num_spatial_layer=2, num_temporal_layer=1)
    ref = Poser(m)
    assert ref.heads == 2 and ref.query_token.shape == (3, 16)
    weights = make_weights(ref, 1, "cpu", served=False)
    load_reference(ref, weights, make_mano(1, "cpu"))
    b = crops(4, 1, 32, 1, "flops", "cpu", targets=True)
    calibrate(ref, [b[k] for k in INPUTS], 2)
    if not train:
        ref.requires_grad_(False)
    with reference_numerics("f32"), FlopCounterMode(display=False) as counter:
        if train:
            loss, _ = ref.loss(b, torch.Generator().manual_seed(0))
            torch.autograd.grad(loss, [p for n, p in ref.named_parameters() if trained(n)],
                                allow_unused=True)
        else:
            out = ref.predict(*[b[k] for k in INPUTS])["joint_cam"]
            assert out.shape == (4, 1, 21, 3) and bool(torch.isfinite(out).all())
    prods = flops.poser_products(m, 4, 1, train)
    want = flops.step_flops(prods) if train else flops.forward_flops(prods)
    assert counter.get_total_flops() == want
    bounds = flops.block_bounds(m, 4)
    assert 0 < bounds["fwd_s"] < bounds["bwd_s"]


def test_unknown_kind_names_the_file():
    m = {"img_size": 32, "backbone": dict(VIT, kind="no_such_kind")}
    with pytest.raises(FileNotFoundError, match=r"no_such_kind\.py"):
        Poser(m)


# at the commit before kinds: (step FLOPs, forward FLOPs, products, their
# sha256, block bounds fwd and bwd in s) at each cell's own size
FULL = {
    "poser-train-b64": (8776962608128.0, 2926791676416.0, 297, "5fe00ae8693411d8",
                        0.0027645224245581397, 0.005529000136865519),
    "spenc-train-b64": (10530502686976.0, 4307851327616.0, 288, "20aa4b1785d7e529",
                        0.0027645224245581397, 0.005529000136865519),
    "poser-serve-b64": (2936859578880.0, 2936859578880.0, 348, "4d035f76923dff6b",
                        0.0027645224245581397, 0.005529000136865519),
    "spenc-stream-rt3-b1": (161995735240.0, 161995735240.0, 312, "3ef09291aa4366cb",
                            0.00013558091467515812, 0.0002708832931290161),
}
# at the tiny size, seed 5: (sha256 of the weights, of the calibrated
# statistics, the sum of the first step's joints or of the served joints,
# the three steps' losses)
TINY = {
    "poser-train-b64": ("f2c8b2310126c000", "0e84bfe063f75d29", -4493.263671875,
                        [545.3585815429688, 566.1591186523438, 478.9178771972656]),
    "spenc-train-b64": ("5920ec9f8b1b6fe9", "acb7dc79b1d27343", -5932.949436187744,
                        [490.19329833984375, 456.16571044921875, 459.5310974121094]),
    "poser-serve-b64": ("55ddd294674051c1", "38be01f456830978", -14794.845141649246, None),
    "spenc-stream-rt3-b1": ("c1bf713aec896c2c", "150923e2d1d4eade", 33295.90301036835, None),
}


def _sha(tensors) -> str:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return hashlib.sha256(flat.contiguous().numpy().tobytes()).hexdigest()[:16]


def _model(cell) -> dict:
    m = dict(cell.config["model"])
    if cell.kind != "train":
        m.update(cell.config["serve"]["model"])
    return m


@pytest.mark.parametrize("name", list(FULL))
def test_swin_full_size_counts_are_pinned(name):
    cell = load_cell(name)
    m = _model(cell)
    rows, frames = cell.params["batch"], cell.params.get("frames", 1)
    prods = flops.poser_products(m, rows, frames, cell.kind == "train")
    bounds = flops.block_bounds(m, rows * frames)
    sha = hashlib.sha256(json.dumps(prods).encode()).hexdigest()[:16]
    assert (flops.step_flops(prods), flops.forward_flops(prods), len(prods), sha,
            bounds["fwd_s"], bounds["bwd_s"]) == FULL[name]


@pytest.mark.parametrize("name", list(TINY))
def test_swin_reference_and_weights_are_pinned(name):
    cell = tiny_cell(name)
    m = _model(cell)
    train = cell.kind == "train"
    ref = Poser(m)
    weights = make_weights(ref, 5, "cpu", served=not train)
    mano = make_mano(5, "cpu")
    load_reference(ref, weights, mano)
    frames = 3 if cell.kind == "stream" else 1
    cal = crops(8, frames, 32, 5, "calibration", "cpu")
    inputs = [cal[k] for k in INPUTS]
    stats = calibrate(ref, inputs, 7)
    load_reference(ref, weights, mano, stats)
    w_sha, s_sha, jsum, losses = TINY[name]
    assert _sha(weights.values()) == w_sha and _sha(stats.values()) == s_sha
    if train:
        batches = [[crops(4, 1, 32, 6, f"batch{i}", "cpu", targets=True)] for i in range(3)]
        lgen = [torch.Generator().manual_seed(12)] if m.get("num_latent_layer") else None
        with reference_numerics("f32"):
            r = reference_steps(ref, batches, 1e-3, [torch.Generator().manual_seed(11)], lgen)
        joints = r["joints"]
        assert r["losses"] == pytest.approx(losses, rel=1e-6)
    else:
        with torch.no_grad(), reference_numerics("f32"):
            joints = ref.predict(*inputs)["joint_cam"]
    assert float(joints.double().sum()) == pytest.approx(jsum, rel=1e-6)
