"""The ``dinov2`` backbone kind and the cells ``dinov2g224-train-b48`` and
``poser-finetune-dexycb-b64``: the kind's products and block bounds against
hand counts and torch's FLOP counter at a tiny size; both workload files
load by name; the new readers read a hand-built trace as designed; the data
path's plain reference holds the program's loader, and not a loader that
took other rows or frames; and both cells run end to end at a tiny size on
the CPU, correct when sound and not correct under the control and the
planted faults."""

import copy
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, program_feed
from portbench.backbones import dinov2 as kind
from portbench.cell import HERE, ROOT, load_cell, reader
from portbench.inputs import crops
from portbench.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from portbench.reference import Poser, reference_numerics, trained
from portbench.reference import data as data_reference
from portbench.run import run_cell
from portbench.tests.tiny import TINY_BACKBONE, TINY_LIMITS
from portbench.tracing import Trace
from portbench.weights import load_reference, make_mano, make_weights

BB = {"kind": "dinov2", "image_size": 70, "patch_size": 14, "num_channels": 3, "hidden_size": 48,
      "num_hidden_layers": 2, "num_attention_heads": 4, "mlp_ratio": 4, "layer_norm_eps": 1e-6,
      "layerscale_value": 1.0, "use_swiglu_ffn": True}
INPUTS = ("patches", "square_bboxes", "timestamp", "focal", "princpt")
NEW = ("dinov2g224-train-b48", "poser-finetune-dexycb-b64")


def _model(name="tiny") -> dict:
    return {"img_size": 56, "backbone": dict(BB, name=name), "num_joints": 16,
            "num_spatial_layer": 2, "spatial_layer_type": "decoder", "num_temporal_layer": 1,
            "temporal_supervision": "full", "trope_scalar": 20.0, "num_latent_layer": None,
            "persp_embed_method": "dense", "persp_decorate": "query",
            "global_positioning": "direct"}


def test_products_and_bounds_by_hand():
    """Width 48, 4 x 4 patches + CLS = 17 tokens an image, 2 images: 34
    token rows; SwiGLU hidden 128 a half; the 5 x 5 table resized to 4 x 4."""
    m = _model()
    prods = {n: (f, a, b) for n, f, a, b in kind.products(m, 2, True)}
    assert prods["patch_embed"] == (2 * 32 * 588 * 48, False, True)
    assert prods["pos_resize.rows"][0] == 2 * 25 * 48 * 4
    assert prods["pos_resize.cols"][0] == 2 * 4 * 5 * 48 * 4
    assert prods["layer0.qkv"][0] == 2 * 3 * 34 * 48 * 48
    assert prods["layer1.scores"][0] == prods["layer1.attn_v"][0] == 2 * 34 * 17 * 48
    assert prods["layer0.weights_in"][0] == 2 * 34 * 48 * 256
    assert prods["layer0.weights_out"][0] == 2 * 34 * 128 * 48
    assert len(prods) == 3 + 2 * 6
    b = kind.block_bounds(m, 2)
    act, core = 34 * 48 * 2.0, 2 * (2 * 34 * 17 * 48)
    mlp_f = 2 * 34 * 48 * 256 + 2 * 34 * 128 * 48
    mlp_par = (48 * 128 * 3 + 128 * 2 + 48) * 2.0
    assert b["attn_fwd_s"] == pytest.approx(2 * max(core / BF16_FLOPS, 4 * act / HBM_BYTES_PER_S))
    assert b["attn_bwd_s"] == pytest.approx(
        2 * max(2 * core / BF16_FLOPS, 8 * act / HBM_BYTES_PER_S))
    assert b["mlp_fwd_s"] == pytest.approx(
        2 * max(mlp_f / BF16_FLOPS, (2 * act + mlp_par) / HBM_BYTES_PER_S))
    assert 0 < b["fwd_s"] < b["bwd_s"] and b["mlp_fwd_s"] < b["fwd_s"]


def test_full_size_counts():
    """About 0.61 TFLOP a 224-px ViT-g/14 crop's backbone forward (582
    GFLOP of block linears, 16 of attention), a b48 step's blocks bound by
    their FLOPs."""
    m = load_cell("dinov2g224-train-b48").config["model"]
    backbone = sum(f for n, f, _, _ in kind.products(m, 1, False))
    assert backbone == pytest.approx(0.61e12, rel=0.03)
    b = flops.block_bounds(m, 48)
    assert 0.025 < b["fwd_s"] < 0.035 and 1.9 < b["bwd_s"] / b["fwd_s"] < 2.1


@pytest.mark.parametrize("train", [False, True])
def test_products_agree_with_torch_counter(train):
    """Training, the reference recomputes its layers' forward once under
    the checkpoint: the counter sees the step's FLOPs and that."""
    m = _model()
    ref = Poser(m)
    load_reference(ref, make_weights(ref, 1, "cpu", False), make_mano(1, "cpu"))
    if not train:
        ref.requires_grad_(False)
    b = crops(4, 1, 56, 1, "flops", "cpu", targets=True)
    with reference_numerics("f32"), FlopCounterMode(display=False) as counter:
        if train:
            loss, _ = ref.loss(b, torch.Generator().manual_seed(0))
            torch.autograd.grad(loss, [p for n, p in ref.named_parameters() if trained(n)],
                                allow_unused=True)
        else:
            ref.predict(*[b[k] for k in INPUTS])
    prods = flops.poser_products(m, 4, 1, train)
    want = flops.forward_flops(prods)
    if train:
        want = flops.step_flops(prods) + sum(f for n, f, _, _ in prods
                                             if n.startswith("layer"))
    assert counter.get_total_flops() == want


@pytest.mark.parametrize("name", NEW)
def test_new_workloads_load(name):
    cell = load_cell(name)
    assert cell.chips == 1 and cell.kind in ("train", "finetune")
    names = {m["name"] for m in cell.per_layer}
    assert {"kernels_per_step.train", "mfu.train", "device_idle.train"} <= names
    if name == "dinov2g224-train-b48":
        assert {"block_fwd_roofline.train", "attn_roofline.train",
                "mlp_fwd_roofline.train"} <= names
        assert "block_bwd_roofline.train" not in names  # it reads Swin's backward
        assert cell.config["reduced"] == [] and cell.config["model"]["backbone"]["kind"] == "dinov2"
    else:
        assert {"data_idle_ms.train", "loader_cpu_ms.train", "block_bwd_roofline.train"} <= names
        assert {"data_patch_gap", "data_label_gap"} <= set(cell.limits)


def _x(name, cat, ts, end, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts, "tid": tid,
            "args": args}


def _trace(with_spans=True):
    """One unit (0-1000 us): the loader wait 0-100 (a copy at 50-60), an
    attention forward span 200-300 launching a kernel of 40 us, an MLP span
    300-400 with two kernels of 30 us, the attention backward's host op on
    autograd's thread 500-600 launching a kernel of 60 us."""
    ev = [_x("pb.unit", "user_annotation", 0, 1000)]
    if with_spans:
        ev += [_x("csvit.data.wait", "user_annotation", 0, 100),
               _x("csvit.vit.attn", "user_annotation", 200, 300),
               _x("csvit.vit.mlp", "user_annotation", 300, 400)]
    ev.append(_x("aten::_scaled_dot_product_flash_attention_backward", "cpu_op", 500, 600, 2))
    for i, (tid, launch, k0, k1, cat) in enumerate([
            (1, 45, 50, 60, "gpu_memcpy"), (1, 205, 210, 250, "kernel"),
            (1, 305, 310, 340, "kernel"), (1, 345, 350, 380, "kernel"),
            (2, 505, 510, 570, "kernel")]):
        ev += [_x("cudaLaunchKernel", "cuda_runtime", launch, launch + 3, tid, correlation=i),
               _x(f"k{i}", cat, k0, k1, 7, correlation=i)]
    info = {"unit_s": 1e-3, "flops": 1.0,
            "block_bounds": {"fwd_s": 1e-6, "bwd_s": 1e-6, "attn_fwd_s": 20e-6,
                             "attn_bwd_s": 30e-6, "mlp_fwd_s": 15e-6}}
    return Trace({"traceEvents": ev}, info)


def test_new_readers_read_a_hand_built_trace():
    t = _trace()
    assert reader("layers", "attn_roofline.train")(t) == pytest.approx(100 * 50 / 100)
    assert reader("layers", "mlp_fwd_roofline.train")(t) == pytest.approx(100 * 15 / 60)
    assert reader("layers", "data_idle_ms.train")(t) == pytest.approx(0.090)
    bare = _trace(with_spans=False)
    for name in ("attn_roofline.train", "mlp_fwd_roofline.train", "data_idle_ms.train",
                 "loader_cpu_ms.train"):
        assert reader("layers", name)(bare) is None
    bare.info = dict(bare.info, loader_cpu_ms=12.5)
    assert reader("layers", "loader_cpu_ms.train")(bare) == 12.5
    swin = _trace()
    swin.info = dict(swin.info, block_bounds={"fwd_s": 1e-6, "bwd_s": 1e-6})
    assert reader("layers", "attn_roofline.train")(swin) is None
    assert reader("layers", "mlp_fwd_roofline.train")(swin) is None


def _tiny(name, hf_dir):
    bench = json.load(open(ROOT / "BENCHMARK.json"))
    w = json.load(open(HERE / "workloads" / f"{name}.json"))
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == w["config"])
    config = copy.deepcopy(json.load(open(ROOT / cfg_file)))
    params = {"batch": 4, "pool": 4, "calibration": 8, "keep_at": 5, "trace_units": 1}
    if name == "dinov2g224-train-b48":
        config["model"].update(_model(str(hf_dir)))
    else:
        config["model"].update(img_size=32, backbone=TINY_BACKBONE, num_spatial_layer=2,
                               num_temporal_layer=1)
        params.update(sequences=2, frames=8, frame_hw=[120, 160], repeat=2)
    config["train"]["dtype"] = config["serve"]["dtype"] = "float32"
    # the data gaps keep the cell's limits (f32 patches here, bf16 there)
    w = dict(w, params=params, limits={k: TINY_LIMITS.get(k, v) for k, v in w["limits"].items()})
    return load_cell(name, bench, config, w)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    hf = {k: v for k, v in BB.items() if k != "kind"}
    (d / "config.json").write_text(json.dumps(dict(hf, model_type="dinov2")))
    return d


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("fault", [None, "control", "half", "frozen", "dw"])
def test_tiny_run(name, fault, hf_dir):
    r = run_cell(name, 7, 0.2, fault is None, device="cpu", cell=_tiny(name, hf_dir),
                 fault=fault)
    assert r["correct"] == (fault is None), r["checks"]
    assert r["attempted"] > 0
    if name == "poser-finetune-dexycb-b64":
        assert r["checks"]["data_patch_gap"]["value"] < 1e-5  # the program's f32 patches
        if fault is None:
            assert r["metrics"]["loader_cpu_ms.train"]["value"] >= 0


@pytest.mark.parametrize("fault", [None, "epoch", "next_frame", "left_as_right"])
def test_data_reference_holds_the_loader(tmp_path, fault):
    """Batch 0 of the program's feed (bf16 patches, as the cell's) against
    the reference's: under the cell's limits; over them when the reference
    reads the rows of another epoch, each row's next frame, or a left hand
    unmirrored (a loader at fault in that way reads the same)."""
    cell = load_cell("poser-finetune-dexycb-b64")
    config = copy.deepcopy(cell.config)
    config["model"]["img_size"] = 64
    groups = program_feed.dexycb_tree(str(tmp_path), 2, 8, (120, 160), 5, 2)
    feed = program_feed.finetune_feed(config, 16, str(tmp_path), groups, 11, "cpu")
    got = {k: v.float().numpy() for k, v in next(feed).items()}
    feed.close()
    assert got["patches"].shape == (16, 1, 64, 64, 3)
    epoch, want_groups = 1, groups
    if fault == "epoch":
        epoch = 2
    elif fault == "next_frame":
        want_groups = {n: dict(g, imgs_path=g["imgs_path"][[*range(1, 8), 0]])
                       for n, g in groups.items()}
    elif fault == "left_as_right":
        want_groups = {n: dict(g, handedness=np.asarray([b"right"]))
                       for n, g in groups.items()}
    rows = data_reference.batch_rows(32, 11, epoch, 0, 16)
    assert (rows >= 16).any() and (rows < 16).any()  # both hands: seq001 is a left one
    want = data_reference.dexycb_batch(want_groups, str(tmp_path), program_feed.mano_pca(),
                                       rows, epoch, program_feed.ITEM_SEED,
                                       **program_feed.crop(config))
    gaps = data_reference.gaps(got, want)
    within = all(gaps[k] <= cell.limits[k] for k in gaps)
    assert within == (fault is None), gaps
