"""The benchmark's files resolve by name, BENCHMARK.json keeps to its
contract, the FLOP counts agree with torch's counter on the reference, and
the trace readers read what a trace holds."""

import json
import re

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops
from portbench.cell import HERE, ROOT, driver_module, load_cell, reader
from portbench.inputs import crops
from portbench.reference import Poser, reference_numerics, trained
from portbench.tests.tiny import TINY_BACKBONE
from portbench.tracing import Trace
from portbench.weights import load_reference, make_mano, make_weights

BENCH = json.load(open(ROOT / "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = load_cell(name)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell.workload["config"])
    assert cell.config["name"] == entry["name"]
    assert hasattr(driver_module(cell.kind), "Driver")
    for m in cell.end_to_end:
        assert callable(reader("e2e", m["name"]))
    for m in cell.per_layer:
        assert callable(reader("layers", m["name"]))
    assert all(v is not None for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.load(open(ROOT / c["file"]))["reduced"]
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        workload = json.load(open(HERE / "workloads" / f"{w['name']}.json"))
        assert workload["why"] == w["why"] and workload["params"].get("world", 1) in (1, w["chips"])
    # cells of four cards: at most a quarter of the cells, rounded down, or one
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


def _tiny_model(kind: str, train: bool) -> dict:
    m = {"img_size": 32, "backbone": TINY_BACKBONE, "num_joints": 16, "num_spatial_layer": 2,
         "spatial_layer_type": "decoder", "num_temporal_layer": 2, "temporal_supervision": "full",
         "trope_scalar": 20.0, "num_latent_layer": None, "persp_embed_method": "dense",
         "persp_decorate": "query", "global_positioning": "direct"}
    if kind == "spenc":
        m.update(spatial_layer_type="encoder", persp_decorate="patch",
                 temporal_supervision="realtime", num_latent_layer=2 if train else None)
    return m


@pytest.mark.parametrize("kind", ["poser", "spenc"])
@pytest.mark.parametrize("train", [False, True])
def test_flops_agree_with_torch_counter(kind, train):
    m = _tiny_model(kind, train)
    frames = 3 if kind == "spenc" and not train else 1
    ref = Poser(m)
    load_reference(ref, make_weights(ref, 1, "cpu", False), make_mano(1, "cpu"))
    if not train:
        ref.requires_grad_(False)
    b = crops(4, frames, 32, 1, "flops", "cpu", targets=True)
    b["timestamp"] = 33.3 * torch.arange(frames).float()[None].repeat(4, 1)
    with reference_numerics("f32"), FlopCounterMode(display=False) as counter:
        if train:
            loss, _ = ref.loss(b, torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
            torch.autograd.grad(loss, [p for n, p in ref.named_parameters() if trained(n)],
                                allow_unused=True)
        else:
            ref.predict(b["patches"], b["square_bboxes"], b["timestamp"], b["focal"], b["princpt"])
    prods = flops.poser_products(m, 4, frames, train)
    want = flops.step_flops(prods) if train else flops.forward_flops(prods)
    assert counter.get_total_flops() == want


def test_full_size_counts():
    """43.6 GFLOP a SwinV2-B-256 crop's backbone forward (the paper's 21.8 G
    multiply-adds), and block bounds set by the FLOPs at b64."""
    m = load_cell("poser-train-b64").config["model"]
    backbone = sum(f for n, f, _, _ in flops.poser_products(m, 1, 1, False)
                   if n.startswith(("patch_embed", "block", "merge")))
    assert backbone == pytest.approx(43.6e9, rel=0.03)
    bounds = flops.block_bounds(m, 64)
    assert 2.0e-3 < bounds["fwd_s"] < 3.5e-3 and 1.9 < bounds["bwd_s"] / bounds["fwd_s"] < 2.1


def _trace():
    """Two units on one thread; a block span launching two kernels and a
    copy; a gap of 30 us while the host syncs."""
    X = "X"
    ev = [
        {"ph": X, "cat": "user_annotation", "name": "pb.unit", "ts": 0, "dur": 100, "tid": 1},
        {"ph": X, "cat": "user_annotation", "name": "pb.unit", "ts": 200, "dur": 100, "tid": 1},
        {"ph": X, "cat": "user_annotation", "name": "pb.block", "ts": 5, "dur": 20, "tid": 1},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 1, "tid": 1,
         "args": {"correlation": 1}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1, "tid": 1,
         "args": {"correlation": 2}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 210, "dur": 1, "tid": 1,
         "args": {"correlation": 3}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 40, "dur": 50,
         "tid": 1, "args": {"correlation": 4}},
        {"ph": X, "cat": "kernel", "name": "k1", "ts": 20, "dur": 20, "args": {"correlation": 1}},
        {"ph": X, "cat": "kernel", "name": "k2", "ts": 40, "dur": 30, "args": {"correlation": 2}},
        {"ph": X, "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 220,
         "dur": 40, "args": {"correlation": 3}},
    ]
    info = {"unit_s": 200e-6, "flops": 989e12 * 100e-6, "block_bounds": {"fwd_s": 25e-6, "bwd_s": 1}}
    return Trace({"traceEvents": ev}, info)


def test_readers_read_the_trace():
    t = _trace()
    assert t.n_units == 2 and t.busy_us() == 90
    assert reader("layers", "kernels_per_step.train")(t) == 1.0
    assert reader("layers", "syncs_per_step.train")(t) == 0.5
    assert reader("layers", "h2d_ms.batch")(t) == pytest.approx(0.02)
    assert reader("layers", "block_fwd_roofline.batch")(t) == pytest.approx(100 * 25 / 25)
    assert reader("layers", "block_bwd_roofline.train")(t) is None
    assert reader("layers", "heads_fwd_ms.train")(t) is None
    assert reader("layers", "mfu.train")(t) == pytest.approx(50.0)
    assert reader("layers", "device_idle.train")(t) == pytest.approx(100 * (1 - 45 / 200))
    gaps = dict(t.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert t.top_device_ops()[0][0] == "Memcpy HtoD (Pageable -> Device)"
