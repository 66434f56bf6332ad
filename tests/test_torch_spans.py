"""The program's spans (``cs_vit_tpu_torch.utils.profiling.annotate``).

Without a profiler ``annotate`` hands out one shared null context and
enters no ``RecordFunction``; under ``utils.trace`` a tiny spatial step
(the test backbone of ``tests/test_torch_train.py``, B=2, T=1, f32) and a
tiny ``predict_crops`` (two chunks of a batch-4 session) record their
``csvit.*`` spans, each nested in its parent in the order the code runs
them; and the step's and the session's results are bit-identical with the
trace on and off.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from cs_vit_tpu_torch import utils
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.mano import ManoLayer, sh_joint_regressor, synthetic_assets
from cs_vit_tpu_torch.models import Poser, PoserConfig, SwinV2Config, init_poser_weights
from cs_vit_tpu_torch.serving import PoserSession
from cs_vit_tpu_torch.train import TrainState, build_optimizer, make_train_step

from .helpers import TINY_SWIN, tiny_batch

# each span with its children, in the order they open
# (None: the spans inside no other ``csvit.*`` span)
STEP_TREE = {
    None: ["csvit.step"],
    "csvit.step": ["csvit.step.cast", "csvit.step.forward", "csvit.step.backward",
                   "csvit.step.update"],
    "csvit.step.update": ["csvit.sync.finite", "csvit.step.clip", "csvit.step.optim"],
    "csvit.step.clip": ["csvit.sync.clip"],
}
SERVE_TREE = {None: ["csvit.serve.input", "csvit.serve.forward", "csvit.serve.output"] * 2}


def _tiny_step():
    """A tiny Poser's train state, its spatial step and a batch."""
    sw = SwinV2Config(**{f: getattr(TINY_SWIN, f) for f in (
        "image_size", "patch_size", "embed_dim", "depths", "num_heads", "window_size",
        "drop_path_rate", "pretrained_window_sizes")})
    assets = synthetic_assets(seed=1)
    model = Poser(PoserConfig(backbone="custom", custom_swin=sw, image_size=32,
                              num_pose_query=16, num_spatial_layer=2, num_temporal_layer=1),
                  ManoLayer(assets), sh_joint_regressor(assets))
    init_poser_weights(model, 0)
    state = TrainState.create(model, build_optimizer(model, "spatial", 1e-3))
    step = make_train_step(model, state.optimizer, "spatial")
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(np.random.default_rng(11), B=2,
                                                              T=1).items()}
    return state, step, batch


def _run_step():
    """One step of a fresh tiny state: the loss, the clipped grads and the
    updated parameters."""
    state, step, batch = _tiny_step()
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    params = state.optimizer.params()
    return [metrics["loss"], metrics["grad_norm"], *(p.grad for p in params), *params]


def _run_serve():
    """A batch-4 f32 session's answers to 6 crops (a full and a padded
    chunk)."""
    sess = PoserSession(FinetuneConfig(exp="spans", backbone="test", img_size=32,
                                       phase="inference", data=["dexycb"], batch_size=4),
                        batch_size=4, dtype="float32", device="cpu")
    rng = np.random.default_rng(5)
    out = sess.predict_crops(
        rng.uniform(size=(6, 1, 32, 32, 3)).astype(np.float32),
        np.tile(np.asarray([10, 10, 200, 200], np.float32), (6, 1, 1)),
        np.zeros((6, 1), np.float32), np.full((6, 1, 2), 300.0, np.float32),
        np.full((6, 1, 2), 100.0, np.float32))
    return [torch.from_numpy(out[k]) for k in sorted(out)]


RUNS = {"step": (_run_step, STEP_TREE), "serve": (_run_serve, SERVE_TREE)}


def _traced(run, tmp_path):
    with utils.trace(str(tmp_path)) as prof:
        out = run()
    with open(prof.trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and str(e.get("name", "")).startswith("csvit.")]
    return out, events


@pytest.mark.parametrize("recording", [False, True])
def test_annotate_records_only_under_a_profiler(recording, monkeypatch):
    if not recording:
        def refused(name):
            raise AssertionError("a RecordFunction was entered with no profiler running")

        monkeypatch.setattr(torch.profiler, "record_function", refused)
        span = utils.annotate("csvit.test")
        assert span is utils.annotate("csvit.other")
        assert isinstance(span, contextlib.nullcontext)
        with span, utils.annotate("csvit.inner"):
            pass
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        span = utils.annotate("csvit.test")
        assert isinstance(span, torch.profiler.record_function)
        with span:
            pass


@pytest.mark.parametrize("kind", list(RUNS))
def test_spans_nest_in_the_order_the_code_runs(kind, tmp_path):
    run, tree = RUNS[kind]
    _, events = _traced(run, tmp_path)

    def within(e, p):
        return e is not p and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]

    top = sorted((e for e in events if not any(within(e, p) for p in events)),
                 key=lambda e: e["ts"])
    assert [e["name"] for e in top] == tree[None]
    for parent, children in tree.items():
        if parent is None:
            continue
        spans = [e for e in events if e["name"] == parent]
        assert spans, sorted({e["name"] for e in events})
        for p in spans:
            inside = sorted((e for e in events if e["name"] in children and within(e, p)),
                            key=lambda e: e["ts"])
            assert [e["name"] for e in inside] == children, (parent, inside)


@pytest.mark.parametrize("kind", list(RUNS))
def test_results_are_bit_identical_with_the_trace_on_and_off(kind, tmp_path):
    run = RUNS[kind][0]
    untraced = run()
    traced, events = _traced(run, tmp_path)
    assert events
    assert len(traced) == len(untraced)
    for a, b in zip(traced, untraced):
        assert a.dtype == b.dtype and torch.equal(a, b)
