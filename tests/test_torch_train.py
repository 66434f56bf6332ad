"""Port parity: the spatial train step against the JAX package.

The models are ``tests/helpers.py:tiny_poser`` (JAX) and its port, f32,
droppath 0, the flax weights carried across by ``state_dict_from_flax``; the
batch is ``tiny_batch`` (B=4, T=1) made with numpy from a seed. Tolerances,
each with its reason:

* BatchNorm training mode, output and running statistics: 1e-6 (same f32
  formulas).
* Optimizer fed the same numpy grads: parameters to 1e-6 of each leaf's
  largest magnitude (optax and torch write AdamW's arithmetic in another
  order, a few f32 ulps of the leaf's scale) plus 1e-4 of the peak lr: optax
  takes Adam's bias correction 1 - 0.999^t in f32 (1.3e-5 off at t = 1),
  torch in f64, so each update differs by up to ~1e-5 of its lr-sized step.
* One train step: loss rtol 1e-5; each grad to 1e-4 of its leaf's largest
  magnitude (both sides differentiate the same graph, the sums run in other
  orders through six layers of sqrt(d_h)-sharpened attention), plus 1e-6 of
  the clipped grads' global norm of 5 for the leaves whose exact grad cancels
  to zero (the attention key biases: softmax ignores a per-row constant) and
  which hold f32 noise only; grad_norm rtol 5e-5, as it is the norm of a few
  large leaves that differ by up to 2e-5 of their own norm under that
  per-leaf tolerance; BatchNorm running statistics 1e-5 (the BatchNorms
  deep in the spatial encoder see activations that already carry the
  upstream layers' f32 sum-order noise, which moves their batch variance by
  up to ~3e-5 and, at momentum 0.1, the running value by ~3e-6). Parameters after the step: Adam's first update is
  lr * g / (|g| + eps), about lr * sign(g), so where |g| is under ten times
  its grad tolerance (where a grad difference within tolerance could flip
  the sign) the parameters may differ by 2 lr; elsewhere by 1e-6 |p| +
  1e-3 lr.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cs_vit_tpu.models.modules import TorchBatchNorm as JTorchBatchNorm
from cs_vit_tpu.models.poser import derivative as j_derivative
from cs_vit_tpu.train import TrainState as JTrainState
from cs_vit_tpu.train import build_optimizer as j_build_optimizer
from cs_vit_tpu.train import make_train_step as j_make_train_step
from cs_vit_tpu.train import scaled_lr as j_scaled_lr
from cs_vit_tpu.train import warmup_cosine_schedule as j_warmup_cosine_schedule
from cs_vit_tpu_torch import utils
from cs_vit_tpu_torch.cli.common import build_model
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.mano import ManoLayer, sh_joint_regressor, synthetic_assets
from cs_vit_tpu_torch.models import Poser, PoserConfig, SwinV2Config, init_poser_weights
from cs_vit_tpu_torch.models.modules import TorchBatchNorm
from cs_vit_tpu_torch.models.poser import derivative, phase_trainable_params
from cs_vit_tpu_torch.ops import multi_tensor as mt
from cs_vit_tpu_torch.serving import PoserSession
from cs_vit_tpu_torch.train import (
    PhaseAdamW,
    TrainState,
    build_optimizer,
    latest_checkpoint,
    load_reference_state_dict,
    make_train_step,
    merge_params,
    restore_checkpoint,
    save_checkpoint,
    scaled_lr,
    state_dict_from_flax,
    warmup_cosine_schedule,
)
from cs_vit_tpu_torch.train.optim import sum_of_squares

from .helpers import TINY_SWIN, tiny_batch, tiny_poser

LR = 1e-3
TEMPORAL = ("pose_temporal_encoder", "shape_temporal_encoder", "root_temporal_encoder")


def _port_tiny(**overrides) -> Poser:
    sw = SwinV2Config(**{f: getattr(TINY_SWIN, f) for f in (
        "image_size", "patch_size", "embed_dim", "depths", "num_heads", "window_size",
        "drop_path_rate", "pretrained_window_sizes")})
    kw = dict(backbone="custom", custom_swin=sw, image_size=32, num_pose_query=16,
              num_spatial_layer=2, num_temporal_layer=1)
    kw.update(overrides)
    assets = synthetic_assets(seed=1)
    return Poser(PoserConfig(**kw), ManoLayer(assets), sh_joint_regressor(assets))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_step():
    """One JAX spatial step of tiny_poser (f32, lr 1e-3, droppath 0) and the
    jax.grad of its loss, from random BatchNorm running statistics."""
    rng = np.random.default_rng(3)
    jmodel = tiny_poser()
    batch = tiny_batch(rng, B=4, T=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jmodel.init({"params": jax.random.key(0), "droppath": jax.random.key(1)},
                            jbatch, phase="inference")
    stats = jax.tree.map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, size=np.shape(v)), jnp.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    key = jax.random.key(0)

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats}, jbatch,
                              phase="spatial", rngs={"droppath": key, "latent": key},
                              mutable=["batch_stats"])
        return out["loss"]

    grads = jax.grad(loss)(variables["params"])
    tx = j_build_optimizer(variables["params"], "spatial", LR)
    state = JTrainState.create(variables, tx)
    new_state, metrics = j_make_train_step(jmodel, tx, "spatial", donate=False)(
        state, jbatch, key)
    return dict(batch=batch, variables=_np(variables), grads=_np(grads),
                new_params=_np(new_state.params), new_stats=_np(new_state.batch_stats),
                loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))


def _port_from(variables, impl="eager"):
    model = _port_tiny(attention_impl=impl)
    load_reference_state_dict(model, state_dict_from_flax(
        variables["params"], variables["batch_stats"], model.config))
    return model


def _ref_names(tree, stats, model):
    """A flax params-shaped tree (params or grads) under reference names."""
    sd = state_dict_from_flax(tree, stats, model.config)
    names = dict(model.named_parameters())
    return {k: v for k, v in sd.items() if k in names}


# ---------------------------------------------------------------------------


def test_batchnorm_training_matches_jax(rng):
    x = rng.normal(size=(4, 3, 16)).astype(np.float32) * 2 + 0.5
    jbn = JTorchBatchNorm()
    variables = jbn.init(jax.random.key(0), jnp.asarray(x), use_running_average=False)
    mean0 = rng.normal(size=16).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, size=16).astype(np.float32)
    scale = 1 + 0.1 * rng.normal(size=16).astype(np.float32)
    bias = 0.1 * rng.normal(size=16).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, mutated = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                              mutable=["batch_stats"])
    bn = TorchBatchNorm(16)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean0),
                        ("running_var", var0)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    got = bn(torch.from_numpy(x), train=True)
    tol = dict(atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]),
                               **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mutated["batch_stats"]["var"]),
                               **tol)


def test_lr_scaling_and_schedule_match_jax():
    for world, batch in ((1, 11), (4, 11), (8, 22), (1, 8)):
        assert scaled_lr(1e-4, world, batch) == pytest.approx(j_scaled_lr(1e-4, world, batch))
    kw = dict(max_lr=2e-3, min_lr=1e-5, warmup_epochs=2, annealing_epochs=3, steps_per_epoch=7)
    sched, jsched = warmup_cosine_schedule(**kw), j_warmup_cosine_schedule(**kw)
    # the JAX schedule runs in f32 (cos near pi loses a few ulps), the port's
    # in Python floats: 1e-5 relative is f32 rounding, not a formula change
    for step in (0, 1, 6, 13, 14, 15, 20, 28, 34, 35, 36, 100):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-5, abs=1e-12)
    assert sched(0) == 0.0


def test_optimizer_matches_optax():
    """Five updates from the same grads: a warm-up step at lr 0, a step where
    the clip at 5.0 triggers, grads near eps; frozen parameters stay put."""
    rng = np.random.default_rng(5)
    model = _port_tiny()
    init_poser_weights(model, 0)
    names = [n for n, _ in model.named_parameters()]
    jparams = {}
    for n, p in model.named_parameters():
        top, rest = n.split(".", 1) if "." in n else (n, "_")
        jparams.setdefault(top, {})[rest] = jnp.asarray(p.detach().numpy())
    kw = dict(max_lr=1e-3, min_lr=1e-5, warmup_epochs=1, annealing_epochs=2, steps_per_epoch=2)
    tx = j_build_optimizer(jparams, "spatial", j_warmup_cosine_schedule(**kw))
    jstate = tx.init(jparams)
    opt = build_optimizer(model, "spatial", warmup_cosine_schedule(**kw))
    trainable = {id(p) for p in opt.params()}
    norms = []
    for k, scale in enumerate((1e-3, 1e-3, 1.0, 1e-7, 1e-3)):
        grads = {n: (rng.normal(size=p.shape) * scale).astype(np.float32)
                 for n, p in model.named_parameters()}
        jgrads = {}
        for n, g in grads.items():
            top, rest = n.split(".", 1) if "." in n else (n, "_")
            jgrads.setdefault(top, {})[rest] = jnp.asarray(g)
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n]) if id(p) in trainable else None
        norms.append(float(opt.clip_grads_()))
        opt.scheduled_step()
    assert norms[2] > 5.0 > max(norms[:2] + norms[3:])  # the clip triggered once
    assert opt.updates_taken() == 5
    for n, p in model.named_parameters():
        top, rest = n.split(".", 1) if "." in n else (n, "_")
        want = np.asarray(jparams[top][rest])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max() + 1e-4 * 1e-3, err_msg=n)
    frozen = [n for n in names if n.split(".", 1)[0] in TEMPORAL]
    assert frozen and all(id(dict(model.named_parameters())[n]) not in trainable for n in frozen)


def test_spatial_step_matches_jax(jax_step):
    js = jax_step
    model = _port_from(js["variables"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(model, build_optimizer(model, "spatial", LR))
    step = make_train_step(model, state.optimizer, "spatial")
    state, metrics = step(state, _torch_batch(js["batch"]), None)
    assert state.step == 1 and float(metrics["skipped"]) == 0.0
    assert float(metrics["loss"]) == pytest.approx(js["loss"], rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(js["grad_norm"], rel=5e-5)
    assert metrics["joint_cam_pred"].shape == (4, 1, 21, 3)

    clip = min(1.0, 5.0 / js["grad_norm"])
    jgrads = _ref_names(js["grads"], js["variables"]["batch_stats"], model)
    jparams = _ref_names(js["new_params"], js["new_stats"], model)
    params = dict(model.named_parameters())
    assert {n for n, _ in phase_trainable_params(model, "spatial")} <= set(jgrads)
    for n, _ in phase_trainable_params(model, "spatial"):
        g_want = jgrads[n] * clip
        atol = 1e-4 * float(np.abs(g_want).max()) + 1e-6 * 5.0
        np.testing.assert_allclose(params[n].grad.numpy(), g_want, rtol=0, atol=atol, err_msg=n)
        p, want = params[n].detach().numpy(), jparams[n]
        sensitive = np.abs(g_want) < 10 * atol
        allowed = np.where(sensitive, 2 * LR, 1e-6 * np.abs(want) + 1e-3 * LR)
        assert (np.abs(p - want) <= allowed).all(), n
    # BatchNorm running statistics moved as in JAX
    sd = state_dict_from_flax(js["new_params"], js["new_stats"], model.config)
    for n, b in model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), sd[n], atol=1e-5, rtol=1e-5, err_msg=n)
    # the temporal encoders neither run nor train in the spatial phase
    for n, p in params.items():
        if n.split(".", 1)[0] in TEMPORAL:
            assert p.grad is None and torch.equal(p.detach(), before[n]), n


def test_nan_batch_leaves_the_state_bit_identical(jax_step):
    model = _port_from(jax_step["variables"])
    state = TrainState.create(model, build_optimizer(model, "spatial", LR))
    step = make_train_step(model, state.optimizer, "spatial")
    batch = _torch_batch(jax_step["batch"])
    state, _ = step(state, batch, None)  # give AdamW some state first
    params = copy.deepcopy(model.state_dict())
    opt_state = copy.deepcopy(state.optimizer.state_dict())
    bad = dict(batch, joint_cam=batch["joint_cam"].clone())
    bad["joint_cam"][0, 0, 0, 0] = float("nan")
    state, metrics = step(state, bad, None)
    assert float(metrics["skipped"]) == 1.0 and state.step == 1
    assert not np.isfinite(float(metrics["loss"]))
    for k, v in model.state_dict().items():  # parameters and BatchNorm statistics
        assert torch.equal(v, params[k]), k
    after = state.optimizer.state_dict()
    assert after["param_groups"] == opt_state["param_groups"]
    for i, s in opt_state["state"].items():
        for k, v in s.items():
            assert torch.equal(after["state"][i][k], v), (i, k)


def test_checkpoint_round_trip_and_serving(tmp_path, rng):
    cfg = FinetuneConfig(exp="ckpt", backbone="test", img_size=32, phase="spatial")
    model = build_model(cfg)
    init_poser_weights(model, 1)
    state = TrainState.create(model, build_optimizer(model, "spatial", LR))
    step = make_train_step(model, state.optimizer, "spatial")
    state, _ = step(state, _torch_batch(tiny_batch(rng, B=2, T=1)), None)
    save_checkpoint(str(tmp_path), 1, state)
    path = save_checkpoint(str(tmp_path), 2, state)
    assert latest_checkpoint(str(tmp_path)) == path
    (tmp_path / "config.json").write_text(cfg.to_json())

    fresh = build_model(cfg)
    fresh_state = TrainState.create(fresh, build_optimizer(fresh, "spatial", LR))
    payload = restore_checkpoint(path, fresh_state)
    assert set(payload) >= {"model", "merged", "epoch", "optimizer"} and payload["epoch"] == 2
    assert fresh_state.step == 1 and fresh_state.optimizer.updates_taken() == 1
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    # strict=False merge: a mismatched shape and an unknown name are skipped
    loaded = dict(payload["model"], extra=torch.zeros(1))
    loaded["query_token"] = torch.zeros(1, 1)
    merged, skipped = merge_params(fresh.state_dict(), loaded)
    assert skipped == ["query_token"] and "extra" not in merged

    sess = PoserSession.from_experiment(str(tmp_path), batch_size=2, dtype="float32",
                                        device="cpu")
    assert torch.equal(sess.model.query_token, model.query_token.detach())


def test_criterion_temporal_term_matches_jax(rng, jax_step):
    """The smoothness term (T=5: velocities and accelerations) and the
    derivative against the JAX Poser's criterion, f32 at 1e-6."""
    jmodel = tiny_poser()
    variables = jax.tree.map(jnp.asarray, jax_step["variables"])
    batch = tiny_batch(rng, B=2, T=5)
    predict = {"joint_cam": batch["joint_cam"] + rng.normal(scale=5.0, size=(2, 5, 21, 3)),
               "shape": rng.normal(size=(2, 5, 10))}
    predict = {k: v.astype(np.float32) for k, v in predict.items()}
    x = rng.normal(size=(2, 6, 4)).astype(np.float32)
    np.testing.assert_allclose(derivative(torch.from_numpy(x), 1).numpy(),
                               np.asarray(j_derivative(jnp.asarray(x), 1)), atol=1e-6)
    model = _port_tiny()
    for phase in ("spatial", "temporal"):
        jloss, jlogs = jmodel.apply(
            variables, {k: jnp.asarray(v) for k, v in predict.items()},
            {k: jnp.asarray(v) for k, v in batch.items()}, phase, method=jmodel.criterion)
        loss, logs = model.criterion(_torch_batch(predict), _torch_batch(batch), phase)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
        for k in jlogs:
            assert float(logs[k]) == pytest.approx(float(jlogs[k]), rel=1e-6, abs=1e-9), k
    assert float(logs["loss_vel"]) > 0 and float(logs["loss_accel"]) > 0


@pytest.mark.parametrize("impl", ["eager", "fused"])
def test_spatial_steps_fit_a_fixed_batch(impl):
    """About 200 steps on one fixed batch bring the loss below half its start,
    on the eager path and on the kernel path (plain versions on the CPU)."""
    torch.manual_seed(0)
    model = _port_tiny(attention_impl=impl)
    init_poser_weights(model, 0)
    state = TrainState.create(model, build_optimizer(model, "spatial", LR))
    step = make_train_step(model, state.optimizer, "spatial")
    batch = _torch_batch(tiny_batch(np.random.default_rng(11), B=2, T=1))
    losses = []
    for _ in range(200):
        state, metrics = step(state, batch, torch.Generator().manual_seed(len(losses)))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and state.step == 200
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# The update's two paths: the multi-tensor kernels (ops.multi_tensor) and the
# per-leaf code. On the CPU every leaf takes the per-leaf code; with the
# optimizer's card set to the CPU, the kernels' plain versions stand in for
# the kernels, so the multi-tensor path's bookkeeping runs here. Tolerance
# between the two: f32 round-off (the kernels' norm sums in f64, the per-leaf
# norm in f32, so a clipped grad may differ by an ulp or two).

ODD_SHAPES = [(3, 4), (5,), (1,), (0,), (7, 9), (2, 3, 5), (16,)]


def _leaves(seed, shapes=ODD_SHAPES):
    rng = np.random.default_rng(seed)
    return [torch.nn.Parameter(torch.from_numpy(rng.normal(size=s).astype(np.float32)))
            for s in shapes]


def _grads(rng, leaves, scale):
    return [torch.from_numpy((rng.normal(size=p.shape) * scale).astype(np.float32))
            for p in leaves]


def _on_the_card(monkeypatch):
    """Have the optimizer take the CPU for its card: its leaves take the
    multi-tensor path, run by the kernels' plain versions."""
    monkeypatch.setattr(PhaseAdamW, "_card", lambda self: torch.device("cpu"))


def _assert_close_leaves(got, want):
    for a, b in zip(got, want):
        a, b = a.detach().numpy(), b.detach().numpy()
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-6 * (np.abs(b).max(initial=0) + 1))


def test_cpu_leaves_take_the_per_leaf_path(tmp_path):
    """A CPU step's leaves all take the per-leaf code: the counters say so,
    and the clip and AdamW each open only ``csvit.optim.per_leaf`` spans."""
    model = _port_tiny()
    init_poser_weights(model, 0)
    state = TrainState.create(model, build_optimizer(model, "spatial", LR))
    step = make_train_step(model, state.optimizer, "spatial")
    batch = _torch_batch(tiny_batch(np.random.default_rng(11), B=2, T=1))
    with utils.trace(str(tmp_path)) as prof:
        state, _ = step(state, batch, None)
    opt = state.optimizer
    assert opt.leaves_per_leaf == len(opt.params()) and opt.leaves_multi_tensor == 0
    with open(prof.trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {n: [e for e in events if e.get("name") == n] for n in (
        "csvit.step.clip", "csvit.step.optim", "csvit.optim.per_leaf",
        "csvit.optim.multi_tensor", "csvit.sync.clip")}
    assert not spans["csvit.optim.multi_tensor"]

    def inside(e, parent):
        return any(p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                   for p in spans[parent])

    assert len(spans["csvit.optim.per_leaf"]) == 3  # the norm, the clip's branch, AdamW
    assert sum(inside(e, "csvit.step.clip") for e in spans["csvit.optim.per_leaf"]) == 2
    assert sum(inside(e, "csvit.step.optim") for e in spans["csvit.optim.per_leaf"]) == 1
    assert len(spans["csvit.sync.clip"]) == 1
    assert all(inside(e, "csvit.optim.per_leaf") for e in spans["csvit.sync.clip"])


@pytest.mark.parametrize("case", ["below", "above", "nan"])
def test_kernel_plain_versions_match_the_optimizer(case):
    """Three updates by ``multi_tensor``'s plain versions (the kernels'
    arithmetic: the norm, the select, AdamW) against ``clip_grads_`` and
    ``step()`` on the CPU, from the same grads: norm under the clip, over
    it, NaN."""
    rng = np.random.default_rng(7)
    leaves, copies = _leaves(1), _leaves(1)
    opt = PhaseAdamW(leaves, LR)
    m = [torch.zeros_like(p) for p in copies]
    v = [torch.zeros_like(p) for p in copies]
    for t in (1, 2, 3):
        grads = _grads(rng, leaves, {"below": 0.1, "above": 10.0, "nan": 1.0}[case])
        if case == "nan" and t == 2:
            grads[4][1, 2] = float("nan")
        for p, g in zip(leaves, grads):
            p.grad = g.clone()
        norm = opt.clip_grads_()
        opt.step()
        want = mt.squares_reference(grads, [])[2]
        mt.clip_reference_(grads, want, 5.0)
        mt.adamw_reference_([p.data for p in copies], grads, m, v, lr=LR, beta1=0.9,
                            beta2=0.999, eps=1e-8, weight_decay=0.01, step=t)
        np.testing.assert_allclose(float(norm), float(want), rtol=1e-6)
        assert (float(norm) < 5.0) == {"below": True, "above": False, "nan": False}[case]
        _assert_close_leaves([p.grad for p in leaves], grads)
        _assert_close_leaves(leaves, copies)
        _assert_close_leaves([opt.state[p]["exp_avg_sq"] for p in leaves], v)
    if case == "nan":
        assert all(torch.isnan(p).all() for p in leaves if p.numel())


def _laid_out(g, layout):
    """`g` as a grad the backward may give: contiguous, stored transposed
    (a 2-D one), or every other element of a wider buffer (not dense)."""
    if layout == "transposed" and g.dim() == 2:
        return g.t().contiguous().t()
    if layout == "strided" and g.dim() == 2:
        wide = torch.zeros(g.shape[0], 2 * g.shape[1])
        wide[:, ::2] = g
        return wide[:, ::2]
    return g.clone()


@pytest.mark.parametrize("layout", ["contiguous", "transposed", "strided"])
def test_multi_tensor_path_matches_the_per_leaf_path(layout, monkeypatch):
    """Three clips and updates on the multi-tensor path (plain versions
    standing in for the kernels) against the per-leaf path, from the same
    grads; one leaf misses the first update, so the leaves' update counts
    differ after it. Two 2-D leaves' grads come in `layout`: stored
    transposed, or not dense (the kernels then take a contiguous copy); every
    leaf takes the kernels all the same."""
    rng = np.random.default_rng(3)
    fast, slow = _leaves(2), _leaves(2)
    fast_opt, slow_opt = PhaseAdamW(fast, LR), PhaseAdamW(slow, LR)
    _on_the_card(monkeypatch)
    odd = {0, 4}
    for k, scale in enumerate((0.1, 10.0, 0.1)):
        grads = _grads(rng, fast, scale)
        for i, (a, b, g) in enumerate(zip(fast, slow, grads)):
            if k == 0 and i == 1:
                a.grad = b.grad = None
                continue
            a.grad = _laid_out(g, layout) if i in odd else g.clone()
            b.grad = g.clone()
        norms = [fast_opt.clip_grads_(), None]
        fast_opt.step()
        monkeypatch.undo()
        norms[1] = slow_opt.clip_grads_()
        slow_opt.step()
        _on_the_card(monkeypatch)
        np.testing.assert_allclose(float(norms[0]), float(norms[1]), rtol=1e-6)
        _assert_close_leaves([p.grad for p in fast if p.grad is not None],
                             [p.grad for p in slow if p.grad is not None])
        _assert_close_leaves(fast, slow)
    for a, b in zip(fast, slow):
        sa, sb = fast_opt.state[a], slow_opt.state[b]
        assert float(sa["step"]) == float(sb["step"]) == (2.0 if a is fast[1] else 3.0)
        _assert_close_leaves([sa["exp_avg"], sa["exp_avg_sq"]], [sb["exp_avg"], sb["exp_avg_sq"]])
    assert fast_opt.leaves_per_leaf == 0
    assert fast_opt.leaves_multi_tensor == 3 * len(fast) - 1
    assert slow_opt.leaves_multi_tensor == 0
    assert slow_opt.leaves_per_leaf == 3 * len(slow) - 1


@pytest.mark.parametrize("path", ["per_leaf", "multi_tensor"])
def test_sharded_norm_all_reduces_the_shards_sum(path, monkeypatch):
    """Under tensor parallelism the norm all-reduces the shards' sum of
    squares over the model group and counts the replicated leaves once, on
    either path (the all-reduce faked: two ranks holding the same shards)."""
    rng = np.random.default_rng(9)
    leaves = _leaves(6)
    opt = PhaseAdamW(leaves, LR)
    opt.sharded = [i % 2 == 1 for i in range(len(leaves))]
    grads = _grads(rng, leaves, 1.0)
    reduced = []

    def all_reduce(t, group=None):
        reduced.append(t.clone())
        t.mul_(2)

    monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
    if path == "multi_tensor":
        _on_the_card(monkeypatch)
    norm = opt.grad_norm(grads)
    rep = sum_of_squares(g for g, s in zip(grads, opt.sharded) if not s)
    shards = sum_of_squares(g for g, s in zip(grads, opt.sharded) if s)
    assert len(reduced) == 1
    np.testing.assert_allclose(float(reduced[0]), float(shards), rtol=1e-6)
    np.testing.assert_allclose(float(norm), float(torch.sqrt(rep + 2 * shards)), rtol=1e-6)


@pytest.mark.parametrize("path", ["per_leaf", "multi_tensor"])
def test_adamw_state_stays_per_leaf_and_older_checkpoints_step_on(path, tmp_path, monkeypatch):
    """``state_dict()`` keeps ``step``, ``exp_avg`` and ``exp_avg_sq`` per
    leaf, updated in place; a state written by ``torch.optim.AdamW`` (the
    optimizer's format before its update had kernels) loads and steps on as
    ``torch.optim.AdamW`` would, on either path."""
    rng = np.random.default_rng(5)
    older, leaves = _leaves(4), _leaves(4)
    old_opt = torch.optim.AdamW(older, lr=LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    for _ in range(2):
        for p, g in zip(older, _grads(rng, older, 0.1)):
            p.grad = g
        old_opt.step()
    torch.save(old_opt.state_dict(), tmp_path / "optimizer.pt")
    with torch.no_grad():
        for p, q in zip(leaves, older):
            p.copy_(q)
    if path == "multi_tensor":
        _on_the_card(monkeypatch)
    opt = PhaseAdamW(leaves, LR)
    opt.load_state_dict(torch.load(tmp_path / "optimizer.pt"))
    assert opt.updates_taken() == 2
    moments = [(opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]) for p in leaves]
    for _ in range(2):
        for p, q, g in zip(leaves, older, _grads(rng, older, 0.1)):
            p.grad, q.grad = g.clone(), g.clone()
        opt.step()
        old_opt.step()
    assert (opt.leaves_multi_tensor, opt.leaves_per_leaf) == (
        (2 * len(leaves), 0) if path == "multi_tensor" else (0, 2 * len(leaves)))
    sd = opt.state_dict()
    assert sorted(sd["state"]) == list(range(len(leaves)))
    for i, p in enumerate(leaves):
        assert set(sd["state"][i]) == {"step", "exp_avg", "exp_avg_sq"}
        assert float(sd["state"][i]["step"]) == 4.0
        assert opt.state[p]["exp_avg"] is moments[i][0]
        assert opt.state[p]["exp_avg_sq"] is moments[i][1]
    _assert_close_leaves(leaves, older)
    _assert_close_leaves([opt.state[p]["exp_avg_sq"] for p in leaves],
                         [old_opt.state[q]["exp_avg_sq"] for q in older])
