"""Port parity: the temporal train step against the JAX package.

``make_train_step(model, opt, "temporal")`` trains the temporal encoders
only, with their BatchNorms on batch statistics, while the backbone and the
spatial encoder run frozen. It is held against JAX ``make_train_step(phase=
"temporal")`` for realtime T=3 (last-frame supervision) and full T=5 (all
frames and the smoothness loss) on ``tests/helpers.py:tiny_poser`` with
random temporal initialisation, f32, eager/XLA attention on both sides
(JAX cannot differentiate through its Pallas kernel, which has no vjp).
What the phase does not train stays bit-identical: parameters and BatchNorm
statistics. Tolerances, from tests/test_torch_train.py with their reasons
there, and where the noise is larger, why:

* loss rtol 1e-5; parameters after the step within 2 lr where a grad is
  under ten times its tolerance, else 1e-6 |p| + 1e-3 lr (as there).
* grads, grad_norm and the BatchNorm running statistics are held against
  JAX's float64 step (the same step under ``jax.enable_x64``, the packages'
  f32 casts in LayerNorm, BatchNorm and softmax kept): the port may miss
  each by twice the larger of JAX's own f32 miss and a floor: grads
  GRAD_FLOOR (1e-4, the spatial step's) of the leaf's largest magnitude
  plus 1e-6 of the clip norm 5; grad_norm 5e-5 relative; statistics 1e-5
  plus STAT_FLOOR (1e-5) of the leaf's largest value. The temporal encoders
  train on the frozen stack's output, and their random-weight attention
  (sqrt(d_h)-multiplied, nearly hard; in the realtime case over one query
  token per sample, with BatchNorm statistics over the B last-frame tokens)
  amplifies f32 sum-order noise in the backward, JAX's as much as the
  port's: for grad_norm (realtime, the test's seed 23) JAX's f32 step lies
  3.1e-5 and the port's 8.9e-6 relative from the float64 value. Over seeds
  23, 5 and 6 of this file's inputs in the full case, the port's misses
  took at most 0.78 (grads), 0.55 (grad_norm) and 0.86 (statistics) of
  their allowances; at seed 23, 0.21 / 0.0048 / 0.25.
* The realtime case alone gives larger floors to the leaves on either side
  of its cross attention's softmax: SOFTMAX_GRAD_FLOOR to the grads of the
  query and key projections and of the norm before the query
  (SOFTMAX_GRAD_LEAVES), which reach them through the softmax's Jacobian,
  and SOFTMAX_STAT_FLOOR to the statistics of the norm after it
  (SOFTMAX_STAT_LEAVES), taken over the B=4 last-frame tokens the softmax
  mixes. Both are JAX's own f32 misses there, as fractions of the leaf's
  scale, read by tests/test_torch_temporal_noise.py (slow; its docstring
  has the readings): the grads' floor is JAX's largest miss over six seeds
  of this file's inputs (1.915e-3, seed 8), the statistics' its largest
  miss with its parameters and inputs moved by one ulp (2.382e-4, seed 9;
  unmoved, JAX's statistics miss by at most 2.6e-5 and the port's by
  7.4e-5). Every other realtime leaf keeps the spatial floors, and the
  reader holds the port within them at all six seeds.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.train import TrainState as JTrainState
from cs_vit_tpu.train import build_optimizer as j_build_optimizer
from cs_vit_tpu.train import make_train_step as j_make_train_step
from cs_vit_tpu_torch.models import init_poser_weights
from cs_vit_tpu_torch.models.poser import phase_trainable_params
from cs_vit_tpu_torch.train import (
    TrainState,
    build_optimizer,
    load_reference_state_dict,
    make_train_step,
    state_dict_from_flax,
)

from .helpers import tiny_batch, tiny_poser
from .test_torch_poser import _port_tiny

LR = 1e-3
CASES = {"realtime": 3, "full": 5}
# the floors of the grads' and the BatchNorm statistics' allowances, as
# fractions of the leaf's scale (see the module docstring): the spatial
# step's, and in the realtime case larger ones on either side of the
# softmax: the grads of its query and key and of the norm before them, the
# statistics of the norm after it
GRAD_FLOOR, STAT_FLOOR = 1e-4, 1e-5
SOFTMAX_GRAD_FLOOR, SOFTMAX_STAT_FLOOR = 1.92e-3, 2.39e-4
SOFTMAX_GRAD_LEAVES = re.compile(r"\.layers\.\d+\.(norm1|cross_atten\.(query|key))\.")
SOFTMAX_STAT_LEAVES = re.compile(r"\.layers\.\d+\.norm2\.running_(mean|var)$")
TEMPORAL = ("pose_temporal_encoder", "shape_temporal_encoder", "root_temporal_encoder")


def grad_atol(sup: str, name: str, jax_miss: float, g64: np.ndarray) -> float:
    """What the port's grad of leaf `name` may miss JAX's float64 grad by."""
    softmax = sup == "realtime" and SOFTMAX_GRAD_LEAVES.search(name)
    floor = SOFTMAX_GRAD_FLOOR if softmax else GRAD_FLOOR
    return 2 * max(jax_miss, floor * float(np.abs(g64).max()) + 1e-6 * 5.0)


def stat_atol(sup: str, name: str, jax_miss: float, want64: np.ndarray) -> float:
    """What the port's running statistic `name` may miss JAX's float64 one by."""
    softmax = sup == "realtime" and SOFTMAX_STAT_LEAVES.search(name)
    floor = SOFTMAX_STAT_FLOOR if softmax else STAT_FLOOR
    return 2 * max(jax_miss, 1e-5 + floor * float(np.abs(want64).max()))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _camera_batch(rng, B, T):
    """tiny_batch with a box and intrinsics of its own for every frame, as
    real data has: tiny_batch gives every frame one box, so the perspective
    encoder decorates every query token alike, the realtime temporal
    BatchNorms (statistics over the B last-frame queries) see near-zero
    variances, and those amplify the f32 noise of the frozen layers below."""
    batch = tiny_batch(rng, B=B, T=T)
    x0 = rng.uniform(40, 200, size=(B, T, 2))
    side = rng.uniform(120, 300, size=(B, T, 1))
    batch["square_bboxes"] = np.concatenate([x0, x0 + side], -1).astype(np.float32)
    batch["focal"] = rng.uniform(500, 700, size=(B, T, 2)).astype(np.float32)
    batch["princpt"] = rng.uniform(200, 320, size=(B, T, 2)).astype(np.float32)
    return batch


def _jax_temporal_step(sup, seed=23):
    """One JAX temporal step of tiny_poser (f32, lr 1e-3) and the jax.grad of
    its loss, from random BatchNorm running statistics."""
    rng = np.random.default_rng(seed)
    jmodel = tiny_poser(temporal_supervision=sup, temporal_init_method="random")
    batch = _camera_batch(rng, B=4, T=CASES[sup])
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
                              phase="temporal", rngs={"droppath": key, "latent": key},
                              mutable=["batch_stats"])
        return out["loss"]

    grads = jax.grad(loss)(variables["params"])
    with jax.enable_x64(True):
        params64, stats64, batch64 = jax.tree.map(
            lambda v: jnp.asarray(v, jnp.float64), (variables["params"], stats, jbatch))

        def loss64(params):
            out, mutated = jmodel.apply({"params": params, "batch_stats": stats64}, batch64,
                                        phase="temporal", rngs={"droppath": key, "latent": key},
                                        mutable=["batch_stats"])
            return out["loss"], mutated["batch_stats"]

        grads64, new_stats64 = jax.grad(loss64, has_aux=True)(params64)
        grads64, new_stats64 = _np(grads64), _np(new_stats64)
    tx = j_build_optimizer(variables["params"], "temporal", LR)
    state = JTrainState.create(variables, tx)
    new_state, metrics = j_make_train_step(jmodel, tx, "temporal", donate=False)(
        state, jbatch, key)
    return dict(sup=sup, batch=batch, variables=_np(variables), grads=_np(grads),
                new_params=_np(new_state.params), new_stats=_np(new_state.batch_stats),
                loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                grads64=grads64, new_stats64=new_stats64)


# the full case runs from tests/test_torch_temporal_train_full.py, so that
# the two cases' JAX compiles run in parallel under xdist
@pytest.fixture(scope="module", params=["realtime"])
def jax_temporal_step(request):
    return _jax_temporal_step(request.param)


def _port_from(js):
    model = _port_tiny(temporal_supervision=js["sup"], temporal_init_method="random")
    load_reference_state_dict(model, state_dict_from_flax(
        js["variables"]["params"], js["variables"]["batch_stats"], model.config))
    return model


def test_temporal_step_matches_jax(jax_temporal_step):
    js = jax_temporal_step
    model = _port_from(js)
    before = copy.deepcopy(model.state_dict())
    state = TrainState.create(model, build_optimizer(model, "temporal", LR))
    step = make_train_step(model, state.optimizer, "temporal")
    state, metrics = step(state, _torch_batch(js["batch"]), None)
    assert state.step == 1 and float(metrics["skipped"]) == 0.0
    assert float(metrics["loss"]) == pytest.approx(js["loss"], rel=1e-5)
    T_out = 1 if js["sup"] == "realtime" else CASES[js["sup"]]
    assert metrics["joint_cam_pred"].shape == (4, T_out, 21, 3)
    if js["sup"] == "full":
        assert float(metrics["scalar_logs"]["origin"]["loss_vel"]) > 0

    stats = js["variables"]["batch_stats"]
    sd_grads = state_dict_from_flax(js["grads"], stats, model.config)
    sd_grads64 = state_dict_from_flax(js["grads64"], stats, model.config)
    sd_new = state_dict_from_flax(js["new_params"], js["new_stats"], model.config)
    sd_stats64 = state_dict_from_flax(js["variables"]["params"], js["new_stats64"], model.config)
    params = dict(model.named_parameters())
    trained = {n for n, _ in phase_trainable_params(model, "temporal")}
    assert trained == {n for n in params if n.startswith(TEMPORAL)}
    # float64 truth; each allowance is twice the larger of JAX's own f32 miss
    # and a floor
    norm64 = float(np.sqrt(sum((sd_grads64[n] ** 2).sum() for n in trained)))
    allowed = 2 * max(abs(js["grad_norm"] - norm64), 5e-5 * norm64)
    assert abs(float(metrics["grad_norm"]) - norm64) <= allowed
    clip, clip64 = min(1.0, 5.0 / js["grad_norm"]), min(1.0, 5.0 / norm64)
    for n in trained:
        g_jax, g64 = sd_grads[n] * clip, sd_grads64[n] * clip64
        jax_miss = float(np.abs(g_jax - g64).max())
        atol = grad_atol(js["sup"], n, jax_miss, g64)
        np.testing.assert_allclose(params[n].grad.numpy(), g64, rtol=0, atol=atol, err_msg=n)
        p, want = params[n].detach().numpy(), sd_new[n]
        sensitive = np.abs(g_jax) < 10 * atol
        allowed = np.where(sensitive, 2 * LR, 1e-6 * np.abs(want) + 1e-3 * LR)
        assert (np.abs(p - want) <= allowed).all(), n
    for n, p in params.items():
        if n not in trained:
            assert p.grad is None and torch.equal(p.detach(), before[n]), n
    # the temporal BatchNorms moved as in JAX; every other statistic is untouched
    for n, b in model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            if n.startswith(TEMPORAL):
                want64 = sd_stats64[n]
                jax_miss = float(np.abs(sd_new[n] - want64).max())
                atol = stat_atol(js["sup"], n, jax_miss, want64)
                assert np.abs(b.numpy() - want64).max() <= atol, n
            else:
                assert torch.equal(b, before[n]) and np.array_equal(b.numpy(), sd_new[n]), n


def test_temporal_nan_batch_leaves_the_state_bit_identical(rng):
    model = _port_tiny(temporal_supervision="realtime", temporal_init_method="random")
    init_poser_weights(model, 0)
    state = TrainState.create(model, build_optimizer(model, "temporal", LR))
    step = make_train_step(model, state.optimizer, "temporal")
    batch = _torch_batch(tiny_batch(rng, B=2, T=3))
    state, _ = step(state, batch, None)  # give AdamW some state first
    params = copy.deepcopy(model.state_dict())
    opt_state = copy.deepcopy(state.optimizer.state_dict())
    bad = dict(batch, joint_cam=batch["joint_cam"].clone())
    bad["joint_cam"][0, -1, 0, 0] = float("nan")
    state, metrics = step(state, bad, None)
    assert float(metrics["skipped"]) == 1.0 and state.step == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    after = state.optimizer.state_dict()
    assert after["param_groups"] == opt_state["param_groups"]
    for i, s in opt_state["state"].items():
        for k, v in s.items():
            assert torch.equal(after["state"][i][k], v), (i, k)


@pytest.mark.parametrize("sup", sorted(CASES))
def test_temporal_steps_fit_a_fixed_batch(sup):
    """Steps on one fixed batch bring the loss well below its start with
    only the temporal encoders training (the heads and everything below them
    stay as initialised)."""
    model = _port_tiny(temporal_supervision=sup, temporal_init_method="random",
                       attention_impl="pallas")
    init_poser_weights(model, 0)
    state = TrainState.create(model, build_optimizer(model, "temporal", LR))
    step = make_train_step(model, state.optimizer, "temporal")
    batch = _torch_batch(tiny_batch(np.random.default_rng(11), B=2, T=CASES[sup]))
    losses = []
    for _ in range(60):
        state, metrics = step(state, batch, None)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and state.step == 60
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
