"""Port parity: the Poser paths of the released spenc_addpat configuration
and its relatives against the JAX package.

Models are ``tests/helpers.py:tiny_poser`` and its port, f32, weights from
flax init with random BatchNorm statistics (and non-zero temporal
``zero_conv`` kernels for predict), carried across by the port's own
``state_dict_from_flax``; batches made by numpy from a seed; the latent
group's draws pinned to the same numpy values on both sides
(``test_torch_poser.pinned_latent_draws``). Tolerances, each with its
reason:

* ``predict``: ``test_torch_poser.compare`` (1e-4 of each output's scale
  plus 1e-4). Measured at these inputs, the largest miss of scale: patch
  decoration T=2 2.9e-5 (pose_aa), latent with realtime temporal encoders
  T=3 4.1e-6.
* The latent-2x spatial step (encoder-type spatial layers, six of them, two
  latent layers): ``tests/test_torch_train.py``'s floors for the loss, the
  grad norm, every leaf's grad, the parameters after the step and the
  BatchNorm running statistics; the logs (origin, trans and their terms)
  rtol 1e-5 as the loss. The latent group's parameters and statistics are
  bit-identical after the step on both sides, and the encoder layers before
  the last, which the loss does not reach, get zero grads and move by
  AdamW's decay alone.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import InvalidRngError

from cs_vit_tpu.models.modules import MHA as JMHA
from cs_vit_tpu.train import TrainState as JTrainState
from cs_vit_tpu.train import build_optimizer as j_build_optimizer
from cs_vit_tpu.train import make_train_step as j_make_train_step
from cs_vit_tpu.train.convert import export_poser_state_dict
from cs_vit_tpu_torch.cli.common import build_model
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.models import MHA, PoserConfig, init_poser_weights
from cs_vit_tpu_torch.serving import PoserSession
from cs_vit_tpu_torch.train import TrainState, build_optimizer, make_train_step
from cs_vit_tpu_torch.train.convert import (
    FlaxMapper,
    load_reference_state_dict,
    state_dict_from_flax,
)

from .helpers import tiny_batch, tiny_poser
from .test_torch_poser import (
    _port_tiny,
    compare,
    compare_latent,
    jax_and_port,
    latent_values,
    pinned_latent_draws,
    to_numpy,
)

LR, WD = 1e-3, 0.01
# the released reference configuration's Poser knobs, at the tiny size
SPENC = dict(spatial_layer_type="encoder", num_spatial_layer=6, num_latent_layer=2,
             persp_decorate="patch")
ARGS = ("patches", "square_bboxes", "timestamp", "focal", "princpt")


def test_patch_decoration_predict_matches_jax(rng):
    compare(*jax_and_port(rng, 2, 2, persp_decorate="patch"))


def test_latent_realtime_predict_matches_jax(rng):
    """The latent group with realtime temporal encoders over T=3: the
    timestamps are doubled with the rows; the transformed half un-rotated."""
    jmodel, variables, tmodel, batch = jax_and_port(
        rng, 2, 3, num_latent_layer=2, persp_decorate="patch", temporal_supervision="realtime")
    compare_latent(jmodel, variables, tmodel, batch, rng)


def test_latent_needs_its_generator(rng):
    """Without the latent stream both packages refuse: flax's ``make_rng``
    raises without a "latent" rng, the port without ``latent_generator``;
    so does a session, which passes none (as the JAX session's jitted
    predict passes no "latent" rng)."""
    jmodel, variables, tmodel, batch = jax_and_port(rng, 2, 1, **SPENC)
    args = [batch[k] for k in ARGS]
    with pytest.raises(InvalidRngError):
        jmodel.apply(variables, *[jnp.asarray(a) for a in args], "inference",
                     method=jmodel.predict)
    with pytest.raises(ValueError, match="latent_generator"):
        tmodel.predict(*[torch.from_numpy(a) for a in args])
    cfg = FinetuneConfig(exp="t", backbone="test", img_size=32, num_latent_layer=2,
                         persp_decorate="patch")
    sess = PoserSession(cfg, batch_size=2, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="evaluate.py:56"):
        sess.predict_crops(*args)


def test_mha_promotes_mixed_dtypes(rng):
    """bf16 weights, bf16 queries over f32 context (patch decoration leaves
    the query tokens bf16 while the eager backbone hands f32 patches): the
    scores run in f32 as JAX's einsum promotes them; one bf16 rounding of
    each projection apart."""
    jm = JMHA(16, 2)
    x = rng.normal(size=(3, 3, 16)).astype(np.float32)
    ctx = rng.normal(size=(3, 5, 16)).astype(np.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(ctx))["params"]
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(ctx)), np.float32)
    mapper = FlaxMapper(to_numpy(jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), params)))
    mapper.mha((), "")
    m = MHA(16, 2)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in mapper.out.items()})
    with torch.no_grad():
        got = m.to(torch.bfloat16)(torch.from_numpy(x).bfloat16(), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_latent_without_patch_decoration_is_refused():
    with pytest.raises(AssertionError):
        tiny_poser(num_latent_layer=2).config
    with pytest.raises(ValueError, match="persp_decorate='patch'"):
        PoserConfig(backbone="test", num_latent_layer=2)


def test_weight_round_trip_and_latent_keys_dropped(rng, capsys):
    """Encoder-type spatial layers and the latent group: the port's mapping
    gives exactly the names of the JAX package's export, loads strictly and
    gives them back; a model without the latent group drops exactly the
    latent_trans.* keys and stays strict on every other key."""
    jmodel, variables, tmodel, _ = jax_and_port(rng, 2, 1, **SPENC)
    params, stats = to_numpy(variables["params"]), to_numpy(variables["batch_stats"])
    sd = state_dict_from_flax(params, stats, tmodel.config)
    want = export_poser_state_dict(params, stats, jmodel.config)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    got = tmodel.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    latent = [k for k in sd if k.startswith("latent_trans.")]
    assert len(latent) > 60 and any(k.startswith("latent_trans.sr.1.") for k in latent)

    plain = _port_tiny(**dict(SPENC, num_latent_layer=None))
    load_reference_state_dict(plain, sd)
    assert f"dropped {len(latent)} latent_trans.* keys" in capsys.readouterr().out
    for k, v in plain.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_state_dict(plain, {k: v for k, v in sd.items() if k != "query_token"})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_state_dict(plain, dict(sd, extra=np.zeros(1, np.float32)))


def test_session_serves_a_latent_trained_checkpoint(tmp_path, rng, capsys):
    """A config.json in the reference layout with num_latent_layer null (as
    evaluation rewrites it) and a .pt whose state dict carries the latent
    group: from_experiment drops exactly those keys and serves the rest."""
    layout = dict(exp="spenc", backbone="test", img_size=32, num_joints=16,
                  num_spatial_layer=6, spatial_layer_type="encoder", num_temporal_layer=2,
                  persp_decorate="patch", temporal_supervision="realtime", phase="spatial",
                  data="dexycb", seq_len=1, batch_size=2)
    trained = build_model(FinetuneConfig(**layout, num_latent_layer=2))
    init_poser_weights(trained, 5)
    sd = trained.state_dict()
    n_latent = sum(k.startswith("latent_trans.") for k in sd)
    torch.save({"epoch": 0, "model": sd, "merged": sd}, tmp_path / "checkpoint.pt")
    (tmp_path / "config.json").write_text(json.dumps(dict(layout, num_latent_layer=None)))
    sess = PoserSession.from_experiment(str(tmp_path), batch_size=2, dtype="float32",
                                        device="cpu")
    assert f"dropped {n_latent} latent_trans.* keys" in capsys.readouterr().out
    assert sess.model.latent_trans is None
    for k, v in sess.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    batch = tiny_batch(rng, B=3, T=1)
    out = sess.predict_crops(*[batch[k] for k in ARGS])
    assert out["joint_cam"].shape == (3, 1, 21, 3) and np.isfinite(out["joint_cam"]).all()


@pytest.fixture(scope="module")
def latent_step():
    """One JAX latent-2x spatial step of the spenc_addpat configuration at
    the tiny size (f32, lr 1e-3, droppath 0, B=4, T=1 as
    ``test_torch_train.py``'s step: at B=2 the perspective encoder's
    batch-statistics BatchNorms see two rows and its grads are f32 noise)
    with pinned draws, and the jax.grad of its loss (both compiled)."""
    rng = np.random.default_rng(13)
    jmodel, variables, _, batch = jax_and_port(rng, 4, 1, jit_init=True, **SPENC)
    draws = latent_values(rng, 4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(0)

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jbatch, phase="spatial", rngs={"droppath": key, "latent": key},
                              mutable=["batch_stats"])
        return out["loss"]

    tx = j_build_optimizer(variables["params"], "spatial", LR)
    with pinned_latent_draws(*draws):
        grads = jax.jit(jax.grad(loss))(variables["params"])
        new_state, metrics = j_make_train_step(jmodel, tx, "spatial", donate=False)(
            JTrainState.create(variables, tx), jbatch, key)
    return dict(batch=batch, draws=draws, variables=to_numpy(variables), grads=to_numpy(grads),
                new_params=to_numpy(new_state.params),
                new_stats=to_numpy(new_state.batch_stats), metrics=to_numpy(metrics))


def _flat_logs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_logs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = float(v)
    return out


def test_latent_spatial_step_matches_jax(latent_step):
    js = latent_step
    model = _port_tiny(**SPENC)
    stats0 = js["variables"]["batch_stats"]
    load_reference_state_dict(model, state_dict_from_flax(js["variables"]["params"], stats0,
                                                          model.config))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState.create(model, build_optimizer(model, "spatial", LR, weight_decay=WD))
    step = make_train_step(model, state.optimizer, "spatial")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in js["batch"].items()}
    with pinned_latent_draws(*js["draws"]):
        state, metrics = step(state, batch, None, torch.Generator())
    jm = js["metrics"]
    assert state.step == 1 and float(metrics["skipped"]) == 0.0
    assert float(metrics["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=5e-5)
    logs, jlogs = _flat_logs(metrics["scalar_logs"]), _flat_logs(jm["scalar_logs"])
    assert set(logs) == set(jlogs) and jlogs["trans.trans"] > 0
    for k, v in jlogs.items():
        assert logs[k] == pytest.approx(v, rel=1e-5, abs=1e-9), k
    assert logs["total"] == pytest.approx(logs["origin.origin"] + 1e-2 * logs["trans.trans"],
                                          rel=1e-6)
    assert metrics["joint_cam_pred"].shape == (4, 1, 21, 3)  # the origin half

    clip = min(1.0, 5.0 / float(jm["grad_norm"]))
    names = dict(model.named_parameters())
    jgrads = state_dict_from_flax(js["grads"], stats0, model.config)
    jparams = state_dict_from_flax(js["new_params"], js["new_stats"], model.config)
    trained = {id(p) for p in state.optimizer.params()}
    for n, p in names.items():
        if id(p) not in trained:
            continue
        g_want = jgrads[n] * clip
        atol = 1e-4 * float(np.abs(g_want).max()) + 1e-6 * 5.0
        np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=0, atol=atol, err_msg=n)
        got, want = p.detach().numpy(), jparams[n]
        sensitive = np.abs(g_want) < 10 * atol
        allowed = np.where(sensitive, 2 * LR, 1e-6 * np.abs(want) + 1e-3 * LR)
        assert (np.abs(got - want) <= allowed).all(), n
    for n, b in model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), jparams[n], atol=1e-5, rtol=1e-5, err_msg=n)
    # all six encoder-type layers ran in training mode: their statistics moved
    for i in range(6):
        for norm in ("norm1", "norm2"):
            k = f"spatial_encoder.layers.{i}.{norm}.running_mean"
            assert not torch.equal(model.get_buffer(k), before[k]), k
    # layers 0..4 get no gradient and move by AdamW's decay alone, on both sides
    for n, p in names.items():
        if n.startswith(tuple(f"spatial_encoder.layers.{i}." for i in range(5))):
            assert not p.grad.any(), n
            np.testing.assert_allclose(p.detach().numpy(), before[n].numpy() * (1 - LR * WD),
                                       rtol=1e-6, atol=1e-9, err_msg=n)
            np.testing.assert_allclose(jparams[n], before[n].numpy() * (1 - LR * WD),
                                       rtol=1e-6, atol=1e-9, err_msg=n)
    # the latent group trains in no phase: bit-identical, its statistics too
    latent = [k for k in before if k.startswith("latent_trans.")]
    assert latent
    for k in latent:
        assert torch.equal(model.state_dict()[k], before[k]), k
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(jparams[k], before[k].numpy(), err_msg=k)
