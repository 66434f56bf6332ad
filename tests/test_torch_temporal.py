"""Port parity: the temporal path, realtime and full, against the JAX package.

The realtime temporal encoders (continuous-time RoPE, cross-attention
decoders over the frames with the last frame as the query) and the full ones
(absolute PE, encoder blocks over T) run inside ``Poser.predict``; the flax
weights cross over through the port's own ``state_dict_from_flax``. Models
are ``tests/helpers.py:tiny_poser`` and its port with random BatchNorm
statistics and non-zero ``zero_conv`` kernels (test_torch_poser.randomize),
so every temporal layer changes the output. Tolerances, each with its reason:

* ``CrossAttnDecoder``, f32: 1e-5 (same graph, other summation order; the
  sqrt(d_h)-multiplied softmax sharpens f32 noise a little), BatchNorm
  statistics 1e-6 (same f32 formulas).
* trope PE: f32 1e-6 (cos/sin of the same f32 phases in two libraries);
  bf16 one bf16 ulp of each value (one rounding of values that agree to
  f32 noise).
* ``Poser.predict`` and the sessions: 1e-4 of each output's scale plus 1e-4,
  as tests/test_torch_poser.py (measured there: ~3e-5 of scale), for the
  realtime case (T=3, measured <= 1e-5). In the full case (T=5) five frames
  of random-weight temporal encoders and the 6D-to-axis-angle conversion of
  random poses amplify f32 sum-order noise so far that JAX's own f32
  outputs miss its float64 ones (the same model and inputs under
  ``jax.enable_x64``, the packages' f32 casts in LayerNorm, BatchNorm and
  softmax kept) by up to 4.3e-4 of scale. The port's f32 outputs are held
  against those float64 outputs instead: they may miss them by twice the
  larger of JAX's own f32 miss (its XLA and Pallas paths) and 1e-4 of
  scale, plus 1e-4. Measured over five seeds of these inputs (17, the
  test's, and 1-4), as the largest miss over the outputs, of scale: JAX
  f32 2.3e-5 to 4.3e-4, the port's eager path 7.9e-6 to 7.2e-4 and its
  attention-kernel path 9.0e-6 to 8.3e-4 (seed 4 for all three maxima); at
  the test's seed JAX 2.0e-4, the port 1.6e-4 (eager) and 4.6e-5 (kernel).
  The float64 runs of the two packages agree to 1.8e-5 of scale there (the
  f32 casts round in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.config import FinetuneConfig as JFinetuneConfig
from cs_vit_tpu.models.modules import CrossAttnDecoder as JCrossAttnDecoder
from cs_vit_tpu.models.modules import PositionalEncoding as JPositionalEncoding
from cs_vit_tpu.serving import PoserSession as JPoserSession
from cs_vit_tpu.train.convert import export_poser_state_dict
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.models import CrossAttnDecoder, PositionalEncoding, init_poser_weights
from cs_vit_tpu_torch.serving import PoserSession
from cs_vit_tpu_torch.train.convert import (
    FlaxMapper,
    load_reference_state_dict,
    state_dict_from_flax,
)

from .helpers import tiny_batch, tiny_poser
from .test_torch_poser import KEYS, _port_tiny, compare, randomize, to_numpy

CASES = {"realtime": 3, "full": 5}  # __graft_entry__'s temporal cases: realtime T=3, full T=5
ARGS = ("patches", "square_bboxes", "timestamp", "focal", "princpt")  # of predict
TEMPORAL = ("pose_temporal_encoder", "shape_temporal_encoder", "root_temporal_encoder")


@pytest.mark.parametrize("train", [False, True])
def test_cross_attn_decoder_matches_jax(rng, train):
    """[B, 1, D] queries (the last frame) over [B, T, D] frames; in training
    mode the BatchNorms take statistics over the B query tokens."""
    D, H = 16, 2
    x = rng.normal(size=(4, 1, D)).astype(np.float32)
    ref = rng.normal(size=(4, 3, D)).astype(np.float32)
    jmod = JCrossAttnDecoder(D, H)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(ref))
    variables = randomize(variables, rng)
    want, mutated = jmod.apply(variables, jnp.asarray(x), jnp.asarray(ref), train=train,
                               mutable=["batch_stats"])
    m = FlaxMapper(to_numpy(variables["params"]), to_numpy(variables["batch_stats"]))
    m.cross_attn_decoder((), "")
    port = CrossAttnDecoder(D, H)
    load_reference_state_dict(port, m.out)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ref), train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for n in ("norm1", "norm2"):
        bn, stats = getattr(port, n), mutated["batch_stats"][n]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trope_matches_jax(rng, dtype):
    x = rng.normal(size=(2, 4, 16)).astype(np.float32)
    t = np.cumsum(rng.uniform(10, 50, size=(2, 4)), axis=1).astype(np.float32) / 20.0
    want = JPositionalEncoding(16, mode="trope").apply(
        {}, jnp.asarray(x).astype(dtype), jnp.asarray(t))
    pe = PositionalEncoding(16, mode="trope")
    assert not list(pe.state_dict())  # no parameters, no persistent buffers
    got = pe(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(t))
    assert str(got.dtype) == f"torch.{want.dtype}"
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


@pytest.fixture(scope="module", params=sorted(CASES))
def temporal_jax(request):
    """tiny_poser with `temporal_supervision` = the param, randomised
    statistics and zero_conv, and a B=2 batch of CASES[param] frames."""
    sup = request.param
    rng = np.random.default_rng(17)
    batch = tiny_batch(rng, B=2, T=CASES[sup])
    variables = tiny_poser(temporal_supervision=sup).init(
        {"params": jax.random.key(0), "droppath": jax.random.key(1), "latent": jax.random.key(2)},
        {k: jnp.asarray(v) for k, v in batch.items()}, phase="inference",
    )
    return sup, randomize(variables, rng), batch


@pytest.fixture(scope="module")
def full_f64(temporal_jax):
    """For the full case: JAX's float64 predict outputs and the largest miss
    of its f32 ones (XLA and Pallas paths) from them, per output."""
    sup, variables, batch = temporal_jax
    if sup != "full":
        return None
    args = [batch[k] for k in ARGS]
    jmodel = tiny_poser(temporal_supervision=sup, attention_impl="xla")
    with jax.enable_x64(True):
        want = jmodel.apply(jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), variables),
                            *[jnp.asarray(a, jnp.float64) for a in args], "inference",
                            method=jmodel.predict)
        want = {k: np.asarray(v) for k, v in want.items()}
    miss = dict.fromkeys(KEYS, 0.0)
    for jimpl in ("xla", "pallas"):
        m = tiny_poser(temporal_supervision=sup, attention_impl=jimpl)
        got = m.apply(variables, *[jnp.asarray(a) for a in args], "inference", method=m.predict)
        for k in KEYS:
            miss[k] = max(miss[k], float(np.abs(np.asarray(got[k], np.float64) - want[k]).max()))
    return want, miss


@pytest.mark.parametrize("impl,jimpl", [("eager", "xla"), ("pallas", "pallas")])
def test_predict_matches_jax(temporal_jax, full_f64, impl, jimpl):
    """Realtime T=3 (outputs [B,1,...]) and full T=5 (outputs [B,T,...]), on
    the eager backbone and on the attention-only kernel's (plain version on
    the CPU; JAX runs Pallas in interpret mode). Full: against JAX's float64
    outputs (see the module docstring)."""
    sup, variables, batch = temporal_jax
    tmodel = _port_tiny(temporal_supervision=sup, attention_impl=impl)
    load_reference_state_dict(tmodel, state_dict_from_flax(
        to_numpy(variables["params"]), to_numpy(variables["batch_stats"]), tmodel.config))
    if sup == "realtime":
        compare(tiny_poser(temporal_supervision=sup, attention_impl=jimpl), variables, tmodel,
                batch)
    with torch.no_grad():
        out = tmodel.eval().predict(*[torch.from_numpy(batch[k]) for k in ARGS])
    assert out["joint_cam"].shape == (2, 1 if sup == "realtime" else CASES[sup], 21, 3)
    if sup == "full":
        want, jax_miss = full_f64
        for k in KEYS:
            scale = np.abs(want[k]).max()
            err = np.abs(out[k].numpy().astype(np.float64) - want[k]).max()
            assert err <= 2 * max(jax_miss[k], 1e-4 * scale) + 1e-4, (k, err, jax_miss[k], scale)


def test_realtime_weights_carry_across(temporal_jax):
    """The port's state_dict_from_flax gives the names and values of the JAX
    package's own exporter, and they load strictly: cross-attention decoders
    (norm1, cross_atten, norm2, ffn) and no pe_temporal."""
    sup, variables, _ = temporal_jax
    tmodel = _port_tiny(temporal_supervision=sup)
    params, stats = to_numpy(variables["params"]), to_numpy(variables["batch_stats"])
    sd = state_dict_from_flax(params, stats, tmodel.config)
    want = export_poser_state_dict(params, stats, tiny_poser(temporal_supervision=sup).config)
    assert set(sd) == set(want) == set(tmodel.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k], np.asarray(v), err_msg=k)
    load_reference_state_dict(tmodel, sd)
    temporal = [k for k in sd if k.startswith(TEMPORAL)]
    if sup == "realtime":
        assert not any(".pe_temporal." in k for k in temporal)
        assert {k.split(".")[3] for k in temporal if ".layers." in k} == {
            "norm1", "cross_atten", "norm2", "ffn"}
    else:
        assert all(f"{n}.pe_temporal.pe.weight" in sd for n in TEMPORAL)


def test_temporal_phase_builds_no_graph_below_the_temporal_encoders(rng):
    """The backbone, the perspective encoder and the spatial encoder run
    without autograd in the temporal phase: the loss reaches the temporal
    encoders and the heads above them (frozen by the optimizer, as in JAX,
    whose stop_gradient sits at the same place), and nothing below."""
    model = _port_tiny(temporal_supervision="realtime", temporal_init_method="random")
    init_poser_weights(model, 0)
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(rng, B=2, T=3).items()}
    out = model(batch, "temporal")
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(out["loss"], params, allow_unused=True)
    reached = {n for n, g in zip(names, grads) if g is not None}
    heads = ("pose_decoder", "shape_decoder", "root_decoder")
    assert {n for n in names if n.startswith(TEMPORAL + heads)} == reached


def test_realtime_session_matches_jax(tmp_path, rng):
    """PoserSession(seq_len=3) with realtime temporal encoders against the
    JAX session on its exported weights: [N, 1, 21, 3] out, N=3 at batch 2
    (one padded chunk), timestamps 33 ms apart."""
    cfg = dict(exp="rt", backbone="test", img_size=32, phase="inference",
               temporal_supervision="realtime", temporal_init_method="random")
    jsess = JPoserSession(JFinetuneConfig(**cfg), batch_size=2, seq_len=3, dtype="float32")
    sd = export_poser_state_dict(to_numpy(jsess._params), to_numpy(jsess._stats),
                                 jsess.model.config)
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               tmp_path / "checkpoint.pt")
    sess = PoserSession(FinetuneConfig(**cfg), checkpoint=str(tmp_path / "checkpoint.pt"),
                        batch_size=2, seq_len=3, dtype="float32", device="cpu")
    N, T = 3, 3
    req = (rng.uniform(size=(N, T, 32, 32, 3)).astype(np.float32),
           np.tile(np.asarray([10, 10, 200, 200], np.float32), (N, T, 1)),
           np.tile(np.arange(T, dtype=np.float32) * 33.3, (N, 1)),
           np.full((N, T, 2), 300.0, np.float32), np.full((N, T, 2), 100.0, np.float32))
    got, want = sess.predict_crops(*req), jsess.predict_crops(*req)
    assert got["joint_cam"].shape == (N, 1, 21, 3)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max() + 1e-4, k
