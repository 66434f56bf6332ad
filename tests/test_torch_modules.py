"""Port parity: cs_vit_tpu_torch.models.modules against the JAX package.

Each flax module is initialised, its BatchNorm running statistics are
randomised (at init BN is the identity and would hide a wrong mapping), its
weights are carried over by ``FlaxMapper`` and both sides see the same numpy
input. f32 throughout; tolerance 2e-5 absolute/relative: the same ops in a
different summation order on O(1) activations (MHA with the sqrt(d_h)
multiply sharpens the softmax, hence not 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.models import modules as jm
from cs_vit_tpu_torch.models import modules as tm
from cs_vit_tpu_torch.train.convert import FlaxMapper, load_reference_state_dict

TOL = dict(atol=2e-5, rtol=2e-5)


def _randomize_stats(stats, rng):
    def f(path, v):
        name = path[-1].key
        shape = np.shape(v)
        if name == "mean":
            return jnp.asarray(rng.normal(scale=0.3, size=shape), jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 2.0, size=shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(f, stats)


def _carry(variables, rng, fill):
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _randomize_stats(variables.get("batch_stats", {}), rng)
    m = FlaxMapper(params, jax.tree.map(np.asarray, stats))
    fill(m)
    return {"params": variables["params"], "batch_stats": stats}, m.out


def _check(jmodule, tmodule, fill, args, rng, **apply_kw):
    variables = jmodule.init(jax.random.key(0), *[jnp.asarray(a) for a in args], **apply_kw)
    variables, sd = _carry(variables, rng, fill)
    want = jmodule.apply(variables, *[jnp.asarray(a) for a in args], **apply_kw)
    load_reference_state_dict(tmodule, sd)
    with torch.no_grad():
        got = tmodule.eval()(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batchnorm_eval_matches_jax(rng):
    x = rng.normal(size=(4, 3, 16)).astype(np.float32)
    _check(jm.TorchBatchNorm(), tm.TorchBatchNorm(16), lambda m: m.bn((), ""),
           (x,), rng, use_running_average=True)


def test_batchnorm_keeps_bf16_and_refuses_training_mode():
    """The mode is the phase's ``train`` argument: ``nn.Module.train()`` does
    not switch the module to batch statistics, nor touch the running ones."""
    bn = tm.TorchBatchNorm(8).eval()
    x = torch.randn(2, 3, 8, dtype=torch.bfloat16)
    want = bn(x)
    assert want.dtype == torch.bfloat16
    assert torch.equal(bn.train()(x), want)
    assert torch.equal(bn.running_mean, torch.zeros(8))
    assert bn(x, train=True).dtype == torch.bfloat16


@pytest.mark.parametrize("compat_scale", [True, False])
def test_mha_matches_jax(rng, compat_scale):
    x = rng.normal(size=(3, 4, 16)).astype(np.float32)
    ctx = rng.normal(size=(3, 7, 16)).astype(np.float32)
    _check(jm.MHA(16, 2, compat_scale), tm.MHA(16, 2, compat_scale),
           lambda m: m.mha((), ""), (x, ctx), rng)


def test_encoder_block_matches_jax(rng):
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    _check(jm.EncoderBlock(16, 2), tm.EncoderBlock(16, 2),
           lambda m: m.encoder_block((), ""), (x,), rng)


def test_decoder_block_matches_jax(rng):
    x = rng.normal(size=(3, 3, 16)).astype(np.float32)
    ref = rng.normal(size=(3, 9, 16)).astype(np.float32)
    _check(jm.DecoderBlock(16, 2), tm.DecoderBlock(16, 2),
           lambda m: m.decoder_block((), ""), (x, ref), rng)


def test_absolute_positional_encoding_matches_jax(rng):
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)

    def fill(m):
        m.out["pe.weight"] = m.p[("pe",)]

    _check(jm.PositionalEncoding(16, mode="absolute"), tm.PositionalEncoding(16), fill, (x,), rng)


def test_linear_and_layer_norm_promote_like_flax():
    lin = tm.Linear(4, 3).to(torch.bfloat16)
    assert lin(torch.randn(2, 4)).dtype == torch.float32       # f32 input, bf16 weights
    assert lin(torch.randn(2, 4, dtype=torch.bfloat16)).dtype == torch.bfloat16
    ln = tm.LayerNorm(4).to(torch.bfloat16)
    assert ln(torch.randn(2, 4)).dtype == torch.float32
    assert ln(torch.randn(2, 4, dtype=torch.bfloat16)).dtype == torch.bfloat16
