"""Port parity: the latent group's modules against the JAX package.

``RoPE2DPositionalEncoding``, ``ContinuousAngleEmbedding``, ``MLP3`` and
``ScaleRotComplexEmbedTransformationGroup`` (both ``compat_swap`` wirings,
``truncate``), f32, weights initialised by flax then perturbed (the
frequency bank, the radial embedding, the BatchNorm running statistics),
carried across with the port's ``FlaxMapper``; inputs made by numpy from a
seed. Tolerance: max|port - jax| <= 1e-5 max|jax| + 1e-6 (the same f32
formulas; sums run in other orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.models import latent as jlatent
from cs_vit_tpu.models import modules as jmodules
from cs_vit_tpu_torch.models import (
    MLP3,
    ContinuousAngleEmbedding,
    RoPE2DPositionalEncoding,
    ScaleRotComplexEmbedTransformationGroup,
    compose_sr,
    init_poser_weights,
)
from cs_vit_tpu_torch.models.modules import floor_mod
from cs_vit_tpu_torch.train.convert import FlaxMapper

from .test_torch_poser import _port_tiny

D, P, HEADS = 16, 4, 2


def close(got: torch.Tensor, want) -> None:
    w = np.asarray(want)
    g = got.detach().numpy()
    assert g.shape == w.shape and g.dtype == w.dtype
    err = np.abs(g - w).max()
    assert err <= 1e-5 * np.abs(w).max() + 1e-6, (err, np.abs(w).max())


def perturbed(tree, rng, scale=0.3):
    """Every leaf moved by N(0, scale) noise relative to its size (variances
    kept positive)."""
    def leaf(path, v):
        v = np.asarray(v)
        if path[-1].key == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, size=v.shape), jnp.float32)
        return jnp.asarray(v + scale * rng.normal(size=v.shape) * (np.abs(v).mean() + 0.1),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def load(module: torch.nn.Module, mapper: FlaxMapper) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in mapper.out.items()},
                           strict=True)
    return module


def test_rope2d_matches_jax(rng):
    jm = jmodules.RoPE2DPositionalEncoding(D, P, P, 32)
    x = rng.normal(size=(3, P * P, D)).astype(np.float32)
    params = perturbed(jm.init(jax.random.key(0), jnp.asarray(x))["params"], rng)
    want = jm.apply({"params": params}, jnp.asarray(x))
    m = RoPE2DPositionalEncoding(D, P, P, 32)
    assert [n for n, _ in m.named_parameters()] == ["embedding"] and not m.state_dict().keys() - {
        "embedding"}
    m.embedding.data = torch.from_numpy(np.array(params["embedding"]))
    close(m(torch.from_numpy(x)), want)
    # bf16 patches stay bf16: the f32 result on the same patches, rounded
    xb = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        got = m(xb)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, m(xb.float()).bfloat16())


def test_angle_embedding_matches_jax(rng):
    jm = jmodules.ContinuousAngleEmbedding(output_dim=D, num_freq=32)
    # angles past 2 pi and below 0 exercise the mod
    a = rng.uniform(-8.0, 14.0, size=(7,)).astype(np.float32)
    init = jm.init(jax.random.key(0), jnp.asarray(a))["params"]
    m = ContinuousAngleEmbedding(D, num_freq=32)
    np.testing.assert_array_equal(m.freq_base.detach().numpy(), np.asarray(init["freq_base"]))
    params = perturbed(init, rng, scale=0.05)
    mapper = FlaxMapper(params)
    mapper.angle_embedder((), "")
    assert set(mapper.out) == {"freq_base", "proj.0.weight", "proj.0.bias", "proj.2.weight",
                               "proj.2.bias"}
    load(m, mapper)
    close(m(torch.from_numpy(a)), jm.apply({"params": params}, jnp.asarray(a)))
    np.testing.assert_array_equal(floor_mod(torch.from_numpy(a), 2 * math.pi).numpy(),
                                  np.asarray(jnp.mod(jnp.asarray(a), 2 * math.pi)))


def test_mlp3_matches_jax(rng):
    jm = jlatent.MLP3(D)
    x = rng.normal(size=(5, D)).astype(np.float32)
    params = perturbed(jm.init(jax.random.key(0), jnp.asarray(x))["params"], rng)
    mapper = FlaxMapper(params)
    mapper.mlp3((), "")
    close(load(MLP3(D), mapper)(torch.from_numpy(x)), jm.apply({"params": params},
                                                               jnp.asarray(x)))


@pytest.mark.parametrize("compat_swap,truncate,train", [
    (True, None, False), (False, None, False), (True, 1, False), (True, None, True)])
def test_latent_group_matches_jax(rng, compat_swap, truncate, train):
    """Two encoder blocks over a 4x4 grid; running statistics (as the Poser
    runs it) and, in one case, batch statistics with their update."""
    jm = jlatent.ScaleRotComplexEmbedTransformationGroup(
        num_layers=2, embed_dim=D, num_heads=HEADS, num_p=P, num_q=P, compat_swap=compat_swap)
    N = 6
    x = rng.normal(size=(N, P * P, D)).astype(np.float32)
    scale = (np.clip(rng.normal(size=N), -0.3, 0.3) + 1).astype(np.float32)
    angle = (rng.uniform(size=N) * 2 * np.pi).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(angle))
    variables = jm.init(jax.random.key(0), *args)
    params = perturbed(variables["params"], rng, scale=0.1)
    stats = perturbed(variables["batch_stats"], rng)
    want, mutated = jm.apply({"params": params, "batch_stats": stats}, *args, train=train,
                             truncate=truncate, mutable=["batch_stats"])
    mapper = FlaxMapper(params, stats)
    mapper.latent_group((), "", 2)
    m = load(ScaleRotComplexEmbedTransformationGroup(2, D, HEADS, P, P, compat_swap=compat_swap),
             mapper)
    got = m(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(angle), train=train,
            truncate=truncate)
    close(got, want)
    after = FlaxMapper(params, mutated["batch_stats"])
    after.latent_group((), "", 2)
    for k, v in m.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), after.out[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # the swap matters: the other wiring gives another output
    other = load(ScaleRotComplexEmbedTransformationGroup(2, D, HEADS, P, P,
                                                         compat_swap=not compat_swap), mapper)
    assert not torch.allclose(other(torch.from_numpy(x), torch.from_numpy(scale),
                                    torch.from_numpy(angle), truncate=truncate), got)


def test_compose_sr_and_init_rules():
    assert compose_sr(1.5, 0.25, 2.0, 1.0) == (3.0, 1.25)
    model = _port_tiny(num_latent_layer=1, persp_decorate="patch")
    init_poser_weights(model, 0)
    lt = model.latent_trans
    for emb in (lt.scale_embedder, lt.angle_embedder):
        np.testing.assert_allclose(emb.freq_base.detach().numpy(),
                                   np.logspace(0, 1, 32).astype(np.float32))
    # N(0, 1), not the fan-in rule's N(0, 1/D)
    assert 0.8 < float(lt.rope2d.embedding.detach().std()) < 1.2
