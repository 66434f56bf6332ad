"""Port parity: the whole inference slice, ``Poser.predict`` against JAX
``Poser.predict(phase="inference")``.

The flax model is initialised, then every BatchNorm running mean/var is
randomised and every temporal ``zero_conv`` kernel set non-zero (at init BN
is the identity and the temporal encoders add exactly zero, which would leave
half the path untested). Weights cross over through the port's own
``state_dict_from_flax``; the same numpy batch goes to both sides.

Tolerance, f32: 1e-4 of each output's largest magnitude (joint_cam: about
0.05 mm at the ~500 mm these random weights produce), plus 1e-4 absolute.
Both sides compute the same graph; summation order differs (~1e-7
relative) and untrained weights amplify that through 6 decoder layers with
the sqrt(d_h)-sharpened softmax to ~3e-5 relative, measured.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.cli.common import build_model as j_build_model
from cs_vit_tpu.cli.common import init_variables
from cs_vit_tpu.config import FinetuneConfig as JFinetuneConfig
from cs_vit_tpu_torch.cli.common import build_model
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.mano import ManoLayer, sh_joint_regressor, synthetic_assets
from cs_vit_tpu_torch.models import Poser, PoserConfig, SwinV2Config
from cs_vit_tpu_torch.models import poser as tposer
from cs_vit_tpu_torch.train.convert import load_reference_state_dict, state_dict_from_flax

from .helpers import TINY_SWIN, tiny_batch, tiny_poser

KEYS = ("joint_cam", "verts_cam", "pose_aa", "shape", "root_transl")


def randomize(variables, rng):
    """Random BN running statistics and non-zero temporal zero_conv kernels."""
    def stats(path, v):
        shape = np.shape(v)
        if path[-1].key == "mean":
            return jnp.asarray(rng.normal(scale=0.2, size=shape), jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, size=shape), jnp.float32)

    def params(path, v):
        if any(getattr(p, "key", None) == "zero_conv" for p in path):
            return jnp.asarray(rng.normal(scale=0.05, size=np.shape(v)), jnp.float32)
        return v

    return {
        "params": jax.tree_util.tree_map_with_path(params, variables["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(stats, variables["batch_stats"]),
    }


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def compare(jmodel, variables, tmodel, batch, rel=1e-4, rngs=None, latent_generator=None):
    args = [batch[k] for k in ("patches", "square_bboxes", "timestamp", "focal", "princpt")]
    want = jmodel.apply(variables, *[jnp.asarray(a) for a in args], "inference",
                        method=jmodel.predict, rngs=rngs)
    with torch.no_grad():
        got = tmodel.eval().predict(*[torch.from_numpy(a) for a in args],
                                    latent_generator=latent_generator)
    for k in KEYS:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        err = np.abs(g - w).max()
        assert err <= rel * np.abs(w).max() + 1e-4, (k, err, np.abs(w).max())


def _port_tiny(**overrides) -> Poser:
    sw = SwinV2Config(**{f: getattr(TINY_SWIN, f) for f in (
        "image_size", "patch_size", "embed_dim", "depths", "num_heads", "window_size",
        "drop_path_rate", "pretrained_window_sizes")})
    kw = dict(backbone="custom", custom_swin=sw, image_size=32, num_pose_query=16,
              num_spatial_layer=2, num_temporal_layer=1)
    kw.update(overrides)
    assets = synthetic_assets(seed=1)
    return Poser(PoserConfig(**kw), ManoLayer(assets), sh_joint_regressor(assets))


@pytest.fixture(scope="module")
def tiny_jax():
    """helpers.tiny_poser with randomised statistics and a B=2, T=2 batch."""
    rng = np.random.default_rng(7)
    jmodel = tiny_poser()
    batch = tiny_batch(rng, B=2, T=2)
    variables = jmodel.init(
        {"params": jax.random.key(0), "droppath": jax.random.key(1), "latent": jax.random.key(2)},
        {k: jnp.asarray(v) for k, v in batch.items()}, phase="inference",
    )
    return jmodel, randomize(variables, rng), batch


@pytest.mark.parametrize("impl", ["eager", "fused"])
def test_tiny_poser_predict_matches_jax(tiny_jax, impl):
    """T=2 exercises temporal attention over two frames; the port's eager
    backbone and its kernel path (plain versions on CPU)."""
    jmodel, variables, batch = tiny_jax
    tmodel = _port_tiny(attention_impl=impl)
    load_reference_state_dict(tmodel, state_dict_from_flax(
        to_numpy(variables["params"]), to_numpy(variables["batch_stats"]), tmodel.config))
    compare(jmodel, variables, tmodel, batch)


def test_test_backbone_predict_matches_jax(rng):
    """The "test" backbone through both packages' build_model (synthetic MANO,
    the shipped 21x778 joint regressor), B=2 T=1 as served, held against
    JAX's float64 outputs (the same variables and batch under
    ``jax.enable_x64``, the packages' f32 casts kept): the port may miss them
    by twice the larger of JAX's own f32 miss and 1e-4 of each output's scale
    plus 1e-4. Its two Swin stages, six decoder layers and the random-weight
    heads amplify f32 sum-order noise past the f32-against-f32 tolerance of
    ``compare`` on some CPUs. Measured on one such CPU: joint_cam (scale
    1956.7 mm) misses the float64 result by 0.118 mm in the port and by
    0.335 mm in JAX's own f32 run; verts_cam 0.127 / 0.354, root_transl
    0.116 / 0.330, shape 1.6e-3 / 3.4e-3, pose_aa 7.4e-5 / 1.19e-4 (port /
    JAX). There the f32-against-f32 gap (0.453 mm) was JAX's own error."""
    jcfg = JFinetuneConfig(exp="t", backbone="test", img_size=32, attention_impl="xla")
    jmodel = j_build_model(jcfg)
    variables = randomize(init_variables(jmodel, jcfg, 1), rng)
    tmodel = build_model(FinetuneConfig(exp="t", backbone="test", img_size=32))
    load_reference_state_dict(tmodel, state_dict_from_flax(
        to_numpy(variables["params"]), to_numpy(variables["batch_stats"]), tmodel.config))
    batch = tiny_batch(rng, B=2, T=1)
    args = [batch[k] for k in ("patches", "square_bboxes", "timestamp", "focal", "princpt")]
    with jax.enable_x64(True):
        want = jmodel.apply(jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), variables),
                            *[jnp.asarray(a, jnp.float64) for a in args], "inference",
                            method=jmodel.predict)
        want = {k: np.asarray(v) for k, v in want.items()}
    jax32 = jmodel.apply(variables, *[jnp.asarray(a) for a in args], "inference",
                         method=jmodel.predict)
    with torch.no_grad():
        got = tmodel.eval().predict(*[torch.from_numpy(a) for a in args])
    for k in KEYS:
        scale = np.abs(want[k]).max()
        jax_miss = np.abs(np.asarray(jax32[k], np.float64) - want[k]).max()
        err = np.abs(got[k].numpy().astype(np.float64) - want[k]).max()
        assert got[k].shape == want[k].shape, k
        assert err <= 2 * max(jax_miss, 1e-4 * scale + 1e-4), (k, err, jax_miss, scale)


@contextlib.contextmanager
def pinned_latent_draws(normal, uniform):
    """The latent group's draws pinned to the same numpy values on both
    sides: JAX's ``jax.random.normal`` / ``uniform`` of shape (B,) (the
    latent scale and angle; other shapes pass through) and the port's
    ``latent_draws``."""
    B = normal.shape[0]
    j_normal, j_uniform, t_draws = jax.random.normal, jax.random.uniform, tposer.latent_draws

    def fake_normal(key, shape=(), dtype=jnp.float32, *a, **kw):
        if tuple(shape) != (B,):
            return j_normal(key, shape, dtype, *a, **kw)
        return jnp.asarray(normal, dtype)

    def fake_uniform(key, shape=(), dtype=jnp.float32, *a, **kw):
        if tuple(shape) != (B,):
            return j_uniform(key, shape, dtype, *a, **kw)
        return jnp.asarray(uniform, dtype)

    def fake_draws(batch, generator):
        assert batch == B and isinstance(generator, torch.Generator)
        return torch.from_numpy(normal), torch.from_numpy(uniform)

    jax.random.normal, jax.random.uniform = fake_normal, fake_uniform
    tposer.latent_draws = fake_draws
    try:
        yield
    finally:
        jax.random.normal, jax.random.uniform = j_normal, j_uniform
        tposer.latent_draws = t_draws


def latent_values(rng, B):
    """Raw latent draws for B samples: (normal, uniform), f32 numpy."""
    return rng.normal(size=B).astype(np.float32), rng.uniform(size=B).astype(np.float32)


def jax_and_port(rng, B, T, jit_init=False, **overrides):
    """tiny_poser(**overrides) initialised by flax with randomised
    statistics, its port carrying the weights across, and a B x T batch
    whose bboxes, focal lengths and principal points differ per sample and
    frame. `jit_init` compiles the init as one program (quicker than op by
    op for a model whose later calls are compiled too)."""
    jmodel = tiny_poser(**overrides)
    batch = tiny_batch(rng, B=B, T=T)
    x0 = rng.uniform(40, 200, size=(B, T, 2))
    side = rng.uniform(120, 300, size=(B, T, 1))
    batch["square_bboxes"] = np.concatenate([x0, x0 + side], -1).astype(np.float32)
    batch["focal"] = rng.uniform(500, 700, size=(B, T, 2)).astype(np.float32)
    batch["princpt"] = rng.uniform(200, 320, size=(B, T, 2)).astype(np.float32)
    init = jax.jit(jmodel.init, static_argnames="phase") if jit_init else jmodel.init
    variables = init(
        {"params": jax.random.key(0), "droppath": jax.random.key(1), "latent": jax.random.key(2)},
        {k: jnp.asarray(v) for k, v in batch.items()}, phase="inference",
    )
    variables = randomize(variables, rng)
    tmodel = _port_tiny(**overrides)
    load_reference_state_dict(tmodel, state_dict_from_flax(
        to_numpy(variables["params"]), to_numpy(variables["batch_stats"]), tmodel.config))
    return jmodel, variables, tmodel, batch


def compare_latent(jmodel, variables, tmodel, batch, rng):
    """`compare` for a model with a latent group: pinned draws, a "latent"
    rng on the JAX side and a latent generator on the port's."""
    with pinned_latent_draws(*latent_values(rng, batch["patches"].shape[0])):
        compare(jmodel, variables, tmodel, batch, rngs={"latent": jax.random.key(3)},
                latent_generator=torch.Generator())


FORMERLY_REFUSED = {
    "latent": dict(num_latent_layer=2, persp_decorate="patch"),
    "sparse": dict(persp_embed_method="sparse"),
    "orientation": dict(global_positioning="orientation"),
    "encoder": dict(spatial_layer_type="encoder"),
}


@pytest.mark.parametrize("option", sorted(FORMERLY_REFUSED))
def test_formerly_refused_options_match_jax(rng, option):
    """Each option PoserConfig once refused builds and matches JAX's
    predict under `compare`'s rule: the latent group (2 layers, patch
    decoration) at T=1 with pinned draws, its 2B rows in JAX's order; the
    sparse corners, "orientation" positioning and encoder-type spatial
    layers at T=2."""
    kw = FORMERLY_REFUSED[option]
    PoserConfig(backbone="test", **kw)
    jmodel, variables, tmodel, batch = jax_and_port(rng, 2, 1 if option == "latent" else 2, **kw)
    if option == "latent":
        compare_latent(jmodel, variables, tmodel, batch, rng)
    else:
        compare(jmodel, variables, tmodel, batch)
