"""Port parity: TI pretraining's modules, losses and steps against the JAX
package, and the ViT and DINOv2 against local ``transformers`` models.

Sizes: ViT and DINOv2 of 2 layers at width 64 (4 heads), images 32 x 32,
patch 8 (a 4 x 4 grid). The flax parameters come across through
``train/convert.py`` and load with ``strict=True``. The random scales and
angles are JAX's own draws handed to the port's forwards: ``dino_forward``
and ``ti_forward`` split the key they are given, so the test splits it the
same way; ``TIViT`` takes its key from flax's ``make_rng``, so the test
records the normal and uniform draws JAX makes there.

Tolerances: module outputs 2e-5 (f32, sums in other orders; the norms are
unit scale); losses rtol 1e-5; grads 1e-4 of each leaf's largest magnitude
plus 1e-6 of the grads' global norm (both sides differentiate the same graph
with sums in other orders; the floor covers leaves whose exact grad cancels
to zero, such as the attention key biases); a first AdamW step moves a
parameter by lr g / (|g| + eps), so where the grads agree to `atol` the
parameters may differ by lr atol eps / (max(|g| - atol, 0) + eps)^2, at most
2 lr, plus 1e-6 |p| for the f32 rounding of the parameter and 2e-5 lr for
optax's bias correction (its 1 - 0.999 in f32 is 1.3e-5 off, which moves
its step by 6.4e-6 lr from torch's; 6.75e-6 lr measured); BatchNorm
statistics 1e-5.

The latent groups' encoder blocks multiply their attention scores by
sqrt(d_h) (the reference quirk), and with random weights their softmax is
nearly hard: f32 sum-order noise comes out amplified, and JAX's own f32
result misses its float64 one by up to 28 on outputs of 105 at width 64
(4 heads, running statistics). So the groups are held at the width of
``tests/test_torch_latent.py`` (16, 2 heads) to 1e-5 of the largest output
plus 1e-6, and what passes through them at width 64 (TI-DINO's TI terms,
the TI stage's loss and grads) is held to four times JAX's own spread under
a one-ulp move of the group's parameters and the images (``_spread``), plus
the tolerance above. Float64 cannot take the place of the spread: both
packages run the attention softmax and the BatchNorm in f32 whatever the
input dtype, so a float64 run keeps f32 noise (the port misses JAX by 1e-5
of the TI loss there, and a one-ulp float64 move spreads nothing). Each
spread must stay a small share of what it guards (``_assert_small``): under
1e-3 of a group's largest output, 1e-4 of a loss and 2e-2 of a grad leaf's
largest magnitude (measured at these fixtures: at most 6.9e-5, 1.54e-5 and
7.9e-3). The only
leaves spread further are the attention key biases, whose exact grad is
zero (the softmax takes no shift); their grads stay under 1e-6 of the
global norm and the floor above holds them.
"""

import contextlib

import flax.linen as flax_nn
import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cs_vit_tpu.models import latent as jlatent
from cs_vit_tpu.models import modules as jmodules
from cs_vit_tpu.models import ti as jti
from cs_vit_tpu.models.dinov2 import Dinov2Backbone as JDinov2Backbone
from cs_vit_tpu.models.dinov2 import Dinov2Config as JDinov2Config
from cs_vit_tpu.models.vit import ViTConfig as JViTConfig
from cs_vit_tpu.models.vit import ViTEncoder as JViTEncoder
from cs_vit_tpu.models.vit import ViTMAEDecoderConfig as JViTMAEDecoderConfig
from cs_vit_tpu.models.vit import ViTMAEDecoderNoMask as JViTMAEDecoderNoMask
from cs_vit_tpu.models.vit import merge_lora_params as j_merge_lora_params
from cs_vit_tpu.ops.resample import crop_with_normalized_box_np as j_crop_normalized
from cs_vit_tpu.ops.resample import scale_rotate_img as j_scale_rotate_img
from cs_vit_tpu.train.sparse_update import mask_random_columns as j_mask_random_columns
from cs_vit_tpu_torch.cli import pretrain_ti
from cs_vit_tpu_torch.models import latent, ti
from cs_vit_tpu_torch.models.dinov2 import (
    Dinov2Backbone,
    Dinov2Config,
    convert_hf_dinov2_state_dict,
)
from cs_vit_tpu_torch.models.modules import LoraCompatibleMHA
from cs_vit_tpu_torch.models.vit import (
    ViTConfig,
    ViTEncoder,
    ViTMAEDecoderConfig,
    ViTMAEDecoderNoMask,
    convert_hf_mae_decoder_state_dict,
    convert_hf_vit_state_dict,
    merge_lora_params,
)
from cs_vit_tpu_torch.ops.resample import crop_with_normalized_box_np, scale_rotate_img
from cs_vit_tpu_torch.train import load_reference_state_dict
from cs_vit_tpu_torch.train.convert import (
    FlaxMapper,
    dino_state_dict_from_flax,
    dino_trans_state_dict_from_flax,
    tivit_state_dict_from_flax,
)
from cs_vit_tpu_torch.train.sparse_update import ColumnRandomUpdateAdamW, mask_columns_

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128)
DINO = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, mlp_ratio=4)
DEC = dict(hidden_size=64, decoder_hidden_size=32, decoder_num_hidden_layers=2,
           decoder_num_attention_heads=2, decoder_intermediate_size=64, patch_size=8)
TOL = dict(atol=2e-5, rtol=0)
LR = 1e-3


def _mapped(method, params, batch_stats=None, *args):
    """A flax module's parameters under the port's names (module at the root)."""
    m = FlaxMapper(params, batch_stats)
    getattr(m, method)((), "", *args)
    return m.out


def _load(module, sd):
    return load_reference_state_dict(module, sd)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_stats(variables, rng):
    stats = jax.tree.map(lambda v: jnp.asarray(
        rng.uniform(0.5, 1.5, size=np.shape(v)), jnp.float32), variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def _grad_tols(jax_grads, names, spread=None):
    """Each leaf's grad tolerance (module docstring); `spread` adds four
    times JAX's own one-ulp spread of that leaf."""
    gnorm = float(np.sqrt(sum(float(np.sum(np.square(jax_grads[n], dtype=np.float64)))
                              for n in names)))
    if spread:
        _assert_small_grad_spread(spread, jax_grads, names)
    return {n: 1e-4 * float(np.abs(jax_grads[n]).max()) + 1e-6 * gnorm
            + (4 * float(spread[n].max()) if spread else 0.0) for n in names}


def _assert_grads(port_grads, jax_grads, names, spread=None):
    for n, atol in _grad_tols(jax_grads, names, spread).items():
        np.testing.assert_allclose(_np(port_grads[n]), jax_grads[n], rtol=0, atol=atol,
                                   err_msg=n)


def _assert_adam_step(params, new_want, grads_want, names, spread=None):
    """A first AdamW step (eps 1e-8) from grads within their tolerance: the
    bound of the module docstring, element by element."""
    eps = 1e-8
    for n, atol in _grad_tols(grads_want, names, spread).items():
        g, want = np.abs(grads_want[n]), new_want[n]
        moved = LR * atol * eps / (np.maximum(g - atol, 0.0) + eps) ** 2
        allowed = np.minimum(moved, 2 * LR) + 1e-6 * np.abs(want) + 2e-5 * LR
        miss = np.abs(_np(params[n]) - want)
        assert (miss <= allowed).all(), (n, float(miss.max()), int((miss > allowed).sum()),
                                         atol, float(g.max()))


def _ulp(tree):
    """Every element moved up by one f32 ulp."""
    return jax.tree.map(lambda a: np.nextafter(np.asarray(a, np.float32), np.float32(np.inf)),
                        tree)


def _spread(a, b):
    """|a - b| leaf by leaf (two JAX results, numpy)."""
    return jax.tree.map(lambda x, y: np.abs(np.asarray(x, np.float64) - np.asarray(y)), a, b)


def _assert_small(spread, value, share, what):
    """JAX's own spread is under `share` of the value it guards, so that a
    tolerance built on it still tells a wrong value from a right one."""
    assert float(np.max(spread)) <= share * float(np.max(np.abs(value))), (
        what, float(np.max(spread)), float(np.max(np.abs(value))))


def _assert_witnessed(got, want, spread, what):
    _assert_small(spread, want, 1e-4, what)
    assert abs(float(got) - float(want)) <= 4 * float(spread) + 1e-5 * abs(float(want)), (
        what, float(got), float(want), float(spread))


def _assert_small_grad_spread(gspread, grads, names):
    """Each leaf's spread is under 2e-2 of its largest grad, save the leaves
    that the global-norm floor holds (module docstring)."""
    gnorm = float(np.sqrt(sum(float(np.sum(np.square(grads[n], dtype=np.float64)))
                              for n in names)))
    for n in names:
        if float(np.abs(grads[n]).max()) > 1e-6 * gnorm:
            _assert_small(gspread[n], grads[n], 2e-2, n)


@contextlib.contextmanager
def _recorded_draws():
    """Records the ``jax.random.normal`` and ``uniform`` draws made inside."""
    seen, normal, uniform = [], jax.random.normal, jax.random.uniform

    def rec(fn):
        def inner(*a, **k):
            out = fn(*a, **k)
            seen.append(np.asarray(out))
            return out
        return inner

    jax.random.normal, jax.random.uniform = rec(normal), rec(uniform)
    try:
        yield seen
    finally:
        jax.random.normal, jax.random.uniform = normal, uniform


def _split_draws(key, B):
    """The (normal, uniform) draws ``ti.py`` makes from `key`."""
    k1, k2 = jax.random.split(key)
    return _t(jax.random.normal(k1, (B,))), _t(jax.random.uniform(k2, (B,)))


# --- modules ----------------------------------------------------------------------------


@pytest.mark.parametrize("lora", [None, 2])
def test_vit_encoder_and_lora_merge_match_jax(rng, lora):
    x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JViTEncoder(JViTConfig(**VIT), lora_rank=lora)
    params = jm.init(jax.random.key(0), x)["params"]
    if lora:  # peft zero-initialises B: give the delta a value
        flat = tu.flatten_dict(params)
        for k in flat:
            if k[-1] == "lora_B":
                flat[k] = jnp.asarray(rng.normal(scale=0.1, size=flat[k].shape), jnp.float32)
        params = tu.unflatten_dict(flat)
    port = _load(ViTEncoder(ViTConfig(**VIT), lora_rank=lora), _mapped("vit", params, None, 2))
    with torch.no_grad():
        got = port(_t(x))
    want = np.asarray(jm.apply({"params": params}, x))
    if not lora:
        np.testing.assert_allclose(_np(got), want, **TOL)
    else:
        # the LoRA deltas (alpha / r = 16) widen the activations that the
        # final LayerNorm divides down, and with them the f32 sum-order
        # noise: hold the port to JAX's float64 result, within twice JAX's
        # own f32 miss of it
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
            want64 = np.asarray(jm.apply({"params": p64}, jnp.asarray(x, jnp.float64)))
        jax_miss = float(np.abs(want - want64).max())
        assert float(np.abs(_np(got) - want64).max()) <= 2 * jax_miss + TOL["atol"], jax_miss
    if lora:
        plain = ViTEncoder(ViTConfig(**VIT))
        plain.load_state_dict(merge_lora_params(port.state_dict()), strict=True)
        jmerged = j_merge_lora_params(params)
        want = np.asarray(JViTEncoder(JViTConfig(**VIT)).apply({"params": jmerged}, x))
        with torch.no_grad():
            merged = _np(plain(_t(x)))
        miss = float(np.abs(np.asarray(want) - want64).max())
        assert float(np.abs(merged - np.asarray(want)).max()) <= 2 * miss + jax_miss + TOL["atol"]
        assert float(np.abs(merged - _np(got)).max()) <= 2 * (miss + jax_miss) + TOL["atol"]


def test_mae_decoder_matches_jax(rng):
    tokens = rng.normal(size=(2, 17, 64)).astype(np.float32)
    jm = JViTMAEDecoderNoMask(JViTMAEDecoderConfig(**DEC), 16)
    params = jm.init(jax.random.key(0), tokens)["params"]
    port = _load(ViTMAEDecoderNoMask(ViTMAEDecoderConfig(**DEC), 16),
                 _mapped("mae_decoder", params, None, 2))
    with torch.no_grad():
        got = port(_t(tokens))
    assert got.shape == (2, 16, 8 * 8 * 3)
    np.testing.assert_allclose(_np(got), np.asarray(jm.apply({"params": params}, tokens)), **TOL)


@pytest.mark.parametrize("size", [32, 48, 24])
def test_dinov2_matches_jax(rng, size):
    """At the configured grid, and resized up (48: 6 x 6) and down (24:
    3 x 3, antialiased) as ``jax.image.resize`` does."""
    jm = JDinov2Backbone(JDinov2Config(**DINO))
    params = jm.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32))["params"]
    x = rng.uniform(size=(2, size, size, 3)).astype(np.float32)
    port = _load(Dinov2Backbone(Dinov2Config(**DINO)), _mapped("dinov2", params, None, 2))
    with torch.no_grad():
        got = port(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(jm.apply({"params": params}, x)), **TOL)


def test_lora_compatible_mha_matches_jax(rng):
    q, kv = rng.normal(size=(2, 3, 64)).astype(np.float32), rng.normal(size=(2, 5, 64)).astype(
        np.float32)
    jm = jmodules.LoraCompatibleMHA(64, 4)
    with pytest.warns(DeprecationWarning):
        params = jm.init(jax.random.key(0), q, kv, kv)["params"]
        want = jm.apply({"params": params}, q, kv, kv)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        port = LoraCompatibleMHA(64, 4)
    _load(port, _mapped("lora_mha", params))
    with torch.no_grad():
        got = port(_t(q), _t(kv), _t(kv))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("group", ["scale_rot", "image_latent", "dino_trans"])
def test_latent_groups_match_jax(rng, group, train):
    """Width 16, 2 heads: outputs to four times JAX's own one-ulp spread
    plus 1e-5 of the largest plus 1e-6 (module docstring), and the
    BatchNorm statistics each op leaves."""
    D, H = 16, 2
    x = rng.normal(size=(2, 16, D)).astype(np.float32)
    scale, angle = np.asarray([0.8, 1.2], np.float32), np.asarray([0.3, 4.0], np.float32)
    if group == "scale_rot":
        jm, port = jlatent.ScaleRotTransformationGroup(2, D, H), latent.ScaleRotTransformationGroup(
            2, D, H)
        args, margs = (x, scale, angle), ("scale_rot_group", 2)
    elif group == "image_latent":
        jm, port = jlatent.ImageLatentTransformerGroup(2, D, H), latent.ImageLatentTransformerGroup(
            2, D, H)
        args, margs = (x, angle), ("image_latent_group", 2)
    else:
        jm, port = jti.TIDinoTransGroup(D, H, 4), ti.TIDinoTransGroup(D, H, 4)
        args, margs = (x, scale, angle), ("latent_group", "trans_grp", 6)
    init_args = args + ("init",) if group == "image_latent" else args
    variables = _random_stats(jm.init(jax.random.key(0), *init_args), rng)
    m = FlaxMapper(variables["params"], variables["batch_stats"])
    if group == "dino_trans":
        m.latent_group(("trans_grp",), "trans_grp", 6)
    else:
        getattr(m, margs[0])((), "", margs[1])
    _load(port, m.out)
    ops = ("hf", "cr", "hr") if group == "image_latent" else (None,)
    for op in ops:
        jargs = args + (op,) if op else args
        want, mutated = jm.apply(variables, *jargs, train=train, mutable=["batch_stats"])
        moved, _ = jm.apply(_ulp(variables), _ulp(x), *jargs[1:], train=train,
                            mutable=["batch_stats"])
        spread = float(_spread(want, moved).max())
        _assert_small(spread, want, 1e-3, (group, op))
        before = {n: b.clone() for n, b in port.named_buffers()}
        with torch.no_grad():
            got = port(*[_t(a) for a in args], **({"op": op} if op else {}), train=train)
        want = np.asarray(want)
        assert float(np.abs(_np(got) - want).max()) <= (
            4 * spread + 1e-5 * float(np.abs(want).max()) + 1e-6), spread
        assert got.shape == x.shape
        sd = _mapped_stats(group, mutated["batch_stats"], variables["params"])
        for n, b in port.named_buffers():
            if n.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(_np(b), sd[n], atol=1e-5, rtol=1e-5, err_msg=n)
        with torch.no_grad():  # the next op starts from the same statistics
            for n, b in port.named_buffers():
                b.copy_(before[n])


def _mapped_stats(group, stats, params):
    m = FlaxMapper(params, stats)
    if group == "dino_trans":
        m.latent_group(("trans_grp",), "trans_grp", 6)
    elif group == "scale_rot":
        m.scale_rot_group((), "", 2)
    else:
        m.image_latent_group((), "", 2)
    return m.out


def test_compose_hf_cr_hr_matches_jax():
    for a in ("hf", "cr", "hr"):
        for b in ("hf", "cr", "hr"):
            for angles in ((0.5, 0.25), (None, 0.25), (0.5, None), (None, None)):
                assert latent.compose_hf_cr_hr(a, angles[0], b, angles[1]) == \
                    jlatent.compose_hf_cr_hr(a, angles[0], b, angles[1]), (a, b, angles)


def test_scale_rotate_img_matches_jax(rng):
    images = rng.uniform(size=(3, 20, 24, 3)).astype(np.float32)
    scale = np.asarray([0.8, 1.3, 1.0], np.float32)
    degrees = np.asarray([30.0, -100.0, 400.0], np.float32)
    want = j_scale_rotate_img(jnp.asarray(images), jnp.asarray(scale), jnp.asarray(degrees))
    got = scale_rotate_img(_t(images), _t(scale), _t(degrees))
    assert got.shape == images.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)


def test_crop_with_normalized_box_matches_jax(rng):
    image = rng.uniform(size=(40, 60, 3)).astype(np.float32)
    for box in ([0.1, 0.2, 0.5, 0.9], [0.3, 0.3, 0.9, 0.5], [-0.2, 0.4, 0.4, 1.2]):
        np.testing.assert_array_equal(crop_with_normalized_box_np(image, box, (16, 12)),
                                      j_crop_normalized(image, box, (16, 12)))


@pytest.mark.parametrize("value", [0.01, 100.0, 4.0])
def test_support_loss_matches_jax(value):
    """Both branches (mean norm under and over the support) and the edge."""
    delta = np.full((4, 8), value / np.sqrt(8), np.float32)
    want, jgrad = jax.value_and_grad(lambda d: jti.support_loss(d, 4.0))(jnp.asarray(delta))
    d = _t(delta).requires_grad_(True)
    got = ti.support_loss(d, 4.0)
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-9)
    np.testing.assert_allclose(_np(d.grad), np.asarray(jgrad), rtol=1e-5, atol=1e-9)


# --- losses and steps --------------------------------------------------------------------


def _named_grads(module):
    return {n: p.grad for n, p in module.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module")
def tivit_jax():
    """JAX TIViT (decoder, TI loss): the losses, grads and statistics of one
    training forward, and the draws it made."""
    rng = np.random.default_rng(4)
    imgs = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jti.TIViT(JViTConfig(**VIT), decoder_config=JViTMAEDecoderConfig(**DEC), ti_loss=True)
    variables = jm.init({"params": jax.random.key(0), "latent": jax.random.key(1)}, imgs)
    variables = _random_stats(variables, rng)

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, imgs,
                            train=True, rngs={"latent": jax.random.key(2)},
                            mutable=["batch_stats"])
        return out["loss"], (out["logs"]["scalar"], mut["batch_stats"])

    with _recorded_draws() as draws:
        (loss, (logs, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
    assert len(draws) == 2
    return dict(imgs=imgs, variables=variables, loss=float(loss), draws=draws,
                logs={k: float(v) for k, v in logs.items()}, grads=grads, stats=stats)


def test_tivit_losses_and_grads_match_jax(tivit_jax):
    js = tivit_jax
    v = js["variables"]
    model = _load(ti.TIViT(ViTConfig(**VIT), ViTMAEDecoderConfig(**DEC)),
                  tivit_state_dict_from_flax(v["params"], v["batch_stats"]))
    out = model(_t(js["imgs"]), train=True, draws=tuple(_t(d) for d in js["draws"]))
    out["loss"].backward()
    assert float(out["loss"]) == pytest.approx(js["loss"], rel=1e-5)
    for k, want in js["logs"].items():
        assert float(out["logs"]["scalar"][k]) == pytest.approx(want, rel=1e-5, abs=1e-7), k
    assert float(out["logs"]["scalar"]["recons"]) > 0 and out["recons"].shape == (2, 16, 192)
    jgrads = tivit_state_dict_from_flax(js["grads"], v["batch_stats"])
    names = [n for n, _ in model.named_parameters()]
    assert set(_named_grads(model)) == set(names)
    _assert_grads(_named_grads(model), jgrads, names)
    sd = tivit_state_dict_from_flax(v["params"], js["stats"])
    for n, b in model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(_np(b), sd[n], atol=1e-5, rtol=1e-5, err_msg=n)


@pytest.fixture(scope="module")
def dino_jax():
    rng = np.random.default_rng(5)
    imgs = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    student = jti.TIDinoViT(JDinov2Config(**DINO))
    svars = student.init(jax.random.key(0), imgs)
    teacher = jax.tree.map(lambda p: p + jnp.asarray(
        rng.normal(scale=0.02, size=p.shape), jnp.float32), svars["params"])
    trans = jti.TIDinoTransGroup(embed_dim=64, num_heads=4, num_p=4)
    patches = student.apply(svars, imgs)
    tvars = _random_stats(trans.init(jax.random.key(1), patches, jnp.ones(2), jnp.zeros(2)),
                          rng)
    center = jnp.asarray(rng.normal(scale=0.1, size=(16, 64)), jnp.float32)
    return dict(imgs=imgs, student=student, trans=trans, svars=svars, teacher=teacher,
                tvars=tvars, center=center)


def _dino_port(js):
    student = _load(ti.TIDinoViT(Dinov2Config(**DINO)), dino_state_dict_from_flax(
        js["svars"]["params"]))
    teacher = _load(ti.TIDinoViT(Dinov2Config(**DINO)), dino_state_dict_from_flax(js["teacher"]))
    trans = _load(ti.TIDinoTransGroup(64, 4, 4), dino_trans_state_dict_from_flax(
        js["tvars"]["params"], js["tvars"]["batch_stats"]))
    return student, teacher, trans


def test_dino_forward_and_update_teacher_match_jax(dino_jax):
    js = dino_jax
    key = jax.random.key(3)

    def loss_fn(p):
        loss, logs, center = jti.dino_forward(js["student"], js["trans"], {"params": p},
                                              js["teacher"], js["tvars"], js["center"],
                                              js["imgs"], key)
        return loss, (logs, center)

    (loss, (logs, center)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        js["svars"]["params"])
    # JAX's own spread of the TI terms (through the latent group at width 64)
    _, moved, _ = jti.dino_forward(js["student"], js["trans"], js["svars"], js["teacher"],
                                   _ulp(js["tvars"]), js["center"], _ulp(js["imgs"]), key)
    spread = _spread(logs, moved)
    student, teacher, trans = _dino_port(js)
    got, glogs, gcenter = ti.dino_forward(student, teacher, trans, _t(js["center"]),
                                          _t(js["imgs"]), _split_draws(key, 2))
    got.backward()
    assert float(glogs["dino"]) == pytest.approx(float(logs["dino"]), rel=1e-5)
    for k in ("ti", "total"):
        _assert_witnessed(glogs[k], logs[k], spread[k], k)
    _assert_witnessed(got, loss, spread["total"], "loss")
    np.testing.assert_allclose(_np(gcenter), np.asarray(center), **TOL)
    assert not np.allclose(_np(gcenter), np.asarray(js["center"]))
    jgrads = dino_state_dict_from_flax(grads)
    names = [n for n, _ in student.named_parameters()]
    _assert_grads(_named_grads(student), jgrads, names)
    # the TI term carries no gradient: only the student records a graph
    assert all(p.grad is None for p in list(teacher.parameters()) + list(trans.parameters()))

    new_teacher = jti.update_teacher(js["teacher"], js["svars"]["params"], 0.9)
    ti.update_teacher(teacher, student, 0.9)
    want = dino_state_dict_from_flax(new_teacher)
    for n, p in teacher.named_parameters():
        np.testing.assert_allclose(_np(p), want[n], rtol=1e-6, atol=1e-7, err_msg=n)


def test_ti_forward_matches_jax(dino_jax):
    js = dino_jax
    key = jax.random.key(4)

    def loss_fn(tp):
        return jti.ti_forward(js["student"], js["trans"], js["teacher"],
                              {**js["tvars"], "params": tp}, js["imgs"], key)

    (loss, logs), grads = jax.value_and_grad(loss_fn, has_aux=True)(js["tvars"]["params"])
    spread, gspread = _ti_spread(js, key, loss, grads)
    _, teacher, trans = _dino_port(js)
    stats = {n: b.clone() for n, b in trans.named_buffers()}
    got, glogs = ti.ti_forward(teacher, trans, _t(js["imgs"]), _split_draws(key, 2))
    got.backward()
    _assert_witnessed(got, loss, spread, "loss")
    assert float(glogs["ti"]) == float(got)
    jgrads = dino_trans_state_dict_from_flax(grads, js["tvars"]["batch_stats"])
    names = [n for n, _ in trans.named_parameters()]
    _assert_grads(_named_grads(trans), jgrads, names, gspread)
    for n, b in trans.named_buffers():  # JAX drops the statistics' update
        assert torch.equal(b, stats[n]), n
    assert all(p.grad is None for p in teacher.parameters())


def _ti_spread(js, key, loss, grads):
    """JAX's own one-ulp spread of ``ti_forward``'s loss and trans grads."""
    def loss_fn(tp):
        return jti.ti_forward(js["student"], js["trans"], js["teacher"],
                              {**js["tvars"], "params": tp}, _ulp(js["imgs"]), key)[0]

    moved, mgrads = jax.value_and_grad(loss_fn)(_ulp(js["tvars"]["params"]))
    stats = js["tvars"]["batch_stats"]
    g = dino_trans_state_dict_from_flax(grads, stats)
    gm = dino_trans_state_dict_from_flax(mgrads, stats)
    return abs(float(moved) - float(loss)), {n: np.abs(g[n] - gm[n]) for n in g}


class _Args:
    def __init__(self, mode, **kw):
        self.__dict__.update(mode=mode, img_size=32, patch_size=8, hidden_size=64, num_layers=2,
                             num_heads=4, lr=LR, lora_rank=0, teacher_momentum=0.996)
        self.__dict__.update(kw)


def _cli_port_run(mode, jparams, **kw):
    """The port CLI's setup for `mode`, its weights replaced by the JAX ones."""
    args = _Args(mode, **kw)
    if mode == "tivit":
        run = pretrain_ti.tivit_setup(args, torch.device("cpu"))
        _load(run["model"], tivit_state_dict_from_flax(*jparams))
        return args, run
    run = pretrain_ti.dino_setup(args, torch.device("cpu"))
    svars, teacher, tvars = jparams
    _load(run["student"], dino_state_dict_from_flax(svars["params"]))
    _load(run["teacher"], dino_state_dict_from_flax(teacher))
    _load(run["trans"], dino_trans_state_dict_from_flax(tvars["params"], tvars["batch_stats"]))
    return args, run


def test_tivit_cli_step_matches_jax(tivit_jax):
    """One step of ``cli.pretrain_ti --mode tivit`` (no decoder, optax
    ``adamw``) from the same weights and draws."""
    js = tivit_jax
    jm = jti.TIViT(JViTConfig(**{**VIT, "intermediate_size": 4 * VIT["hidden_size"]}),
                   decoder_config=None, ti_loss=True)
    variables = jm.init({"params": jax.random.key(0), "latent": jax.random.key(1)}, js["imgs"])
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.adamw(LR)

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, js["imgs"], train=True,
                            rngs={"latent": jax.random.key(9)}, mutable=["batch_stats"])
        return out["loss"], mut["batch_stats"]

    with _recorded_draws() as draws:
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    _, run = _cli_port_run("tivit", (params, stats))
    step = pretrain_ti.make_tivit_step(run)
    got, _ = step(_t(js["imgs"]), tuple(_t(d) for d in draws))
    assert float(got) == pytest.approx(float(loss), rel=1e-5)
    model = run["model"]
    names = [n for n, _ in model.named_parameters()]
    _assert_adam_step(dict(model.named_parameters()),
                      tivit_state_dict_from_flax(new_params, new_stats),
                      tivit_state_dict_from_flax(grads, stats), names)


@pytest.mark.parametrize("mode", ["dino", "ti"])
def test_dino_cli_steps_match_jax(dino_jax, mode):
    """One step of ``cli.pretrain_ti --mode dino`` (APLA mask, EMA teacher,
    centre) and ``--mode ti`` (the group alone): the loss and the
    parameters after the step, and only the masked parameters move."""
    js = dino_jax
    key = jax.random.key(13)
    args, run = _cli_port_run(mode, (js["svars"], js["teacher"], js["tvars"]))
    run["center"] = _t(js["center"])
    start = {k: {n: p.detach().clone() for n, p in run[k].named_parameters()}
             for k in ("student", "teacher", "trans")}
    if mode == "dino":
        sparams = js["svars"]["params"]
        mask = jti.dino_stage_mask(sparams)
        labels = jax.tree.map(lambda m: "t" if m else "f", mask)
        tx = optax.multi_transform({"t": optax.adamw(LR), "f": optax.set_to_zero()}, labels)

        def loss_fn(p):
            loss, _, c = jti.dino_forward(js["student"], js["trans"], {"params": p},
                                          js["teacher"], js["tvars"], js["center"],
                                          js["imgs"], key)
            return loss, c

        (loss, center), grads = jax.value_and_grad(loss_fn, has_aux=True)(sparams)
        moved, _, _ = jti.dino_forward(js["student"], js["trans"], js["svars"], js["teacher"],
                                       _ulp(js["tvars"]), js["center"], _ulp(js["imgs"]), key)
        spread = abs(float(moved) - float(loss))
        updates, _ = tx.update(grads, tx.init(sparams), sparams)
        new_student = optax.apply_updates(sparams, updates)
        new_teacher = jti.update_teacher(js["teacher"], new_student, args.teacher_momentum)
        step = pretrain_ti.make_dino_step(run, args.teacher_momentum)
        got, _ = step(_t(js["imgs"]), _split_draws(key, 2))
        np.testing.assert_allclose(_np(run["center"]), np.asarray(center), **TOL)
        moved = {n for n, p in run["student"].named_parameters()
                 if not torch.equal(p, start["student"][n])}
        assert moved and all(ti.dino_stage_mask(n) for n in moved)
        assert all(torch.equal(p, start["trans"][n]) for n, p in run["trans"].named_parameters())
        _assert_adam_step(dict(run["student"].named_parameters()),
                          dino_state_dict_from_flax(new_student), dino_state_dict_from_flax(grads),
                          sorted(moved))
        want = dino_state_dict_from_flax(new_teacher)
        for n, p in run["teacher"].named_parameters():
            np.testing.assert_allclose(_np(p), want[n], rtol=1e-6, atol=2 * LR * 1e-2,
                                       err_msg=n)
        _assert_witnessed(got, loss, spread, "loss")
        return
    else:
        tparams = js["tvars"]["params"]
        tx = optax.adamw(LR)

        def loss_fn(tp):
            return jti.ti_forward(js["student"], js["trans"], js["teacher"],
                                  {**js["tvars"], "params": tp}, js["imgs"], key)[0]

        loss, grads = jax.value_and_grad(loss_fn)(tparams)
        spread, gspread = _ti_spread(js, key, loss, grads)
        updates, _ = tx.update(grads, tx.init(tparams), tparams)
        new_trans = optax.apply_updates(tparams, updates)
        step = pretrain_ti.make_ti_step(run)
        got, _ = step(_t(js["imgs"]), _split_draws(key, 2))
        for k in ("student", "teacher"):
            assert all(torch.equal(p, start[k][n]) for n, p in run[k].named_parameters()), k
        stats = js["tvars"]["batch_stats"]
        _assert_adam_step(dict(run["trans"].named_parameters()),
                          dino_trans_state_dict_from_flax(new_trans, stats),
                          dino_trans_state_dict_from_flax(grads, stats),
                          [n for n, _ in run["trans"].named_parameters()], gspread)
        _assert_witnessed(got, loss, spread, "loss")
        return
    assert float(got) == pytest.approx(float(loss), rel=1e-5)


def test_sparse_update_masks_the_columns_jax_masks(rng):
    """For the same column draw (JAX's counter-keyed permutation handed in),
    the port masks the same columns of an array; the optimizer updates only
    its drawn columns of a 2-D weight. On a flax ``Dense`` and the torch
    ``Linear`` converted from it, the port masks the input features, as the
    reference does, where the JAX code masks the kernel's axis 1, its output
    features (``train/sparse_update.py``'s docstring)."""
    tree = {"a": rng.normal(size=(4, 6)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "c": rng.normal(size=(3, 8)).astype(np.float32)}
    tx = j_mask_random_columns(3, seed=5)
    state = tx.init(tree)
    for count in range(2):
        masked, state = tx.update({k: jnp.asarray(v) for k, v in tree.items()}, state)
        for i, name in enumerate(sorted(tree)):
            g = torch.from_numpy(tree[name].copy())
            if g.dim() == 2:
                key = jax.random.fold_in(jax.random.key(5), count * 131071 + i)
                chosen = np.asarray(jax.random.permutation(key, g.shape[1]))[:3]
                mask_columns_(g, torch.from_numpy(chosen))
            np.testing.assert_array_equal(_np(g), np.asarray(masked[name]), err_msg=name)

    # a converted pair: flax kernel [in 6, out 4], torch weight [out 4, in 6]
    x = rng.normal(size=(3, 6)).astype(np.float32)
    dense = flax_nn.Dense(4)
    dparams = dense.init(jax.random.key(0), x)["params"]
    kgrad = np.asarray(jax.grad(lambda p: jnp.sum(dense.apply({"params": p}, x) ** 2))(
        dparams)["kernel"])
    lin = torch.nn.Linear(6, 4)
    with torch.no_grad():
        lin.weight.copy_(_t(np.asarray(dparams["kernel"]).T))
        lin.bias.copy_(_t(dparams["bias"]))
    lin(_t(x)).pow(2).sum().backward()
    np.testing.assert_allclose(_np(lin.weight.grad), kgrad.T, rtol=1e-5, atol=1e-6)
    jmasked = np.asarray(j_mask_random_columns(3, seed=5).update(
        {"kernel": jnp.asarray(kgrad)}, {"count": jnp.zeros((), jnp.int32)})[0]["kernel"])
    kept_out = np.flatnonzero(np.abs(jmasked).sum(0))  # JAX keeps output features
    assert len(kept_out) == 3 and np.abs(jmasked).sum(1).all()
    chosen = np.asarray(jax.random.permutation(jax.random.fold_in(jax.random.key(5), 0), 6))[:3]
    mask_columns_(lin.weight.grad, torch.from_numpy(chosen))
    kept_in = np.flatnonzero(np.abs(_np(lin.weight.grad)).sum(0))  # the port keeps inputs
    np.testing.assert_array_equal(kept_in, np.sort(chosen))
    np.testing.assert_allclose(_np(lin.weight.grad), (kgrad * np.isin(np.arange(6), chosen)[
        :, None]).T, rtol=1e-5, atol=1e-6)

    lin = torch.nn.Linear(6, 4)
    w0 = lin.weight.detach().clone()
    opt = ColumnRandomUpdateAdamW(lin.parameters(), lr=0.1, num_columns_to_update=2,
                                  generator=torch.Generator().manual_seed(0), weight_decay=0.0)
    lin(torch.randn(3, 6)).sum().backward()
    opt.step()
    changed = (lin.weight.detach() != w0).any(0)
    assert int(changed.sum()) == 2


# --- transformers -------------------------------------------------------------------------


transformers = pytest.importorskip("transformers")


def test_vit_encoder_loads_and_matches_hf(rng):
    hf_cfg = transformers.ViTConfig(**VIT, hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.ViTModel(hf_cfg, add_pooling_layer=False).eval()
    port = ViTEncoder(ViTConfig(**VIT))
    port.load_state_dict(convert_hf_vit_state_dict(hf.state_dict(), port.config), strict=True)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = hf(_t(x).permute(0, 3, 1, 2)).last_hidden_state
        np.testing.assert_allclose(_np(port(_t(x))), _np(want), **TOL)


def test_mae_decoder_loads_and_matches_hf(rng):
    from transformers.models.vit_mae.modeling_vit_mae import ViTMAEDecoder

    hf_cfg = transformers.ViTMAEConfig(
        image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, decoder_hidden_size=32, decoder_num_hidden_layers=2,
        decoder_num_attention_heads=2, decoder_intermediate_size=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    hf_cfg._attn_implementation = "eager"  # a bare submodule needs this resolved
    torch.manual_seed(1)
    hf_dec = ViTMAEDecoder(hf_cfg, num_patches=16).eval()
    cfg = ViTMAEDecoderConfig(**DEC)
    port = ViTMAEDecoderNoMask(cfg, 16)
    port.load_state_dict(convert_hf_mae_decoder_state_dict(hf_dec.state_dict(), cfg, 16),
                         strict=True)
    tokens = rng.normal(size=(2, 17, 64)).astype(np.float32)
    with torch.no_grad():
        want = hf_dec(_t(tokens), torch.arange(16)[None].repeat(2, 1)).logits
        np.testing.assert_allclose(_np(port(_t(tokens))), _np(want), **TOL)


def test_dinov2_loads_and_matches_hf(rng):
    hf_cfg = transformers.Dinov2Config(**DINO, hidden_dropout_prob=0.0,
                                       attention_probs_dropout_prob=0.0, drop_path_rate=0.0)
    torch.manual_seed(2)
    hf = transformers.Dinov2Model(hf_cfg).eval()
    port = Dinov2Backbone(Dinov2Config(**DINO))
    port.load_state_dict(convert_hf_dinov2_state_dict(hf.state_dict(), port.config), strict=True)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = hf(_t(x).permute(0, 3, 1, 2)).last_hidden_state[:, 1:]
        np.testing.assert_allclose(_np(port(_t(x))), _np(want), **TOL)
