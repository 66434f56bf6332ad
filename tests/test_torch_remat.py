"""Remat: ``PoserConfig.remat`` runs each backbone block under
``torch.utils.checkpoint``, as the JAX package wraps each in ``nn.remat``.

* ``PoserConfig`` takes every field of the JAX ``PoserConfig`` (read from
  the JAX dataclass, so that a field added there cannot slip by).
* On the CPU a remat step equals the plain step bit for bit, with droppath
  on and the same generator: the loss, the clipped grads, the parameters
  after AdamW, the BatchNorm statistics and the generator's state after the
  step. Each block runs its forward twice a step under remat (once more in
  the backward), on every implementation.
* Both steps hold against JAX's step with ``remat=True`` (droppath 0, whose
  draws the two packages make apart) at ``tests/test_torch_train.py``'s
  tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.models.poser import PoserConfig as JPoserConfig
from cs_vit_tpu.train import TrainState as JTrainState
from cs_vit_tpu.train import build_optimizer as j_build_optimizer
from cs_vit_tpu.train import make_train_step as j_make_train_step
from cs_vit_tpu_torch.models import PoserConfig, SwinV2Config, init_poser_weights
from cs_vit_tpu_torch.models.poser import phase_trainable_params
from cs_vit_tpu_torch.models.swinv2 import SwinV2Block
from cs_vit_tpu_torch.train import (
    TrainState,
    build_optimizer,
    load_reference_state_dict,
    make_train_step,
    state_dict_from_flax,
)

from .helpers import TINY_SWIN, tiny_batch, tiny_poser
from .test_torch_train import LR, _port_tiny, _ref_names, _torch_batch


def test_poser_config_takes_every_jax_field():
    """Fault B: the port's ``PoserConfig`` refused ``remat`` and
    ``expansion_ratio``."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JPoserConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(PoserConfig)}
    assert set(jax_fields) <= set(port_fields), set(jax_fields) - set(port_fields)
    cfg = PoserConfig(remat=True, expansion_ratio=1.25)
    assert cfg.remat and cfg.expansion_ratio == 1.25
    for name in ("remat", "expansion_ratio"):
        assert port_fields[name] == jax_fields[name], name
    for backbone in ("swinv2-base-256", "swinv2-tiny-256", "test"):
        assert PoserConfig(backbone=backbone, remat=True).swin_config().remat
        assert not PoserConfig(backbone=backbone).swin_config().remat


def _swin(drop_path_rate, remat):
    return SwinV2Config(**{f: getattr(TINY_SWIN, f) for f in (
        "image_size", "patch_size", "embed_dim", "depths", "num_heads", "window_size",
        "pretrained_window_sizes")}, drop_path_rate=drop_path_rate, remat=remat)


def _step(remat, impl, batch, drop_path_rate=0.3, seed=5):
    """One f32 spatial step from init_poser_weights(0); what it left."""
    model = _port_tiny(custom_swin=_swin(drop_path_rate, remat), attention_impl=impl)
    init_poser_weights(model, 0)
    state = TrainState.create(model, build_optimizer(model, "spatial", LR))
    step = make_train_step(model, state.optimizer, "spatial")
    gen = torch.Generator().manual_seed(seed)
    calls = []
    run = SwinV2Block._fused if impl == "fused" else SwinV2Block._eager

    def counted(self, *args):
        calls.append(self)
        return run(self, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SwinV2Block, run.__name__, counted)
        state, metrics = step(state, batch, gen)
    return dict(model=model, metrics=metrics, gen=gen.get_state(), calls=len(calls),
                grads={n: p.grad.clone() for n, p in phase_trainable_params(model, "spatial")})


@pytest.mark.parametrize("impl", ["eager", "fused", "pallas"])
def test_remat_step_equals_the_plain_step_bit_for_bit(impl):
    batch = _torch_batch(tiny_batch(np.random.default_rng(8), B=4, T=1))
    plain, remat = _step(False, impl, batch), _step(True, impl, batch)
    n_blocks = sum(TINY_SWIN.depths)
    assert plain["calls"] == n_blocks and remat["calls"] == 2 * n_blocks
    assert torch.equal(plain["gen"], remat["gen"])  # the generator advanced alike
    for k in ("loss", "grad_norm", "skipped"):
        assert torch.equal(plain["metrics"][k], remat["metrics"][k]), k
    assert float(plain["metrics"]["skipped"]) == 0.0
    for n, g in plain["grads"].items():
        assert torch.equal(g, remat["grads"][n]), n
    for (n, a), b in zip(plain["model"].state_dict().items(),
                         remat["model"].state_dict().values()):
        assert torch.equal(a, b), n
    # droppath was on: another generator seed gives other grads
    other = _step(False, impl, batch, seed=6)
    assert any(not torch.equal(g, other["grads"][n]) for n, g in plain["grads"].items())


@pytest.fixture(scope="module")
def jax_remat_step():
    """JAX's spatial step with remat=True (f32, droppath 0, lr 1e-3)."""
    rng = np.random.default_rng(3)
    jmodel = tiny_poser(custom_swin=dataclasses.replace(TINY_SWIN, remat=True))
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

    grads = jax.jit(jax.grad(loss))(variables["params"])
    tx = j_build_optimizer(variables["params"], "spatial", LR)
    new_state, metrics = j_make_train_step(jmodel, tx, "spatial", donate=False)(
        JTrainState.create(variables, tx), jbatch, key)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(batch=batch, variables=np_(variables), grads=np_(grads),
                new_params=np_(new_state.params), new_stats=np_(new_state.batch_stats),
                loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))


@pytest.mark.parametrize("remat", [True, False])
def test_step_matches_jax_remat_step(jax_remat_step, remat):
    js = jax_remat_step
    model = _port_tiny(custom_swin=_swin(0.0, remat))
    load_reference_state_dict(model, state_dict_from_flax(
        js["variables"]["params"], js["variables"]["batch_stats"], model.config))
    state = TrainState.create(model, build_optimizer(model, "spatial", LR))
    state, metrics = make_train_step(model, state.optimizer, "spatial")(
        state, _torch_batch(js["batch"]), None)
    assert float(metrics["loss"]) == pytest.approx(js["loss"], rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(js["grad_norm"], rel=5e-5)
    clip = min(1.0, 5.0 / js["grad_norm"])
    jgrads = _ref_names(js["grads"], js["variables"]["batch_stats"], model)
    jparams = _ref_names(js["new_params"], js["new_stats"], model)
    params = dict(model.named_parameters())
    for n, _ in phase_trainable_params(model, "spatial"):
        g_want = jgrads[n] * clip
        atol = 1e-4 * float(np.abs(g_want).max()) + 1e-6 * 5.0
        np.testing.assert_allclose(params[n].grad.numpy(), g_want, rtol=0, atol=atol, err_msg=n)
        p, want = params[n].detach().numpy(), jparams[n]
        sensitive = np.abs(g_want) < 10 * atol
        allowed = np.where(sensitive, 2 * LR, 1e-6 * np.abs(want) + 1e-3 * LR)
        assert (np.abs(p - want) <= allowed).all(), n
    sd = state_dict_from_flax(js["new_params"], js["new_stats"], model.config)
    for n, b in model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), sd[n], atol=1e-5, rtol=1e-5, err_msg=n)
