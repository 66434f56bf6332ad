"""TI pretraining in a world of two processes: each mode's step of
``cli.pretrain_ti`` on two gloo ranks, each on half of a b4 batch, against
the port's one-process step on the whole batch and against JAX's step on a
2-device data mesh (the JAX CLI's one ``jax.jit`` program, its images
sharded over the mesh, which computes the global batch's function).

The workers (``tests/torch_pretrain_worker.py``) start once for the module.
Sizes: ViT / DINOv2 of 2 layers at width 16 (2 heads), images 32 x 32,
patch 8, the latent groups at the same width (where
``tests/test_torch_latent.py`` holds them to 1e-5). The draws of the whole
batch are pinned on both sides: JAX's ``jax.random.normal`` / ``uniform``
of shape (4,) return them, and each rank's step takes its rows.

Tolerances: the one-process step is the same arithmetic but for the
reduction order of the BatchNorm statistics (f64 sums across the ranks), of
the losses' means (a mean of two halves' means) and of the grads (a mean of
two halves' grads): losses and logs rtol 1e-5, the centre 2e-5, BatchNorm
statistics 1e-5, and grads 1e-4 of each leaf's largest magnitude plus 1e-6
of the global norm; against JAX the bounds of ``tests/test_torch_ti.py``
(the same grad bound; a first AdamW step element by element to the bound
that grad tolerance gives; in the TI stage, whose loss and grads pass
through the latent group with grads, four times JAX's own spread is added,
as there: the largest change under three one-ulp moves of the group's
parameters and the images, up together and each down alone). The two ranks agree bit for bit on every
parameter, statistic and the centre after the step.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cs_vit_tpu.models import ti as jti
from cs_vit_tpu.models.dinov2 import Dinov2Config as JDinov2Config
from cs_vit_tpu.models.vit import ViTConfig as JViTConfig
from cs_vit_tpu.parallel import make_mesh, replicate_state, shard_batch
from cs_vit_tpu_torch.data.fixtures import make_synthetic_image_folder
from cs_vit_tpu_torch.train.convert import (
    dino_state_dict_from_flax,
    dino_trans_state_dict_from_flax,
    tivit_state_dict_from_flax,
)

from .test_torch_ti import (
    _assert_adam_step,
    _assert_grads,
    _assert_witnessed,
    _random_stats,
    _ulp,
)
from .torch_pretrain_worker import build_run, snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, B, W = 1e-3, 4, 16
MODES = ("tivit", "dino", "ti")


def _pinned(normal, uniform):
    """jax.random.normal / uniform of shape (B,) return the given draws."""
    j_normal, j_uniform = jax.random.normal, jax.random.uniform

    def fake(real, value):
        def inner(key, shape=(), dtype=jnp.float32, *a, **kw):
            if tuple(shape) != (B,):
                return real(key, shape, dtype, *a, **kw)
            return jnp.asarray(value, dtype)
        return inner

    class _Ctx:
        def __enter__(self):
            jax.random.normal, jax.random.uniform = fake(j_normal, normal), fake(j_uniform,
                                                                                uniform)

        def __exit__(self, *exc):
            jax.random.normal, jax.random.uniform = j_normal, j_uniform

    return _Ctx()


def _ulp_down(tree):
    """Every element moved down by one f32 ulp."""
    return jax.tree.map(lambda a: np.nextafter(np.asarray(a, np.float32), np.float32(-np.inf)),
                        tree)


def _sd(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _jax_tivit(images, draws, rng, mesh):
    cfg = JViTConfig(image_size=32, patch_size=8, hidden_size=W, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=4 * W)
    jm = jti.TIViT(cfg, decoder_config=None, ti_loss=True)
    variables = _random_stats(jax.jit(jm.init)(
        {"params": jax.random.key(0), "latent": jax.random.key(1)}, images[:1]), rng)
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.adamw(LR)

    @jax.jit
    def step(params, stats, opt_state, x):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                                rngs={"latent": jax.random.key(7)}, mutable=["batch_stats"])
            return out["loss"], (out["logs"]["scalar"], mut["batch_stats"])

        (loss, (logs, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, loss, logs, grads

    p, s, o = (replicate_state(t, mesh) for t in (params, stats, tx.init(params)))
    with _pinned(*draws):
        new_params, new_stats, loss, logs, grads = step(
            p, s, o, shard_batch({"x": images}, mesh)["x"])
    sd = lambda t, st: tivit_state_dict_from_flax(jax.device_get(t), jax.device_get(st))  # noqa
    return ({"model": _sd(sd(params, stats))},
            {"loss": float(loss), "logs": {k: float(v) for k, v in logs.items()},
             "model": {"params": sd(new_params, new_stats), "grads": sd(grads, stats),
                       "stats": sd(params, new_stats)}})


def _jax_dino(images, draws, rng, mesh, mode):
    cfg = JDinov2Config(image_size=32, patch_size=8, hidden_size=W, num_hidden_layers=2,
                        num_attention_heads=2)
    student = jti.TIDinoViT(cfg)
    svars = student.init(jax.random.key(0), images[:1])
    teacher = jax.tree.map(lambda p: p + jnp.asarray(rng.normal(scale=0.02, size=p.shape),
                                                     jnp.float32), svars["params"])
    trans = jti.TIDinoTransGroup(embed_dim=W, num_heads=2, num_p=4)
    tvars = _random_stats(jax.jit(trans.init)(
        jax.random.key(1), student.apply(svars, images[:1]), jnp.ones(1), jnp.zeros(1)), rng)
    center = jnp.asarray(rng.normal(scale=0.1, size=(16, W)), jnp.float32)
    key = jax.random.key(11)
    x = shard_batch({"x": images}, mesh)["x"]
    weights = {"student": _sd(dino_state_dict_from_flax(svars["params"])),
               "teacher": _sd(dino_state_dict_from_flax(teacher)),
               "trans": _sd(dino_trans_state_dict_from_flax(tvars["params"],
                                                            tvars["batch_stats"])),
               "center": torch.from_numpy(np.array(center))}
    if mode == "dino":
        sparams = svars["params"]
        labels = jax.tree.map(lambda m: "t" if m else "f", jti.dino_stage_mask(sparams))
        tx = optax.multi_transform({"t": optax.adamw(LR), "f": optax.set_to_zero()}, labels)

        @jax.jit
        def step(sparams, tparams, opt_state, center, x):
            def loss_fn(p):
                loss, logs, new_center = jti.dino_forward(student, trans, {"params": p},
                                                          tparams, tvars, center, x, key)
                return loss, (logs, new_center)

            (loss, (logs, new_center)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                sparams)
            updates, _ = tx.update(grads, opt_state, sparams)
            return optax.apply_updates(sparams, updates), new_center, loss, logs, grads

        s, t, o, c = (replicate_state(v, mesh) for v in (sparams, teacher, tx.init(sparams),
                                                          center))
        with _pinned(*draws):
            new_s, new_center, loss, logs, grads = step(s, t, o, c, x)
        want = {"student": {"params": dino_state_dict_from_flax(jax.device_get(new_s)),
                            "grads": dino_state_dict_from_flax(jax.device_get(grads))},
                "center": np.asarray(new_center)}
    else:
        tparams = tvars["params"]
        tx = optax.adamw(LR)

        @jax.jit
        def step(trans_params, opt_state, x):
            def loss_fn(tp):
                return jti.ti_forward(student, trans, teacher, {**tvars, "params": tp}, x, key)

            (loss, logs), grads = jax.value_and_grad(loss_fn, has_aux=True)(trans_params)
            updates, _ = tx.update(grads, opt_state, trans_params)
            return optax.apply_updates(trans_params, updates), loss, logs, grads

        t, o = (replicate_state(v, mesh) for v in (tparams, tx.init(tparams)))
        with _pinned(*draws):
            new_t, loss, logs, grads = step(t, o, x)
            # JAX's own spread: the group's parameters and the images moved by
            # one ulp, up together, and each down alone
            moves = [step(replicate_state(tp, mesh), o, shard_batch({"x": im}, mesh)["x"])
                     for tp, im in ((_ulp(tparams), _ulp(images)), (_ulp_down(tparams), images),
                                    (tparams, _ulp_down(images)))]
        st = tvars["batch_stats"]
        g = dino_trans_state_dict_from_flax(jax.device_get(grads), st)
        gspread = {n: np.zeros(np.shape(v)) for n, v in g.items()}
        for _, _, _, mg in moves:
            gm = dino_trans_state_dict_from_flax(jax.device_get(mg), st)
            for n in g:
                gspread[n] = np.maximum(gspread[n], np.abs(np.asarray(g[n], np.float64) - gm[n]))
        want = {"trans": {
            "params": dino_trans_state_dict_from_flax(jax.device_get(new_t), st), "grads": g,
            "spread": gspread}, "spread": max(abs(float(m[1]) - float(loss)) for m in moves)}
    want.update(loss=float(loss), logs={k: float(v) for k, v in logs.items()})
    return weights, want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's 2-device steps, the port's one-process steps, and both ranks'
    results (run once)."""
    rng = np.random.default_rng(21)
    images = rng.uniform(size=(B, 32, 32, 3)).astype(np.float32)
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    weights, want, draws = {}, {}, {}
    for mode in MODES:
        draws[mode] = (rng.normal(size=B).astype(np.float32),
                       rng.uniform(size=B).astype(np.float32))
        if mode == "tivit":
            weights[mode], want[mode] = _jax_tivit(images, draws[mode], rng, mesh)
        else:
            weights[mode], want[mode] = _jax_dino(images, draws[mode], rng, mesh, mode)
    tdraws = {m: tuple(torch.from_numpy(d) for d in v) for m, v in draws.items()}
    one = {}
    for mode in MODES:
        run, step = build_run(mode, weights[mode])
        loss, logs = step(torch.from_numpy(images), tdraws[mode])
        one[mode] = snapshot(mode, run, loss, logs)

    work = tmp_path_factory.mktemp("pretrain_world")
    root = make_synthetic_image_folder(str(work / "imgs"), n=8)
    torch.save({"weights": weights, "images": torch.from_numpy(images), "draws": tdraws,
                "root": root}, work / "payload.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    worker = os.path.join(REPO, "tests", "torch_pretrain_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), port, str(work)], env=env,
                              cwd=str(work), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
        assert out.strip().endswith("done"), out[-2000:]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(want=want, one=one, ranks=ranks, work=work, outs=outs)


def _modules(mode):
    """The modules whose parameters the mode trains."""
    return {"tivit": ("model",), "dino": ("student",), "ti": ("trans",)}[mode]


def _grad_close(got, want, names):
    gnorm = float(np.sqrt(sum(float(np.sum(np.square(np.asarray(want[n], np.float64))))
                              for n in names)))
    for n in names:
        w = np.asarray(want[n])
        atol = 1e-4 * float(np.abs(w).max()) + 1e-6 * gnorm
        np.testing.assert_allclose(got[n].numpy(), w, rtol=0, atol=atol, err_msg=n)


@pytest.mark.parametrize("mode", MODES)
def test_ranks_agree_bit_for_bit(world, mode):
    r0, r1 = (r[mode] for r in world["ranks"])
    assert torch.equal(r0["loss"], r1["loss"])
    for key in ("model", "student", "teacher", "trans"):
        if key not in r0:
            continue
        for part in ("params", "grads", "stats"):
            assert r0[key][part].keys() == r1[key][part].keys()
            for n, v in r0[key][part].items():
                assert torch.equal(v, r1[key][part][n]), (key, part, n)
    if mode != "tivit":
        assert torch.equal(r0["center"], r1["center"])


@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_equal_the_one_process_step(world, mode):
    one, got = world["one"][mode], world["ranks"][0][mode]
    assert float(got["loss"]) == pytest.approx(float(one["loss"]), rel=1e-5)
    for k, v in one["logs"].items():
        assert float(got["logs"][k]) == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
    for key in _modules(mode):
        names = sorted(one[key]["grads"])
        assert names and names == sorted(got[key]["grads"])
        _grad_close(got[key]["grads"], one[key]["grads"], names)
        for n, b in one[key]["stats"].items():
            np.testing.assert_allclose(got[key]["stats"][n].numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=n)
    if mode == "tivit":
        assert one["model"]["stats"]  # the group's statistics moved in training
    if mode != "tivit":
        np.testing.assert_allclose(got["center"].numpy(), one["center"].numpy(), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_match_jax_two_device_step(world, mode):
    want, got = world["want"][mode], world["ranks"][1][mode]
    if "spread" in want:  # the TI stage: through the latent group with grads
        _assert_witnessed(got["loss"], want["loss"], want["spread"], "loss")
    else:
        assert float(got["loss"]) == pytest.approx(want["loss"], rel=1e-5)
        for k, v in want["logs"].items():
            assert float(got["logs"][k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for key in _modules(mode):
        grads = {n: np.asarray(v) for n, v in want[key]["grads"].items()}
        spread = want[key].get("spread")
        names = sorted(got[key]["grads"])
        assert names and set(names) <= set(grads)
        _assert_grads(got[key]["grads"], grads, names, spread)
        _assert_adam_step(got[key]["params"], want[key]["params"], grads, names, spread)
        if "stats" in want[key]:
            for n, b in got[key]["stats"].items():
                np.testing.assert_allclose(b.numpy(), want[key]["stats"][n], rtol=1e-5,
                                           atol=1e-5, err_msg=n)
    if "center" in want:
        np.testing.assert_allclose(got["center"].numpy(), want["center"], rtol=0, atol=2e-5)


def test_cli_trains_one_model_across_the_world(world):
    """``cli.pretrain_ti`` in the world: each rank reads its shard (8 images,
    2 a rank a step: 2 steps), both hold the same weights and statistics
    afterwards, and rank 0 alone wrote the checkpoint, which holds them."""
    r0, r1 = (r["cli"] for r in world["ranks"])
    assert len(r0["losses"]) == len(r1["losses"]) == 2
    assert r0["losses"] == r1["losses"] and np.isfinite(r0["losses"]).all()
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    ckpt = torch.load(world["work"] / "checkpoints" / "cli" / "checkpoint_1", weights_only=True)
    for k, v in ckpt["params"].items():
        assert torch.equal(v, r0["state"][k]), k
    assert "E1 it1" in world["outs"][0][0] and "E1 it1" not in world["outs"][1][0]
