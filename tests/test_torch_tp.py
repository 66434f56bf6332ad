"""Tensor parallelism (``cs_vit_tpu_torch/parallel/tp.py``) against JAX's
(``cs_vit_tpu/parallel/tp.py``), on the CPU under gloo.

* The shard specs equal ``poser_param_specs``, name by name through the
  converter, on the tiny Poser with and without the latent group.
* Two ranks at ``tp=2`` against JAX's global step on ``make_mesh(n_data=1,
  n_model=2)``, and four ranks at 2 x 2 against ``make_mesh(2, 2)``, each
  data rank on its rows of the b4 batch: the latter pins the BatchNorms'
  statistics over the global batch. Tolerances are
  ``tests/test_torch_parallel.py``'s (its docstring): both sides compute
  the one-device step up to reduction order.
* The ``tp=2`` step against the port's one-process step with droppath (rate
  0.2) and the latent group, from the same generator seeds, to the same
  tolerances; the replicated tensors bit-identical across the model peers.
* ``cli.finetune --tp 2``: a checkpoint written without tensor parallelism
  resumes under it and the other way round; the resumed epoch under
  ``tp=2`` against the one without it from the same checkpoint (parameters
  within 2 lr a step of it, AdamW's largest move, where the sum order flips
  a small grad's sign). ``cli.evaluate --tp 2`` writes the rows that
  ``cli.evaluate`` writes without it: paths and ground truth exactly, the
  predictions within 1e-4 of their scale plus 1e-4 (the bound of
  ``tests/test_torch_cli.py``'s eval parity; the reprojections of a random
  Poser's joints near depth 0 amplify that miss without bound, so they are
  held through the joints), each row once in the 2 x 2 world too.

The workers (``tests/torch_tp_worker.py``) start once for the module, a
world of two and a world of four side by side, while JAX compiles.
"""

import os
import socket
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.parallel import make_mesh as j_make_mesh
from cs_vit_tpu.parallel import poser_param_specs, shard_batch, shard_state_tp
from cs_vit_tpu.train import TrainState as JTrainState
from cs_vit_tpu.train import build_optimizer as j_build_optimizer
from cs_vit_tpu.train import make_train_step as j_make_train_step
from cs_vit_tpu_torch.data.fixtures import make_synthetic_dexycb
from cs_vit_tpu_torch.mano import ManoLayer, sh_joint_regressor, synthetic_assets
from cs_vit_tpu_torch.models import Poser, PoserConfig, SwinV2Config, init_poser_weights
from cs_vit_tpu_torch.parallel import tp
from cs_vit_tpu_torch.train import state_dict_from_flax

from .helpers import TINY_SWIN, tiny_batch, tiny_poser
from .test_torch_parallel import _adam_moments, _filled, _np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
POSER = dict(backbone="custom", image_size=32, num_pose_query=16, num_spatial_layer=2,
             num_temporal_layer=1, attention_impl="eager")
SWIN = {f: getattr(TINY_SWIN, f) for f in (
    "image_size", "patch_size", "embed_dim", "depths", "num_heads", "window_size",
    "drop_path_rate", "pretrained_window_sizes")}
LATENT = dict(num_latent_layer=1, persp_decorate="patch")


def _port_config(swin=SWIN, **over):
    return PoserConfig(custom_swin=SwinV2Config(**swin), **{**POSER, **over})


def _port_poser(config):
    assets = synthetic_assets(seed=1)
    return Poser(config, ManoLayer(assets), sh_joint_regressor(assets))


@pytest.mark.parametrize("latent", [False, True])
def test_specs_are_poser_param_specs(latent):
    """Every parameter's split dimension (or none) is the one JAX's spec
    gives it: a marker array per flax leaf, varying along the sharded axis,
    goes through ``state_dict_from_flax``, and the axis it varies along in
    torch's layout is the port's."""
    over = LATENT if latent else {}
    jmodel = tiny_poser(**over)
    batch = {k: jnp.asarray(v) for k, v in tiny_batch(np.random.default_rng(0), B=1,
                                                      T=1).items()}
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "droppath": jax.random.key(1),
         "latent": jax.random.key(2)}, batch, phase="inference"))
    specs = poser_param_specs(shapes["params"], 2)

    def marker(leaf, spec):
        axes = [i for i, a in enumerate(tuple(spec)) if a is not None]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        idx = np.arange(leaf.shape[axes[0]], dtype=np.float32) + 1
        shape = [1] * len(leaf.shape)
        shape[axes[0]] = -1
        return np.broadcast_to(idx.reshape(shape), leaf.shape).copy()

    markers = jax.tree.map(marker, shapes["params"], specs)
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])
    config = _port_config(**over)
    sd = state_dict_from_flax(markers, stats, config)

    def varying(a):
        for ax in range(a.ndim):
            if a.shape[ax] > 1 and not (np.diff(a, axis=ax) == 0).all():
                return ax
        return None

    port = tp.param_specs(dict(_port_poser(config).named_parameters()), 2)
    want = {n: varying(sd[n]) for n in port}
    assert port == want
    n_sharded = sum(d is not None for d in port.values())
    assert n_sharded == sum(
        any(a is not None for a in s) for s in jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    if not latent:  # the count of the tiny Poser's leaves that JAX shards
        assert (n_sharded, len(port)) == (86, 177)
    names = {n.rpartition(".")[0] for n, d in port.items() if d is not None}
    for part in ("backbone.", "spatial_encoder.", "pose_temporal_encoder.", "perspective_mlp.")\
            + (("latent_trans.",) if latent else ()):
        assert any(n.startswith(part) for n in names), part


def test_shard_and_gather_state_dict_round_trip():
    model = _port_poser(_port_config(**LATENT))
    init_poser_weights(model, 3)
    full = {k: v.clone() for k, v in model.state_dict().items()}
    specs = tp.param_specs(full, 2)
    shards = [tp.shard_state_dict(full, r, 2) for r in range(2)]
    for k, v in full.items():
        d = specs[k]
        if d is None:
            assert all(torch.equal(s[k], v) for s in shards), k
        else:
            assert torch.equal(torch.cat([s[k] for s in shards], dim=d), v), k
            assert shards[0][k].shape[d] * 2 == v.shape[d]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers (worlds of two and four) and JAX's (1, 2) and (2, 2)
    global steps on the same weights and batch."""
    rng = np.random.default_rng(3)
    jmodel = tiny_poser()
    batch = tiny_batch(rng, B=4, T=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda b: jmodel.init(
        {"params": jax.random.key(0), "droppath": jax.random.key(1)}, b, phase="inference"))(
        jbatch)
    stats = jax.tree.map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, size=np.shape(v)), jnp.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    config = _port_config()
    tiny_sd = state_dict_from_flax(_np(variables["params"]), _np(stats), config)
    drop_swin = dict(SWIN, drop_path_rate=0.2)
    drop = _port_poser(_port_config(drop_swin, **LATENT))
    init_poser_weights(drop, 7)
    with torch.no_grad():  # BatchNorm statistics away from their start
        for n, b in drop.named_buffers():
            if n.endswith(("running_mean", "running_var")):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, size=b.shape).astype(np.float32)))
    work = tmp_path_factory.mktemp("tp")
    root = make_synthetic_dexycb(str(work / "dexycb"), seq_len=8)
    torch.save({"tiny": {"swin": SWIN, "poser": POSER, "state_dict": tiny_sd},
                "drop": {"swin": drop_swin, "poser": {**POSER, **LATENT},
                         "state_dict": {k: v.clone() for k, v in drop.state_dict().items()}},
                "batch": batch, "lr": LR, "dexycb_root": root}, work / "payload.pt")
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    worker = os.path.join(REPO, "tests", "torch_tp_worker.py")
    procs = {}
    for world in (2, 4):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        procs[world] = [subprocess.Popen([sys.executable, worker, str(r), str(world), port,
                                          str(work)], env=env, cwd=str(work),
                                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True) for r in range(world)]
    try:
        want = {shape: _jax_step(jmodel, variables, jbatch, *shape) for shape in ((1, 2), (2, 2))}
        outs = {w: [p.communicate(timeout=600) for p in ps] for w, ps in procs.items()}
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
    for w, ps in procs.items():
        for p, (out, err) in zip(ps, outs[w]):
            assert p.returncode == 0, err[-4000:]
            assert out.strip().endswith("done"), out[-2000:]
    ranks = {w: [torch.load(work / f"w{w}_rank{r}.pt", weights_only=False) for r in range(w)]
             for w in (2, 4)}
    return dict(want=want, ranks=ranks, work=work, config=config, stats=stats)


def _jax_step(jmodel, variables, jbatch, n_data, n_model):
    """JAX's tensor-parallel step: the global-jit step over a (data, model)
    mesh, the state sharded by ``shard_state_tp``, the batch over data."""
    tx = j_build_optimizer(variables["params"], "spatial", LR)
    mesh = j_make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:n_data * n_model])
    state = shard_state_tp(JTrainState.create(variables, tx), tx, mesh)
    new_state, metrics = j_make_train_step(jmodel, tx, "spatial", donate=False)(
        state, shard_batch(jbatch, mesh), jax.random.key(0))
    params = _np(variables["params"])
    mu, nu = _adam_moments(new_state.opt_state)
    return dict(new_params=_np(new_state.params), new_stats=_np(new_state.batch_stats),
                mu=_filled(_np(mu), params), nu=_filled(_np(nu), params),
                loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))


def _assert_step(got, want_loss, want_norm, mu, nu, new, stats):
    """``tests/test_torch_parallel.py``'s bounds for one step."""
    assert got["step"] == 1 and float(got["skipped"]) == 0.0
    assert float(got["loss"]) == pytest.approx(want_loss, rel=1e-5)
    assert float(got["grad_norm"]) == pytest.approx(want_norm, rel=5e-5)
    names = set(got["exp_avg"])
    assert names and names <= set(mu)
    for n in names:
        g_want = np.asarray(mu[n]) / 0.1
        atol = 1e-4 * float(np.abs(g_want).max()) + 1e-6 * 5.0
        np.testing.assert_allclose(got["exp_avg"][n].numpy(), mu[n], rtol=0, atol=0.1 * atol,
                                   err_msg=n)
        nu_tol = 1e-3 * (2 * float(np.abs(g_want).max()) * atol + atol ** 2)
        np.testing.assert_allclose(got["exp_avg_sq"][n].numpy(), nu[n], rtol=0, atol=nu_tol,
                                   err_msg=n)
        p, w = got["params"][n].numpy(), np.asarray(new[n])
        sensitive = np.abs(g_want) < 10 * atol
        allowed = np.where(sensitive, 2 * LR, 1e-6 * np.abs(w) + 1e-3 * LR)
        assert (np.abs(p - w) <= allowed).all(), n
    assert got["stats"]
    for n, b in got["stats"].items():
        np.testing.assert_allclose(b.numpy(), stats[n], atol=1e-5, rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2))])
def test_tp_step_matches_jax_mesh_step(run, world, shape):
    js, config = run["want"][shape], run["config"]

    def names(tree, st):
        return state_dict_from_flax(tree, st, config)

    stats = run["stats"]
    mu, nu = names(js["mu"], _np(stats)), names(js["nu"], _np(stats))
    new = names(js["new_params"], js["new_stats"])
    for rank in run["ranks"][world]:
        _assert_step(rank["jax"], js["loss"], js["grad_norm"], mu, nu, new, new)
    first = run["ranks"][world][0]["jax"]
    for rank in run["ranks"][world][1:]:  # every rank holds the same whole step
        for key in ("params", "stats", "exp_avg", "exp_avg_sq"):
            for n, v in first[key].items():
                assert torch.equal(v, rank["jax"][key][n]), (key, n)


def test_tp_step_with_droppath_and_latent_matches_the_one_process_step(run):
    r0, r1 = run["ranks"][2]
    one = r0["one"]
    assert torch.equal(one["loss"], r1["one"]["loss"])
    for rank in (r0, r1):
        _assert_step(rank["drop"], float(one["loss"]), float(one["grad_norm"]),
                     {n: v.numpy() for n, v in one["exp_avg"].items()},
                     {n: v.numpy() for n, v in one["exp_avg_sq"].items()},
                     {n: v.numpy() for n, v in one["params"].items()},
                     {n: v.numpy() for n, v in one["stats"].items()})
    specs = r0["specs"]
    assert any(d is not None for n, d in specs.items() if n.startswith("latent_trans."))
    replicated = [k for k in r0["local"] if specs.get(k) is None]
    assert len(replicated) > 100
    for k in replicated:
        assert torch.equal(r0["local"][k], r1["local"][k]), k
    for k, d in specs.items():
        if d is not None:
            assert r0["local"][k].shape[d] * 2 == one["params"][k].shape[d], k


def _ckpt(run, exp, epoch, shape="1x2"):
    root = "checkpoints" if shape == "1x2" else "checkpoints_2x2"
    return torch.load(run["work"] / root / exp / f"checkpoint_{epoch}", weights_only=True)


def test_tp_checkpoints_are_the_one_process_schema_both_ways(run):
    tp_ckpt, plain = _ckpt(run, "tp", 1), _ckpt(run, "plain", 1)
    assert tp_ckpt["model"].keys() == plain["model"].keys()
    for k, v in plain["model"].items():
        assert tp_ckpt["model"][k].shape == v.shape, k
    for i, st in plain["optimizer"]["state"].items():
        for k, v in st.items():
            assert tp_ckpt["optimizer"]["state"][i][k].shape == v.shape, (i, k)
    # the TP checkpoint resumed without tensor parallelism (strict load)
    resumed = _ckpt(run, "tp", 2)
    assert resumed["step"] == 2 * tp_ckpt["step"] > 0 and resumed["epoch"] == 2
    # the checkpoint without tensor parallelism resumed under it, against
    # the same epoch resumed without it
    got, want = _ckpt(run, "plain", 2), _ckpt(run, "plain_ref", 2)
    steps = want["step"] - plain["step"]
    assert got["step"] == want["step"] and steps > 0
    for k, v in want["model"].items():
        if v.is_floating_point():
            allowed = 2 * LR * steps + 1e-5 * v.abs()
            assert ((got["model"][k] - v).abs() <= allowed).all(), k
        else:
            assert torch.equal(got["model"][k], v), k
    moved = [k for k, v in want["model"].items() if v.is_floating_point()
             and not torch.equal(v, plain["model"][k])]
    assert moved


def _rows(path):
    with h5py.File(path) as f:
        return {k: f[k][()] for k in f}


def test_tp_evaluate_writes_the_rows_of_one_process(run):
    one = _rows(run["work"] / "eval_one.h5")
    tp1 = _rows(next((run["work"] / "checkpoints" / "tp").glob("eval_dexycb_*.h5")))
    assert len(one["img_paths"]) == 16 and (tp1["img_paths"] == one["img_paths"]).all()
    for k in ("joint_cam_gt", "joint_reproj_gt"):
        np.testing.assert_array_equal(tp1[k], one[k], err_msg=k)
    scale = float(np.abs(one["joint_cam_pred"]).max())
    np.testing.assert_allclose(tp1["joint_cam_pred"], one["joint_cam_pred"], rtol=0,
                               atol=1e-4 * scale + 1e-4)
    tp2 = _rows(run["work"] / "eval_tp_2x2.h5")  # its own checkpoint: rows once each
    order = np.argsort(tp2["img_paths"])
    assert sorted(tp2["img_paths"]) == sorted(one["img_paths"])
    want = np.argsort(one["img_paths"])
    np.testing.assert_array_equal(tp2["joint_cam_gt"][order], one["joint_cam_gt"][want])


def test_tp_finetune_in_a_2x2_world_keeps_the_copies_equal(run):
    ranks = run["ranks"][4]
    assert all(r["tp_steps"] == ranks[0]["tp_steps"] > 0 for r in ranks)
    specs = tp.param_specs(_ckpt(run, "tp", 1, "2x2")["model"], 2)
    for r in ranks[1:]:
        for k, v in ranks[0]["tp_local"].items():
            if specs.get(k) is None:  # replicated: one value on all four ranks
                assert torch.equal(v, r["tp_local"][k]), k
    for a, b in ((0, 2), (1, 3)):  # a shard: one value on its model rank's data peers
        for k, v in ranks[a]["tp_local"].items():
            assert torch.equal(v, ranks[b]["tp_local"][k]), k
    saved = _ckpt(run, "tp", 1, "2x2")["model"]  # the gathered model: rank 0's shards in it
    for k, v in ranks[0]["tp_local"].items():
        d = specs.get(k)
        want = saved[k] if d is None else saved[k].narrow(d, 0, saved[k].shape[d] // 2)
        assert torch.equal(v, want), k
