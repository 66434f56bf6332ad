"""Data parallelism: the port's train step in a two-process gloo world against
JAX's two-device ``shard_map`` step, and the CLIs in that world.

The workers (``tests/torch_dp_worker.py``) start once for the module and run
every case; the tests read what they wrote. The oracle of a two-rank step is
JAX's ``make_train_step(..., mesh=make_mesh(n_data=2))`` on the same halves,
not a one-process step on the whole batch: the spatial encoder's block norms
are BatchNorm1d, and each rank (each device under ``shard_map``) normalises
its rows by their own statistics. A one-process step is the oracle only
where both ranks see the same batch.

Tolerances against JAX are those ``tests/test_torch_train.py`` holds the
one-process step to (see its docstring): loss rtol 1e-5, grad_norm rtol
5e-5, the clipped grads (here read from AdamW's first moment, 0.1 g after
one step) to 1e-4 of each leaf's largest magnitude plus 1e-6 of the clip
norm 5, the second moment (1e-3 g^2) to what that grad tolerance allows,
parameters to 2 lr where the grad is small enough for its sign to flip and
to 1e-6 |p| + 1e-3 lr elsewhere, BatchNorm statistics 1e-5.
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

from cs_vit_tpu.parallel import make_mesh
from cs_vit_tpu.train import TrainState as JTrainState
from cs_vit_tpu.train import build_optimizer as j_build_optimizer
from cs_vit_tpu.train import make_train_step as j_make_train_step
from cs_vit_tpu_torch.cli.common import build_model
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.data.fixtures import make_synthetic_dexycb
from cs_vit_tpu_torch.models import PoserConfig, init_poser_weights
from cs_vit_tpu_torch.parallel import all_mean_, init_distributed, process_local_batch_slice
from cs_vit_tpu_torch.serving import INIT_SEED
from cs_vit_tpu_torch.train import state_dict_from_flax

from .helpers import TINY_SWIN, tiny_batch, tiny_poser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
POSER = dict(backbone="custom", image_size=32, num_pose_query=16, num_spatial_layer=2,
             num_temporal_layer=1)
SWIN = {f: getattr(TINY_SWIN, f) for f in (
    "image_size", "patch_size", "embed_dim", "depths", "num_heads", "window_size",
    "drop_path_rate", "pretrained_window_sizes")}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam_moments(opt_state):
    """(mu, nu) of the optax AdamW inside the JAX optimizer's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu
    children = opt_state.values() if isinstance(opt_state, dict) else (
        opt_state if isinstance(opt_state, tuple) else ())
    for child in children:
        found = _adam_moments(child)
        if found is not None:
            return found
    return None


def _filled(moment, params):
    """A params-shaped tree of `moment`, zeros where a frozen leaf has none."""
    if isinstance(params, dict):
        return {k: _filled(moment[k], v) for k, v in params.items()}
    return np.asarray(moment) if hasattr(moment, "shape") else np.zeros_like(params)


@pytest.fixture(scope="module")
def jax_dp():
    """JAX's two-device shard_map step (f32, droppath 0, lr 1e-3) on a b4
    batch, from random BatchNorm running statistics."""
    rng = np.random.default_rng(3)
    jmodel = tiny_poser()
    batch = tiny_batch(rng, B=4, T=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jmodel.init({"params": jax.random.key(0), "droppath": jax.random.key(1)},
                            jbatch, phase="inference")
    stats = jax.tree.map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, size=np.shape(v)), jnp.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tx = j_build_optimizer(variables["params"], "spatial", LR)
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    new_state, metrics = j_make_train_step(jmodel, tx, "spatial", donate=False, mesh=mesh)(
        JTrainState.create(variables, tx), jbatch, jax.random.key(0))
    params = _np(variables["params"])
    mu, nu = _adam_moments(new_state.opt_state)
    return dict(batch=batch, variables=_np(variables), new_params=_np(new_state.params),
                new_stats=_np(new_state.batch_stats), mu=_filled(mu, params),
                nu=_filled(nu, params), loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]))


@pytest.fixture(scope="module")
def world(jax_dp, tmp_path_factory):
    """Both workers' results (``tests/torch_dp_worker.py``), run once."""
    work = tmp_path_factory.mktemp("dp")
    config = PoserConfig(custom_swin=TINY_SWIN, **POSER)
    sd = state_dict_from_flax(jax_dp["variables"]["params"], jax_dp["variables"]["batch_stats"],
                              config)
    root = make_synthetic_dexycb(str(work / "dexycb"), seq_len=8)
    torch.save({"state_dict": sd, "swin": SWIN, "poser": POSER, "batch": jax_dp["batch"],
                "lr": LR, "dexycb_root": root}, work / "payload.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), port, str(work)], env=env,
                              cwd=str(work), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
        assert out.strip().endswith("done"), out[-2000:]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(ranks=ranks, work=work, sd=sd, config=config)


def _ref_names(tree, stats, config, names):
    sd = state_dict_from_flax(tree, stats, config)
    return {k: v for k, v in sd.items() if k in names}


def _assert_same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_step_matches_jax_shard_map(world, jax_dp, rank):
    js, got = jax_dp, world["ranks"][rank]["halves"]
    assert got["step"] == 1 and float(got["skipped"]) == 0.0
    assert float(got["loss"]) == pytest.approx(js["loss"], rel=1e-5)
    assert float(got["grad_norm"]) == pytest.approx(js["grad_norm"], rel=5e-5)
    stats = js["variables"]["batch_stats"]
    names = set(got["exp_avg"])
    mu = _ref_names(js["mu"], stats, world["config"], names)
    nu = _ref_names(js["nu"], stats, world["config"], names)
    new = _ref_names(js["new_params"], js["new_stats"], world["config"], names)
    assert names and names <= set(mu)
    for n in names:
        g_want = mu[n] / 0.1
        atol = 1e-4 * float(np.abs(g_want).max()) + 1e-6 * 5.0
        np.testing.assert_allclose(got["exp_avg"][n].numpy(), mu[n], rtol=0, atol=0.1 * atol,
                                   err_msg=n)
        nu_tol = 1e-3 * (2 * float(np.abs(g_want).max()) * atol + atol ** 2)
        np.testing.assert_allclose(got["exp_avg_sq"][n].numpy(), nu[n], rtol=0, atol=nu_tol,
                                   err_msg=n)
        p, want = got["params"][n].numpy(), new[n]
        sensitive = np.abs(g_want) < 10 * atol
        allowed = np.where(sensitive, 2 * LR, 1e-6 * np.abs(want) + 1e-3 * LR)
        assert (np.abs(p - want) <= allowed).all(), n
    sd = state_dict_from_flax(js["new_params"], js["new_stats"], world["config"])
    assert got["stats"]
    for n, b in got["stats"].items():
        np.testing.assert_allclose(b.numpy(), sd[n], atol=1e-5, rtol=1e-5, err_msg=n)


def test_ranks_agree_bit_for_bit(world):
    r0, r1 = (r["halves"] for r in world["ranks"])
    for key in ("params", "stats", "exp_avg", "exp_avg_sq"):
        _assert_same(r0[key], r1[key], key)
    for key in ("loss", "grad_norm"):
        assert torch.equal(r0[key], r1[key]), key


def test_same_batch_on_both_ranks_equals_the_one_process_step(world):
    for rank in world["ranks"]:
        for key in ("params", "stats", "exp_avg", "exp_avg_sq"):
            _assert_same(rank["same"][key], rank["one"][key], key)
        for key in ("loss", "grad_norm"):
            assert torch.equal(rank["same"][key], rank["one"][key]), key


def test_nan_on_one_rank_skips_the_step_on_both(world):
    initial = {n: torch.from_numpy(np.asarray(v)) for n, v in world["sd"].items()}
    for rank in world["ranks"]:
        got = rank["nan"]
        assert float(got["skipped"]) == 1.0 and got["step"] == 0
        assert not np.isfinite(float(got["loss"]))
        for n, p in got["params"].items():
            assert torch.equal(p, initial[n].to(p.dtype)), n
        for n, b in got["stats"].items():
            assert torch.equal(b, initial[n].to(b.dtype)), n
        assert got["exp_avg"] == {}  # AdamW took no step


def test_finetune_leaves_the_same_weights_on_both_ranks(world):
    """Fault A: each rank reads its own shard; after two steps both hold
    the same parameters and BatchNorm statistics (on the parent the ranks
    trained apart, and only rank 0's weights were saved)."""
    r0, r1 = world["ranks"]
    assert r0["finetune_steps"] == r1["finetune_steps"] == 2
    _assert_same(r0["finetune"]["params"], r1["finetune"]["params"], "params")
    _assert_same(r0["finetune"]["stats"], r1["finetune"]["stats"], "stats")
    saved = torch.load(world["work"] / "checkpoints" / "dp" / "checkpoint",
                       weights_only=False)["model"]
    for n, p in r1["finetune"]["params"].items():
        assert torch.equal(saved[n], p), n
    fresh = build_model(FinetuneConfig(backbone="test", img_size=32, phase="spatial"))
    init_poser_weights(fresh, INIT_SEED)
    start = dict(fresh.named_parameters())
    assert [n for n, p in r0["finetune"]["params"].items() if not torch.equal(p, start[n])]


def test_evaluate_in_a_world_of_two_writes_the_one_process_rows(world):
    """Rank 0's dump holds the one-process dump's rows, each batch as rank
    0's rows then rank 1's (JAX's ``process_allgather`` order)."""
    with h5py.File(world["work"] / "eval_world.h5") as f2, \
            h5py.File(world["work"] / "eval_one.h5") as f1:
        one = {k: f1[k][()] for k in f1}
        two = {k: f2[k][()] for k in f2}
    n, B = len(one["img_paths"]), 4
    assert n == 16 and len(two["img_paths"]) == n
    shards = [np.arange(r, n, 2) for r in range(2)]
    order = np.concatenate([s[k * B:(k + 1) * B] for k in range(n // (2 * B)) for s in shards])
    assert [p.decode() if isinstance(p, bytes) else p for p in two["img_paths"]] == \
        [p.decode() if isinstance(p, bytes) else p for p in one["img_paths"][order]]
    for k in ("joint_cam_gt", "joint_reproj_gt"):
        np.testing.assert_array_equal(two[k], one[k][order], err_msg=k)
    for k in ("joint_cam_pred", "joint_reproj_pred"):
        np.testing.assert_allclose(two[k], one[k][order], rtol=1e-5, atol=1e-3, err_msg=k)


def test_world_helpers_without_a_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    t = [torch.arange(3.0), torch.ones(2, 2)]
    before = [x.clone() for x in t]
    all_mean_(t)
    for a, b in zip(t, before):
        assert torch.equal(a, b)
    assert process_local_batch_slice(8) == slice(0, 8)
