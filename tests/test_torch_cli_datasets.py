"""Port parity: ``cli.finetune`` and ``cli.evaluate`` over the HO3D and
InterHand2.6M fixtures against the JAX CLIs, on the CPU, with the "test"
backbone at img 32 (``tests/test_torch_cli.py`` does the same for DexYCB).

- Finetune: one bf16 epoch of the port's loop over ``data=["ho3d",
  "interhand26m"]``. Every batch its train step receives (through
  ``parallel.device_prefetch``, ``patches`` cast to bf16 on the host) is
  held bit for bit against the batch the JAX loop's pipeline gives its step
  (``build_loader`` over ``build_datasets`` into ``device_prefetch`` with
  ``patches_dtype=bfloat16``, ``cs_vit_tpu/cli/finetune.py:158-160``), and
  the lr of every AdamW update against JAX's optax schedule to 1e-6 relative
  (JAX evaluates it in f32, the port in f64), as for DexYCB.
- Evaluate: one set of JAX parameters, evaluated by both CLIs over both
  test splits (HO3D's "evaluation", InterHand2.6M's "test"), each package
  reading its own fixture tree through its C crop. Paths and ground truth
  match exactly; the predictions are held to ``test_torch_cli``'s bound:
  twice the larger of JAX's own f32 miss (its dump against its float64
  predictions of the same batches) and 1e-4 of the output's scale plus
  1e-4; against JAX's dump, that plus JAX's own miss.
"""

import contextlib
import io
import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.cli import evaluate as j_evaluate
from cs_vit_tpu.cli.common import build_datasets as j_build_datasets
from cs_vit_tpu.cli.common import build_loader as j_build_loader
from cs_vit_tpu.cli.common import build_model as j_build_model
from cs_vit_tpu.cli.common import init_variables
from cs_vit_tpu.config import FinetuneConfig as JFinetuneConfig
from cs_vit_tpu.data import fixtures as jf
from cs_vit_tpu.parallel import fitting_mesh
from cs_vit_tpu.parallel.prefetch import device_prefetch as j_device_prefetch
from cs_vit_tpu.train import save_checkpoint as j_save_checkpoint
from cs_vit_tpu.train import scaled_lr as j_scaled_lr
from cs_vit_tpu.train import warmup_cosine_schedule as j_warmup_cosine_schedule
from cs_vit_tpu_torch.cli import evaluate, finetune
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.data import fixtures as tf
from cs_vit_tpu_torch.evaluation import reproject_pinhole
from cs_vit_tpu_torch.train.optim import PhaseAdamW

from .test_torch_poser import randomize, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_LEN, BATCH = 4, 4  # HO3D 2 x 4 frames, InterHand2.6M 2 hands x 4: 4 batches a split


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_datasets")
    roots = {}
    for side, fx in (("port", tf), ("jax", jf)):
        roots[side] = {
            "ho3d_root": fx.make_synthetic_ho3d(str(base / side / "ho3d"), seq_len=SEQ_LEN),
            "ih26mseq_root": fx.make_synthetic_ih26mseq(str(base / side / "ih26m"),
                                                        seq_len=SEQ_LEN)}
    return {"roots": roots, "ckpt_root": str(base / "checkpoints"), "base": base}


def make_cfg(env, side="port", **over):
    cls = FinetuneConfig if side == "port" else JFinetuneConfig
    kw = dict(exp="ds", epoch=1, backbone="test", data=["ho3d", "interhand26m"], seq_len=2,
              batch_size=BATCH, phase="spatial", temporal_supervision="full", lr=1e-3,
              lr_scheduler="warmup", img_size=32, num_workers=2, **env["roots"][side])
    if side == "jax":
        kw["attention_impl"] = "xla"
    kw.update(over)
    return cls(**kw)


def printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


def relpaths(paths, env):
    roots = [r for side in env["roots"].values() for r in side.values()]
    out = []
    for p in paths:
        p = p.decode() if isinstance(p, bytes) else p
        root = next(r for r in roots if p.startswith(r + os.sep))
        out.append(os.path.relpath(p, root))
    return out


def test_finetune_batches_and_lr_match_jax(env):
    seen, losses, lrs = [], [], []
    make_step, scheduled_step = finetune.make_train_step, PhaseAdamW.scheduled_step

    def recording_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch, *rest):
            seen.append({k: v.clone() for k, v in batch.items()})
            state, metrics = step(state, batch, *rest)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return run

    def recording_lr(self):
        scheduled_step(self)
        lrs.append(self.param_groups[0]["lr"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(finetune, "make_train_step", recording_step)
        mp.setattr(PhaseAdamW, "scheduled_step", recording_lr)
        state, log = printed(finetune.main, make_cfg(env, exp="ft", dtype="bfloat16"),
                             env["ckpt_root"], log_every=1, device="cpu")
    steps = 2 * 2 * SEQ_LEN // BATCH
    assert state.step == steps and len(seen) == steps
    assert "Added ho3d" in log and "Added interhand26m" in log
    assert "of the wall waiting on the loader" in log
    assert np.isfinite(losses).all() and len(losses) == steps

    jcfg = make_cfg(env, "jax", exp="ft", dtype="bfloat16")
    loader = j_build_loader(jcfg, j_build_datasets(jcfg, "train"), shuffle=True)
    loader.set_epoch(1)
    want = [jax.tree.map(np.asarray, b) for b in
            j_device_prefetch(loader, fitting_mesh(BATCH), patches_dtype=jnp.bfloat16)]
    assert len(want) == steps
    for got, w in zip(seen, want):
        assert sorted(got) == sorted(w)
        for k in w:
            g = got[k]
            if k == "patches":
                assert g.dtype == torch.bfloat16 and w[k].dtype == jnp.bfloat16
                np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                              w[k].view(np.int16), err_msg=k)
            else:
                assert g.numpy().dtype == w[k].dtype, k
                np.testing.assert_array_equal(g.numpy(), w[k], err_msg=k)

    max_lr, min_lr = j_scaled_lr(1e-3, 1, BATCH), j_scaled_lr(1e-6, 1, BATCH)
    schedule = j_warmup_cosine_schedule(max_lr, min_lr, 1, 10, steps)
    np.testing.assert_allclose(lrs, [float(schedule(k)) for k in range(steps)], rtol=1e-6,
                               atol=0)


@pytest.fixture(scope="module")
def eval_parity(env):
    """The same JAX parameters evaluated by both CLIs over both test splits,
    and JAX's float64 predictions of the same batches."""
    base = env["base"] / "parity"
    ckpt_root = str(base / "checkpoints")
    rng = np.random.default_rng(3)
    jcfg = make_cfg(env, "jax", exp="parity")
    jmodel = j_build_model(jcfg)
    variables = to_numpy(randomize(init_variables(jmodel, jcfg, 1), rng))
    exp_dir = os.path.join(ckpt_root, "parity")
    orbax_dir = j_save_checkpoint(exp_dir, 1, {"params": variables["params"],
                                               "batch_stats": variables["batch_stats"],
                                               "epoch": 1})
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        f.write(jcfg.to_json())
    pt_path = str(base / "parity.pt")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import export_torch_ckpt
    finally:
        sys.path.pop(0)
    printed(export_torch_ckpt.main, orbax_dir, os.path.join(exp_dir, "config.json"), pt_path)

    out = {}
    printed(j_evaluate.main, make_cfg(env, "jax", exp="parity", eval_ckpt=orbax_dir),
            ckpt_root, h5_path=str(base / "jax.h5"))
    batches = list(j_build_loader(jcfg, j_build_datasets(jcfg, "test"), shuffle=False))
    _, out["log"] = printed(evaluate.main, make_cfg(env, exp="parity", eval_ckpt=pt_path),
                            ckpt_root, h5_path=str(base / "port.h5"), device="cpu")
    for name in ("jax", "port"):
        with h5py.File(str(base / f"{name}.h5"), "r") as f:
            out[name] = {k: f[k][()] for k in f}

    keys = ("patches", "square_bboxes", "timestamp", "focal", "princpt")
    cam64, reproj64 = [], []
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), variables)
        for b in batches:
            pred = jmodel.apply(f64, *[jnp.asarray(b[k], jnp.float64) for k in keys],
                                "inference", method=jmodel.predict)
            jc = np.asarray(pred["joint_cam"])
            cam64.append(jc[:, -1])
            reproj64.append(reproject_pinhole(jc, b["focal"].astype(np.float64),
                                              b["princpt"].astype(np.float64))[:, -1])
    out["f64"] = {"joint_cam_pred": np.concatenate(cam64),
                  "joint_reproj_pred": np.concatenate(reproj64)}
    return out


def test_eval_dump_over_ho3d_and_interhand26m_matches_jax(eval_parity, env):
    jax_dump, port = eval_parity["jax"], eval_parity["port"]
    assert "loaded eval ckpt (0 unmatched leaves)" in eval_parity["log"]
    assert "eval: 4 batches of 4 in" in eval_parity["log"]
    assert sorted(port) == sorted(jax_dump)
    paths = relpaths(port["img_paths"], env)
    assert paths == relpaths(jax_dump["img_paths"], env) and len(paths) == 4 * SEQ_LEN
    assert sum(p.startswith("images/ho3d_seq") for p in paths) == 2 * SEQ_LEN
    for k in ("joint_cam_gt", "joint_reproj_gt"):
        np.testing.assert_array_equal(port[k], jax_dump[k], err_msg=k)
    for k in ("joint_cam_pred", "joint_reproj_pred"):
        want = eval_parity["f64"][k]
        scale = np.abs(want).max()
        jax_miss = np.abs(jax_dump[k].astype(np.float64) - want).max()
        tol = 2 * max(jax_miss, 1e-4 * scale + 1e-4)
        err = np.abs(port[k].astype(np.float64) - want).max()
        print(f"{k}: port miss {err:.4g}, JAX f32 miss {jax_miss:.4g}, scale {scale:.4g}")
        assert err <= tol, (k, err, tol, jax_miss, scale)
        gap = np.abs(port[k].astype(np.float64) - jax_dump[k]).max()
        assert gap <= tol + jax_miss, (k, gap, tol + jax_miss)
