"""Port parity: the tools under ``cs_vit_tpu_torch/tools/`` against the JAX
package's ``tools/`` on the same inputs, on the CPU.

* ``demo``: the "test" backbone at img 32 from the weights the JAX tool
  initialises (carried across by ``train/convert.py``), on the JAX tool's
  synthetic frame: ``joint_cam`` against the JAX tool's, to twice 1e-4 of
  its scale plus 1e-4 (the floor of ``tests/test_torch_poser.py``'s bound
  for ``predict``; both f32 results missed JAX's float64 one by under 4e-3
  mm of 3057 when this test was written, so the bound leaves room for the
  CPU's sum order); the PNG is written with the crop's size.
* ``analyze``: the same dict as JAX's on an H5 that the port's writer wrote.
* ``scan``: the same groups as JAX's, clean and with a NaN, and exit code 1
  on the NaN.
* ``dryrun_dexycb`` and ``dryrun_hybrid``: 2 iterations each on the port's
  fixtures (the synthetic default, and roots handed in), batches of
  [B, T, 256, 256, 3] patches as the JAX tools print.
"""

import contextlib
import importlib.util
import io
import os
import sys

import cv2
import h5py
import jax
import numpy as np
import pytest
import torch

import cs_vit_tpu.cli.common as jcommon
import cs_vit_tpu.evaluation as jevaluation
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.data.fixtures import (
    make_synthetic_dexycb,
    make_synthetic_ho3d,
    make_synthetic_ih26mseq,
)
from cs_vit_tpu_torch.evaluation import EvalH5Writer
from cs_vit_tpu_torch.tools import (
    analyze_eval_h5,
    demo,
    dryrun_dexycb,
    dryrun_hybrid,
    scan_ih26m_annotations,
)
from cs_vit_tpu_torch.train import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    """A module of the JAX package's ``tools/`` (not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def test_demo_matches_the_jax_tool(tmp_path, monkeypatch):
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(FinetuneConfig(exp="demo", backbone="test", img_size=32,
                                       phase="inference").to_json())
    seen = {}

    def spy(name, fn):
        def inner(*a, **k):
            out = fn(*a, **k)
            seen[name] = (a, out)
            return out
        return inner

    for mod, name in ((jcommon, "init_variables"), (jevaluation, "reproject_pinhole")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    monkeypatch.setattr(sys, "argv", ["demo.py", "--config", str(cfg_path),
                                      "--out", str(tmp_path / "jax.png")])
    quiet(jax_tool("demo").main)
    want = np.asarray(seen["reproject_pinhole"][0][0])[0, 0]
    variables = seen["init_variables"][1]
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray, variables["batch_stats"]),
                              demo_poser_config(cfg_path))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "w.pt")
    out = quiet(demo.main, ["--config", str(cfg_path), "--ckpt", str(tmp_path / "w.pt"),
                            "--out", str(tmp_path / "port.png"), "--device", "cpu"])
    got = out["joint_cam"]
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == (21, 3) and np.isfinite(got).all()
    assert err <= 2 * (1e-4 * scale + 1e-4), (err, scale)
    png = cv2.imread(str(tmp_path / "port.png"))
    assert png.shape == (32, 32, 3) and out["grid"].shape == (32, 32, 3)
    assert cv2.imread(str(tmp_path / "jax.png")).shape == png.shape


def demo_poser_config(cfg_path):
    from cs_vit_tpu_torch.cli.common import poser_config_from

    return poser_config_from(FinetuneConfig.from_json_file(str(cfg_path)))


def test_demo_defaults_to_the_card():
    args = demo.build_argparser().parse_args([])
    assert args.device == "cuda" and args.config is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            quiet(demo.main, [])


def _dump(path, seed, n=12):
    rng = np.random.default_rng(seed)
    gt = rng.normal(scale=50.0, size=(n, 21, 3)).astype(np.float32)
    gt[..., 2] += 500.0
    pred = gt + rng.normal(scale=5.0, size=gt.shape).astype(np.float32)
    w = EvalH5Writer(str(path))
    w.append([f"img_{i}.jpg" for i in range(n)], gt, pred, gt[..., :2], pred[..., :2])
    w.close()


@pytest.mark.parametrize("use_pred", [False, True])
def test_analyze_matches_jax_on_the_port_s_dump(tmp_path, use_pred):
    path = tmp_path / "eval.h5"
    _dump(path, 3)
    got = quiet(analyze_eval_h5.analyze, str(path), use_pred)
    want = quiet(jax_tool("analyze_eval_h5").analyze, str(path), use_pred)
    assert got.keys() == want.keys() == {"roots", "metrics", "root_err", "joint_err"}
    for k in ("roots", "root_err", "joint_err"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["metrics"].keys() == want["metrics"].keys()
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-6), k


def test_analyze_cli_plots_with_matplotlib_only_there(tmp_path):
    path = tmp_path / "eval.h5"
    _dump(path, 4)
    results = quiet(analyze_eval_h5.main, [str(path), "--plot", str(tmp_path / "roots.png")])
    assert set(results) == {str(path)}
    assert cv2.imread(str(tmp_path / "roots.png")) is not None


def test_scan_matches_jax_and_gates_on_nan(tmp_path):
    root = make_synthetic_ih26mseq(str(tmp_path / "ih26m"), splits=("train",), seq_len=4)
    seq = os.path.join(root, "annotations", "train", "seq.h5")
    jscan = jax_tool("scan_ih26m_annotations").scan
    keys = ["joint_img", "joint_cam"]
    assert quiet(scan_ih26m_annotations.scan, seq, keys) == quiet(jscan, seq, keys) == []
    assert quiet(scan_ih26m_annotations.main, [seq]) == 0
    with h5py.File(seq, "a") as f:
        groups = []
        f.visit(lambda name: groups.append(name) if name.endswith("annots") else None)
        ds = f[groups[-1]]["joint_img"]
        arr = ds[()]
        arr[1, 3, 0] = np.nan
        ds[...] = arr
    got = quiet(scan_ih26m_annotations.scan, seq, keys)
    assert got == quiet(jscan, seq, keys)
    assert len(got) == 1 and got[0]["key"] == "joint_img" and got[0]["nan_frames"] == 1
    assert quiet(scan_ih26m_annotations.main, [seq, "--keys", "joint_cam"]) == 0
    assert quiet(scan_ih26m_annotations.main, [seq]) == 1


def test_dryrun_dexycb_runs_two_iterations(tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    shapes = quiet(dryrun_dexycb.main, ["--frames", "2", "--batch_size", "2",
                                        "--max_iters", "2"])
    assert shapes == [(2, 2, 256, 256, 3)] * 2


def test_dryrun_hybrid_runs_two_iterations(tmp_path, monkeypatch):
    roots = {"dexycb": make_synthetic_dexycb(str(tmp_path / "dexycb"), seq_len=4),
             "ho3d": make_synthetic_ho3d(str(tmp_path / "ho3d"), seq_len=4),
             "ih26m": make_synthetic_ih26mseq(str(tmp_path / "ih26m"), seq_len=4)}
    args = [x for k, v in roots.items() for x in (f"--{k}", v)]
    shapes = quiet(dryrun_hybrid.main, args + ["--frames", "2", "--batch_size", "2",
                                               "--max_iters", "2"])
    assert shapes == [(2, 2, 256, 256, 3)] * 2
