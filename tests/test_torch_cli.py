"""Port parity: the experiment lifecycle (``cs_vit_tpu_torch.cli``: config
tiers, HF backbone weights, finetune with resume, evaluation to HDF5, the
benchmark metrics) against ``cs_vit_tpu.cli`` on the synthetic DexYCB
fixture, on the CPU, with the "test" backbone at img 32.

Tolerances:
- The backbone loaded from a local HF checkpoint against HF's
  ``last_hidden_state`` and against the JAX package's backbone: 3e-5
  absolute and relative, as ``test_torch_fused_block`` holds the same
  two-stage backbone against JAX (f32 sum order only).
- The learning rate of each step against JAX's optax schedule: 1e-6
  relative (JAX evaluates the schedule in f32, the port in f64).
- Eval parity: one set of JAX parameters is saved as an orbax checkpoint
  for ``cs_vit_tpu.cli.evaluate.main`` and exported by
  ``tools/export_torch_ckpt.py`` into the ``.pt`` the port's
  ``evaluate.main`` reads; both read the same fixture through their C crops
  (one C source: the same pixels). Paths and ground truth match exactly. The predictions are held against JAX's own
  float64 predictions of the same batches: the port may miss them by twice
  the larger of JAX's own f32 miss (its dump against its float64 result)
  and 1e-4 of the output's scale plus 1e-4, as
  ``test_torch_poser.test_test_backbone_predict_matches_jax`` holds
  ``predict``; against JAX's dump, by that plus JAX's own miss.
"""

import contextlib
import io
import json
import os
import re
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
from cs_vit_tpu.cli.common import load_backbone_params as j_load_backbone_params
from cs_vit_tpu.cli.common import load_or_create_config as j_load_or_create_config
from cs_vit_tpu.config import FinetuneConfig as JFinetuneConfig
from cs_vit_tpu.models.swinv2 import SwinV2 as JSwinV2
from cs_vit_tpu.models.swinv2 import SwinV2Config as JSwinV2Config
from cs_vit_tpu.train import save_checkpoint as j_save_checkpoint
from cs_vit_tpu.train import scaled_lr as j_scaled_lr
from cs_vit_tpu.train import warmup_cosine_schedule as j_warmup_cosine_schedule
from cs_vit_tpu_torch.cli import benchmark, evaluate, finetune
from cs_vit_tpu_torch.cli.common import (
    build_datasets,
    build_model,
    load_backbone_params,
    load_or_create_config,
    read_safetensors,
)
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.data.fixtures import (
    make_synthetic_dexycb,
    make_synthetic_ho3d,
    make_synthetic_ih26mseq,
)
from cs_vit_tpu_torch.evaluation import reproject_pinhole
from cs_vit_tpu_torch.models.swinv2 import SwinV2, SwinV2Config
from cs_vit_tpu_torch.train.optim import PhaseAdamW
from cs_vit_tpu_torch.train.state import TrainState

from .test_torch_poser import randomize, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE_TOL = dict(atol=3e-5, rtol=3e-5)
SEQ_LEN, BATCH = 6, 4  # 2 sequences x 6 frames: 3 steps an epoch, 3 eval batches


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("lifecycle")
    return {"data_root": make_synthetic_dexycb(str(base / "dexycb"), seq_len=SEQ_LEN),
            "ckpt_root": str(base / "checkpoints"), "base": base}


def make_cfg(env, cls=FinetuneConfig, **over):
    cfg = cls(exp="smoke", epoch=1, backbone="test", data=["dexycb"], seq_len=2,
              batch_size=BATCH, phase="spatial", temporal_supervision="full", lr=1e-3,
              lr_scheduler="warmup", img_size=32, dexycb_root=env["data_root"])
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def printed(fn, *args, **kwargs):
    """(fn's result, what it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


# --- config ------------------------------------------------------------------------


def test_config_load_or_create(tmp_path):
    """Mirrors tests/test_cli_e2e.py::test_config_load_or_create."""
    root = str(tmp_path / "ck")
    args = {"exp": "cfgtest", "backbone": "test", "batch_size": 2, "epoch": 5, "device": "x"}
    cfg = load_or_create_config("cfgtest", args, ckpt_root=root)
    assert cfg.backbone == "test" and cfg.batch_size == 2
    path = os.path.join(root, "cfgtest", "config.json")
    assert os.path.exists(path)

    # json takes precedence over new CLI args (except epoch)
    cfg2 = load_or_create_config(
        "cfgtest", {"exp": "cfgtest", "backbone": "swinv2-base-256", "epoch": 9}, ckpt_root=root)
    assert cfg2.backbone == "test"
    assert cfg2.epoch == 9
    with open(path) as f:
        assert json.load(f)["backbone"] == "test"

    # a config.json written by the JAX package loads the same
    j_load_or_create_config("jaxcfg", dict(args, backbone="swinv2-base-256"), ckpt_root=root)
    cfg3 = load_or_create_config("jaxcfg", {"epoch": 2}, ckpt_root=root)
    assert cfg3.backbone == "swinv2-base-256" and cfg3.epoch == 2


def test_config_file_with_unknown_keys_is_refused(tmp_path):
    path = tmp_path / "ck" / "bad" / "config.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"backbone": "test", "nosuch_key": 1}))
    with pytest.raises(KeyError, match="nosuch_key"):
        load_or_create_config("bad", {}, ckpt_root=str(tmp_path / "ck"))


# --- HF backbone weights -----------------------------------------------------------


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """A tiny transformers.Swinv2Model built from an in-code config, saved as
    safetensors (save_pretrained) and as a pytorch_model.bin."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Swinv2Config(image_size=32, patch_size=4, embed_dim=16, depths=[2, 2],
                                    num_heads=[2, 4], window_size=4)
    torch.manual_seed(0)
    hf = transformers.Swinv2Model(cfg, add_pooling_layer=False).eval()
    base = tmp_path_factory.mktemp("hf")
    st_dir, bin_dir = base / "st", base / "bin"
    hf.save_pretrained(str(st_dir), safe_serialization=True)
    bin_dir.mkdir()
    (bin_dir / "config.json").write_text((st_dir / "config.json").read_text())
    torch.save({"swinv2." + k: v for k, v in hf.state_dict().items()},
               str(bin_dir / "pytorch_model.bin"))
    return hf, {"safetensors": str(st_dir), "bin": str(bin_dir)}


TINY = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4, pretrained_window_sizes=(0, 0))


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_backbone_params_matches_hf_and_jax(hf_dirs, fmt, rng):
    hf, dirs = hf_dirs
    backbone = SwinV2(SwinV2Config(**TINY)).eval()
    assert load_backbone_params(dirs[fmt], backbone)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = backbone(torch.from_numpy(x)).numpy()
        want_hf = hf(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).last_hidden_state.numpy()
    jcfg = JSwinV2Config(**TINY)
    want_jax = np.asarray(JSwinV2(jcfg).apply(
        {"params": j_load_backbone_params(dirs[fmt], jcfg)}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want_hf, **BACKBONE_TOL)
    np.testing.assert_allclose(got, want_jax, **BACKBONE_TOL)


def test_load_backbone_params_without_weights(tmp_path):
    assert load_backbone_params(str(tmp_path), SwinV2(SwinV2Config(**TINY))) is False


def test_safetensors_reader_is_bit_exact(hf_dirs, tmp_path):
    from safetensors.torch import load_file, save_file

    _, dirs = hf_dirs
    g = torch.Generator().manual_seed(0)
    mixed = {
        "f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(7, generator=g).bfloat16(),
        "f16": torch.randn(2, 2, 2, generator=g).half(),
        "f64": torch.randn(3, generator=g).double(),
        "i64": torch.arange(-4, 5), "i32": torch.arange(3, dtype=torch.int32),
        "u8": torch.arange(250, 256, dtype=torch.uint8), "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
    }
    save_file(mixed, str(tmp_path / "mixed.safetensors"), metadata={"format": "pt"})
    for path in (os.path.join(dirs["safetensors"], "model.safetensors"),
                 str(tmp_path / "mixed.safetensors")):
        got, want = read_safetensors(path), load_file(path)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                               want[k].reshape(-1).view(torch.uint8)), k


# --- finetune -> resume -> evaluate -> benchmark ---------------------------------------


@pytest.fixture(scope="module")
def lifecycle(env):
    """Epoch 1, then epoch 2 resumed, then the eval dump and its metrics, with
    the lr of every AdamW update recorded."""
    lrs = []
    original = PhaseAdamW.scheduled_step

    def recording(self):
        original(self)
        lrs.append(self.param_groups[0]["lr"])

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PhaseAdamW, "scheduled_step", recording)
        out["state1"], out["log1"] = printed(finetune.main, make_cfg(env), env["ckpt_root"],
                                             log_every=1, device="cpu")
        out["lrs1"] = list(lrs)
        out["state2"], out["log2"] = printed(finetune.main, make_cfg(env, epoch=2),
                                             env["ckpt_root"], log_every=1, device="cpu")
        out["lrs2"] = lrs[len(out["lrs1"]):]
    exp_dir = os.path.join(env["ckpt_root"], "smoke")
    out["h5"], out["log_eval"] = printed(
        evaluate.main, make_cfg(env, eval_ckpt=os.path.join(exp_dir, "checkpoint")),
        env["ckpt_root"], device="cpu")
    out["metrics"], out["log_bench"] = printed(benchmark.main, out["h5"])
    out["exp_dir"] = exp_dir
    return out


def test_finetune_writes_checkpoints_and_resumes(lifecycle):
    exp_dir = lifecycle["exp_dir"]
    assert {"checkpoint", "checkpoint_1", "checkpoint_2"} <= set(os.listdir(exp_dir))
    assert os.readlink(os.path.join(exp_dir, "checkpoint")) == "checkpoint_2"
    s1, s2 = lifecycle["state1"], lifecycle["state2"]
    assert isinstance(s1, TrainState) and (s1.step, s2.step) == (3, 6)
    assert (s1.epoch, s2.epoch) == (1, 2)
    # the second run resumed from checkpoint_1 and trained epoch 2 only
    assert "Config loaded" not in lifecycle["log2"]
    assert f"resuming from {os.path.realpath(os.path.join(exp_dir, 'checkpoint_1'))}" \
        in lifecycle["log2"]
    assert re.findall(r"training for epoch (\d+)/", lifecycle["log1"]) == ["1"]
    assert re.findall(r"training for epoch (\d+)/", lifecycle["log2"]) == ["2"]
    assert re.findall(r"E2 it (\d+)/3", lifecycle["log2"]) == ["1", "2", "3"]
    ck = torch.load(os.path.join(exp_dir, "checkpoint_2"), map_location="cpu", weights_only=True)
    assert ck["epoch"] == 2 and ck["step"] == 6 and ck["model"].keys() == ck["merged"].keys()
    for k, v in s2.model.state_dict().items():
        assert torch.equal(ck["model"][k], v), k


def test_finetune_lr_follows_the_jax_schedule(lifecycle):
    """Every AdamW update's lr, across the resume, against JAX's optax
    schedule for the same steps_per_epoch (3) and the scaled lr."""
    max_lr, min_lr = j_scaled_lr(1e-3, 1, BATCH), j_scaled_lr(1e-6, 1, BATCH)
    schedule = j_warmup_cosine_schedule(max_lr, min_lr, 1, 10, 3)
    got = lifecycle["lrs1"] + lifecycle["lrs2"]
    assert len(lifecycle["lrs1"]) == len(lifecycle["lrs2"]) == 3
    want = [float(schedule(k)) for k in range(6)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0  # warm-up starts at 0, as in optax


def test_evaluate_and_benchmark(lifecycle):
    assert "loaded eval ckpt (0 unmatched leaves)" in lifecycle["log_eval"]
    assert re.search(r"eval: 3 batches of 4 in", lifecycle["log_eval"])
    with h5py.File(lifecycle["h5"], "r") as f:
        assert {k: f[k].shape for k in f} == {
            "img_paths": (12,), "joint_cam_gt": (12, 21, 3), "joint_cam_pred": (12, 21, 3),
            "joint_reproj_gt": (12, 21, 2), "joint_reproj_pred": (12, 21, 2)}
        assert np.isfinite(f["joint_cam_pred"][:]).all()
    assert os.path.basename(lifecycle["h5"]).startswith("eval_dexycb_spatial_full_")
    for key in ("mprpe", "mpjpe_cs", "mpjpe_rs", "mpjpe_pa"):
        assert np.isfinite(lifecycle["metrics"][key]) and lifecycle["metrics"][key] >= 0
        assert f"{key}: {lifecycle['metrics'][key]} mm" in lifecycle["log_bench"]


def test_resume_refuses_a_checkpoint_of_another_model(lifecycle, env):
    """Resume is strict: a checkpoint whose model keys differ is refused."""
    exp_dir = os.path.join(env["ckpt_root"], "other")
    os.makedirs(exp_dir)
    ck = torch.load(os.path.join(lifecycle["exp_dir"], "checkpoint_1"), weights_only=True)
    ck["model"] = {k: v for k, v in ck["model"].items() if not k.startswith("pose_decoder")}
    torch.save(ck, os.path.join(exp_dir, "checkpoint_1"))
    os.symlink("checkpoint_1", os.path.join(exp_dir, "checkpoint"))
    with pytest.raises(RuntimeError, match="pose_decoder"):
        printed(finetune.main, make_cfg(env, exp="other", epoch=2), env["ckpt_root"],
                device="cpu")


def test_temporal_phase_from_spatial_ckpt(lifecycle, env):
    """Cross-phase transfer: the temporal run starts from the spatial
    checkpoint (strict=False) and trains only the temporal encoders."""
    spatial = torch.load(os.path.join(lifecycle["exp_dir"], "checkpoint_2"), weights_only=True)
    cfg = make_cfg(env, exp="smoke_temporal", phase="temporal", seq_len=5, batch_size=2,
                   spatial_ckpt=os.path.join(lifecycle["exp_dir"], "checkpoint"))
    state, log = printed(finetune.main, cfg, env["ckpt_root"], log_every=1, device="cpu")
    assert "loaded spatial ckpt (0 unmatched leaves kept fresh)" in log
    assert state.step == 2  # 2 sequences x 2 windows of 5 frames, batch 2
    trained = ("pose_temporal_encoder", "shape_temporal_encoder", "root_temporal_encoder")
    moved = set()
    for k, v in state.model.state_dict().items():
        if not torch.equal(v, spatial["model"][k]):
            moved.add(k.split(".", 1)[0])
    assert moved and moved <= set(trained), moved


# --- eval parity against the JAX package ------------------------------------------


@pytest.fixture(scope="module")
def eval_parity(env):
    """The same JAX parameters evaluated by both packages on the fixture, and
    JAX's float64 predictions of the same batches."""
    base = env["base"] / "parity"
    ckpt_root = str(base / "checkpoints")
    rng = np.random.default_rng(3)
    jcfg = make_cfg(env, cls=JFinetuneConfig, exp="parity", attention_impl="xla")
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
    printed(j_evaluate.main, make_cfg(env, cls=JFinetuneConfig, exp="parity",
                                      attention_impl="xla", eval_ckpt=orbax_dir),
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


def test_eval_dump_matches_jax(eval_parity):
    jax_dump, port = eval_parity["jax"], eval_parity["port"]
    assert "loaded eval ckpt (0 unmatched leaves)" in eval_parity["log"]
    assert sorted(port) == sorted(jax_dump)
    np.testing.assert_array_equal(port["img_paths"], jax_dump["img_paths"])
    assert len(port["img_paths"]) == 2 * SEQ_LEN
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


# --- refusals and entry points ---------------------------------------------------------


def test_evaluate_protocol_guard(env):
    cfg = make_cfg(env, phase="temporal", temporal_supervision="full")
    with pytest.raises(ValueError, match="eval supports spatial or temporal\\+realtime"):
        evaluate.main(cfg, device="cpu")


@pytest.mark.parametrize("name", ["ho3d", "interhand26m"])
def test_unported_datasets_are_refused(env, name, tmp_path):
    """Every dataset the JAX package accepts is ported (this one's items are
    held in tests/test_torch_datasets.py); a name it does not accept is
    refused."""
    with pytest.raises(ValueError, match="unknown dataset"):
        build_datasets(make_cfg(env, data=[name.upper()]), "train")
    roots = {"ho3d": ("ho3d_root", make_synthetic_ho3d),
             "interhand26m": ("ih26mseq_root", make_synthetic_ih26mseq)}
    field, make = roots[name]
    ds, log = printed(build_datasets,
                      make_cfg(env, data=[name], **{field: make(str(tmp_path / name))}), "train")
    assert f"Added {name}" in log and len(ds) > 0


@pytest.mark.parametrize("field,value", [("tp", 2), ("remat", True)])
def test_unported_options_are_refused(env, field, value):
    """No option is refused any more: ``remat`` reaches the backbone's
    config, and ``tp`` the eager attention path that tensor parallelism
    shards (``tests/test_torch_tp.py`` runs it in worlds of two and four);
    what is left of the refusal is the world ``tp`` needs: one process
    cannot hold a ``tp=2`` mesh, and the error says so."""
    cfg = make_cfg(env, **{field: value})
    if field == "tp":
        assert build_model(cfg).config.attention_impl == "eager"
        with pytest.raises(ValueError, match="tp=2 needs a world of n_data x 2 processes"):
            finetune.main(cfg, device="cpu")
        with pytest.raises(ValueError, match="tp=2 needs a world"):
            evaluate.main(cfg, device="cpu", h5_path=str(env["base"] / "tp.h5"))
    else:
        assert build_model(cfg).config.swin_config().remat is True


def test_cli_device_cuda_without_a_card_raises(env, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    monkeypatch.chdir(tmp_path)
    args = ["--exp", "dev", "--phase", "spatial", "--temporal_supervision", "full",
            "--backbone", "test", "--img_size", "32", "--data", "dexycb",
            "--dexycb_root", env["data_root"], "--batch_size", "4", "--epoch", "1"]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        printed(finetune.cli, args)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        printed(evaluate.cli, ["--exp", "dev", "--data", "dexycb", "--batch_size", "4",
                               "--eval_ckpt", "none"])


def test_cli_entry_points_on_cpu(env, tmp_path, monkeypatch):
    """The three console entry points, in a fresh directory, on the CPU."""
    monkeypatch.chdir(tmp_path)
    args = ["--exp", "cli", "--phase", "spatial", "--temporal_supervision", "full",
            "--backbone", "test", "--img_size", "32", "--data", "dexycb",
            "--dexycb_root", env["data_root"], "--batch_size", "4", "--epoch", "1",
            "--device", "cpu"]
    _, log = printed(finetune.cli, args)
    assert "Config loaded from command" in log and "writing checkpoint for epoch 1" in log
    _, log = printed(evaluate.cli, ["--exp", "cli", "--data", "dexycb", "--batch_size", "4",
                                    "--eval_ckpt", "checkpoints/cli/checkpoint",
                                    "--device", "cpu"])
    h5 = re.search(r"eval dump written to (\S+)", log).group(1)
    _, log = printed(benchmark.cli, [h5])
    assert re.findall(r"^(\w+): \S+ mm$", log, re.M) == ["mprpe", "mpjpe_cs", "mpjpe_rs",
                                                         "mpjpe_pa"]
