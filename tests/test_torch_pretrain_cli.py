"""Port parity: TI pretraining's data and CLI.

* The fixture trees each package writes from the same seed are byte for
  byte the same (``make_synthetic_image_folder``, ``make_synthetic_ego4d``,
  ``make_synthetic_hint``).
* ``COCO2017``, ``Ego4DHandImage`` and ``HIntHandImage`` items equal the
  JAX package's exactly, over two epochs of augmentation draws.
* ``cli.pretrain_ti`` runs each mode on the image-folder fixture on the
  CPU: finite losses, one checkpoint an epoch with the JAX CLI's keys, and
  only the stage's parameters moved. Its steps against JAX's, from the same
  weights and draws, are in ``tests/test_torch_ti.py`` (the two CLIs draw
  from different generators, so their checkpoints cannot match).
* A stray ``WORLD_SIZE`` is no world: the CLI runs alone (two ranks are
  in ``tests/test_torch_pretrain_world.py``).
"""

import os

import numpy as np
import pytest
import torch

from cs_vit_tpu.data import fixtures as jfixtures
from cs_vit_tpu.data import pretrain as jpretrain
from cs_vit_tpu_torch.cli import pretrain_ti
from cs_vit_tpu_torch.data import fixtures, pretrain
from cs_vit_tpu_torch.models.ti import dino_stage_mask, init_ti_weights

SMALL = ["--img_size", "32", "--patch_size", "8", "--hidden_size", "16", "--num_layers", "2",
         "--num_heads", "2", "--epochs", "1", "--batch_size", "4", "--log_every", "1",
         "--device", "cpu"]


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("name", ["make_synthetic_image_folder", "make_synthetic_ego4d",
                                  "make_synthetic_hint"])
def test_fixture_trees_are_byte_identical(tmp_path, name):
    getattr(fixtures, name)(str(tmp_path / "port"))
    getattr(jfixtures, name)(str(tmp_path / "jax"))
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got and got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("name", ["coco", "ego4d", "hint"])
def test_pretrain_items_match_jax(tmp_path, name):
    if name == "coco":
        root = fixtures.make_synthetic_image_folder(str(tmp_path / "imgs"))
        make = lambda m: m.COCO2017(root, img_size=32)  # noqa: E731
    elif name == "ego4d":
        root = fixtures.make_synthetic_ego4d(str(tmp_path / "ego4d"))
        make = lambda m: m.Ego4DHandImage(root, img_size=32, cache_dir=str(  # noqa: E731
            tmp_path / f"cache_{m.__name__.split('.')[0]}"))
    else:
        root = fixtures.make_synthetic_hint(str(tmp_path / "hint"))
        make = lambda m: m.HIntHandImage(  # noqa: E731
            root, img_size=(32, 24), parts=["newdays"],
            cache_dir=str(tmp_path / f"cache_{m.__name__.split('.')[0]}"))
    port, jax_ds = make(pretrain), make(jpretrain)
    assert len(port) == len(jax_ds) > 0
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(len(port)):
            got, want = port[i], jax_ds[i]
            assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{name} item {i} epoch {epoch}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mode of the CLI for one epoch (2 steps) on the image folder."""
    base = tmp_path_factory.mktemp("pretrain")
    root = fixtures.make_synthetic_image_folder(str(base / "imgs"), n=8)
    cwd = os.getcwd()
    os.chdir(base)
    try:
        out = {mode: pretrain_ti.cli(["--exp", mode, "--mode", mode, "--data_root", root]
                                     + SMALL + (["--lora_rank", "2"] if mode == "tivit" else []))
               for mode in ("tivit", "dino", "ti")}
    finally:
        os.chdir(cwd)
    return base, out


@pytest.mark.parametrize("mode", ["tivit", "dino", "ti"])
def test_cli_runs_each_mode_and_writes_the_jax_keys(runs, mode):
    base, out = runs
    run = out[mode]
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
    ckpt = base / "checkpoints" / mode
    assert os.path.realpath(ckpt / "checkpoint") == str(ckpt / "checkpoint_1")
    payload = torch.load(ckpt / "checkpoint_1", weights_only=True)
    keys = {"tivit": {"params", "epoch"}, "dino": {"student", "teacher", "trans", "center",
                                                    "epoch"},
            "ti": {"trans", "epoch"}}[mode]
    assert set(payload) == keys and payload["epoch"] == 1
    if mode == "tivit":
        assert any(k.endswith("lora_A") for k in payload["params"])
        assert any(k.endswith("running_var") for k in payload["params"])


def test_cli_moves_only_each_stage_s_parameters(runs):
    """dino: only the student's MLPs move, the teacher is the EMA of the
    student and the centre moved; ti: only the group moves."""
    _, out = runs
    args = pretrain_ti.build_argparser().parse_args(["--exp", "x", "--mode", "dino",
                                                     "--data_root", "x"] + SMALL)
    fresh = pretrain_ti.dino_setup(args, torch.device("cpu"))
    dino, ti_run = out["dino"], out["ti"]
    start = dict(fresh["student"].named_parameters())
    moved = {n for n, p in dino["student"].named_parameters() if not torch.equal(p, start[n])}
    assert moved and moved == {n for n in start if dino_stage_mask(n)}
    for n, p in dino["trans"].named_parameters():
        assert torch.equal(p, dict(fresh["trans"].named_parameters())[n]), n
    assert not torch.equal(dino["center"], torch.zeros_like(dino["center"]))
    m = args.teacher_momentum
    for n, p in dino["teacher"].named_parameters():
        if n in moved:
            assert not torch.equal(p, start[n]), n
        else:  # two EMA steps towards an unchanged student parameter
            want = start[n].detach()
            for _ in range(2):
                want = want * m + (1 - m) * start[n].detach()
            assert torch.equal(p, want), n
    for n, p in ti_run["student"].named_parameters():
        assert torch.equal(p, start[n]), n
    trans_start = dict(fresh["trans"].named_parameters())
    assert all(not torch.equal(p, trans_start[n]) for n, p in ti_run["trans"].named_parameters()
               if n.endswith("weight"))


def test_init_ti_weights_is_seeded():
    args = pretrain_ti.build_argparser().parse_args(["--exp", "x", "--mode", "tivit",
                                                     "--data_root", "x"] + SMALL)
    a = pretrain_ti.tivit_setup(args, torch.device("cpu"))["model"]
    b = pretrain_ti.tivit_setup(args, torch.device("cpu"))["model"]
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    init_ti_weights(b, 1)
    assert not torch.equal(a.backbone.embeddings.cls_token, b.backbone.embeddings.cls_token)


def test_pretrain_refuses_a_larger_world(monkeypatch, tmp_path):
    """A world of more than one process is no longer refused (two ranks are
    held against JAX in ``tests/test_torch_pretrain_world.py``); what is
    left of the refusal: a ``WORLD_SIZE`` without the rest of torchrun's
    environment is no world to join, so the CLI runs alone, reading every
    image, and starts no process group."""
    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.chdir(tmp_path)
    root = fixtures.make_synthetic_image_folder(str(tmp_path / "imgs"), n=8)
    run = pretrain_ti.cli(["--exp", "x", "--mode", "ti", "--data_root", root] + SMALL)
    assert len(run["losses"]) == 2 and not torch.distributed.is_initialized()


@pytest.mark.parametrize("name", ["finetune", "pretrain_ti"])
def test_cli_arguments_and_defaults_are_jax_s(name):
    """Every option of the JAX CLI, with its default and choices; the port
    adds only ``--device`` (and ``--num_workers`` to ``pretrain_ti``)."""
    import importlib

    jax_cli = importlib.import_module(f"cs_vit_tpu.cli.{name}")
    port_cli = importlib.import_module(f"cs_vit_tpu_torch.cli.{name}")
    want = {a.dest: a for a in jax_cli.build_argparser()._actions if a.dest != "help"}
    got = {a.dest: a for a in port_cli.build_argparser()._actions if a.dest != "help"}
    extra = {"device"} | ({"num_workers"} if name == "pretrain_ti" else set())
    assert set(got) == set(want) | extra, set(got) ^ set(want)
    for dest, a in want.items():
        assert (got[dest].default, got[dest].choices, got[dest].required) == (
            a.default, a.choices, a.required), dest
