"""``parallel.device_prefetch`` on the CPU: the batches it yields, the train
step computed from them, errors, and its thread's lifetime.

On the CPU it neither pins memory nor uses streams (the card's path, pinned
staging and a side-stream copy, is checked on the H100 by ``chip_smoke.py``
phase ``datasets``). With ``patches_dtype=torch.bfloat16`` the patches are
cast on the host, which rounds to nearest even as the bf16 train step's own
cast does, so the step from a prefetched batch is held bit for bit against
the step from ``cli.common.batch_to_device``'s f32 batch.
"""

import copy
import threading
import time

import numpy as np
import pytest
import torch

from cs_vit_tpu_torch.cli.common import batch_to_device, build_model
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.data import DataLoader
from cs_vit_tpu_torch.models import init_poser_weights
from cs_vit_tpu_torch.parallel import device_prefetch, host_stage
from cs_vit_tpu_torch.train import TrainState, build_optimizer, make_train_step

B, T, S = 4, 1, 32


def host_batch(rng, with_paths=True):
    x0 = rng.uniform(20, 60, size=(B, T, 1)).astype(np.float32)
    side = rng.uniform(60, 120, size=(B, T, 1)).astype(np.float32)
    jc = rng.normal(scale=30, size=(B, T, 21, 3)).astype(np.float32)
    jc[..., 2] += 500
    b = {
        "patches": rng.uniform(size=(B, T, S, S, 3)).astype(np.float32),
        "square_bboxes": np.concatenate([x0, x0, x0 + side, x0 + side], -1),
        "timestamp": np.zeros((B, T), np.float32),
        "focal": np.full((B, T, 2), 240.0, np.float32),
        "princpt": np.full((B, T, 2), 80.0, np.float32),
        "joint_cam": jc,
        "joint_rel": jc - jc[:, :, :1],
        "joint_img": rng.uniform(20, 140, size=(B, T, 21, 2)).astype(np.float32),
        "joint_valid": np.ones((B, T, 21), np.float32),
        "mano_pose": rng.normal(scale=0.3, size=(B, T, 48)).astype(np.float32),
        "mano_shape": rng.normal(scale=0.5, size=(B, T, 10)).astype(np.float32),
        "rot_rad": np.zeros((B, T), np.float32),
    }
    if with_paths:
        b["imgs_path"] = [[f"{i}.jpg"] for i in range(B)]
        b["flip"] = [False] * B
    return b


def test_prefetched_batches_are_batch_to_device_cast_to_bf16(rng):
    host = [host_batch(rng) for _ in range(5)]
    got = list(device_prefetch(iter(host), "cpu", depth=2, patches_dtype=torch.bfloat16))
    assert len(got) == 5
    for g, h in zip(got, host):
        want = batch_to_device(h, torch.device("cpu"))
        assert sorted(g) == sorted(want)  # imgs_path and flip dropped
        for k, w in want.items():
            if k == "patches":
                w = w.to(torch.bfloat16)
            assert g[k].dtype == w.dtype and g[k].device.type == "cpu", k
            assert torch.equal(g[k].view(torch.int16) if k == "patches" else g[k],
                               w.view(torch.int16) if k == "patches" else w), k
            assert not g[k].is_pinned()


def test_f32_prefetch_is_batch_to_device(rng):
    h = host_batch(rng)
    (got,) = list(device_prefetch([h], "cpu"))
    for k, w in batch_to_device(h, torch.device("cpu")).items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_host_stage_casts_only_the_patches(rng):
    staged = host_stage(host_batch(rng), pin=False, patches_dtype=torch.bfloat16)
    assert staged["patches"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for k, v in staged.items() if k != "patches")
    assert "imgs_path" not in staged and "flip" not in staged


def test_train_step_from_a_prefetched_batch_is_bit_identical(rng):
    cfg = FinetuneConfig(exp="pf", backbone="test", img_size=S, phase="spatial",
                         batch_size=B, dtype="bfloat16")
    model = build_model(cfg)
    init_poser_weights(model, 0)
    h = host_batch(rng)
    runs = []
    for batch in (batch_to_device(h, torch.device("cpu")),
                  next(iter(device_prefetch([h], "cpu", patches_dtype=torch.bfloat16)))):
        m = copy.deepcopy(model)
        opt = build_optimizer(m, "spatial", lambda step: 1e-3)
        state = TrainState.create(m, opt)
        step = make_train_step(m, opt, "spatial", compute_dtype=torch.bfloat16)
        state, metrics = step(state, batch, torch.Generator().manual_seed(7))
        runs.append((metrics, {k: v.clone() for k, v in m.state_dict().items()}))
    (m0, sd0), (m1, sd1) = runs
    assert np.isfinite(float(m0["loss"]))
    for k in ("loss", "grad_norm"):
        assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
    assert torch.equal(m0["joint_cam_pred"], m1["joint_cam_pred"])
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


def test_an_error_in_the_loader_reaches_the_consumer(rng):
    def batches():
        yield host_batch(rng)
        yield host_batch(rng)
        raise OSError("frame 17 is unreadable")

    got = []
    with pytest.raises(OSError, match="frame 17"):
        for b in device_prefetch(batches(), "cpu"):
            got.append(b)
    assert len(got) == 2


def test_an_item_error_through_the_loader_reaches_the_consumer():
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, ix):
            if ix == 4:
                raise ValueError("item 4 is broken")
            return {"patches": np.zeros((1, 2, 2, 3), np.float32)}

    loader = DataLoader(Broken(), 2, shuffle=False, num_workers=2)
    with pytest.raises(ValueError, match="item 4 is broken"):
        list(device_prefetch(loader, "cpu"))


def test_staging_runs_at_most_depth_ahead_and_stops_with_the_consumer(rng):
    made = []
    template = host_batch(rng, with_paths=False)

    def batches():
        for i in range(100):
            made.append(i)
            yield template

    before = {t.ident for t in threading.enumerate()}
    gen = device_prefetch(batches(), "cpu", depth=2)
    next(gen)
    time.sleep(0.2)
    # one handed out, `depth` queued, one staged and waiting to be queued
    assert len(made) <= 1 + 2 + 1, len(made)
    gen.close()  # the consumer stops early: the staging thread ends
    deadline = time.monotonic() + 10
    while {t.ident for t in threading.enumerate()} - before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not {t.ident for t in threading.enumerate()} - before
    assert len(made) < 10
