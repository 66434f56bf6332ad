"""Port parity: ``cs_vit_tpu_torch.utils`` (misc, profiling, vis) against
``cs_vit_tpu.utils``, and the finetune loop's reprojection image.

* ``calculate_gradient_norm`` keeps the reference's quirk (sum of squares
  x 0.5 with ``compat=True``) and gives the true norm otherwise, on
  ``tests/test_misc_components.py``'s grads and on a nested tree of
  tensors against the JAX function on the same arrays.
* The memory stats count the same bytes and leaves as JAX's.
* ``trace`` writes a Chrome trace on the CPU that holds an ``annotate``
  span.
* The drawings are JAX's bit for bit: same colours, thicknesses, tile order.
* ``cli.finetune`` logs ``train/reprojection`` on a logging step, built
  from the first min(4, batch) rows, through a stub writer.
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.utils import misc as jmisc
from cs_vit_tpu.utils import vis as jvis
from cs_vit_tpu_torch import utils
from cs_vit_tpu_torch.cli import finetune
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.data.fixtures import make_synthetic_dexycb
from cs_vit_tpu_torch.utils import misc, vis
from cs_vit_tpu_torch.utils.logging import TBLogger


def test_gradient_norm_quirk():
    grads = {"a": torch.tensor([3.0, 4.0])}  # L2 norm 5, squared 25
    assert np.isclose(utils.calculate_gradient_norm(grads, compat=True), 12.5)
    assert np.isclose(utils.calculate_gradient_norm(grads, compat=False), 5.0)
    stats = utils.stat_tree_memory(grads)
    assert stats["num_arrays"] == 1 and stats["total_bytes"] == 8


@pytest.mark.parametrize("compat", [True, False])
def test_gradient_norm_and_memory_match_jax(compat):
    rng = np.random.default_rng(0)
    arrays = {"w": rng.normal(size=(4, 5)).astype(np.float32),
              "blocks": [{"b": rng.normal(size=(7,)).astype(np.float32)},
                         rng.normal(size=(2, 3, 2)).astype(np.float32)]}
    torch_tree = {"w": torch.from_numpy(arrays["w"]),
                  "blocks": [{"b": torch.from_numpy(arrays["blocks"][0]["b"])},
                             arrays["blocks"][1]]}  # a numpy leaf among tensors
    jax_tree = {"w": jnp.asarray(arrays["w"]),
                "blocks": [{"b": jnp.asarray(arrays["blocks"][0]["b"])},
                           jnp.asarray(arrays["blocks"][1])]}
    got = misc.calculate_gradient_norm(torch_tree, compat=compat)
    want = jmisc.calculate_gradient_norm(jax_tree, compat=compat)
    assert got == pytest.approx(want, rel=1e-6)
    assert misc.stat_tree_memory(torch_tree) == jmisc.stat_tree_memory(jax_tree)
    assert misc.get_array_memory(torch_tree["w"]) == jmisc.get_array_memory(jax_tree["w"])


def test_brief_dict_and_to_tuple_match_jax():
    tree = {"x": torch.zeros(2, 3), "n": 3, "none": None, "sub": {"s": "a"}, "obj": object}
    jtree = {**tree, "x": np.zeros((2, 3), np.float32)}
    outs = []
    for fn, t in ((misc.brief_dict, tree), (jmisc.brief_dict, jtree)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(t)
        outs.append(buf.getvalue().replace("Tensor", "array").replace("ndarray", "array"))
    assert outs[0] == outs[1]
    assert misc.to_tuple(3) == jmisc.to_tuple(3) == (3, 3)
    assert misc.to_tuple((1, 2)) == (1, 2)


def test_trace_writes_an_annotated_chrome_trace(tmp_path):
    with utils.trace(str(tmp_path / "trace")) as prof:
        with utils.annotate("csvit_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.trace_path and os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "csvit_span" in names
    assert any("mm" in str(n) for n in names)


def _drawing_inputs(seed, K=2, T=2, S=32):
    rng = np.random.default_rng(seed)
    patches = rng.uniform(size=(K, T, S, S, 3)).astype(np.float32)
    boxes = np.tile(np.asarray([100.0, 80.0, 164.0, 144.0], np.float32), (K, T, 1))
    boxes += rng.uniform(-5, 5, size=(K, T, 1)).astype(np.float32)
    focal = np.full((K, T, 2), 500.0, np.float32)
    princpt = np.tile(np.asarray([128.0, 112.0], np.float32), (K, T, 1))
    joint_cam = rng.normal(scale=20.0, size=(K, T, 21, 3)).astype(np.float32)
    joint_cam[..., 2] += 600.0
    gt2d = rng.uniform(95, 170, size=(K, T, 21, 2)).astype(np.float32)
    return patches, boxes, focal, princpt, joint_cam, gt2d


@pytest.mark.parametrize("with_gt", [True, False])
def test_drawings_match_jax_bit_for_bit(with_gt):
    patches, boxes, focal, princpt, joint_cam, gt2d = _drawing_inputs(1)
    gt = gt2d if with_gt else None
    got = vis.training_reprojection_image(patches, boxes, focal, princpt, joint_cam, gt)
    want = jvis.training_reprojection_image(patches, boxes, focal, princpt, joint_cam, gt)
    assert got.shape == (32, 4 * 32, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    grid = vis.reprojection_grid(patches[0], boxes[0], gt2d[0])
    np.testing.assert_array_equal(grid, jvis.reprojection_grid(patches[0], boxes[0], gt2d[0]))
    for color in ("blue", "white", "nonsense"):
        a = vis.draw_hands_on_image_batch(patches[0], gt2d[0] - 100, [(0, 1), (1, 2)], color,
                                          color)
        b = jvis.draw_hands_on_image_batch(patches[0], gt2d[0] - 100, [(0, 1), (1, 2)], color,
                                           color)
        np.testing.assert_array_equal(a, b)


class _StubWriter:
    def __init__(self):
        self.images, self.scalars = [], []

    def add_scalar(self, name, value, step):
        self.scalars.append((name, value, step))

    def add_image(self, name, img, step, dataformats):
        self.images.append((name, np.array(img), step, dataformats))

    def close(self):
        pass


def test_finetune_logs_the_reprojection_image(tmp_path, monkeypatch):
    writers = []

    class StubTB(TBLogger):
        def __init__(self, log_dir, enabled=True):
            self.writer = _StubWriter() if enabled and log_dir else None
            writers.append(self.writer)

    monkeypatch.setattr(finetune, "TBLogger", StubTB)
    logged = []
    real = finetune.reprojection_image

    def spy(batch, metrics, cfg):
        grid = real(batch, metrics, cfg)
        logged.append((vis.training_reprojection_image(
            batch["patches"][:4].float().numpy(), batch["square_bboxes"][:4].numpy(),
            batch["focal"][:4].numpy(), batch["princpt"][:4].numpy(),
            metrics["joint_cam_pred"][:4].numpy(), batch["joint_img"][:4].numpy()), grid))
        return grid

    monkeypatch.setattr(finetune, "reprojection_image", spy)
    root = make_synthetic_dexycb(str(tmp_path / "dexycb"), seq_len=6)
    cfg = FinetuneConfig(exp="vis", epoch=1, backbone="test", data=["dexycb"], seq_len=2,
                         batch_size=4, phase="spatial", temporal_supervision="full",
                         img_size=32, lr_scheduler="constant", num_workers=0,
                         dexycb_root=root)
    with contextlib.redirect_stdout(io.StringIO()):
        state = finetune.main(cfg, ckpt_root=str(tmp_path / "ckpt"), log_every=1, device="cpu")
    images = writers[0].images
    assert state.step >= 2 and len(images) == state.step
    for (name, img, step, fmt), (want, grid) in zip(images, logged):
        assert name == "train/reprojection" and fmt == "HWC"
        assert img.shape == (32, 4 * 32, 3) and 0.0 <= img.min() and img.max() <= 1.0
        np.testing.assert_array_equal(img, want)
        np.testing.assert_array_equal(img, grid)
    assert [s for _, _, s, _ in images] == sorted({s for _, _, s, _ in images})
