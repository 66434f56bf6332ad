"""Port parity: ``ops.heatmap``, ``core.joints`` reordering, the MANO asset
helpers ``save_mano_pkl``/``fix_left_shapedirs`` and ``data.mano_gt``
against the JAX package.

Tolerances:
- ``soft_argmax_2d``/``_3d``: f32 softmax and sums over the grid in another
  order than XLA's; the expected coordinate (up to the grid size G) is held
  to 4e-6 G, some 30 f32 ulps of the coordinate.
- ``distort_projection_fisheye``: the same f32 formula element by element;
  1e-6 relative plus 1e-4 px (arctan and the powers of theta round by an ulp
  or two differently in torch and XLA).
- ``ManoGTSynthesizer``: the torch LBS against the ``jnp`` one, 1e-6 m as
  ``tests/test_torch_mano.py`` holds the two ``ManoLayer``s; the projected
  ``joint_img`` to that micrometre through the pinhole (focal 240 px at
  depths of at least 0.4 m: 600 px a metre, plus the x/z term) 1e-3 px. The
  pose and shape it hands back are the same numpy/scipy arithmetic: exact.
- Everything numpy (``gen_trans_from_patch``, ``apply_affine``, the
  reorder indices, the MANO pickle, ``fix_left_shapedirs``): exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from cs_vit_tpu.constants import (
    HO3D_JOINTS_ORDER,
    IH26M_RJOINTS_ORDER,
    MANO_JOINTS_ORDER,
    TARGET_JOINTS_ORDER,
)
from cs_vit_tpu.core import joints as jj
from cs_vit_tpu.data.mano_gt import ManoGTSynthesizer as JManoGTSynthesizer
from cs_vit_tpu.mano import assets as ja
from cs_vit_tpu.ops import heatmap as jh
from cs_vit_tpu_torch.core import joints as tj
from cs_vit_tpu_torch.data.mano_gt import ManoGTSynthesizer
from cs_vit_tpu_torch.mano import (
    fix_left_shapedirs,
    load_mano_pkl,
    save_mano_pkl,
    synthetic_assets,
)
from cs_vit_tpu_torch.ops import heatmap as th

MANO_TOL, PIX_TOL = 1e-6, 1e-3


@pytest.mark.parametrize("shape", [(2, 21, 64, 48), (1, 3, 8, 8)])
def test_soft_argmax_2d_matches_jax(rng, shape):
    hm = (rng.normal(size=shape) * 3).astype(np.float32)
    got = th.soft_argmax_2d(torch.from_numpy(hm)).numpy()
    want = np.asarray(jh.soft_argmax_2d(jnp.asarray(hm)))
    assert got.shape == want.shape == shape[:2] + (2,)
    assert np.abs(got - want).max() <= 4e-6 * max(shape[2:])


def test_soft_argmax_3d_matches_jax(rng):
    hm = (rng.normal(size=(2, 5, 8, 16, 12)) * 3).astype(np.float32)
    got = th.soft_argmax_3d(torch.from_numpy(hm)).numpy()
    want = np.asarray(jh.soft_argmax_3d(jnp.asarray(hm)))
    assert got.shape == want.shape == (2, 5, 3)
    assert np.abs(got - want).max() <= 4e-6 * 16
    # a sharp peak lands on its cell
    peak = np.full((1, 1, 8, 16, 12), -50.0, np.float32)
    peak[0, 0, 3, 11, 7] = 50.0
    np.testing.assert_allclose(th.soft_argmax_3d(torch.from_numpy(peak)).numpy()[0, 0],
                               [7, 11, 3], atol=1e-4)


def test_fisheye_projection_matches_jax(rng):
    pts = np.stack([rng.uniform(-0.2, 0.2, (3, 21)), rng.uniform(-0.2, 0.2, (3, 21)),
                    rng.uniform(0.3, 0.8, (3, 21))], -1).astype(np.float32)
    focal = rng.uniform(200, 600, (3, 2)).astype(np.float32)
    princpt = rng.uniform(100, 300, (3, 2)).astype(np.float32)
    D = rng.normal(scale=0.05, size=(3, 4)).astype(np.float32)
    args = (pts, focal, princpt, D)
    got = th.distort_projection_fisheye(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jh.distort_projection_fisheye(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("inv", [False, True])
def test_patch_transform_matches_jax(rng, inv):
    for _ in range(4):
        a = (*rng.uniform(50, 150, 2), *rng.uniform(40, 120, 2), 48, 64,
             float(rng.uniform(0.8, 1.2)), float(rng.uniform(-60, 60)))
        got = th.gen_trans_from_patch(*a, inv=inv)
        np.testing.assert_array_equal(got, jh.gen_trans_from_patch(*a, inv=inv))
        pts = rng.uniform(0, 200, (7, 2)).astype(np.float32)
        np.testing.assert_array_equal(th.apply_affine(pts, got), jh.apply_affine(pts, got))


@pytest.mark.parametrize("origin", [HO3D_JOINTS_ORDER, IH26M_RJOINTS_ORDER])
def test_reorder_joints_matches_jax(rng, origin):
    idx = tj.reorder_indices(tuple(origin), TARGET_JOINTS_ORDER)
    np.testing.assert_array_equal(idx, jj.reorder_indices(tuple(origin), TARGET_JOINTS_ORDER))
    assert idx.dtype == np.int32
    joints = rng.normal(size=(2, 3, 21, 3)).astype(np.float32)
    got = tj.reorder_joints(torch.from_numpy(joints), origin, TARGET_JOINTS_ORDER)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jj.reorder_joints(jnp.asarray(joints), origin,
                                                  TARGET_JOINTS_ORDER)))
    with pytest.raises(ValueError, match="same length"):
        tj.reorder_indices(tuple(origin), tuple(MANO_JOINTS_ORDER))
    with pytest.raises(ValueError, match="same joints"):
        tj.reorder_indices(tuple(origin), tuple(origin[:-1]) + ("Nowhere",))


def test_save_mano_pkl_round_trips(tmp_path):
    assets = synthetic_assets(seed=3, is_rhand=False)
    path = save_mano_pkl(assets, str(tmp_path / "MANO_LEFT.pkl"))
    back = load_mano_pkl(path, is_rhand=False)
    for f in dataclasses.fields(assets):
        if f.name == "synthetic":
            assert back.synthetic is False
            continue
        np.testing.assert_array_equal(np.asarray(getattr(back, f.name)),
                                      np.asarray(getattr(assets, f.name)), err_msg=f.name)
    # the JAX package writes the same bytes from the same assets
    ja.save_mano_pkl(ja.synthetic_assets(seed=3, is_rhand=False), str(tmp_path / "jax.pkl"))
    assert (tmp_path / "jax.pkl").read_bytes() == (tmp_path / "MANO_LEFT.pkl").read_bytes()


@pytest.mark.parametrize("similar", [True, False])
def test_fix_left_shapedirs_matches_jax(similar):
    right, jright = synthetic_assets(seed=0), ja.synthetic_assets(seed=0)
    left, jleft = synthetic_assets(seed=1, is_rhand=False), ja.synthetic_assets(seed=1,
                                                                             is_rhand=False)
    if similar:  # the smplx issue #48 case: the first shape column matches the right's
        left = dataclasses.replace(left, shapedirs=right.shapedirs.copy())
        jleft = dataclasses.replace(jleft, shapedirs=jright.shapedirs.copy())
    got, want = fix_left_shapedirs(left, right), ja.fix_left_shapedirs(jleft, jright)
    np.testing.assert_array_equal(got.shapedirs, want.shapedirs)
    flipped = not np.array_equal(got.shapedirs, left.shapedirs)
    assert flipped == similar
    if similar:
        np.testing.assert_array_equal(got.shapedirs[:, 0], -left.shapedirs[:, 0])


@pytest.mark.parametrize("flip,rotated", [(False, False), (False, True), (True, True)])
def test_mano_gt_synthesizer_matches_jax(flip, rotated):
    rng = np.random.default_rng(9)
    param = {"pose": rng.normal(scale=0.3, size=48), "shape": rng.normal(scale=0.5, size=10),
             "trans": [0.02, -0.01, 0.5]}
    cam = {"R": np.eye(3), "t": np.zeros(3), "focal": [240.0, 240.0], "princpt": [80.0, 60.0]}
    if rotated:
        cam["R"] = Rotation.from_euler("y", 0.4).as_matrix()
        cam["t"] = np.asarray([0.01, 0.0, 0.02])
    kw = dict(do_flip=flip, img_shape=(120, 160))
    got = ManoGTSynthesizer(synthetic_assets(seed=0))(param, cam, **kw)
    want = JManoGTSynthesizer(ja.synthetic_assets(seed=0))(param, cam, **kw)
    names = ("joint_img", "joints", "mesh", "pose", "shape")
    tols = {"joint_img": PIX_TOL, "joints": MANO_TOL, "mesh": MANO_TOL, "pose": 0, "shape": 0}
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=tols[name], err_msg=name)
