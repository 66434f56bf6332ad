"""Port parity: cs_vit_tpu_torch.mano against the JAX package.

``synthetic_assets`` must draw the very same numbers (bit for bit), the pkl
loader must read what the JAX package writes, and the f32 LBS must agree
with JAX ``ManoLayer`` to 1e-6 m (1 um: f32 rounding of sums over 778
vertices at 0.1 m scale).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.mano import ManoLayer as JManoLayer
from cs_vit_tpu.mano import sh_joint_regressor as j_sh_joint_regressor
from cs_vit_tpu.mano import synthetic_assets as j_synthetic_assets
from cs_vit_tpu.mano.assets import save_mano_pkl
from cs_vit_tpu_torch.mano import (
    ManoLayer,
    find_and_load,
    load_mano_pkl,
    sh_joint_regressor,
    synthetic_assets,
)


def _assert_assets_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("seed,is_rhand", [(0, True), (1, True), (1, False)])
def test_synthetic_assets_bit_identical(seed, is_rhand):
    _assert_assets_equal(
        synthetic_assets(seed=seed, is_rhand=is_rhand),
        j_synthetic_assets(seed=seed, is_rhand=is_rhand),
    )


def test_sh_joint_regressor_identical():
    assets = synthetic_assets(seed=1)
    np.testing.assert_array_equal(
        sh_joint_regressor(assets), j_sh_joint_regressor(j_synthetic_assets(seed=1))
    )


def test_pkl_loader_reads_reference_layout(tmp_path, monkeypatch):
    path = save_mano_pkl(j_synthetic_assets(seed=3), str(tmp_path / "MANO_RIGHT.pkl"))
    loaded = load_mano_pkl(path)
    ref = j_synthetic_assets(seed=3)
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
                 "hands_mean", "hands_components", "parents", "faces"):
        np.testing.assert_array_equal(getattr(loaded, name), getattr(ref, name), err_msg=name)
    assert not loaded.synthetic
    monkeypatch.setenv("MANO_MODEL_DIR", str(tmp_path))
    assert not find_and_load().synthetic
    monkeypatch.delenv("MANO_MODEL_DIR")
    assert find_and_load().synthetic
    with pytest.raises(FileNotFoundError):
        find_and_load(allow_synthetic=False)


@pytest.mark.parametrize("flat_hand_mean", [False, True])
def test_mano_layer_matches_jax(rng, flat_hand_mean):
    B = 5
    betas = rng.normal(size=(B, 10)).astype(np.float32)
    orient = rng.normal(scale=0.5, size=(B, 3)).astype(np.float32)
    pose = rng.normal(scale=0.3, size=(B, 45)).astype(np.float32)
    transl = rng.normal(scale=0.1, size=(B, 3)).astype(np.float32)
    want = JManoLayer(j_synthetic_assets(seed=1), flat_hand_mean=flat_hand_mean)(
        jnp.asarray(betas), jnp.asarray(orient), jnp.asarray(pose), jnp.asarray(transl)
    )
    layer = ManoLayer(synthetic_assets(seed=1), flat_hand_mean=flat_hand_mean)
    assert len(layer.state_dict()) == 0  # MANO tensors are non-persistent buffers
    got = layer(*(torch.from_numpy(a) for a in (betas, orient, pose, transl)))
    for key in ("vertices", "joints"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-6, rtol=0)
