"""Port parity: cs_vit_tpu_torch.core.{geometry,joints} against the JAX package.

Same numpy inputs (seeded) go through both; f32 everywhere. Tolerance 1e-5
absolute: both sides evaluate the same branch-free formulas, so only f32
rounding of a handful of ops differs (values are O(1) rotations / angles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.constants import TARGET_JOINTS_CONNECTION
from cs_vit_tpu.core import geometry as jgeo
from cs_vit_tpu.core.joints import mean_connection_length as j_mcl
from cs_vit_tpu_torch.core import geometry as tgeo
from cs_vit_tpu_torch.core.joints import mean_connection_length as t_mcl

ATOL = 1e-5


def _rotations(rng, n):
    aa = rng.normal(size=(n, 3))
    aa = aa / np.linalg.norm(aa, axis=-1, keepdims=True) * rng.uniform(0.0, 3.0, (n, 1))
    return np.asarray(jgeo.axis_angle_to_matrix(jnp.asarray(aa, jnp.float32)))


def _inputs(name, rng):
    n = 64
    if name in ("rotation_6d_to_matrix",):
        return rng.normal(size=(4, n // 4, 6)).astype(np.float32)
    if name in ("matrix_to_quaternion", "matrix_to_axis_angle", "matrix_to_rotation_6d"):
        return _rotations(rng, n).astype(np.float32)
    if name in ("quaternion_to_matrix", "quaternion_to_axis_angle", "standardize_quaternion"):
        return rng.normal(size=(n, 4)).astype(np.float32)
    if name in ("axis_angle_to_quaternion", "axis_angle_to_matrix"):
        aa = rng.normal(size=(n, 3)).astype(np.float32)
        aa[0] = 0.0  # the zero-angle branch
        return aa
    if name in ("rotation_matrix_x", "rotation_matrix_z", "rotation_matrix_y"):
        return rng.uniform(-np.pi, np.pi, size=(3, n // 3)).astype(np.float32)
    if name == "safe_norm":
        x = rng.normal(size=(n, 3)).astype(np.float32)
        x[:4] = 0.0
        return x
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "rotation_6d_to_matrix", "matrix_to_rotation_6d", "standardize_quaternion",
    "matrix_to_quaternion", "quaternion_to_matrix", "quaternion_to_axis_angle",
    "axis_angle_to_quaternion", "axis_angle_to_matrix", "matrix_to_axis_angle",
    "rotation_matrix_x", "rotation_matrix_z", "rotation_matrix_y", "safe_norm",
])
def test_geometry_matches_jax(rng, name):
    x = _inputs(name, rng)
    want = np.asarray(getattr(jgeo, name)(jnp.asarray(x)))
    got = getattr(tgeo, name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_rotation_matrix_y_textbook_fill(rng):
    x = _inputs("rotation_matrix_y", rng)
    want = np.asarray(jgeo.rotation_matrix_y(jnp.asarray(x), compat=False))
    got = tgeo.rotation_matrix_y(torch.from_numpy(x), compat=False).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the compat fill differs from the textbook one (the quirk is kept on)
    assert not np.allclose(tgeo.rotation_matrix_y(torch.from_numpy(x)).numpy(), got)


def test_mean_connection_length_matches_jax(rng):
    joints = rng.normal(scale=0.05, size=(3, 5, 21, 3)).astype(np.float32)
    want = np.asarray(j_mcl(jnp.asarray(joints), TARGET_JOINTS_CONNECTION))
    got = t_mcl(torch.from_numpy(joints), TARGET_JOINTS_CONNECTION).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
