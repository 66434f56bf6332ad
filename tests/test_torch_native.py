"""Port parity: the host crop (``cs_vit_tpu_torch.native``, the C crop, and
``ops.resample``) against the JAX package's, and the device crop.

The port's C crop is built from its own copy of the JAX package's C source
with the same flags by the same compiler, so the two C crops are held bit
for bit, on axis-aligned and rotated corners, float32 and uint8 frames. With
both C crops switched off both packages take their numpy paths, which are
held exactly too.

The device crop (``ops.resample.crop_and_resize``, torch) is held against
JAX's ``crop_and_resize`` (``jnp``, f32): both compute the sample positions
in f32 from the same corners, but ``torch.linspace`` and ``jnp.linspace``
round some grid steps differently (by up to 6e-8), which moves a position by
up to an ulp of its coordinate, and a sample by that times the step between
neighbouring pixels: at most 1.0 for frames in [0,1], at the edge where the
zero padding starts. ``device_crop_tol`` allows two ulps of the largest
corner coordinate, plus four f32 ulps of 1.0 for the four-term sum. Each
package misses a float64 crop by about what they miss each other by (``-s``
prints the readings: 1.3e-5 apart, 1.1e-5 each from float64, on one CPU).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu import native as j_native
from cs_vit_tpu.ops import resample as jr
from cs_vit_tpu_torch import native
from cs_vit_tpu_torch.ops import resample as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (120, 160)


@pytest.fixture
def numpy_crops(monkeypatch):
    """Both packages' crops on their numpy paths."""
    monkeypatch.setattr(j_native, "crop_affine_bilinear_batch", lambda *a, **k: None)
    monkeypatch.setattr(native, "native_available", lambda: False)


def device_crop_tol(corners) -> float:
    """See the module docstring."""
    return 2 * float(np.spacing(np.abs(corners).max())) + 4 * float(np.spacing(np.float32(1)))


def frames(rng, n, dtype):
    imgs = rng.uniform(size=(n,) + HW + (3,))
    return (imgs * 255).astype(np.uint8) if dtype == np.uint8 else imgs.astype(dtype)


def rotated_corners(rng, n):
    """Square crops about random centres, turned by random angles, some
    reaching outside the frame."""
    c = rng.uniform(-10, 170, size=(n, 1, 2))
    half = rng.uniform(3, 60, size=(n, 1, 1))
    theta = rng.uniform(-np.pi, np.pi, size=(n, 1))
    unit = np.asarray([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)[None]
    cos, sin = np.cos(theta)[..., None], np.sin(theta)[..., None]
    turned = np.concatenate([unit[..., :1] * cos - unit[..., 1:] * sin,
                             unit[..., :1] * sin + unit[..., 1:] * cos], -1)
    return (c + half * turned).astype(np.float32)


def axis_corners(rng, n):
    c = rng.uniform(0, 160, size=(n, 2))
    s = rng.uniform(2, 80, size=(n, 2))
    return jr.bbox_to_corners(np.concatenate([c - s, c + s], 1).astype(np.float32))


def test_native_available_here():
    assert native.find_compiler() is not None  # this machine has cc
    assert native.native_available()


@pytest.mark.parametrize("corners", ["axis", "rotated"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("out_hw", [(32, 32), (24, 40), (1, 7)])
def test_c_crop_matches_jax_bit_for_bit(rng, dtype, corners, out_hw):
    imgs = frames(rng, 6, dtype)
    cs = (rotated_corners if corners == "rotated" else axis_corners)(rng, 6)
    got = tr.crop_and_resize_np(imgs, cs, out_hw)
    want = jr.crop_and_resize_np(imgs, cs, out_hw)
    assert got.dtype == want.dtype == np.float32 and got.shape == (6,) + out_hw + (3,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.crop_affine_bilinear_batch(imgs, cs, *out_hw),
        j_native.crop_affine_bilinear_batch(imgs, cs, *out_hw))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_numpy_paths_match_jax(rng, dtype, numpy_crops):
    imgs = frames(rng, 3, dtype)
    cs = rotated_corners(rng, 3)
    got = tr.crop_and_resize_np(imgs, cs, (24, 32))
    want = jr.crop_and_resize_np(imgs, cs, (24, 32))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_crop_with_square_box_matches_jax_bit_for_bit(rng):
    imgs = frames(rng, 4, np.uint8)
    c = rng.uniform(10, 110, size=(4, 2))
    s = rng.uniform(4, 40, size=(4, 2))
    b = np.concatenate([c - s, c + s], 1).astype(np.float32)
    for g, w in zip(tr.crop_with_square_box_np(imgs, b, 1.25, 32),
                    jr.crop_with_square_box_np(imgs, b, 1.25, 32)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_library_lands_in_build_dir_and_is_reused():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libfastcrop-")
    mtime = path.stat().st_mtime_ns
    assert native.build() == path and path.stat().st_mtime_ns == mtime  # not rebuilt
    assert native.load() is native.load()


def test_library_name_follows_the_source(tmp_path):
    cc = native.find_compiler()
    src = tmp_path / "fastcrop.c"
    src.write_bytes(native.SRC.read_bytes())
    same = native.library_path(cc, src, tmp_path)
    assert same == native.library_path(cc, native.SRC, tmp_path)
    src.write_bytes(native.SRC.read_bytes() + b"\n/* edited */\n")
    assert native.library_path(cc, src, tmp_path) != same


def test_a_source_that_fails_to_compile_raises(tmp_path):
    broken = tmp_path / "fastcrop.c"
    broken.write_text(native.SRC.read_text().replace("floor(sx)", "floor(sx", 1))
    with pytest.raises(RuntimeError, match="failed on"):
        native.load(broken, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_without_a_compiler_the_numpy_path_is_taken(rng, monkeypatch, tmp_path):
    monkeypatch.setattr(native, "find_compiler", lambda: None)
    assert native.build(native.SRC, tmp_path) is None
    monkeypatch.setattr(native, "_loaded", {})  # a process that has loaded nothing yet
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.crop_affine_bilinear_batch(frames(rng, 1, np.uint8), axis_corners(rng, 1), 4, 4)
    monkeypatch.setattr(j_native, "crop_affine_bilinear_batch", lambda *a, **k: None)
    imgs, cs = frames(rng, 2, np.uint8), rotated_corners(rng, 2)
    np.testing.assert_array_equal(tr.crop_and_resize_np(imgs, cs, (8, 8)),
                                  jr.crop_and_resize_np(imgs, cs, (8, 8)))


def test_importing_the_package_compiles_nothing():
    code = ("import cs_vit_tpu_torch.native as n, cs_vit_tpu_torch.ops.resample, "
            "cs_vit_tpu_torch.data\n"
            "import subprocess\n"
            "assert n._loaded == {}, n._loaded\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_c_crop_releases_the_interpreter_lock():
    """ctypes drops the lock around the call: while another thread is inside
    one long crop, this thread keeps running Python (with the lock held it
    would stall for the whole call, its longest gap as long as the call)."""
    import threading
    import time

    big = np.zeros((32, 480, 640, 3), np.uint8)
    cs = jr.bbox_to_corners(np.tile(np.asarray([[0, 0, 639, 479]], np.float32), (32, 1)))
    native.crop_affine_bilinear_batch(big[:1], cs[:1], 8, 8)  # built and loaded

    def attempt():
        span = []

        def crop():
            t0 = time.perf_counter()
            native.crop_affine_bilinear_batch(big, cs, 480, 640)
            span.append(time.perf_counter() - t0)

        t = threading.Thread(target=crop)
        stamps = [time.perf_counter()]
        t.start()
        while t.is_alive():
            stamps.append(time.perf_counter())
        t.join()
        return max(np.diff(stamps)), span[0]

    gaps = [attempt() for _ in range(3)]  # a busy host may stall this thread once
    assert any(gap < call / 2 for gap, call in gaps), gaps


@pytest.mark.parametrize("corners", ["axis", "rotated"])
def test_device_crop_matches_jax(rng, corners):
    imgs = frames(rng, 5, np.float32)
    cs = (rotated_corners if corners == "rotated" else axis_corners)(rng, 5)
    want = np.asarray(jr.crop_and_resize(jnp.asarray(imgs), jnp.asarray(cs), (24, 32)))
    got = tr.crop_and_resize(torch.from_numpy(imgs), torch.from_numpy(cs), (24, 32))
    assert got.dtype == torch.float32 and got.shape == (5, 24, 32, 3)
    err, tol = np.abs(got.numpy() - want).max(), device_crop_tol(cs)
    f64 = tr.crop_and_resize(torch.from_numpy(imgs.astype(np.float64)),
                             torch.from_numpy(cs.astype(np.float64)), (24, 32)).numpy()
    print(f"device crop vs JAX: {err:.3g} (tol {tol:.3g}); vs float64: port "
          f"{np.abs(got.numpy() - f64).max():.3g}, JAX {np.abs(want - f64).max():.3g}")
    assert err <= tol
