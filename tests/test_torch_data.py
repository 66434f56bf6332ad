"""Port parity: the host data pipeline (``cs_vit_tpu_torch.ops.resample``'s
host crop, ``data.transforms_np``, ``data.base``, ``data.dexycb``,
``data.fixtures``) against the JAX package's modules on the same inputs.

Both are numpy code over the same C crop (each package builds its own copy
of ``fastcrop.c`` with the same flags), so every result is held exactly.
With both C crops switched off (``numpy_crops``) both packages take their
numpy paths, and every field is held exactly again.

One case compares the two paths on purpose: the port's C crop against the
JAX package's numpy crop. The C crop computes the sample position from f32
corners in a different order than the numpy path's float64 ``linspace``
grid, and folds the uint8 1/255 into the interpolation. A crop then differs
by the rounding of the position (a few half-ulp roundings of a coordinate up
to the frame's longer side) times the largest step between neighbouring
pixels (1.0 for these noise frames): ``patch_tol`` allows two ulps of the
longer side, 3.05e-5 at 160 pixels (``-s`` prints the reading of
``test_c_crop_against_numpy_crop``: 2.4e-6 on one CPU). The augmented train
crops then pass the photometric augmentation, whose colour jitter scales a
difference by at most 1.2 x 1.2 x 1.4 (brightness, contrast, saturation)
before the hue turn: they get four times that.
"""

import os

import h5py
import numpy as np
import pytest

from cs_vit_tpu import native as j_native
from cs_vit_tpu.data import DataLoader as JDataLoader
from cs_vit_tpu.data import DexYCB as JDexYCB
from cs_vit_tpu.data import transforms_np as jt
from cs_vit_tpu.data.fixtures import make_synthetic_dexycb as j_make_synthetic_dexycb
from cs_vit_tpu.ops import resample as jr
from cs_vit_tpu_torch.data import ConcatDataset, DataLoader, DexYCB, collate
from cs_vit_tpu_torch.data import transforms_np as tt
from cs_vit_tpu_torch.data.fixtures import make_synthetic_dexycb, synthetic_dexycb_sequences
from cs_vit_tpu_torch import native as t_native
from cs_vit_tpu_torch.ops import resample as tr

IMG = 32
FIXTURE_HW = (120, 160)
# the photometric augmentation's largest scaling of a crop difference
# (brightness 1.2, contrast 1.2, saturation 1.2 + 0.2), rounded up
AUG_GAIN = 4.0


def patch_tol(hw) -> float:
    """Two f32 ulps of the frame's longer side (see the module docstring)."""
    return 2 * float(np.spacing(np.float32(max(hw))))


@pytest.fixture
def jax_numpy_crops(monkeypatch):
    """The JAX package's crops on its own numpy path (its C crop reports
    itself unavailable)."""
    monkeypatch.setattr(j_native, "crop_affine_bilinear_batch", lambda *a, **k: None)


@pytest.fixture
def numpy_crops(monkeypatch, jax_numpy_crops):
    """Both packages' crops on their numpy paths."""
    monkeypatch.setattr(t_native, "native_available", lambda: False)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    return {
        "port": make_synthetic_dexycb(str(base / "port"), seq_len=6),
        "jax": j_make_synthetic_dexycb(str(base / "jax"), seq_len=6),
    }


def assert_items_equal(got, want, tol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        if k in ("imgs_path", "flip"):
            assert got[k] == want[k], k
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "patches":
            assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max(), tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def frames(rng, n=3, hw=FIXTURE_HW, dtype=np.uint8):
    imgs = rng.uniform(size=(n,) + tuple(hw) + (3,))
    return (imgs * 255).astype(np.uint8) if dtype == np.uint8 else imgs.astype(dtype)


def boxes(rng, n=3, hw=FIXTURE_HW):
    c = rng.uniform(10, min(hw) - 10, size=(n, 2))
    s = rng.uniform(4, 40, size=(n, 2))
    return np.concatenate([c - s, c + s], axis=1).astype(np.float32)


# --- ops/resample.py ---------------------------------------------------------


def test_sample_coords_and_gather_match_jax(rng):
    corners = rng.uniform(-20, 170, size=(4, 2)).astype(np.float32)
    grid = tr._sample_coords(corners, 24, 32)
    np.testing.assert_array_equal(grid, jr._sample_coords(corners, 24, 32, np))
    img = frames(rng, 1, dtype=np.float32)[0]
    np.testing.assert_array_equal(tr._bilinear_gather_np(img, grid),
                                  jr._bilinear_gather_np(img, grid))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_crop_and_resize_np_matches_jax(rng, dtype):
    imgs = frames(rng, dtype=dtype)
    corners = rng.uniform(-20, 170, size=(3, 4, 2)).astype(np.float32)
    got = tr.crop_and_resize_np(imgs, corners, (24, 32))
    want = jr.crop_and_resize_np(imgs, corners, (24, 32))
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 24, 32, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_c_crop_against_numpy_crop(rng, dtype, jax_numpy_crops):
    """The port's C crop against the JAX package's numpy crop (see the module
    docstring)."""
    imgs = frames(rng, dtype=dtype)
    corners = rng.uniform(-20, 170, size=(3, 4, 2)).astype(np.float32)
    got = tr.crop_and_resize_np(imgs, corners, (24, 32))
    want = jr.crop_and_resize_np(imgs, corners, (24, 32))
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 24, 32, 3)
    print(f"{np.dtype(dtype).name}: C crop vs numpy crop {np.abs(got - want).max():.3g}")
    assert 0 < np.abs(got - want).max() <= patch_tol(FIXTURE_HW)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_crop_and_resize_np_matches_jax_numpy_path(rng, dtype, numpy_crops):
    imgs = frames(rng, dtype=dtype)
    corners = rng.uniform(-20, 170, size=(3, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(tr.crop_and_resize_np(imgs, corners, (24, 32)),
                                  jr.crop_and_resize_np(imgs, corners, (24, 32)))


def test_bbox_helpers_match_jax(rng):
    b = boxes(rng, 5)
    for ratio in (1.0, 1.25, 2.0):
        np.testing.assert_array_equal(tr.expand_bbox_square(b, ratio),
                                      jr.expand_bbox_square(b, ratio))
    np.testing.assert_array_equal(tr.bbox_to_corners(b), jr.bbox_to_corners(b))
    np.testing.assert_array_equal(tr.bbox_to_corners(b[None]), jr.bbox_to_corners(b[None]))


def test_crop_with_square_box_np_matches_jax(rng):
    imgs, b = frames(rng), boxes(rng)
    got = tr.crop_with_square_box_np(imgs, b, 1.25, IMG)
    want = jr.crop_with_square_box_np(imgs, b, 1.25, IMG)
    for g, w in zip(got, want):  # patches, scales, square boxes
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# --- data/transforms_np.py -------------------------------------------------------


def test_rotation_helpers_match_jax(rng):
    rad = rng.uniform(-np.pi, np.pi, size=(4,)).astype(np.float32)
    np.testing.assert_array_equal(tt.rotation_matrix_z_np(rad), jt.rotation_matrix_z_np(rad))
    aa = rng.normal(size=(4, 16, 3))
    mat = tt.axis_angle_to_matrix_np(aa)
    np.testing.assert_array_equal(mat, jt.axis_angle_to_matrix_np(aa))
    np.testing.assert_array_equal(tt.matrix_to_axis_angle_np(mat), jt.matrix_to_axis_angle_np(mat))


@pytest.mark.parametrize("seed", range(6))
def test_photometric_augmentations_match_jax(seed):
    """Same generator state on both sides: same draws, same pixels, and the
    generators left in the same state."""
    img = frames(np.random.default_rng(100 + seed), 2, (24, 24), np.float32)
    for name in ("color_jitter", "random_photometric_aug"):
        r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
        got = getattr(tt, name)(img.copy(), r_port)
        want = getattr(jt, name)(img.copy(), r_jax)
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert r_port.uniform() == r_jax.uniform(), name
    np.testing.assert_array_equal(tt._grayscale(img), jt._grayscale(img))


def clip_annotations(rng, T=2):
    joint_cam = rng.normal(scale=30, size=(T, 21, 3)).astype(np.float32)
    joint_cam[..., 2] += 500
    joint_img = rng.uniform(30, 110, size=(T, 21, 2)).astype(np.float32)
    return {
        "joint_cam": joint_cam,
        "joint_rel": (joint_cam - joint_cam[:, :1]).astype(np.float32),
        "joint_img": joint_img,
        "mano_pose": rng.normal(scale=0.3, size=(T, 48)).astype(np.float32),
        "princpt": np.tile(np.asarray([80.0, 60.0], np.float32), (T, 1)),
    }


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rotation_augmentation_matches_jax(rng, dtype):
    img = frames(rng, 2, dtype=dtype)
    a = clip_annotations(rng)
    args = (a["joint_cam"], a["joint_rel"], a["joint_img"], a["mano_pose"], a["princpt"], 1.25, IMG)
    r_port, r_jax = np.random.default_rng(5), np.random.default_rng(5)
    got = tt.rotation_augmentation(img, *args, r_port)
    want = jt.rotation_augmentation(img, *args, r_jax)
    assert_items_equal(got, want)
    assert r_port.uniform() == r_jax.uniform()


def test_rotation_augmentation_matches_jax_numpy_path(rng, numpy_crops):
    img = frames(rng, 2)
    a = clip_annotations(rng)
    args = (a["joint_cam"], a["joint_rel"], a["joint_img"], a["mano_pose"], a["princpt"], 1.25, IMG)
    assert_items_equal(tt.rotation_augmentation(img, *args, np.random.default_rng(5)),
                       jt.rotation_augmentation(img, *args, np.random.default_rng(5)))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_horizontal_flip_annotations_matches_jax(rng, dtype):
    img = frames(rng, 2, dtype=dtype)
    a = clip_annotations(rng)
    bbox = boxes(rng, 2)
    args = (img, bbox, a["joint_img"], a["joint_img"] - bbox[:, None, :2], a["joint_cam"],
            a["joint_rel"], a["mano_pose"], a["princpt"])
    got, want = tt.horizontal_flip_annotations(*args), jt.horizontal_flip_annotations(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# --- data/fixtures.py ----------------------------------------------------------


def h5_contents(path):
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = (obj.dtype, obj[()])

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def test_synthetic_dexycb_writes_the_jax_fixture(roots):
    for split in ("train", "test"):
        got = h5_contents(os.path.join(roots["port"], f"s1_{split}.h5"))
        want = h5_contents(os.path.join(roots["jax"], f"s1_{split}.h5"))
        assert sorted(got) == sorted(want) and len(want) == 2 * 7
        for k, (dtype, value) in want.items():
            assert got[k][0] == dtype, k
            np.testing.assert_array_equal(got[k][1], value, err_msg=k)
    jpegs = sorted(os.path.relpath(os.path.join(d, f), roots["jax"])
                   for d, _, fs in os.walk(roots["jax"]) for f in fs if f.endswith(".jpg"))
    assert len(jpegs) == 2 * 2 * 6
    for rel in jpegs:
        with open(os.path.join(roots["port"], rel), "rb") as a, \
                open(os.path.join(roots["jax"], rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_synthetic_sequences_hold_the_written_frames(roots):
    """Each JPEG file is the encoding of the frame the generator gives."""
    import cv2

    n = 0
    for split, name, arrays in synthetic_dexycb_sequences(seq_len=6):
        for rel, img in zip(arrays["imgs_path"], arrays["images"]):
            with open(os.path.join(roots["port"], rel.decode()), "rb") as f:
                assert f.read() == cv2.imencode(".jpg", img)[1].tobytes(), rel
            n += 1
    assert n == 2 * 2 * 6


# --- data/dexycb.py ----------------------------------------------------------------


@pytest.mark.parametrize("split,epoch,T", [("train", 0, 1), ("train", 1, 1), ("train", 1, 3),
                                           ("test", 0, 1), ("test", 0, 3)])
def test_dexycb_items_match_jax(roots, split, epoch, T):
    port = DexYCB(roots["port"], T, "s1", split, img_size=IMG)
    jax_ds = JDexYCB(roots["port"], T, "s1", split, img_size=IMG)
    port.set_epoch(epoch)
    jax_ds.set_epoch(epoch)
    assert len(port) == len(jax_ds) == 2 * (6 - T + 1)
    for ix in range(len(port)):  # both sequences: right and left (flipped) hands
        assert_items_equal(port[ix], jax_ds[ix])
    assert port[len(port) - 1]["flip"] is True


@pytest.mark.parametrize("split", ["train", "test"])
def test_dexycb_items_c_crop_against_numpy_crop(roots, split, jax_numpy_crops):
    """The port's items (C crop) against the JAX package's on its numpy crop:
    every field exact but the patches (see the module docstring)."""
    port = DexYCB(roots["port"], 1, "s1", split, img_size=IMG)
    jax_ds = JDexYCB(roots["port"], 1, "s1", split, img_size=IMG)
    port.set_epoch(1)
    jax_ds.set_epoch(1)
    tol = patch_tol(FIXTURE_HW) * (AUG_GAIN if split == "train" else 1.0)
    for ix in (0, len(port) - 1):
        assert_items_equal(port[ix], jax_ds[ix], tol)


@pytest.mark.parametrize("split", ["train", "test"])
def test_dexycb_items_match_jax_numpy_path(roots, split, numpy_crops):
    port = DexYCB(roots["port"], 1, "s1", split, img_size=IMG)
    jax_ds = JDexYCB(roots["port"], 1, "s1", split, img_size=IMG)
    port.set_epoch(2)
    jax_ds.set_epoch(2)
    for ix in (0, len(port) - 1):
        assert_items_equal(port[ix], jax_ds[ix])


def test_train_items_redraw_by_epoch(roots):
    ds = DexYCB(roots["port"], 1, "s1", "train", img_size=IMG)
    ds.set_epoch(0)
    a = ds[0]
    ds.set_epoch(1)
    assert not np.array_equal(a["patches"], ds[0]["patches"])
    ds.set_epoch(0)
    np.testing.assert_array_equal(a["patches"], ds[0]["patches"])


# --- data/base.py ------------------------------------------------------------------


class Indexed:
    """Items that are their own index, with an epoch like the datasets'."""

    def __init__(self, n):
        self.n, self.epoch = n, None

    def __len__(self):
        return self.n

    def __getitem__(self, ix):
        return {"ix": np.asarray(ix), "imgs_path": [f"{ix}.jpg"], "flip": bool(ix % 2)}

    def set_epoch(self, epoch):
        self.epoch = epoch


@pytest.mark.parametrize("n,batch,shuffle,drop_last,shards", [
    (10, 3, False, False, 1), (10, 3, True, True, 1), (10, 4, True, False, 3),
    (11, 2, True, True, 4), (7, 8, False, False, 2), (7, 8, True, True, 1),
])
def test_loader_order_matches_jax(n, batch, shuffle, drop_last, shards):
    for epoch in (0, 1, 5):
        for shard in range(shards):
            kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last, seed=42,
                      num_shards=shards, shard_index=shard)
            port, jax_loader = DataLoader(Indexed(n), **kw), JDataLoader(Indexed(n), **kw)
            port.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            assert port.dataset.epoch == epoch
            got, want = list(port), list(jax_loader)
            assert len(port) == len(jax_loader) == len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["ix"], w["ix"])
                assert g["imgs_path"] == w["imgs_path"] and g["flip"] == w["flip"]


def test_loader_shards_pad_to_equal_counts():
    per = [[int(i) for b in DataLoader(Indexed(10), 4, shuffle=False, num_shards=3,
                                       shard_index=s, prefetch=0) for i in b["ix"]]
           for s in range(3)]
    assert [len(p) for p in per] == [4, 4, 4]
    assert sorted(sum(per, [])) == sorted(list(range(10)) + [0, 1])


def test_concat_dataset_and_collate(roots):
    a = DexYCB(roots["port"], 1, "s1", "test", img_size=IMG)
    ds = ConcatDataset([a, a])
    assert len(ds) == 2 * len(a)
    assert_items_equal(ds[len(a) + 3], a[3])
    b = collate([ds[0], ds[1]])
    assert isinstance(b["imgs_path"], list) and isinstance(b["flip"], list)
    assert b["patches"].shape == (2, 1, IMG, IMG, 3)


def test_parallel_loader_matches_serial(roots):
    """num_workers=4 gives bit-identical batches to a serial run."""
    ds = DexYCB(roots["port"], 1, "s1", "train", img_size=IMG)
    kw = dict(batch_size=4, shuffle=True, seed=11, drop_last=True)
    serial = DataLoader(ds, prefetch=0, **kw)
    parallel = DataLoader(ds, num_workers=4, prefetch=2, **kw)
    serial.set_epoch(3)
    parallel.set_epoch(3)
    got_s, got_p = list(serial), list(parallel)
    assert len(got_s) == len(got_p) == 3
    for bs, bp in zip(got_s, got_p):
        assert_items_equal(bp, bs)
