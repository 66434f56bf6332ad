"""Port parity: the HO3D, HO3D_FS, InterHand26MSeq and legacy InterHand2.6M
datasets, their fixtures, ``cli.common.build_datasets`` and the loader over
all three training sources, against the JAX package on the same seeds.

Each package writes its own fixture tree from the same seed, and the trees
are first held byte for byte (HDF5, JPEG, pickle and JSON files). Each
package then reads its own tree with its own C crop (the same C source and
flags: the same bits), so every field of every item is held exactly, paths
relative to the tree's root.

The one exception is the MANO ground truth of the legacy loader's
``train_item``, which the port synthesises with its torch ``ManoLayer`` and
the JAX package with its ``jnp`` one: ``mano_mesh_cam`` (metres) is held to
1e-6, the tolerance ``tests/test_torch_mano.py`` holds the two LBS to, and
``mano_joint_img`` (heatmap pixels) to that micrometre carried through the
pinhole (focal 240 px at depths of at least 0.4 m: 600 px a metre) and the
heatmap affine (at most 0.375 heatmap pixels an image pixel), 2.25e-4, plus
two f32 ulps of its largest value.
"""

import os
import os.path as osp

import numpy as np
import pytest

from cs_vit_tpu.cli.common import build_datasets as j_build_datasets
from cs_vit_tpu.cli.common import build_loader as j_build_loader
from cs_vit_tpu.config import FinetuneConfig as JFinetuneConfig
from cs_vit_tpu.data import HO3D as JHO3D
from cs_vit_tpu.data import HO3D_FS as JHO3D_FS
from cs_vit_tpu.data import InterHand26M as JInterHand26M
from cs_vit_tpu.data import InterHand26MSeq as JInterHand26MSeq
from cs_vit_tpu.data import fixtures as jf
from cs_vit_tpu_torch.cli.common import build_datasets, build_loader
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.data import HO3D, HO3D_FS, DexYCB, InterHand26M, InterHand26MSeq
from cs_vit_tpu_torch.data import fixtures as tf
from cs_vit_tpu_torch.data.fixtures import MemoryStore

IMG = 32
SEQ_LEN = 5
FIXTURES = {  # fixture function -> keyword arguments
    "make_synthetic_dexycb": {"seq_len": SEQ_LEN},
    "make_synthetic_ho3d": {"seq_len": SEQ_LEN},
    "make_synthetic_ih26mseq": {"seq_len": SEQ_LEN},
    "make_synthetic_ho3d_fs": {"seq_len": SEQ_LEN},
    "make_synthetic_ih26m_legacy": {},
}
MESH_TOL = 1e-6
HM_TOL = 1e-6 * 600 * 0.375


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    out = {}
    for name, kw in FIXTURES.items():
        out[name] = {"port": getattr(tf, name)(str(base / "port" / name), **kw),
                     "jax": getattr(jf, name)(str(base / "jax" / name), **kw)}
    return out


def files_of(root):
    return sorted(osp.relpath(osp.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
                  if "__cache__" not in d)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_trees_are_byte_identical(trees, name):
    port, jax_root = trees[name]["port"], trees[name]["jax"]
    files = files_of(jax_root)
    assert files == files_of(port) and files
    for rel in files:
        with open(osp.join(port, rel), "rb") as a, open(osp.join(jax_root, rel), "rb") as b:
            assert a.read() == b.read(), rel


def relative(value, roots):
    """A path (or list of paths) with its tree's root taken off."""
    if isinstance(value, list):
        return [relative(v, roots) for v in value]
    for root in roots:
        if isinstance(value, str) and value.startswith(root + os.sep):
            return osp.relpath(value, root)
    return value


def assert_same(got, want, roots, path="", tols=None):
    """Every field equal (paths relative to the roots), recursively; `tols`
    maps a field's path to its tolerance."""
    tols = tols or {}
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], roots, f"{path}/{k}", tols)
    elif isinstance(want, list) and not all(isinstance(w, str) for w in want):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, roots, f"{path}[{i}]", tols)
    elif isinstance(want, (str, list)):
        assert relative(got, roots) == relative(want, roots), path
    elif isinstance(want, tuple):
        assert got == want, path
    elif want is None or isinstance(want, (bool, int, float)):
        assert type(got) is type(want) and got == want, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        if path in tols:
            tol = tols[path] + 2 * float(np.spacing(np.abs(w).max().astype(w.dtype)))
            err = float(np.abs(g.astype(np.float64) - w).max())
            print(f"{path}: {err:.3g} (tol {tol:.3g})")
            assert err <= tol, (path, err, tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def pair(trees, fixture, port_cls, jax_cls, *args, **kw):
    roots = (trees[fixture]["port"], trees[fixture]["jax"])
    return port_cls(roots[0], *args, **kw), jax_cls(roots[1], *args, **kw), roots


@pytest.mark.parametrize("split,epoch,T", [("train", 0, 1), ("train", 3, 1), ("train", 1, 3),
                                           ("evaluation", 0, 1), ("evaluation", 0, 3)])
def test_ho3d_items_match_jax(trees, split, epoch, T):
    port, jax_ds, roots = pair(trees, "make_synthetic_ho3d", HO3D, JHO3D, T, split,
                               img_size=IMG)
    port.set_epoch(epoch)
    jax_ds.set_epoch(epoch)
    assert len(port) == len(jax_ds) == 2 * (SEQ_LEN - T + 1)
    for ix in range(len(port)):
        assert_same(port[ix], jax_ds[ix], roots)


@pytest.mark.parametrize("split,epoch,T", [("train", 0, 1), ("train", 2, 3),
                                           ("test", 0, 1), ("test", 0, 3)])
def test_ih26mseq_items_match_jax(trees, split, epoch, T):
    port, jax_ds, roots = pair(trees, "make_synthetic_ih26mseq", InterHand26MSeq,
                               JInterHand26MSeq, T, split, img_size=IMG)
    port.set_epoch(epoch)
    jax_ds.set_epoch(epoch)
    assert len(port) == len(jax_ds) == 2 * (SEQ_LEN - T + 1)
    flips = []
    for ix in range(len(port)):
        item = port[ix]
        assert_same(item, jax_ds[ix], roots)
        flips.append(item["flip"])
    # the left hand (its group sorts first) is flipped, the right is not
    assert flips == [True] * (SEQ_LEN - T + 1) + [False] * (SEQ_LEN - T + 1)
    np.testing.assert_array_equal(item["timestamp"], np.arange(T) * 200.0)


def test_ih26mseq_index_cache_is_reused(trees):
    root = trees["make_synthetic_ih26mseq"]["port"]
    first = InterHand26MSeq(root, 2, "test", img_size=IMG)
    cache = osp.join(root, "__cache__", "ih26mseq_test_2.pkl")
    assert osp.exists(cache)
    os.utime(cache, (0, 0))
    again = InterHand26MSeq(root, 2, "test", img_size=IMG)
    assert os.stat(cache).st_mtime == 0  # read, not rewritten
    assert again.seq_index == first.seq_index


@pytest.mark.parametrize("split,T", [("train", 1), ("evaluation", 1), ("evaluation", 3)])
def test_ho3d_fs_items_match_jax(trees, split, T):
    port, jax_ds, roots = pair(trees, "make_synthetic_ho3d_fs", HO3D_FS, JHO3D_FS, T, split,
                               img_size=IMG)
    assert len(port) == len(jax_ds) == SEQ_LEN - T + 1
    for ix in range(len(port)):
        assert_same(port[ix], jax_ds[ix], roots)


def test_memory_stores_give_the_file_items(trees):
    """The datasets over the fixtures' in-memory arrays (``store=``, for a
    machine without h5py) give the items they read from the HDF5 files."""
    ho3d_root = trees["make_synthetic_ho3d"]["port"]
    seqs = list(tf.synthetic_ho3d_sequences(seq_len=SEQ_LEN))
    store = MemoryStore.of((f"sequences/{name}", a) for s, name, a in seqs if s == "train")
    a = HO3D(ho3d_root, 1, "train", img_size=IMG, store=store)
    b = HO3D(ho3d_root, 1, "train", img_size=IMG)
    assert len(a) == len(b)
    for ix in (0, len(a) - 1):
        assert_same(a[ix], b[ix], ())

    ih_root = trees["make_synthetic_ih26mseq"]["port"]
    seqs = list(tf.synthetic_ih26mseq_sequences(seq_len=SEQ_LEN))
    store = MemoryStore.of((f"{path}/annots", a) for s, path, a in seqs if s == "test")
    a = InterHand26MSeq(ih_root, 1, "test", img_size=IMG, store=store,
                        cache_dir=osp.join(ih_root, "__memory_cache__"))
    b = InterHand26MSeq(ih_root, 1, "test", img_size=IMG)
    assert len(a) == len(b) and a.seq_index == b.seq_index
    for ix in (0, len(a) - 1):
        assert_same(a[ix], b[ix], ())

    dex_root = trees["make_synthetic_dexycb"]["port"]
    seqs = list(tf.synthetic_dexycb_sequences(seq_len=SEQ_LEN))
    store = MemoryStore.of((f"sequences/{name}", a) for s, name, a in seqs if s == "test")
    a = DexYCB(dex_root, 1, "s1", "test", img_size=IMG, store=store)
    b = DexYCB(dex_root, 1, "s1", "test", img_size=IMG)
    for ix in (0, len(a) - 1):
        assert_same(a[ix], b[ix], ())


# --- the legacy InterHand2.6M loader ----------------------------------------------


@pytest.fixture(scope="module")
def legacy(trees, tmp_path_factory):
    aid = tmp_path_factory.mktemp("aid") / "aid_human_annot_test.txt"
    aid.write_text("1\n3\n")
    roots = (trees["make_synthetic_ih26m_legacy"]["port"],
             trees["make_synthetic_ih26m_legacy"]["jax"])
    return {"roots": roots,
            "full": (InterHand26M(roots[0], "test", img_size=IMG),
                     JInterHand26M(roots[1], "test", img_size=IMG)),
            "aid": (InterHand26M(roots[0], "test", img_size=IMG, aid_list_path=str(aid)),
                    JInterHand26M(roots[1], "test", img_size=IMG, aid_list_path=str(aid)))}


@pytest.mark.parametrize("which", ["full", "aid"])
def test_legacy_datalist_and_items_match_jax(legacy, which):
    port, jax_ds = legacy[which]
    assert len(port) == len(jax_ds) == (4 if which == "full" else 2)
    assert_same(port.datalist, jax_ds.datalist, legacy["roots"])
    for ix in range(len(port)):
        assert_same(port[ix], jax_ds[ix], legacy["roots"])


@pytest.mark.parametrize("mode,ix,seed", [("test", 0, None), ("train", 1, 0), ("train", 1, 1),
                                          ("train", 0, 1)])
def test_legacy_train_item_matches_jax(legacy, monkeypatch, mode, ix, seed):
    port, jax_ds = legacy["full"]
    monkeypatch.setattr(port, "data_split", mode)
    monkeypatch.setattr(jax_ds, "data_split", mode)
    rng = (lambda: None) if seed is None else (lambda: np.random.default_rng(seed))
    got = port.train_item(ix, rng=rng(), hand_img_size=48)
    want = jax_ds.train_item(ix, rng=rng(), hand_img_size=48)
    assert_same(got, want, legacy["roots"],
                tols={"/targets/mano_mesh_cam": MESH_TOL, "/targets/mano_joint_img": HM_TOL})


# --- build_datasets and the loader ---------------------------------------------------


def cfgs(trees, **over):
    kw = dict(dict(exp="ds", backbone="test", data=["dexycb", "ho3d", "interhand26m"],
                   phase="spatial", batch_size=4, img_size=IMG, num_workers=0,
                   dexycb_root=trees["make_synthetic_dexycb"]["port"],
                   ho3d_root=trees["make_synthetic_ho3d"]["port"],
                   ih26mseq_root=trees["make_synthetic_ih26mseq"]["port"]), **over)
    jkw = dict(kw, dexycb_root=trees["make_synthetic_dexycb"]["jax"],
               ho3d_root=trees["make_synthetic_ho3d"]["jax"],
               ih26mseq_root=trees["make_synthetic_ih26mseq"]["jax"])
    return FinetuneConfig(**kw), JFinetuneConfig(**jkw)


def all_roots(trees):
    return tuple(trees[f][side] for f in ("make_synthetic_dexycb", "make_synthetic_ho3d",
                                          "make_synthetic_ih26mseq") for side in ("port", "jax"))


@pytest.mark.parametrize("split", ["train", "test"])
def test_build_datasets_matches_jax(trees, split, capsys):
    cfg, jcfg = cfgs(trees)
    port, jax_ds = build_datasets(cfg, split), j_build_datasets(jcfg, split)
    assert capsys.readouterr().out.count("Added") == 6
    assert [type(d).__name__ for d in port.datasets] == ["DexYCB", "HO3D", "InterHand26MSeq"]
    splits = [d.data_split for d in port.datasets]
    assert splits == (["train"] * 3 if split == "train" else ["test", "evaluation", "test"])
    assert len(port) == len(jax_ds) == 3 * 2 * SEQ_LEN
    for ix in range(0, len(port), 3):
        assert_same(port[ix], jax_ds[ix], all_roots(trees))


@pytest.mark.parametrize("workers", [0, 4])
def test_loader_over_three_datasets_matches_jax(trees, workers):
    cfg, jcfg = cfgs(trees, num_workers=workers)
    port = build_loader(cfg, build_datasets(cfg, "train"), shuffle=True)
    jax_loader = j_build_loader(jcfg, j_build_datasets(jcfg, "train"), shuffle=True)
    port.set_epoch(2)
    jax_loader.set_epoch(2)
    got, want = list(port), list(jax_loader)
    assert len(got) == len(want) == 3 * 2 * SEQ_LEN // 4
    for g, w in zip(got, want):
        assert_same(g, w, all_roots(trees))


def test_loader_raises_an_item_error_in_the_consumer(trees):
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, ix):
            if ix == 5:
                raise ValueError("item 5 is broken")
            return {"x": np.zeros(2, np.float32)}

    from cs_vit_tpu_torch.data import DataLoader

    for workers in (0, 3):
        loader = DataLoader(Broken(), 2, shuffle=False, num_workers=workers)
        with pytest.raises(ValueError, match="item 5 is broken"):
            list(loader)
