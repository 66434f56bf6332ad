"""Port parity: ``cs_vit_tpu_torch.evaluation`` (the benchmark metrics, the
InterHand2.6M metric suite, the HDF5 eval dump) against
``cs_vit_tpu.evaluation`` on seeded inputs.

Both packages run the same numpy and scipy code, so every number is held
exactly, and so are the dump's schema (dataset names, dtypes, shapes,
maxshape, chunks, compression) and contents.
"""

import h5py
import numpy as np
import pytest

from cs_vit_tpu.evaluation import EvalH5Writer as JEvalH5Writer
from cs_vit_tpu.evaluation import align_w_scale as j_align_w_scale
from cs_vit_tpu.evaluation import compute_metrics as j_compute_metrics
from cs_vit_tpu.evaluation import ih26m_metrics as jm
from cs_vit_tpu.evaluation import reproject_pinhole as j_reproject_pinhole
from cs_vit_tpu_torch.evaluation import (
    EvalH5Writer,
    align_w_scale,
    compute_metrics,
    gather_strings_to_host0,
    gather_to_host0,
    reproject_pinhole,
)
from cs_vit_tpu_torch.evaluation import ih26m_metrics as tm
from cs_vit_tpu_torch.evaluation import writer as twriter


def joints(rng, n, scale=30.0, depth=500.0, J=21):
    j = rng.normal(scale=scale, size=(n, J, 3)).astype(np.float32)
    j[..., 2] += depth
    return j


@pytest.mark.parametrize("seed", range(3))
def test_compute_metrics_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gt = joints(rng, 12)
    pred = gt + rng.normal(scale=8.0, size=gt.shape).astype(np.float32)
    got, want = compute_metrics(gt, pred), j_compute_metrics(gt, pred)
    assert got == want
    assert sorted(got) == ["mpjpe_cs", "mpjpe_pa", "mpjpe_rs", "mprpe"]


@pytest.mark.parametrize("trafo", [False, True])
def test_align_w_scale_matches_jax(rng, trafo):
    a, b = joints(rng, 2)
    got = align_w_scale(a, b, return_trafo=trafo)
    want = j_align_w_scale(a, b, return_trafo=trafo)
    for g, w in zip(got if trafo else [got], want if trafo else [want]):
        np.testing.assert_array_equal(g, w)


def test_reproject_pinhole_matches_jax(rng):
    jc = joints(rng, 6).reshape(2, 3, 21, 3)
    focal = rng.uniform(400, 700, size=(2, 3, 2)).astype(np.float32)
    princpt = rng.uniform(100, 400, size=(2, 3, 2)).astype(np.float32)
    got = reproject_pinhole(jc, focal, princpt)
    want = j_reproject_pinhole(jc, focal, princpt)
    assert got.dtype == want.dtype and got.shape == (2, 3, 21, 2)
    np.testing.assert_array_equal(got, want)


def two_hand_sample(rng, hand_type, with_mesh=True, partial=False):
    J, V = 42, 778
    valid = np.ones(J, np.float32)
    if partial:
        valid[rng.choice(J, 6, replace=False)] = 0
    gt = joints(rng, 1, J=J)[0]
    mesh_gt = joints(rng, 1, J=2 * V)[0] if with_mesh else None
    sample = {
        "joint_gt": gt,
        "joint_out": gt + rng.normal(scale=6.0, size=gt.shape),
        "joint_valid": valid,
        "hand_type": hand_type,
        "mesh_gt": mesh_gt,
        "mesh_out": (None if mesh_gt is None
                     else mesh_gt + rng.normal(scale=5.0, size=mesh_gt.shape)),
        "rel_trans_gt": rng.normal(scale=50, size=3),
        "rel_trans_out": rng.normal(scale=50, size=3),
        "has_mano": {"right": True, "left": hand_type != "right"},
        "bboxes_gt": [np.asarray([10, 20, 90, 120.0]), np.asarray([50, 40, 150, 130.0])],
        "bboxes_out": [np.asarray([12, 18, 95, 118.0]), None if hand_type == "right"
                       else np.asarray([40, 45, 140, 120.0])],
    }
    return sample


@pytest.mark.parametrize("hand_type", ["right", "left", "interacting"])
def test_ih26m_evaluate_sample_matches_jax(hand_type):
    rng = np.random.default_rng({"right": 0, "left": 1, "interacting": 2}[hand_type])
    reg = rng.uniform(size=(21, 778))
    reg /= reg.sum(1, keepdims=True)
    for with_mesh, partial in ((True, False), (False, True), (True, True)):
        s = two_hand_sample(rng, hand_type, with_mesh, partial)
        got = tm.evaluate_sample(sh_joint_regressor=reg, **s)
        want = jm.evaluate_sample(sh_joint_regressor=reg, **s)
        assert got == want


def test_ih26m_aggregate_results_matches_jax():
    rng = np.random.default_rng(3)
    reg = rng.uniform(size=(21, 778))
    reg /= reg.sum(1, keepdims=True)
    samples = [jm.evaluate_sample(sh_joint_regressor=reg, **two_hand_sample(rng, h, m, p))
               for h in ("right", "left", "interacting") for m in (True, False)
               for p in (False, True)]
    got, want = tm.aggregate_results(samples), jm.aggregate_results(samples)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tm.aggregate_results([]).keys() == jm.aggregate_results([]).keys()
    box = rng.uniform(0, 100, size=4)
    assert tm.bbox_iou(box, box + 3) == jm.bbox_iou(box, box + 3)


def write_dump(writer_cls, path, rng):
    w = writer_cls(str(path))
    for n in (3, 5):
        jc = joints(rng, n)
        w.append([f"images/seq{i:03d}/test_{n}.jpg" for i in range(n)], jc, jc + 1.5,
                 jc[..., :2] * 0.5, jc[..., :2] * 0.5 + 2.0)
    w.close()


def h5_schema_and_contents(path):
    out = {}
    with h5py.File(path, "r") as f:
        for name, d in f.items():
            out[name] = {"dtype": d.dtype, "shape": d.shape, "maxshape": d.maxshape,
                         "chunks": d.chunks, "compression": d.compression,
                         "compression_opts": d.compression_opts,
                         "string": h5py.check_string_dtype(d.dtype), "value": d[()]}
    return out


def test_eval_h5_writer_matches_jax(tmp_path):
    write_dump(EvalH5Writer, tmp_path / "port.h5", np.random.default_rng(7))
    write_dump(JEvalH5Writer, tmp_path / "jax.h5", np.random.default_rng(7))
    got = h5_schema_and_contents(tmp_path / "port.h5")
    want = h5_schema_and_contents(tmp_path / "jax.h5")
    assert sorted(got) == sorted(want) == ["img_paths", "joint_cam_gt", "joint_cam_pred",
                                           "joint_reproj_gt", "joint_reproj_pred"]
    for name, w in want.items():
        for key in w:
            if key == "value":
                np.testing.assert_array_equal(got[name][key], w[key], err_msg=name)
            else:
                assert got[name][key] == w[key], (name, key)
    assert want["joint_cam_gt"]["shape"] == (8, 21, 3)


def test_gathers_are_the_identity_on_one_process(rng):
    a = joints(rng, 4)
    assert gather_to_host0(a) is a
    paths = ["a.jpg", "b.jpg"]
    assert gather_strings_to_host0(paths) is paths


def test_gathers_take_the_world_from_utils_dist(monkeypatch, rng):
    """The gathers read the world from ``utils/dist.py``: in a world of two
    they concatenate the ranks' parts in rank order (JAX's
    ``process_allgather``), whatever the collective hands back."""
    from cs_vit_tpu_torch.utils import dist as tdist

    assert twriter.process_count is tdist.process_count
    a, b = joints(rng, 2), joints(rng, 3)
    parts = {"rows": [a, b], "strings": [["a.jpg"], ["b.jpg", "c.jpg"]]}
    monkeypatch.setattr(twriter, "process_count", lambda: 2)
    monkeypatch.setattr(twriter, "_all_gather",
                        lambda obj: parts["strings" if isinstance(obj, list) else "rows"])
    np.testing.assert_array_equal(gather_to_host0(a), np.concatenate([a, b]))
    assert gather_strings_to_host0(["a.jpg"]) == ["a.jpg", "b.jpg", "c.jpg"]


_GLOO_WORKER = """
import sys
import numpy as np
import torch.distributed as dist
from cs_vit_tpu_torch.evaluation import gather_to_host0, gather_strings_to_host0
from cs_vit_tpu_torch.utils.dist import process_count, process_index
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://localhost:" + sys.argv[2], world_size=2,
                        rank=rank)
assert (process_index(), process_count()) == (rank, 2)
rows = gather_to_host0(np.full((rank + 1, 21, 3), rank, np.float32))
assert rows.shape == (3, 21, 3) and rows.dtype == np.float32, rows.shape
assert [float(r[0, 0]) for r in rows] == [0.0, 1.0, 1.0], rows[:, 0, 0]
names = gather_strings_to_host0([f"r{rank}_{i}.jpg" for i in range(rank + 1)])
assert names == ["r0_0.jpg", "r1_0.jpg", "r1_1.jpg"], names
dist.destroy_process_group()
print("gathered")
"""


def test_gathers_gather_in_rank_order_in_a_gloo_world_of_two():
    """Two real processes in a gloo group: each gathers numbers and strings
    of both ranks, rank 0's first."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r), port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "gathered"
