"""Port parity: ``PoserSession`` against the JAX ``PoserSession``.

Both sessions serve the same weights (the JAX session's, exported to a
reference-style ``.pt``) at batch 4; N=6 crops make a full chunk and a
chunk padded by repeating its last row. f32 on the CPU; tolerance as in
test_torch_poser.py (1e-4 of each output's largest magnitude, + 1e-4).
``predict_images`` (full frames and tight boxes through each package's C
crop: the same pixels) is held to the same tolerance, and exactly against
the port's own ``predict_crops`` on its own host crops.
"""

import json

import jax
import numpy as np
import pytest
import torch

from cs_vit_tpu.config import FinetuneConfig as JFinetuneConfig
from cs_vit_tpu.serving import PoserSession as JPoserSession
from cs_vit_tpu.train.convert import export_poser_state_dict
from cs_vit_tpu_torch.config import FinetuneConfig
from cs_vit_tpu_torch.ops.resample import crop_with_square_box_np
from cs_vit_tpu_torch.serving import PoserSession

CFG = dict(exp="serve", backbone="test", img_size=32, phase="inference",
           data=["dexycb"], batch_size=4)


def _request(rng, N=6, S=32):
    return (
        rng.uniform(size=(N, 1, S, S, 3)).astype(np.float32),
        np.tile(np.asarray([10, 10, 200, 200], np.float32), (N, 1, 1)),
        np.zeros((N, 1), np.float32),
        np.full((N, 1, 2), 300.0, np.float32),
        np.full((N, 1, 2), 100.0, np.float32),
    )


@pytest.fixture(scope="module")
def jax_session_and_ckpt(tmp_path_factory):
    jsess = JPoserSession(JFinetuneConfig(**CFG), batch_size=4, seq_len=1, dtype="float32")
    sd = export_poser_state_dict(
        jax.tree.map(np.asarray, jsess._params), jax.tree.map(np.asarray, jsess._stats),
        jsess.model.config,
    )
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    exp = tmp_path_factory.mktemp("exp")
    torch.save({"model": sd, "merged": sd, "epoch": 1}, exp / "checkpoint.pt")
    (exp / "config.json").write_text(JFinetuneConfig(**CFG).to_json())
    return jsess, exp


def _assert_close(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == np.float32, k
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max() + 1e-4, k


def test_predict_crops_padding_matches_jax(jax_session_and_ckpt, rng):
    jsess, exp = jax_session_and_ckpt
    sess = PoserSession(FinetuneConfig(**CFG), checkpoint=str(exp / "checkpoint.pt"),
                        batch_size=4, dtype="float32", device="cpu")
    req = _request(rng)
    out = sess.predict_crops(*req)
    assert out["joint_cam"].shape == (6, 1, 21, 3)
    assert out["verts_cam"].shape == (6, 1, 778, 3)
    _assert_close(out, jsess.predict_crops(*req))
    # the padded rows answer exactly as they do unpadded, at the front of a chunk
    tail = sess.predict_crops(*[a[4:] for a in req])
    np.testing.assert_allclose(tail["joint_cam"], out["joint_cam"][4:], rtol=1e-6, atol=1e-4)


def test_from_experiment_matches_jax(jax_session_and_ckpt, rng):
    jsess, exp = jax_session_and_ckpt
    sess = PoserSession.from_experiment(str(exp), batch_size=4, dtype="float32", device="cpu")
    req = _request(rng, N=4)
    _assert_close(sess.predict_crops(*req), jsess.predict_crops(*req))


def test_bf16_session_on_cpu(rng):
    sess = PoserSession(FinetuneConfig(**CFG), batch_size=2, dtype="bfloat16", device="cpu")
    assert sess.model.query_token.dtype == torch.bfloat16
    bn = sess.model.perspective_mlp.layer[0]
    assert bn.running_var.dtype == torch.float32  # statistics stay f32
    sess.warmup()
    out = sess.predict_crops(*_request(rng, N=3))
    assert out["joint_cam"].shape == (3, 1, 21, 3) and np.isfinite(out["joint_cam"]).all()


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this test covers machines without one")
    with pytest.raises(RuntimeError, match="cuda"):
        PoserSession(FinetuneConfig(**CFG), batch_size=2, dtype="float32", device="cuda")


def test_config_json_roundtrip_and_unknown_keys(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(JFinetuneConfig(**CFG).to_json())
    cfg = FinetuneConfig.from_json_file(str(path))
    assert cfg.to_dict() == JFinetuneConfig(**CFG).to_dict()
    path.write_text(json.dumps(dict(cfg.to_dict(), no_such_key=1)))
    with pytest.raises(KeyError):
        FinetuneConfig.from_json_file(str(path))


def _frames(rng, N=6, hw=(120, 160)):
    c = rng.uniform(30, 90, size=(N, 2))
    half = rng.uniform(8, 25, size=(N, 2))
    return (
        rng.uniform(size=(N,) + hw + (3,)).astype(np.float32),
        np.concatenate([c - half, c + half], 1).astype(np.float32),
        rng.uniform(200, 300, size=(N, 2)).astype(np.float32),
        rng.uniform(60, 100, size=(N, 2)).astype(np.float32),
        rng.uniform(0, 100, size=(N,)).astype(np.float32),
    )


def test_predict_images_matches_jax(jax_session_and_ckpt, rng):
    jsess, exp = jax_session_and_ckpt
    sess = PoserSession(FinetuneConfig(**CFG), checkpoint=str(exp / "checkpoint.pt"),
                        batch_size=4, dtype="float32", device="cpu")
    images, boxes, focal, princpt, ts = _frames(rng)
    for stamps in (None, ts):
        out = sess.predict_images(images, boxes, focal, princpt, stamps)
        assert out["joint_cam"].shape == (6, 21, 3) and out["verts_cam"].shape == (6, 778, 3)
        _assert_close(out, jsess.predict_images(images, boxes, focal, princpt, stamps))


def test_predict_images_is_predict_crops_on_the_host_crops(rng):
    sess = PoserSession(FinetuneConfig(**CFG), batch_size=4, dtype="float32", device="cpu")
    images, boxes, focal, princpt, ts = _frames(rng, N=5)
    out = sess.predict_images(images, boxes, focal, princpt, ts)
    patches, _, squares = crop_with_square_box_np(images, boxes, sess.cfg.expansion_ratio,
                                                  sess.cfg.img_size)
    want = sess.predict_crops(patches[:, None], squares[:, None], ts[:, None],
                              focal[:, None], princpt[:, None])
    assert set(out) == set(want)
    for k in want:
        np.testing.assert_array_equal(out[k], want[k][:, 0], err_msg=k)
