"""Port parity: ``PoserSession`` against the JAX ``PoserSession``.

Both sessions serve the same weights (the JAX session's, exported to a
reference-style ``.pt``) at batch 4; N=6 crops make a full chunk and a
chunk padded by repeating its last row. f32 on the CPU; tolerance as in
test_torch_poser.py (1e-4 of each output's largest magnitude, + 1e-4).
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
