"""Port parity: the overlap probe's plain version against the TPU probe kernel.

``tools/probe_overlap.py:make_kernel(mode)`` (modes "mxu", "vpu", "both") runs
through ``pl.pallas_call(..., interpret=True)`` on small shapes; the port's
``probe_overlap`` (modes "mma", "exp", "both") on CPU tensors runs its plain
version on the same numpy inputs. Tolerances (those chip_smoke.py holds the
kernel to): the bf16 product chain to 2e-2 of its scale (eight products,
each rounded to bf16; an f32 sum in another order flips a rounding by one
ulp, 2^-8, and later products carry it), the f32 exp chain to 1e-5 relative
(32 passes of exp(v/4 - 1) contract errors by about v/4 < 1 each).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cs_vit_tpu_torch.ops import probe_overlap as po
from cs_vit_tpu_torch.tools import probe_overlap as tool

TPU_MODE = {"mma": "mxu", "exp": "vpu", "both": "both"}


def _tpu_probe():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "probe_overlap.py")
    spec = importlib.util.spec_from_file_location("tpu_probe_overlap", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", po.MODES)
def test_plain_version_matches_the_tpu_kernel(rng, mode):
    a = (rng.normal(size=(32, 32)) * 0.2).astype(np.float32)
    w = (rng.normal(size=(32, 32)) * 0.2).astype(np.float32)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    ja, jw = jnp.asarray(a, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want_acc, want_vec = pl.pallas_call(
        _tpu_probe().make_kernel(TPU_MODE[mode]),
        out_shape=[jax.ShapeDtypeStruct(a.shape, jnp.bfloat16),
                   jax.ShapeDtypeStruct(x.shape, jnp.float32)],
        interpret=True,
    )(ja, jw, jnp.asarray(x))
    want_acc = np.asarray(want_acc.astype(jnp.float32))
    po.reset_launch_counts()
    acc, vec = po.probe_overlap(torch.from_numpy(a).to(torch.bfloat16),
                                torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(x), mode)
    assert po.launch_counts() == {"probe_overlap": 0}  # CPU: the plain version
    assert acc.dtype == torch.bfloat16 and vec.dtype == torch.float32
    acc = acc.float().numpy()
    assert np.abs(acc - want_acc).max() <= 2e-2 * np.abs(want_acc).max()
    np.testing.assert_allclose(vec.numpy(), np.asarray(want_vec), rtol=1e-5, atol=0)
    if mode == "exp":  # the untouched stream passes its input through
        np.testing.assert_array_equal(acc, want_acc)
    if mode == "mma":
        np.testing.assert_array_equal(vec.numpy(), x)


def test_tool_runs_on_the_cpu():
    """The tool's timing loop on CPU tensors times the plain version of each
    mode."""
    ms = tool.run("cpu", iters=1, repeats=1)
    assert set(ms) == {"mma", "exp", "both", "serial", "overlap"}
    assert all(np.isfinite(v) and v > 0 for v in ms.values())
    assert ms["serial"] == ms["mma"] + ms["exp"] and ms["overlap"] == max(ms["mma"], ms["exp"])
