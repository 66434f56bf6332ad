"""Port parity: the SwinV2 block backward against the JAX package.

On CPU tensors ``fused_swin_block`` runs through ``FusedSwinBlock`` with every
kernel wrapper on its plain version, forward and backward, so these tests
hold the Function itself (its eleven-step backward) against ``jax.grad`` of
the JAX ``fused_swin_block(..., interpret=True)``, whose backward is the
Pallas kernel ``_pallas_backward`` run in interpret mode, as
``tests/test_fused_block.py`` runs it; a single-window geometry is held
against ``jax.vjp`` of ``_block_reference`` (the route JAX takes for stage 3).
Tolerance: the JAX test's own, atol 1e-3 and rtol 2e-3 in f32 (reassociated
f32 sums and the TPU kernel's rational erf). Each plain backward kernel is
held against autograd of its own plain forward in f32 at 1e-5 of the
largest gradient (same math, other summation order). The inputs are numpy
draws from a seed; the droppath scales are 1 and 0 for one image, 1 and 2
for the next. The CUDA kernels are held against these plain versions on the
card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.ops.fused_block import _block_reference as j_block_reference
from cs_vit_tpu.ops.fused_block import fused_swin_block as j_fused_swin_block
from cs_vit_tpu_torch.models.swinv2 import _shift_attn_mask
from cs_vit_tpu_torch.ops import fused_block as fb

GEOMS = [
    (8, 4, 0, 16, 2, 2),    # multi-window
    (8, 4, 2, 16, 2, 2),    # shifted (mask)
    (4, 4, 0, 16, 4, 4),    # single window, several images
    (12, 4, 2, 8, 2, 2),    # several window rows per image, shifted
]
SINGLE = (8, 8, 0, 64, 2, 2)  # one 8x8 window per image, stage-3-like
JAX_TOL = dict(atol=1e-3, rtol=2e-3)
NAMES = ("x",) + fb.OPERANDS


def _operands(seed, res, ws, shift, C, heads, B):
    rng = np.random.default_rng(seed)
    L, Ch = ws * ws, 4 * C
    n = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)  # noqa: E731
    ops = dict(
        x=n(B, res, res, C),
        wqkv=n(C, 3 * C, std=C ** -0.5), bqkv=n(3 * C, std=0.02),
        wproj=n(C, C, std=C ** -0.5), bproj=n(C, std=0.02),
        ln1_scale=1 + n(C, std=0.1), ln1_bias=n(C, std=0.1),
        w1=n(C, Ch, std=C ** -0.5), b1=n(Ch, std=0.02),
        w2=n(Ch, C, std=Ch ** -0.5), b2=n(C, std=0.02),
        ln2_scale=1 + n(C, std=0.1), ln2_bias=n(C, std=0.1),
        rel_bias=(16 / (1 + np.exp(-n(heads, L, L)))).astype(np.float32),
        logit_scale=np.exp(np.minimum(np.log(10.0) + n(heads, std=0.5), np.log(100.0))
                           ).astype(np.float32),
    )
    ops["bqkv"][C:2 * C] = 0.0  # no key bias
    g = n(B, res, res, C)
    mask = _shift_attn_mask(res, res, ws, shift) if shift else None
    dp = np.tile(np.asarray([[1.0, 0.0], [1.0, 2.0]], np.float32), (B // 2, 1))
    return ops, g, mask, dp


def _port_grads(ops, g, mask, dp, ws, heads, shift):
    leaves = [torch.from_numpy(ops[k]).requires_grad_(True) for k in NAMES]
    y = fb.fused_swin_block(
        *leaves, mask=None if mask is None else torch.from_numpy(mask),
        droppath_keep=torch.from_numpy(dp), window_size=ws, num_heads=heads, shift=shift)
    return [t.numpy() for t in torch.autograd.grad(y, leaves, torch.from_numpy(g))]


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of sum(y * g) w.r.t. x and every operand, per geometry: the
    Pallas backward (interpret mode) for GEOMS, jax.vjp of _block_reference
    for SINGLE."""
    out = {}
    for seed, (res, ws, shift, C, heads, B) in enumerate(GEOMS):
        ops, g, mask, dp = _operands(seed, res, ws, shift, C, heads, B)

        def loss(*args):
            y = j_fused_swin_block(
                *args, mask=None if mask is None else jnp.asarray(mask),
                droppath_keep=jnp.asarray(dp), window_size=ws, num_heads=heads,
                interpret=True, shift=shift)
            return jnp.sum(y * jnp.asarray(g))

        grads = jax.grad(loss, argnums=tuple(range(len(NAMES))))(
            *[jnp.asarray(ops[k]) for k in NAMES])
        out[(res, ws, shift, C, heads, B)] = [np.asarray(v) for v in grads]
    res, ws, shift, C, heads, B = SINGLE
    ops, g, mask, dp = _operands(len(GEOMS), *SINGLE)
    ref = functools.partial(j_block_reference, window_size=ws, num_heads=heads, eps=1e-5)
    _, vjp = jax.vjp(lambda *a: ref(*a, jnp.asarray(dp)), *[jnp.asarray(ops[k]) for k in NAMES])
    out[SINGLE] = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    return out


@pytest.mark.parametrize("geom", GEOMS + [SINGLE],
                         ids=[f"res{g[0]}_ws{g[1]}_shift{g[2]}_C{g[3]}" for g in GEOMS + [SINGLE]])
def test_block_backward_matches_jax(jax_grads, geom):
    """FusedSwinBlock on CPU tensors (plain versions) == JAX's gradients of x
    and of all fourteen operands, in f32."""
    res, ws, shift, C, heads, B = geom
    seed = GEOMS.index(geom) if geom in GEOMS else len(GEOMS)
    ops, g, mask, dp = _operands(seed, *geom)
    fb.reset_launch_counts()
    got = _port_grads(ops, g, mask, dp, ws, heads, shift)
    assert all(v == 0 for v in fb.launch_counts().values())  # CPU: nothing launched
    for name, a, b in zip(NAMES, got, jax_grads[geom]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **JAX_TOL)


def test_block_backward_reference_matches_the_function():
    """block_backward_reference (one function, on pre-rolled windows) and the
    Function's eleven plain-version steps give the same grads (f32, 1e-5 of
    each grad's scale: same math, other summation order)."""
    res, ws, shift, C, heads, B = GEOMS[1]
    ops, g, mask, dp = _operands(1, *GEOMS[1])
    got = _port_grads(ops, g, mask, dp, ws, heads, shift)
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    roll = functools.partial(torch.roll, shifts=(-shift, -shift), dims=(1, 2))
    want = fb.block_backward_reference(
        roll(torch.from_numpy(g)), roll(t["x"]), *[t[k] for k in fb.OPERANDS],
        torch.from_numpy(dp), torch.from_numpy(mask), window_size=ws, num_heads=heads, eps=1e-5)
    assert len(want) == 1 + len(fb.OPERANDS) + 2  # dx, operands, zeros for dp and mask
    assert not want[-1].any() and not want[-2].any()
    want = [torch.roll(want[0], (shift, shift), (1, 2))] + list(want[1:-2])
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5 * float(b.abs().max()), rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# each plain backward kernel against autograd of its plain forward
# ---------------------------------------------------------------------------


def _t(rng, *shape, std=1.0):
    return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("epi", ["none", "gelu", "add"])
def test_gemm_dgrad_plain_matches_autograd(rng, epi):
    """dA of y = f(a) @ w with f = GELU ('gelu', aux = a) or the identity;
    'add' adds a residual grad, as h1b = g + m1b @ W1^T does."""
    a, w, dy = _t(rng, 12, 16).requires_grad_(True), _t(rng, 16, 24), _t(rng, 12, 24)
    y = fb.gemm_bias_act_reference(torch.nn.functional.gelu(a) if epi == "gelu" else a,
                                   w, torch.zeros(24))
    (want,) = torch.autograd.grad(y, a, dy)
    res = _t(rng, 12, 16)
    aux = {"none": None, "gelu": a.detach(), "add": res}[epi]
    got = fb.gemm_dgrad(dy, w, aux, epi=epi, out_dtype=torch.float32)
    _close(got, want + res if epi == "add" else want)


def test_gemm_wgrad_plain_matches_autograd(rng):
    a, w, b, dy = _t(rng, 40, 16), _t(rng, 16, 24), _t(rng, 24), _t(rng, 40, 24)
    w.requires_grad_(True)
    b.requires_grad_(True)
    want_w, want_b = torch.autograd.grad(fb.gemm_bias_act_reference(a, w, b), (w, b), dy)
    got_w, got_b = fb.gemm_wgrad(a, dy)
    _close(got_w, want_w)
    _close(got_b, want_b)


def test_ln_residual_bwd_plain_matches_autograd(rng):
    z, res, g = _t(rng, 12, 16, std=3.0), _t(rng, 12, 16), _t(rng, 12, 16)
    gamma, beta = 1 + _t(rng, 16, std=0.1), _t(rng, 16, std=0.1)
    dp = torch.tensor([[1.0, 0.0], [2.0, 1.0], [0.5, 3.0]])
    for t in (z, gamma, beta):
        t.requires_grad_(True)
    for col in (0, 1):
        y, _ = fb.ln_residual_reference(z, res, gamma, beta, dp, col, 1e-5, torch.float32)
        want = torch.autograd.grad(y, (z, gamma, beta), g)
        got = fb.ln_residual_bwd(z.detach(), g, gamma.detach(), dp, col, 1e-5)
        for a, b in zip(got, want):
            _close(a, b)


@pytest.mark.parametrize("shift", [0, 2])
def test_window_attention_bwd_plain_matches_autograd(rng, shift):
    B, res, ws, heads, hd = 2, 8, 4, 2, 8
    C, L = heads * hd, ws * ws
    qkv = _t(rng, B, res, res, 3 * C).requires_grad_(True)
    rel_bias = (16 * torch.sigmoid(_t(rng, heads, L, L))).requires_grad_(True)
    scale = torch.tensor([10.0, 23.0], requires_grad=True)
    mask = torch.from_numpy(_shift_attn_mask(res, res, ws, shift)) if shift else None
    dout = _t(rng, B, res, res, C)
    kw = dict(window_size=ws, num_heads=heads, shift=shift)
    o = fb.window_attention_reference(qkv, rel_bias, scale, mask, **kw)
    want = torch.autograd.grad(o, (qkv, rel_bias, scale), dout)
    got = fb.window_attention_bwd(qkv.detach(), dout, rel_bias.detach(), scale.detach(), mask,
                                  **kw)
    for a, b in zip(got, want):
        _close(a, b)
