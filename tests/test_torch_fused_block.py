"""Port parity: the SwinV2 block and backbone against the JAX package.

On CPU tensors the port's kernel wrappers run their plain versions, so these
tests hold (a) the port's ``block_reference`` and (b) its seven-step
``fused_swin_block`` against the JAX fused block (Pallas in interpret mode,
as ``tests/test_fused_block.py`` runs it) and JAX ``_block_reference``, then
the SwinV2 backbone against JAX ``SwinV2``. Tolerances are the JAX tests':
2e-5 for one f32 block (same math, other summation order), 3e-5 for the
two-stage backbone. The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs_vit_tpu.models.swinv2 import SwinV2 as JSwinV2
from cs_vit_tpu.models.swinv2 import SwinV2Config as JSwinV2Config
from cs_vit_tpu.models.swinv2 import _shift_attn_mask as j_shift_attn_mask
from cs_vit_tpu.ops.fused_block import _block_reference as j_block_reference
from cs_vit_tpu.ops.fused_block import fused_swin_block as j_fused_swin_block
from cs_vit_tpu_torch.models.swinv2 import SwinV2, SwinV2Config, _shift_attn_mask
from cs_vit_tpu_torch.ops import fused_block as fb
from cs_vit_tpu_torch.train.convert import FlaxMapper, load_reference_state_dict

F32_TOL = dict(atol=2e-5, rtol=2e-5)
NAMES = ("wqkv", "bqkv", "wproj", "bproj", "ln1_scale", "ln1_bias", "w1", "b1",
         "w2", "b2", "ln2_scale", "ln2_bias", "rel_bias", "logit_scale")


def _block_operands(rng, B, res, C, heads, ws, shift):
    L, Ch = ws * ws, 4 * C
    n = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)  # noqa: E731
    ops = dict(
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
    x = n(B, res, res, C)
    mask = _shift_attn_mask(res, res, ws, shift) if shift else None
    dp = np.tile(np.asarray([[1.0, 1.0], [0.0, 2.0]], np.float32), (B // 2, 1))
    return x, ops, mask, dp


def test_shift_mask_matches_jax():
    np.testing.assert_array_equal(_shift_attn_mask(12, 12, 4, 2), j_shift_attn_mask(12, 12, 4, 2))


@pytest.mark.parametrize(
    "res,ws,shift,dim,heads,B",
    [
        (8, 4, 0, 16, 2, 2),    # multi-window
        (8, 4, 2, 16, 2, 2),    # shifted (mask)
        (4, 4, 0, 16, 4, 4),    # single window, several images
        (12, 4, 2, 8, 2, 2),    # several window rows per image, shifted
    ],
)
def test_block_matches_jax_f32(rng, res, ws, shift, dim, heads, B):
    x, ops, mask, dp = _block_operands(rng, B, res, dim, heads, ws, shift)
    kw = dict(window_size=ws, num_heads=heads, eps=1e-5)
    j_args = [jnp.asarray(ops[k]) for k in NAMES]
    j_mask = None if mask is None else jnp.asarray(mask)
    want_fused = np.asarray(j_fused_swin_block(
        jnp.asarray(x), *j_args, mask=j_mask, droppath_keep=jnp.asarray(dp),
        interpret=True, shift=shift, **kw))
    xr = np.roll(x, (-shift, -shift), (1, 2))
    want_ref = np.roll(np.asarray(j_block_reference(
        jnp.asarray(xr), *j_args, jnp.asarray(dp), j_mask, **kw)), (shift, shift), (1, 2))

    t_args = [torch.from_numpy(ops[k]) for k in NAMES]
    t_mask = None if mask is None else torch.from_numpy(mask)
    got_ref = torch.roll(fb.block_reference(
        torch.from_numpy(xr), *t_args, torch.from_numpy(dp), t_mask, **kw), (shift, shift), (1, 2))
    fb.reset_launch_counts()
    got_fused = fb.fused_swin_block(torch.from_numpy(x), *t_args, mask=t_mask,
                                    droppath_keep=torch.from_numpy(dp), shift=shift, **kw)
    # CPU tensors take the plain versions: nothing is launched or counted
    assert all(v == 0 for v in fb.launch_counts().values())

    for got in (got_ref.numpy(), got_fused.numpy()):
        np.testing.assert_allclose(got, want_fused, **F32_TOL)
        np.testing.assert_allclose(got, want_ref, **F32_TOL)


def test_block_matches_jax_bf16(rng):
    """bf16 activations and weights: both sides round at the same points
    (qkv, q/k-hat, p, o, h1, GELU output, y); an f32 sum in another order can
    flip a rounding by one bf16 ulp, and the chain carries a few such flips.
    Outputs are O(1) (post-norm residual), whose ulp is 2^-7..2^-6, so the
    bound is 0.05 absolute with at most 0.5% of elements above 2 ulps."""
    res, ws, shift, dim, heads, B = 8, 4, 2, 16, 2, 2
    x, ops, mask, dp = _block_operands(rng, B, res, dim, heads, ws, shift)
    kw = dict(window_size=ws, num_heads=heads, eps=1e-5)
    bf = jnp.bfloat16
    j_args = [jnp.asarray(ops[k]).astype(bf) if k != "logit_scale" else jnp.asarray(ops[k])
              for k in NAMES]
    xr = np.roll(x, (-shift, -shift), (1, 2))
    want = np.asarray(j_block_reference(
        jnp.asarray(xr).astype(bf), *j_args, jnp.asarray(dp), jnp.asarray(mask).astype(bf), **kw
    ).astype(jnp.float32))
    want = np.roll(want, (shift, shift), (1, 2))
    t_args = [torch.from_numpy(ops[k]).to(torch.bfloat16) if k != "logit_scale"
              else torch.from_numpy(ops[k]) for k in NAMES]
    got = fb.fused_swin_block(
        torch.from_numpy(x).to(torch.bfloat16), *t_args,
        mask=torch.from_numpy(mask).to(torch.bfloat16), droppath_keep=torch.from_numpy(dp),
        shift=shift, **kw,
    )
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 0.05, diff.max()
    assert np.mean(diff > 2 * 2.0 ** -7 * np.maximum(np.abs(want), 1.0)) <= 0.005


def _carry_backbone(j_cfg, t_cfg, impl, x, rng):
    jmod = JSwinV2(j_cfg, attention_impl="xla")
    params = jmod.init(jax.random.key(0), jnp.asarray(x))
    m = FlaxMapper(jax.tree.map(np.asarray, params["params"]))
    m.swinv2((), "", t_cfg)
    tmod = SwinV2(t_cfg, attention_impl=impl)
    load_reference_state_dict(tmod, m.out)
    return jmod, params, tmod.eval()


@pytest.mark.parametrize("impl", ["eager", "fused"])
def test_two_stage_backbone_matches_jax(rng, impl):
    """Two stages, shifted blocks and a patch merge: the port's eager path and
    its kernel path (plain versions on CPU) against JAX SwinV2 on the XLA path
    and on the fused Pallas path."""
    kw = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
              window_size=4, drop_path_rate=0.0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jmod, params, tmod = _carry_backbone(JSwinV2Config(**kw), SwinV2Config(**kw), impl, x, rng)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    want_xla = np.asarray(jmod.apply(params, jnp.asarray(x)))
    want_fused = np.asarray(JSwinV2(JSwinV2Config(**kw), attention_impl="fused").apply(
        params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want_xla, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got, want_fused, atol=3e-5, rtol=3e-5)


def test_window_clamped_to_resolution(rng):
    """Resolution below the window: ws clamps to the resolution (L = 16) and
    the second block's shift drops to 0 (``_compute_window_shift``)."""
    kw = dict(image_size=16, patch_size=4, embed_dim=16, depths=(2,), num_heads=(2,),
              window_size=8, drop_path_rate=0.0, pretrained_window_sizes=(0,))
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jmod, params, tmod = _carry_backbone(JSwinV2Config(**kw), SwinV2Config(**kw), "fused", x, rng)
    blocks = tmod.encoder.layers[0].blocks
    assert [(b.ws, b.sh) for b in blocks] == [(4, 0), (4, 0)]
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, jnp.asarray(x))),
                               atol=3e-5, rtol=3e-5)


def test_fused_operands_are_built_once_per_set_of_weights(rng):
    """Without autograd the kernel path prepares each block's operands once
    and reuses them; an in-place edit of a weight rebuilds them, so the
    kernel path keeps agreeing with the eager path (3e-5, as above)."""
    kw = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2,), num_heads=(2,),
              window_size=4, drop_path_rate=0.0, pretrained_window_sizes=(0,))
    tmod = SwinV2(SwinV2Config(**kw), attention_impl="fused").eval()
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    blk = tmod.encoder.layers[0].blocks[1]
    with torch.no_grad():
        tmod(x)
        first = blk._fused_cache[1]
        tmod(x)
        assert blk._fused_cache[1] is first
        blk.intermediate.dense.weight.mul_(1.5)
        blk.attention.self.logit_scale.add_(0.5)
        got = tmod(x)
        assert blk._fused_cache[1] is not first
        tmod.set_attention_impl("eager")
        want = tmod(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=3e-5)
    tmod.set_attention_impl("fused")
    np.testing.assert_allclose(tmod(x).detach().numpy(), got.numpy(), atol=0, rtol=0)


def test_fused_operands_follow_fresh_weights_on_recycled_storage(rng):
    """A train step hands the model fresh copies of its weights on every step
    (``train/step.py`` casts them anew, ``functional_call`` installs them at
    version 0), and an allocator may place the next step's copies on the
    storage of the last step's. Here the second copies are new tensors on the
    first copies' numpy buffers, at version 0, with other values: the kernel
    path must rebuild its operands for them and agree with the eager path on
    the same weights (3e-5, as above)."""
    kw = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2,), num_heads=(2,),
              window_size=4, drop_path_rate=0.0, pretrained_window_sizes=(0,))
    tmod = SwinV2(SwinV2Config(**kw), attention_impl="fused").eval()
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    arrays = {n: p.detach().numpy().copy() for n, p in tmod.named_parameters()}
    first = {n: torch.from_numpy(a) for n, a in arrays.items()}
    with torch.no_grad():
        torch.func.functional_call(tmod, first, (x,))
        for a in arrays.values():
            a *= 1.5
        second = {n: torch.from_numpy(a) for n, a in arrays.items()}
        assert all(second[n].data_ptr() == first[n].data_ptr() and second[n]._version == 0
                   for n in arrays)
        got = torch.func.functional_call(tmod, second, (x,))
        tmod.set_attention_impl("eager")
        want = torch.func.functional_call(tmod, second, (x,))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=3e-5)


def test_ln_residual_without_droppath_scales_keeps_the_residual_whole(rng):
    """dp None (inference) is dp = 1 for every image, bit for bit."""
    z, res = (torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)) for _ in range(2))
    g, b = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
    ones = fb.ln_residual(z, res, g, b, torch.ones(2, 2), 1, 1e-5, torch.float32, keep_f32=True)
    none = fb.ln_residual(z, res, g, b, None, 1, 1e-5, torch.float32, keep_f32=True)
    assert all(torch.equal(u, v) for u, v in zip(ones, none))
