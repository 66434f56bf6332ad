"""The CUDA kernels of cs_vit_tpu_torch against their plain PyTorch versions.

The kernel tests need a CUDA card and ``nvcc`` (the kernels are built from
``cs_vit_tpu_torch/ops/csrc/`` at first use); each one decides inside the
test whether a card is present and skips otherwise. Run them on the card:

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q

(``--noconftest``: tests/conftest.py sets up JAX, which the card's machine
need not have.) The per-kernel cases run ``chip_smoke.kernel_checks``,
``chip_smoke.bwd_kernel_checks``, ``chip_smoke.window_attention_checks`` and
``chip_smoke.attention_checks``, ``chip_smoke.bwd_edge_checks``,
``chip_smoke.gemm_edge_checks`` and ``chip_smoke.ln_edge_checks``, the checks
``chip_smoke.py`` makes, at the Swin-B-256 block geometries (the two attention
forward kernels and the attention backward also at the ws 4 geometries of
``chip_smoke.SMALL_GEOMS`` and with a query row's whole bias at -100;
gemm_wgrad also at ``chip_smoke.WGRAD_EDGE_SHAPES``, gemm_bias_act and
gemm_dgrad at ``chip_smoke.GEMM_EDGE_SHAPES``, the two LayerNorm kernels at
``chip_smoke.LN_EDGE_SHAPES``) and the batches of
``chip_smoke.CHECK_BATCHES`` (so also marked ``slow``) with its stated
tolerances (``chip_smoke.TOL``); the overlap probe's case runs
``chip_smoke.check_probe`` at the probe's own shapes (``chip_smoke.PROBE_TOL``);
the multi-tensor cases (``ops.multi_tensor``) hold the train step's update
against its per-leaf code over tables of a few hundred leaves and of more
than one launch's worth. This file imports no JAX.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from cs_vit_tpu_torch.models.swinv2 import _shift_attn_mask
from cs_vit_tpu_torch.ops import fused_block as fb
from cs_vit_tpu_torch.ops import multi_tensor as mt
from cs_vit_tpu_torch.ops import probe_overlap as po
from cs_vit_tpu_torch.ops import window_attention as wa
from cs_vit_tpu_torch.train import PhaseAdamW


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("dname", ["bf16", "f32"])
@pytest.mark.parametrize("geom", chip_smoke.GEOMS,
                         ids=[f"stage{g[0]}_shift{g[5]}" for g in chip_smoke.GEOMS])
def test_kernels_match_plain_versions(geom, dname):
    """chip_smoke.py's phase-3 check at one geometry and dtype, every batch."""
    _need_card()
    for B in chip_smoke.CHECK_BATCHES:
        fb.reset_launch_counts()
        results = chip_smoke.kernel_checks(torch, fb, dname, geom, B)
        bad = [r for r in results if not r[3] <= r[4]]
        assert not bad, (B, bad)
        # the single-kernel checks (3 GEMM, 1 attention, 2 LN), then one block
        counts = {k: v for k, v in fb.launch_counts().items() if v}
        assert counts == {"gemm_bias_act": 3 + 4, "ln_residual": 2 + 2,
                          "window_attention": 1 + 1, "fused_swin_block": 1}


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("dname", ["bf16", "f32"])
@pytest.mark.parametrize("geom", chip_smoke.GEOMS,
                         ids=[f"stage{g[0]}_shift{g[5]}" for g in chip_smoke.GEOMS])
def test_backward_kernels_match_plain_versions(geom, dname):
    """chip_smoke.py's backward checks at one geometry and dtype, every batch."""
    _need_card()
    for B in chip_smoke.CHECK_BATCHES:
        fb.reset_launch_counts()
        results = chip_smoke.bwd_kernel_checks(torch, fb, dname, geom, B)
        bad = [r for r in results if not r[3] <= r[4]]
        assert not bad, (B, bad)
        # the single-kernel checks (2 LN, 4 dgrad, 3 wgrad, 1 attention), then
        # one block forward (with the backward's MLP-1 recompute) and backward
        counts = {k: v for k, v in fb.launch_counts().items() if v}
        assert counts == {"ln_residual_bwd": 2 + 2, "gemm_dgrad": 4 + 4, "gemm_wgrad": 3 + 4,
                          "window_attention_bwd": 1 + 1, "FusedSwinBlock": 1,
                          "fused_swin_block": 1, "gemm_bias_act": 4 + 1, "ln_residual": 2,
                          "window_attention": 1}


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("dname", ["bf16", "f32"])
def test_backward_kernels_beyond_the_block_geometries(dname):
    """The attention backward at ws 4 (L=16), every batch, and with a query
    row's whole bias at -100; gemm_wgrad at M off its 64-row stage and K, N
    8 more than a multiple of its 128-wide tile."""
    _need_card()
    fb.reset_launch_counts()
    results = chip_smoke.bwd_edge_checks(torch, fb, dname)
    bad = [r for r in results if not r[3] <= r[4]]
    assert not bad, bad
    counts = fb.launch_counts()
    n_attn = len(chip_smoke.SMALL_GEOMS) * len(chip_smoke.CHECK_BATCHES) + len(
        [g for g in chip_smoke.GEOMS + chip_smoke.SMALL_GEOMS
         if (g[0], g[5]) in chip_smoke.MASKED_ROW_GEOMS])
    assert counts["window_attention_bwd"] == n_attn
    assert counts["gemm_wgrad"] == len(chip_smoke.WGRAD_EDGE_SHAPES)


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("dname", ["bf16", "f32"])
def test_gemms_beyond_the_block_geometries(dname):
    """gemm_bias_act and gemm_dgrad at M off their 64- and 128-row tiles and
    K, N 8 more than a multiple of 64 or 128, every activation, epilogue,
    aux and output dtype."""
    _need_card()
    fb.reset_launch_counts()
    results = chip_smoke.gemm_edge_checks(torch, fb, dname)
    bad = [r for r in results if not r[3] <= r[4]]
    assert not bad, bad
    counts = fb.launch_counts()
    n = len(chip_smoke.GEMM_EDGE_SHAPES)
    outs = 2 if dname == "bf16" else 1
    assert counts["gemm_bias_act"] == n * 2 * outs
    assert counts["gemm_dgrad"] == n * (2 + outs) * outs


@pytest.mark.gpu
@pytest.mark.slow
def test_backward_kernels_are_bit_identical_over_two_launches():
    """gemm_wgrad (four shapes), gemm_bias_act (four), gemm_dgrad (four), the
    attention backward and ln_residual_bwd (the cotangent in bf16 and in
    f32) at every block geometry."""
    _need_card()
    assert chip_smoke.check_bit_identical(torch, fb) == 15 * len(chip_smoke.GEOMS)


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["bf16", "f32"])
def test_layer_norm_kernels_beyond_the_block_geometries(dname):
    """ln_residual and ln_residual_bwd at chip_smoke.LN_EDGE_SHAPES: each
    Swin-B width C in {128, 256, 512, 1024} at M of 1, 7 and 1000 and the
    masked widths, with droppath scales and without (dp None); ln_residual
    with res in the compute dtype and in f32, keep_f32 on and off;
    ln_residual_bwd with g in the compute dtype and in f32."""
    _need_card()
    fb.reset_launch_counts()
    results = chip_smoke.ln_edge_checks(torch, fb, dname)
    bad = [r for r in results if not r[3] <= r[4]]
    assert not bad, bad
    dtypes = 2 if dname == "bf16" else 1
    counts = fb.launch_counts()
    assert counts["ln_residual"] == len(chip_smoke.LN_EDGE_SHAPES) * 2 * dtypes * 2
    assert counts["ln_residual_bwd"] == len(chip_smoke.LN_EDGE_SHAPES) * 2 * dtypes


@pytest.mark.gpu
@pytest.mark.parametrize("gname", ["bf16", "f32"])
def test_ln_residual_bwd_is_bit_identical_over_two_launches(gname):
    """dz, dgamma and dbeta of two launches on the same inputs at every
    Swin-B block shape at batch 8 (the sum over rows runs in a fixed order:
    lanes, row groups, cluster ranks, clusters)."""
    _need_card()
    gen = torch.Generator().manual_seed(5)
    gt = {"bf16": torch.bfloat16, "f32": torch.float32}[gname]
    for _, res, C, _, _, _, _ in chip_smoke.GEOMS:
        M = 8 * res * res
        z = torch.randn(M, C, generator=gen).cuda()
        g = torch.randn(M, C, generator=gen).to("cuda", gt)
        gamma = (1 + 0.1 * torch.randn(C, generator=gen)).to("cuda", torch.bfloat16)
        dp = torch.tensor([[1.0, 1.0], [0.0, 2.0]] * 4, device="cuda")
        first = [t.clone() for t in fb.ln_residual_bwd(z, g, gamma, dp, 1, 1e-5)]
        second = fb.ln_residual_bwd(z, g, gamma, dp, 1, 1e-5)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (M, C)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    _need_card()
    a = torch.randn(64, 32, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(32, 20, device="cuda", dtype=torch.bfloat16)  # N not a multiple of 8
    with pytest.raises(ValueError):
        fb.gemm_bias_act(a, w, torch.zeros(20, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # one tensor on the CPU
        fb.gemm_bias_act(a, w[:, :16].contiguous(), torch.zeros(16, dtype=torch.bfloat16))
    a16 = torch.randn(64 * 32 + 1, device="cuda").to(torch.bfloat16)[1:].view(64, 32)
    with pytest.raises(ValueError):  # bf16 not 16-byte aligned
        fb.gemm_bias_act(a16, w[:, :16].contiguous(),
                         torch.zeros(16, device="cuda", dtype=torch.bfloat16))
    z = torch.randn(8, 2048, device="cuda")  # C above LN_MAX_C
    with pytest.raises(ValueError):
        fb.ln_residual(z, z, torch.ones(2048, device="cuda"), torch.zeros(2048, device="cuda"),
                       None, 0, 1e-5, torch.float32)
    qkv = torch.randn(1, 8, 8, 3 * 64, device="cuda")  # head_dim 16
    with pytest.raises(ValueError):
        fb.window_attention(qkv, torch.zeros(4, 64, 64, device="cuda"),
                            torch.ones(4, device="cuda"), window_size=8, num_heads=4)
    n = 8 * 8 * 3 * 64
    qkv = torch.randn(n + 1, device="cuda").to(torch.bfloat16)[1:].view(1, 8, 8, 3 * 64)
    with pytest.raises(ValueError):  # bf16 not 16-byte aligned
        fb.window_attention(qkv, torch.zeros(2, 64, 64, device="cuda", dtype=torch.bfloat16),
                            torch.ones(2, device="cuda"), window_size=8, num_heads=2)


@pytest.mark.gpu
def test_backward_kernels_refuse_what_they_do_not_take():
    _need_card()
    dy = torch.randn(64, 20, device="cuda")  # N not a multiple of 8
    w = torch.randn(32, 20, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fb.gemm_dgrad(dy, w)
    dy16 = torch.randn(64 * 16 + 1, device="cuda")[1:].view(64, 16)
    with pytest.raises(ValueError):  # not 16-byte aligned
        fb.gemm_dgrad(dy16, w[:, :16].contiguous())
    with pytest.raises(ValueError):  # the grad must be f32
        fb.gemm_wgrad(torch.randn(64, 32, device="cuda", dtype=torch.bfloat16),
                      torch.randn(64, 16, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # one tensor on the CPU
        fb.ln_residual_bwd(torch.randn(8, 16, device="cuda"), torch.randn(8, 16),
                           torch.ones(16, device="cuda"), None, 0, 1e-5)
    with pytest.raises(ValueError):  # C not a multiple of 8
        fb.ln_residual_bwd(torch.randn(8, 20, device="cuda"), torch.randn(8, 20, device="cuda"),
                           torch.ones(20, device="cuda"), None, 0, 1e-5)
    z16 = torch.randn(8 * 16 + 1, device="cuda")[1:].view(8, 16)
    with pytest.raises(ValueError):  # not 16-byte aligned
        fb.ln_residual_bwd(z16, torch.randn(8, 16, device="cuda"), torch.ones(16, device="cuda"),
                           None, 0, 1e-5)
    qkv = torch.randn(1, 8, 8, 3 * 64, device="cuda")  # head_dim 16
    with pytest.raises(ValueError):
        fb.window_attention_bwd(qkv, torch.randn(1, 8, 8, 64, device="cuda"),
                                torch.zeros(4, 64, 64, device="cuda"),
                                torch.ones(4, device="cuda"), window_size=8, num_heads=4)


def test_cpu_tensors_take_the_plain_backward_versions():
    """On CPU tensors each backward wrapper returns its plain version's result
    and counts no launch, and so does FusedSwinBlock's backward."""
    g = torch.Generator().manual_seed(1)
    fb.reset_launch_counts()
    dy, w, aux = (torch.randn(8, 24, generator=g), torch.randn(16, 24, generator=g),
                  torch.randn(8, 16, generator=g))
    assert torch.equal(fb.gemm_dgrad(dy, w, aux, "gelu"),
                       fb.gemm_dgrad_reference(dy, w, aux, "gelu"))
    a = torch.randn(8, 16, generator=g)
    for got, want in zip(fb.gemm_wgrad(a, dy), fb.gemm_wgrad_reference(a, dy)):
        assert torch.equal(got, want)
    z, gy, dp = torch.randn(8, 16, generator=g), torch.randn(8, 16, generator=g), torch.ones(2, 2)
    for got, want in zip(fb.ln_residual_bwd(z, gy, torch.ones(16), dp, 1, 1e-5),
                         fb.ln_residual_bwd_reference(z, gy, torch.ones(16), dp, 1, 1e-5)):
        assert torch.equal(got, want)
    qkv, dout = torch.randn(1, 8, 8, 48, generator=g), torch.randn(1, 8, 8, 16, generator=g)
    kw = dict(window_size=4, num_heads=2, shift=2)
    mask = torch.from_numpy(_shift_attn_mask(8, 8, 4, 2))
    bias, scale = torch.rand(2, 16, 16, generator=g), torch.full((2,), 10.0)
    for got, want in zip(fb.window_attention_bwd(qkv, dout, bias, scale, mask, **kw),
                         fb.window_attention_bwd_reference(qkv, dout, bias, scale, mask, **kw)):
        assert torch.equal(got, want)
    assert all(v == 0 for v in fb.launch_counts().values())


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch."""
    g = torch.Generator().manual_seed(0)
    a, w, b = (torch.randn(8, 16, generator=g), torch.randn(16, 24, generator=g),
               torch.randn(24, generator=g))
    fb.reset_launch_counts()
    assert torch.equal(fb.gemm_bias_act(a, w, b, act="gelu"),
                       fb.gemm_bias_act_reference(a, w, b, act="gelu"))
    z, res = torch.randn(8, 16, generator=g), torch.randn(8, 16, generator=g)
    dp = torch.ones(2, 2)
    ydt, y32 = fb.ln_residual(z, res, torch.ones(16), torch.zeros(16), dp, 0, 1e-5,
                              torch.float32, keep_f32=True)
    assert torch.equal(y32, fb.ln_residual_reference(z, res, torch.ones(16), torch.zeros(16),
                                                     dp, 0, 1e-5, torch.float32)[0])
    qkv = torch.randn(1, 8, 8, 48, generator=g)
    kw = dict(window_size=4, num_heads=2, shift=2)
    mask = torch.from_numpy(_shift_attn_mask(8, 8, 4, 2))
    bias, scale = torch.rand(2, 16, 16, generator=g), torch.full((2,), 10.0)
    assert torch.equal(fb.window_attention(qkv, bias, scale, mask, **kw),
                       fb.window_attention_reference(qkv, bias, scale, mask, **kw))
    assert all(v == 0 for v in fb.launch_counts().values())


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("dname", ["bf16", "f32"])
@pytest.mark.parametrize("geom", chip_smoke.GEOMS,
                         ids=[f"stage{g[0]}_shift{g[5]}" for g in chip_smoke.GEOMS])
def test_window_attention_kernel_matches_plain_version(geom, dname):
    """chip_smoke.py's attention-only kernel check at one geometry and dtype,
    every batch and every image count of the temporal paths: one launch
    each."""
    _need_card()
    for B in chip_smoke.CHECK_BATCHES + chip_smoke.WA_PATH_BATCHES:
        wa.reset_launch_counts()
        results = chip_smoke.window_attention_checks(torch, wa, dname, geom, B)
        assert all(r[3] <= r[4] for r in results), (B, results)
        assert wa.launch_counts() == {"fused_window_attention": 1}


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("dname", ["bf16", "f32"])
@pytest.mark.parametrize("geom", chip_smoke.SMALL_GEOMS,
                         ids=[f"L16_shift{g[5]}" for g in chip_smoke.SMALL_GEOMS])
def test_window_attention_kernels_at_small_windows(geom, dname):
    """chip_smoke.py's checks of the two window-attention forward kernels at
    a ws 4 (L=16) geometry, which the Swin-B path does not reach, every
    batch; at the shifted geometry also with one query row's whole bias at
    -100."""
    _need_card()
    for B in chip_smoke.CHECK_BATCHES:
        fb.reset_launch_counts()
        wa.reset_launch_counts()
        results = chip_smoke.attention_checks(torch, fb, wa, dname, geom, B)
        if (geom[0], geom[5]) in chip_smoke.MASKED_ROW_GEOMS:
            results += chip_smoke.attention_checks(torch, fb, wa, dname, geom, B,
                                                   masked_row=True)
        assert all(r[3] <= r[4] for r in results), (B, results)
        n = len(results) // 2
        assert fb.launch_counts()["window_attention"] == n
        assert wa.launch_counts() == {"fused_window_attention": n}


@pytest.mark.gpu
def test_window_attention_kernel_refuses_what_it_does_not_take():
    _need_card()
    q = torch.randn(4, 2, 16, 32, device="cuda")
    bias, scale = torch.zeros(1, 2, 16, 16, device="cuda"), torch.ones(2, device="cuda")
    with pytest.raises(ValueError):  # head_dim 16
        wa.fused_window_attention(q[..., :16].contiguous(), q[..., :16].contiguous(),
                                  q[..., :16].contiguous(), bias, scale)
    with pytest.raises(ValueError):  # L = 32
        wa.fused_window_attention(*(torch.randn(4, 2, 32, 32, device="cuda"),) * 3,
                                  torch.zeros(1, 2, 32, 32, device="cuda"), scale)
    with pytest.raises(ValueError):  # B_ not a multiple of nW
        wa.fused_window_attention(q, q, q, torch.zeros(3, 2, 16, 16, device="cuda"), scale)
    with pytest.raises(ValueError):  # f16
        wa.fused_window_attention(*(q.half(),) * 3, bias, scale)
    qb = torch.randn(q.numel() + 1, device="cuda").to(torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError):  # bf16 not 16-byte aligned
        wa.fused_window_attention(qb, qb, qb, bias.to(torch.bfloat16), scale)
    with pytest.raises(RuntimeError):  # under autograd: the kernel has no backward
        wa.fused_window_attention(q.clone().requires_grad_(), q, q, bias, scale)
    with torch.no_grad():  # the same call without autograd runs
        out = wa.fused_window_attention(q.clone().requires_grad_(), q, q, bias, scale)
    assert out.shape == q.shape


@pytest.mark.gpu
def test_probe_kernel_matches_plain_version():
    _need_card()
    po.reset_launch_counts()
    chip_smoke.check_probe(torch, po)
    assert po.launch_counts() == {"probe_overlap": len(po.MODES) * len(chip_smoke.PROBE_ROWS)}


@pytest.mark.gpu
def test_probe_kernel_refuses_what_it_does_not_take():
    _need_card()
    a = torch.randn(512, 512, device="cuda").to(torch.bfloat16)
    x = torch.randn(2048, 512, device="cuda")
    with pytest.raises(ValueError):  # M not a multiple of 64
        po.probe_overlap(a[:100].contiguous(), a, x, "both")
    with pytest.raises(ValueError):  # f32 products
        po.probe_overlap(a.float(), a.float(), x, "both")
    with pytest.raises(ValueError):  # x not a whole number of chunks
        po.probe_overlap(a, a, x[:, :100].contiguous(), "both")
    with pytest.raises(ValueError):
        po.probe_overlap(a, a, x, "vpu")


def test_cpu_tensors_take_the_plain_attention_and_probe_versions():
    """On CPU tensors the attention-only kernel's and the probe's wrappers
    return their plain versions' results and count no launch."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(8, 2, 16, 32, generator=g) for _ in range(3))
    bias, scale = torch.randn(4, 2, 16, 16, generator=g), torch.full((2,), 10.0)
    wa.reset_launch_counts()
    po.reset_launch_counts()
    assert torch.equal(wa.fused_window_attention(q, k, v, bias, scale),
                       wa.fused_window_attention_reference(q, k, v, bias, scale))
    a, w = (torch.randn(64, 64, generator=g).to(torch.bfloat16) for _ in range(2))
    x = torch.randn(4, 64, generator=g)
    for mode in po.MODES:
        for got, want in zip(po.probe_overlap(a, w, x, mode),
                             po.probe_overlap_reference(a, w, x, mode)):
            assert torch.equal(got, want)
    assert wa.launch_counts() == {"fused_window_attention": 0}
    assert po.launch_counts() == {"probe_overlap": 0}


# --- the train step's update: ops.multi_tensor -----------------------------------------

# the leaves' shapes, in turn: empty and 1-element leaves, sizes on and off a
# float4 and a chunk (16384) boundary, several chunks; 2-D ones whose grads
# come stored transposed (the block kernels' weight grads), on and off the
# 32 x 32 tiles, over several chunks of tiles; a conv weight whose grad comes
# channels-last
MT_SHAPES = ((0,), (1,), (3,), (4,), (17,), (255,), (1031,), (16383,), (16384,), (16385,),
             (40001,), (2,), (640,), (7,), (33, 47), (128, 128), (3, 5461), (257, 65),
             (96, 1), (8, 3, 4, 4))


def _mt_leaves(n, seed):
    """`n` f32 leaves on the card of the shapes MT_SHAPES in turn; every 9th
    one a view one element into its storage (contiguous, not on 16 bytes)."""
    gen = torch.Generator().manual_seed(seed)
    leaves = []
    for i in range(n):
        shape = MT_SHAPES[i % len(MT_SHAPES)]
        size = int(np.prod(shape))
        data = torch.randn(size + 1, generator=gen).cuda()
        data = data[1:] if i % 9 == 4 else data[:size].clone()
        leaves.append(torch.nn.Parameter(data.view(shape)))
    return leaves


def _mt_grads(leaves, scale, seed, nan=False):
    """Grads of `leaves`, the 2-D ones stored transposed, the 4-D ones
    channels-last."""
    gen = torch.Generator().manual_seed(seed)
    grads = [(torch.randn(p.shape, generator=gen) * scale).cuda() for p in leaves]
    if nan:
        grads[9].view(-1)[5] = float("nan")
    return [g.t().contiguous().t() if g.dim() == 2
            else g.contiguous(memory_format=torch.channels_last) if g.dim() == 4 else g
            for g in grads]


def _assert_leaves_close(got, want, what, rel=0.0, scales=None):
    """Each leaf to f32 round-off: a few ulps, and `rel` (what the clip's
    scale carries over from the norms' gap), of its largest element, or of
    `scales` (a bound of each element's terms, for a sum that may cancel)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if b.numel():
            top = b.detach().abs().max().nan_to_num(1.0) if scales is None else scales[i]
            tol = (8 * torch.finfo(torch.float32).eps + rel) * top + 1e-30
            close = ((a - b).abs() <= tol) | (a.isnan() & b.isnan())
            assert bool(close.all()), (what, i, float((a - b).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["below_above", "nan"])
@pytest.mark.parametrize("n", [300, 1700], ids=["leaves300", "leaves1700"])
def test_multi_tensor_update_matches_the_per_leaf_path(n, case):
    """Three clips and AdamW updates (weight decay on) by the kernels against
    the per-leaf code (``torch.optim.AdamW``'s step and the clip's host
    branch) from the same grads (2-D ones stored transposed, 4-D ones
    channels-last): norms under and over the clip, or NaN at the second
    step; 1700 leaves take more than one launch's table. The kernels
    sum the squares in f64, the per-leaf code in f32 (its error grows with
    the leaves summed, ~1e-6 at 1700): a clipped grad and the moments differ
    by that much more than their round-off (the squares' moment twice), the
    parameters not (Adam's step does not scale with the grads)."""
    _need_card()
    fast, slow = _mt_leaves(n, 1), _mt_leaves(n, 1)
    fast_opt, slow_opt = PhaseAdamW(fast, 1e-3), PhaseAdamW(slow, 1e-3)
    slow_opt._card = lambda: None  # the per-leaf code on the card
    mt.reset_launch_counts()
    scales = (1e-3, 1.0, 1e-3) if case == "below_above" else (1e-3, 1e-3, 1e-3)
    rel, g_top = 0.0, [torch.zeros_like(p) for p in slow]
    for k, scale in enumerate(scales):
        grads = _mt_grads(fast, scale, 10 + k, nan=case == "nan" and k == 1)
        for a, b, g in zip(fast, slow, grads):
            a.grad, b.grad = g.clone(), g.clone()
        norms = [opt.clip_grads_() for opt in (fast_opt, slow_opt)]
        for opt in (fast_opt, slow_opt):
            opt.step()
        torch.cuda.synchronize()
        if case == "nan" and k == 1:
            assert torch.isnan(norms[0]) and torch.isnan(norms[1])
        else:
            gap = float((norms[0] - norms[1]).abs() / norms[1])
            assert gap <= 1e-5, (k, float(norms[0]), float(norms[1]))
            rel = max(rel, gap)  # the moments keep every step's
            assert (float(norms[0]) < 5.0) == (scale < 0.1)
        _assert_leaves_close([p.grad for p in fast], [p.grad for p in slow], f"grad {k}", rel)
        _assert_leaves_close(fast, slow, f"param {k}")
        # a moment is a weighted sum of the clipped grads so far (of their
        # squares), whose terms can cancel: bound each element by the largest
        g_top = [torch.maximum(t, p.grad.detach().abs()) for t, p in zip(g_top, slow)]
        for key, top in (("exp_avg", g_top), ("exp_avg_sq", [t * t for t in g_top])):
            _assert_leaves_close([fast_opt.state[p][key] for p in fast],
                                 [slow_opt.state[p][key] for p in slow], f"{key} {k}", 2 * rel,
                                 top)
    assert fast_opt.leaves_multi_tensor == 3 * n and fast_opt.leaves_per_leaf == 0
    assert slow_opt.leaves_per_leaf == 3 * n and slow_opt.leaves_multi_tensor == 0
    assert mt.launch_counts() == {"squares": 3, "clip_": 3, "adamw_": 3}


@pytest.mark.gpu
def test_multi_tensor_norm_is_bit_identical_over_two_launches():
    _need_card()
    for n in (300, 1700):
        grads = _mt_grads(_mt_leaves(n, 2), 1.0, 3)
        half = n // 3  # the rest as shards of tensor parallelism
        first = mt.squares(grads[:half], grads[half:])
        second = mt.squares(grads[:half], grads[half:])
        want = mt.squares_reference([g.cpu() for g in grads[:half]],
                                    [g.cpu() for g in grads[half:]])
        assert torch.equal(first, second), (n, first, second)
        assert torch.allclose(first.cpu(), want, rtol=1e-6), (n, first, want)


@pytest.mark.gpu
def test_multi_tensor_kernels_refuse_what_they_do_not_take():
    _need_card()
    g = [torch.randn(8, 4, device="cuda") for _ in range(3)]
    norm = torch.full((1,), 10.0, device="cuda")
    for bad in (torch.randn(8, 8, device="cuda")[:, ::2],     # not dense
                torch.randn(8, 4, device="cuda").double(),      # not f32
                torch.randn(8, 4, device="cuda").bfloat16(),
                torch.randn(8, 4)):                             # on another device
        table = [*g, bad]
        with pytest.raises(ValueError):
            mt.squares(table, [])
        with pytest.raises(ValueError):
            mt.clip_(table, norm, 5.0)
        with pytest.raises(ValueError):
            mt.adamw_(table, table, table, table, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                      weight_decay=0.01, step=1)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01, step=1)
    with pytest.raises(ValueError):  # a leaf's grad of another shape
        mt.adamw_(g, [*g[:2], torch.randn(4, 8, device="cuda")], g, g, **kw)
    with pytest.raises(ValueError):  # a parameter stored transposed
        mt.adamw_([*g[:2], g[2].t().contiguous().t()], g, g, g, **kw)
    with pytest.raises(ValueError):  # a dense grad neither contiguous nor transposed
        w = [torch.randn(2, 3, 4, 4, device="cuda") for _ in range(2)]
        mt.adamw_(w, [w[0], w[1].contiguous(memory_format=torch.channels_last)], w, w, **kw)
    with pytest.raises(ValueError):  # the norm on the host
        mt.clip_(g, norm.cpu(), 5.0)


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


@pytest.mark.gpu
def test_a_train_step_makes_six_syncs_and_none_at_the_clip(tmp_path):
    """A profiled bf16 spatial step of the flagship (Swin-B-256, the block
    kernels, b2) on the card, its loss read as the benchmark reads it: 6
    host syncs (the loss's finiteness, the forward's four pageable copies,
    the loss read), none in a ``csvit.sync.clip`` span; every leaf, the
    block kernels' transposed weight grads among them, takes the kernels."""
    _need_card()
    from cs_vit_tpu_torch import utils

    model = chip_smoke.train_model(torch)
    state, step = chip_smoke.new_step(torch, model, torch.bfloat16)
    batch = chip_smoke.train_batch(torch, 2, seed=4)
    for _ in range(2):  # the first step makes AdamW's state
        state, metrics = step(state, batch, None)
        float(metrics["loss"])
    torch.cuda.synchronize()
    with utils.trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("unit"):  # what the benchmark counts in
            state, metrics = step(state, batch, None)
            float(metrics["loss"])
    with open(prof.trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") != "gpu_user_annotation"]  # the host's events

    def inside(e, s):
        return s["ts"] <= e["ts"] and e["ts"] + e.get("dur", 0) <= s["ts"] + s["dur"]

    unit = next(e for e in events if e.get("name") == "unit")
    syncs = [e for e in events if e.get("name") in SYNC_CALLS and inside(e, unit)]
    named = [e for e in events if str(e.get("name", "")).startswith("csvit.sync.")]
    where = " ".join("+".join(sorted({s["name"][11:] for s in named if inside(e, s)})) or "-"
                     for e in syncs)  # each sync's csvit.sync site, "-" for none
    assert len(syncs) == 6, where
    assert sorted(where.split()) == sorted(["mano_parents", "mano_bottom", "bone_src",
                                            "bone_dst", "finite", "-"]), where  # "-": the loss read
    assert not [e for e in named if e["name"] == "csvit.sync.clip"]
    opt = state.optimizer
    assert opt.leaves_per_leaf == 0 and opt.leaves_multi_tensor == 3 * len(opt.params())


@pytest.mark.gpu
def test_update_kernels_hold_at_the_flagship_leaves():
    """``chip_smoke.check_update`` on the card: the three wrappers at a
    flagship bf16 step's 651 trained leaves and their grads as the backward
    left them (transposed weight grads, the conv's channels-last one), each
    within a few f32 ulps of its plain version; one launch of each wrapper a
    step, and the kernels line's row."""
    _need_card()
    model = chip_smoke.train_model(torch)
    state, step = chip_smoke.new_step(torch, model, torch.bfloat16)
    batch = chip_smoke.train_batch(torch, 2, seed=4)
    launches = chip_smoke.Launches(fb, mt)
    for _ in range(2):
        launches.reset_launch_counts()
        state, metrics = step(state, batch, None)
        float(metrics["loss"])
    counts = launches.launch_counts()
    assert {k: counts[k] for k in chip_smoke.UPDATE_EXPECT} == chip_smoke.UPDATE_EXPECT
    row = chip_smoke.check_update(torch, mt, state)
    assert row["launches"] == 4 and row["max_abs_err"] < 1e-3
    assert 0 < row["bound_ms"] < row["ms"] < row["library_ms"]


@pytest.mark.gpu
def test_sharded_norm_on_the_card_all_reduces_the_shards_sum(monkeypatch):
    """Tensor parallelism's norm on the card: the kernels' shards' sum is the
    tensor all-reduced (faked: two ranks holding the same shards), the
    replicated leaves counted once."""
    _need_card()
    leaves = _mt_leaves(300, 5)
    opt = PhaseAdamW(leaves, 1e-3)
    opt.sharded = [i % 3 == 1 for i in range(len(leaves))]
    grads = _mt_grads(leaves, 1.0, 6)
    reduced = []

    def all_reduce(t, group=None):
        reduced.append(t.clone())
        t.mul_(2)

    monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
    norm = opt.grad_norm(grads)
    want = mt.squares_reference([g.cpu() for g, s in zip(grads, opt.sharded) if not s],
                                [g.cpu() for g, s in zip(grads, opt.sharded) if s])
    assert len(reduced) == 1 and reduced[0].is_cuda
    assert torch.allclose(reduced[0].cpu(), want[1], rtol=1e-6), (reduced[0], want)
    whole = (want[0].double() + 2 * want[1].double()).sqrt().float()
    assert torch.allclose(norm.cpu(), whole, rtol=1e-6), (norm, whole)
