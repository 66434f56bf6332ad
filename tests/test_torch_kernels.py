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
``chip_smoke.check_probe`` at the probe's own shapes (``chip_smoke.PROBE_TOL``).
This file imports no JAX.
"""

import pytest
import torch

import chip_smoke
from cs_vit_tpu_torch.models.swinv2 import _shift_attn_mask
from cs_vit_tpu_torch.ops import fused_block as fb
from cs_vit_tpu_torch.ops import probe_overlap as po
from cs_vit_tpu_torch.ops import window_attention as wa


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
