"""Host-side tile plan and arithmetic of the bf16 wgmma GEMMs gemm_bias_act
and gemm_dgrad (``cs_vit_tpu_torch/ops/fused_block.py``), on the CPU.

The two kernels run only on the card; what decides their work on the host is
plain Python, held here: the output tile and ring of ``_gemm_plan`` and the
tiles they imply (``_gemm_tiles``), at every Swin-B-256 block shape of
``chip_smoke.GEOMS`` and at ``chip_smoke.GEMM_EDGE_SHAPES``. Neither kernel
splits its reduction, so no partials are written or summed: each output
element is one block's sum. The arithmetic the kernels run is emulated in
PyTorch at their rounding points (dY rounded to bf16 as it is read, f32 sums
of 64-deep stages, bias and GELU or GELU' in f32, one rounding to the output
dtype) and held against the plain versions at ``chip_smoke.TOL``. The inputs
are numpy draws from a seed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cs_vit_tpu_torch.ops import fused_block as fb

SMS = (132, 114, 78)  # H100 SXM, H100 PCIe, a smaller card
BATCHES = (1, 2, 8)


KERNELS = ("gemm_bias_act", "gemm_dgrad")


def _block_shapes(batches=BATCHES + (64,)):
    """(kernel, stage, M, output columns, reduction) of every forward GEMM
    and input grad of a block: the forward's (N, K) are (3C, C), (C, C),
    (4C, C) and (C, 4C); the input grads' (K, N), dY . W^T back to each
    GEMM's input, are (4C, C), (C, 4C), (C, C) and (C, 3C)."""
    out = []
    for stage, res, C, _, _, _, _ in chip_smoke.GEOMS:
        for B in batches:
            M = B * res * res
            out += [("gemm_bias_act", stage, M, n, r)
                    for n, r in ((3 * C, C), (C, C), (4 * C, C), (C, 4 * C))]
            out += [("gemm_dgrad", stage, M, k, n)
                    for k, n in ((4 * C, C), (C, 4 * C), (C, C), (C, 3 * C))]
    return out


def _edge_shapes():
    """(kernel, M, output columns, reduction) of GEMM_EDGE_SHAPES:
    gemm_bias_act's [M, N] over K and gemm_dgrad's [M, K] over N."""
    return [s for M, K, N in chip_smoke.GEMM_EDGE_SHAPES
            for s in (("gemm_bias_act", M, N, K), ("gemm_dgrad", M, K, N))]


def _all_shapes():
    return [(k, M, n, r) for k, _, M, n, r in _block_shapes()] + _edge_shapes()


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("sms", SMS)
def test_gemm_plan_covers_every_output_once(sms):
    """Each output element lies in exactly one tile, and that tile's block
    sums its whole reduction: no split, no partials to sum."""
    for kernel, M, N, R in _all_shapes():
        bm, bn, _ = fb._gemm_plan(kernel, M, N, R, sms)
        assert (bm, bn) in fb.GEMM_TILES, (kernel, M, N)
        cols, rows = -(-N // bn), -(-M // bm)  # the kernels' grid (x, y)
        assert cols * rows == fb._gemm_tiles(M, N, (bm, bn))
        for extent, tile, count in ((N, bn, cols), (M, bm, rows)):
            covered = np.zeros(extent, np.int64)
            for i in range(count):
                lo, hi = i * tile, min(extent, (i + 1) * tile)
                assert hi > lo, (kernel, M, N, bm, bn)  # no empty tile
                covered[lo:hi] += 1
            assert (covered == 1).all(), (kernel, M, N, bm, bn)


def test_gemm_plan_fills_half_the_sms_at_stages_2_and_3():
    """A Swin-B b8 step's GEMMs at stages 2 and 3 each give at least half of
    the H100's 132 SMs a tile (the WMMA kernels' 64 x 128 tiles gave 64 at
    stage 2's proj and MLP-2 and 32 at stage 3's)."""
    for kernel, stage, M, N, R in _block_shapes(batches=(8,)):
        if stage in (2, 3):
            bm, bn, _ = fb._gemm_plan(kernel, M, N, R, 132)
            assert 2 * fb._gemm_tiles(M, N, (bm, bn)) >= 132, (kernel, stage, M, N, bm, bn)


@pytest.mark.parametrize("sms", SMS)
def test_gemm_plan_takes_the_largest_tile_that_fills_half_the_sms(sms):
    """A smaller tile reads each operand row or column more often: the plan
    takes the first of GEMM_TILES whose tiles fill half of the SMs, and the
    smallest only where none does."""
    for kernel, M, N, R in _all_shapes():
        fits = [t for t in fb.GEMM_TILES if 2 * fb._gemm_tiles(M, N, t) >= sms]
        want = fits[0] if fits else fb.GEMM_TILES[-1]
        assert fb._gemm_plan(kernel, M, N, R, sms)[:2] == want, (kernel, M, N)


def test_gemm_plan_reads_less_than_the_wmma_tiles_at_the_block_shapes():
    """Over a Swin-B b8 step's shapes the planned tiles read fewer operand
    bytes (A once per column of tiles, W once per row) than the WMMA
    kernels' fixed 64 x 128 tiles."""
    a_bytes = {"gemm_bias_act": 2, "gemm_dgrad": 4}  # bf16 A, the f32 dY

    def traffic(kernel, M, N, R, tile):
        return (-(-N // tile[1]) * M * R * a_bytes[kernel]
                + -(-M // tile[0]) * N * R * 2)

    for kernel in KERNELS:
        planned = wmma = 0
        for k, stage, M, N, R in _block_shapes(batches=(8,)):
            if k == kernel:
                planned += traffic(k, M, N, R, fb._gemm_plan(k, M, N, R, 132)[:2])
                wmma += traffic(k, M, N, R, (64, 128))
        assert planned < wmma, kernel


@pytest.mark.parametrize("sms", SMS)
def test_gemm_plan_ring_fits_and_holds_no_stage_the_reduction_cannot_fill(sms):
    """The ring fits GEMM_RING_BYTES (two blocks an SM), holds at least two
    stages where the reduction has two (both kernels hand a stage back one
    stage late or refill it only once its products are done), and none
    that the reduction cannot fill."""
    for kernel, M, N, R in _all_shapes():
        bm, bn, stages = fb._gemm_plan(kernel, M, N, R, sms)
        depth = -(-R // fb.GEMM_DEPTH)
        stage = fb._gemm_stage_bytes(kernel, bm, bn)
        assert 1 <= stages <= min(fb.GEMM_STAGES, depth), (kernel, M, N, R)
        assert stages >= min(2, depth), (kernel, M, N, R)
        assert stages * stage <= max(fb.GEMM_RING_BYTES, 2 * stage), (kernel, M, N, R)


def test_gemm_plan_rings_by_tile():
    """At a long reduction, at stage-2 and stage-3 output shapes of a b8
    step that plan to each tile: gemm_bias_act's rings hold 3, 4 and 6
    stages, gemm_dgrad's 2, 2 and 4 (its f32 dY makes a 128-row stage 48
    or 40 KB), all two blocks an SM."""
    R = 4096
    want = {("gemm_bias_act", 128, 128): 3, ("gemm_bias_act", 128, 64): 4,
            ("gemm_bias_act", 64, 64): 6, ("gemm_dgrad", 128, 128): 2,
            ("gemm_dgrad", 128, 64): 2, ("gemm_dgrad", 64, 64): 4}
    for (kernel, bm, bn), stages in want.items():
        M, N = {(128, 128): (2048, 1024), (128, 64): (2048, 512), (64, 64): (512, 512)}[bm, bn]
        got = fb._gemm_plan(kernel, M, N, R, 132)
        assert got == (bm, bn, stages), (kernel, bm, bn, got)
        assert stages * fb._gemm_stage_bytes(kernel, bm, bn) <= fb.GEMM_RING_BYTES


def _staged_product(a32: torch.Tensor, b32: torch.Tensor) -> torch.Tensor:
    """f32 sum over 64-deep stages of a [M, R] . b [R, N], in stage order,
    as the kernels' accumulators take them (each stage's product in f32)."""
    acc = torch.zeros(a32.shape[0], b32.shape[1], dtype=torch.float32)
    for r0 in range(0, a32.shape[1], fb.GEMM_DEPTH):
        acc += a32[:, r0:r0 + fb.GEMM_DEPTH] @ b32[r0:r0 + fb.GEMM_DEPTH]
    return acc


def _emulate_bias_act(a, w, bias, act, out_dtype):
    v = _staged_product(a.float(), w.float()) + bias.float()
    if act == "gelu":
        v = 0.5 * v * (1.0 + torch.erf(v * 0.7071067811865476))
    return v.to(out_dtype)


def _emulate_dgrad(dy, w, aux, epi, out_dtype):
    v = _staged_product(dy.to(torch.bfloat16).float(), w.float().t())
    if epi == "gelu":
        v = v * fb._gelu_grad(aux.float())
    elif epi == "add":
        v = v + aux.float()
    return v.to(out_dtype)


def _gemm_cases():
    """(M, K, N): a Swin-B block's four GEMMs at C = 128 and 512 on 200 token
    rows (not a multiple of the 64-row tile), and the edge shapes' K and N
    on 72 rows."""
    cases = []
    for C in (128, 512):
        cases += [(200, C, 3 * C), (200, C, C), (200, C, 4 * C), (200, 4 * C, C)]
    cases += [(72, K, N) for _, K, N in chip_smoke.GEMM_EDGE_SHAPES]
    return cases


@pytest.mark.parametrize("shape", _gemm_cases(), ids=lambda s: "M{}_K{}_N{}".format(*s))
def test_gemm_bias_act_kernel_arithmetic_matches_plain_version(shape):
    M, K, N = shape
    rng = np.random.default_rng(M + 7 * K + 13 * N)
    bf = torch.bfloat16
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(bf)
    w = torch.from_numpy((rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)).to(bf)
    bias = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(bf)
    tol = chip_smoke.TOL["bf16"]["kernel"]
    for act in ("none", "gelu"):
        for odt in (bf, torch.float32):
            got = _emulate_bias_act(a, w, bias, act, odt)
            want = fb.gemm_bias_act_reference(a, w, bias, act, odt)
            assert got.dtype == want.dtype and _rel(got, want) <= tol, (act, odt)


@pytest.mark.parametrize("shape", _gemm_cases(), ids=lambda s: "M{}_K{}_N{}".format(*s))
def test_gemm_dgrad_kernel_arithmetic_matches_plain_version(shape):
    """dY [M, N] f32 against W [K, N]: the output [M, K] is the input grad of
    the forward GEMM of the same (K, N)."""
    M, K, N = shape
    rng = np.random.default_rng(M + 11 * K + 17 * N)
    bf, f32 = torch.bfloat16, torch.float32
    dy = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(K, N)) * N ** -0.5).astype(np.float32)).to(bf)
    m1 = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    tol = chip_smoke.TOL["bf16"]["kernel"]
    for epi, aux in (("gelu", m1.to(bf)), ("add", m1.to(bf)), ("add", m1), ("none", None)):
        for odt in (bf, f32):
            got = _emulate_dgrad(dy, w, aux, epi, odt)
            want = fb.gemm_dgrad_reference(dy, w, aux, epi, odt)
            assert got.dtype == want.dtype and _rel(got, want) <= tol, (epi, odt)
