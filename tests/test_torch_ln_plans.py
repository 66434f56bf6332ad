"""Host-side launch plan of the two LayerNorm-residual kernels, ln_residual
and ln_residual_bwd (``cs_vit_tpu_torch/ops/fused_block.py``), on the CPU.

The kernels run only on the card; what decides their work on the host is
plain Python, held here: the lanes, chunks, row groups, grid and rows per
block of ``_ln_plan`` and the backward's partial scratch
(``ln_bwd_partial_floats``), at every Swin-B-256 block shape of
``chip_smoke.GEOMS`` at batch 1, 2 and 8 and at ``chip_smoke.LN_EDGE_SHAPES``
(M of 1, 7 and 1000; the masked widths). The rows and columns each lane
takes are those of the kernels' loops (``csrc/ln_core.cuh``), and the
backward's fixed-order sum of the dgamma/dbeta partials (lanes over their
rows, the block over its row groups, a cluster over its blocks by slices of
columns, the last block of each rank over the clusters) is emulated in
PyTorch and held against the plain version at ``chip_smoke.TOL``. The inputs
are numpy draws from a seed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cs_vit_tpu_torch.ops import fused_block as fb

SMS = (132, 114, 78)  # H100 SXM, H100 PCIe, a smaller card
BATCHES = (1, 2, 8)
KERNELS = ("ln_residual", "ln_residual_bwd")


def _shapes():
    """(M, C) of every Swin-B block at BATCHES, then LN_EDGE_SHAPES."""
    blocks = [(B * res * res, C) for _, res, C, _, _, _, _ in chip_smoke.GEOMS for B in BATCHES]
    return list(dict.fromkeys(blocks + list(chip_smoke.LN_EDGE_SHAPES)))


def _rows_of(M, plan):
    """[(block, group, row)] in the order each group takes its rows: block b
    of the grid's G takes [b M / G, (b + 1) M / G) a group's width at a time,
    group g taking the pass's g-th row where it is in the block's range."""
    _, _, groups, blocks = plan
    out = []
    for b in range(blocks):
        r0, r1 = b * M // blocks, (b + 1) * M // blocks
        for base in range(r0, r1, groups):
            out += [(b, g, base + g) for g in range(groups) if base + g < r1]
    return out


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("sms", SMS)
def test_ln_plan_covers_every_row_and_column_once(sms, kernel):
    """Each row is taken by exactly one (block, group), and each of its 8-column
    chunks by exactly one lane of the group; no lane holds a chunk index that
    lies wholly past the row."""
    for M, C in _shapes():
        plan = fb._ln_plan(kernel, M, C, sms)
        lanes, chunks, groups, blocks = plan
        taken = np.zeros(M, np.int64)
        for _, _, row in _rows_of(M, plan):
            taken[row] += 1
        assert (taken == 1).all(), (M, C, plan)
        cols = np.zeros(C, np.int64)
        for lane in range(lanes):
            for i in range(chunks):
                col = 8 * (lane + lanes * i)
                if col < C:
                    cols[col:col + 8] += 1
        assert (cols == 1).all(), (M, C, plan)
        assert 8 * lanes * (chunks - 1) < C <= 8 * lanes * chunks, (C, plan)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("sms", SMS)
def test_ln_plan_blocks_fit_the_kernels(sms, kernel):
    """Whole warps of at most LN_THREADS threads (the row sums shuffle over
    whole warps; a row group wider than a warp is the whole block, whose
    barriers its row sums take), whole clusters of blocks, rows shared
    evenly (at most one apart), and no more than the kernel's
    LN_BLOCKS_PER_SM blocks an SM beyond the rounding to clusters."""
    for M, C in _shapes():
        lanes, chunks, groups, blocks = plan = fb._ln_plan(kernel, M, C, sms)
        threads = lanes * groups
        assert threads % 32 == 0 and threads <= fb.LN_THREADS, (M, C)
        assert lanes <= 32 or groups == 1, (M, C)  # a four-warp group is the block
        assert blocks % fb.LN_CLUSTER == 0, (M, C, blocks)
        per_block = np.bincount([b for b, _, _ in _rows_of(M, plan)], minlength=blocks)
        assert per_block.max() - per_block.min() <= 1, (M, C, plan)
        assert blocks < fb.LN_BLOCKS_PER_SM[kernel] * sms + fb.LN_CLUSTER, (M, C, blocks)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("sms", SMS)
def test_ln_plan_gives_every_sm_two_blocks_where_rows_allow(sms, kernel):
    """At least 2 x SMs blocks, every one with rows, wherever M has rows for
    them at the fewest rows a block can take (one warp of row groups): stage
    3 at b8 (512 rows of 1024) no longer runs on 64 eight-row blocks."""
    for M, C in _shapes():
        lanes, _, groups, blocks = plan = fb._ln_plan(kernel, M, C, sms)
        least = max(1, 32 // lanes)
        if -(-M // least) >= 2 * sms:
            with_rows = len({b for b, _, _ in _rows_of(M, plan)})
            assert blocks >= 2 * sms and with_rows == blocks, (M, C, sms, plan)
    assert fb._ln_plan(kernel, 512, 1024, 132)[3] >= 2 * 132


@pytest.mark.parametrize("kernel", KERNELS)
def test_ln_plan_walks_many_rows_at_the_first_stages(kernel):
    """At a Swin-B b8 step's stages 0 and 1 each row group of a full block
    takes several rows, with its gamma (and the backward's partials) kept
    in registers across them; the Swin-B widths run the unmasked builds
    (lanes x chunks x 8 columns == C)."""
    for M, C, passes in ((32768, 128, 4), (8192, 256, 2)):
        lanes, _, groups, blocks = fb._ln_plan(kernel, M, C, 132)
        assert lanes * groups == fb.LN_THREADS, (M, C)
        assert -(-(M // blocks) // groups) >= passes, (M, C, groups, blocks)
    for C in (128, 256, 512, 1024):
        lanes, chunks = fb._ln_lanes(C)
        assert 8 * lanes * chunks == C


def test_ln_bwd_grid_is_two_blocks_an_sm():
    """The backward's grid at the Swin-B b8 shapes: 2 x 132 blocks (33
    clusters), where the forward's takes up to 4 x 132."""
    for _, res, C, _, _, _, _ in chip_smoke.GEOMS:
        M = 8 * res * res
        assert fb._ln_plan("ln_residual_bwd", M, C, 132)[3] == 264, (M, C)
        assert fb._ln_plan("ln_residual", M, C, 132)[3] >= 264, (M, C)


@pytest.mark.parametrize("sms", SMS)
def test_ln_bwd_partials_are_sized_to_the_grid(sms):
    """One [2C] row of f32 partials per cluster of the grid, and the ranks'
    slices of it cover the 2C columns once."""
    for M, C in _shapes():
        blocks = fb._ln_plan("ln_residual_bwd", M, C, sms)[3]
        assert fb.ln_bwd_partial_floats(M, C, sms) == blocks // fb.LN_CLUSTER * 2 * C
        slice_ = 2 * C // fb.LN_CLUSTER
        assert slice_ * fb.LN_CLUSTER == 2 * C


def _emulated_param_grads(z, g, gamma, dp, col, eps, sms):
    """(dgamma, dbeta) summed in the backward kernel's order: each lane over
    its rows, the block over its row groups in order, each cluster's blocks
    in rank order (rank q writing columns [q, q + 1) * 2C / 8 of its
    cluster's row of partials), then the clusters, split over the threads of
    the summing block in a fixed way."""
    M, C = z.shape
    lanes, chunks, groups, blocks = plan = fb._ln_plan("ln_residual_bwd", M, C, sms)
    gz = g.float() * fb._dp_rows(dp, col, M)
    zf = z.float()
    mean = zf.mean(-1, keepdim=True)
    var = torch.clamp((zf * zf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    zh = (zf - mean) * torch.rsqrt(var + eps)
    contrib = torch.cat([gz * zh, gz], 1)  # [M, 2C]: dgamma | dbeta terms
    lane_sums = torch.zeros(blocks, groups, 2 * C)
    for b, grp, row in _rows_of(M, plan):
        lane_sums[b, grp] += contrib[row]
    block_sums = lane_sums[:, 0].clone()
    for grp in range(1, groups):
        block_sums += lane_sums[:, grp]
    part = torch.zeros(blocks // fb.LN_CLUSTER, 2 * C)
    slice_ = 2 * C // fb.LN_CLUSTER
    for cl in range(blocks // fb.LN_CLUSTER):
        for rank in range(fb.LN_CLUSTER):
            cols = slice(rank * slice_, (rank + 1) * slice_)
            s = torch.zeros(slice_)
            for q in range(fb.LN_CLUSTER):
                s += block_sums[cl * fb.LN_CLUSTER + q, cols]
            part[cl, cols] = s
    # the last block of each rank: `ways` threads share each column (of 4
    # floats where the slice holds whole 16-byte pieces), thread j summing
    # clusters j, j + ways, ... in order; their sums added in order of j
    cols = slice_ // 4 if slice_ % 4 == 0 else slice_
    ways = max(1, lanes * groups // cols)
    out = torch.zeros(2 * C)
    for j in range(ways):
        s = torch.zeros(2 * C)
        for cl in range(j, part.shape[0], ways):
            s += part[cl]
        out = s if j == 0 else out + s
    return out[:C], out[C:]


@pytest.mark.parametrize("M,C", [(1, 128), (7, 1024), (1000, 96), (4096, 128), (256, 512),
                                 (512, 1024), (1000, 768)])
def test_ln_bwd_fixed_order_sum_matches_the_plain_version(M, C):
    """The kernel's order of summing dgamma/dbeta, emulated, against the
    plain version's sum over all rows at the f32 kernel tolerance; with
    droppath scales (one image in two at 0) and a cotangent in bf16."""
    rng = np.random.default_rng(M * 7 + C)
    z = torch.from_numpy(rng.standard_normal((M, C), np.float32) * 3 + 0.5)
    g = torch.from_numpy(rng.standard_normal((M, C), np.float32)).to(torch.bfloat16)
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(C).astype(np.float32))
    images = M if M % 8 else 8
    dp = torch.tensor([[[1.0, 1.0], [0.0, 2.0]][b % 2] for b in range(images)])
    _, want_g, want_b = fb.ln_residual_bwd_reference(z, g, gamma, dp, 1, 1e-5)
    for sms in SMS:
        got_g, got_b = _emulated_param_grads(z, g, gamma, dp, 1, 1e-5, sms)
        tol = chip_smoke.TOL["f32"]["kernel"]
        for got, want in ((got_g, want_g), (got_b, want_b)):
            assert float((got - want).abs().max() / want.abs().max()) <= tol, (M, C, sms)


def test_ln_wrappers_refuse_widths_the_kernels_do_not_take_only_on_the_card():
    """C not a multiple of 8, or above LN_MAX_C, is refused for CUDA tensors
    (checked before any launch); CPU tensors take the plain versions at any
    width."""
    for C in (12, 1032):
        with pytest.raises(ValueError):
            fb._ln_check_width("ln_residual", C)
    z = torch.randn(4, 12)
    dz, dgamma, dbeta = fb.ln_residual_bwd(z, torch.randn(4, 12), torch.ones(12), None, 0, 1e-5)
    assert dz.shape == (4, 12) and dgamma.shape == dbeta.shape == (12,)
    ydt, y32 = fb.ln_residual(z, torch.randn(4, 12), torch.ones(12), torch.zeros(12), None, 0,
                              1e-5, torch.float32, keep_f32=True)
    assert ydt.shape == y32.shape == (4, 12)
