"""Host-side plans and arithmetic of the bf16 attention backward and the
bf16 weight-grad GEMM (``cs_vit_tpu_torch/ops/fused_block.py``), on the CPU.

The two kernels run only on the card; what decides their work on the host is
plain Python, held here: gemm_wgrad's split of the token rows
(``_wgrad_splits``) and the attention backward's image groups
(``_attn_bwd_groups``) and scratch (``attn_bwd_scratch_floats``). The
arithmetic the kernels reorder is emulated in PyTorch, in the kernels' order
(the attention backward's query passes and 16-key chunks, its d rel_bias
slots summed over a block's images before the slots are summed; the GEMM's
64-row stages, splits and per-warp column sums), and held against the plain
versions at ``chip_smoke.TOL``. The inputs are numpy draws from a seed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cs_vit_tpu_torch.models.swinv2 import _shift_attn_mask
from cs_vit_tpu_torch.ops import fused_block as fb

SMS = (132, 114, 78)  # H100 SXM, H100 PCIe, a smaller card
BATCHES = (1, 2, 8)


def _wgrad_shapes():
    shapes = list(chip_smoke.WGRAD_EDGE_SHAPES)
    for _, res, C, _, _, _, _ in chip_smoke.GEOMS:
        for B in BATCHES + (64,):
            M = B * res * res
            shapes += [(M, 4 * C, C), (M, C, 4 * C), (M, C, C), (M, C, 3 * C)]
    return shapes


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("sms", SMS)
def test_wgrad_splits_cover_every_row_once(sms, bf16):
    for M, K, N in _wgrad_shapes():
        splits, rows = fb._wgrad_splits(M, K, N, sms, bf16)
        assert rows % (fb.WGRAD_DEPTH if bf16 else 32) == 0, (M, K, N)
        count = np.zeros(M, np.int64)
        for s in range(splits):
            lo, hi = s * rows, min(M, (s + 1) * rows)
            assert hi > lo, (M, K, N, s)  # no empty split
            count[lo:hi] += 1
        assert (count == 1).all(), (M, K, N)


@pytest.mark.parametrize("sms", SMS)
def test_wgrad_does_not_split_where_the_tiles_fill_the_card(sms):
    for M, K, N in _wgrad_shapes():
        tiles = fb._wgrad_tiles(K, N)
        splits, rows = fb._wgrad_splits(M, K, N, sms)
        if 4 * tiles >= sms:
            assert splits == 1 and fb.wgrad_partial_bytes(M, K, N, sms) == 0, (M, K, N)
        else:
            assert splits * tiles <= sms, (M, K, N)  # one wave
            assert splits == 1 or rows >= fb.WGRAD_MIN_ROWS, (M, K, N)
    # stage 3 of the Swin-B b8 step fills the card: one split
    for K, N in ((4096, 1024), (1024, 4096), (1024, 1024), (1024, 3072)):
        assert fb._wgrad_splits(512, K, N, 132)[0] == 1


def test_wgrad_partial_bytes_per_step_fall():
    """The split partials of a b8 step, over GEOMS, stay below the 3.37 GB
    of the WMMA kernel's planner (64 x 128 tiles, 4 blocks an SM)."""
    total = 0
    for _, res, C, _, _, _, n_blocks in chip_smoke.GEOMS:
        M = 8 * res * res
        for K, N in ((4 * C, C), (C, 4 * C), (C, C), (C, 3 * C)):
            total += n_blocks * fb.wgrad_partial_bytes(M, K, N, 132)
    assert 0 < total < 3.37e9


@pytest.mark.parametrize("resident", [1, 64, 132, 264, 1000])
def test_attn_bwd_groups_cover_every_image_once(resident):
    for _, res, C, heads, ws, _, _ in chip_smoke.GEOMS + chip_smoke.SMALL_GEOMS:
        nW = (res // ws) ** 2
        for B in range(1, 41):
            per_group, groups = fb._attn_bwd_groups(resident, heads, nW, B)
            count = np.zeros(B, np.int64)
            for g in range(groups):
                lo, hi = g * per_group, min(B, (g + 1) * per_group)
                assert hi > lo, (resident, heads, nW, B, g)
                count[lo:hi] += 1
            assert (count == 1).all(), (resident, heads, nW, B)
            assert groups * heads * nW <= max(resident, heads * nW)


def test_attn_bwd_scratch_does_not_grow_with_batch():
    for _, res, C, heads, ws, _, _ in chip_smoke.GEOMS:
        nW, L = (res // ws) ** 2, ws * ws
        sizes = []
        for B in (8, 16, 64, 256):
            _, groups = fb._attn_bwd_groups(132, heads, nW, B)
            sizes.append(fb.attn_bwd_scratch_floats(B, nW, heads, L, groups))
        assert len(set(sizes)) == 1, sizes
    # stage 0 at b8 (one resident block per SM at L=256): a quarter of one
    # slot per window of every image, at most 34 MB
    _, groups = fb._attn_bwd_groups(132, 4, 16, 8)
    new = fb.attn_bwd_scratch_floats(8, 16, 4, 256, groups) * 4
    old = fb.attn_bwd_scratch_floats(8, 16, 4, 256, None) * 4
    assert new <= 34e6 and 4 * new == old


# ---------------------------------------------------------------------------
# emulation of the bf16 kernels' arithmetic
# ---------------------------------------------------------------------------


def _rnd(t):
    return t.to(torch.bfloat16).float()


def _emulate_attention_bwd(qkv, dout, rel_bias, scale, mask, ws, heads, shift, resident):
    """The bf16 window_attn_bwd_tc_kernel's arithmetic: per (head, window
    position, image group) block, per image, query passes of 16 NWARP rows;
    D from the f32 product of bf16 p and v; dq^ summed over 16-key chunks in
    order; dk^ and dv summed over the passes' 16-row tiles in order; d
    rel_bias summed over the block's images into its slot, then over the
    slots in order; d logit_scale per block, then over the blocks."""
    B, H, W, C3 = qkv.shape
    C, L = C3 // 3, ws * ws
    nW = (H // ws) * (W // ws)
    nwarp = {256: 8, 64: 4, 16: 1}[L]
    hr = 16 * nwarp
    per_group, groups = fb._attn_bwd_groups(resident, heads, nW, B)
    roll = (lambda t: torch.roll(t, (-shift, -shift), (1, 2))) if shift else (lambda t: t)
    win = fb.window_partition(roll(qkv.float()), ws).reshape(B, nW, L, 3, heads, 32)
    dow = fb.window_partition(roll(dout.float()), ws).reshape(B, nW, L, heads, 32)
    dwin = torch.zeros(B, nW, L, 3, heads, 32)
    slots = torch.zeros(nW * groups, heads * L * L + heads)
    for h in range(heads):
        lam = float(scale[h])
        for w in range(nW):
            bias = rel_bias[h].float() + (mask[w].float() if mask is not None else 0.0)
            for g in range(groups):
                slot = slots[w * groups + g]
                drb = torch.zeros(L, L)
                dlam = torch.zeros(())
                for b in range(g * per_group, min(B, (g + 1) * per_group)):
                    q, k, v = (win[b, w, :, i, h] for i in range(3))
                    do = dow[b, w, :, h]
                    rq = torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24)
                    rk = torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-24)
                    qh, kh = _rnd(q * rq), _rnd(k * rk)
                    p = _rnd(torch.softmax(qh @ kh.t() * lam + bias, -1))
                    d = (do * (p @ v)).sum(-1, keepdim=True)
                    ds = p * (do @ v.t() - d)
                    dsr = _rnd(ds)
                    drb += ds
                    qhb = torch.zeros(L, 32)
                    for c in range(0, L, 16):
                        qhb += dsr[:, c:c + 16] @ kh[c:c + 16]
                    dlam += (qhb * (q * rq)).sum()
                    qnb = lam * qhb
                    dwin[b, w, :, 0, h] = rq * (qnb - q * rq * rq * (qnb * q).sum(-1, keepdim=True))
                    dkh, dv = torch.zeros(L, 32), torch.zeros(L, 32)
                    for p0 in range(0, L, hr):
                        pk, pv = torch.zeros(L, 32), torch.zeros(L, 32)
                        for t0 in range(p0, p0 + hr, 16):
                            pk += dsr[t0:t0 + 16].t() @ qh[t0:t0 + 16]
                            pv += p[t0:t0 + 16].t() @ do[t0:t0 + 16]
                        dkh, dv = dkh + pk, dv + pv
                    knb = lam * dkh
                    dwin[b, w, :, 1, h] = rk * (knb - k * rk * rk * (knb * k).sum(-1, keepdim=True))
                    dwin[b, w, :, 2, h] = dv
                slot[h * L * L:(h + 1) * L * L] = drb.reshape(-1)
                slot[heads * L * L + h] = dlam
    out = torch.zeros(heads * L * L + heads)
    for s in range(slots.shape[0]):  # sum_splits' order
        out += slots[s]
    d = fb.window_reverse(dwin.reshape(B * nW, L, C3), ws, B, H, W)
    d = torch.roll(d, (shift, shift), (1, 2)) if shift else d
    return d, out[:heads * L * L].reshape(heads, L, L), out[heads * L * L:]


# (res, ws, shift, heads, B, resident): L=16 and L=64 in one pass, L=256 in
# two; ragged image groups
ATTN_CASES = [
    (8, 4, 2, 2, 5, 8),
    (16, 8, 4, 2, 3, 8),
    (16, 16, 0, 1, 3, 2),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[f"L{c[1] ** 2}_shift{c[2]}" for c in ATTN_CASES])
def test_attention_bwd_kernel_arithmetic_matches_plain_version(case):
    res, ws, shift, heads, B, resident = case
    rng = np.random.default_rng(res * 10 + ws)
    C, L = heads * 32, ws * ws
    bf = torch.bfloat16
    qkv = torch.from_numpy(rng.normal(size=(B, res, res, 3 * C)).astype(np.float32)).to(bf)
    dout = torch.from_numpy(rng.normal(size=(B, res, res, C)).astype(np.float32)).to(bf)
    rel_bias = torch.from_numpy(16 / (1 + np.exp(-rng.normal(size=(heads, L, L))))).to(bf)
    scale = torch.from_numpy(np.exp(np.log(10.0) + 0.5 * rng.normal(size=heads))).float()
    mask = torch.from_numpy(_shift_attn_mask(res, res, ws, shift)).to(bf) if shift else None
    got = _emulate_attention_bwd(qkv, dout, rel_bias, scale, mask, ws, heads, shift, resident)
    want = fb.window_attention_bwd_reference(qkv, dout, rel_bias, scale, mask, window_size=ws,
                                             num_heads=heads, shift=shift)
    tol = chip_smoke.TOL["bf16"]["kernel"]
    for name, a, b in zip(("dqkv", "d rel_bias", "d logit_scale"), got, want):
        assert _rel(a, b) <= tol, (name, _rel(a, b))


def _emulate_wgrad(a, dy, sms):
    """The bf16 wgrad_wgmma_kernel's arithmetic: per split, f32 sums of
    64-row stages of a^T round(dy); the column sums per consumer warp (rows
    = w mod 8 of every stage) added in warp order; the splits in order."""
    M, N = dy.shape
    splits, rows = fb._wgrad_splits(M, a.shape[1], N, sms)
    depth = fb.WGRAD_DEPTH
    dw, db = torch.zeros(a.shape[1], N), torch.zeros(N)
    af, dr = a.float(), _rnd(dy)
    for s in range(splits):
        lo, hi = s * rows, min(M, (s + 1) * rows)
        pw, warp_sums = torch.zeros_like(dw), torch.zeros(8, N)
        for m0 in range(lo, hi, depth):
            m1 = min(hi, m0 + depth)
            pw += af[m0:m1].t() @ dr[m0:m1]
            for w in range(8):
                warp_sums[w] += dy[m0 + w:m1:8].sum(0)
        dw += pw
        db += warp_sums.sum(0)
    return dw, db


@pytest.mark.parametrize("shape", [(1000, 136, 264), (4104, 520, 136), (2048, 512, 512),
                                   (1000, 128, 264)])
def test_wgrad_kernel_arithmetic_matches_plain_version(shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32))
    dw, db = _emulate_wgrad(a, dy, 132)
    want_dw, want_db = fb.gemm_wgrad_reference(a, dy)
    assert _rel(dw, want_dw) <= chip_smoke.TOL["bf16"]["kernel"]
    # the bias grad is an f32 sum of f32 values: held to the f32 tolerance
    assert _rel(db, want_db) <= chip_smoke.TOL["f32"]["kernel"]
