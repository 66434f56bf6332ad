"""The overlap probe kernel's split of the work, emulated on the CPU.

``ops/probe_overlap.py:probe_plan`` holds the numbers that
``csrc/probe_overlap.cu`` is built with (its constants are read from the
source here and compared). The tests walk the kernel's index arithmetic at
M in {128, 512, 1024} with numpy: which block owns which rows of acc, which
element of x each consumer thread's chains hold in each k-tile, how many
exp passes each element gets and where it is stored. No card is needed.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from cs_vit_tpu_torch.ops import probe_overlap as po

SOURCE = Path(po.__file__).resolve().parent / "csrc" / "probe_overlap.cu"
M_CASES = (128, 512, 1024)
REPEATS = 2


def _kernel_constants():
    """The source's ``constexpr int PO_* = <number>;`` constants."""
    src = SOURCE.read_text()
    return {name: int(val) for name, val in re.findall(r"constexpr int (PO_\w+) = (\d+);", src)}


def test_plan_is_the_kernels():
    k, plan = _kernel_constants(), po.probe_plan(512)
    assert (k["PO_N"], k["PO_PRODUCTS"], k["PO_EXP_PASSES"]) == (po.N, po.PRODUCTS, po.EXP_PASSES)
    assert (k["PO_ROWS"], k["PO_CONSUMERS"], k["PO_BK"], k["PO_STAGES"], k["PO_CHAINS"]) == (
        plan.rows, plan.consumers, plan.w_rows, plan.stages, plan.chains)
    assert plan.threads == plan.consumers + 128 and plan.k_tiles == po.PRODUCTS * po.N // plan.w_rows
    assert plan.groups * plan.chains * plan.consumers == plan.rows * po.VEC_PER_ROW


@pytest.mark.parametrize("M", M_CASES)
def test_each_acc_row_is_owned_once_per_repeat(M):
    """Block (i, r) owns rows [64 i, 64 i + 64) of acc in repeat r, through
    all 8 products: no row is shared, none is left out."""
    plan = po.probe_plan(M)
    assert M % plan.rows == 0 and plan.blocks * plan.rows == M
    for r in range(REPEATS):
        owner = np.full(M, -1)
        for i in range(plan.blocks):
            rows = slice(plan.rows * i, plan.rows * (i + 1))
            assert (owner[rows] == -1).all()
            owner[rows] = i
        assert (owner >= 0).all()
        assert np.array_equal(np.bincount(owner), np.full(plan.blocks, plan.rows))


@pytest.mark.parametrize("M", M_CASES)
def test_each_x_element_gets_its_passes_in_order_and_is_stored_once(M):
    plan = po.probe_plan(M)
    n = M * po.VEC_PER_ROW
    passes = np.zeros(n, np.int64)
    stores = np.zeros(n, np.int64)
    last_tile = np.full(n, -1)
    in_order = True
    group_elems = plan.chains * plan.consumers
    tiles_per_group = po.EXP_PASSES // plan.passes
    assert plan.groups * tiles_per_group == plan.k_tiles
    t = np.arange(plan.consumers)
    for b in range(plan.blocks):
        v0 = b * plan.rows * po.VEC_PER_ROW + t
        for it in range(plan.k_tiles):
            g = it // tiles_per_group
            idx = (v0[None, :] + g * group_elems + np.arange(plan.chains)[:, None] * plan.consumers)
            idx = idx.ravel()
            assert len(np.unique(idx)) == idx.size  # independent chains
            in_order &= bool((last_tile[idx] == it - 1).all() or (passes[idx] == 0).all())
            passes[idx] += plan.passes
            last_tile[idx] = it
            if it % tiles_per_group == tiles_per_group - 1:
                assert (passes[idx] == po.EXP_PASSES).all()  # stored after all 32
                stores[idx] += 1
    assert in_order
    assert (passes == po.EXP_PASSES).all() and (stores == 1).all()


@pytest.mark.parametrize("M", M_CASES)
def test_shared_memory_and_registers_fit(M):
    plan = po.probe_plan(M)
    assert plan.smem_bytes <= 232_448
    assert plan.acc_regs <= 128
    assert plan.stages >= 2  # a k-tile in flight while the previous one is read
    # the exp chains: 8 consumer warps an SM, each thread with its chains
    assert plan.consumers // 32 == 8 and plan.chains >= 8


@pytest.mark.parametrize("M,gib", [(128, 0.5), (512, 2.0), (1024, 4.0)])
def test_w_reads_from_l2(M, gib):
    """At 64 repeats every block reads all of w per product: 2 GiB a call at
    the probe's shapes."""
    assert po.probe_plan(M).w_l2_bytes * 64 == gib * 2**30
