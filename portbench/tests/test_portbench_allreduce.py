"""The reader of ``allreduce_ms.dp`` on a hand-built Chrome trace of two
steps (0-1000 us, 1000-2000 us): each step's backward kernel, then its
NCCL all-reduce (launched at the step's end, waiting for the peers until
their shares arrive); one more all-reduce after the traced steps, which no
step holds."""

import pytest

from portbench.cell import reader
from portbench.tracing import Trace

# (name, launch, kernel start, kernel end)
KERNELS = [("wgrad_kernel", 100, 105, 600), ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 610, 612, 900),
           ("wgrad_kernel", 1100, 1105, 1500),
           ("ncclKernel_AllReduce_RING_LL_Sum_float", 1510, 1515, 1915),
           ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 2100, 2105, 2300)]


def _x(name, cat, ts, end, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts, "tid": tid,
            "args": args}


def _trace(nccl=True):
    ev = [_x("pb.unit", "user_annotation", 0, 1000), _x("pb.unit", "user_annotation", 1000, 2000)]
    for i, (name, launch, k0, k1) in enumerate(KERNELS):
        if nccl or "nccl" not in name:
            ev += [_x("cudaLaunchKernel", "cuda_runtime", launch, launch + 3, correlation=i),
                   _x(name, "kernel", k0, k1, tid=7, correlation=i)]
    return Trace({"traceEvents": ev}, {"unit_s": 1e-3})


def test_allreduce_ms_reads_the_steps_nccl_kernels():
    # (288 + 400) us over two steps; the third all-reduce lies after them
    assert reader("layers", "allreduce_ms.dp")(_trace()) == pytest.approx(0.344, abs=1e-12)


def test_allreduce_ms_reads_none_without_nccl_kernels():
    assert reader("layers", "allreduce_ms.dp")(_trace(nccl=False)) is None
