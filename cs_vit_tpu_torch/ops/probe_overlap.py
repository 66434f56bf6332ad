"""Tensor-core / SFU overlap probe: a CUDA kernel for Hopper and its plain
version.

Port of the TPU probe kernel of ``tools/probe_overlap.py:bench`` (body
``make_kernel``), which runs a chain of matrix products, a chain of
exponentials, or both with no dependence between them, to see whether the
two units overlap. In each mode ("mma", "exp", "both"; the TPU tool's "mxu",
"vpu", "both")::

    acc = a;  8 times: acc = bf16(acc @ w)   (f32 sums; "mma", "both")
    vec = x; 32 times: vec = exp(vec * 0.25 - 1)      ("exp", "both")

and the outputs are (acc, vec): a itself in "exp" mode, x itself in "mma"
mode. The kernel (``csrc/probe_overlap.cu``) does the whole work `repeats`
times, as the TPU grid of 64 did, on the tensor cores (asynchronous
``wgmma`` on TMA-fed tiles) and the SFU, the exps issued between a
``wgmma``'s commit and its wait. :func:`probe_plan` holds its split. No path
of the model runs it: its entry point is ``cs_vit_tpu_torch.tools.probe_overlap``.

:func:`probe_overlap` launches the kernel for CUDA tensors and counts the
launch in its ``launches`` attribute; for CPU tensors it runs
:func:`probe_overlap_reference`. A CUDA call the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import _build
from .fused_block import _check_launch, _is_cpu, _require, _stream

MODES = ("mma", "exp", "both")
N = 512            # a is [M, N], w is [N, N]
PRODUCTS = 8       # products in the chain
EXP_PASSES = 32    # exp passes over vec (4 per product)
VEC_PER_ROW = 2048  # x elements per row of a (the TPU probe's x [2048, 512] to a [512, 512])
SMEM_CAP = 232448  # dynamic shared memory a block of the H100 may opt in to
_P, _I = ctypes.c_void_p, ctypes.c_int
_lib_handle = None


class ProbePlan(NamedTuple):
    """The kernel's split of the work (``csrc/probe_overlap.cu``'s constants)."""

    rows: int        # acc rows a block owns through the 8 products: the kernel
                     # takes M a multiple of it
    blocks: int      # row blocks a repeat (M / rows); no clusters
    consumers: int   # threads of the two consumer warpgroups (256 columns each)
    threads: int     # the consumers and one producer warpgroup (one thread issues)
    acc_regs: int    # f32 accumulator registers a consumer thread holds
    w_rows: int      # k-rows of w a ring stage holds (all 512 columns)
    stages: int      # ring stages: as many as fit beside acc's tile
    smem_bytes: int  # dynamic shared memory a block
    k_tiles: int     # ring stages a block walks (k-tiles of the 8 products)
    chains: int      # independent exp chains (vec elements) a consumer thread keeps
    groups: int      # groups of chains a block walks (each stored once)
    passes: int      # exp passes each chain gets per k-tile
    w_l2_bytes: int  # w bytes a repeat reads from L2: all of w per block and product


def probe_plan(M: int) -> ProbePlan:
    """The kernel's plan at M rows of a."""
    rows, consumers, w_rows, chains = 64, 256, 32, 16
    atom_row = 128                      # bytes: 64 bf16, one row of a swizzle atom
    acc_bytes = N // 64 * rows * atom_row
    stage_bytes = N // 64 * w_rows * atom_row
    fixed = 16 * 8 + 1024 + acc_bytes   # 16 mbarriers, the atoms' 1024-byte alignment
    stages = (SMEM_CAP - fixed) // stage_bytes
    k_tiles = PRODUCTS * N // w_rows
    groups = rows * VEC_PER_ROW // (chains * consumers)  # the block's vec slice
    return ProbePlan(
        rows=rows, blocks=M // rows, consumers=consumers, threads=consumers + 128,
        acc_regs=rows * N // 2 // 128, w_rows=w_rows, stages=stages,
        smem_bytes=fixed + stages * stage_bytes, k_tiles=k_tiles, chains=chains,
        groups=groups, passes=EXP_PASSES * groups // k_tiles,
        w_l2_bytes=M // rows * PRODUCTS * N * N * 2,
    )


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("probe_overlap")
        lib.probe_overlap.argtypes = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
        lib.probe_overlap.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def reset_launch_counts() -> None:
    probe_overlap.launches = 0


def launch_counts() -> dict:
    return {"probe_overlap": probe_overlap.launches}


def probe_overlap_reference(
    a: torch.Tensor, w: torch.Tensor, x: torch.Tensor, mode: str, repeats: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the chain in torch, `repeats` times (each repeat starts
    again from a and x, so the outputs do not depend on `repeats`)."""
    _require(mode in MODES, f"mode must be one of {MODES}, got {mode!r}")
    acc, vec = a, x
    for _ in range(repeats):
        acc, vec = a, x
        if mode in ("mma", "both"):
            for _ in range(PRODUCTS):
                acc = (acc.float() @ w.float()).to(a.dtype)
        if mode in ("exp", "both"):
            for _ in range(EXP_PASSES):
                vec = torch.exp(vec * 0.25 - 1.0)
    return acc, vec


def probe_overlap(
    a: torch.Tensor, w: torch.Tensor, x: torch.Tensor, mode: str, repeats: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [M, 512] and w [512, 512] bf16, x f32 (any shape); returns (acc,
    vec). The kernel takes M a multiple of 64 (:func:`probe_plan`'s rows a
    block) and x of M * 2048 elements (the TPU probe's a [512, 512] and
    x [2048, 512])."""
    _require(mode in MODES, f"mode must be one of {MODES}, got {mode!r}")
    if _is_cpu(a, w, x):
        return probe_overlap_reference(a, w, x, mode, repeats)
    M = a.shape[0]
    _require(a.dtype == torch.bfloat16 and w.dtype == torch.bfloat16 and x.dtype == torch.float32,
             "probe_overlap takes bf16 a and w and f32 x")
    _require(a.dim() == 2 and a.shape[1] == N and w.shape == (N, N),
             f"probe_overlap needs a [M, {N}] and w [{N}, {N}]")
    rows = probe_plan(M).rows
    _require(M > 0 and M % rows == 0, f"probe_overlap needs M a multiple of {rows}")
    _require(x.numel() == M * VEC_PER_ROW, f"probe_overlap needs x of M * {VEC_PER_ROW} elements")
    _require(0 < repeats <= 65535, "repeats must be 1 to 65535")
    _require(all(t.is_contiguous() for t in (a, w, x)), "probe_overlap needs contiguous operands")
    acc, vec = torch.empty_like(a), torch.empty_like(x)
    rc = _lib().probe_overlap(
        a.data_ptr(), w.data_ptr(), x.data_ptr(), acc.data_ptr(), vec.data_ptr(), M,
        int(mode != "exp"), int(mode != "mma"), repeats, _stream(a),
    )
    _check_launch("probe_overlap", rc)
    probe_overlap.launches += 1
    return acc, vec


reset_launch_counts()
