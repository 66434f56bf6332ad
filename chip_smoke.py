#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cs_vit_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``:

    python3 chip_smoke.py

It builds the CUDA kernels from ``cs_vit_tpu_torch/ops/csrc/`` and then, in
order, failing (non-zero exit, no result line) at the first phase that fails:

1. prints the card (``nvidia-smi`` name and power limit), turns TF32 off;
2. builds the kernels (all four sources at once) and prints the build time
   and the compiler's register/spill report; fails if a tensor-core kernel
   (the window-attention ``*_tc_kernel``s, forward and backward, and the
   three ``wgmma`` GEMMs at each tile width) spills or is missing from the
   report;
3. holds each forward and backward kernel of the whole-block path, the whole
   ``fused_swin_block``, the whole block backward (``FusedSwinBlock``) and
   the attention-only window kernel (``fused_window_attention``) against its
   plain PyTorch version at every Swin-B-256 block geometry (stages 0/1 with
   and without shift, stage 2, stage 3 at L=64), at batch 1, 2 and 8, bf16
   and f32 (the attention-only kernel also at the 3, 24 and 40 images of the
   temporal paths); the two window-attention forward kernels also at a ws 4
   (L=16) geometry and with one query row's whole bias at -100, and so is
   the attention backward; ``gemm_wgrad`` also at WGRAD_EDGE_SHAPES,
   ``gemm_bias_act`` and ``gemm_dgrad`` at GEMM_EDGE_SHAPES with every
   epilogue and output dtype; the bf16 ``gemm_wgrad``, attention backward,
   ``gemm_bias_act`` and ``gemm_dgrad`` launched twice must give
   bit-identical outputs; a CUDA ``fused_window_attention`` under autograd
   must raise;
4. serves the flagship model (Swin-B-256 Poser, img 256, bf16, synthetic
   MANO, seeded random weights) through ``PoserSession`` at batch 1 and 8,
   checks the outputs, the kernel launch counts per forward, and the kernel
   path against the eager path on the card;
5. serves the same model with realtime temporal encoders over T=3 frames on
   the attention-only kernel (``attention_impl="pallas"``; ``"hybrid"``
   too) at batch 1 and 8, with the same checks after calibrating the
   BatchNorm statistics;
6. trains the flagship model in the spatial phase at batch 8
   (``train.make_train_step``): f32 backbone grads of the kernel path
   against the eager path under a backbone-only loss, and the bf16 step's
   loss and grad norm against the eager path's, held to a measured floor;
   TRAIN_STEPS bf16 steps on one batch whose loss must fall, with the
   launch counts of one step and the step time; a NaN batch that must leave
   the state bit-identical; a profiled step (device idle share);
7. trains it in the temporal phase at batch 8, realtime T=3 and full T=5 on
   the attention-only kernel: the f32 backbone tokens and the f32 step
   against the eager path,
   TEMPORAL_STEPS bf16 steps whose loss must fall, every frozen parameter
   and statistic bit-identical afterwards, no saved backbone activations,
   the NaN skip;
8. runs the tensor-core/SFU overlap probe's kernel against its plain version
   in its three modes, then its entry point (``tools.probe_overlap``);
9. times every kernel at its path's shapes (batch 8) beside its plain
   version, one library call and its bound (CUDA events around calls as the
   host issues them, ``cuda_ms``), the two window-attention forward
   kernels, the attention backward, the three GEMMs and their library calls
   also queued behind a sleep kernel (``queued_ms``: the card's time,
   flagged where the host still fell behind), the attention backward's
   scratch bytes per call and ``gemm_wgrad``'s split-partial bytes per step,
   and the serve latencies;
10. prints each kernel's kernel / library factor, then ``{"kernels": [...]}``,
    then ``{"ok": true, "device": {...}}`` as the last line.

Each phase prints its wall seconds. It imports nothing of JAX or of
``cs_vit_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

DEV = "cuda"
BACKBONE, IMG = "swinv2-base-256", 256

# batches of the kernel checks: the serving path's 1 and 8, and 2
CHECK_BATCHES = (1, 2, 8)
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# Swin-B-256 block geometries: (stage, res, C, heads, ws, shift, blocks)
GEOMS = (
    (0, 64, 128, 4, 16, 0, 1), (0, 64, 128, 4, 16, 8, 1),
    (1, 32, 256, 8, 16, 0, 1), (1, 32, 256, 8, 16, 8, 1),
    (2, 16, 512, 16, 16, 0, 18),
    (3, 8, 1024, 32, 8, 0, 2),
)
# small-window geometries (ws 4, L=16) that only the two window-attention
# forward kernels' checks use ("stage" 9 seeds them apart from GEOMS)
SMALL_GEOMS = ((9, 8, 128, 4, 4, 0, 0), (9, 8, 128, 4, 4, 2, 0))
# the bias of a shifted block's query row 0 all at -100 (a row the shift mask
# masks whole), checked at these geometries: (stage, shift) of GEOMS /
# SMALL_GEOMS
MASKED_ROW_GEOMS = ((0, 8), (9, 2))
# gemm_wgrad shapes beside the blocks' (M, K, N): M not a multiple of the
# kernel's 64-row stage, K and N 8 more than a multiple of its 128-wide tile
WGRAD_EDGE_SHAPES = ((1000, 136, 264), (4104, 520, 136), (33000, 136, 1032))
# gemm_bias_act (A [M,K] . W [K,N]) and gemm_dgrad (dY [M,N] . W[K,N]^T)
# shapes beside the blocks' (M, K, N): M not a multiple of the kernels' 64-row
# tile, K and N 8 more than a multiple of 64 or 128 (so that both tile widths
# of fused_block._gemm_plan run in each kernel), at every epilogue and
# output dtype
GEMM_EDGE_SHAPES = ((1000, 136, 264), (4104, 1032, 72), (33000, 136, 1032))
KERNEL_SOURCE = "cs_vit_tpu_torch/ops/csrc/fused_block.cu"
REPLACES = "cs_vit_tpu/ops/fused_block.py:738"
# kernel vs plain: max |kernel - plain| / max |plain|. f32: only the order of
# f32 sums differs (K <= 4096 terms). bf16: both round at the same points, so
# a differing f32 sum flips an output by at most a few bf16 ulps (2^-8); the
# whole block chains seven such roundings.
TOL = {"f32": {"kernel": 2e-4, "block": 5e-4}, "bf16": {"kernel": 1.6e-2, "block": 4e-2}}
BWD_KERNEL_SOURCE = "cs_vit_tpu_torch/ops/csrc/fused_block_bwd.cu"
BWD_REPLACES = "cs_vit_tpu/ops/fused_block.py:973"
# spatial train step (Swin-B-256 Poser, b8): AdamW at the config's default lr,
# constant; TRAIN_STEPS steps on one fixed batch, the last three of which must
# average below TRAIN_FALL times the first three.
TRAIN_LR, TRAIN_STEPS, TRAIN_FALL = 1e-4, 30, 0.9
# f32 backbone grads under a backbone-only loss, kernel path vs eager path:
# max |diff| / max |eager grad| per parameter (sum order only, through the 24
# blocks' backward).
TRAIN_GRAD_TOL = 1e-3
# Whole step (loss and pre-clip grad_norm), kernel path vs eager path from
# the same weights, batch and droppath draws. f32: relative to the eager
# value (sum order only, amplified by the random-weight heads). bf16: each
# path rounds at other points and the random-weight heads amplify the
# backbone's bf16 noise (tokens ~5% of their largest magnitude off the f32
# ones, on either path), so the kernel path's distance from the f32 eager
# step is held to twice the eager bf16 path's distance plus TRAIN_BF16_SLACK
# of the value.
TRAIN_F32_TOL, TRAIN_BF16_SLACK = 1e-3, 0.05
# served model, kernel path vs eager path on the card, same weights and inputs.
# Backbone tokens (relative to their largest magnitude): f32 differs by sum
# order only; bf16 rounds activations to 8 bits at 7 points in each of the 24
# blocks where the eager path (promoted to f32 after its first block, as in
# the JAX package) does not. joint_cam (mm): with random weights the heads
# amplify any perturbation of the tokens, so each dtype is held to its own
# noise floor, measured in the run. f32: the largest joint_cam shift of the
# eager f32 model when its tokens are perturbed by the kernel path's own token
# difference with its entries permuted (same sizes, other places; WITNESSES
# draws). bf16: the distance of the bf16 eager path from the f32 eager path.
# The bound is twice the floor plus SERVE_MM_SLACK.
SERVE_TOKEN_TOL = {"f32": 1e-4, "bf16": 5e-2}
SERVE_MM_SLACK = {"f32": 0.01, "bf16": 1.0}
WITNESSES = 8
WA_SOURCE = "cs_vit_tpu_torch/ops/csrc/window_attention.cu"
WA_REPLACES = "cs_vit_tpu/ops/window_attention.py:31"
PROBE_SOURCE = "cs_vit_tpu_torch/ops/csrc/probe_overlap.cu"
PROBE_REPLACES = "tools/probe_overlap.py:51"
# the temporal cases of __graft_entry__.py: realtime over T=3 frames (served
# and trained), full over T=5 (trained)
RT_T, FULL_T = 3, 5
# the image counts the attention-only kernel sees on those paths beyond
# CHECK_BATCHES: realtime b1 and b8 over RT_T frames, full b8 over FULL_T
WA_PATH_BATCHES = (RT_T, 8 * RT_T, 8 * FULL_T)
# temporal train steps (b8, bf16 on f32 masters, only the temporal encoders
# train): AdamW at TEMPORAL_LR, constant; TEMPORAL_STEPS steps on one fixed
# batch, the last three of which must average below TRAIN_FALL times the
# first three
TEMPORAL_LR, TEMPORAL_STEPS = 1e-4, 20
# Before the realtime serving comparison and the temporal steps the
# BatchNorm running statistics are brought to the batch's own statistics by
# CALIBRATION_FORWARDS forwards without autograd in each phase that moves
# them (spatial: the perspective and spatial encoders; temporal: the
# temporal encoders, for serving), as a trained checkpoint would have them:
# at their initial values (mean 0, var 1) the decoders' activations grow
# layer by layer and their nearly hard (sqrt(d_h)-multiplied) attention
# turns the backbone paths' 1e-6 f32 differences into 8% differences of
# their output (CPU rehearsal at Swin-B width); calibrated, 4e-5. The
# temporal f32 step, kernel path vs eager path, is then held to
# TRAIN_F32_TOL (loss and grad_norm, relative to the eager value).
CALIBRATION_FORWARDS = 30
# the temporal step holds no backbone activations for backward: what autograd
# saves in one step stays under this many bytes (the temporal encoders' and
# heads' own, a few MB; the spatial step's backbone saves about 2 GB)
TEMPORAL_SAVED_MAX = 64 * 2**20
# probe kernel vs plain: bf16 acc to 2e-2 of its scale (eight products, each
# rounded to bf16; a sum in another order flips a rounding by one ulp and
# later products carry it), f32 vec to 1e-5 relative per element (__expf on
# the SFU against exp; 32 passes of exp(v/4 - 1) contract errors)
PROBE_TOL = {"acc": 2e-2, "vec": 1e-5}
# queued_ms's sleep kernel ahead of the timed calls (about 20 ms at 1.98 GHz):
# long enough for the host to enqueue them all
SLEEP_CYCLES = 40_000_000
# SFU exp2 throughput of a Hopper SM (16 per clock, the CUDA programming
# guide's table of arithmetic instruction throughput, compute capability 9.0)
SFU_PER_CLOCK_PER_SM = 16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


class Launches:
    """The launch counters of several kernel modules as one: each module has
    ``reset_launch_counts()`` and ``launch_counts()``."""

    def __init__(self, *modules):
        self.modules = modules

    def reset_launch_counts(self) -> None:
        for m in self.modules:
            m.reset_launch_counts()

    def launch_counts(self) -> dict:
        out = {}
        for m in self.modules:
            out.update(m.launch_counts())
        return out


def sync(torch) -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def rel_err(got, want) -> tuple:
    g, w = got.float(), want.float()
    if not (bool(g.isfinite().all()) and bool(w.isfinite().all())):
        return math.inf, math.inf
    err = (g - w).abs().max().item()
    return err, err / max(w.abs().max().item(), 1e-30)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def block_inputs(torch, B, res, C, heads, ws, shift, dtype, seed):
    """Seeded block operands at one geometry, with a CPB-like bias."""
    from cs_vit_tpu_torch.models.swinv2 import _shift_attn_mask

    g = torch.Generator().manual_seed(seed)

    def n(*shape, std=1.0):
        return torch.randn(*shape, generator=g) * std

    L, Ch = ws * ws, 4 * C
    t = dict(
        x=n(B, res, res, C),
        wqkv=n(C, 3 * C, std=C ** -0.5), bqkv=n(3 * C, std=0.02),
        wproj=n(C, C, std=C ** -0.5), bproj=n(C, std=0.02),
        ln1_scale=1 + n(C, std=0.1), ln1_bias=n(C, std=0.1),
        w1=n(C, Ch, std=C ** -0.5), b1=n(Ch, std=0.02),
        w2=n(Ch, C, std=Ch ** -0.5), b2=n(C, std=0.02),
        ln2_scale=1 + n(C, std=0.1), ln2_bias=n(C, std=0.1),
        rel_bias=16 * torch.sigmoid(n(heads, L, L)),
    )
    t["bqkv"][C:2 * C] = 0  # SwinV2 key has no bias
    t = {k: v.to(DEV, dtype) for k, v in t.items()}
    t["logit_scale"] = torch.exp(torch.clamp(math.log(10.0) + n(heads, std=0.5),
                                             max=math.log(100.0))).to(DEV)
    t["mask"] = (torch.from_numpy(_shift_attn_mask(res, res, ws, shift)).to(DEV, dtype)
                 if shift else None)
    t["dp"] = torch.tensor([[[1.0, 1.0], [0.0, 2.0]][b % 2] for b in range(B)], device=DEV)
    return t


def kernel_checks(torch, fb, dname, geom, B=2):
    """Every kernel and the whole block against its plain version at one
    block geometry and batch B: [(kernel, what, max_abs, rel, tol)]."""
    stage, res, C, heads, ws, shift, _ = geom
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
    tol = TOL[dname]
    t = block_inputs(torch, B, res, C, heads, ws, shift, dtype, seed=stage * 10 + shift + 100 * B)
    M = B * res * res
    x2 = t["x"].reshape(M, C)
    pairs = []
    qkv = fb.gemm_bias_act_reference(x2, t["wqkv"], t["bqkv"])
    pairs.append(("gemm_bias_act", "qkv", fb.gemm_bias_act(x2, t["wqkv"], t["bqkv"]), qkv))
    h = fb.gemm_bias_act_reference(x2, t["w1"], t["b1"], act="gelu")
    pairs.append(("gemm_bias_act", "mlp1+gelu",
                  fb.gemm_bias_act(x2, t["w1"], t["b1"], act="gelu"), h))
    m2 = fb.gemm_bias_act_reference(h, t["w2"], t["b2"], out_dtype=torch.float32)
    pairs.append(("gemm_bias_act", "mlp2 f32-out",
                  fb.gemm_bias_act(h, t["w2"], t["b2"], out_dtype=torch.float32), m2))
    pairs.append(swin_attention_pair(fb, t, qkv.reshape(B, res, res, 3 * C), geom))
    ln1 = (m2, x2, t["ln1_scale"], t["ln1_bias"], t["dp"], 0, 1e-5, dtype)
    y32, ydt = fb.ln_residual_reference(*ln1)
    kdt, k32 = fb.ln_residual(*ln1, keep_f32=True)
    pairs += [("ln_residual", "ln1 dt", kdt, ydt), ("ln_residual", "ln1 f32", k32, y32)]
    ln2 = (m2, y32, t["ln2_scale"], t["ln2_bias"], t["dp"], 1, 1e-5, dtype)
    pairs.append(("ln_residual", "ln2 f32-res", fb.ln_residual(*ln2)[0],
                  fb.ln_residual_reference(*ln2)[1]))
    # whole block: seven launches vs block_reference on rolled windows
    args = [t[k] for k in ("wqkv", "bqkv", "wproj", "bproj", "ln1_scale", "ln1_bias",
                           "w1", "b1", "w2", "b2", "ln2_scale", "ln2_bias",
                           "rel_bias", "logit_scale")]
    y = fb.fused_swin_block(t["x"], *args, mask=t["mask"], droppath_keep=t["dp"],
                            window_size=ws, num_heads=heads, eps=1e-5, shift=shift)
    xr = torch.roll(t["x"], (-shift, -shift), (1, 2))
    yr = torch.roll(fb.block_reference(xr, *args, t["dp"], t["mask"], window_size=ws,
                                       num_heads=heads, eps=1e-5), (shift, shift), (1, 2))
    pairs.append(("fused_swin_block", "whole block", y, yr))
    sync(torch)
    return [
        (name, what, *rel_err(got, want), tol["block" if name == "fused_swin_block" else "kernel"])
        for name, what, got, want in pairs
    ]


def swin_attention_pair(fb, t, qkv4, geom, mask=None, what="attn"):
    """(kernel, what, got, want) of ``swin_window_attn_fwd`` on qkv4 with
    block_inputs' bias and (unless `mask` is given) its shift mask."""
    _, _, _, heads, ws, shift, _ = geom
    kw = dict(window_size=ws, num_heads=heads, shift=shift)
    mask = t["mask"] if mask is None else mask
    ops = (qkv4, t["rel_bias"], t["logit_scale"], mask)
    return ("swin_window_attn_fwd", what, fb.window_attention(*ops, **kw),
            fb.window_attention_reference(*ops, **kw))


def attention_checks(torch, fb, wa, dname, geom, B=2, masked_row=False):
    """The two window-attention forward kernels against their plain versions
    at one geometry and batch B (the small-window geometries, which only they
    see): [(kernel, what, max_abs, rel, tol)]. `masked_row`: instead, a
    shifted block whose query row 0 has its whole bias at -100 (the shift
    mask's value) in every window."""
    stage, res, C, heads, ws, shift, _ = geom
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
    seed = stage * 10 + shift + 100 * B + 17
    t = block_inputs(torch, B, res, C, heads, ws, shift, dtype, seed=seed)
    qkv4 = fb.gemm_bias_act_reference(t["x"].reshape(-1, C), t["wqkv"], t["bqkv"])
    qkv4 = qkv4.reshape(B, res, res, 3 * C)
    if not masked_row:
        pairs = [swin_attention_pair(fb, t, qkv4, geom)]
        results = window_attention_checks(torch, wa, dname, geom, B)
    else:
        mask = t["mask"].clone()
        mask[:, 0, :] = -100.0
        pairs = [swin_attention_pair(fb, t, qkv4, geom, mask, "row 0 all -100")]
        q, k, v, bias, scale = window_attention_inputs(torch, B, res, C, heads, ws, shift,
                                                       dtype, seed=seed + 1)
        bias = bias.float().clone()
        bias[:, :, 0, :] = -100.0
        pairs.append(("fused_window_attention", "row 0 all -100",
                      wa.fused_window_attention(q, k, v, bias, scale),
                      wa.fused_window_attention_reference(q, k, v, bias, scale)))
        results = []
    sync(torch)
    return [(name, what, *rel_err(got, want), TOL[dname]["kernel"])
            for name, what, got, want in pairs] + results


def bwd_kernel_checks(torch, fb, dname, geom, B=2):
    """Every backward kernel, and the whole block backward through
    ``FusedSwinBlock``, against its plain version at one block geometry and
    batch B: [(kernel, what, max_abs, rel, tol)]."""
    stage, res, C, heads, ws, shift, _ = geom
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
    f32 = torch.float32
    tol = TOL[dname]
    seed = stage * 10 + shift + 100 * B + 7
    t = block_inputs(torch, B, res, C, heads, ws, shift, dtype, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)

    def n(*shape, dt=f32):
        return torch.randn(*shape, generator=gen).to(DEV, dt)

    M, Ch = B * res * res, 4 * C
    x2 = t["x"].reshape(M, C)
    pairs = []
    # LayerNorm-residual backward, with the cotangent in the compute dtype
    # (LN2: the block's output grad) and in f32 (LN1: h1's grad)
    z = n(M, C) * 3 + 0.5
    for what, g, col in (("ln2", n(M, C, dt=dtype), 1), ("ln1", n(M, C), 0)):
        got = fb.ln_residual_bwd(z, g, t["ln2_scale"], t["dp"], col, 1e-5)
        want = fb.ln_residual_bwd_reference(z, g, t["ln2_scale"], t["dp"], col, 1e-5)
        pairs += [("ln_residual_bwd", f"{what} {p}", a, b)
                  for p, a, b in zip(("dz", "dgamma", "dbeta"), got, want)]
    # the block's four input grads, each with its epilogue and output dtype
    m1 = n(M, Ch, dt=dtype)
    for what, dy, w, aux, epi, odt in (
        ("mlp2 gelu'", n(M, C), t["w2"], m1, "gelu", f32),
        ("mlp1 +g", n(M, Ch), t["w1"], n(M, C, dt=dtype), "add", f32),
        ("proj", n(M, C), t["wproj"], None, "none", dtype),
        ("qkv +h1b", n(M, 3 * C), t["wqkv"], n(M, C), "add", dtype),
    ):
        pairs.append(("gemm_dgrad", what, fb.gemm_dgrad(dy, w, aux, epi, odt),
                      fb.gemm_dgrad_reference(dy, w, aux, epi, odt)))
    # weight and bias grads over all M token rows
    for what, a, dy in (("qkv", x2, n(M, 3 * C)), ("mlp1", x2, n(M, Ch)),
                        ("mlp2", m1, n(M, C))):
        got, want = fb.gemm_wgrad(a, dy), fb.gemm_wgrad_reference(a, dy)
        pairs += [("gemm_wgrad", f"{what} {p}", a_, b_)
                  for p, a_, b_ in zip(("dW", "db"), got, want)]
    # attention backward
    kw = dict(window_size=ws, num_heads=heads, shift=shift)
    qkv4 = fb.gemm_bias_act_reference(x2, t["wqkv"], t["bqkv"]).reshape(B, res, res, 3 * C)
    dout = n(B, res, res, C, dt=dtype)
    ops = (qkv4, dout, t["rel_bias"], t["logit_scale"], t["mask"])
    got = fb.window_attention_bwd(*ops, **kw)
    want = fb.window_attention_bwd_reference(*ops, **kw)
    pairs += [("swin_window_attn_bwd", p, a, b)
              for p, a, b in zip(("dqkv", "d rel_bias", "d logit_scale"), got, want)]
    # whole block: autograd through FusedSwinBlock vs block_backward_reference
    # on rolled windows
    args = [t[k] for k in fb.OPERANDS]
    leaves = [v.clone().requires_grad_() for v in [t["x"]] + args]
    y = fb.fused_swin_block(leaves[0], *leaves[1:], mask=t["mask"], droppath_keep=t["dp"],
                            **dict(kw, eps=1e-5))
    gy = n(B, res, res, C, dt=dtype)
    grads = torch.autograd.grad(y, leaves, gy)

    def roll(v, s):
        return torch.roll(v, (s, s), (1, 2)) if shift else v

    ref = fb.block_backward_reference(roll(gy, -shift), roll(t["x"], -shift), *args, t["dp"],
                                      t["mask"], window_size=ws, num_heads=heads, eps=1e-5)
    want = (roll(ref[0], shift),) + tuple(ref[1:1 + len(args)])
    pairs += [("FusedSwinBlock", f"d{name}", a, b)
              for name, a, b in zip(("x",) + fb.OPERANDS, grads, want)]
    sync(torch)
    return [
        (name, what, *rel_err(got, want), tol["block" if name == "FusedSwinBlock" else "kernel"])
        for name, what, got, want in pairs
    ]


def attention_bwd_pair(torch, fb, dname, geom, B, masked_row=False):
    """(kernel, what, got, want) of ``swin_window_attn_bwd`` at one geometry
    and batch B, each of its three outputs; `masked_row`: the shift mask's
    query row 0 all at -100 in every window."""
    stage, res, C, heads, ws, shift, _ = geom
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
    seed = stage * 10 + shift + 100 * B + 23
    t = block_inputs(torch, B, res, C, heads, ws, shift, dtype, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    qkv4 = fb.gemm_bias_act_reference(t["x"].reshape(-1, C), t["wqkv"], t["bqkv"])
    qkv4 = qkv4.reshape(B, res, res, 3 * C)
    dout = torch.randn(B, res, res, C, generator=gen).to(DEV, dtype)
    mask, what = t["mask"], f"L{ws * ws}"
    if masked_row:
        mask = mask.clone()
        mask[:, 0, :] = -100.0
        what += " row 0 all -100"
    ops = (qkv4, dout, t["rel_bias"], t["logit_scale"], mask)
    kw = dict(window_size=ws, num_heads=heads, shift=shift)
    got = fb.window_attention_bwd(*ops, **kw)
    want = fb.window_attention_bwd_reference(*ops, **kw)
    return [("swin_window_attn_bwd", f"{what} {p}", a, b)
            for p, a, b in zip(("dqkv", "d rel_bias", "d logit_scale"), got, want)]


def bwd_edge_checks(torch, fb, dname):
    """The two redesigned backward kernels beyond the block geometries: the
    attention backward at the ws 4 (L=16) geometries at every batch and with
    a query row's whole bias at -100, gemm_wgrad at WGRAD_EDGE_SHAPES:
    [(kernel, what, max_abs, rel, tol)]."""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
    pairs = []
    for geom in SMALL_GEOMS:
        for B in CHECK_BATCHES:
            pairs += attention_bwd_pair(torch, fb, dname, geom, B)
    for geom in GEOMS + SMALL_GEOMS:
        if (geom[0], geom[5]) in MASKED_ROW_GEOMS:
            pairs += attention_bwd_pair(torch, fb, dname, geom, 2, masked_row=True)
    gen = torch.Generator().manual_seed(31)
    for M, K, N in WGRAD_EDGE_SHAPES:
        a = torch.randn(M, K, generator=gen).to(DEV, dtype)
        dy = torch.randn(M, N, generator=gen).to(DEV)
        pairs += [("gemm_wgrad", f"M{M} K{K} N{N} {p}", x, y)
                  for p, x, y in zip(("dW", "db"), fb.gemm_wgrad(a, dy),
                                     fb.gemm_wgrad_reference(a, dy))]
    sync(torch)
    return [(name, what, *rel_err(got, want), TOL[dname]["kernel"])
            for name, what, got, want in pairs]


def gemm_edge_checks(torch, fb, dname):
    """The two GEMMs beyond the block geometries: gemm_bias_act and
    gemm_dgrad at GEMM_EDGE_SHAPES with every activation or epilogue, aux
    dtype and output dtype the dtype admits: [(kernel, what, max_abs, rel,
    tol)]."""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
    f32 = torch.float32
    out_dtypes = (dtype, f32) if dtype != f32 else (f32,)
    aux_dtypes = (dtype, f32) if dtype != f32 else (f32,)
    gen = torch.Generator().manual_seed(37)

    def n(*shape, dt=f32):
        return torch.randn(*shape, generator=gen).to(DEV, dt)

    pairs = []
    for M, K, N in GEMM_EDGE_SHAPES:
        a, w, b = n(M, K, dt=dtype), n(K, N, dt=dtype) * K ** -0.5, n(N, dt=dtype)
        for act in ("none", "gelu"):
            for odt in out_dtypes:
                pairs.append(("gemm_bias_act", f"M{M} K{K} N{N} {act} out {odt}",
                              fb.gemm_bias_act(a, w, b, act, odt),
                              fb.gemm_bias_act_reference(a, w, b, act, odt)))
        dy = n(M, N)
        cases = [("gelu", n(M, K, dt=dtype))] + [("add", n(M, K, dt=adt)) for adt in aux_dtypes]
        for epi, aux in cases + [("none", None)]:
            for odt in out_dtypes:
                what = f"M{M} K{K} N{N} {epi}" + ("" if aux is None else f" aux {aux.dtype}")
                pairs.append(("gemm_dgrad", f"{what} out {odt}",
                              fb.gemm_dgrad(dy, w, aux, epi, odt),
                              fb.gemm_dgrad_reference(dy, w, aux, epi, odt)))
    sync(torch)
    return [(name, what, *rel_err(got, want), TOL[dname]["kernel"])
            for name, what, got, want in pairs]


def check_bit_identical(torch, fb, B=8):
    """The bf16 gemm_wgrad, swin_window_attn_bwd, gemm_bias_act and
    gemm_dgrad launched twice on the same inputs at every block geometry
    (each GEMM at the block's four shapes) give bit-identical outputs: every
    cross-block sum runs in a fixed order, and the two GEMMs sum each output
    in one block. Returns the number of comparisons."""
    bf = torch.bfloat16
    n = 0
    for stage, res, C, heads, ws, shift, _ in GEOMS:
        t = block_inputs(torch, B, res, C, heads, ws, shift, bf, seed=400 + stage)
        gen = torch.Generator().manual_seed(400 + stage)
        M = B * res * res
        calls = []
        for K, N in ((4 * C, C), (C, 4 * C), (C, C), (C, 3 * C)):
            a = torch.randn(M, K, generator=gen).to(DEV, bf)
            dy = torch.randn(M, N, generator=gen).to(DEV)
            calls.append((f"gemm_wgrad K{K} N{N}", lambda a=a, dy=dy: fb.gemm_wgrad(a, dy)))
            w = torch.randn(K, N, generator=gen).to(DEV, bf)
            calls.append((f"gemm_bias_act K{K} N{N}", lambda a=a, w=w: (
                fb.gemm_bias_act(a, w, w[0].contiguous(), "gelu"),)))
            calls.append((f"gemm_dgrad K{K} N{N}", lambda a=a, dy=dy, w=w: (
                fb.gemm_dgrad(dy, w, a, "add", torch.float32),)))
        qkv = torch.randn(B, res, res, 3 * C, generator=gen).to(DEV, bf)
        dout = torch.randn(B, res, res, C, generator=gen).to(DEV, bf)
        kw = dict(window_size=ws, num_heads=heads, shift=shift)
        calls.append(("swin_window_attn_bwd", lambda: fb.window_attention_bwd(
            qkv, dout, t["rel_bias"], t["logit_scale"], t["mask"], **kw)))
        for what, fn in calls:
            first = [x.clone() for x in fn()]
            second = fn()
            sync(torch)
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                fail(f"{what} at stage{stage} shift{shift} b{B} differs between two launches")
            n += 1
    print(f"check: gemm_wgrad, swin_window_attn_bwd, gemm_bias_act and gemm_dgrad "
          f"bit-identical over two launches ({n} comparisons, bf16 b{B})")
    return n


def window_attention_inputs(torch, B, res, C, heads, ws, shift, dtype, seed):
    """Seeded operands of ``fused_window_attention`` at one block geometry,
    as the ``"pallas"`` backbone hands them over: q, k, v [B*nW, heads, L,
    32] in `dtype`; the bias [nW, heads, L, L] f32 (the CPB bias plus the f32
    shift mask) for a shifted block, else [1, heads, L, L] in `dtype`; the
    logit scale [heads] f32."""
    from cs_vit_tpu_torch.models.swinv2 import _shift_attn_mask

    g = torch.Generator().manual_seed(seed)
    L, nW, hd = ws * ws, (res // ws) ** 2, C // heads
    q, k, v = (torch.randn(B * nW, heads, L, hd, generator=g).to(DEV, dtype) for _ in range(3))
    rel_bias = (16 * torch.sigmoid(torch.randn(heads, L, L, generator=g))).to(DEV, dtype)
    bias = rel_bias[None]
    if shift:
        bias = bias + torch.from_numpy(_shift_attn_mask(res, res, ws, shift)).to(DEV)[:, None]
    scale = torch.exp(torch.clamp(math.log(10.0) + 0.5 * torch.randn(heads, generator=g),
                                  max=math.log(100.0))).to(DEV)
    return q, k, v, bias.contiguous(), scale


def window_attention_checks(torch, wa, dname, geom, B=2):
    """The attention-only window kernel against its plain version at one block
    geometry and batch B: [(kernel, what, max_abs, rel, tol)]."""
    stage, res, C, heads, ws, shift, _ = geom
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
    ops = window_attention_inputs(torch, B, res, C, heads, ws, shift, dtype,
                                  seed=stage * 10 + shift + 100 * B + 13)
    got, want = wa.fused_window_attention(*ops), wa.fused_window_attention_reference(*ops)
    sync(torch)
    what = f"bias {ops[3].dtype} [{ops[3].shape[0]},H,L,L]"
    return [("fused_window_attention", what, *rel_err(got, want), TOL[dname]["kernel"])]


def check_window_attention_refuses_grad(torch, wa):
    """A CUDA call under autograd with an input that requires grad raises:
    the kernel has no backward."""
    q, k, v, bias, scale = window_attention_inputs(torch, 1, 16, 64, 2, 4, 0, torch.float32, 1)
    q.requires_grad_()
    try:
        wa.fused_window_attention(q, k, v, bias, scale)
    except RuntimeError as e:
        print(f"check: fused_window_attention under autograd raises: {e}")
        return
    fail("fused_window_attention ran under autograd on an input that requires grad")


def check_kernels(torch, fb, wa):
    """Phase 3: kernel_checks, bwd_kernel_checks and window_attention_checks
    at every geometry and batch, bf16 and f32; one line per geometry, batch
    and dtype with each kernel's worst rel; fails on the first disagreement.
    Returns each kernel's worst bf16 max_abs."""
    worst = {k: 0.0 for k in ("gemm_bias_act", "ln_residual", "swin_window_attn_fwd",
                              "gemm_dgrad", "gemm_wgrad", "ln_residual_bwd",
                              "swin_window_attn_bwd", "fused_window_attention")}
    n_checks = 0
    masked = [g for g in GEOMS + SMALL_GEOMS if (g[0], g[5]) in MASKED_ROW_GEOMS]
    for dname in ("bf16", "f32"):
        for geom, B, kind in (
            [(g, B, "all") for g in GEOMS for B in CHECK_BATCHES + WA_PATH_BATCHES]
            + [(g, B, "attention") for g in SMALL_GEOMS for B in CHECK_BATCHES]
            + [(g, 2, "masked row") for g in masked]
        ):
            if kind == "all":
                results = window_attention_checks(torch, wa, dname, geom, B)
                if B in CHECK_BATCHES:
                    results = (kernel_checks(torch, fb, dname, geom, B)
                               + bwd_kernel_checks(torch, fb, dname, geom, B) + results)
            else:
                results = attention_checks(torch, fb, wa, dname, geom, B,
                                           masked_row=kind == "masked row")
            n_checks += len(results)
            where = (f"{dname} b{B} stage{geom[0]} shift{geom[5]}" if kind == "all" else
                     f"{dname} b{B} L{geom[4] ** 2} shift{geom[5]} {kind}")
            by_kernel = {}
            for name, what, err, rel, tol in results:
                if not rel <= tol:
                    print(f"check {where} {name} {what}: max_abs={err:.3e} rel={rel:.3e} "
                          f"tol={tol:.1e} FAIL")
                    fail(f"{name} ({what}) disagrees with its plain version")
                by_kernel[name] = max(by_kernel.get(name, (0.0, tol)), (rel, tol))
                if dname == "bf16" and name in worst:
                    worst[name] = max(worst[name], err)
            print(f"check {where} worst rel/tol: " + ", ".join(
                f"{k} {r:.2e}/{t:.0e}" for k, (r, t) in by_kernel.items()))
        for name, what, err, rel, tol in (bwd_edge_checks(torch, fb, dname)
                                          + gemm_edge_checks(torch, fb, dname)):
            n_checks += 1
            ok = rel <= tol
            print(f"check {dname} {name} {what}: max_abs={err:.3e} rel={rel:.3e} tol={tol:.1e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} ({what}) disagrees with its plain version")
            if dname == "bf16":
                worst[name] = max(worst[name], err)
    print(f"check: {n_checks} kernel and block checks ok")
    return worst


# the tensor-core instantiations of each library: (kernel, L, variant); the
# wgmma GEMMs have no L (0): gemm_bias_act's and gemm_dgrad's variants are
# their output tiles (rows x columns)
GEMM_TILE_NAMES = ("128x128", "128x64", "64x64")
TC_KERNELS = {
    "fused_block": {("window_attn_tc_kernel", L, v)
                    for L in (256, 64, 16) for v in ("masked", "unmasked")}
                   | {("gemm_bias_act_wgmma_kernel", 0, t) for t in GEMM_TILE_NAMES},
    "window_attention": {("fused_window_attn_tc_kernel", L, v)
                         for L in (256, 64, 16) for v in ("f32 bias", "bf16 bias")},
    "fused_block_bwd": {("window_attn_bwd_tc_kernel", L, v)
                        for L in (256, 64, 16) for v in ("masked", "unmasked")}
                       | {("wgrad_wgmma_kernel", 0, "bf16")}
                       | {("dgrad_wgmma_kernel", 0, t) for t in GEMM_TILE_NAMES},
}


def ptxas_entries(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from an ``nvcc -Xptxas -v`` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, [0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def check_tc_spills(lib: str, log: str) -> None:
    """The tensor-core kernels (the window-attention ``*_tc_kernel``s, which
    keep their score blocks in registers, and the three wgmma GEMMs, which
    keep their accumulators there): fail on any spill, and unless the report
    holds every instantiation of TC_KERNELS[lib]."""
    seen = set()
    for name, (regs, stores, loads) in ptxas_entries(log).items():
        m = re.search(r"\d((?:fused_)?window_attn(?:_bwd)?_tc_kernel)ILi(\d+)E"
                      r"(f|13__nv_bfloat16|Lb[01]E)", name)
        if m:
            variant = {"f": "f32 bias", "13__nv_bfloat16": "bf16 bias", "Lb1E": "masked",
                       "Lb0E": "unmasked"}[m.group(3)]
            key = (m.group(1), int(m.group(2)), variant)
            what = f"{m.group(1)}<L={m.group(2)}, {variant}>"
        elif re.search(r"\dwgrad_wgmma_kernel", name):
            key, what = ("wgrad_wgmma_kernel", 0, "bf16"), "wgrad_wgmma_kernel"
        elif m := re.search(r"\d((?:gemm_bias_act|dgrad)_wgmma_kernel)ILi(\d+)ELi(\d+)E", name):
            key = (m.group(1), 0, f"{m.group(2)}x{m.group(3)}")
            what = f"{m.group(1)}<{key[2]}>"
        else:
            continue
        seen.add(key)
        print(f"tensor-core kernel {lib}: {what} {regs} registers, spill stores {stores} B, "
              f"spill loads {loads} B")
        if stores or loads:
            fail(f"{what} spills registers ({stores} B stored, {loads} B loaded)")
    missing = TC_KERNELS[lib] - seen
    if missing:
        fail(f"the ptxas report of {lib} lacks {sorted(missing)}: their spills are unchecked")


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync(torch)
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters=20, warmup=3):
    """Device ms per call of fn, printed beside cuda_ms's reading (the calls
    as the host issues them): here the `iters` calls wait behind a sleep
    kernel of SLEEP_CYCLES, so they run back to back and the events read the
    card's time, not the host's issue rate. Returns (ms, host_gapped):
    host_gapped is True where the enqueue outlasted the sleep, so that host
    gaps are in the reading."""
    for _ in range(warmup):
        fn()
    sync(torch)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    sync(torch)
    return ev[1].elapsed_time(ev[2]) / iters, host_ms > ev[0].elapsed_time(ev[1])


# the kernels line's keys of a device-queued reading (queued_ms) of a kernel
# and of its library call, beside the issued ones (ms, library_ms)
QUEUED_KEYS = {"queued_ms": 0.0, "queued_library_ms": 0.0, "queued_host_gapped": False}


def queued(torch, r, n_blocks, kernel, library, what):
    """Adds n_blocks device-queued readings of `kernel` and `library` to the
    totals r (QUEUED_KEYS) and prints them."""
    ms, gap_k = queued_ms(torch, kernel)
    lib, gap_l = queued_ms(torch, library)
    print(f"queued {what}: {ms:.4f} ms, library {lib:.4f} ms"
          + (" (host gaps included)" if gap_k or gap_l else ""))
    r["queued_ms"] += n_blocks * ms
    r["queued_library_ms"] += n_blocks * lib
    r["queued_host_gapped"] |= gap_k or gap_l


def time_kernels(torch, fb, F, B=8):
    """Phase 9: per-forward totals at batch B, bf16, summed over the 24 blocks;
    gemm_bias_act and swin_window_attn_fwd and their library calls also
    queued (queued_ms)."""
    bf = torch.bfloat16
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_s": 0.0, "flops_s": 0.0,
               "bound_ms": 0.0} for k in ("gemm_bias_act", "ln_residual", "swin_window_attn_fwd")}

    def add(name, n_blocks, ms, plain, lib, nbytes, flops, peak, what=""):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        print(f"timed stage{stage} shift{shift} {name} {what}: {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib:.4f} ms, bound {max(tb, tf):.4f} ms "
              f"({'bytes' if tb >= tf else 'operations'}) x{n_blocks} blocks")
        r = tot[name]
        r["ms"] += n_blocks * ms
        r["plain_ms"] += n_blocks * plain
        r["library_ms"] += n_blocks * lib
        r["bytes_s"] += n_blocks * tb
        r["flops_s"] += n_blocks * tf
        r["bound_ms"] += n_blocks * max(tb, tf)

    for k in ("gemm_bias_act", "swin_window_attn_fwd"):
        tot[k].update(QUEUED_KEYS)
    for stage, res, C, heads, ws, shift, n_blocks in GEOMS:
        t = block_inputs(torch, B, res, C, heads, ws, shift, bf, seed=100 + stage)
        M, L, Ch = B * res * res, ws * ws, 4 * C
        x2 = t["x"].reshape(M, C)
        # the four GEMMs of a block
        for (K, N, act, odt, a, w, b) in (
            (C, 3 * C, "none", bf, x2, t["wqkv"], t["bqkv"]),
            (C, C, "none", torch.float32, x2, t["wproj"], t["bproj"]),
            (C, Ch, "gelu", bf, x2, t["w1"], t["b1"]),
            (Ch, C, "none", torch.float32, torch.randn(M, Ch, device=DEV).to(bf),
             t["w2"], t["b2"]),
        ):
            ms = cuda_ms(torch, lambda: fb.gemm_bias_act(a, w, b, act=act, out_dtype=odt))
            plain = cuda_ms(torch, lambda: fb.gemm_bias_act_reference(a, w, b, act=act, out_dtype=odt))
            lib = cuda_ms(torch, lambda: torch.addmm(b, a, w))
            queued(torch, tot["gemm_bias_act"], n_blocks,
                   lambda: fb.gemm_bias_act(a, w, b, act=act, out_dtype=odt),
                   lambda: torch.addmm(b, a, w),
                   f"stage{stage} shift{shift} gemm_bias_act M{M} K{K} N{N} {act}")
            nbytes = (M * K + K * N + N) * 2 + M * N * (4 if odt == torch.float32 else 2)
            add("gemm_bias_act", n_blocks, ms, plain, lib, nbytes, 2 * M * N * K,
                PEAK_FLOPS["bf16"], f"M{M} K{K} N{N} {act}")
        # the two LayerNorm-residuals of a block
        z = torch.randn(M, C, device=DEV)
        r32 = torch.randn(M, C, device=DEV)
        for res_t, keep in ((x2, True), (r32, False)):
            g, be = t["ln1_scale"], t["ln1_bias"]
            ms = cuda_ms(torch, lambda: fb.ln_residual(z, res_t, g, be, None, 0, 1e-5, bf, keep))
            plain = cuda_ms(torch, lambda: fb.ln_residual_reference(z, res_t, g, be, None, 0, 1e-5, bf))
            lib = cuda_ms(torch, lambda: res_t + F.layer_norm(z, (C,), g.float(), be.float(), 1e-5))
            nbytes = M * C * (4 + res_t.element_size() + 2 + (4 if keep else 0)) + 2 * C * 2
            add("ln_residual", n_blocks, ms, plain, lib, nbytes, 8 * M * C, PEAK_FLOPS["f32"],
                f"M{M} C{C} res-{res_t.dtype}")
        # window attention
        qkv = torch.randn(B, res, res, 3 * C, device=DEV).to(bf)
        kw = dict(window_size=ws, num_heads=heads, shift=shift)
        rb, ls, mk = t["rel_bias"], t["logit_scale"], t["mask"]
        ms = cuda_ms(torch, lambda: fb.window_attention(qkv, rb, ls, mk, **kw))
        plain = cuda_ms(torch, lambda: fb.window_attention_reference(qkv, rb, ls, mk, **kw))
        # library yardstick: SDPA on pre-rolled, pre-partitioned, pre-normalised
        # q/k/v with the scale folded into q and bias+mask as one float mask
        hd = C // heads
        win = fb.window_partition(torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv, ws)
        win = win.reshape(-1, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q = F.normalize(win[0].float(), dim=-1) * ls.reshape(1, heads, 1, 1)
        k = F.normalize(win[1].float(), dim=-1)
        nW = (res // ws) ** 2
        bias = rb.float()[None].expand(nW, heads, L, L)
        if mk is not None:
            bias = bias + mk.float()[:, None]
        bias = bias[None].expand(B, nW, heads, L, L).reshape(B * nW, heads, L, L).to(bf).contiguous()
        q, k, v = q.to(bf).contiguous(), k.to(bf).contiguous(), win[2].contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)  # noqa: E731
        lib = cuda_ms(torch, sdpa)
        queued(torch, tot["swin_window_attn_fwd"], n_blocks,
               lambda: fb.window_attention(qkv, rb, ls, mk, **kw), sdpa,
               f"stage{stage} shift{shift} swin_window_attn_fwd")
        # q|k|v in, o out; bias and mask in their own dtype (bf16, as served)
        nbytes = (M * 3 * C * 2 + M * C * 2 + heads * 4
                  + (heads * L * L + (nW * L * L if shift else 0)) * rb.element_size())
        add("swin_window_attn_fwd", n_blocks, ms, plain, lib, nbytes,
            4 * L * hd * M * heads, PEAK_FLOPS["bf16"], f"B{B} L{L} heads{heads}")
    return tot


def serve(torch, fb):
    """Phase 4: the flagship model through PoserSession, b1 and b8."""
    import numpy as np

    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.serving import PoserSession

    cfg = FinetuneConfig(exp="chip_smoke", backbone=BACKBONE, img_size=IMG,
                         phase="inference", attention_impl="auto")
    rng = np.random.default_rng(0)

    def request(N):
        S = IMG
        x0 = rng.uniform(40, 200, size=(N, 1, 1)).astype(np.float32)
        y0 = rng.uniform(40, 200, size=(N, 1, 1)).astype(np.float32)
        side = rng.uniform(120, 300, size=(N, 1, 1)).astype(np.float32)
        return (
            rng.uniform(size=(N, 1, S, S, 3)).astype(np.float32),
            np.concatenate([x0, y0, x0 + side, y0 + side], -1),
            np.zeros((N, 1), np.float32),
            rng.uniform(500, 700, size=(N, 1, 2)).astype(np.float32),
            rng.uniform(200, 320, size=(N, 1, 2)).astype(np.float32),
        )

    t0 = time.perf_counter()
    s8 = PoserSession(cfg, batch_size=8, dtype="bfloat16", device=DEV)
    s1 = PoserSession(cfg, batch_size=1, dtype="bfloat16", device=DEV)
    s8.warmup()
    s1.warmup()
    sync(torch)
    print(f"serve: sessions built and warmed in {time.perf_counter() - t0:.1f} s")

    requests = [(s8, request(8)), (s8, request(11)), (s1, request(3))]
    forwards = sum(math.ceil(r[0].shape[0] / s.batch_size) for s, r in requests)
    fb.reset_launch_counts()
    outs = [s.predict_crops(*r) for s, r in requests]
    sync(torch)
    counts = fb.launch_counts()
    print(f"serve: {forwards} forwards, launches {json.dumps(counts)}")
    depth = sum(s8.model.backbone.config.depths)
    expect = {"fused_swin_block": depth, "swin_window_attn_fwd": depth,
              "gemm_bias_act": 4 * depth, "ln_residual": 2 * depth}
    fwd_name = {"fused_swin_block": "fused_swin_block", "swin_window_attn_fwd": "window_attention",
                "gemm_bias_act": "gemm_bias_act", "ln_residual": "ln_residual"}
    for name, per in expect.items():
        if counts[fwd_name[name]] != per * forwards:
            fail(f"{name}: {counts[fwd_name[name]]} launches for {forwards} forwards, "
                 f"expected {per} per forward")
    for (s, r), out in zip(requests, outs):
        N = r[0].shape[0]
        jc = out["joint_cam"]
        if jc.shape != (N, 1, 21, 3) or not np.isfinite(jc).all():
            fail(f"joint_cam has shape {jc.shape} or non-finite values")
        if out["verts_cam"].shape != (N, 1, 778, 3) or not np.isfinite(out["verts_cam"]).all():
            fail("verts_cam has the wrong shape or non-finite values")
    print("serve: joint_cam finite, shapes [N,1,21,3] for N = 8, 11 (padded), 3 (b1)")

    # kernel path vs eager path on the card: one session per dtype (one set
    # of weights), its backbone switched between the two paths
    f32 = PoserSession(cfg, batch_size=8, dtype="float32", device=DEV)
    compare_paths(torch, "serve", {"bf16": s8, "f32": f32}, "fused", request(8),
                  bf16_tokens=True)
    del f32
    return s1, s8, request, counts, forwards


def compare_paths(torch, tag, sessions, impl, req, bf16_tokens):
    """The served model on the backbone path `impl` against the eager path,
    on the card, same weights and inputs: f32 backbone tokens within
    SERVE_TOKEN_TOL (bf16 tokens too when `bf16_tokens`; the bf16 flows of
    the eager path and of an attention-only kernel path differ by design, so
    those are printed only), joint_cam within twice each dtype's noise
    floor plus SERVE_MM_SLACK (see there). `sessions` maps "bf16" and "f32"
    to sessions of one config; each is left on `impl`."""
    import numpy as np

    jc, tokens = {}, {}
    for dname, sess in sessions.items():
        x = torch.as_tensor(req[0].reshape((-1,) + req[0].shape[2:])).to(DEV, sess._dtype)
        x = ((x.float() - sess.model.img_mean) / sess.model.img_std).to(sess._dtype)
        for path in (impl, "eager"):
            sess.model.backbone.set_attention_impl(path)
            jc[dname, path] = sess.predict_crops(*req)["joint_cam"]
            with torch.no_grad():
                tokens[dname, path] = sess.model.backbone(x)
    eager32 = sessions["f32"]  # left on the eager path
    for dname in ("f32", "bf16"):
        err, rel = rel_err(tokens[dname, impl], tokens[dname, "eager"])
        checked = dname == "f32" or bf16_tokens
        ok = rel <= SERVE_TOKEN_TOL[dname]
        print(f"{tag}: {dname} backbone tokens kernel path vs eager path: max_abs={err:.4e} "
              f"rel={rel:.4e} " + (f"tol={SERVE_TOKEN_TOL[dname]:.0e} {'ok' if ok else 'FAIL'}"
                                   if checked else "(two dtype flows by design: not held)"))
        if checked and not ok:
            fail(f"{tag}: {dname} backbone tokens of the kernel path disagree with the eager path")

    # noise floors in mm (see SERVE_MM_SLACK): the eager f32 model's heads on
    # given tokens, its backbone swapped out for the duration
    class FixedTokens(torch.nn.Module):
        def __init__(self, t):
            super().__init__()
            self.t = t

        def forward(self, x, generator=None):
            return self.t

    def head_mm(t):
        backbone, eager32.model.backbone = eager32.model.backbone, FixedTokens(t)
        try:
            return float(np.abs(eager32.predict_crops(*req)["joint_cam"]
                                - jc["f32", "eager"]).max())
        finally:
            eager32.model.backbone = backbone

    base = tokens["f32", "eager"]
    delta = (tokens["f32", impl] - base).flatten()
    gen = torch.Generator().manual_seed(0)
    shifts = [head_mm(base + delta[torch.randperm(delta.numel(), generator=gen).to(DEV)]
                      .reshape(base.shape)) for _ in range(WITNESSES)]
    print(f"{tag}: f32 head on eager tokens + permuted kernel-path token difference: "
          f"joint_cam moves {', '.join(f'{v:.4f}' for v in shifts)} mm; on the kernel "
          f"path's own tokens {head_mm(tokens['f32', impl]):.4f} mm, on the eager "
          f"path's own {head_mm(base):.4f} mm")
    floor = {"f32": max(shifts),
             "bf16": float(np.abs(jc["bf16", "eager"] - jc["f32", "eager"]).max())}
    print(f"{tag}: joint_cam noise floor f32 {floor['f32']:.4f} mm, bf16 (|eager bf16 - "
          f"eager f32|) {floor['bf16']:.4f} mm; max|joint_cam| = "
          f"{float(np.abs(jc['f32', 'eager']).max()):.1f} mm")
    for dname in ("f32", "bf16"):
        err = float(np.abs(jc[dname, impl] - jc[dname, "eager"]).max())
        tol = 2 * floor[dname] + SERVE_MM_SLACK[dname]
        ok = err <= tol
        print(f"{tag}: {dname} joint_cam kernel path vs eager path: max_abs={err:.4f} mm, "
              f"tol={tol:.4f} mm {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{tag}: {dname} kernel path disagrees with the eager path")
    for sess in sessions.values():
        sess.model.backbone.set_attention_impl(impl)


def serve_realtime(torch, launches):
    """Phase 5: the flagship model with realtime temporal encoders (random
    temporal weights, so they change the output) over RT_T frames, through
    PoserSession on the attention-only kernel, b1 and b8."""
    import numpy as np

    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.serving import PoserSession

    cfg = FinetuneConfig(exp="chip_smoke", backbone=BACKBONE, img_size=IMG, phase="inference",
                         temporal_supervision="realtime", temporal_init_method="random",
                         attention_impl="pallas")
    rng = np.random.default_rng(1)
    T = RT_T

    def request(N):
        x0 = rng.uniform(40, 200, size=(N, T, 1)).astype(np.float32)
        y0 = rng.uniform(40, 200, size=(N, T, 1)).astype(np.float32)
        side = rng.uniform(120, 300, size=(N, T, 1)).astype(np.float32)
        ts = np.cumsum(rng.uniform(25, 45, size=(N, T)), axis=1).astype(np.float32)
        return (
            rng.uniform(size=(N, T, IMG, IMG, 3)).astype(np.float32),
            np.concatenate([x0, y0, x0 + side, y0 + side], -1),
            ts,
            rng.uniform(500, 700, size=(N, T, 2)).astype(np.float32),
            rng.uniform(200, 320, size=(N, T, 2)).astype(np.float32),
        )

    s8 = PoserSession(cfg, batch_size=8, seq_len=T, dtype="bfloat16", device=DEV)
    s1 = PoserSession(cfg, batch_size=1, seq_len=T, dtype="bfloat16", device=DEV)
    s8.warmup()
    s1.warmup()
    sync(torch)
    requests = [(s8, request(8)), (s8, request(11)), (s1, request(3))]
    forwards = sum(math.ceil(r[0].shape[0] / s.batch_size) for s, r in requests)
    launches.reset_launch_counts()
    outs = [s.predict_crops(*r) for s, r in requests]
    sync(torch)
    counts = launches.launch_counts()
    print(f"serve_rt{T}: {forwards} forwards, launches {json.dumps(counts)}")
    depth = sum(s8.model.backbone.config.depths)
    # blocks whose image splits into more than one window: "hybrid" runs the
    # kernel there (Swin-B-256: stages 0 and 1)
    multi = sum(n for _, res, _, _, ws, _, n in GEOMS if res > ws)
    if DEV == "cuda":
        if counts["fused_window_attention"] != depth * forwards or any(
                v for k, v in counts.items() if k != "fused_window_attention"):
            fail(f"serve_rt{T}: expected {depth} fused_window_attention launches per forward "
                 f"and no other kernel, got {counts}")
    for (s, r), out in zip(requests, outs):
        N = r[0].shape[0]
        for key, tail in (("joint_cam", (21, 3)), ("verts_cam", (778, 3))):
            if out[key].shape != (N, 1) + tail or not np.isfinite(out[key]).all():
                fail(f"serve_rt{T}: {key} has shape {out[key].shape} or non-finite values")
    print(f"serve_rt{T}: joint_cam finite, shapes [N,1,21,3] for N = 8, 11 (padded), 3 (b1)")

    s8.model.backbone.set_attention_impl("hybrid")
    launches.reset_launch_counts()
    s8.predict_crops(*request(8))
    sync(torch)
    hybrid = launches.launch_counts()
    s8.model.backbone.set_attention_impl("pallas")
    print(f"serve_rt{T}: hybrid, one forward: launches {json.dumps(hybrid)}")
    if DEV == "cuda" and (hybrid["fused_window_attention"] != multi
                          or any(v for k, v in hybrid.items() if k != "fused_window_attention")):
        fail(f"serve_rt{T}: hybrid expected {multi} fused_window_attention launches and no "
             f"other kernel, got {hybrid}")

    # kernel path vs eager path from calibrated BatchNorm statistics (see
    # CALIBRATION_FORWARDS), the same in both sessions
    f32 = PoserSession(cfg, batch_size=8, seq_len=T, dtype="float32", device=DEV)
    calibrate_statistics(torch, f32.model, temporal_batch(torch, 8, T, seed=30),
                         ("spatial", "temporal"))
    s8.model.load_state_dict({k: v for k, v in f32.model.state_dict().items()
                              if k.endswith(("running_mean", "running_var"))}, strict=False)
    compare_paths(torch, f"serve_rt{T}", {"bf16": s8, "f32": f32}, "pallas", request(8),
                  bf16_tokens=False)
    del f32
    return s1, s8, request, counts


def train_batch(torch, B, seed):
    """A seeded spatial-phase batch of B crops on the card (T=1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    jc = rng.normal(scale=20.0, size=(B, 1, 21, 3)).astype(np.float32)
    jc[..., 2] += 400.0
    x0 = rng.uniform(40, 200, size=(B, 1, 2)).astype(np.float32)
    side = rng.uniform(120, 300, size=(B, 1, 1)).astype(np.float32)
    batch = {
        "patches": rng.uniform(size=(B, 1, IMG, IMG, 3)).astype(np.float32),
        "square_bboxes": np.concatenate([x0, x0 + side], -1),
        "timestamp": np.zeros((B, 1), np.float32),
        "focal": rng.uniform(500, 700, size=(B, 1, 2)).astype(np.float32),
        "princpt": rng.uniform(200, 320, size=(B, 1, 2)).astype(np.float32),
        "joint_cam": jc,
        "joint_valid": np.ones((B, 1, 21), np.float32),
        "mano_shape": rng.normal(scale=0.5, size=(B, 1, 10)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}


def train_model(torch, seed=0):
    """The flagship Poser with seeded random f32 weights on the card, in the
    spatial phase's configuration (kernel path)."""
    from cs_vit_tpu_torch.cli.common import build_model
    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.models import init_poser_weights

    cfg = FinetuneConfig(exp="chip_smoke", backbone=BACKBONE, img_size=IMG, phase="spatial",
                         attention_impl="fused")
    model = build_model(cfg)
    init_poser_weights(model, seed)
    return model.to(DEV)


def with_impl(model, impl):
    import copy

    out = copy.deepcopy(model)
    out.backbone.set_attention_impl(impl)
    return out


def new_step(torch, model, compute_dtype, phase="spatial", lr=TRAIN_LR):
    from cs_vit_tpu_torch.train import TrainState, build_optimizer, make_train_step

    state = TrainState.create(model, build_optimizer(model, phase, lr))
    return state, make_train_step(model, state.optimizer, phase, compute_dtype=compute_dtype)


def check_train(torch, fb, model, B=8):
    """Phase 6: the spatial step's grads and loss, kernel path vs eager path
    from the same weights, batch and droppath draws."""
    # (1) backbone grads, f32, under a backbone-only loss
    x = train_batch(torch, B, seed=1)["patches"][:, 0]
    x = (x - model.img_mean) / model.img_std
    proj, grads = None, {}
    for impl in ("fused", "eager"):
        m = with_impl(model, impl)
        params = dict(m.backbone.named_parameters())
        fb.reset_launch_counts()
        tokens = m.backbone(x, torch.Generator(device=DEV).manual_seed(3))
        if proj is None:
            gen = torch.Generator().manual_seed(2)
            proj = (torch.randn(tokens.shape, generator=gen) / tokens.shape[1] ** 0.5).to(DEV)
        g = torch.autograd.grad((tokens.float() * proj).sum(), list(params.values()))
        sync(torch)
        if (DEV == "cuda" and impl == "fused"
                and fb.launch_counts()["FusedSwinBlock"] != sum(m.backbone.config.depths)):
            fail(f"backbone grads ran {fb.launch_counts()['FusedSwinBlock']} block backwards "
                 "through the kernels")
        grads[impl] = dict(zip(params, g))
        del m
    rows = sorted(((rel_err(grads["fused"][n], grads["eager"][n])[1], n) for n in grads["eager"]),
                  reverse=True)
    print(f"train: f32 backbone grads, kernel path vs eager path, {len(rows)} parameters; "
          f"worst rel (max|diff| / max|eager grad|): "
          + ", ".join(f"{n} {r:.3e}" for r, n in rows[:5]))
    if not rows[0][0] <= TRAIN_GRAD_TOL:
        fail(f"backbone grad {rows[0][1]} of the kernel path disagrees with the eager path "
             f"(rel {rows[0][0]:.3e} > {TRAIN_GRAD_TOL:.0e})")
    del grads

    # (2) the whole step, f32 and bf16: kernel path vs eager path
    batch = train_batch(torch, B, seed=4)
    res = {}
    for impl in ("fused", "eager"):
        for dname, cdt in (("f32", None), ("bf16", torch.bfloat16)):
            m = with_impl(model, impl)
            state, step = new_step(torch, m, cdt)
            state, met = step(state, batch, torch.Generator(device=DEV).manual_seed(5))
            res[impl, dname] = (float(met["loss"]), float(met["grad_norm"]))
            if state.step != 1 or not all(math.isfinite(v) for v in res[impl, dname]):
                fail(f"{impl} {dname} step: step {state.step}, loss/grad_norm {res[impl, dname]}")
            print(f"train: {impl} {dname} step: loss {res[impl, dname][0]:.6f} "
                  f"grad_norm {res[impl, dname][1]:.6f}")
            del m, state, step
    for i, what in enumerate(("loss", "grad_norm")):
        truth = res["eager", "f32"][i]
        err = abs(res["fused", "f32"][i] - truth)
        ok = err <= TRAIN_F32_TOL * abs(truth)
        print(f"train: f32 {what} kernel path vs eager path: |diff| {err:.6f} "
              f"(rel {err / abs(truth):.3e}, tol {TRAIN_F32_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"f32 step {what} of the kernel path disagrees with the eager path")
        floor = abs(res["eager", "bf16"][i] - truth)
        err = abs(res["fused", "bf16"][i] - truth)
        tol = 2 * floor + TRAIN_BF16_SLACK * abs(truth)
        ok = err <= tol
        print(f"train: bf16 {what}: kernel path's distance from the f32 eager step {err:.6f}, "
              f"eager bf16 path's {floor:.6f}, tol {tol:.6f} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"bf16 step {what} of the kernel path is further from the f32 step than "
                 "the eager bf16 path allows")


def check_nan_skip(torch, state, step, batch):
    """A batch with a NaN target (in a supervised frame) leaves the state
    bit-identical (phases 6 and 7)."""
    import copy

    model, opt = state.model, state.optimizer
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = copy.deepcopy(opt.state_dict())
    steps = state.step
    bad = dict(batch, joint_cam=batch["joint_cam"].clone())
    bad["joint_cam"][0, -1, 0, 0] = float("nan")  # a supervised frame in every mode
    state, met = step(state, bad, torch.Generator(device=DEV).manual_seed(6))
    sync(torch)
    after = opt.state_dict()
    same = (all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
            and after["param_groups"] == opt_before["param_groups"]
            and all(torch.equal(after["state"][i][k], v)
                    for i, s in opt_before["state"].items() for k, v in s.items()))
    print(f"train: NaN batch: skipped={float(met['skipped'])}, step {steps} -> {state.step}, "
          f"parameters, BatchNorm statistics and AdamW state bit-identical: {same}")
    if not (same and float(met["skipped"]) == 1.0 and state.step == steps):
        fail("a NaN batch changed the train state")


def train_curve(torch, fb, state, step, batch, n, tag="train"):
    """n bf16 steps on one fixed batch, with the same droppath draws in every
    step (one fixed objective); the loss must fall. Returns the step times
    (ms), the launch counts of the last step (`fb`: anything with
    ``reset_launch_counts``/``launch_counts``) and the device memory that
    step holds above what stays resident (weights, AdamW state), in bytes
    (None off the card)."""
    losses, times, counts, peak = [], [], None, None
    gen = torch.Generator(device=DEV)
    for i in range(n):
        gen.manual_seed(7)
        sync(torch)
        if i == n - 1:
            fb.reset_launch_counts()
            if DEV == "cuda":
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = step(state, batch, gen)
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
        if i == n - 1:
            counts = fb.launch_counts()
            if DEV == "cuda":
                peak = torch.cuda.max_memory_allocated() - resident
                print(f"{tag}: one step's peak device memory above the resident "
                      f"{resident / 2**30:.2f} GiB: {peak / 2**30:.2f} GiB")
        losses.append(float(met["loss"]))
    print(f"{tag}: loss curve " + " ".join(f"{v:.3f}" for v in losses))
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not (all(math.isfinite(v) for v in losses) and last < TRAIN_FALL * first):
        fail(f"{tag}: the loss did not fall: first three {first:.4f}, last three {last:.4f}")
    print(f"{tag}: mean loss of the first three steps {first:.4f}, of the last three {last:.4f}")
    return times, counts, peak


def temporal_batch(torch, B, T, seed):
    """A seeded batch of B samples of T frames on the card, timestamps ~33 ms
    apart."""
    import numpy as np

    rng = np.random.default_rng(seed)
    jc = rng.normal(scale=20.0, size=(B, T, 21, 3)).astype(np.float32)
    jc[..., 2] += 400.0
    x0 = rng.uniform(40, 200, size=(B, T, 2)).astype(np.float32)
    side = rng.uniform(120, 300, size=(B, T, 1)).astype(np.float32)
    batch = {
        "patches": rng.uniform(size=(B, T, IMG, IMG, 3)).astype(np.float32),
        "square_bboxes": np.concatenate([x0, x0 + side], -1),
        "timestamp": np.cumsum(rng.uniform(25, 45, size=(B, T)), axis=1).astype(np.float32),
        "focal": rng.uniform(500, 700, size=(B, T, 2)).astype(np.float32),
        "princpt": rng.uniform(200, 320, size=(B, T, 2)).astype(np.float32),
        "joint_cam": jc,
        "joint_valid": np.ones((B, T, 21), np.float32),
        "mano_shape": rng.normal(scale=0.5, size=(B, T, 10)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}


def temporal_model(torch, sup, seed=0):
    """The flagship Poser with `sup` temporal encoders (random temporal
    weights) and seeded random f32 weights on the card, on the attention-only
    kernel."""
    from cs_vit_tpu_torch.cli.common import build_model
    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.models import init_poser_weights

    cfg = FinetuneConfig(exp="chip_smoke", backbone=BACKBONE, img_size=IMG, phase="temporal",
                         temporal_supervision=sup, temporal_init_method="random",
                         attention_impl="pallas")
    model = build_model(cfg)
    init_poser_weights(model, seed)
    return model.to(DEV)


def calibrate_statistics(torch, model, batch, phases=("spatial",)):
    """CALIBRATION_FORWARDS forwards without autograd in each of `phases`, in
    that order."""
    with torch.no_grad():
        for phase_name in phases:
            for _ in range(CALIBRATION_FORWARDS):
                model(batch, phase_name)
    sync(torch)


def saved_bytes(torch, step, state, batch):
    """Bytes autograd saves for backward during one step (which is taken)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step(state, batch, None)
    sync(torch)
    return total[0]


def check_temporal(torch, launches, sup, T, B=8):
    """Phase 7: the temporal step at batch B over T frames, only the temporal
    encoders training, after calibrate_statistics: the f32 backbone tokens
    and the f32 step of the attention-kernel path against the eager path,
    then TEMPORAL_STEPS bf16 steps on one batch (the loss falls, the
    launches of one step, no backbone activations saved, every frozen
    parameter and statistic bit-identical, the NaN skip). Returns (median
    step ms, launch counts of one step, peak bytes of one step, saved bytes
    of one step)."""
    tag = f"temporal_{sup}{T}"
    prefixes = ("pose_temporal_encoder", "shape_temporal_encoder", "root_temporal_encoder")
    model = temporal_model(torch, sup)
    batch = temporal_batch(torch, B, T, seed=20 + T)
    calibrate_statistics(torch, model, batch)
    x = batch["patches"].reshape((B * T,) + tuple(batch["patches"].shape[2:]))
    x = (x - model.img_mean) / model.img_std
    tokens = {}
    with torch.no_grad():
        for impl in ("pallas", "eager"):
            model.backbone.set_attention_impl(impl)
            tokens[impl] = model.backbone(x)
    model.backbone.set_attention_impl("pallas")
    err, rel = rel_err(tokens["pallas"], tokens["eager"])
    ok = rel <= SERVE_TOKEN_TOL["f32"]
    print(f"{tag}: f32 backbone tokens kernel path vs eager path ({B * T} images): "
          f"max_abs={err:.4e} rel={rel:.4e} tol={SERVE_TOKEN_TOL['f32']:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{tag}: f32 backbone tokens of the kernel path disagree with the eager path")
    del tokens, x
    res = {}
    for impl in ("pallas", "eager"):
        m = with_impl(model, impl)
        state, step = new_step(torch, m, None, "temporal", TEMPORAL_LR)
        state, met = step(state, batch, None)
        res[impl] = (float(met["loss"]), float(met["grad_norm"]))
        if state.step != 1 or not all(math.isfinite(v) for v in res[impl]):
            fail(f"{tag}: {impl} f32 step: step {state.step}, loss/grad_norm {res[impl]}")
        print(f"{tag}: {impl} f32 step: loss {res[impl][0]:.6f} grad_norm {res[impl][1]:.6f}")
        del m, state, step
    for i, what in enumerate(("loss", "grad_norm")):
        truth = res["eager"][i]
        err = abs(res["pallas"][i] - truth)
        ok = err <= TRAIN_F32_TOL * abs(truth)
        print(f"{tag}: f32 {what} kernel path vs eager path: |diff| {err:.6f} "
              f"(rel {err / abs(truth):.3e}, tol {TRAIN_F32_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{tag}: f32 step {what} of the kernel path disagrees with the eager path")

    frozen = {k: v.clone() for k, v in model.state_dict().items() if not k.startswith(prefixes)}
    state, step = new_step(torch, model, torch.bfloat16, "temporal", TEMPORAL_LR)
    print(f"{tag}: AdamW lr {TEMPORAL_LR} (constant), {TEMPORAL_STEPS} bf16 steps on one batch "
          f"of {B} x {T} frames")
    times, counts, peak = train_curve(torch, launches, state, step, batch, TEMPORAL_STEPS, tag)
    print(f"{tag}: launches in one step {json.dumps(counts)}")
    depth = sum(model.backbone.config.depths)
    if DEV == "cuda" and (counts["fused_window_attention"] != depth
                          or any(v for k, v in counts.items() if k != "fused_window_attention")):
        fail(f"{tag}: expected {depth} fused_window_attention launches per step and no other "
             f"kernel, got {counts}")
    saved = saved_bytes(torch, step, state, batch)
    trained = sum(p.numel() * 2 for p in state.optimizer.params())  # their bf16 copies
    print(f"{tag}: autograd saved {saved / 2**20:.1f} MiB in one step (the bf16 copies of the "
          f"trained parameters: {trained / 2**20:.1f} MiB)")
    if saved > trained + TEMPORAL_SAVED_MAX:
        fail(f"{tag}: one step saved {saved} bytes for backward: more than the trained "
             f"parameters' copies and {TEMPORAL_SAVED_MAX} bytes of activations")
    changed = [k for k, v in model.state_dict().items()
               if k in frozen and not torch.equal(v, frozen[k])]
    print(f"{tag}: {len(frozen)} frozen parameters and statistics bit-identical after "
          f"{state.step} steps: {not changed}")
    if changed:
        fail(f"{tag}: frozen state changed: {changed[:5]}")
    check_nan_skip(torch, state, step, batch)
    step_ms = statistics.median(times[3:])
    return step_ms, counts, peak, saved


def device_profile(torch, prof):
    """(busy ms, kernel rows, op rows) of a torch.profiler run. Busy time sums
    the device-side kernel events only: an op's or an autograd Function's
    self device time repeats the time of the kernels it launched, and a
    user annotation on the device timeline (the optimizer's step) spans
    kernels that are events of their own. Op rows [(device ms, count,
    name)] attribute the kernels to the op, Function or annotation that
    launched them."""
    from torch.autograd import DeviceType

    kernels, ops = [], []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us <= 0:
            continue
        on_device = (getattr(ev, "device_type", None) == DeviceType.CUDA
                     and not getattr(ev, "is_user_annotation", False))
        (kernels if on_device else ops).append((dev_us / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    return sum(r[0] for r in kernels), kernels, ops


def print_profile(tag, kernels, ops, n=12):
    for ms, count, key in kernels[:n]:
        print(f"{tag}: kernel {ms:9.3f} ms  x{count:4d}  {key[:90]}")
    for ms, count, key in ops[:n]:
        print(f"{tag}: launched by {ms:9.3f} ms  x{count:4d}  {key[:80]}")


def profile_step(torch, state, step, batch, median_ms):
    """Device busy time and idle share of one bf16 b8 step (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEV).manual_seed(8)
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, gen)
        sync(torch)
        wall = (time.perf_counter() - t0) * 1e3
    busy, kernels, ops = device_profile(torch, prof)
    if busy == 0:
        print("profile step: no device time recorded (not measured)")
        return None
    idle = max(0.0, 1 - busy / median_ms)
    print(f"profile step: b8 step wall {wall:.3f} ms (profiled), device busy {busy:.3f} ms "
          f"({sum(r[1] for r in kernels)} kernels), idle share against the unprofiled median "
          f"{median_ms:.3f} ms: {idle:.3f}")
    print_profile("profile step", kernels, ops, n=16)
    return idle


def time_bwd_kernels(torch, fb, F, B=8, iters=10):
    """Phase 9: the backward kernels at a bf16 b8 step's shapes, per step
    (summed over the 24 blocks), beside their plain versions, one library call
    each (yardsticks: torch.matmul, autograd of F.layer_norm and of SDPA with
    a float mask) and their bounds; gemm_dgrad, gemm_wgrad and
    swin_window_attn_bwd and their library calls also queued (queued_ms;
    gemm_dgrad's torch.matmul is handed dY already in bf16, so its byte
    floor is lower than the kernel's, which reads f32 dY). Prints the attention
    backward's scratch bytes per call and gemm_wgrad's split-partial bytes."""
    bf, f32 = torch.bfloat16, torch.float32
    names = ("gemm_dgrad", "gemm_wgrad", "ln_residual_bwd", "swin_window_attn_bwd")
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_s": 0.0, "flops_s": 0.0,
               "bound_ms": 0.0} for k in names}
    for k in ("gemm_dgrad", "gemm_wgrad", "swin_window_attn_bwd"):
        tot[k].update(QUEUED_KEYS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    partial_bytes = 0

    def ms_of(fn):
        return cuda_ms(torch, fn, iters=iters, warmup=2)

    def add(name, n_blocks, kern, plain, lib, nbytes, flops, peak, what):
        ms, pl, lb = ms_of(kern), ms_of(plain), ms_of(lib)
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        print(f"timed bwd stage{stage} shift{shift} {name} {what}: {ms:.4f} ms, plain {pl:.4f} ms, "
              f"library {lb:.4f} ms, bound {max(tb, tf):.4f} ms "
              f"({'bytes' if tb >= tf else 'operations'}) x{n_blocks} blocks")
        r = tot[name]
        for k, v in (("ms", ms), ("plain_ms", pl), ("library_ms", lb), ("bytes_s", tb),
                     ("flops_s", tf), ("bound_ms", max(tb, tf))):
            r[k] += n_blocks * v

    gen = torch.Generator().manual_seed(9)

    def n(*shape, dt=f32):
        return torch.randn(*shape, generator=gen).to(DEV, dt)

    for stage, res, C, heads, ws, shift, n_blocks in GEOMS:
        t = block_inputs(torch, B, res, C, heads, ws, shift, bf, seed=200 + stage)
        M, L, Ch, hd = B * res * res, ws * ws, 4 * C, C // heads
        dp = t["dp"]
        # the two LayerNorm-residual backwards (LN2: bf16 cotangent; LN1: f32)
        for what, g, gamma, col in (("ln2", n(M, C, dt=bf), t["ln2_scale"], 1),
                                    ("ln1", n(M, C), t["ln1_scale"], 0)):
            z = n(M, C)
            zl = z.clone().requires_grad_()
            wl = gamma.float().requires_grad_()
            bl = torch.zeros(C, device=DEV, requires_grad=True)
            yl = F.layer_norm(zl, (C,), wl, bl, 1e-5)
            g32 = g.float()
            nbytes = M * C * (4 + g.element_size() + 4) + C * 2 + B * 8 + 2 * C * 4
            add("ln_residual_bwd", n_blocks,
                lambda: fb.ln_residual_bwd(z, g, gamma, dp, col, 1e-5),
                lambda: fb.ln_residual_bwd_reference(z, g, gamma, dp, col, 1e-5),
                lambda: torch.autograd.grad(yl, (zl, wl, bl), g32, retain_graph=True),
                nbytes, 12 * M * C, PEAK_FLOPS["f32"], f"M{M} C{C} {what}")
        # the four weight grads: (activation, output grad)
        for what, K, N in (("mlp2", Ch, C), ("mlp1", C, Ch), ("proj", C, C), ("qkv", C, 3 * C)):
            a, dy = n(M, K, dt=bf), n(M, N)
            dyb = dy.to(bf)
            add("gemm_wgrad", n_blocks, lambda: fb.gemm_wgrad(a, dy),
                lambda: fb.gemm_wgrad_reference(a, dy), lambda: torch.matmul(a.t(), dyb),
                M * K * 2 + M * N * 4 + (K * N + N) * 4, 2 * M * N * K + M * N,
                PEAK_FLOPS["bf16"], f"{what} M{M} K{K} N{N}")
            queued(torch, tot["gemm_wgrad"], n_blocks, lambda: fb.gemm_wgrad(a, dy),
                   lambda: torch.matmul(a.t(), dyb), f"stage{stage} shift{shift} gemm_wgrad {what}")
            partial_bytes += n_blocks * fb.wgrad_partial_bytes(M, K, N, sms)
        # the four input grads: (what, out grad, weight [K,N], aux, epilogue, out dtype)
        for what, N, K, aux, epi, odt in (
            ("mlp2 gelu'", C, Ch, n(M, Ch, dt=bf), "gelu", f32),
            ("mlp1 +g", Ch, C, n(M, C, dt=bf), "add", f32),
            ("proj", C, C, None, "none", bf),
            ("qkv +h1b", 3 * C, C, n(M, C), "add", bf),
        ):
            dy, w = n(M, N), n(K, N, dt=bf)
            dyb = dy.to(bf)
            nbytes = (M * N * 4 + K * N * 2 + M * K * (4 if odt == f32 else 2)
                      + (0 if aux is None else aux.numel() * aux.element_size()))
            add("gemm_dgrad", n_blocks,
                lambda: fb.gemm_dgrad(dy, w, aux, epi, odt),
                lambda: fb.gemm_dgrad_reference(dy, w, aux, epi, odt),
                lambda: torch.matmul(dyb, w.t()),
                nbytes, 2 * M * N * K, PEAK_FLOPS["bf16"], f"{what} M{M} K{K} N{N}")
            queued(torch, tot["gemm_dgrad"], n_blocks, lambda: fb.gemm_dgrad(dy, w, aux, epi, odt),
                   lambda: torch.matmul(dyb, w.t()),
                   f"stage{stage} shift{shift} gemm_dgrad {what} M{M} K{K} N{N}")
        # attention backward
        qkv = n(B, res, res, 3 * C, dt=bf)
        dout = n(B, res, res, C, dt=bf)
        kw = dict(window_size=ws, num_heads=heads, shift=shift)
        rb, ls, mk = t["rel_bias"], t["logit_scale"], t["mask"]
        nW = (res // ws) ** 2
        win = fb.window_partition(torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv, ws)
        win = win.reshape(-1, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
        bias = rb.float()[None].expand(nW, heads, L, L)
        if mk is not None:
            bias = bias + mk.float()[:, None]
        bias = bias[None].expand(B, nW, heads, L, L).reshape(B * nW, heads, L, L).to(bf).contiguous()
        q, k, v = (win[i].contiguous().requires_grad_() for i in range(3))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)
        do = fb.window_partition(dout, ws).reshape(-1, L, heads, hd).transpose(1, 2).contiguous()
        nbytes = (M * 3 * C * 2 + M * C * 2 + heads * L * L * 2 + (nW * L * L * 2 if shift else 0)
                  + heads * 4 + M * 3 * C * 4 + (heads * L * L + heads) * 4)
        add("swin_window_attn_bwd", n_blocks,
            lambda: fb.window_attention_bwd(qkv, dout, rb, ls, mk, **kw),
            lambda: fb.window_attention_bwd_reference(qkv, dout, rb, ls, mk, **kw),
            lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True),
            nbytes, 10 * L * hd * M * heads, PEAK_FLOPS["bf16"], f"B{B} L{L} heads{heads}")
        queued(torch, tot["swin_window_attn_bwd"], n_blocks,
               lambda: fb.window_attention_bwd(qkv, dout, rb, ls, mk, **kw),
               lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True),
               f"stage{stage} shift{shift} swin_window_attn_bwd")
        _, groups = fb._attn_bwd_groups(fb._attn_bwd_resident(qkv, ws, mk is not None),
                                        heads, nW, B)
        print(f"scratch swin_window_attn_bwd stage{stage} shift{shift} b{B}: "
              f"{fb.attn_bwd_scratch_floats(B, nW, heads, L, groups) * 4} bytes per call "
              f"({groups} image groups; one slot per window of every image: "
              f"{fb.attn_bwd_scratch_floats(B, nW, heads, L, None) * 4})")
    print(f"gemm_wgrad split partials per b{B} step: {partial_bytes} bytes written and read "
          f"({sms} SMs)")
    return tot


def time_window_attention(torch, wa, F, B=8, T=RT_T):
    """The attention-only kernel at the realtime serving path's shapes (B
    samples of T frames, bf16), summed over the 24 blocks, beside its plain
    version, one library call (SDPA on pre-normalised, pre-scaled q^ with
    the float bias as attn_mask, scale 1) and its bound."""
    bf = torch.bfloat16
    r = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bytes_s", "flops_s", "bound_ms")}
    r.update(QUEUED_KEYS)
    for stage, res, C, heads, ws, shift, n_blocks in GEOMS:
        q, k, v, bias, scale = window_attention_inputs(torch, B * T, res, C, heads, ws, shift, bf,
                                                       seed=300 + stage)
        B_, L, nW = q.shape[0], ws * ws, (res // ws) ** 2
        ms = cuda_ms(torch, lambda: wa.fused_window_attention(q, k, v, bias, scale))
        plain = cuda_ms(torch, lambda: wa.fused_window_attention_reference(q, k, v, bias, scale))
        qn = (F.normalize(q.float(), dim=-1) * scale.reshape(1, heads, 1, 1)).to(bf)
        kn = F.normalize(k.float(), dim=-1).to(bf)
        mask = bias.to(bf)[None].expand(B * T, nW, heads, L, L).reshape(B_, heads, L, L)
        sdpa = lambda: F.scaled_dot_product_attention(qn, kn, v, attn_mask=mask, scale=1.0)  # noqa: E731
        lib = cuda_ms(torch, sdpa)
        queued(torch, r, n_blocks, lambda: wa.fused_window_attention(q, k, v, bias, scale), sdpa,
               f"stage{stage} shift{shift} fused_window_attention")
        # q, k, v in, out written, at their dtype; the bias at its size and dtype
        nbytes = 4 * q.numel() * q.element_size() + bias.numel() * bias.element_size() + heads * 4
        flops = 4 * (B_ * L) * L * C
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
        print(f"timed stage{stage} shift{shift} fused_window_attention B_{B_} L{L} heads{heads} "
              f"bias {bias.dtype}: {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
              f"bound {max(tb, tf):.4f} ms ({'bytes' if tb >= tf else 'operations'}) "
              f"x{n_blocks} blocks")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bytes_s", tb),
                         ("flops_s", tf), ("bound_ms", max(tb, tf))):
            r[key] += n_blocks * val
        del q, k, v, bias, qn, kn, mask
    return r


def check_probe(torch, po):
    """Phase 8: the probe kernel against its plain version in its three modes
    at the probe's own shapes; returns the worst max_abs."""
    from cs_vit_tpu_torch.tools.probe_overlap import make_inputs

    a, w, x = make_inputs(DEV)
    worst = 0.0
    for mode in po.MODES:
        acc, vec = po.probe_overlap(a, w, x, mode)
        racc, rvec = po.probe_overlap_reference(a, w, x, mode)
        sync(torch)
        err_a, rel_a = rel_err(acc, racc)
        err_v = (vec - rvec).abs().max().item()
        rel_v = ((vec - rvec).abs() / rvec.abs().clamp_min(1e-30)).max().item()
        ok = rel_a <= PROBE_TOL["acc"] and rel_v <= PROBE_TOL["vec"]
        print(f"check probe {mode}: acc max_abs={err_a:.3e} rel={rel_a:.3e} "
              f"tol={PROBE_TOL['acc']:.0e}; vec max_abs={err_v:.3e} max rel={rel_v:.3e} "
              f"tol={PROBE_TOL['vec']:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"probe_overlap ({mode}) disagrees with its plain version")
        worst = max(worst, err_a, err_v)
    return worst


def probe_entry(torch, po):
    """The probe through its entry point (``python -m
    cs_vit_tpu_torch.tools.probe_overlap``): its three times and launches."""
    from cs_vit_tpu_torch.tools import probe_overlap as tool

    po.reset_launch_counts()
    ms = tool.main() if DEV == "cuda" else tool.run("cpu", iters=1, repeats=1)
    sync(torch)
    launches = po.launch_counts()["probe_overlap"]
    print(f"probe: launches through the entry point {launches}")
    if DEV == "cuda" and launches == 0:
        fail("the probe's entry point launched no probe_overlap kernel")
    return ms, launches


def probe_bound(torch, po, repeats):
    """(bound ms, what bounds it) of one "both" call: the larger of the
    products' FLOPs at the bf16 tensor-core peak, the exp2 count
    at the SFU rate (SFU_PER_CLOCK_PER_SM x SMs x the maximum SM clock that
    nvidia-smi reports), the bytes of a, w, x and the two outputs."""
    from cs_vit_tpu_torch.tools.probe_overlap import V

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True)
    clock_hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mma = po.PRODUCTS * 2 * po.N ** 3 * repeats / PEAK_FLOPS["bf16"] * 1e3
    exp = po.EXP_PASSES * V * 512 * repeats / (SFU_PER_CLOCK_PER_SM * sms * clock_hz) * 1e3
    nbytes = 3 * po.N * po.N * 2 + 2 * V * 512 * 4
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"probe bound: products {mma:.4f} ms at {PEAK_FLOPS['bf16'] / 1e12:.0f} TFLOP/s, exp "
          f"{exp:.4f} ms at {SFU_PER_CLOCK_PER_SM} x {sms} SMs x {clock_hz / 1e6:.0f} MHz, bytes "
          f"{tb:.4f} ms")
    bound = max(mma, exp, tb)
    return bound, "bytes" if bound == tb else "operations"


def serve_latency(torch, s1, s8, request):
    out = {}
    for name, sess in (("b1", s1), ("b8", s8)):
        req = request(sess.batch_size)
        for _ in range(3):
            sess.predict_crops(*req)
        times = []
        for _ in range(20):
            sync(torch)
            t0 = time.perf_counter()
            sess.predict_crops(*req)
            sync(torch)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
        out[name + "_min"] = min(times)
    out["crops_per_s_b8"] = 8e3 / out["b8"]
    return out


def profile_forward(torch, s8, request, latency_ms, tag="profile"):
    """Device time by kernel over one b8 forward (torch.profiler / CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    req = request(8)
    s8.predict_crops(*req)
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s8.predict_crops(*req)
        sync(torch)
        wall = (time.perf_counter() - t0) * 1e3
    busy, kernels, ops = device_profile(torch, prof)
    if busy == 0:
        print(f"{tag}: no device time recorded (not measured)")
        return
    print(f"{tag}: b8 forward wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({sum(r[1] for r in kernels)} kernels; idle share {max(0.0, 1 - busy / wall):.3f}; "
          f"against the unprofiled median {latency_ms:.3f} ms: "
          f"{max(0.0, 1 - busy / latency_ms):.3f})")
    print_profile(tag, kernels, ops)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: chip_smoke.py needs one CUDA card",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from cs_vit_tpu_torch.ops import _build
    from cs_vit_tpu_torch.ops import fused_block as fb
    from cs_vit_tpu_torch.ops import probe_overlap as po
    from cs_vit_tpu_torch.ops import window_attention as wa
    from cs_vit_tpu_torch.tools.probe_overlap import make_inputs

    launches = Launches(fb, wa, po)
    card = nvidia_smi_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("build"):
        secs = _build.build()
        print(f"build: {json.dumps(secs)}")
        for name in secs:
            log = _build.library_path(name).with_name(_build.library_path(name).name + ".log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if "registers" in line or "spill" in line or "Compiling entry" in line:
                        print(f"ptxas {name}: {line.strip()}")
            if name in TC_KERNELS:
                if not log.exists():
                    fail(f"no ptxas report of {name} ({log.name}): its spills are unchecked")
                check_tc_spills(name, log.read_text())

    with phase("check"):
        worst = check_kernels(torch, fb, wa)
        check_bit_identical(torch, fb)
        check_window_attention_refuses_grad(torch, wa)
    with phase("serve"):
        s1, s8, request, counts, forwards = serve(torch, fb)
    with phase("serve_rt"):
        r1, r8, rt_request, rt_counts = serve_realtime(torch, launches)

    with phase("train"):
        model = train_model(torch)
        check_train(torch, fb, model)
        batch = train_batch(torch, 8, seed=10)
        state, step = new_step(torch, model, torch.bfloat16)
        times, train_counts, spatial_peak = train_curve(torch, fb, state, step, batch, TRAIN_STEPS)
        check_nan_skip(torch, state, step, batch)
        depth = sum(model.backbone.config.depths)
        expect = {"FusedSwinBlock": depth, "gemm_dgrad": 4 * depth, "gemm_wgrad": 4 * depth,
                  "ln_residual_bwd": 2 * depth, "window_attention_bwd": depth,
                  "fused_swin_block": depth, "gemm_bias_act": 5 * depth,
                  "ln_residual": 2 * depth, "window_attention": depth}
        print(f"train: launches in one step {json.dumps(train_counts)}")
        for name, per in expect.items():
            if train_counts[name] != per:
                fail(f"{name}: {train_counts[name]} launches in one train step, expected {per}")
        step_ms = statistics.median(times[3:])
        print(f"train_step_ms_b8 {step_ms:.3f} (min {min(times[3:]):.3f}, "
              f"{len(times) - 3} steps after 3 of warm-up)")
        print(f"train_crops_per_s_b8 {8e3 / step_ms:.1f}")
        profile_step(torch, state, step, batch, step_ms)
        del model, state, step, batch

    with phase("temporal"):
        temporal = {name: check_temporal(torch, launches, sup, T)
                    for name, sup, T in ((f"rt{RT_T}", "realtime", RT_T),
                                         (f"full{FULL_T}", "full", FULL_T))}
        for name, (ms, step_counts, peak, saved) in temporal.items():
            print(f"temporal_{name}_step_ms_b8 {ms:.3f}")
            print(f"temporal_{name}: launches per step {json.dumps(step_counts)}; peak device "
                  f"memory of one step {peak / 2**30:.3f} GiB (spatial step: "
                  f"{spatial_peak / 2**30:.3f} GiB); autograd saved {saved / 2**20:.1f} MiB")

    with phase("probe"):
        probe_err = check_probe(torch, po)
        probe_ms, probe_launches = probe_entry(torch, po)

    with phase("timing"):
        tot = time_kernels(torch, fb, F)
        tot.update(time_bwd_kernels(torch, fb, F))
        tot["fused_window_attention"] = time_window_attention(torch, wa, F)
        a, w, x = make_inputs(DEV)
        bound, bound_by = probe_bound(torch, po, 64)
        plain = cuda_ms(torch, lambda: po.probe_overlap_reference(a, w, x, "both", 64),
                        iters=2, warmup=1)
        print(f"timed probe_overlap both: {probe_ms['both']:.4f} ms (entry point), plain "
              f"{plain:.4f} ms, bound {bound:.4f} ms ({bound_by}); mma {probe_ms['mma']:.4f} "
              f"ms, exp {probe_ms['exp']:.4f} ms, serial sum {probe_ms['serial']:.4f} ms, "
              f"perfect overlap {probe_ms['overlap']:.4f} ms")
        lat = serve_latency(torch, s1, s8, request)
        print(f"serve_b1_ms {lat['b1']:.3f} (min {lat['b1_min']:.3f})")
        print(f"serve_b8_ms {lat['b8']:.3f} (min {lat['b8_min']:.3f})")
        print(f"crops_per_s_b8 {lat['crops_per_s_b8']:.1f}")
        profile_forward(torch, s8, request, lat["b8"])
        rt_lat = serve_latency(torch, r1, r8, rt_request)
        print(f"serve_rt{RT_T}_b1_ms {rt_lat['b1']:.3f} (min {rt_lat['b1_min']:.3f})")
        print(f"serve_rt{RT_T}_b8_ms {rt_lat['b8']:.3f} (min {rt_lat['b8_min']:.3f})")
        profile_forward(torch, r8, rt_request, rt_lat["b8"], tag=f"profile_rt{RT_T}")

    # launches: the forward kernels' from the serving run, the backward
    # kernels' from one spatial train step, the attention-only kernel's from
    # the realtime serving run, the probe's from its entry point
    launches_of = {"gemm_bias_act": counts["gemm_bias_act"], "ln_residual": counts["ln_residual"],
                   "swin_window_attn_fwd": counts["window_attention"],
                   "gemm_dgrad": train_counts["gemm_dgrad"],
                   "gemm_wgrad": train_counts["gemm_wgrad"],
                   "ln_residual_bwd": train_counts["ln_residual_bwd"],
                   "swin_window_attn_bwd": train_counts["window_attention_bwd"],
                   "fused_window_attention": rt_counts["fused_window_attention"]}
    source = {"gemm_bias_act": KERNEL_SOURCE, "ln_residual": KERNEL_SOURCE,
              "swin_window_attn_fwd": KERNEL_SOURCE, "fused_window_attention": WA_SOURCE}
    replaces = {"gemm_bias_act": REPLACES, "ln_residual": REPLACES,
                "swin_window_attn_fwd": REPLACES, "fused_window_attention": WA_REPLACES}
    per = {"gemm_bias_act": "b8 forward", "ln_residual": "b8 forward",
           "swin_window_attn_fwd": "b8 forward",
           "fused_window_attention": f"b8 x {RT_T}-frame realtime forward"}
    kernels = []
    for name, r in tot.items():
        print(f"kernel {name}: per {per.get(name, 'b8 train step')} {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, "
              f"library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"(bytes {r['bytes_s']:.4f} ms, operations {r['flops_s']:.4f} ms)")
        kernels.append({
            "name": name, "route": "cuda",
            "source": source.get(name, BWD_KERNEL_SOURCE),
            "replaces": replaces.get(name, BWD_REPLACES),
            "launches": launches_of[name], "max_abs_err": worst[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_s"] >= r["flops_s"] else "operations",
            "library_ms": r["library_ms"],
            **{k: r[k] for k in QUEUED_KEYS if k in r},
        })
    kernels.append({
        "name": "probe_overlap", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES, "launches": probe_launches, "max_abs_err": probe_err,
        "ms": probe_ms["both"], "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the chain
    })
    for k in kernels:
        if k["library_ms"]:
            print(f"factor {k['name']}: kernel / library {k['ms'] / k['library_ms']:.3f}x "
                  f"({k['ms']:.3f} / {k['library_ms']:.3f} ms)")
        if "queued_ms" in k:
            print(f"factor {k['name']} queued: kernel / library "
                  f"{k['queued_ms'] / k['queued_library_ms']:.3f}x ({k['queued_ms']:.3f} / "
                  f"{k['queued_library_ms']:.3f} ms"
                  + (", host gaps included)" if k["queued_host_gapped"] else ")"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
