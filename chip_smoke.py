#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cs_vit_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``:

    python3 chip_smoke.py

It builds the CUDA kernels from ``cs_vit_tpu_torch/ops/csrc/`` and then, in
order, failing (non-zero exit, no result line) at the first phase that fails:

1. prints the card (``nvidia-smi`` name and power limit), turns TF32 off;
2. builds the kernels (all four sources at once) and prints the build time
   and the compiler's register/spill report; fails if a tensor-core kernel
   (the window-attention ``*_tc_kernel``s, forward and backward, the
   three ``wgmma`` GEMMs at each tile width and the overlap probe in each
   mode) spills or is missing from the report, or if ptxas reports any
   library's ``wgmma`` instructions serialized;
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
   epilogue and output dtype, ``ln_residual`` and ``ln_residual_bwd`` at
   LN_EDGE_SHAPES with and without droppath scales, every input and output
   dtype; the bf16 ``gemm_wgrad``, attention backward, ``gemm_bias_act``,
   ``gemm_dgrad`` and ``ln_residual_bwd`` launched twice must give
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
   launch counts of one step (the update's multi-tensor wrappers among
   them, UPDATE_EXPECT) and the step time; the update's kernels
   (``ops.multi_tensor``: ``squares``, ``clip_``, ``adamw_``) at the trained
   leaves and their grads as the backward left them, each against its plain
   version, then timed beside them, the library's per-leaf update and the
   bound of their bytes (``check_update``); a NaN batch that must leave
   the state bit-identical; a profiled step (device idle share; the
   LayerNorm kernels' and ``sum_splits``' launches and device ms, and
   ``FusedSwinBlockBackward``'s device ms);
7. runs the released spenc_addpat configuration (SPENC_CONFIG: encoder-type
   spatial layers, patch decoration, a latent group of two layers) at full
   width: its latent-2x spatial step at b8 (kernel path vs eager path in
   f32 and bf16 with the same droppath and latent draws, SPENC_STEPS bf16
   steps whose loss must fall, the launches of one step equal to the
   flagship step's, the latent group bit-identical afterwards, the encoder
   layers before the last moved by AdamW's decay alone, a profiled step);
   serves those weights through ``PoserSession.from_experiment`` from a
   checkpoint carrying the ``latent_trans.*`` keys, with
   ``num_latent_layer`` null in the config as evaluation writes it (b1 and
   b8: launches, outputs, kernel path vs eager path, latency, a profiled
   forward); and serves one forward of the sparse + patch + orientation
   variant, kernel path vs eager path from calibrated BatchNorm statistics;
8. runs the experiment lifecycle through the port's entry points at the
   flagship width (LIFECYCLE_CONFIG): a synthetic DexYCB tree of 480 x 640
   frames, ``cli.finetune`` for one epoch and again for a second that must
   resume from ``checkpoint_1`` (step count, epochs, symlink),
   ``cli.evaluate`` from the ``checkpoint`` symlink (rows, finite
   predictions, the whole-block kernels' launches per eval batch, one eval
   batch held against the eager path and against the dump), and
   ``cli.benchmark``'s four metrics; it prints which file libraries
   (FILE_LIBS) are missing and, without h5py, feeds the same loops an
   in-memory annotation store (the datasets' ``store=``) and keeps the eval
   rows in memory; it prints the finetune step time, the eval time per
   batch and the eval loop's share of waiting on the loader;
9. runs the rest of the host data pipeline at the flagship width
   (DATASETS_CONFIG): synthetic HO3D (480 x 640) and InterHand2.6M (512 x
   334) trees; prints whether h5py and cv2 import and whether the C crop
   (``cs_vit_tpu_torch.native``) built, failing if it did not;
   ``cli.finetune`` for one epoch over both through ``device_prefetch``
   (step count, the flagship step's launches a step, finite losses, one
   prefetched batch bit for bit against ``batch_to_device``'s with bf16
   patches, its staging pinned); ``cli.evaluate`` on the InterHand2.6M test
   split and the HO3D evaluation split (as in 8); ``predict_images`` on 8
   full HO3D frames at b1 and b8, equal bit for bit to ``predict_crops`` on
   the port's own host crops, with the launches per forward; it prints the
   finetune step and its excess over the bare step, the loader-wait share,
   the eval time per batch, ``predict_images`` beside ``predict_crops``, and
   the host crop of one b8 batch, C against numpy, and the bare train step
   with the loader idle and with it busy; the lifecycle phase (8)
   prints its finetune step beside the loop's earlier reading with pageable
   copies and the numpy crop;
9a. ``parallel``: the flagship bf16 step at b8 with ``remat`` and without,
   from the same weights, batch and droppath generator (loss, grad norm,
   every grad and the generator's state afterwards bit-identical; the
   backward kernels' launches unchanged, the forward kernels' up by one
   served forward's for the recomputation), with both steps' time and peak memory at b8 and at
   the largest batch the step without remat fits; ``cli.finetune`` on the
   lifecycle fixture under a torchrun-style environment with WORLD_SIZE=1
   (an NCCL group, the step's average an NCCL all-reduce), its checkpoint
   bit-identical to the run without a group; two gloo ranks on the one card
   (NCCL refuses two ranks on one device), each on half of a b8 batch for
   DP_STEPS steps, bit-identical to each other and to a one-process
   emulation of the averaged step, each launching the flagship step's
   kernels;
9b. ``pretrain``: ``cli.pretrain_ti`` in each mode (tivit, dino, ti) at the
   CLI's defaults (ViT-B/16 and a DINOv2 of its width, img 224, b64) over
   synthetic 480 x 640 JPEGs, one epoch of PRETRAIN_STEPS steps; each mode's
   step time and peak memory on one batch; tivit's loss falls over
   PRETRAIN_CURVE steps; dino moves only the student's MLPs, keeps the
   teacher at the EMA of the student bit for bit and moves the centre; ti
   moves only the transformation group; two gloo ranks on the one card, a
   ``tivit`` and a ``dino`` step each on half of the b64 batch, held against
   the one-process step on the whole batch (loss, logs, every trained grad,
   the transformation group's statistics, the centre) within four times
   the one-process step's one-ulp spread plus a share, the centre equal on
   both ranks; one f32 TIViT forward on the card against the CPU within a
   floor measured in the run;
9c. ``tp``: two gloo ranks on the one card run the flagship f32 spatial
   step at ``tp`` = 2 (``parallel.tp``, the eager attention path, as JAX's
   tensor parallelism runs XLA) for TP_STEPS steps on a b8 batch, held
   against the one-process eager step (losses, grad norms, every parameter)
   within TP_FLOOR times a floor measured in the run, the replicated
   tensors bit-identical on both ranks; a rank's step time, peak memory and
   all-reduces a step;
9d. ``tools``: ``tools.demo`` on its synthetic frame writes its PNG, and a
   ``utils.trace`` of one served b8 flagship forward holds the whole-block
   kernels and a ``utils.annotate`` span;
10. trains the flagship model in the temporal phase at batch 8, realtime T=3 and full T=5 on
   the attention-only kernel: the f32 backbone tokens and the f32 step
   against the eager path,
   TEMPORAL_STEPS bf16 steps whose loss must fall, every frozen parameter
   and statistic bit-identical afterwards, no saved backbone activations,
   the NaN skip;
11. runs the tensor-core/SFU overlap probe's kernel (``wgmma`` fed by TMA,
   the exps between a ``wgmma``'s commit and its wait) against its plain
   version in its three modes at a of 128, 512 and 1024 rows, then its entry
   point (``tools.probe_overlap``: the three times and the overlap share);
12. times every kernel at its path's shapes (batch 8) beside its plain
   version, one library call and its bound (CUDA events around calls as the
   host issues them, ``cuda_ms``), the two window-attention forward
   kernels, the attention backward, the three GEMMs, the two LayerNorm
   kernels and their library calls also queued behind a sleep kernel
   (``queued_ms``: the card's time, flagged where the host still fell
   behind; the LayerNorm kernels' inputs rotated through copies larger than
   the L2, as the step finds them), the attention backward's
   scratch bytes per call and ``gemm_wgrad``'s split-partial bytes per step,
   and the serve latencies;
13. prints each kernel's kernel / library factor, then ``{"kernels": [...]}``,
    then ``{"ok": true, "device": {...}}`` as the last line.

Each phase prints its wall seconds. It imports nothing of JAX or of
``cs_vit_tpu``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import itertools
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
# ln_residual and ln_residual_bwd (M rows of C) beside the blocks': each
# Swin-B width (the kernels' unmasked builds) at M of 1, 7 and 1000 (none a
# multiple of the plan's rows per block), and the widths of swinv2-tiny and
# of the "test" backbone (the masked builds)
LN_EDGE_SHAPES = (tuple((M, C) for C in (128, 256, 512, 1024) for M in (1, 7, 1000))
                  + tuple((1000, C) for C in (8, 16, 96, 192, 384, 768)))
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
# the train step's update (ops.multi_tensor): the wrappers' calls in one step
# (squares launches two kernels, clip_ and adamw_ one each), and each against
# its plain version at the flagship's leaves within UPDATE_ULPS f32 ulps of
# each leaf's largest element (the f64 sums' order; fma contraction in AdamW)
UPDATE_SOURCE = "cs_vit_tpu_torch/ops/csrc/multi_tensor_adamw.cu"
UPDATE_REPLACES = "none: cs_vit_tpu/train/step.py runs optax's clip and AdamW inside its graph"
UPDATE_EXPECT = {"squares": 1, "clip_": 1, "adamw_": 1}
UPDATE_ULPS = 8
# bytes an element of a trained leaf moves through the update: the norm reads
# g, the clip reads and writes it, AdamW reads p, g, m, v and writes p, m, v
UPDATE_BYTES_PER_ELEMENT = 4 * (1 + 2 + 7)
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
# the released reference configuration, spatial_dexycb_swinb_spenc_addpat_noti
# (SURVEY.md:14), as tools/full_scale_convert_check.py:115-121 writes its
# config.json (with BACKBONE and IMG): encoder-type spatial layers, patch
# decoration, a latent group of two layers, realtime temporal encoders. Its
# spatial phase trains SPENC_STEPS bf16 steps (latent 2x) on one batch, whose
# loss must fall as TRAIN_FALL says.
SPENC_CONFIG = {"exp": "chip_smoke_spenc", "num_joints": 16,
                "num_spatial_layer": 6, "spatial_layer_type": "encoder",
                "num_temporal_layer": 2, "num_latent_layer": 2,
                "persp_decorate": "patch", "temporal_supervision": "realtime",
                "phase": "spatial", "data": "dexycb", "seq_len": 1, "batch_size": 8}
SPENC_STEPS = 30
# the lifecycle phase: the flagship configuration (LIFECYCLE_CONFIG with
# BACKBONE and IMG) fine-tuned through cli.finetune for one epoch, resumed for
# a second, evaluated through cli.evaluate and scored through cli.benchmark,
# over a synthetic DexYCB tree of DexYCB's 480 x 640 frames written into the
# git-ignored LIFECYCLE_DIR: LIFECYCLE_TRAIN sequences x frames give 4 steps
# at b8 an epoch, LIFECYCLE_TEST 4 eval batches at LIFECYCLE_EVAL_BATCH
LIFECYCLE_CONFIG = {"exp": "chip_smoke_lifecycle", "data": ["dexycb"], "dtype": "bfloat16",
                    "batch_size": 8, "lr_scheduler": "warmup", "phase": "spatial",
                    "temporal_supervision": "full"}
LIFECYCLE_DIR = "_chip_smoke"
LIFECYCLE_HW = (480, 640)
LIFECYCLE_TRAIN, LIFECYCLE_TEST, LIFECYCLE_EVAL_BATCH = (2, 16), (4, 16), 16
# the datasets phase: the flagship configuration (DATASETS_CONFIG with BACKBONE
# and IMG) fine-tuned through cli.finetune for one epoch over synthetic HO3D
# and InterHand2.6M trees at the datasets' own frame sizes, written into the
# git-ignored DATASETS_DIR: HO3D 2 sequences x 8 frames and InterHand2.6M two
# hands x 8 frames give 4 steps at b8; evaluated on HO3D's 2 x 16 evaluation
# frames and InterHand2.6M's 2 x 16 test frames, 2 batches of 16 each
DATASETS_CONFIG = {"exp": "chip_smoke_datasets", "data": ["ho3d", "interhand26m"],
                   "dtype": "bfloat16", "batch_size": 8, "lr_scheduler": "warmup",
                   "phase": "spatial", "temporal_supervision": "full"}
DATASETS_DIR = "_chip_smoke_datasets"
DATASETS_HO3D_HW, DATASETS_IH_HW = (480, 640), (512, 334)
DATASETS_HO3D_TRAIN, DATASETS_HO3D_EVAL = (2, 8), (2, 16)
DATASETS_IH_TRAIN, DATASETS_IH_TEST = 8, 16
DATASETS_EVAL_BATCH = 16
# the parallel phase (PARALLEL_DIR, git-ignored): the flagship b8 step with
# and without remat (PARALLEL_TIMED_STEPS timed), the largest batch the plain
# step fits (found within PARALLEL_MAX_TRIES tries, starting at
# PARALLEL_EDGE, the largest batch it fitted on an H100 80GB HBM3, so that
# two tries do on that card), cli.finetune in a
# one-rank NCCL world on the lifecycle fixture, and two gloo ranks on the one
# card, DP_STEPS steps each on half of a b8 batch (DP_SEED + rank seeds a
# rank's droppath), within DP_TIMEOUT seconds
PARALLEL_DIR = "_chip_smoke_parallel"
PARALLEL_TIMED_STEPS, PARALLEL_MAX_TRIES, PARALLEL_EDGE = 5, 12, 560
DP_STEPS, DP_SEED, DP_TIMEOUT = 3, 100, 300
# the pretrain phase (PRETRAIN_DIR, git-ignored): cli.pretrain_ti with
# PRETRAIN_ARGS on top of the CLI's defaults (ViT-B/16 widths, img 224, b64),
# one epoch of PRETRAIN_STEPS steps over PRETRAIN_BATCH x PRETRAIN_STEPS
# synthetic PRETRAIN_HW JPEGs, then PRETRAIN_CURVE tivit steps on one batch
PRETRAIN_DIR = "_chip_smoke_pretrain"
PRETRAIN_HW, PRETRAIN_BATCH, PRETRAIN_STEPS, PRETRAIN_CURVE = (480, 640), 64, 4, 10
PRETRAIN_ARGS = []
# the pretrain phase's two gloo ranks (PRETRAIN_DIR + "_world"): a tivit and a
# dino step each on half of the b64 batch, held against the one-process step
# on the whole batch to four times that step's own spread when the images
# move by one ulp plus this share of each value's largest magnitude
PRETRAIN_WORLD_REL = {"loss": 1e-5, "grad": 1e-3, "stat": 1e-5}
# the tp phase (TP_DIR, git-ignored): two gloo ranks on the one card run the
# flagship f32 step at tp = 2, TP_STEPS steps on the b8 batch with the
# droppath generator reseeded to TP_SEED before each, within TP_TIMEOUT
# seconds; held against the one-process eager step to TP_FLOOR times the
# larger of the kernel step's miss and the eager step's one-ulp spread
TP_DIR = "_chip_smoke_tp"
TP_STEPS, TP_SEED, TP_TIMEOUT, TP_FLOOR = 3, 200, 600, 4
# the tools phase (TOOLS_DIR, git-ignored): the whole-block kernels a trace of
# one served forward must hold, as the profiler names them
TOOLS_DIR = "_chip_smoke_tools"
TRACE_KERNELS = ("gemm_bias_act_wgmma_kernel", "window_attn_tc_kernel", "ln_residual_kernel")
# the f32 TIViT forward, card against CPU: the share of each value's largest
# magnitude the floor adds to four times the CPU's one-ulp spread, about ten
# times the miss measured on an H100 (encode 6.1e-6 of 4.45, total and
# latent 1.8e-4 of 975 beside a spread of 3.1e-4, support 1.5e-8 of 0.0139,
# a hinge of a mean norm near its support, beside a spread of 0)
TIVIT_CARD_REL = {"encode": 1e-5, "total": 1e-6, "latent": 1e-6, "support": 1e-5}
# the file libraries the data and eval paths import where they read or
# write files; without h5py the phase feeds the same loops through their
# dataset= and writer= arguments (the annotations in memory, the frames as
# JPEG files), and the metrics are computed from the rows it kept
FILE_LIBS = ("h5py", "cv2")
# the encoder-type spatial layers before the last get no gradient: AdamW moves
# them by its decay alone, p * (1 - lr * wd) a step, to this relative error
# (f32 rounding, one multiply a step)
DECAY_RTOL = 1e-5
# probe kernel vs plain: bf16 acc to 2e-2 of its scale (eight products, each
# rounded to bf16; a sum in another order flips a rounding by one ulp and
# later products carry it), f32 vec to 1e-5 relative per element (ex2.approx
# on the SFU against exp; 32 passes of exp(v/4 - 1) contract errors)
PROBE_TOL = {"acc": 2e-2, "vec": 1e-5}
# rows of a the probe kernel is checked at: the TPU probe's 512, two row
# blocks (128: fewer blocks than SMs) and twice the TPU's
PROBE_ROWS = (128, 512, 1024)
# queued_ms's sleep kernel ahead of the timed calls (about 20 ms at 1.98 GHz):
# long enough for the host to enqueue them all
SLEEP_CYCLES = 40_000_000
# the two LayerNorm kernels' queued readings rotate each call's inputs through
# copies that together hold at least this many bytes, over twice the H100's
# 50 MB L2: each call then reads its inputs from HBM, as the step's backward
# reads z (written by the forward, many kernels earlier)
L2_ROTATE_BYTES = 128 * 2**20
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


def ln_edge_checks(torch, fb, dname):
    """The two LayerNorm-residual kernels beyond the block geometries, at
    LN_EDGE_SHAPES, with droppath scales and without: ln_residual with res
    in the compute dtype and in f32, the f32 copy kept and not;
    ln_residual_bwd with g in the compute dtype and in f32. Fails if a
    backward launch left its workspace's counters off 0. [(kernel, what,
    max_abs, rel, tol)]"""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
    f32 = torch.float32
    gen = torch.Generator().manual_seed(41)

    def n(*shape):
        return torch.randn(*shape, generator=gen).to(DEV)

    pairs = []
    for M, C in LN_EDGE_SHAPES:
        z = n(M, C) * 3 + 0.5
        gamma, beta = (1 + 0.1 * n(C)).to(dtype), (0.1 * n(C)).to(dtype)
        images = M if M % 8 else 8
        dps = torch.tensor([[[1.0, 1.0], [0.0, 2.0]][b % 2] for b in range(images)], device=DEV)
        for dp in (None, dps):
            where = f"M{M} C{C} dp {'none' if dp is None else images}"
            for rt in dict.fromkeys((dtype, f32)):
                res = n(M, C).to(rt)
                args = (z, res, gamma, beta, dp, 1, 1e-5, dtype)
                y32, ydt = fb.ln_residual_reference(*args)
                for keep in (False, True):
                    kdt, k32 = fb.ln_residual(*args, keep_f32=keep)
                    pairs.append(("ln_residual", f"{where} res {rt} keep {keep}", kdt, ydt))
                    if keep:
                        pairs.append(("ln_residual", f"{where} res {rt} f32 copy", k32, y32))
            for gt in dict.fromkeys((dtype, f32)):
                g = n(M, C).to(gt)
                got = fb.ln_residual_bwd(z, g, gamma, dp, 0, 1e-5)
                want = fb.ln_residual_bwd_reference(z, g, gamma, dp, 0, 1e-5)
                pairs += [("ln_residual_bwd", f"{where} g {gt} {p}", a, b)
                          for p, a, b in zip(("dz", "dgamma", "dbeta"), got, want)]
    sync(torch)
    for key, buf in getattr(fb, "_ln_scratch", {}).items():
        if bool(buf[:fb.LN_CLUSTER].ne(0).any()):
            fail(f"ln_residual_bwd left its counters at {buf[:fb.LN_CLUSTER].tolist()} ({key})")
    return [(name, what, *rel_err(got, want), TOL[dname]["kernel"])
            for name, what, got, want in pairs]


def check_bit_identical(torch, fb, B=8):
    """The bf16 gemm_wgrad, swin_window_attn_bwd, gemm_bias_act, gemm_dgrad
    and ln_residual_bwd launched twice on the same inputs at every block
    geometry (each GEMM at the block's four shapes, ln_residual_bwd with the
    cotangent in bf16 and in f32) give bit-identical outputs: every
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
        z = torch.randn(M, C, generator=gen).to(DEV)
        for gt in (bf, torch.float32):
            g = torch.randn(M, C, generator=gen).to(DEV, gt)
            calls.append((f"ln_residual_bwd g {gt}", lambda z=z, g=g: fb.ln_residual_bwd(
                z, g, t["ln2_scale"], t["dp"], 1, 1e-5)))
        for what, fn in calls:
            first = [x.clone() for x in fn()]
            second = fn()
            sync(torch)
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                fail(f"{what} at stage{stage} shift{shift} b{B} differs between two launches")
            n += 1
    print(f"check: gemm_wgrad, swin_window_attn_bwd, gemm_bias_act, gemm_dgrad and "
          f"ln_residual_bwd bit-identical over two launches ({n} comparisons, bf16 b{B})")
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
        ln = ln_edge_checks(torch, fb, dname)
        n_checks += len(ln)
        by_kernel = {}
        for name, what, err, rel, tol in ln:
            if not rel <= tol:
                print(f"check {dname} {name} {what}: max_abs={err:.3e} rel={rel:.3e} "
                      f"tol={tol:.1e} FAIL")
                fail(f"{name} ({what}) disagrees with its plain version")
            by_kernel[name] = max(by_kernel.get(name, (0.0, tol)), (rel, tol))
            if dname == "bf16":
                worst[name] = max(worst[name], err)
        print(f"check {dname} LN_EDGE_SHAPES ({len(ln)} checks) worst rel/tol: " + ", ".join(
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
    # the probe's three modes: its wgmma accumulators and exp chains in registers
    "probe_overlap": {("probe_overlap_kernel", 0, m) for m in ("mma", "exp", "both")},
}
# ptxas's note that a kernel's wgmma instructions run one after another
WGMMA_SERIAL_RE = re.compile(r"wgmma.*serializ|serializ.*wgmma", re.I)


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
    keep their score blocks in registers, the three wgmma GEMMs and the
    probe, which keep their accumulators there): fail on any spill, and
    unless the report holds every instantiation of TC_KERNELS[lib]."""
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
        elif m := re.search(r"\dprobe_overlap_kernelILb([01])ELb([01])E", name):
            mode = {"10": "mma", "01": "exp", "11": "both"}[m.group(1) + m.group(2)]
            key, what = ("probe_overlap_kernel", 0, mode), f"probe_overlap_kernel<{mode}>"
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


def ln_residual_bytes(M, C, res_size, keep):
    """Bytes ln_residual must move (bf16 out): z f32 and res read, y in bf16
    (and in f32 if `keep`) written, gamma and beta in bf16 read."""
    return M * C * (4 + res_size + 2 + (4 if keep else 0)) + 2 * C * 2


def ln_residual_bwd_bytes(M, C, g_size, B):
    """Bytes ln_residual_bwd must move: z f32 and g read, dz f32 written,
    gamma bf16 and dp [B,2] f32 read, dgamma and dbeta f32 written."""
    return M * C * (4 + g_size + 4) + C * 2 + B * 8 + 2 * C * 4


def l2_cold(make, nbytes):
    """A call that runs make(0)(), make(1)(), ... in turn: make(i) returns a
    call on the i-th copy of the inputs (nbytes each), and there are enough
    copies to hold L2_ROTATE_BYTES, so that no call finds its inputs in L2."""
    it = itertools.cycle([make(i) for i in range(max(2, -(-L2_ROTATE_BYTES // nbytes)))])
    return lambda: next(it)()


def copies(tensors, i):
    """The tensors themselves (i == 0) or fresh copies of them."""
    return tensors if i == 0 else tuple(t.clone() for t in tensors)


def queued_ln_residual(torch, fb, F, r, geom, B, seed):
    """Adds the queued readings of one block's two ln_residual calls (LN1:
    res in the compute dtype, the f32 copy kept; LN2: res f32) and of their
    library call, ``res + F.layer_norm``, at geometry `geom` and batch B
    (bf16, no droppath: as served) to r (QUEUED_KEYS), inputs L2-cold."""
    stage, res, C, _, _, shift, n_blocks = geom
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    M = B * res * res
    z = torch.randn(M, C, generator=gen).to(DEV)
    gamma = (1 + 0.1 * torch.randn(C, generator=gen)).to(DEV, bf)
    beta = (0.1 * torch.randn(C, generator=gen)).to(DEV, bf)
    for what, rt, keep in (("ln1", bf, True), ("ln2", torch.float32, False)):
        res_t = torch.randn(M, C, generator=gen).to(DEV, rt)
        nbytes = M * C * (4 + res_t.element_size())

        def kern(i, keep=keep, res_t=res_t):
            zc, rc = copies((z, res_t), i)
            return lambda: fb.ln_residual(zc, rc, gamma, beta, None, 0, 1e-5, bf, keep)

        def lib(i, res_t=res_t):
            zc, rc = copies((z, res_t), i)
            g32, b32 = gamma.float(), beta.float()
            return lambda: rc + F.layer_norm(zc, (C,), g32, b32, 1e-5)

        queued(torch, r, n_blocks, l2_cold(kern, nbytes), l2_cold(lib, nbytes),
               f"stage{stage} shift{shift} ln_residual M{M} C{C} {what} (L2-cold)")


def queued_ln_residual_bwd(torch, fb, F, r, geom, B, seed):
    """Adds the queued readings of one block's two ln_residual_bwd calls (LN2:
    the cotangent in bf16; LN1: f32) and of their library call, autograd of
    ``F.layer_norm``, at geometry `geom` and batch B (a bf16 step's, with
    droppath) to r (QUEUED_KEYS), inputs L2-cold."""
    stage, res, C, heads, ws, shift, n_blocks = geom
    bf, f32 = torch.bfloat16, torch.float32
    t = block_inputs(torch, B, res, C, heads, ws, shift, bf, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    M = B * res * res
    for what, gt, gamma, col in (("ln2", bf, t["ln2_scale"], 1), ("ln1", f32, t["ln1_scale"], 0)):
        z = torch.randn(M, C, generator=gen).to(DEV)
        g = torch.randn(M, C, generator=gen).to(DEV, gt)
        nbytes = M * C * (4 + g.element_size())

        def kern(i, z=z, g=g, gamma=gamma, col=col):
            zc, gc = copies((z, g), i)
            return lambda: fb.ln_residual_bwd(zc, gc, gamma, t["dp"], col, 1e-5)

        def lib(i, z=z, g=g, gamma=gamma):
            zc, gc = copies((z, g), i)
            zl = zc.detach().requires_grad_()
            wl = gamma.float().requires_grad_()
            bl = torch.zeros(C, device=DEV, requires_grad=True)
            yl, g32 = F.layer_norm(zl, (C,), wl, bl, 1e-5), gc.float()
            return lambda: torch.autograd.grad(yl, (zl, wl, bl), g32, retain_graph=True)

        queued(torch, r, n_blocks, l2_cold(kern, nbytes), l2_cold(lib, nbytes),
               f"stage{stage} shift{shift} ln_residual_bwd M{M} C{C} {what} (L2-cold)")


def time_kernels(torch, fb, F, B=8):
    """Phase 10: per-forward totals at batch B, bf16, summed over the 24 blocks;
    gemm_bias_act, swin_window_attn_fwd and ln_residual and their library
    calls also queued (queued_ms; ln_residual's inputs L2-cold)."""
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

    for k in ("gemm_bias_act", "swin_window_attn_fwd", "ln_residual"):
        tot[k].update(QUEUED_KEYS)
    for geom in GEOMS:
        stage, res, C, heads, ws, shift, n_blocks = geom
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
            nbytes = ln_residual_bytes(M, C, res_t.element_size(), keep)
            add("ln_residual", n_blocks, ms, plain, lib, nbytes, 8 * M * C, PEAK_FLOPS["f32"],
                f"M{M} C{C} res-{res_t.dtype}")
        queued_ln_residual(torch, fb, F, tot["ln_residual"], geom, B, seed=500 + stage)
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


def crop_requests(rng):
    """A function N -> one T=1 request of N crops (predict_crops' arguments),
    drawn from `rng`."""
    import numpy as np

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

    return request


def serve_expect(depth):
    """Launches of each forward kernel in one T=1 forward on the whole-block
    path, by counter name."""
    return {"fused_swin_block": depth, "window_attention": depth,
            "gemm_bias_act": 4 * depth, "ln_residual": 2 * depth}


def check_serve_launches(tag, counts, forwards, depth):
    for name, per in serve_expect(depth).items():
        if counts[name] != per * forwards:
            fail(f"{tag}: {name}: {counts[name]} launches for {forwards} forwards, "
                 f"expected {per} per forward")


def train_expect(depth):
    """Launches of each kernel in one spatial train step on the whole-block
    path (the backbone at B)."""
    return {"FusedSwinBlock": depth, "gemm_dgrad": 4 * depth, "gemm_wgrad": 4 * depth,
            "ln_residual_bwd": 2 * depth, "window_attention_bwd": depth,
            "fused_swin_block": depth, "gemm_bias_act": 5 * depth,
            "ln_residual": 2 * depth, "window_attention": depth}


def serve(torch, fb):
    """Phase 4: the flagship model through PoserSession, b1 and b8."""
    import numpy as np

    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.serving import PoserSession

    cfg = FinetuneConfig(exp="chip_smoke", backbone=BACKBONE, img_size=IMG,
                         phase="inference", attention_impl="auto")
    request = crop_requests(np.random.default_rng(0))

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
    check_serve_launches("serve", counts, forwards, sum(s8.model.backbone.config.depths))
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


def compare_paths(torch, tag, sessions, impl, req, bf16_tokens, bf16_witness=False):
    """The served model on the backbone path `impl` against the eager path,
    on the card, same weights and inputs: f32 backbone tokens within
    SERVE_TOKEN_TOL (bf16 tokens too when `bf16_tokens`; the bf16 flows of
    the eager path and of an attention-only kernel path differ by design, so
    those are printed only), joint_cam within twice each dtype's noise
    floor plus SERVE_MM_SLACK (see there). `sessions` maps "bf16" and "f32"
    to sessions of one config; each is left on `impl`. Returns the floors
    (mm) by dtype.

    `bf16_witness`, for trained-like weights (the spenc phase serves the
    weights its steps trained): the heads no longer amplify, and the bf16
    eager path, promoted to f32 after its first block, sits far closer to
    the f32 eager path than the bf16 kernel path's own rounding allows (on
    an H100: 0.197 mm against 1.764 mm of a 437.6 mm joint_cam, 0.4%, a
    bf16 ulp). The bf16 floor is then at least what the f32 one is made
    of: the largest joint_cam shift of the bf16 eager session when its
    tokens carry the bf16 kernel path's own token difference with its
    entries permuted, rounded to bf16 so that its heads run in bf16 as on
    the kernel path (WITNESSES draws)."""
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

    def head_mm(t, sess=eager32, dname="f32"):
        backbone, sess.model.backbone = sess.model.backbone, FixedTokens(t)
        try:
            return float(np.abs(sess.predict_crops(*req)["joint_cam"]
                                - jc[dname, "eager"]).max())
        finally:
            sess.model.backbone = backbone

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
    floor_how = "|eager bf16 - eager f32|"
    if bf16_witness:
        base = tokens["bf16", "eager"].float()
        delta = (tokens["bf16", impl].float() - base).flatten()
        shifts = [head_mm((base + delta[torch.randperm(delta.numel(), generator=gen).to(DEV)]
                           .reshape(base.shape)).to(torch.bfloat16), sessions["bf16"], "bf16")
                  for _ in range(WITNESSES)]
        print(f"{tag}: bf16 head on bf16 eager tokens + permuted kernel-path token difference, "
              f"rounded to bf16: joint_cam moves {', '.join(f'{v:.4f}' for v in shifts)} mm")
        floor_how += f" {floor['bf16']:.4f} mm or the largest bf16 witness"
        floor["bf16"] = max(floor["bf16"], max(shifts))
    print(f"{tag}: joint_cam noise floor f32 {floor['f32']:.4f} mm, bf16 ({floor_how}) "
          f"{floor['bf16']:.4f} mm; max|joint_cam| = "
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
    return floor


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


def train_model(torch, seed=0, remat=False):
    """The flagship Poser with seeded random f32 weights on the card, in the
    spatial phase's configuration (kernel path); `remat` recomputes each
    backbone block in the backward."""
    from cs_vit_tpu_torch.cli.common import build_model
    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.models import init_poser_weights

    cfg = FinetuneConfig(exp="chip_smoke", backbone=BACKBONE, img_size=IMG, phase="spatial",
                         attention_impl="fused", remat=remat)
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
    check_step(torch, model, B)


def check_update(torch, mt, state):
    """The train step's update kernels (``ops.multi_tensor``) at a trained
    flagship state's leaves: its grads as the backward left them (the block
    kernels' weight grads stored transposed, the conv's channels-last),
    tripled so that the clip scales. ``squares``, ``clip_`` and ``adamw_``
    each against its plain version (``*_reference``) on the card within
    UPDATE_ULPS f32 ulps of each leaf's largest element; then the three as
    the step issues them, timed with CUDA events beside their plain
    versions, the library's per-leaf update (the parent's clip: the f32 norm
    per leaf, the host's branch, the scaling per leaf; ``torch.optim.AdamW``'s
    foreach step) and the bound of the bytes they move. Every timed call's
    clip scales: its limit halves each call. Returns the kernels line's
    row."""
    from cs_vit_tpu_torch.train.optim import global_norm

    opt = state.optimizer
    group = opt.param_groups[0]
    params = [p for p in opt.params() if p.grad is not None]
    kw = dict(lr=group["lr"], beta1=group["betas"][0], beta2=group["betas"][1],
              eps=group["eps"], weight_decay=group["weight_decay"], step=opt.updates_taken() + 1)
    ulp = torch.finfo(torch.float32).eps

    def copies(ts):
        return [t.detach().clone() for t in ts]  # a clone keeps a dense layout

    def for_adamw(gs):  # as PhaseAdamW hands them to adamw_
        return [g if g.is_contiguous() or mt.transposed(g) else g.contiguous() for g in gs]

    worst = 0.0

    def held(what, got, want):
        nonlocal worst
        for i, (a, b) in enumerate(zip(got, want)):
            if not b.numel():
                continue
            top = float(b.abs().max())
            gap = float((a - b).abs().max())
            worst = max(worst, gap)
            if not gap <= UPDATE_ULPS * ulp * top:
                fail(f"update: {what} of leaf {i} {tuple(b.shape)} off its plain version by "
                     f"{gap:.3e} (> {UPDATE_ULPS} ulps of {top:.3e})")

    grads = [g.mul_(3.0) for g in copies([p.grad for p in params])]
    layouts = {"contiguous": sum(g.is_contiguous() for g in grads),
               "transposed": sum(mt.transposed(g) for g in grads)}
    layouts["other dense"] = len(grads) - layouts["contiguous"] - layouts["transposed"]
    mt.reset_launch_counts()
    sq = mt.squares(grads, [])
    held("squares", sq.unbind(), mt.squares_reference(grads, []).unbind())
    norm = sq[2]
    kernel_g, plain_g = copies(grads), copies(grads)
    mt.clip_(kernel_g, norm, opt.max_grad_norm)
    mt.clip_reference_(plain_g, norm, opt.max_grad_norm)
    held("clip_", kernel_g, plain_g)
    moments = [[opt.state[p][k] for p in params] for k in ("exp_avg", "exp_avg_sq")]
    kernel = [copies(params), *map(copies, moments)]
    plain = [copies(params), *map(copies, moments)]
    mt.adamw_(kernel[0], for_adamw(kernel_g), kernel[1], kernel[2], **kw)
    mt.adamw_reference_(plain[0], kernel_g, plain[1], plain[2], **kw)
    for what, got, want in zip(("adamw_ p", "adamw_ exp_avg", "adamw_ exp_avg_sq"), kernel, plain):
        held(what, got, want)
    sync(torch)
    counts = mt.launch_counts()
    if DEV == "cuda" and counts != {"squares": 1, "clip_": 1, "adamw_": 1}:
        fail(f"update: the wrappers launched {counts}")
    elements = sum(p.numel() for p in params)
    print(f"update: {len(params)} leaves, {elements / 1e6:.2f} M elements, grads {layouts}, "
          f"norm {float(norm):.4f} (clip at {opt.max_grad_norm}); squares, clip_ and adamw_ "
          f"against their plain versions: worst |diff| {worst:.3e} (tol {UPDATE_ULPS} ulps of "
          f"each leaf's largest element)")

    def halving():
        """Each call's clip limit: half the last, which the norm now is."""
        limit = [opt.max_grad_norm]

        def next_limit():
            limit[0] *= 0.5
            return limit[0]
        return next_limit

    kernel_limit, plain_limit, library_limit = halving(), halving(), halving()

    def kernels():
        sq = mt.squares(kernel_g, [])
        mt.clip_(kernel_g, sq[2], kernel_limit())
        mt.adamw_(kernel[0], for_adamw(kernel_g), kernel[1], kernel[2], **kw)

    def plains():
        sq = mt.squares_reference(plain_g, [])
        mt.clip_reference_(plain_g, sq[2], plain_limit())
        mt.adamw_reference_(plain[0], plain_g, plain[1], plain[2], **kw)

    lib_params = [torch.nn.Parameter(p) for p in copies(params)]
    library = torch.optim.AdamW(lib_params, foreach=True, lr=kw["lr"],
                                betas=(kw["beta1"], kw["beta2"]), eps=kw["eps"],
                                weight_decay=kw["weight_decay"])
    for p, g, m, v in zip(lib_params, copies(grads), *map(copies, moments)):
        p.grad = g
        library.state[p] = {"step": torch.tensor(float(kw["step"] - 1)), "exp_avg": m,
                            "exp_avg_sq": v}

    def per_leaf():
        gs = [p.grad for p in lib_params]
        n = global_norm(gs)
        limit = library_limit()
        if not bool(n < limit):
            for g in gs:
                g.copy_(g / n * limit)
        library.step()

    ms = cuda_ms(torch, kernels)
    plain_ms = cuda_ms(torch, plains, iters=3, warmup=1)
    library_ms = cuda_ms(torch, per_leaf, iters=5, warmup=2)
    bound_ms = elements * UPDATE_BYTES_PER_ELEMENT / HBM_BYTES_PER_S * 1e3
    print(f"update: the three kernels {ms:.3f} ms a step, plain {plain_ms:.3f} ms, library "
          f"(per-leaf clip + foreach AdamW) {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({elements * UPDATE_BYTES_PER_ELEMENT / 1e9:.3f} GB)")
    return {"name": "multi_tensor_update", "route": "cuda", "source": UPDATE_SOURCE,
            "replaces": UPDATE_REPLACES, "launches": 2 * counts["squares"] + counts["clip_"]
            + counts["adamw_"], "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}


def latent_generator(torch, seed):
    """The latent group's generator, on the card (None off a latent path)."""
    return torch.Generator(device=DEV).manual_seed(seed)


def check_step(torch, model, B, tag="train", latent=False):
    """The whole spatial step, f32 and bf16: kernel path vs eager path from
    the same weights, batch, droppath draws and (`latent`) latent draws;
    the f32 step within TRAIN_F32_TOL, the bf16 step within twice the eager
    bf16 path's distance from the f32 eager step plus TRAIN_BF16_SLACK."""
    batch = train_batch(torch, B, seed=4)
    res = {}
    for impl in ("fused", "eager"):
        for dname, cdt in (("f32", None), ("bf16", torch.bfloat16)):
            m = with_impl(model, impl)
            state, step = new_step(torch, m, cdt)
            state, met = step(state, batch, torch.Generator(device=DEV).manual_seed(5),
                              latent_generator(torch, 9) if latent else None)
            res[impl, dname] = (float(met["loss"]), float(met["grad_norm"]))
            if state.step != 1 or not all(math.isfinite(v) for v in res[impl, dname]):
                fail(f"{tag}: {impl} {dname} step: step {state.step}, loss/grad_norm "
                     f"{res[impl, dname]}")
            print(f"{tag}: {impl} {dname} step: loss {res[impl, dname][0]:.6f} "
                  f"grad_norm {res[impl, dname][1]:.6f}")
            del m, state, step
    for i, what in enumerate(("loss", "grad_norm")):
        truth = res["eager", "f32"][i]
        err = abs(res["fused", "f32"][i] - truth)
        ok = err <= TRAIN_F32_TOL * abs(truth)
        print(f"{tag}: f32 {what} kernel path vs eager path: |diff| {err:.6f} "
              f"(rel {err / abs(truth):.3e}, tol {TRAIN_F32_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{tag}: f32 step {what} of the kernel path disagrees with the eager path")
        floor = abs(res["eager", "bf16"][i] - truth)
        err = abs(res["fused", "bf16"][i] - truth)
        tol = 2 * floor + TRAIN_BF16_SLACK * abs(truth)
        ok = err <= tol
        print(f"{tag}: bf16 {what}: kernel path's distance from the f32 eager step {err:.6f}, "
              f"eager bf16 path's {floor:.6f}, tol {tol:.6f} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{tag}: bf16 step {what} of the kernel path is further from the f32 step "
                 "than the eager bf16 path allows")


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


def train_curve(torch, fb, state, step, batch, n, tag="train", latent=False):
    """n bf16 steps on one fixed batch, with the same droppath draws (and,
    `latent`, the same latent draws) in every step (one fixed objective);
    the loss must fall. Returns the step times
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
        lgen = latent_generator(torch, 9) if latent else None
        t0 = time.perf_counter()
        state, met = step(state, batch, gen, lgen)
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


def spenc(torch, fb):
    """Phase 7: the released spenc_addpat configuration (SPENC_CONFIG) at full
    width, seeded random weights, on the "auto" path: (a) the latent-2x
    spatial step at b8 (kernel path vs eager path, SPENC_STEPS bf16 steps
    whose loss must fall, the launches of one step against the flagship
    step's, the latent group bit-identical, the encoder layers before the
    last moved by AdamW's decay alone, a profiled step); (b) serving the
    trained weights through PoserSession.from_experiment from a checkpoint
    that carries the latent group's keys, with num_latent_layer null in the
    config as evaluation writes it (b1 and b8, bf16 and f32, kernel path vs
    eager path, launches, latency, a profiled forward); (c) one served
    forward of the sparse + patch + orientation variant, kernel path vs
    eager path from calibrated BatchNorm statistics."""
    import os.path as osp
    import tempfile

    import numpy as np

    from cs_vit_tpu_torch.cli.common import build_model
    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.models import init_poser_weights
    from cs_vit_tpu_torch.ops import multi_tensor as mt
    from cs_vit_tpu_torch.serving import PoserSession

    layout = dict(SPENC_CONFIG, backbone=BACKBONE, img_size=IMG)
    cfg = FinetuneConfig(**layout)
    model = build_model(cfg)
    init_poser_weights(model, 11)
    model = model.to(DEV)
    depth = sum(model.backbone.config.depths)
    check_step(torch, model, 8, "spenc", latent=True)

    # (a) the latent-2x spatial step
    batch = train_batch(torch, 8, seed=12)
    latent0 = {k: v.clone() for k, v in model.state_dict().items()
               if k.startswith("latent_trans.")}
    early = tuple(f"spatial_encoder.layers.{i}." for i in range(cfg.num_spatial_layer - 1))
    early0 = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith(early)}
    state, step = new_step(torch, model, torch.bfloat16)
    print(f"spenc: AdamW lr {TRAIN_LR} (constant), {SPENC_STEPS} bf16 steps on one batch of 8, "
          f"the latent group doubling the rows after the backbone")
    times, counts, _ = train_curve(torch, Launches(fb, mt), state, step, batch, SPENC_STEPS,
                                   "spenc", latent=True)
    print(f"spenc: launches in one step {json.dumps(counts)}")
    if DEV == "cuda":
        for name, per in dict(train_expect(depth), **UPDATE_EXPECT).items():
            if counts[name] != per:
                fail(f"spenc: {name}: {counts[name]} launches in one step, expected {per} "
                     "(the flagship step's: the backbone runs once, at B)")
    changed = [k for k, v in model.state_dict().items()
               if k in latent0 and not torch.equal(v, latent0[k])]
    print(f"spenc: {len(latent0)} latent_trans parameters and statistics bit-identical after "
          f"{state.step} steps: {not changed}")
    if changed or not latent0:
        fail(f"spenc: the latent group changed: {changed[:5]}")
    decay = (1 - TRAIN_LR * state.optimizer.param_groups[0]["weight_decay"]) ** state.step
    worst, still = 0.0, []
    for n, p0 in early0.items():
        p = dict(model.named_parameters())[n].detach()
        worst = max(worst, rel_err(p, p0 * decay)[1])
        if torch.equal(p, p0) and bool(p0.any()):
            still.append(n)
    print(f"spenc: {len(early0)} parameters of encoder layers 0..{cfg.num_spatial_layer - 2} "
          f"against p0 * {decay:.8f} (decay alone over {state.step} steps): worst rel "
          f"{worst:.3e}, tol {DECAY_RTOL:.0e}; unmoved: {len(still)}")
    if not early0 or worst > DECAY_RTOL or still:
        fail("spenc: the encoder layers without gradient moved otherwise than by decay")
    step_ms = statistics.median(times[3:])
    print(f"train_spenc_step_ms_b8 {step_ms:.3f} (min {min(times[3:]):.3f}, "
          f"{len(times) - 3} steps after 3 of warm-up)")
    profile_step(torch, state, step, batch, step_ms, tag="profile spenc step", latent=True)
    del state, step, batch

    # (b) serving the trained weights from an experiment directory
    request = crop_requests(np.random.default_rng(3))
    with tempfile.TemporaryDirectory() as exp:
        with open(osp.join(exp, "config.json"), "w") as f:
            json.dump(dict(layout, num_latent_layer=None), f)
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        torch.save({"epoch": 0, "model": sd, "merged": sd}, osp.join(exp, "checkpoint.pt"))
        n_latent = sum(k.startswith("latent_trans.") for k in sd)
        print(f"spenc: checkpoint of {len(sd)} tensors, {n_latent} of them latent_trans.*")
        s8 = PoserSession.from_experiment(exp, batch_size=8, dtype="bfloat16", device=DEV)
        s1 = PoserSession.from_experiment(exp, batch_size=1, dtype="bfloat16", device=DEV)
        f32 = PoserSession.from_experiment(exp, batch_size=8, dtype="float32", device=DEV)
    served = f32.model.state_dict()
    differ = [k for k, v in sd.items() if not k.startswith("latent_trans.")
              and not torch.equal(served[k].cpu(), v)]
    if f32.model.latent_trans is not None or differ:
        fail(f"spenc: the served model is not the trained one without its latent group: "
             f"{differ[:5]}")
    del model, sd
    for sess in (s8, s1):
        sess.warmup()
    sync(torch)
    requests = [(s8, request(8)), (s8, request(11)), (s1, request(3))]
    forwards = sum(math.ceil(r[0].shape[0] / s.batch_size) for s, r in requests)
    fb.reset_launch_counts()
    outs = [s.predict_crops(*r) for s, r in requests]
    sync(torch)
    served_counts = fb.launch_counts()
    print(f"serve_spenc: {forwards} forwards, launches {json.dumps(served_counts)}")
    if DEV == "cuda":
        check_serve_launches("serve_spenc", served_counts, forwards, depth)
    for (s, r), out in zip(requests, outs):
        N = r[0].shape[0]
        for key, tail in (("joint_cam", (21, 3)), ("verts_cam", (778, 3))):
            if out[key].shape != (N, 1) + tail or not np.isfinite(out[key]).all():
                fail(f"serve_spenc: {key} has shape {out[key].shape} or non-finite values")
    print("serve_spenc: joint_cam finite, shapes [N,1,21,3] for N = 8, 11 (padded), 3 (b1)")
    compare_paths(torch, "serve_spenc", {"bf16": s8, "f32": f32}, "fused", request(8),
                  bf16_tokens=True, bf16_witness=True)
    del f32
    lat = serve_latency(torch, s1, s8, request)
    print(f"serve_spenc_b1_ms {lat['b1']:.3f} (min {lat['b1_min']:.3f})")
    print(f"serve_spenc_b8_ms {lat['b8']:.3f} (min {lat['b8_min']:.3f})")
    if DEV == "cuda":
        profile_forward(torch, s8, request, lat["b8"], tag="profile_spenc")
    del s1, s8

    # (c) the sparse + patch + orientation variant, one forward per path
    variant = FinetuneConfig(exp="chip_smoke_sparse", backbone=BACKBONE, img_size=IMG,
                             phase="inference", persp_embed_method="sparse",
                             persp_decorate="patch", global_positioning="orientation")
    sessions = {"bf16": PoserSession(variant, batch_size=8, dtype="bfloat16", device=DEV),
                "f32": PoserSession(variant, batch_size=8, dtype="float32", device=DEV)}
    # from calibrated BatchNorm statistics (see CALIBRATION_FORWARDS), the
    # same in both sessions
    calibrate_statistics(torch, sessions["f32"].model, train_batch(torch, 8, seed=31))
    sessions["bf16"].model.load_state_dict(
        {k: v for k, v in sessions["f32"].model.state_dict().items()
         if k.endswith(("running_mean", "running_var"))}, strict=False)
    compare_paths(torch, "serve_sparse", sessions, "fused", request(8), bf16_tokens=True,
                  bf16_witness=True)


class _Tee:
    """A stdout that prints and keeps a copy (the entry points report their
    step and batch times in their log lines)."""

    def __init__(self, real):
        self.real, self.lines = real, []

    def write(self, text):
        self.lines.append(text)
        return self.real.write(text)

    def flush(self):
        self.real.flush()

    def text(self):
        return "".join(self.lines)


def printed(fn, *args, **kwargs):
    """(fn's result, what it printed), printing it as well."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = fn(*args, **kwargs)
    return result, tee.text()


def memory_store(sequences, split, group="{}"):
    """The annotations of `split`'s sequences as an in-memory store that a
    dataset reads in place of its HDF5 file (its ``store=``), each
    sequence's arrays under ``group.format(name)``; for a machine without
    h5py."""
    from cs_vit_tpu_torch.data.fixtures import MemoryStore

    return MemoryStore.of((group.format(name), arrays) for s, name, arrays in sequences
                          if s == split)


class EvalRows:
    """``EvalH5Writer``'s append and close, keeping the rows in memory."""

    NAMES = ("img_paths", "joint_cam_gt", "joint_cam_pred", "joint_reproj_gt",
             "joint_reproj_pred")

    def __init__(self):
        self.parts = {k: [] for k in self.NAMES}

    def append(self, *columns):
        for name, col in zip(self.NAMES, columns):
            self.parts[name].append(list(col) if name == "img_paths" else col.astype("float32"))

    def close(self):
        pass

    def rows(self):
        import numpy as np

        return {k: sum(v, []) if k == "img_paths" else np.concatenate(v)
                for k, v in self.parts.items()}


def run_finetune(torch, tag, cfg, ckpt_root, epoch, steps, dataset):
    """cli.finetune for epoch `epoch` of `cfg` (resuming after epoch - 1):
    the epochs it trained, its step count and the ``checkpoint`` symlink
    checked; returns (its log, its ms a step from the log lines, its share
    of the epoch's wall spent waiting on the loader)."""
    import os
    import os.path as osp

    from cs_vit_tpu_torch.cli import finetune

    exp_dir = osp.realpath(osp.join(ckpt_root, cfg.exp))
    state, log = printed(finetune.main, cfg, ckpt_root, log_every=1, device=DEV,
                         dataset=dataset)
    link = os.readlink(osp.join(exp_dir, "checkpoint"))
    epochs = re.findall(r"training for epoch (\d+)/", log)
    print(f"{tag}: finetune run {epoch}: epochs trained {epochs}, step {state.step}, "
          f"AdamW updates {state.optimizer.updates_taken()}, checkpoint -> {link}")
    if epochs != [str(epoch)] or state.step != epoch * steps or link != f"checkpoint_{epoch}":
        fail(f"{tag}: finetune run {epoch} trained epochs {epochs} to step {state.step} "
             f"and left the symlink at {link}")
    if epoch > 1 and f"resuming from {osp.join(exp_dir, f'checkpoint_{epoch - 1}')}" not in log:
        fail(f"{tag}: finetune run {epoch} did not resume from checkpoint_{epoch - 1}")
    step_ms = [float(ms) for ms in re.findall(rf"E{epoch} it \d+/\d+ \| (\d+) ms/it", log)]
    wait = re.search(r"samples/s, (\S+) of the wall waiting on the loader", log)
    if len(step_ms) != steps or wait is None:
        fail(f"{tag}: {len(step_ms)} step lines in epoch {epoch}, expected {steps}")
    logged = [float(v) for v in re.findall(r"=(\S+?)(?: \||$)", log, re.M)]
    if not logged or not all(math.isfinite(v) for v in logged):
        fail(f"{tag}: non-finite or missing losses in the step lines")
    del state
    return log, step_ms, float(wait.group(1))


def run_eval(torch, launches, tag, ecfg, ckpt_root, dataset, n_batches, h5_path, cfg_of):
    """cli.evaluate of `ecfg` from its eval checkpoint: rows, finite values,
    the whole-block kernels' launches per batch; its first batch held against
    the eager path by ``compare_paths``'s floors and the dump against the
    f32 session's kernel path. Without `h5_path` the rows stay in memory.
    Returns (the dump, its ms a batch, its loader-wait share)."""
    import os.path as osp

    import numpy as np

    from cs_vit_tpu_torch.cli import evaluate
    from cs_vit_tpu_torch.cli.common import build_datasets, poser_config_from
    from cs_vit_tpu_torch.data import collate
    from cs_vit_tpu_torch.serving import PoserSession

    B = ecfg.batch_size
    rows = None if h5_path else EvalRows()
    sync(torch)
    launches.reset_launch_counts()
    _, log = printed(evaluate.main, ecfg, ckpt_root, h5_path=h5_path, device=DEV,
                     dataset=dataset, writer=rows)
    sync(torch)
    counts = launches.launch_counts()
    print(f"{tag}: eval launches over {n_batches} batches {json.dumps(counts)}")
    if DEV == "cuda":
        check_serve_launches(f"{tag} eval", counts, n_batches,
                             sum(poser_config_from(ecfg).swin_config().depths))
    timing = re.search(r"eval: (\d+) batches of \d+ in \S+ s, (\S+) ms a batch, (\S+) of the "
                       r"wall waiting on the loader", log)
    if (timing is None or int(timing.group(1)) != n_batches
            or "loaded eval ckpt (0 unmatched leaves)" not in log):
        fail(f"{tag}: evaluate did not load the whole checkpoint or ran other batches")
    if rows is None:
        import h5py

        with h5py.File(h5_path, "r") as f:
            dump = {k: f[k][()] for k in f}
    else:
        dump = rows.rows()
    n = n_batches * B
    shapes = {k: np.shape(v) for k, v in dump.items()}
    print(f"{tag}: eval rows {shapes}")
    if shapes["joint_cam_pred"] != (n, 21, 3) or len(dump["img_paths"]) != n:
        fail(f"{tag}: the dump holds {shapes}, expected {n} rows")
    if not all(np.isfinite(dump[k]).all() for k in dump if k != "img_paths"):
        fail(f"{tag}: non-finite values in the eval dump")

    # one eval batch: the kernel path against the eager path, and the dump
    ds = dataset if dataset is not None else build_datasets(ecfg, "test")
    first = collate([ds[i] for i in range(B)])  # the loader's first batch
    req = tuple(first[k] for k in ("patches", "square_bboxes", "timestamp", "focal", "princpt"))
    ckpt = osp.realpath(ecfg.eval_ckpt)
    sessions = {d: PoserSession(cfg_of(batch_size=B), checkpoint=ckpt, batch_size=B, dtype=dt,
                                device=DEV)
                for d, dt in (("bf16", "bfloat16"), ("f32", "float32"))}
    kernel32 = sessions["f32"].predict_crops(*req)["joint_cam"][:, -1]
    floor = compare_paths(torch, tag, sessions, "fused", req, bf16_tokens=True,
                          bf16_witness=True)
    err = float(np.abs(dump["joint_cam_pred"][:B] - kernel32).max())
    tol = 2 * floor["f32"] + SERVE_MM_SLACK["f32"]
    print(f"{tag}: eval dump's first batch vs the f32 session's kernel path: "
          f"max_abs={err:.4f} mm, tol={tol:.4f} mm {'ok' if err <= tol else 'FAIL'}")
    if err > tol:
        fail(f"{tag}: the eval dump disagrees with the served kernel path")
    del sessions
    return dump, float(timing.group(2)), float(timing.group(3))


def dexycb_fixture(work, have, tag):
    """The lifecycle's synthetic DexYCB tree (LIFECYCLE_TRAIN and
    LIFECYCLE_TEST sequences of LIFECYCLE_HW frames) under `work`: HDF5 and
    JPEG files where h5py imports, else the JPEG files with the annotations
    in memory. Returns (its root, frames per split, ``dataset(split, cfg)``:
    the in-memory dataset, or None where ``build_datasets`` reads the
    files)."""
    import os.path as osp

    from cs_vit_tpu_torch.data import DexYCB
    from cs_vit_tpu_torch.data.fixtures import (
        write_images,
        make_synthetic_dexycb,
        synthetic_dexycb_sequences,
    )

    data_root = osp.join(work, "dexycb")
    t0 = time.perf_counter()
    splits = (("train", LIFECYCLE_TRAIN, 1), ("test", LIFECYCLE_TEST, 2))
    if have["h5py"]:
        for split, (n_seqs, seq_len), seed in splits:
            make_synthetic_dexycb(data_root, splits=(split,), num_seqs=n_seqs, seq_len=seq_len,
                                  img_hw=LIFECYCLE_HW, seed=seed)
        sequences = None
    else:
        sequences = [seq for split, (n_seqs, seq_len), seed in splits
                     for seq in synthetic_dexycb_sequences((split,), n_seqs, seq_len,
                                                           LIFECYCLE_HW, seed)]
        for _, _, arrays in sequences:
            write_images(data_root, [r.decode() for r in arrays["imgs_path"]],
                          arrays["images"])
    n_frames = {split: n * T for split, (n, T), _ in splits}
    print(f"{tag}: synthetic DexYCB at {LIFECYCLE_HW[0]}x{LIFECYCLE_HW[1]}, "
          f"{n_frames['train']} train and {n_frames['test']} test frames, written in "
          f"{time.perf_counter() - t0:.1f} s ("
          + ("HDF5 and JPEG files)" if sequences is None else
             "JPEG files; the annotations in memory)"))

    def dataset(split, cfg):
        if sequences is None:
            return None
        return DexYCB(data_root, 1, "s1", split, img_size=cfg.img_size,
                      expansion_ratio=cfg.expansion_ratio,
                      store=memory_store(sequences, split, "sequences/{}"))

    return data_root, n_frames, dataset


def lifecycle(torch, launches, have, bare_step_ms):
    """Phase lifecycle: the port's experiment loop at the flagship width.
    cli.finetune for epoch 1, then again for epoch 2, which must resume from
    checkpoint_1 (the step count continues, only epoch 2 runs, the
    ``checkpoint`` symlink moves); cli.evaluate from that symlink (see
    run_eval); cli.benchmark's four metrics, finite. `have` says which of
    FILE_LIBS import here; `bare_step_ms` is the train phase's step."""
    import os.path as osp
    import shutil

    from cs_vit_tpu_torch.cli import benchmark
    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.evaluation import compute_metrics

    missing = [m for m in FILE_LIBS if not have[m]]
    print(f"lifecycle: file libraries missing here: {', '.join(missing) or 'none'}")
    if not have["cv2"]:
        fail("lifecycle: cv2 is missing: the DexYCB path decodes, flips and augments with it")
    work = osp.abspath(LIFECYCLE_DIR)
    shutil.rmtree(work, ignore_errors=True)
    ckpt_root = osp.join(work, "checkpoints")
    data_root, n_frames, dataset = dexycb_fixture(work, have, "lifecycle")

    def config(**over):
        return FinetuneConfig(**dict(LIFECYCLE_CONFIG, backbone=BACKBONE, img_size=IMG,
                                     dexycb_root=data_root, **over))

    exp_dir = osp.realpath(osp.join(ckpt_root, LIFECYCLE_CONFIG["exp"]))
    steps = n_frames["train"] // LIFECYCLE_CONFIG["batch_size"]
    for epoch in (1, 2):
        cfg = config(epoch=epoch)
        _, step_ms, wait = run_finetune(torch, "lifecycle", cfg, ckpt_root, epoch, steps,
                                        dataset("train", cfg))
    median = statistics.median(step_ms)
    print(f"lifecycle_finetune_step_ms_b8 {median:.1f} (median of epoch 2's "
          f"{steps} steps, the loop's wall a step at 1 ms resolution: {step_ms}; batches "
          f"through device_prefetch; loader wait share {wait:.4f}); the train phase's bare "
          f"step here {bare_step_ms:.1f} ms, excess {median - bare_step_ms:.1f} ms (with "
          f"pageable f32 copies and the numpy crop, on an H100 80GB HBM3 at 700 W: 400.5 ms, "
          f"bare step 189.4 ms) on "
          f"{nvidia_smi_line() if DEV == 'cuda' else 'the CPU'}")

    ecfg = config(epoch=2, batch_size=LIFECYCLE_EVAL_BATCH,
                  eval_ckpt=osp.join(exp_dir, "checkpoint"))
    h5_path = osp.join(work, "eval.h5") if have["h5py"] else None
    dump, ms, wait = run_eval(torch, launches, "lifecycle", ecfg, ckpt_root,
                              dataset("test", ecfg), n_frames["test"] // LIFECYCLE_EVAL_BATCH,
                              h5_path, config)
    if h5_path:
        metrics, _ = printed(benchmark.main, h5_path)
    else:
        metrics = compute_metrics(dump["joint_cam_gt"], dump["joint_cam_pred"])
        for key in ("mprpe", "mpjpe_cs", "mpjpe_rs", "mpjpe_pa"):  # benchmark.main's lines
            print(f"{key}: {metrics[key]} mm")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"lifecycle: non-finite metrics {metrics}")
    print(f"lifecycle_eval_ms_per_batch_b{LIFECYCLE_EVAL_BATCH} {ms}, "
          f"loader wait share {wait} (host clock, the whole eval loop) on "
          f"{nvidia_smi_line() if DEV == 'cuda' else 'the CPU'}")
    shutil.rmtree(work)


def check_prefetch(torch, cfg, dataset):
    """One batch of `cfg`'s training loader through device_prefetch: its
    tensors bit-identical to batch_to_device's with the patches cast to bf16
    on the card, its staging tensors pinned (on the card), and the bytes each
    path copies."""
    from cs_vit_tpu_torch.cli.common import batch_to_device, build_loader
    from cs_vit_tpu_torch.parallel import device_prefetch, host_stage

    loader = build_loader(cfg, dataset, shuffle=True)
    loader.set_epoch(1)
    host = list(loader)[0]  # the whole epoch: no loader thread left waiting
    bf16 = torch.bfloat16
    (got,) = list(device_prefetch([host], DEV, patches_dtype=bf16))
    want = batch_to_device(host, torch.device(DEV))
    want["patches"] = want["patches"].to(bf16)  # the train step's own cast, on the card
    sync(torch)
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.device != w.device or not torch.equal(
                g.view(torch.int16) if k == "patches" else g,
                w.view(torch.int16) if k == "patches" else w):
            fail(f"datasets: the prefetched {k} is not batch_to_device's bf16 {k}")
    staged = host_stage(host, pin=DEV == "cuda", patches_dtype=bf16)
    pinned = all(t.is_pinned() for t in staged.values())
    if DEV == "cuda" and not pinned:
        fail("datasets: device_prefetch's staging tensors are not pinned")
    copied = sum(t.numel() * t.element_size() for t in staged.values())
    pageable = sum(t.numel() * t.element_size() for t in want.values()) + \
        want["patches"].numel() * 2
    print(f"datasets: a prefetched b{cfg.batch_size} batch equals batch_to_device's with bf16 "
          f"patches, bit for bit ({len(want)} tensors); staging pinned: {pinned}; "
          f"{copied / 1e6:.2f} MB copied a batch against {pageable / 1e6:.2f} MB pageable f32")


def host_crop_ms(frames, boxes, size, reps=5):
    """Median ms of crop_with_square_box_np over one batch of uint8 frames,
    on the C crop and on the numpy path, and whether the two agree to the
    f32 rounding of the sample positions (two ulps of the longer side)."""
    import numpy as np

    from cs_vit_tpu_torch import native
    from cs_vit_tpu_torch.ops import resample

    def timed():
        out, times = None, []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = resample.crop_with_square_box_np(frames, boxes, 1.25, size)[0]
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    c_out, c_ms = timed()
    available = native.native_available
    native.native_available = lambda: False  # the numpy path, as where no compiler exists
    try:
        np_out, np_ms = timed()
    finally:
        native.native_available = available
    err = float(np.abs(c_out - np_out).max())
    return c_ms, np_ms, err


def loader_contention(torch, cfg, dataset, steps=10):
    """The bare b8 bf16 spatial step (a seeded batch already on the card)
    timed with the host loader idle, then while `cfg`'s loader (its
    threads decoding, augmenting and cropping `dataset`) runs epoch after
    epoch in the background, and beside as many processes spinning on the
    host's cores as the loader has threads (the cores taken, the
    interpreter lock not): whether and how the loader's threads hold the
    dispatching thread back. Returns the three medians (ms)."""
    import os
    import threading

    from cs_vit_tpu_torch.cli.common import build_loader

    model = train_model(torch)
    state, step = new_step(torch, model, torch.bfloat16)
    batch = train_batch(torch, 8, seed=10)
    gen = torch.Generator(device=DEV).manual_seed(0)

    def timed():
        times = []
        for _ in range(steps):
            sync(torch)
            t0 = time.perf_counter()
            step(state, batch, gen)
            sync(torch)
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    for _ in range(3):
        step(state, batch, gen)
    idle = timed()
    stop, produced, errors = threading.Event(), [0], []

    def load():  # whole epochs only, so that no loader is left half-drained
        try:
            loader, epoch = build_loader(cfg, dataset, shuffle=True), 0
            while not stop.is_set():
                loader.set_epoch(epoch)
                epoch += 1
                for _ in loader:
                    produced[0] += 1
        except Exception as e:  # raised below
            errors.append(e)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    time.sleep(0.5)  # the loader's threads under way
    n0 = produced[0]
    busy = timed()
    n1 = produced[0]
    stop.set()
    t.join(timeout=120)
    if t.is_alive() or errors:
        fail(f"datasets: the background loader did not stop cleanly ({errors})")
    # as many processes spinning on the host's cores as the loader has
    # threads: core contention without the interpreter lock
    hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(cfg.num_workers)]
    try:
        time.sleep(0.5)
        spun = timed()
    finally:
        for h in hogs:
            h.kill()
        for h in hogs:
            h.wait(timeout=30)
    med = {k: statistics.median(v) for k, v in (("idle", idle), ("busy", busy), ("spun", spun))}
    print(f"datasets_loader_contention: bare b8 bf16 step {med['idle']:.1f} ms "
          f"(min {min(idle):.1f}) with the loader idle, {med['busy']:.1f} ms "
          f"(min {min(busy):.1f}) while its {cfg.num_workers} threads made {n1 - n0} b8 "
          f"batches of 480x640 / 512x334 frames as fast as they could, {med['spun']:.1f} ms "
          f"(min {min(spun):.1f}) beside {cfg.num_workers} processes spinning on the host's "
          f"{os.cpu_count()} cores; median of {steps} steps each on "
          f"{nvidia_smi_line() if DEV == 'cuda' else 'the CPU'}")
    del model, state, step, batch
    return med


def datasets(torch, launches, have, bare_step_ms):
    """Phase datasets: the flagship configuration over synthetic HO3D (480 x
    640) and InterHand2.6M (512 x 334) trees. cli.finetune for one epoch over
    both through device_prefetch (step count, the flagship step's launches a
    step, finite losses, one prefetched batch bit for bit against
    batch_to_device's bf16, pinned staging); cli.evaluate on the
    InterHand2.6M test split and the HO3D evaluation split (see run_eval);
    PoserSession.predict_images on 8 full HO3D frames at b1 and b8, equal bit
    for bit to predict_crops on the port's own host crops; timings of each,
    and the host crop of one b8 batch, C against numpy; the bare step with the
    loader idle and busy (loader_contention)."""
    import os.path as osp
    import shutil

    import numpy as np

    from cs_vit_tpu_torch import native
    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.data import HO3D, ConcatDataset, InterHand26MSeq
    from cs_vit_tpu_torch.data.dexycb import load_image_rgb
    from cs_vit_tpu_torch.data.fixtures import (
        write_images,
        make_synthetic_ho3d,
        make_synthetic_ih26mseq,
        synthetic_ho3d_sequences,
        synthetic_ih26mseq_sequences,
    )
    from cs_vit_tpu_torch.ops.resample import crop_with_square_box_np
    from cs_vit_tpu_torch.serving import PoserSession

    print(f"datasets: h5py {'imports' if have['h5py'] else 'missing'}, cv2 "
          f"{'imports' if have['cv2'] else 'missing'}; C compiler {native.find_compiler()}")
    if not have["cv2"]:
        fail("datasets: cv2 is missing: the HO3D and InterHand2.6M paths decode with it")
    t0 = time.perf_counter()
    built = native.native_available()
    print(f"datasets: C crop built: {built} ({native.build()}, "
          f"{time.perf_counter() - t0:.2f} s)")
    if not built:
        fail("datasets: the C crop did not build (no C compiler on PATH)")

    work = osp.abspath(DATASETS_DIR)
    shutil.rmtree(work, ignore_errors=True)
    ho3d_root, ih_root = osp.join(work, "ho3d"), osp.join(work, "ih26m")
    ckpt_root = osp.join(work, "checkpoints")
    t0 = time.perf_counter()
    ho3d_splits = (("train", DATASETS_HO3D_TRAIN, 1), ("evaluation", DATASETS_HO3D_EVAL, 3))
    ih_splits = (("train", DATASETS_IH_TRAIN, 2), ("test", DATASETS_IH_TEST, 4))
    ho3d_seqs = [seq for split, (n, T), seed in ho3d_splits
                 for seq in synthetic_ho3d_sequences((split,), n, T, DATASETS_HO3D_HW, seed)]
    if have["h5py"]:
        for split, (n, T), seed in ho3d_splits:
            make_synthetic_ho3d(ho3d_root, (split,), n, T, DATASETS_HO3D_HW, seed)
        for split, T, seed in ih_splits:
            make_synthetic_ih26mseq(ih_root, (split,), T, DATASETS_IH_HW, seed)
        ih_seqs = None
    else:
        ih_seqs = [seq for split, T, seed in ih_splits
                   for seq in synthetic_ih26mseq_sequences((split,), T, DATASETS_IH_HW, seed)]
        for _, _, arrays in ho3d_seqs:
            write_images(ho3d_root, [r.decode() for r in arrays["img_path"]],
                          arrays["images"])
        for split, _, arrays in ih_seqs:
            write_images(osp.join(ih_root, "images", split),
                          [r.decode() for r in arrays["img_path"]], arrays["images"])
    n_train = sum(n * T for _, (n, T), _ in ho3d_splits[:1]) + 2 * DATASETS_IH_TRAIN
    n_eval = {"ho3d": DATASETS_HO3D_EVAL[0] * DATASETS_HO3D_EVAL[1],
              "interhand26m": 2 * DATASETS_IH_TEST}
    print(f"datasets: synthetic HO3D at {DATASETS_HO3D_HW[0]}x{DATASETS_HO3D_HW[1]} and "
          f"InterHand2.6M at {DATASETS_IH_HW[0]}x{DATASETS_IH_HW[1]}: {n_train} train frames, "
          f"{n_eval['ho3d']} HO3D evaluation and {n_eval['interhand26m']} InterHand2.6M test "
          f"frames, written in {time.perf_counter() - t0:.1f} s ("
          + ("HDF5 and JPEG files)" if ih_seqs is None else
             "JPEG files; the annotations in memory)"))

    def config(**over):
        return FinetuneConfig(**dict(DATASETS_CONFIG, backbone=BACKBONE, img_size=IMG,
                                     ho3d_root=ho3d_root, ih26mseq_root=ih_root, **over))

    def dataset(name, split, cfg):
        """`name`'s split over the in-memory annotations (None: build_datasets
        reads the HDF5 files)."""
        if ih_seqs is None:
            return None
        kw = dict(img_size=cfg.img_size, expansion_ratio=cfg.expansion_ratio)
        if name == "ho3d":
            return HO3D(ho3d_root, 1, split, store=memory_store(ho3d_seqs, split,
                                                                "sequences/{}"), **kw)
        return InterHand26MSeq(ih_root, 1, split, store=memory_store(ih_seqs, split,
                                                                     "{}/annots"), **kw)

    # (a) finetune over both through device_prefetch
    cfg = config(epoch=1)
    train = None if ih_seqs is None else ConcatDataset(
        [dataset("ho3d", "train", cfg), dataset("interhand26m", "train", cfg)])
    steps = n_train // DATASETS_CONFIG["batch_size"]
    sync(torch)
    launches.reset_launch_counts()
    _, step_ms, wait = run_finetune(torch, "datasets", cfg, ckpt_root, 1, steps, train)
    sync(torch)
    counts = launches.launch_counts()
    print(f"datasets: finetune launches over {steps} steps {json.dumps(counts)}")
    if DEV == "cuda":
        for name, per in train_expect(sum(cfg_depths(cfg))).items():
            if counts[name] != per * steps:
                fail(f"datasets: {name}: {counts[name]} launches in {steps} finetune steps, "
                     f"expected {per} a step (the flagship step's)")
    median = statistics.median(step_ms)
    print(f"datasets_finetune_step_ms_b8 {median:.1f} (median of {steps} steps, 1 ms "
          f"resolution: {step_ms}); the train phase's bare step {bare_step_ms:.1f} ms, excess "
          f"{median - bare_step_ms:.1f} ms; loader wait share {wait:.4f} (host clock) on "
          f"{nvidia_smi_line() if DEV == 'cuda' else 'the CPU'}")
    if train is None:
        from cs_vit_tpu_torch.cli.common import build_datasets

        train = build_datasets(cfg, "train")
    check_prefetch(torch, cfg, train)
    loader_contention(torch, cfg, train)

    # (b) evaluation on each test split
    ckpt = osp.join(ckpt_root, DATASETS_CONFIG["exp"], "checkpoint")
    for name, split in (("interhand26m", "test"), ("ho3d", "evaluation")):
        ecfg = config(data=[name], batch_size=DATASETS_EVAL_BATCH, eval_ckpt=ckpt)
        h5_path = osp.join(work, f"eval_{name}.h5") if ih_seqs is None else None
        _, ms, wait = run_eval(torch, launches, f"datasets {name}", ecfg, ckpt_root,
                               dataset(name, split, ecfg), n_eval[name] // DATASETS_EVAL_BATCH,
                               h5_path, lambda **kw: config(data=[name], **kw))
        print(f"datasets_eval_{name}_ms_per_batch_b{DATASETS_EVAL_BATCH} {ms}, loader wait "
              f"share {wait} (host clock, the whole eval loop) on "
              f"{nvidia_smi_line() if DEV == 'cuda' else 'the CPU'}")

    # (c) full-frame serving: 8 HO3D evaluation frames and their tight boxes
    frames = [(osp.join(ho3d_root, rel.decode()), box, f, c)
              for split, _, a in ho3d_seqs if split == "evaluation"
              for rel, box, f, c in zip(a["img_path"], a["bbox_tight"], a["focal"], a["princpt"])]
    frames = frames[:8]
    images = np.stack([load_image_rgb(p, as_float=True) for p, _, _, _ in frames])
    boxes, focal, princpt = (np.stack([fr[i] for fr in frames]) for i in (1, 2, 3))
    ts = np.zeros((8,), np.float32)
    scfg = config()
    ckpt_file = osp.realpath(ckpt)
    depth = sum(cfg_depths(scfg))
    for B in (1, 8):
        sess = PoserSession(scfg, checkpoint=ckpt_file, batch_size=B, dtype="bfloat16",
                            device=DEV)
        sess.warmup()
        sync(torch)
        launches.reset_launch_counts()
        out = sess.predict_images(images, boxes, focal, princpt, ts)
        sync(torch)
        counts = launches.launch_counts()
        if DEV == "cuda":
            check_serve_launches(f"datasets predict_images b{B}", counts, 8 // B, depth)
        patches, _, squares = crop_with_square_box_np(images.astype(np.float32), boxes,
                                                      scfg.expansion_ratio, scfg.img_size)
        crops = (patches[:, None], squares[:, None], ts[:, None], focal[:, None],
                 princpt[:, None])
        want = sess.predict_crops(*crops)
        for k in want:
            if out[k].shape != want[k][:, 0].shape or not np.array_equal(out[k], want[k][:, 0]):
                fail(f"datasets: predict_images b{B} {k} differs from predict_crops on the "
                     "host crops")
        if out["joint_cam"].shape != (8, 21, 3) or not np.isfinite(out["joint_cam"]).all():
            fail(f"datasets: predict_images b{B} joint_cam {out['joint_cam'].shape} or "
                 "non-finite")
        print(f"datasets: predict_images b{B} over 8 frames of 480x640: {8 // B} forwards, "
              f"launches {json.dumps(counts)}; equal bit for bit to predict_crops on the host "
              "crops")
        n = B
        img_ms, crop_ms = [], []
        for fn, args, times in ((sess.predict_images, (images[:n], boxes[:n], focal[:n],
                                                       princpt[:n], ts[:n]), img_ms),
                                (sess.predict_crops, tuple(c[:n] for c in crops), crop_ms)):
            for rep in range(23):
                sync(torch)
                t0 = time.perf_counter()
                fn(*args)
                sync(torch)
                if rep >= 3:
                    times.append((time.perf_counter() - t0) * 1e3)
        print(f"datasets_predict_images_b{B}_ms {statistics.median(img_ms):.3f} (min "
              f"{min(img_ms):.3f}); predict_crops on the same crops "
              f"{statistics.median(crop_ms):.3f} (min {min(crop_ms):.3f}); 20 calls after 3 on "
              f"{nvidia_smi_line() if DEV == 'cuda' else 'the CPU'}")
        del sess

    # (d) the host crop of one b8 batch of 480 x 640 uint8 frames
    u8 = np.stack([load_image_rgb(p, as_float=False) for p, _, _, _ in frames])
    c_ms, np_ms, err = host_crop_ms(u8, boxes, IMG)
    print(f"datasets_host_crop_b8_ms C {c_ms:.3f}, numpy {np_ms:.3f} ({np_ms / c_ms:.1f}x; "
          f"crop_with_square_box_np of 8 uint8 frames of 480x640 to {IMG}x{IMG}, median of 5, "
          f"on the host CPU of {nvidia_smi_line() if DEV == 'cuda' else 'no card'}; the two "
          f"paths differ by {err:.2e})")
    if err > 2 * float(np.spacing(np.float32(max(DATASETS_HO3D_HW)))):
        fail("datasets: the C crop and the numpy crop disagree beyond the rounding of the "
             "sample positions")
    shutil.rmtree(work)


def flagship_depth() -> int:
    from cs_vit_tpu_torch.models import PoserConfig

    return sum(PoserConfig(backbone=BACKBONE, image_size=IMG).swin_config().depths)


def timed_steps(torch, fb, state, step, batch, n, seed=7):
    """n steps on `batch`, the droppath generator reseeded to `seed` before
    each: (median ms of the steps after the first, the last step's peak
    device memory above what stays resident in bytes (None off the card),
    the last step's launch counts)."""
    times, peak, counts = [], None, None
    gen = torch.Generator(device=DEV)
    for i in range(n):
        gen.manual_seed(seed)
        sync(torch)
        last = i == n - 1
        if last:
            fb.reset_launch_counts()
            if DEV == "cuda":
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = step(state, batch, gen)
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(float(met["loss"])):
            fail(f"a non-finite loss {float(met['loss'])} at step {i}")
        if last:
            counts = fb.launch_counts()
            if DEV == "cuda":
                peak = torch.cuda.max_memory_allocated() - resident
    return statistics.median(times[1:] if n > 1 else times), peak, counts


def gib(nbytes) -> str:
    return "n/a" if nbytes is None else f"{nbytes / 2**30:.3f} GiB"


def release(torch) -> None:
    import gc

    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


def check_remat(torch, fb):
    """The flagship bf16 step at b8 with and without remat, from the same
    weights, batch and droppath generator: loss, grad norm, every grad and
    the generator's state afterwards bit-identical; the backward kernels'
    launches unchanged and the forward kernels' up by one served forward's
    (the recomputation runs the backbone's forward once more); then the
    step time and peak memory of both at b8 and at the largest batch the
    step without remat fits. Returns the plain b8 step's ms."""
    expect = train_expect(flagship_depth())
    batch = train_batch(torch, 8, seed=10)
    res = {}
    for remat in (False, True):
        model = train_model(torch, remat=remat)
        state, step = new_step(torch, model, torch.bfloat16)
        gen = torch.Generator(device=DEV).manual_seed(7)
        fb.reset_launch_counts()
        state, met = step(state, batch, gen)
        sync(torch)
        res[remat] = {"loss": met["loss"], "grad_norm": met["grad_norm"],
                      "counts": fb.launch_counts(), "gen": gen.get_state(),
                      "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                                if p.grad is not None}}
        ms, peak, _ = timed_steps(torch, fb, state, step, batch, PARALLEL_TIMED_STEPS)
        res[remat].update(ms=ms, peak=peak)
        print(f"parallel: remat={remat} b8 step loss {float(met['loss']):.6f} grad_norm "
              f"{float(met['grad_norm']):.6f}; step {ms:.3f} ms (median of "
              f"{PARALLEL_TIMED_STEPS - 1}), peak {gib(peak)} above the resident")
        del model, state, step
        release(torch)
    plain, remat = res[False], res[True]
    same = {"loss": torch.equal(plain["loss"], remat["loss"]),
            "grad_norm": torch.equal(plain["grad_norm"], remat["grad_norm"]),
            "generator": torch.equal(plain["gen"], remat["gen"]),
            "grads": plain["grads"].keys() == remat["grads"].keys() and all(
                torch.equal(g, remat["grads"][n]) for n, g in plain["grads"].items())}
    print(f"parallel: remat vs plain b8 bf16 step, bit-identical: {json.dumps(same)} "
          f"({len(plain['grads'])} grads)")
    if not all(same.values()):
        fail(f"parallel: the remat step differs from the plain step: {same}")
    # the recomputation adds one forward of the backbone (a served
    # forward's kernels, serve_expect); the wrappers' own counters do not
    # move, as checkpoint's recomputation stops once the block's autograd
    # function has saved its tensors, before ``fused_swin_block`` returns
    forward = ("fused_swin_block", "gemm_bias_act", "ln_residual", "window_attention")
    backward = ("FusedSwinBlock", "gemm_dgrad", "gemm_wgrad", "ln_residual_bwd",
                "window_attention_bwd")
    rise = serve_expect(flagship_depth())
    if DEV == "cuda":
        wrong = {}
        for k in forward + backward:
            want = expect[k] + (rise[k] if k in forward[1:] else 0)
            if (plain["counts"][k], remat["counts"][k]) != (expect[k], want):
                wrong[k] = {"plain": plain["counts"][k], "remat": remat["counts"][k],
                            "expected": (expect[k], want)}
        if wrong:
            fail(f"parallel: launches a step: {json.dumps(wrong)}")
    def kernels_of(counts, names):  # the wrappers' own counters are no kernels
        return sum(counts[k] for k in names if k not in ("fused_swin_block", "FusedSwinBlock"))

    fwd = [kernels_of(r["counts"], forward) for r in (plain, remat)]
    bwd = [kernels_of(r["counts"], backward) for r in (plain, remat)]
    print(f"parallel: launches a step, plain: forward kernels {fwd[0]}, backward kernels "
          f"{bwd[0]}; remat: forward kernels {fwd[1]} (+{fwd[1] - fwd[0]} for the "
          f"recomputation), backward kernels {bwd[1]}; {json.dumps(remat['counts'])}")
    print(f"parallel_remat_b8: step {remat['ms']:.3f} ms (plain {plain['ms']:.3f} ms), peak "
          f"{gib(remat['peak'])} (plain {gib(plain['peak'])}) on "
          f"{nvidia_smi_line() if DEV == 'cuda' else 'the CPU'}")
    if DEV == "cuda":
        largest_batch(torch, fb)
    return plain["ms"]


def largest_batch(torch, fb):
    """The largest multiple of 8 whose plain step fits on the card, then both
    steps' time and peak memory there. The first try is PARALLEL_EDGE; from
    there the batch grows by 8, 16, 32, ... until one does not fit, then
    the interval from the largest that fits (b8 at first) halves down to 8
    (each batch that does not fit is printed)."""
    model = train_model(torch)
    state, step = new_step(torch, model, torch.bfloat16)
    tried, batch8 = {}, train_batch(torch, 8, seed=11)

    def tiled(b):  # b // 8 copies of one b8 batch: the step's cost, not its data
        return {k: v.repeat(b // 8, *([1] * (v.dim() - 1))) for k, v in batch8.items()}

    def attempt(b):
        try:
            tried[b] = timed_steps(torch, fb, state, step, tiled(b), 2)[:2]
            print(f"parallel: b{b} fits without remat: step {tried[b][0]:.3f} ms, peak "
                  f"{gib(tried[b][1])}")
        except torch.cuda.OutOfMemoryError:
            tried[b] = None
            print(f"parallel: b{b} does not fit without remat")
        release(torch)
        return tried[b]

    total = torch.cuda.mem_get_info()[1]
    lo, hi = 8, None  # the largest batch known to fit, the smallest known not to
    b, grow = PARALLEL_EDGE, 8
    for _ in range(PARALLEL_MAX_TRIES):
        if attempt(b) is None:
            hi = b
        else:
            lo = b
        if hi is not None and hi - lo == 8:
            break
        if hi is None:
            b, grow = b + grow, 2 * grow
        else:
            b = lo + (hi - lo) // 16 * 8
    else:
        fail(f"parallel: no edge between fitting and not fitting within "
             f"{PARALLEL_MAX_TRIES} tries: {sorted(tried)}")
    b = lo
    if b not in tried:  # b8: no larger batch fitted
        attempt(b)
    del model, state, step
    release(torch)
    model = train_model(torch, remat=True)
    state, step = new_step(torch, model, torch.bfloat16)
    ms, peak, _ = timed_steps(torch, fb, state, step, tiled(b), 2)
    del model, state, step
    release(torch)
    print(f"parallel_largest_plain_batch {b} (of {total / 2**30:.1f} GiB): plain step "
          f"{tried[b][0]:.3f} ms, peak {gib(tried[b][1])}; remat step {ms:.3f} ms, peak "
          f"{gib(peak)} on {nvidia_smi_line()}")


def nccl_world(torch, have):
    """cli.finetune on the lifecycle fixture twice for one epoch (4 steps):
    without a process group, then under a torchrun-style environment with
    WORLD_SIZE=1, where ``init_distributed`` starts an NCCL group and the
    step's average runs as an NCCL all-reduce; the two checkpoints must be
    bit-identical."""
    import os
    import os.path as osp
    import shutil
    import socket

    import torch.distributed as dist

    from cs_vit_tpu_torch.config import FinetuneConfig

    work = osp.abspath(PARALLEL_DIR)
    shutil.rmtree(work, ignore_errors=True)
    ckpt_root = osp.join(work, "checkpoints")
    data_root, n_frames, dataset = dexycb_fixture(work, have, "parallel")
    steps = n_frames["train"] // LIFECYCLE_CONFIG["batch_size"]
    ms = {}
    for name in ("nogroup", "nccl"):
        cfg = FinetuneConfig(**dict(LIFECYCLE_CONFIG, exp=f"chip_smoke_{name}", backbone=BACKBONE,
                                    img_size=IMG, dexycb_root=data_root, epoch=1))
        env = {}
        if name == "nccl":
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        os.environ.update(env)
        try:
            _, step_ms, _ = run_finetune(torch, "parallel", cfg, ckpt_root, 1, steps,
                                         dataset("train", cfg))
            if name == "nccl":
                if not (dist.is_initialized() and dist.get_world_size() == 1
                        and dist.get_backend() == ("nccl" if DEV == "cuda" else "gloo")):
                    fail("parallel: cli.finetune did not start the process group")
                print(f"parallel: cli.finetune ran in a {dist.get_backend()} world of "
                      f"{dist.get_world_size()}")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k in env:
                del os.environ[k]
        ms[name] = statistics.median(step_ms)
        release(torch)
    payloads = [torch.load(osp.join(ckpt_root, f"chip_smoke_{n}", "checkpoint_1"),
                           map_location="cpu", weights_only=True) for n in ("nogroup", "nccl")]
    a, b = payloads
    same_model = a["model"].keys() == b["model"].keys() and all(
        torch.equal(v, b["model"][k]) for k, v in a["model"].items())
    opt_a, opt_b = a["optimizer"]["state"], b["optimizer"]["state"]
    same_opt = opt_a.keys() == opt_b.keys() and all(
        torch.equal(v, opt_b[i][k]) for i, s in opt_a.items() for k, v in s.items())
    print(f"parallel: checkpoint after {steps} steps, NCCL world of 1 vs no group: parameters "
          f"and statistics bit-identical {same_model}, AdamW state bit-identical {same_opt}, "
          f"step {b['step']} vs {a['step']}")
    if not (same_model and same_opt and a["step"] == b["step"] == steps):
        fail("parallel: the one-rank NCCL fine-tune differs from the run without a group")
    print(f"parallel_nccl1_finetune_step_ms_b8 {ms['nccl']:.1f} (no group {ms['nogroup']:.1f}; "
          f"the loop's wall a step, median of {steps}) on "
          f"{nvidia_smi_line() if DEV == 'cuda' else 'the CPU'}")
    shutil.rmtree(work)


def dp_rank(rank: int, port: str, work: str) -> int:
    """One of two gloo ranks on the one card (``chip_smoke.py --dp-rank RANK
    PORT WORK DEV BACKBONE IMG``, the parent's settings): DP_STEPS bf16
    flagship steps on its half of the b8 batch, droppath drawn from a
    generator seeded DP_SEED + RANK; writes its state dict, its launch
    counts and times a step to WORK/rank<RANK>.pt."""
    import torch
    import torch.distributed as dist

    from cs_vit_tpu_torch.ops import fused_block as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    model = train_model(torch)
    state, step = new_step(torch, model, torch.bfloat16)
    half = {k: v[4 * rank:4 * rank + 4] for k, v in train_batch(torch, 8, seed=10).items()}
    gen = torch.Generator(device=DEV).manual_seed(DP_SEED + rank)
    counts, times, losses = [], [], []
    for _ in range(DP_STEPS):
        fb.reset_launch_counts()
        sync(torch)
        t0 = time.perf_counter()
        state, met = step(state, half, gen)
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(fb.launch_counts())
        losses.append(float(met["loss"]))
    torch.save({"state": {k: v.cpu() for k, v in model.state_dict().items()},
                "counts": counts, "times": times, "losses": losses, "step": state.step},
               f"{work}/rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def run_ranks(flag: str, work: str, timeout: float, tag: str) -> None:
    """Two rank processes of this script (``chip_smoke.py FLAG RANK PORT WORK
    DEV BACKBONE IMG``, the parent's settings), a gloo world on a free
    localhost port; fails if one does not exit 0 within `timeout` s, and
    stops both in any case."""
    import os.path as osp
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, osp.abspath(__file__), flag, str(r), port, work,
                               DEV, BACKBONE, str(IMG)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(err[-4000:], file=sys.stderr)
            fail(f"{tag}: gloo rank {r} exited {p.returncode}")


def two_ranks(torch, bare_step_ms):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device), every tensor on the card, each on half of the b8 batch for
    DP_STEPS steps: both ranks' parameters and BatchNorm statistics
    bit-identical, and equal bit for bit to a one-process emulation (the two
    halves' grads and fresh statistics computed in turn, averaged as
    ``all_mean_`` averages, then clipped and stepped); each rank step
    launches the flagship step's kernels."""
    import os
    import os.path as osp
    import shutil

    work = osp.abspath(PARALLEL_DIR + "_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    run_ranks("--dp-rank", work, DP_TIMEOUT, "parallel")
    ranks = [torch.load(osp.join(work, f"rank{r}.pt"), weights_only=True) for r in range(2)]

    model = train_model(torch)
    state, step = new_step(torch, model, torch.bfloat16)
    batch = train_batch(torch, 8, seed=10)
    halves = [{k: v[4 * r:4 * r + 4] for k, v in batch.items()} for r in range(2)]
    gens = [torch.Generator(device=DEV).manual_seed(DP_SEED + r) for r in range(2)]
    for _ in range(DP_STEPS):
        parts = [step.local(halves[r], gens[r]) for r in range(2)]
        with torch.no_grad():
            for a, b in zip(step.averaged(parts[0]), step.averaged(parts[1])):
                a.copy_(((a.float() + b.float()) / 2).to(a.dtype))
        state, _ = step.update(state, parts[0])
    emulated = {k: v.cpu() for k, v in model.state_dict().items()}

    def same(x, y):
        return x.keys() == y.keys() and all(torch.equal(v, y[k]) for k, v in x.items())

    ranks_agree = same(ranks[0]["state"], ranks[1]["state"])
    emulation = same(ranks[0]["state"], emulated)
    print(f"parallel: two gloo ranks on the card, {DP_STEPS} steps of b4 each: ranks "
          f"bit-identical {ranks_agree}, equal to the one-process emulation {emulation}; "
          f"losses {ranks[0]['losses']} / {ranks[1]['losses']}")
    if not (ranks_agree and emulation and ranks[0]["step"] == ranks[1]["step"] == DP_STEPS):
        fail("parallel: the two ranks disagree with each other or with the emulation")
    expect = train_expect(flagship_depth())
    for r, rank in enumerate(ranks):
        for i, counts in enumerate(rank["counts"]):
            bad = {k: counts[k] for k in expect if counts[k] != expect[k]}
            if bad and DEV == "cuda":
                fail(f"parallel: rank {r} step {i}: launches {bad}, expected {expect}")
    ms = [statistics.median(rank["times"][1:]) for rank in ranks]
    print(f"parallel_two_rank_step_ms_b4x2 {ms[0]:.3f} / {ms[1]:.3f} (rank 0 / 1, median of "
          f"{DP_STEPS - 1} after the first; each rank launches the flagship step's "
          f"{sum(expect[k] for k in expect if k not in ('fused_swin_block', 'FusedSwinBlock'))} "
          f"kernels a step); the one-process b8 step {bare_step_ms:.3f} ms on "
          f"{nvidia_smi_line() if DEV == 'cuda' else 'the CPU'}")
    del model, state, step
    release(torch)
    shutil.rmtree(work)


def parallel(torch, fb, have, bare_step_ms):
    """Phase parallel: remat, a one-rank NCCL world, two gloo ranks."""
    check_remat(torch, fb)
    nccl_world(torch, have)
    two_ranks(torch, bare_step_ms)


def pretrain(torch, have):
    """Phase pretrain: ``cli.pretrain_ti`` at the CLI's defaults (ViT-B/16,
    a DINOv2 of its width, img 224, b64) over PRETRAIN_BATCH x
    PRETRAIN_STEPS synthetic 480 x 640 JPEGs, one epoch in each mode, then
    each mode's step on one repeated batch: tivit's loss falls over
    PRETRAIN_CURVE steps; dino moves only the student's MLPs, its teacher is
    the EMA formula applied to the student bit for bit and its centre moved;
    ti moves only the transformation group. Then one f32 TIViT forward on
    the card against the CPU, held to a floor measured here."""
    import copy
    import os.path as osp
    import shutil

    import numpy as np

    from cs_vit_tpu_torch.cli import pretrain_ti
    from cs_vit_tpu_torch.data.fixtures import make_synthetic_image_folder
    from cs_vit_tpu_torch.models.ti import dino_stage_mask

    if not have["cv2"]:
        fail("pretrain: cv2 is missing: the image datasets decode and augment with it")
    work = osp.abspath(PRETRAIN_DIR)
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    root = make_synthetic_image_folder(osp.join(work, "imgs"), n=PRETRAIN_BATCH * PRETRAIN_STEPS,
                                       img_hw=PRETRAIN_HW)
    print(f"pretrain: {PRETRAIN_BATCH * PRETRAIN_STEPS} synthetic {PRETRAIN_HW[0]}x"
          f"{PRETRAIN_HW[1]} JPEGs written in {time.perf_counter() - t0:.1f} s")
    card = nvidia_smi_line() if DEV == "cuda" else "the CPU"
    for mode in ("tivit", "dino", "ti"):
        args = pretrain_ti.build_argparser().parse_args(
            ["--exp", f"chip_smoke_{mode}", "--mode", mode, "--data_root", root, "--epochs", "1",
             "--log_every", "1", "--num_workers", "8", "--device", DEV] + PRETRAIN_ARGS)
        t0 = time.perf_counter()
        run, _ = printed(pretrain_ti.main, args, device=DEV, ckpt_root=osp.join(work, "ckpt"))
        wall = time.perf_counter() - t0
        ckpt = torch.load(osp.join(work, "ckpt", args.exp, "checkpoint_1"), map_location="cpu",
                          weights_only=True)
        if len(run["losses"]) != PRETRAIN_STEPS or not all(map(math.isfinite, run["losses"])):
            fail(f"pretrain {mode}: losses {run['losses']}")
        print(f"pretrain {mode}: cli.pretrain_ti one epoch of {PRETRAIN_STEPS} steps at "
              f"b{args.batch_size} in {wall:.1f} s, losses {run['losses']}, checkpoint keys "
              f"{sorted(ckpt)}")
        images = torch.from_numpy(np.stack(
            [pretrain_ti.build_dataset(args.dataset, root, args.img_size)[i]
             for i in range(args.batch_size)])).to(DEV)
        fresh = (pretrain_ti.tivit_setup if mode == "tivit" else pretrain_ti.dino_setup)(
            args, torch.device("cpu"))
        draws = torch.Generator(device=DEV)
        if mode == "tivit":
            step = pretrain_ti.make_tivit_step(run)
        elif mode == "dino":
            step = pretrain_ti.make_dino_step(run, args.teacher_momentum)
        else:
            step = pretrain_ti.make_ti_step(run)
        n = PRETRAIN_CURVE if mode == "tivit" else 3
        losses, times, peak = [], [], None
        for i in range(n):
            draws.manual_seed(1)
            last = i == n - 1
            if last and mode == "dino":
                teacher_before = copy.deepcopy(run["teacher"])
            sync(torch)
            if last and DEV == "cuda":
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = step(images, draws)
            sync(torch)
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            if last and DEV == "cuda":
                peak = torch.cuda.max_memory_allocated() - resident
        if not all(map(math.isfinite, losses)):
            fail(f"pretrain {mode}: non-finite losses on one batch {losses}")
        ms = statistics.median(times[1:])
        print(f"pretrain_{mode}_step_ms_b{args.batch_size} {ms:.3f} (median of {n - 1} after "
              f"the first), peak {gib(peak)} above the resident, f32, on {card}; losses on one "
              f"batch {[round(v, 4) for v in losses]}")
        if mode == "tivit":
            if not losses[-1] < losses[0]:
                fail(f"pretrain tivit: the loss did not fall over {n} steps: {losses}")
        elif mode == "dino":
            start = dict(fresh["student"].named_parameters())
            moved = {k for k, p in run["student"].named_parameters()
                     if not torch.equal(p.detach().cpu(), start[k].detach())}
            masked = {k for k in start if dino_stage_mask(k)}
            students = dict(run["student"].named_parameters())
            m = args.teacher_momentum
            ema = all(torch.equal(t, tb * m + (1 - m) * students[k]) for (k, t), tb in zip(
                run["teacher"].named_parameters(), teacher_before.parameters()))
            center_moved = bool(run["center"].abs().max() > 0)
            print(f"pretrain dino: {len(moved)} of {len(start)} student parameters moved, all "
                  f"under dino_stage_mask: {moved == masked}; teacher = EMA of the student bit "
                  f"for bit: {ema}; centre moved: {center_moved}")
            if not (moved == masked and ema and center_moved):
                fail("pretrain dino: the stage moved other parameters, the teacher is not the "
                     "EMA of the student, or the centre did not move")
        else:
            frozen = all(torch.equal(p.detach().cpu(), q.detach()) for key in ("student", "teacher")
                         for p, q in zip(run[key].parameters(), fresh[key].parameters()))
            trans_moved = all(not torch.equal(p.detach().cpu(), q.detach()) for (k, p), q in zip(
                run["trans"].named_parameters(), fresh["trans"].parameters())
                if k.endswith("weight"))
            print(f"pretrain ti: student and teacher unchanged {frozen}, every weight of the "
                  f"transformation group moved {trans_moved}")
            if not (frozen and trans_moved):
                fail("pretrain ti: the stage moved more or less than the transformation group")
        del run, fresh, step, images
        release(torch)
    ds = pretrain_ti.build_dataset("coco", root, args.img_size)
    pretrain_world(torch, torch.from_numpy(np.stack(
        [ds[i] for i in range(args.batch_size)])).to(DEV))
    shutil.rmtree(work)
    tivit_card_vs_cpu(torch)


def tivit_card_vs_cpu(torch):
    """One f32 TIViT forward at the CLI's widths (b2) on the card against the
    same forward on the CPU: the same weights, images and handed-in draws,
    TF32 off. The floor is measured here: four times the CPU's own spread
    when the weights and the images move by one ulp, plus a share of the
    largest value (TIVIT_CARD_REL: 1e-5 for the encoder's patches, 1e-4 for
    the losses, which are means over every token of differences of such
    sums)."""
    import copy

    from cs_vit_tpu_torch.models.ti import TIViT, init_ti_weights
    from cs_vit_tpu_torch.models.vit import ViTConfig

    model = TIViT(ViTConfig())
    init_ti_weights(model, 3)
    gen = torch.Generator().manual_seed(5)
    images = torch.rand(2, 224, 224, 3, generator=gen)
    draws = (torch.randn(2, generator=gen), torch.rand(2, generator=gen))
    moved = torch.nextafter(images, torch.full_like(images, 2.0))
    moved_model = copy.deepcopy(model)
    with torch.no_grad():
        for p in moved_model.parameters():
            p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))

    def run(m, x, d):
        with torch.no_grad():
            out = m(x, draws=d)
            return {"encode": m.encode(x).float().cpu(),
                    **{k: v.float().cpu() for k, v in out["logs"]["scalar"].items()}}

    cpu, cpu_moved = run(model, images, draws), run(moved_model, moved, draws)
    del moved_model
    card = run(model.to(DEV), images.to(DEV), tuple(d.to(DEV) for d in draws))
    for k in ("encode", "total", "latent", "support"):
        miss = float((card[k] - cpu[k]).abs().max())
        spread = float((cpu_moved[k] - cpu[k]).abs().max())
        floor = 4 * spread + TIVIT_CARD_REL[k] * float(cpu[k].abs().max())
        print(f"pretrain: f32 TIViT {k} card vs CPU: max|diff| {miss:.4g}, floor {floor:.4g} "
              f"(the CPU's one-ulp spread {spread:.4g}; max|CPU| "
              f"{float(cpu[k].abs().max()):.4g}) {'ok' if miss <= floor else 'FAIL'}")
        if not miss <= floor:
            fail(f"pretrain: the card's f32 TIViT {k} is further from the CPU's than the floor")
    del model
    release(torch)


def count_collectives(torch):
    """Wrap ``torch.distributed.all_reduce`` so that it counts its calls and
    bytes; returns the counter (a dict) and a function that unwraps it."""
    import torch.distributed as dist

    real = dist.all_reduce
    counter = {"calls": 0, "bytes": 0}

    def counted(tensor, *args, **kwargs):
        counter["calls"] += 1
        counter["bytes"] += tensor.numel() * tensor.element_size()
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counted

    def restore():
        dist.all_reduce = real

    return counter, restore


def tp_model(torch, tp):
    """The flagship Poser as ``cli.finetune --tp`` builds it (the eager path
    for ``tp`` > 1), seeded f32 weights, on the card."""
    from cs_vit_tpu_torch.cli.common import build_model
    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.models import init_poser_weights

    cfg = FinetuneConfig(exp="chip_smoke", backbone=BACKBONE, img_size=IMG, phase="spatial",
                         tp=tp)
    model = build_model(cfg)
    init_poser_weights(model, 0)
    return model.to(DEV)


def tp_steps(torch, state, step, batch):
    """TP_STEPS f32 steps on `batch`, the droppath generator reseeded to
    TP_SEED before each: (losses, grad norms, step ms, the last step's peak
    device memory above the resident)."""
    gen = torch.Generator(device=DEV)
    losses, norms, times, peak = [], [], [], None
    for i in range(TP_STEPS):
        gen.manual_seed(TP_SEED)
        sync(torch)
        if i == TP_STEPS - 1 and DEV == "cuda":
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = step(state, batch, gen)
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    if DEV == "cuda":
        peak = torch.cuda.max_memory_allocated() - resident
    return losses, norms, times, peak


def tp_rank(rank: int, port: str, work: str) -> int:
    """One of two gloo ranks on the one card (``chip_smoke.py --tp-rank RANK
    PORT WORK DEV BACKBONE IMG``): the flagship Poser sharded at ``tp`` = 2
    (a (1, 2) mesh), TP_STEPS f32 steps on the b8 batch with the droppath
    generator reseeded to TP_SEED before each, the collectives of the last
    step counted; then its replicated tensors against rank 0's (broadcast),
    and rank 0 writes the whole parameters after the steps. Writes
    WORK/tp<RANK>.pt."""
    import torch
    import torch.distributed as dist

    from cs_vit_tpu_torch.parallel import make_mesh
    from cs_vit_tpu_torch.parallel import tp
    from cs_vit_tpu_torch.train import TrainState, build_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    mesh = make_mesh(n_model=2)
    model = tp_model(torch, 2)
    specs = tp.shard_model(model, mesh)
    opt = build_optimizer(model, "spatial", TRAIN_LR)
    tp.shard_optimizer(opt, model, mesh)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, "spatial", mesh=mesh)
    batch = train_batch(torch, 8, seed=10)
    counter = {}

    def counted_step(state, batch, gen):
        nonlocal counter
        counter, restore = count_collectives(torch)
        try:
            return step(state, batch, gen)
        finally:
            restore()

    losses, norms, times, peak = tp_steps(torch, state, counted_step, batch)
    local = model.state_dict()
    differ = []
    for name, t in local.items():
        if specs.get(name) is None:
            ref = t.clone()
            dist.broadcast(ref, src=0)
            if not torch.equal(ref, t):
                differ.append(name)
    full = tp.gather_state_dict({k: v.detach() for k, v in model.named_parameters()}, specs,
                                mesh)
    out = {"losses": losses, "norms": norms, "times": times, "peak": peak,
           "collectives": counter, "replicated": sum(s is None for s in specs.values()),
           "sharded": sum(s is not None for s in specs.values()), "differ": differ}
    if rank == 0:
        out["params"] = {k: v.detach().cpu() for k, v in full.items()}
    torch.save(out, f"{work}/tp{rank}.pt")
    dist.destroy_process_group()
    return 0


def tensor_parallel(torch):
    """Phase tp: two gloo ranks on the one card (NCCL refuses two ranks on
    one device) run the flagship f32 spatial step at ``tp`` = 2, b8, TF32
    off, TP_STEPS steps (``tp_rank``), held against the one-process eager
    step on the same batch and droppath draws: each step's loss and grad
    norm, and every parameter after the steps, within TP_FLOOR times the
    larger of what the one-process kernel step misses the eager step by and
    what the eager step moves by when the images move by one ulp (a floor
    measured here); the replicated tensors of the two ranks bit-identical."""
    import os
    import os.path as osp
    import shutil

    work = osp.abspath(TP_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    run_ranks("--tp-rank", work, TP_TIMEOUT, "tp")
    ranks = [torch.load(osp.join(work, f"tp{r}.pt"), weights_only=True) for r in range(2)]

    from cs_vit_tpu_torch.train import TrainState, build_optimizer, make_train_step

    one = {}
    for name, impl in (("eager", "eager"), ("fused", "fused"), ("moved", "eager")):
        model = tp_model(torch, 1)
        model.backbone.set_attention_impl(impl)
        state = TrainState.create(model, build_optimizer(model, "spatial", TRAIN_LR))
        step = make_train_step(model, state.optimizer, "spatial")
        batch = train_batch(torch, 8, seed=10)
        if name == "moved":  # the images one ulp up
            batch["patches"] = torch.nextafter(batch["patches"],
                                               torch.full_like(batch["patches"], 2.0))
        losses, norms, times, peak = tp_steps(torch, state, step, batch)
        one[name] = {"losses": losses, "norms": norms, "times": times, "peak": peak,
                     "params": {k: v.detach().cpu() for k, v in model.named_parameters()}}
        del model, state, step
        release(torch)
    eager, got = one["eager"], ranks[0]

    def misses(a):
        """(loss, grad norm, parameters): `a`'s largest miss of the eager step."""
        return (max(abs(x - y) for x, y in zip(a["losses"], eager["losses"])),
                max(abs(x - y) for x, y in zip(a["norms"], eager["norms"])),
                max(float((a["params"][k] - v).abs().max()) for k, v in eager["params"].items()))

    ok = True
    for name, miss, kernel, moved in zip(("loss", "grad_norm", "params"), misses(got),
                                         misses(one["fused"]), misses(one["moved"])):
        floor = TP_FLOOR * max(kernel, moved)
        good = miss <= floor
        ok &= good
        print(f"tp: f32 {name} over {TP_STEPS} steps, tp=2 vs the one-process eager step: "
              f"max|diff| {miss:.4g}, floor {floor:.4g} ({TP_FLOOR} x the larger of the "
              f"one-process kernel step's miss {kernel:.4g} and the eager step's own with the "
              f"images one ulp up {moved:.4g}) {'ok' if good else 'FAIL'}")
    same = not ranks[0]["differ"] and not ranks[1]["differ"]
    print(f"tp: {got['replicated']} replicated and {got['sharded']} sharded parameters; "
          f"replicated tensors bit-identical on both ranks: {same}; losses {got['losses']} "
          f"(one process, eager {eager['losses']}, kernel {one['fused']['losses']})")
    if not (ok and same):
        fail("tp: the tp=2 step disagrees with the one-process step, or the model peers' "
             f"replicated tensors differ ({ranks[1]['differ'][:5]})")
    card = nvidia_smi_line() if DEV == "cuda" else "the CPU"
    for r, rank in enumerate(ranks):
        c = rank["collectives"]
        print(f"tp_step_ms_b8_tp2 rank {r}: {statistics.median(rank['times'][1:]):.3f} (median of "
              f"{TP_STEPS - 1} after the first; f32), peak {gib(rank['peak'])} above the "
              f"resident, {c['calls']} all-reduces a step ({c['bytes'] / 2**20:.1f} MiB) on "
              f"{card}")
    fused = one["fused"]
    print(f"tp: the one-process f32 b8 step: eager {statistics.median(eager['times'][1:]):.3f} "
          f"ms, peak {gib(eager['peak'])}; kernel {statistics.median(fused['times'][1:]):.3f} "
          f"ms, peak {gib(fused['peak'])}")
    shutil.rmtree(work)


def pretrain_args(mode: str, root: str = "none"):
    from cs_vit_tpu_torch.cli import pretrain_ti

    return pretrain_ti.build_argparser().parse_args(
        ["--exp", f"chip_smoke_{mode}", "--mode", mode, "--data_root", root, "--device", DEV]
        + PRETRAIN_ARGS)


def pretrain_run(torch, mode, args):
    """(run, step) of `mode` as ``cli.pretrain_ti`` sets it up, on the card."""
    from cs_vit_tpu_torch.cli import pretrain_ti

    if mode == "tivit":
        run = pretrain_ti.tivit_setup(args, torch.device(DEV))
        return run, pretrain_ti.make_tivit_step(run)
    run = pretrain_ti.dino_setup(args, torch.device(DEV))
    return run, pretrain_ti.make_dino_step(run, args.teacher_momentum)


def pretrain_result(run, mode, loss, logs):
    """What a pretraining step is held by: the loss, the logs, the grads of
    the trained parameters, the transformation group's statistics, the
    centre (on the CPU)."""
    module = run["model"] if mode == "tivit" else run["student"]
    stats = run["model"].trans_grp if mode == "tivit" else run["trans"]
    return {"loss": float(loss), "logs": {k: float(v) for k, v in logs.items()},
            "grads": {n: p.grad.detach().cpu() for n, p in module.named_parameters()
                      if p.grad is not None},
            "stats": {n: b.detach().cpu() for n, b in stats.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
            "center": run["center"].detach().cpu() if mode != "tivit" else None}


def pretrain_rank(rank: int, port: str, work: str) -> int:
    """One of two gloo ranks on the one card (``chip_smoke.py --pretrain-rank
    RANK PORT WORK DEV BACKBONE IMG``): a step of ``tivit`` and of ``dino`` at
    the parent's widths (WORK/images.pt holds its PRETRAIN_ARGS) on its half
    of the images there, the draws of the whole batch from the generator the
    one-process step drew from; writes WORK/pretrain<RANK>.pt."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    global PRETRAIN_ARGS
    payload = torch.load(f"{work}/images.pt", weights_only=True)
    images, PRETRAIN_ARGS = payload["images"], payload["args"]
    half = images.shape[0] // 2
    mine = images[rank * half:(rank + 1) * half].to(DEV)
    out = {}
    for mode in ("tivit", "dino"):
        run, step = pretrain_run(torch, mode, pretrain_args(mode))
        sync(torch)
        t0 = time.perf_counter()
        loss, logs = step(mine, torch.Generator(device=DEV).manual_seed(1))
        sync(torch)
        out[mode] = {**pretrain_result(run, mode, loss, logs),
                     "ms": (time.perf_counter() - t0) * 1e3}
        del run, step
        release(torch)
    torch.save(out, f"{work}/pretrain{rank}.pt")
    dist.destroy_process_group()
    return 0


def pretrain_world(torch, images):
    """Two gloo ranks on the one card, each a ``tivit`` and a ``dino`` step on
    half of the b64 batch (``pretrain_rank``), held against the one-process
    step on the whole batch: the loss, the logs, every trained grad, the
    transformation group's statistics and the centre within four times the
    one-process step's own spread when the images move by one ulp plus a
    share of the value (PRETRAIN_WORLD_REL); the centre equal on both
    ranks."""
    import os
    import os.path as osp
    import shutil

    B = images.shape[0]
    work = osp.abspath(PRETRAIN_DIR + "_world")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.save({"images": images.cpu(), "args": PRETRAIN_ARGS}, osp.join(work, "images.pt"))
    ref, spread = {}, {}
    moved = torch.nextafter(images, torch.full_like(images, 2.0))
    for mode in ("tivit", "dino"):
        results = []
        for x in (images, moved):
            run, step = pretrain_run(torch, mode, pretrain_args(mode))
            results.append(pretrain_result(run, mode, *step(
                x, torch.Generator(device=DEV).manual_seed(1))))
            del run, step
            release(torch)
        ref[mode], spread[mode] = results
    run_ranks("--pretrain-rank", work, TP_TIMEOUT, "pretrain")
    ranks = [torch.load(osp.join(work, f"pretrain{r}.pt"), weights_only=True) for r in range(2)]
    card = nvidia_smi_line() if DEV == "cuda" else "the CPU"
    for mode in ("tivit", "dino"):
        want, moved_r = ref[mode], spread[mode]
        rows = [("loss", ranks[0][mode]["loss"], want["loss"], moved_r["loss"], "loss")]
        rows += [(f"logs.{k}", ranks[0][mode]["logs"][k], v, moved_r["logs"][k], "loss")
                 for k, v in want["logs"].items()]
        rows += [(f"grad {n}", ranks[0][mode]["grads"][n], g, moved_r["grads"][n], "grad")
                 for n, g in want["grads"].items()]
        rows += [(f"stat {n}", ranks[0][mode]["stats"][n], s, moved_r["stats"][n], "stat")
                 for n, s in want["stats"].items()]
        if want["center"] is not None:
            rows.append(("centre", ranks[0][mode]["center"], want["center"], moved_r["center"],
                         "stat"))
        worst, bad = (0.0, ""), []
        for name, got, w, m, kind in rows:
            got, w, m = (torch.as_tensor(v).double() for v in (got, w, m))
            miss = float((got - w).abs().max())
            floor = 4 * float((m - w).abs().max()) + PRETRAIN_WORLD_REL[kind] * float(
                w.abs().max())
            ratio = miss / floor if floor > 0 else (0.0 if miss == 0 else math.inf)
            worst = max(worst, (ratio, name))
            if not miss <= floor:
                bad.append(f"{name} {miss:.3g} > {floor:.3g}")
        centres_equal = want["center"] is None or torch.equal(ranks[0][mode]["center"],
                                                             ranks[1][mode]["center"])
        print(f"pretrain: two gloo ranks, {mode} b{B // 2} x 2 vs one process b{B}: {len(rows)} "
              f"values "
              f"(loss, logs, {len(want['grads'])} grads, statistics"
              f"{', centre' if want['center'] is not None else ''}), worst miss / floor "
              f"{worst[0]:.3f} ({worst[1]}); loss {ranks[0][mode]['loss']:.6f} / "
              f"{ranks[1][mode]['loss']:.6f} vs {want['loss']:.6f}; centres equal on both ranks "
              f"{centres_equal}")
        print(f"pretrain_{mode}_two_rank_step_ms_b{B // 2}x2 {ranks[0][mode]['ms']:.3f} / "
              f"{ranks[1][mode]['ms']:.3f} (rank 0 / 1, one step, f32) on {card}")
        if bad or not centres_equal:
            fail(f"pretrain {mode}: two ranks disagree with the one-process step: {bad[:5]}")
    shutil.rmtree(work)


def tools(torch):
    """Phase tools: ``tools.demo`` on its synthetic frame (the default
    ``swinv2-tiny-256`` config, random weights) writes its PNG; ``trace`` of
    one served b8 forward of the flagship Poser through ``PoserSession``
    holds the whole-block kernels (TRACE_KERNELS) and an ``annotate`` span."""
    import os
    import os.path as osp
    import shutil

    import cv2
    import numpy as np

    from cs_vit_tpu_torch.config import FinetuneConfig
    from cs_vit_tpu_torch.serving import PoserSession
    from cs_vit_tpu_torch.tools import demo
    from cs_vit_tpu_torch.utils import annotate, trace

    work = osp.abspath(TOOLS_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    png = osp.join(work, "demo.png")
    out, _ = printed(demo.main, ["--out", png, "--device", DEV])
    img = cv2.imread(png)
    if img is None or img.shape != (256, 256, 3) or not np.isfinite(out["joint_cam"]).all():
        fail(f"tools: demo wrote {None if img is None else img.shape}, joint_cam finite "
             f"{np.isfinite(out['joint_cam']).all()}")
    print(f"tools: demo on the synthetic frame wrote a {img.shape} PNG; wrist "
          f"{out['joint_cam'][0]} mm")
    cfg = FinetuneConfig(exp="chip_smoke", backbone=BACKBONE, img_size=IMG,
                         phase="inference", attention_impl="auto")
    session = PoserSession(cfg, batch_size=8, dtype="bfloat16", device=DEV)
    req = crop_requests(np.random.default_rng(0))(8)
    session.predict_crops(*req)
    sync(torch)
    with trace(osp.join(work, "trace")) as prof:
        with annotate("chip_smoke_serve_b8"):
            session.predict_crops(*req)
            sync(torch)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [str(e.get("name", "")) for e in events]
    found = {k: sum(k in n for n in names) for k in TRACE_KERNELS + ("chip_smoke_serve_b8",)}
    print(f"tools: trace of one served b8 forward ({len(events)} events, "
          f"{osp.getsize(prof.trace_path) / 2**20:.1f} MiB): {json.dumps(found)}")
    if (DEV == "cuda" and not all(found.values())) or not found["chip_smoke_serve_b8"]:
        fail(f"tools: the trace lacks a kernel or the annotate span: {found}")
    del session
    release(torch)
    shutil.rmtree(work)


def cfg_depths(cfg):
    from cs_vit_tpu_torch.cli.common import poser_config_from

    return poser_config_from(cfg).swin_config().depths


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
    """Phase 8: the temporal step at batch B over T frames, only the temporal
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


def profile_step(torch, state, step, batch, median_ms, tag="profile step", latent=False):
    """Device busy time and idle share of one bf16 b8 step (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEV).manual_seed(8)
    lgen = latent_generator(torch, 9) if latent else None
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, gen, lgen)
        sync(torch)
        wall = (time.perf_counter() - t0) * 1e3
    busy, kernels, ops = device_profile(torch, prof)
    if busy == 0:
        print(f"{tag}: no device time recorded (not measured)")
        return None
    idle = max(0.0, 1 - busy / median_ms)
    print(f"{tag}: b8 step wall {wall:.3f} ms (profiled), device busy {busy:.3f} ms "
          f"({sum(r[1] for r in kernels)} kernels), idle share against the unprofiled median "
          f"{median_ms:.3f} ms: {idle:.3f}")
    print_profile(tag, kernels, ops, n=16)
    print_ln_profile(tag, kernels, ops)
    return idle


# the LayerNorm kernels and the second pass of the other backward kernels'
# cross-block sums, as a profile names them
LN_PROFILE_KERNELS = {"ln_residual": r"ln_residual_kernel",
                      "ln_residual_bwd": r"ln_residual_bwd_kernel",
                      "sum_splits": r"sum_splits_kernel"}


def print_ln_profile(tag, kernels, ops):
    """One profile's device launches and ms of the LayerNorm kernels and of
    sum_splits (the cross-block sums of gemm_wgrad and the attention
    backward; ln_residual_bwd sums its own), and the device ms of
    FusedSwinBlockBackward."""
    parts = []
    for name, pattern in LN_PROFILE_KERNELS.items():
        rows = [r for r in kernels if re.search(pattern, r[2])]
        parts.append(f"{name} x{sum(r[1] for r in rows)} {sum(r[0] for r in rows):.3f} ms")
    bwd = [r for r in ops if r[2] == "FusedSwinBlockBackward"]
    parts.append(f"FusedSwinBlockBackward {sum(r[0] for r in bwd):.3f} ms device")
    print(f"{tag}: " + ", ".join(parts))


def time_bwd_kernels(torch, fb, F, B=8, iters=10):
    """Phase 10: the backward kernels at a bf16 b8 step's shapes, per step
    (summed over the 24 blocks), beside their plain versions, one library call
    each (yardsticks: torch.matmul, autograd of F.layer_norm and of SDPA with
    a float mask) and their bounds; gemm_dgrad, gemm_wgrad,
    ln_residual_bwd and swin_window_attn_bwd and their library calls also
    queued (queued_ms; ln_residual_bwd's inputs L2-cold;
    gemm_dgrad's torch.matmul is handed dY already in bf16, so its byte
    floor is lower than the kernel's, which reads f32 dY). Prints the attention
    backward's scratch bytes per call and gemm_wgrad's split-partial bytes."""
    bf, f32 = torch.bfloat16, torch.float32
    names = ("gemm_dgrad", "gemm_wgrad", "ln_residual_bwd", "swin_window_attn_bwd")
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_s": 0.0, "flops_s": 0.0,
               "bound_ms": 0.0} for k in names}
    for k in ("gemm_dgrad", "gemm_wgrad", "ln_residual_bwd", "swin_window_attn_bwd"):
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

    for geom in GEOMS:
        stage, res, C, heads, ws, shift, n_blocks = geom
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
            nbytes = ln_residual_bwd_bytes(M, C, g.element_size(), B)
            add("ln_residual_bwd", n_blocks,
                lambda: fb.ln_residual_bwd(z, g, gamma, dp, col, 1e-5),
                lambda: fb.ln_residual_bwd_reference(z, g, gamma, dp, col, 1e-5),
                lambda: torch.autograd.grad(yl, (zl, wl, bl), g32, retain_graph=True),
                nbytes, 12 * M * C, PEAK_FLOPS["f32"], f"M{M} C{C} {what}")
        queued_ln_residual_bwd(torch, fb, F, tot["ln_residual_bwd"], geom, B, seed=600 + stage)
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
    """Phase 9: the probe kernel against its plain version in its three modes
    at the probe's own shapes (a of 512 rows) and at PROBE_ROWS's others;
    returns the worst max_abs."""
    from cs_vit_tpu_torch.tools.probe_overlap import make_inputs

    worst = 0.0
    for rows in PROBE_ROWS:
        a, w, x = make_inputs(DEV, rows=rows)
        for mode in po.MODES:
            acc, vec = po.probe_overlap(a, w, x, mode)
            racc, rvec = po.probe_overlap_reference(a, w, x, mode)
            sync(torch)
            err_a, rel_a = rel_err(acc, racc)
            err_v = (vec - rvec).abs().max().item()
            rel_v = ((vec - rvec).abs() / rvec.abs().clamp_min(1e-30)).max().item()
            ok = rel_a <= PROBE_TOL["acc"] and rel_v <= PROBE_TOL["vec"]
            print(f"check probe {mode} M{rows}: acc max_abs={err_a:.3e} rel={rel_a:.3e} "
                  f"tol={PROBE_TOL['acc']:.0e}; vec max_abs={err_v:.3e} max rel={rel_v:.3e} "
                  f"tol={PROBE_TOL['vec']:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"probe_overlap ({mode}, M {rows}) disagrees with its plain version")
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
    plan = po.probe_plan(po.N)
    print(f"probe bound: products {mma:.4f} ms at {PEAK_FLOPS['bf16'] / 1e12:.0f} TFLOP/s, exp "
          f"{exp:.4f} ms at {SFU_PER_CLOCK_PER_SM} x {sms} SMs x {clock_hz / 1e6:.0f} MHz, bytes "
          f"{tb:.4f} ms; w read from L2 {plan.w_l2_bytes * repeats / 2**30:.3f} GiB a call "
          f"(not in the bound)")
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
    from cs_vit_tpu_torch.ops import multi_tensor as mt
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
            serial = [ln.strip() for ln in (log.read_text().splitlines() if log.exists() else ())
                      if WGMMA_SERIAL_RE.search(ln)]
            for line in serial:
                print(f"ptxas {name}: {line}")
            if serial:
                fail(f"ptxas serialized wgmma instructions in {name}")

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
        times, train_counts, spatial_peak = train_curve(torch, Launches(fb, mt), state, step,
                                                        batch, TRAIN_STEPS)
        update_row = check_update(torch, mt, state)
        check_nan_skip(torch, state, step, batch)
        expect = dict(train_expect(sum(model.backbone.config.depths)), **UPDATE_EXPECT)
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

    with phase("spenc"):
        spenc(torch, fb)

    have = {m: importlib.util.find_spec(m) is not None for m in FILE_LIBS}
    with phase("lifecycle"):
        lifecycle(torch, launches, have, step_ms)

    with phase("datasets"):
        datasets(torch, launches, have, step_ms)

    with phase("parallel"):
        parallel(torch, fb, have, step_ms)

    with phase("tp"):
        tensor_parallel(torch)

    with phase("pretrain"):
        pretrain(torch, have)

    with phase("tools"):
        tools(torch)

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
              f"perfect overlap {probe_ms['overlap']:.4f} ms, overlap share "
              f"{probe_ms['share']:.3f}")
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
    kernels.append(update_row)
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


RANK_ENTRIES = {"--dp-rank": "dp_rank", "--tp-rank": "tp_rank",
                "--pretrain-rank": "pretrain_rank"}

if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in RANK_ENTRIES:
        DEV, BACKBONE, IMG = sys.argv[5], sys.argv[6], int(sys.argv[7])
        sys.exit(globals()[RANK_ENTRIES[sys.argv[1]]](int(sys.argv[2]), sys.argv[3],
                                                      sys.argv[4]))
    sys.exit(main())
