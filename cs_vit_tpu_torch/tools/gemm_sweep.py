"""Tiles, rings and host cost of the two planned bf16 GEMMs, gemm_bias_act
and gemm_dgrad, on the card.

    python cs_vit_tpu_torch/tools/gemm_sweep.py             # everything below
    python cs_vit_tpu_torch/tools/gemm_sweep.py --planned-only --root DIR
    python cs_vit_tpu_torch/tools/gemm_sweep.py --host-only --root DIR

1. Builds the kernels, fails on a spill of their wgmma instantiations and
   prints any ptxas note that it serialised a kernel's wgmma.
2. Checks every tile of fused_block.GEMM_TILES with the fewest and the most
   stages its ring may hold against the plain versions at
   chip_smoke.GEMM_EDGE_SHAPES (chip_smoke.TOL).
3. Times each kernel at every GEMM shape of a Swin-B-256 b8 step (the
   block's four forward products and four input grads at each stage, once
   per block) with each tile and ring size forced, with the planned one,
   and its library call (torch.addmm; torch.matmul on dY already in bf16),
   all queued behind a sleep kernel (device time, chip_smoke.queued_ms),
   and prints the sums per b8 forward or step.
4. Reads the host's cost of one wrapper call, as the served forward and the
   step issue them: the wall time of HOST_CALLS calls of fused_block's
   gemm_bias_act and gemm_dgrad at a stage-2 shape, and of their C entry
   points alone, queued behind a sleep kernel so that the card never holds
   the host back.

--planned-only runs step 3 with the planned tiles alone and step 4;
--host-only step 4 alone. --root DIR imports cs_vit_tpu_torch from another
checkout (an older tree, to compare it with this one in turns in one run
on the card). Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

HOST_CALLS = 96
BLOCKS = {0: 2, 1: 2, 2: 18, 3: 2}  # Swin-B blocks per stage
STAGES_TRIED = (2, 3, 4, 5, 6, 8)
ONE_BLOCK_RING_BYTES = 224 * 1024  # a ring that leaves an SM to one block


def host_us(torch, fb, M=2048, C=512):
    """Host microseconds per call of gemm_bias_act and gemm_dgrad (bf16, a
    stage-2 shape: [M, C] . [C, 4C] and dY [M, C] . W[4C, C]^T): through
    the wrapper, and of the C entry point alone with the wrapper's
    arguments."""
    bf = torch.bfloat16
    a = torch.randn(M, C, device="cuda").to(bf)
    w = torch.randn(C, 4 * C, device="cuda").to(bf)
    b = torch.randn(4 * C, device="cuda").to(bf)
    dy = torch.randn(M, C, device="cuda")
    w2 = torch.randn(4 * C, C, device="cuda").to(bf)
    m1 = torch.randn(M, 4 * C, device="cuda").to(bf)
    calls = {"gemm_bias_act": ("fused_block", lambda: fb.gemm_bias_act(a, w, b, "gelu")),
             "gemm_dgrad": ("fused_block_bwd",
                            lambda: fb.gemm_dgrad(dy, w2, m1, "gelu", torch.float32))}

    def best_us(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(5):
            torch.cuda._sleep(2_000_000_000)  # ~1 s at the H100's clock
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            best = min(best, (time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        return best

    out = {}
    for name, (lib_name, fn) in calls.items():
        lib = fb._lib(lib_name)
        entry, seen = getattr(lib, name), []
        setattr(lib, name, lambda *args: seen.append(args) or entry(*args))
        fn()  # records the C entry's arguments
        setattr(lib, name, entry)
        out[name] = best_us(fn)
        out[name + " entry"] = best_us(lambda: entry(*seen[0]))
        print(f"host {name}: {out[name]:.2f} us a call, of which the C entry "
              f"{out[name + ' entry']:.2f} (best of 5 x {HOST_CALLS} calls)", flush=True)
    return out


def step_shapes():
    """(kind, stage, M, output columns, reduction, activation or epilogue,
    aux dtype name, out dtype name) of a Swin-B-256 b8 step's GEMMs, as the
    fused block runs them."""
    out = []
    for stage, res, C in ((0, 64, 128), (1, 32, 256), (2, 16, 512), (3, 8, 1024)):
        M = 8 * res * res
        out += [("fwd", stage, M, 3 * C, C, "none", None, "bf16"),
                ("fwd", stage, M, C, C, "none", None, "f32"),
                ("fwd", stage, M, 4 * C, C, "gelu", None, "bf16"),
                ("fwd", stage, M, C, 4 * C, "none", None, "f32"),
                ("dgrad", stage, M, 4 * C, C, "gelu", "bf16", "f32"),
                ("dgrad", stage, M, C, 4 * C, "add", "bf16", "f32"),
                ("dgrad", stage, M, C, C, "none", None, "bf16"),
                ("dgrad", stage, M, C, 3 * C, "add", "f32", "bf16")]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="checkout to import cs_vit_tpu_torch from")
    ap.add_argument("--planned-only", action="store_true",
                    help="step 3 with the planned tiles alone, and step 4")
    ap.add_argument("--host-only", action="store_true", help="step 4 alone")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from cs_vit_tpu_torch.ops import _build
    from cs_vit_tpu_torch.ops import fused_block as fb

    if not torch.cuda.is_available():
        raise SystemExit("gemm_sweep needs a CUDA card")
    import chip_smoke as cs

    print(cs.nvidia_smi_line(), flush=True)
    _build.build()
    if args.host_only:
        print(json.dumps({"host_us": host_us(torch, fb)}))
        return
    for name in () if args.planned_only else ("fused_block", "fused_block_bwd"):
        path = _build.library_path(name)
        log = path.with_name(path.name + ".log").read_text()
        cs.check_tc_spills(name, log)
        for line in log.splitlines():
            if re.search(r"wgmma.*serializ|serializ.*wgmma", line, re.I):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    planned = getattr(fb, "_gemm_plan", None)  # none in the WMMA kernels' tree

    def ring_sizes(kernel, tile):
        """The stage counts tried with `tile`: those whose ring fits the
        shared memory of one block an SM."""
        return [s for s in STAGES_TRIED
                if s * fb._gemm_stage_bytes(kernel, *tile) <= ONE_BLOCK_RING_BYTES]

    def forced(tile, stages):
        """A plan of `tile` and `stages` stages, or as many as fit."""
        return lambda kernel, M, N, R, sms: (*tile, min(
            stages, ring_sizes(kernel, tile)[-1], max(1, -(-R // fb.GEMM_DEPTH))))

    # 2: correctness of every forced tile with the fewest and the most stages
    for tile in () if args.planned_only else fb.GEMM_TILES:
        for stages in (STAGES_TRIED[0], STAGES_TRIED[-1]):
            fb._gemm_plan = forced(tile, stages)
            res = cs.gemm_edge_checks(torch, fb, "bf16")
            fb._gemm_plan = planned
            bad = [r for r in res if not r[3] <= r[4]]
            print(f"check tile {tile[0]}x{tile[1]} stages {stages}: {len(res)} checks, "
                  f"{len(bad)} failed, worst rel {max(r[3] for r in res):.3e}", flush=True)
            if bad:
                cs.fail(f"gemm_sweep: tile {tile} stages {stages}: {bad[:3]}")

    # 3: queued device time by shape, forced and planned
    gen = torch.Generator().manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    dts = {"bf16": bf, "f32": f32}
    totals = {}
    for kind, stage, M, n_out, R, op, aux_dt, out_dt in step_shapes():
        if kind == "fwd":
            a = torch.randn(M, R, generator=gen).to("cuda", bf)
            w = (torch.randn(R, n_out, generator=gen) * R ** -0.5).to("cuda", bf)
            b = torch.randn(n_out, generator=gen).to("cuda", bf)
            kernel = "gemm_bias_act"
            fn = lambda a=a, w=w, b=b, op=op, odt=dts[out_dt]: fb.gemm_bias_act(a, w, b, op, odt)
            lib = lambda a=a, w=w, b=b: torch.addmm(b, a, w)
        else:
            dy = torch.randn(M, R, generator=gen).to("cuda")
            w = (torch.randn(n_out, R, generator=gen) * R ** -0.5).to("cuda", bf)
            aux = None if aux_dt is None else torch.randn(M, n_out, generator=gen).to(
                "cuda", dts[aux_dt])
            dyb = dy.to(bf)
            kernel = "gemm_dgrad"
            fn = lambda dy=dy, w=w, aux=aux, op=op, odt=dts[out_dt]: fb.gemm_dgrad(
                dy, w, aux, op, odt)
            lib = lambda dyb=dyb, w=w: torch.matmul(dyb, w.t())
        row = {}
        for tile in () if args.planned_only else fb.GEMM_TILES:
            for stages in ring_sizes(kernel, tile):
                fb._gemm_plan = forced(tile, stages)
                row[f"{tile[0]}x{tile[1]}s{stages}"] = cs.queued_ms(torch, fn)[0]
        fb._gemm_plan = planned
        plan = planned(kernel, M, n_out, R, fb._sm_count(w)) if planned else ("?", "?", "?")
        ms, lib_ms = cs.queued_ms(torch, fn)[0], cs.queued_ms(torch, lib)[0]
        row = row or {"planned": ms}
        best = min(row, key=row.get)
        print(f"time {kind} stage {stage} M {M} out {n_out} R {R} {op}: planned "
              f"{plan[0]}x{plan[1]}s{plan[2]} {ms * 1e3:.2f} us, best {best} "
              f"{row[best] * 1e3:.2f} us, library {lib_ms * 1e3:.2f} us | "
              + " ".join(f"{k}:{v * 1e3:.2f}" for k, v in row.items()), flush=True)
        t = totals.setdefault(kind, {"planned_ms": 0.0, "best_ms": 0.0, "library_ms": 0.0,
                                     "forced_ms": {}})
        t["planned_ms"] += BLOCKS[stage] * ms
        t["best_ms"] += BLOCKS[stage] * row[best]
        t["library_ms"] += BLOCKS[stage] * lib_ms
        for k, v in row.items():
            t["forced_ms"][k] = t["forced_ms"].get(k, 0.0) + BLOCKS[stage] * v
    print(json.dumps({"per_b8": totals, "host_us": host_us(torch, fb)}))


if __name__ == "__main__":
    main()
