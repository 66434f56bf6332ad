"""Device time of the two LayerNorm-residual kernels, ln_residual and
ln_residual_bwd, on the card.

    python cs_vit_tpu_torch/tools/ln_sweep.py               # this checkout
    python cs_vit_tpu_torch/tools/ln_sweep.py --root DIR    # another checkout's
    python cs_vit_tpu_torch/tools/ln_sweep.py --plans       # forced launch plans

Times both kernels at every Swin-B-256 block geometry (chip_smoke.GEOMS) at
batch 8, the block's two calls of each, beside their library calls
(``res + F.layer_norm``; autograd of ``F.layer_norm``): queued behind a
sleep kernel (device time, chip_smoke.queued_ms), each call's inputs rotated
through copies that together exceed the L2 (chip_smoke.l2_cold), so that
every call reads them from HBM. Prints the sums per b8 forward
(ln_residual) and per b8 step (ln_residual_bwd) beside each kernel's byte
bound, and its launch plan where the checkout has one.

--plans also times each kernel's block pair at each geometry under forced
launch plans (row groups per block and blocks an SM) beside the planned one
(fused_block._ln_plan). --root DIR imports cs_vit_tpu_torch from another
checkout (an older tree, to compare the two in turns in one run on the
card); chip_smoke comes from this checkout. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def forced_plans(torch, F, fb, cs, name, fn, geom, B, sms):
    """Device ms of one block's two calls of `name` at `geom` under each
    plan of (row groups, blocks an SM) the kernel takes, beside the planned
    one."""
    stage, res, C = geom[:3]
    M = B * res * res
    planned = fb._ln_plan
    lanes, chunks, _, _ = planned(name, M, C, sms)
    one = geom[:6] + (1,)
    for groups in (1, 2, 4, 8, 16):
        threads = groups * lanes
        if threads > fb.LN_THREADS or threads % 32 or (lanes > 32 and groups > 1):
            continue
        for per_sm in (1, 2, 4):
            blocks = min(-(-M // groups), per_sm * sms)
            plan = (lanes, chunks, groups, -(-blocks // fb.LN_CLUSTER) * fb.LN_CLUSTER)
            r = dict(cs.QUEUED_KEYS)
            fb._ln_plan = lambda *_, plan=plan: plan
            try:
                fn(torch, fb, F, r, one, B, seed=800 + stage)
            finally:
                fb._ln_plan = planned
            mark = " (planned)" if plan == planned(name, M, C, sms) else ""
            print(f"forced {name} stage{stage} M{M} C{C} groups {groups} blocks {plan[3]}: "
                  f"{r['queued_ms'] * 1e3:.2f} us a block{mark}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout to import cs_vit_tpu_torch from")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--plans", action="store_true", help="also time forced launch plans")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    import torch.nn.functional as F

    from cs_vit_tpu_torch.ops import _build
    from cs_vit_tpu_torch.ops import fused_block as fb

    if not torch.cuda.is_available():
        raise SystemExit("ln_sweep needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    print(cs.nvidia_smi_line(), flush=True)
    print(f"kernels from {Path(fb.__file__).resolve()}", flush=True)
    _build.build()
    B = args.batch
    plan = getattr(fb, "_ln_plan", None)  # none in the trees before the redesign
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    totals = {}
    for name, fn in (("ln_residual", cs.queued_ln_residual),
                     ("ln_residual_bwd", cs.queued_ln_residual_bwd)):
        r = dict(cs.QUEUED_KEYS, bound_ms=0.0)
        for geom in cs.GEOMS:
            stage, res, C, _, _, _, n_blocks = geom
            M = B * res * res
            if plan is not None:
                print(f"plan {name} stage{stage} M{M} C{C}: {plan(name, M, C, sms)}", flush=True)
            fn(torch, fb, F, r, geom, B, seed=700 + stage)
            if args.plans and plan is not None:
                forced_plans(torch, F, fb, cs, name, fn, geom, B, sms)
            nbytes = (cs.ln_residual_bytes(M, C, 2, True) + cs.ln_residual_bytes(M, C, 4, False)
                      if name == "ln_residual" else
                      cs.ln_residual_bwd_bytes(M, C, 2, B) + cs.ln_residual_bwd_bytes(M, C, 4, B))
            r["bound_ms"] += n_blocks * nbytes / cs.HBM_BYTES_PER_S * 1e3
        per = "forward" if name == "ln_residual" else "step"
        print(f"{name} per b{B} {per}: queued {r['queued_ms']:.4f} ms, library "
              f"{r['queued_library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes); "
              f"{r['bound_ms'] / r['queued_ms']:.3f} of the bound, "
              f"{r['queued_ms'] / r['queued_library_ms']:.3f}x the library"
              + (" (host gaps included)" if r["queued_host_gapped"] else ""), flush=True)
        totals[name] = r
    print(json.dumps({"per_b8": totals}))


if __name__ == "__main__":
    main()
