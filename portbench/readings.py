"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and the control's and each planted fault's, each run in turn in
one process (the kernels built once).

    python3 -m portbench.readings --workload <cell> --seeds 11,12 \
        --faults "control:21,22;half:31" --seconds 3 [--out portbench/out/readings.jsonl]

Each run is ``portbench.run.run_cell`` with a short window; in a fault run
the driver plants the fault after set-up, or puts the control in the
program's place. One JSON line a run. A cell on more than one card runs
the whole plan in one process a card (``portbench.world.launch``); rank 0
writes.
The benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--faults", default="", help="fault:seed,seed;fault:seed")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="portbench/out/readings.jsonl")
    args = p.parse_args(argv)
    import torch

    from . import world
    from .cell import load_cell
    from .run import run_cell

    chips = load_cell(args.workload).chips
    if chips > 1 and not world.launched():
        return world.launch(chips, "portbench.readings", sys.argv[1:] if argv is None else argv,
                            time.perf_counter())
    world.quiet()
    plan = [(None, int(s)) for s in args.seeds.split(",") if s]
    for part in filter(None, args.faults.split(";")):
        fault, seeds = part.split(":")
        plan += [(fault, int(s)) for s in seeds.split(",")]
    for fault, seed in plan:
        t = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, bool(args.trace), fault=fault,
                     t_start=time.perf_counter())
        if r is not None:  # rank 0
            line = json.dumps({"workload": args.workload, "fault": fault, "seed": seed,
                               "run_s": time.perf_counter() - t, **r})
            print(line, flush=True)
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    world.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
