"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's traffic driver builds the program
(cs_vit_tpu_torch) on the card from the seed and warms it up on the cell's
own shapes; then the window runs units (train steps or requests) for
`--seconds`, untraced; with ``--trace 1`` a few more units run under the
profiler; then the driver finishes (a train cell takes one more step
through the window's call, from a copy of its state kept on the host), the
program is freed, and the plain reference checks what the window and that
step produced: the numbers the workload file gives a limit. The last
stdout line is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit);
the last stderr lines give the same numbers. No card, or fewer cards than
the cell asks for: exit 2 and no result.

A cell on more than one card runs one process a card, started by
``torch.distributed.run`` (``portbench.world.launch``); rank 0 prints the
result alone, and set-up counts from the launcher's start. The ranks agree once,
before the window, on how many units fill ``--seconds`` at the slowest
rank's warm-up pace, and each runs that many; the peak is the fullest
card's, and a traced run's ``busy_s`` the ranks' mean.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cs_vit_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cell=None, fault: Optional[str] = None, t_start: float = T_START) -> Optional[dict]:
    """One run of cell `name` (or of the given `cell`); returns the result
    object (None on a rank other than 0). `fault`: the driver plants it after
    set-up, or puts the control in the program's place (the benchmark's own
    runs never do)."""
    import torch

    from . import tracing, world
    from .cell import driver_module, load_cell, reader

    cell = cell or load_cell(name)
    driver = driver_module(cell.kind).Driver(cell, seed, device)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    driver.setup()
    if fault is not None:
        driver.plant(fault)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ranks = world.size()
    # a world runs a number of units that all its ranks agree on
    count = max(1, round(seconds / world.agree(driver.pace))) if ranks > 1 else None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    units = []
    while (len(units) < count) if count else (time.perf_counter() - t0 < seconds):
        a = time.perf_counter()
        samples = driver.unit()
        units.append((samples, time.perf_counter() - a))
    sync()
    window_s = time.perf_counter() - t0
    peaks = world.gather(torch.cuda.max_memory_allocated() if cuda else 0)
    lead = world.rank() == 0
    peak = max(peaks) if lead else 0
    if lead and ranks > 1:
        print(f"peak bytes by rank: {peaks}", file=sys.stderr)
    window = {"units": units, "window_s": window_s, "setup_s": setup_s, "peak_bytes": peak}

    result_device = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name() if cuda else "cpu",
                     "count": ranks, "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    if trace:
        chrome, host_s = tracing.capture(driver.unit, driver.trace_units, driver.spans(),
                                         driver.optimizer())
        info = dict(driver.work(), unit_s=window_s / max(len(units), 1))
        tr = tracing.Trace(chrome, info)
        busy = world.gather(tr.busy_us() * 1e-6)
        if lead and ranks > 1:
            print(f"busy seconds by rank: {busy}", file=sys.stderr)
        if lead:
            for m in cell.per_layer:
                value = reader("layers", m["name"])(tr)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result_device.update(busy_s=sum(busy) / ranks, window_s=host_s)
            breakdown = {"device_ops": [list(x) for x in tr.top_device_ops()[:10]],
                         "idle_gaps": [list(x) for x in tr.idle_gaps()[:10]]}
    elif lead:
        for m in cell.end_to_end:
            value = reader("e2e", m["name"])(window)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    driver.finish()
    driver.release()
    if not lead:
        return None
    numbers = driver.check()
    # the numbers the workload file gives a limit are compared; the rest are kept beside
    info = numbers.pop("info", {})
    checks = {k: {"value": numbers.pop(k), "limit": v} for k, v in cell.limits.items()}
    info.update(numbers)
    correct = bool(units) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(units), "failed": 0, "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if info:
        out["readings"] = info
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # a library the program imports must not load JAX behind its back
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # one host thread for PyTorch's CPU ops: the work is on the card, and
    # idle OpenMP workers spinning beside the dispatching thread slowed a
    # request by about a sixth and spread the runs
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    from .cell import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from . import world

    if cell.chips > 1 and not world.launched():
        return world.launch(cell.chips, "portbench.run",
                            sys.argv[1:] if argv is None else argv, T_START)
    world.quiet()
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), cell=cell,
                      t_start=world.start_time(T_START))
    world.leave()
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    if result is None:  # a rank other than 0
        return 0
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
