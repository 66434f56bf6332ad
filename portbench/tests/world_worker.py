"""A run of a cell of several cards at the tiny size on the CPU, in a gloo
world of ``tiny.TINY_WORLD`` processes, as ``portbench.run`` drives one on
the cards: this process starts the ranks through ``torch.distributed.run``
(``portbench.world.launch``); each rank joins the program's world and runs
``run_cell``; rank 0 writes the result, with the samples each unit of the
window reported (``unit_samples``), to OUT as JSON, and this process adds
whether every rank exited with 0 (``ranks_ok``).

    python -m portbench.tests.world_worker CELL SEED FAULT TRACE OUT

FAULT ``-`` for none; TRACE 0 or 1.
"""

import json
import os
import sys
import time

import torch

from portbench import cell as cells
from portbench import world
from portbench.run import run_cell
from portbench.tests.tiny import TINY_WORLD, tiny_cell


def main():
    name, seed, fault, trace, out = sys.argv[1:6]
    if not world.launched():
        os.environ["OMP_NUM_THREADS"] = "1"
        code = world.launch(TINY_WORLD, "portbench.tests.world_worker", sys.argv[1:],
                            time.perf_counter())
        with open(out) as f:
            r = json.load(f)
        with open(out, "w") as f:
            json.dump(dict(ranks_ok=code == 0, **r), f)
        return
    world.quiet()
    torch.set_num_threads(1)
    seen = []
    reader = cells.reader

    def spy(folder, metric):  # the e2e readers see the window's units
        read = reader(folder, metric)
        if folder != "e2e":
            return read

        def reading(window):
            seen[:] = [n for n, _ in window["units"]]
            return read(window)

        return reading

    cells.reader = spy
    r = run_cell(name, int(seed), 0.2, trace == "1", device="cpu", cell=tiny_cell(name),
                 fault=None if fault == "-" else fault)
    world.leave()
    if r is not None:
        with open(out, "w") as f:
            json.dump(dict(unit_samples=seen, **r), f)


if __name__ == "__main__":
    main()
