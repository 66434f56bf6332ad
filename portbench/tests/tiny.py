"""Cells of the benchmark at a size a CPU test holds: the test backbone
(embed 8, depths 1/1, window 4, img 32), two spatial and one temporal
layer, with the cells' own traffic kinds at small batches. The program
runs in f32 here (the eager path on the CPU), so it reads about 1e-4 mm
from the reference and gradient and change gaps of about 2e-5, and the
limits are set for that: far above it, and below every control and fault
reading at this size (the control reads 16 mm or more of a crop's mean
and 0.99 or more of ``grad``; the faults 0.38 or more of ``grad`` or
``grad_last``, or 1 of ``change_last``, and 160 mm or more of a crop's
mean; the cells' own limits are for bf16 at full size). A tiny cell
compares the numbers its full-size cell compares; a cell of several cards
runs in a gloo world of two processes (``world_worker``), whose ranks'
leaves have to stay equal to the bit (``ranks_apart`` 0)."""

from __future__ import annotations

import copy
import json

from portbench.cell import HERE, ROOT, load_cell

TINY_BACKBONE = {"name": "test", "embed_dim": 8, "depths": [1, 1], "num_heads": [2, 2],
                 "window_size": 4, "patch_size": 4, "mlp_ratio": 4.0, "drop_path_rate": 0.0,
                 "layer_norm_eps": 1e-5, "pretrained_window_sizes": [0, 0]}
TINY_PARAMS = {"train": {"batch": 4, "pool": 4, "calibration": 8, "keep_at": 5, "trace_units": 1},
               "batch": {"batch": 4, "pool": 2, "calibration": 8, "sample": 2, "trace_units": 1},
               "stream": {"batch": 1, "frames": 3, "frame_ms": 33.3, "track": 6,
                          "calibration": 8, "sample": 4, "trace_units": 2}}


TINY_LIMITS = {"joint_mean_mm": 1.0, "joint_mean_mm_last": 1.0, "grad_last": 0.01,
               "grad_blocks_last": 0.01, "change_last": 0.01, "crop_mean_mm": 1.0,
               "ranks_apart": 0.0}
# a cell of several cards runs in a world of two at this size
TINY_WORLD = 2


def tiny_cell(name: str, dtype: str = "float32"):
    """Cell `name` of BENCHMARK.json at the tiny size; the program in
    `dtype`."""
    bench = json.load(open(ROOT / "BENCHMARK.json"))
    workload = json.load(open(HERE / "workloads" / f"{name}.json"))
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == workload["config"])
    config = copy.deepcopy(json.load(open(ROOT / cfg_file)))
    config["model"].update(img_size=32, backbone=TINY_BACKBONE, num_spatial_layer=2,
                           num_temporal_layer=1)
    config["train"]["dtype"] = config["serve"]["dtype"] = dtype
    params = dict(TINY_PARAMS[workload["kind"]])
    if workload["params"].get("world", 1) > 1:
        params["world"] = TINY_WORLD
    workload = dict(workload, params=params,
                    limits={k: TINY_LIMITS[k] for k in workload["limits"]})
    return load_cell(name, bench, config, workload)
