"""A cell by name: its workload file, its configuration file, its traffic
kind's driver, and the metrics ``BENCHMARK.json`` asks of it.

    portbench/workloads/<cell>.json   configuration, traffic, kind, params, limits
    portbench/configs/<config>.json   the model as run, its source and cuts
    portbench/traffic/<kind>.py       the driver of a traffic kind
    portbench/layers/<metric>.py      a per-layer metric's reader (or the
                                      reader of its name's first part)
    portbench/e2e/<metric>.py         an end-to-end metric's reader
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    workload: dict        # the workload file
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.workload["kind"]

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def limits(self) -> Dict[str, Optional[float]]:
        return self.workload["limits"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None, config: Optional[dict] = None,
              workload: Optional[dict] = None) -> Cell:
    """The cell `name` of ``BENCHMARK.json``; `bench`, `config` and
    `workload` stand in for the files (tests)."""
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = workload if workload is not None else _json(HERE / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: the workload file and BENCHMARK.json disagree on its "
                         "configuration or traffic")
    if config is None:
        cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
        config = _json(ROOT / cfg_entry["file"])
    return Cell(name, entry["chips"], config, workload,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def _module(path: Path):
    tag = path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(kind: str):
    return _module(HERE / "traffic" / f"{kind}.py")


def reader(folder: str, metric: str):
    """The ``read`` function of `metric` in `folder`: its own file, or that
    of its name's part before the first dot."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = HERE / folder / f"{stem}.py"
        if path.is_file():
            return _module(path).read
    raise FileNotFoundError(f"no reader for metric {metric!r} in portbench/{folder}/")
