"""A run end to end at the tiny size on the CPU: sound runs come out
correct; the control and every planted fault that a cell can have come out
not correct; nothing the benchmark loads is JAX's; without a card the
command exits non-zero and prints no result. A cell of several cards runs
in a two-process gloo world (``world_worker``), whose rank 0 reports the
world's samples a unit and ranks whose leaves are equal to the bit. On the
cards: the control at each cell's own size on three seeds."""

import json
import os
import subprocess
import sys
import tempfile

import pytest

from portbench.cell import ROOT
from portbench.run import run_cell
from portbench.tests.tiny import tiny_cell

# the faults each cell can have (the exchange between cards: only across cards)
TRAIN_FAULTS = ("frozen", "half", "grad2", "dw")
WORLD = "poser-dp4-train-b64x4"
FAULTS = {"poser-train-b64": TRAIN_FAULTS, "spenc-train-b64": TRAIN_FAULTS,
          "poser-serve-b64": ("half", "answer"), "spenc-stream-rt3-b1": ("answer",),
          WORLD: ("frozen", "half", "exchange")}
CASES = [(c, f) for c, fs in FAULTS.items() for f in fs]


def _run(name, fault=None, seed=7, trace=False):
    if tiny_cell(name).params.get("world", 1) > 1:
        return _run_world(name, fault, seed, trace)
    return run_cell(name, seed, 0.2, trace, device="cpu", cell=tiny_cell(name), fault=fault)


def _run_world(name, fault, seed, trace):
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        subprocess.run([sys.executable, "-m", "portbench.tests.world_worker", name, str(seed),
                        fault or "-", str(int(trace)), out], cwd=ROOT, check=True,
                       capture_output=True, timeout=300)
        with open(out) as f:
            return json.load(f)


@pytest.mark.parametrize("name", list(FAULTS))
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0 and list(r)[-1] == "checks"
    assert set(r["metrics"]) >= {"setup_s", "peak_mem_gib"}


@pytest.mark.parametrize("name,fault", CASES)
def test_planted_fault_is_not_correct(name, fault):
    assert not _run(name, fault)["correct"]


@pytest.mark.parametrize("name", list(FAULTS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(name, seed):
    assert not _run(name, "control", seed)["correct"]


@pytest.mark.parametrize("name", ["poser-train-b64", WORLD])
def test_traced_run_reports_layer_metrics(name):
    r = _run(name, seed=5, trace=True)
    assert r["correct"] and set(r["metrics"]) == {"mfu.train"}  # no device events on the CPU
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["count"] == tiny_cell(name).params.get("world", 1)


def test_world_reports_its_samples_and_equal_ranks():
    r = _run(WORLD)
    cell = tiny_cell(WORLD)
    world, batch = cell.params["world"], cell.params["batch"]
    assert r["correct"] and r["ranks_ok"] and r["device"]["count"] == world
    assert r["unit_samples"] and set(r["unit_samples"]) == {world * batch}
    assert r["checks"]["ranks_apart"] == {"value": 0.0, "limit": 0.0}


FORBIDDEN_CHECK = """
import sys
import portbench.run, portbench.reference, portbench.readings, portbench.served
from portbench.cell import driver_module, reader
import json
bench = json.load(open("BENCHMARK.json"))
for w in bench["workloads"]:
    driver_module(json.load(open(f"portbench/workloads/{w['name']}.json"))["kind"])
for m in bench["per_layer"]:
    reader("layers", m["name"])
from portbench.run import forbidden_modules
print(json.dumps(forbidden_modules()))
"""


def test_nothing_loads_jax():
    out = subprocess.run([sys.executable, "-c", FORBIDDEN_CHECK], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; import portbench.reference; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    assert "cs_vit_tpu_torch" not in json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["poser-train-b64", WORLD])
def test_no_card_no_result(name):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                        "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "correct" not in p.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FAULTS))
def test_control_fails_at_full_size_on_card(name, tmp_path):
    import torch

    from portbench.cell import load_cell

    chips = load_cell(name).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    seeds = (3000090001, 3000090002, 3000090003)
    if chips == 1:
        for seed in seeds:
            assert not run_cell(name, seed, 2.0, False, fault="control")["correct"]
        return
    out = tmp_path / "readings.jsonl"
    subprocess.run([sys.executable, "-m", "portbench.readings", "--workload", name, "--faults",
                    "control:" + ",".join(map(str, seeds)), "--seconds", "2", "--out", str(out)],
                   cwd=ROOT, check=True, timeout=1800)
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == len(seeds) and not any(x["correct"] for x in lines)
