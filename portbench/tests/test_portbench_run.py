"""A run end to end at the tiny size on the CPU: sound runs come out
correct; the control and every planted fault that a cell can have come out
not correct; nothing the benchmark loads is JAX's; without a card the
command exits non-zero and prints no result. On a card: the control at
each cell's own size on three seeds."""

import json
import os
import subprocess
import sys

import pytest

from portbench.cell import ROOT
from portbench.run import run_cell
from portbench.tests.tiny import tiny_cell

# the faults each cell can have (the exchange between cards: none, one card)
TRAIN_FAULTS = ("frozen", "half", "grad2", "dw")
FAULTS = {"poser-train-b64": TRAIN_FAULTS, "spenc-train-b64": TRAIN_FAULTS,
          "poser-serve-b64": ("half", "answer"), "spenc-stream-rt3-b1": ("answer",)}
CASES = [(c, f) for c, fs in FAULTS.items() for f in fs]


def _run(name, fault=None, seed=7):
    return run_cell(name, seed, 0.2, False, device="cpu", cell=tiny_cell(name), fault=fault)


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


def test_traced_run_reports_layer_metrics():
    r = run_cell("poser-train-b64", 5, 0.2, True, device="cpu", cell=tiny_cell("poser-train-b64"))
    assert r["correct"] and set(r["metrics"]) == {"mfu.train"}  # no device events on the CPU
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


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


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "poser-train-b64",
                        "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "correct" not in p.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FAULTS))
def test_control_fails_at_full_size_on_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (3000090001, 3000090002, 3000090003):
        assert not run_cell(name, seed, 2.0, False, fault="control")["correct"]
