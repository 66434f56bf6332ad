"""Do the H100's tensor cores and its SFU overlap independent work?

Port of ``tools/probe_overlap.py``. Three runs of one kernel
(``ops/probe_overlap.py``): (a) a chain of bf16 matrix products only, (b) a
chain of exp passes only, (c) both interleaved with NO data dependence
between them. If (c) ~= max(a, b) the units overlap, and a kernel may
interleave its softmax (SFU) with its GEMMs (tensor cores); if (c) ~= a + b
the work is serial. The overlap share, (a + b - c) / min(a, b), reads 1
for the first and 0 for the second.

    python -m cs_vit_tpu_torch.tools.probe_overlap

Each mode is timed on the card with CUDA events over ITERS launches after
three of warm-up. :func:`run` on CPU tensors times the plain version under
the host clock.
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict

import numpy as np
import torch

from ..cli.common import resolve_device
from ..ops.probe_overlap import MODES, N, probe_overlap

V = 2048      # rows of the exp operand, [V, 512] f32
REPEATS = 64  # the TPU probe's grid
ITERS = 20    # timed calls per mode (the TPU tool's iters)


def make_inputs(device, seed: int = 0, rows: int = N):
    """a [rows, 512], w [512, 512] bf16 (N(0, 0.05^2)) and x [4 rows, 512]
    f32 (N(0, 1)), drawn in the TPU tool's order (its shapes at rows 512)."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(rows, N)) * 0.05).to(device, torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(N, N)) * 0.05).to(device, torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(V * rows // N, 512))).to(device, torch.float32)
    return a, w, x


def time_mode(mode: str, a, w, x, iters: int = ITERS, repeats: int = REPEATS) -> float:
    """ms per call of :func:`probe_overlap` in `mode`."""
    def call():
        return probe_overlap(a, w, x, mode, repeats)

    for _ in range(3):
        call()
    if a.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize(a.device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) * 1e3 / iters


def run(device="cuda", iters: int = ITERS, repeats: int = REPEATS) -> Dict[str, float]:
    """ms of each mode, with the serial sum, the perfect overlap and the
    overlap share (mma + exp - both) / min(mma, exp)."""
    a, w, x = make_inputs(resolve_device(device))
    ms = {mode: time_mode(mode, a, w, x, iters, repeats) for mode in MODES}
    ms["serial"] = ms["mma"] + ms["exp"]
    ms["overlap"] = max(ms["mma"], ms["exp"])
    ms["share"] = (ms["serial"] - ms["both"]) / min(ms["mma"], ms["exp"])
    return ms


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> Dict[str, float]:
    ms = run()
    print(f"device   : {torch.cuda.get_device_name()}")
    print(f"card     : {card_line()}")
    print(f"mma only : {ms['mma']:7.4f} ms")
    print(f"exp only : {ms['exp']:7.4f} ms")
    print(f"both     : {ms['both']:7.4f} ms   (serial sum {ms['serial']:.4f}, "
          f"perfect overlap {ms['overlap']:.4f})")
    print(f"overlap share: {ms['share']:.3f} (1: the units overlap; 0: the work is serial)")
    return ms


if __name__ == "__main__":
    main()
