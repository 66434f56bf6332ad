"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, reads only the sources in ``csrc/``, and writes into
``cs_vit_tpu_torch/_build/`` (listed in ``.gitignore``). A library's file
name carries a hash of its source, the headers and the flags, so an edited
source is never served by a stale build. All sources compile in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("fused_block", "fused_block_bwd", "window_attention", "probe_overlap")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, PATH or /usr/local/cuda; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of cs_vit_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every library in `names` that is not built yet, all at once.

    Returns the wall seconds per library (0.0 for one already built). The
    compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
    kept beside each library as ``<lib>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`; the first load builds every library of
    ``SOURCES`` that is not built yet, all at once."""
    if name not in _loaded:
        build()
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
