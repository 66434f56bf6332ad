"""The host data pipeline's C crop (port of ``cs_vit_tpu/native``).

``fastcrop.c`` is this package's own copy of the JAX package's C source. It
is compiled at first use, never at import, with the C compiler on ``PATH``
and the JAX package's flags (other flags could change how the compiler
contracts multiplies and adds, and then the two crops would differ), into
``cs_vit_tpu_torch/_build/`` (git-ignored), and loaded with ``ctypes``. The
library's file name carries a hash of the source, the flags, the compiler and
the host, so a stale build, or one made for another machine's CPU
(``-march=native``), is never loaded.

There is no hidden fallback: where no C compiler is on ``PATH``,
:func:`native_available` is False and ``ops.resample.crop_and_resize_np``
takes its numpy path; a compiler that fails on the source raises with its
output. A ``ctypes`` call releases the interpreter lock, so the loader's
threads crop in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().with_name("fastcrop.c")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
COMPILERS = ("cc", "gcc", "clang")
# the JAX package's command line (cs_vit_tpu/native/__init__.py:39)
CFLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LDLIBS = ("-lm",)

# (source, build directory) -> the library, or None where no compiler was found
_loaded: Dict[Tuple[Path, Path], Optional[ctypes.CDLL]] = {}
_lock = threading.Lock()


def find_compiler() -> Optional[str]:
    """The first of COMPILERS on ``PATH``, or None."""
    for cc in COMPILERS:
        path = shutil.which(cc)
        if path:
            return path
    return None


def library_path(compiler: str, src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from `src` by `compiler` on this host lives."""
    real = os.path.realpath(compiler)
    h = hashlib.sha256()
    h.update(Path(src).read_bytes())
    h.update(" ".join(CFLAGS + LDLIBS).encode())
    h.update(f"{real} {os.stat(real).st_mtime_ns} {platform.node()} {platform.machine()}"
             .encode())
    return Path(build_dir) / f"libfastcrop-{h.hexdigest()[:16]}.so"


def build(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Optional[Path]:
    """The library built from `src` (compiled now unless already built);
    None where no C compiler is on ``PATH``. A failing compile raises."""
    cc = find_compiler()
    if cc is None:
        return None
    out = library_path(cc, src, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(src), *LDLIBS],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build of the same source is the same file
    return out


def load(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Optional[ctypes.CDLL]:
    """The loaded library (built at the first call), or None without a
    compiler. Later calls return the first call's answer."""
    key = (Path(src), Path(build_dir))
    if key in _loaded:
        return _loaded[key]
    with _lock:
        if key not in _loaded:
            path = build(src, build_dir)
            _loaded[key] = None if path is None else _open(path)
        return _loaded[key]


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i64 = ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, img_p in (("crop_affine_bilinear_batch", fp),
                        ("crop_affine_bilinear_u8_batch", u8p)):
        fn = getattr(lib, name)
        fn.argtypes = [img_p, i64, i64, i64, i64, fp, fp, i64, i64]
        fn.restype = None
    return lib


def native_available() -> bool:
    """True where the C crop is built and loaded (building it now if need
    be); False only where no C compiler is on ``PATH``."""
    return load() is not None


def crop_affine_bilinear_batch(
    images: np.ndarray,   # [N, H, W, C] float32 in [0,1] OR uint8 in [0,255]
    corners: np.ndarray,  # [N, 4, 2] float32 (tl, tr, br, bl)
    out_h: int,
    out_w: int,
) -> np.ndarray:
    """The C crop -> [N, out_h, out_w, C] float32, [0,1]-scaled for uint8
    sources (the uint8 kernel folds the 1/255 into the interpolation).
    Raises where the library cannot be had."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"no C compiler ({', '.join(COMPILERS)}) on PATH for {SRC.name}")
    if images.dtype not in (np.float32, np.uint8) or images.ndim != 4:
        raise ValueError(f"images must be [N,H,W,C] float32 or uint8, got {images.dtype} "
                         f"{images.shape}")
    corners = np.ascontiguousarray(corners, np.float32)
    N, H, W, C = images.shape
    if corners.shape != (N, 4, 2):
        raise ValueError(f"corners must be [{N},4,2], got {corners.shape}")
    images = np.ascontiguousarray(images)
    out = np.empty((N, int(out_h), int(out_w), C), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    if images.dtype == np.uint8:
        fn, img_p = lib.crop_affine_bilinear_u8_batch, ctypes.POINTER(ctypes.c_uint8)
    else:
        fn, img_p = lib.crop_affine_bilinear_batch, fp
    fn(images.ctypes.data_as(img_p), N, H, W, C, corners.ctypes.data_as(fp),
       out.ctypes.data_as(fp), int(out_h), int(out_w))
    return out
