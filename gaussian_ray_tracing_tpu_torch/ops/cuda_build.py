"""Build and bind the port's CUDA kernels (csrc/*.cu) at first use.

The kernels have a plain C interface: nvcc compiles every source in csrc/
into one shared library for sm_90a under build/kernels/ of the checkout,
named by a hash of the sources and flags so an edit rebuilds, and ctypes
loads it. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("march.cu", "scan.cu")
BUILD_DIR = _PKG.parent / "build" / "kernels"
# -fmad=false: no FMA contraction, so the kernels round each float32
# operation as the plain torch versions do (see csrc/march.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_log = ""  # nvcc/ptxas output of the build this process ran, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libgrt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.grt_march.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                              cf, cf, cf, cf, cf, cf, ci, vp]
    lib.grt_march.restype = ci
    lib.grt_multi_cumsum_i32.argtypes = [vp, vp, vp, ci, ctypes.c_longlong, vp]
    lib.grt_multi_cumsum_i32.restype = ci
    lib.grt_scan_block.argtypes = []
    lib.grt_scan_block.restype = ci
    lib.grt_error_string.argtypes = [ci]
    lib.grt_error_string.restype = ctypes.c_char_p
    lib.SCAN_BLOCK = lib.grt_scan_block()
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = _lib.grt_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{what} failed: CUDA error {err} {msg}")
