"""ctypes bindings of the port's native C++ core, with numpy fallbacks
(counterpart of gaussian_ray_tracing_tpu/native/bindings.py).

grtcore.cpp (PLY read and write, OBJ loading, Morton codes, a u64
argsort) and refmarch.cpp (an independent C++ re-derivation of the
reference march, the oracle's cross-check) are compiled by g++ at first
use into build/native/ of the checkout, each library named by a hash of
its source and flags, so that an edited source is rebuilt and a stale
library is never loaded; nothing is written beside the sources. The
flags carry no -march=native: a library built on one host stays loadable
on another. Every grtcore function has a numpy fallback and returns the
same values without the library; arrays may be numpy arrays or tensors
(moved to the host).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build" / "native"
CORE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
REF_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_ref_lib: Optional[ctypes.CDLL] = None
_ref_tried = False


def library_path(name: str, flags: tuple, build_dir: Path = BUILD_DIR) -> Path:
    """build_dir/lib<name>_<hash of the source and flags>.so."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    return build_dir / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile(name: str, flags: tuple, force: bool = False,
             build_dir: Path = BUILD_DIR) -> Optional[Path]:
    """Compile <name>.cpp unless its library exists; None if g++ fails or
    is missing."""
    out = library_path(name, flags, build_dir)
    if out.exists() and not force:
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([cxx, *flags, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)],
                         capture_output=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def build(force: bool = False) -> bool:
    """Compile grtcore.cpp into build/native/ (again with `force`).
    Returns True on success."""
    global _lib, _tried
    if force:
        _lib, _tried = None, False
    return _compile("grtcore", CORE_FLAGS, force) is not None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _compile("grtcore", CORE_FLAGS)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    c_i64, c_i32, c_char_p = ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p
    p_i64 = ctypes.POINTER(c_i64)
    p_i32 = ctypes.POINTER(c_i32)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_u64 = ctypes.POINTER(ctypes.c_uint64)
    lib.grt_ply_header.argtypes = [c_char_p, p_i64, p_i32, c_char_p, c_i64, p_i64]
    lib.grt_ply_header.restype = c_i32
    lib.grt_ply_read.argtypes = [c_char_p, c_i64, p_f32, c_i64, c_i32]
    lib.grt_ply_read.restype = c_i32
    lib.grt_ply_write.argtypes = [c_char_p, c_char_p, p_f32, c_i64, c_i32]
    lib.grt_ply_write.restype = c_i32
    lib.grt_obj_count.argtypes = [c_char_p, p_i64]
    lib.grt_obj_count.restype = c_i32
    lib.grt_obj_load.argtypes = [c_char_p, p_f32, p_f32, c_i64, c_i32]
    lib.grt_obj_load.restype = c_i32
    lib.grt_morton3d.argtypes = [p_f32, c_i64, p_f32, p_f32, p_u64]
    lib.grt_morton3d.restype = None
    lib.grt_argsort_u64.argtypes = [p_u64, c_i64, p_i64]
    lib.grt_argsort_u64.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _host(x, dtype) -> np.ndarray:
    """A contiguous host numpy copy of an array or tensor."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def ply_read_native(path: str):
    """Read an all-float32 binary_little_endian PLY vertex element.

    Returns a dict name -> float32 column, or None when the library is
    missing or cannot read this file (the caller uses the numpy reader).
    """
    lib = _load()
    if lib is None:
        return None
    count = ctypes.c_int64()
    n_props = ctypes.c_int32()
    names_buf = ctypes.create_string_buffer(1 << 16)
    off = ctypes.c_int64()
    rc = lib.grt_ply_header(str(path).encode(), ctypes.byref(count), ctypes.byref(n_props),
                            names_buf, len(names_buf), ctypes.byref(off))
    if rc != 0:
        return None
    n, p = count.value, n_props.value
    data = np.empty((n, p), np.float32)
    if lib.grt_ply_read(str(path).encode(), off.value, _fptr(data), n, p) != 0:
        return None
    names = names_buf.value.decode().split("\n")
    return {nm: np.ascontiguousarray(data[:, i]) for i, nm in enumerate(names)}


def ply_write_native(path: str, columns: dict) -> bool:
    """Write float32 columns as a binary_little_endian PLY vertex element.
    Returns False when the library is missing or the write fails."""
    lib = _load()
    if lib is None:
        return False
    names = "\n".join(columns.keys())
    data = np.ascontiguousarray(np.stack([_host(v, np.float32) for v in columns.values()],
                                         axis=1))
    rc = lib.grt_ply_write(str(path).encode(), names.encode(), _fptr(data), data.shape[0],
                           data.shape[1])
    return rc == 0


def obj_load_native(path: str, y_flip: bool = True):
    """Load an OBJ as an unindexed triangle soup. Returns (verts, norms)
    float32 arrays of shape (n_tris * 3, 3), or None to fall back."""
    lib = _load()
    if lib is None:
        return None
    n_tris = ctypes.c_int64()
    if lib.grt_obj_count(str(path).encode(), ctypes.byref(n_tris)) != 0:
        return None
    n = n_tris.value
    verts = np.empty((n * 3, 3), np.float32)
    norms = np.empty((n * 3, 3), np.float32)
    rc = lib.grt_obj_load(str(path).encode(), _fptr(verts), _fptr(norms), n,
                          1 if y_flip else 0)
    return None if rc != 0 else (verts, norms)


def morton3d(pos, lo=None, hi=None) -> np.ndarray:
    """63-bit Morton codes (uint64) of (N, 3) positions in the box [lo, hi]
    (default: their bounds), native or numpy."""
    pos = _host(pos, np.float32)
    lo = _host(pos.min(0) if lo is None else lo, np.float32)
    hi = _host(pos.max(0) if hi is None else hi, np.float32)
    lib = _load()
    n = pos.shape[0]
    if lib is not None:
        out = np.empty(n, np.uint64)
        lib.grt_morton3d(_fptr(pos), n, _fptr(lo), _fptr(hi),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out
    span = np.where(hi > lo, hi - lo, 1.0)
    q = (np.clip((pos - lo) / span, 0.0, 1.0) * ((1 << 21) - 1)).astype(np.uint64)

    def expand(v):
        v &= np.uint64((1 << 21) - 1)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (expand(q[:, 0]) << np.uint64(2)) | (expand(q[:, 1]) << np.uint64(1)) \
        | expand(q[:, 2])


def argsort_u64(keys) -> np.ndarray:
    """Stable ascending argsort (int64) of uint64 keys, native or numpy."""
    keys = _host(keys, np.uint64)
    lib = _load()
    if lib is not None:
        out = np.empty(keys.shape[0], np.int64)
        lib.grt_argsort_u64(keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                            keys.shape[0], out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out
    return np.argsort(keys, kind="stable")


def _load_ref() -> Optional[ctypes.CDLL]:
    """Load (building at first use) refmarch.cpp's library."""
    global _ref_lib, _ref_tried
    if _ref_lib is not None or _ref_tried:
        return _ref_lib
    _ref_tried = True
    path = _compile("refmarch", REF_FLAGS)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    c_i64, c_i32, c_f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    p_f32 = ctypes.POINTER(c_f32)
    lib.grt_ref_render.argtypes = [
        p_f32, p_f32, p_f32, p_f32, p_f32, c_i64, c_i32,
        p_f32, p_f32, c_i64, p_f32, p_f32,
        c_f32, c_f32, c_f32, c_i32, c_i32, p_f32, p_f32,
    ]
    lib.grt_ref_render.restype = c_i32
    _ref_lib = lib
    return _ref_lib


def ref_render_native(scene, origins, dirs, config, t_lo=None, t_hi=None):
    """Render rays through the C++ re-derivation of the reference march.

    scene: a GaussianScene (any device); origins, dirs (..., 3). Returns
    (rgb (R, 3), alpha (R,)) float32 numpy arrays, or None when the library
    cannot be built. Used by the cross-validation tests."""
    lib = _load_ref()
    if lib is None:
        return None
    origins = _host(origins, np.float32).reshape(-1, 3)
    dirs = _host(dirs, np.float32).reshape(-1, 3)
    r = origins.shape[0]
    means, scales, quats, opac, sh = (_host(getattr(scene, k), np.float32)
                                      for k in ("means", "scales", "quats", "opacities", "sh"))
    n, k = sh.shape[0], sh.shape[1]
    lo = np.full(r, config.t_min if t_lo is None else t_lo, np.float32)
    hi = np.full(r, config.t_max if t_hi is None else t_hi, np.float32)
    rgb = np.empty((r, 3), np.float32)
    alpha = np.empty((r,), np.float32)
    rc = lib.grt_ref_render(
        _fptr(means), _fptr(scales), _fptr(quats), _fptr(opac), _fptr(sh), n, k,
        _fptr(origins), _fptr(dirs), r, _fptr(lo), _fptr(hi),
        config.alpha_min, config.alpha_clamp, config.min_transmittance,
        config.hit_multiplicity, config.sh_degree, _fptr(rgb), _fptr(alpha),
    )
    return None if rc != 0 else (rgb, alpha)
