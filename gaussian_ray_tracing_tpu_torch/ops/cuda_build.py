"""Build and bind the port's CUDA kernels (csrc/*.cu) at first use.

The kernels have a plain C interface: nvcc compiles every source in csrc/
for sm_90a, one process per source, all started together, then links the
objects into one shared library under build/kernels/ of the checkout,
named by a hash of the sources, headers and flags so an edit rebuilds, and
ctypes loads it. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("march.cu", "march_sh1.cu", "march_sh2.cu", "march_sh3.cu", "march_bwd.cu",
           "march_bwd_sh1.cu", "march_bwd_sh2.cu", "march_bwd_sh3.cu", "scan.cu", "tri.cu")
HEADERS = ("march.cuh", "march_bwd.cuh")
BUILD_DIR = _PKG.parent / "build" / "kernels"
# -fmad=false: no FMA contraction, so the kernels round each float32
# operation as the plain torch versions do (see csrc/march.cu)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib = None
build_log = ""  # nvcc/ptxas output of the library's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((csrc / name).read_bytes())
    return build_dir / f"libgrt_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources of `csrc` (the package's csrc/ by default) into
    the shared library unless it is already built. Sets `build_log` (kept
    beside the library, so that a later process reads the same log)."""
    global build_log
    out = library_path(csrc, build_dir)
    if out.exists():
        log_file = out.with_suffix(".log")
        build_log = log_file.read_text() if log_file.exists() else ""
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [build_dir / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(csrc / name)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(SOURCES, objs)
    ]
    logs, failed = [], []
    t0 = time.perf_counter()
    for name, proc in zip(SOURCES, procs):
        text = proc.communicate()[0]
        logs.append(f"# {name} (done by {time.perf_counter() - t0:.1f} s)\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    tmp = out.with_name(f"{tag}.tmp.so")
    if not failed:
        res = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        logs.append(f"# link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    out.with_suffix(".log").write_text(build_log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


class _InterfaceV5:
    """A library of C interface version 3, 4 or 5 (an earlier commit's csrc,
    for A/B runs against it), called with this tree's argument lists:
    grt_march without `carry` and `carry_tiles` (arguments 34-35) and
    grt_march_bwd without `scratch` and `scratch_tiles` (arguments 25-26),
    which it never needs (it refuses tiles of more than 8192 rays), and no
    carry or scratch to size."""

    def __init__(self, lib, info: bool):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.grt_march.argtypes = [vp] * 12 + [ci] * 7 + [cf] * 6 + [ci] * 6 + [cf, ci, vp, vp]
        lib.grt_march_bwd.argtypes = [vp] * 12 + [ci] * 6 + [cf] * 5 + [ci, ci, vp]
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def grt_march_carry_floats(self, chunk, order, rays):
        return 0

    def grt_march_bwd_scratch_bytes(self, chunk, window, sh_k, rays, n_tiles):
        return 0

    def grt_march(self, *a):
        if a[34] is not None:
            raise ValueError("this kernel build takes no carry (tiles of more than 8192 rays)")
        return self.march5(*a[:34], a[36])

    def grt_march_bwd(self, *a):
        if a[25] is not None:
            raise ValueError("this kernel build takes no scratch (tiles of more than 8192 rays)")
        return self.march_bwd5(*a[:25], a[27])

    def march5(self, *a):  # version 5's argument list
        return self._lib.grt_march(*a)

    def march_bwd5(self, *a):
        return self._lib.grt_march_bwd(*a)


class _InterfaceV2(_InterfaceV5):
    """A library of C interface version 2, called as _InterfaceV5 calls a
    version 5 one, and besides without peak, scan, group, a_fire, repair
    and stats (grt_march's arguments 28-33) and peak (grt_march_bwd's
    argument 24). The default options pass 0, rays_per_tile, 0.0,
    sort_repair and null there, which that build runs as they are (it sorts
    a fired chunk whole, which sort_repair's band reproduces at a_fire 0);
    any other option raises."""

    def __init__(self, lib, info: bool):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.grt_march.argtypes = [vp] * 12 + [ci] * 7 + [cf] * 6 + [ci, ci, ci, vp]
        lib.grt_march_bwd.argtypes = [vp] * 12 + [ci] * 6 + [cf] * 5 + [ci, vp]
        self._lib = lib

    def march5(self, *a):
        peak, scan, group, a_fire, _, stats = a[28:34]
        if peak or scan or group != a[14] or a_fire or stats is not None:
            raise ValueError("this kernel build has no peak key, window-order render options "
                             "or stats")
        return self._march(*a[:28], a[34])

    def march_bwd5(self, *a):
        if a[24]:
            raise ValueError("this kernel build's K3 has no peak key")
        return self._march_bwd(*a[:24], a[25])

    def _march(self, *a):  # version 2's argument list
        return self._lib.grt_march(*a)

    def _march_bwd(self, *a):
        return self._lib.grt_march_bwd(*a)


class _InterfaceV1(_InterfaceV2):
    """A library built from sources older than grt_interface_version, called
    as _InterfaceV2 calls a version 2 one, and besides without `quad`
    (grt_march's argument 27), grt_march_bwd's origins, t_lo and t_hi
    (arguments 9-11) and grt_march_bwd_info's `origins` (argument 3), which
    the shared-origin calls pass as 0 and null; the per-ray-origin modes
    raise."""

    def __init__(self, lib, info: bool):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.grt_march.argtypes = [vp] * 12 + [ci] * 7 + [cf] * 6 + [ci, ci, vp]
        lib.grt_march_bwd.argtypes = [vp] * 9 + [ci] * 6 + [cf] * 5 + [ci, vp]
        if info:
            lib.grt_march_bwd_info.argtypes = [ci] * 4 + [vp]
        self._lib = lib

    def _march(self, *a):
        if a[27]:
            raise ValueError("this kernel build has no per-ray-origin quad response")
        return self._lib.grt_march(*a[:27], a[28])

    def _march_bwd(self, *a):
        if any(x is not None for x in a[9:12]):
            raise ValueError("this kernel build's K3 takes no per-ray origins or windows")
        return self._lib.grt_march_bwd(*a[:9], *a[12:])

    def grt_march_info(self, chunk, order, sh_k, resp, train, rays, out):
        if resp == 2:
            raise ValueError("this kernel build has no per-ray-origin quad response")
        return self._lib.grt_march_info(chunk, order, sh_k, resp, train, rays, out)

    def grt_march_bwd_info(self, chunk, window, sh_k, origins, rays, out):
        if origins:
            raise ValueError("this kernel build's K3 takes no per-ray origins")
        return self._lib.grt_march_bwd_info(chunk, window, sh_k, rays, out)


def declare(lib: ctypes.CDLL, info: bool = True) -> ctypes.CDLL:
    """Declare the C entry points of a loaded kernel library (`info`: also
    the launch queries grt_march_info, grt_march_bwd_info,
    grt_closest_hit_info and grt_scan_info). A library built from an
    earlier commit's sources comes back behind _InterfaceV5 (interface
    version 3-5: it refuses, with cudaErrorInvalidValue, what it lacks: a
    tile of more than 8192 rays, a chunk other than 32, 64, 128 and 256
    (versions 3-4), and order 3, oddeven (version 3)), _InterfaceV2
    (version 2) or _InterfaceV1 (no grt_interface_version)."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.grt_march.argtypes = [vp] * 12 + [ci] * 7 + [cf] * 6 + [ci] * 6 + [cf, ci, vp, vp, ci,
                                                                            vp]
    lib.grt_march.restype = ci
    lib.grt_march_bwd.argtypes = [vp] * 12 + [ci] * 6 + [cf] * 5 + [ci, ci, vp, ci, vp]
    lib.grt_march_bwd.restype = ci
    if info:
        lib.grt_march_info.argtypes = [ci] * 6 + [vp]
        lib.grt_march_info.restype = ci
        lib.grt_march_bwd_info.argtypes = [ci] * 5 + [vp]
        lib.grt_march_bwd_info.restype = ci
        lib.grt_closest_hit_info.argtypes = [ci, vp]
        lib.grt_closest_hit_info.restype = ci
        lib.grt_scan_info.argtypes = [vp]
        lib.grt_scan_info.restype = ci
    lib.grt_multi_cumsum_i32.argtypes = [vp, vp, vp, ci, ctypes.c_longlong, vp]
    lib.grt_multi_cumsum_i32.restype = ci
    lib.grt_closest_hit.argtypes = [vp] * 12 + [ci, ci, cf, cf, vp]
    lib.grt_closest_hit.restype = ci
    lib.grt_scan_scratch_bytes.argtypes = [ci, ctypes.c_longlong]
    lib.grt_scan_scratch_bytes.restype = ctypes.c_longlong
    lib.grt_error_string.argtypes = [ci]
    lib.grt_error_string.restype = ctypes.c_char_p
    version = lib.grt_interface_version() if hasattr(lib, "grt_interface_version") else 1
    if version >= 6:
        lib.grt_march_carry_floats.argtypes = [ci] * 3
        lib.grt_march_carry_floats.restype = ci
        lib.grt_march_bwd_scratch_bytes.argtypes = [ci] * 5
        lib.grt_march_bwd_scratch_bytes.restype = ctypes.c_longlong
        return lib
    cls = _InterfaceV5 if version >= 3 else _InterfaceV2 if version == 2 else _InterfaceV1
    return cls(lib, info)


def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    global _lib
    if _lib is None:
        _lib = declare(ctypes.CDLL(str(build())))
    return _lib


def launch_info(kernel: str, chunk: int, sh_degree: int, rays: int, *, order: str = "window",
                scalar: bool = False, train: bool = False, quad: bool = False) -> dict:
    """What a launch of K1 (`kernel` "march": order, per-ray origins with
    the scalar response `scalar` or the quad one `quad`, saved carries
    `train`), K3 ("march_bwd": order window or key, per-ray origins `scalar`),
    K4 ("closest_hit": chunk and SH degree unused) or K2 ("scan": its own
    256 threads; chunk, SH degree and rays unused) at this chunk, SH degree
    and rays per tile runs: resident blocks per SM, shared memory bytes
    (dynamic; K4's and K2's static), registers and local memory bytes per
    thread, from the CUDA runtime; for K1 and K3 also the blocks of a
    tile's thread-block cluster (1 up to 1024 rays), above 1024 rays the
    clusters that can be resident at once (cudaOccupancyMaxActiveClusters;
    the query raises where none can), the staging capacity C of the
    build that marches this chunk (`build_chunk`: 32, 64, 128 or 256) and
    the rays each thread marches (`rays_per_thread`: ceil(R / 8192) above
    8192, else 1)."""
    lib = load_library()
    out = (ctypes.c_int * 8)()
    k = (sh_degree + 1) ** 2
    if kernel == "scan":
        err = lib.grt_scan_info(out)
    elif kernel == "closest_hit":
        err = lib.grt_closest_hit_info(rays, out)
    elif kernel == "march":
        err = lib.grt_march_info(chunk, ("window", "key", "merge", "oddeven").index(order), k,
                                 2 if quad else int(scalar), int(train), rays, out)
    else:
        err = lib.grt_march_bwd_info(chunk, int(order == "window"), k, int(scalar), rays, out)
    check(err, f"{kernel} launch info")
    info = {"blocks_per_sm": out[0], "smem_bytes": out[1], "registers": out[2],
            "local_bytes": out[3]}
    if kernel in ("march", "march_bwd"):
        info["cluster_blocks"] = out[4] if rays > 1024 else 1
        info["resident_clusters"] = out[5] if rays > 1024 else None
        info["build_chunk"] = out[6]
        info["rays_per_thread"] = max(1, out[7])
    return info


def ptxas_table(log: str) -> dict:
    """{mangled kernel name: (registers, stack frame bytes, spill stores,
    spill loads)} from an nvcc -Xptxas -v log."""
    import re

    table, name, stack = {}, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            stack = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name] = (int(m.group(1)), *stack)
            name, stack = None, (0, 0, 0)
    return table


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = _lib.grt_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{what} failed: CUDA error {err} {msg}")
