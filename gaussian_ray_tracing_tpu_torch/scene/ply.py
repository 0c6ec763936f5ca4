"""3DGS PLY reader (counterpart of gaussian_ray_tracing_tpu/scene/ply.py).

Parses the trained-3DGS vertex layout: x/y/z, scale_0..2, rot_0..3 (wxyz),
opacity, f_dc_0..2 and f_rest_0..44, with the f_rest channel interleave
sh[k][rgb] = f_rest_{k-1 + n_rest*rgb}. binary_little_endian and ascii.
Only the numpy reader is ported; the JAX package's C++ fast path is not.
"""

from __future__ import annotations

import io
from typing import Dict, Tuple

import numpy as np

from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def _read_header(f) -> Tuple[str, int, list[tuple[str, str]]]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    count = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                count = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            if tokens[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tokens[2], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"unsupported PLY format {fmt}")
    return fmt, count, props


def read_ply_raw(path: str) -> Dict[str, np.ndarray]:
    """Read the vertex element into a dict of named float32 columns."""
    with open(path, "rb") as f:
        fmt, count, props = _read_header(f)
        names = [n for n, _ in props]
        if fmt == "binary_little_endian":
            dtype = np.dtype(props)
            data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype,
                                 count=count)
        else:
            raw = np.loadtxt(io.BytesIO(f.read()), dtype=np.float64, max_rows=count)
            raw = np.atleast_2d(raw)
            data = {n: raw[:, i] for i, n in enumerate(names)}
    return {n: np.asarray(data[n], np.float32) for n in names}


def columns_to_raw_params(cols: Dict[str, np.ndarray], max_sh_degree: int = 3):
    """Raw (pre-activation) parameter arrays from PLY columns."""
    n = cols["x"].shape[0]
    means = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1)
    raw_scales = np.stack([cols[f"scale_{i}"] for i in range(3)], axis=-1)
    raw_quats = np.stack([cols[f"rot_{i}"] for i in range(4)], axis=-1)
    k = (max_sh_degree + 1) ** 2
    sh = np.zeros((n, k, 3), np.float32)
    for c in range(3):
        sh[:, 0, c] = cols[f"f_dc_{c}"]
    n_rest = k - 1
    for c in range(3):  # channel-major f_rest blocks
        for i in range(n_rest):
            key = f"f_rest_{i + n_rest * c}"
            if key in cols:
                sh[:, 1 + i, c] = cols[key]
    return means, raw_scales, raw_quats, cols["opacity"], sh


def load_ply(path: str, max_sh_degree: int = 3, pad_to: int | None = None,
             device="cpu") -> GaussianScene:
    """Load a trained 3DGS PLY into an activated GaussianScene."""
    cols = read_ply_raw(path)
    n_rest = len([k for k in cols if k.startswith("f_rest_")])
    degree = 0 if n_rest == 0 else int(round(np.sqrt(n_rest // 3 + 1))) - 1
    degree = min(degree, max_sh_degree)
    means, s, q, o, sh = columns_to_raw_params(cols, max_sh_degree=degree)
    return GaussianScene.from_raw(means, s, q, o, sh, pad_to=pad_to, device=device)
