"""Spherical-harmonics radiance, degrees 0..3 (counterpart of
gaussian_ray_tracing_tpu/ops/sh.py).

The evaluated colour is max(0, 0.5 + sum_i C_i basis_i(d) sh_i) with d the
normalized ray direction and the reference's band constants.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2_0 = 1.0925484305920792
SH_C2_1 = -1.0925484305920792
SH_C2_2 = 0.31539156525252005
SH_C2_3 = -1.0925484305920792
SH_C2_4 = 0.5462742152960396
SH_C3_0 = -0.5900435899266435
SH_C3_1 = 2.890611442640554
SH_C3_2 = -0.4570457994644658
SH_C3_3 = 0.3731763325901154
SH_C3_4 = -0.4570457994644658
SH_C3_5 = 1.445305721320277
SH_C3_6 = -0.5900435899266435

NUM_SH_COEFFS = 16  # degree 3 => (3+1)^2


def num_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def _check_degree(degree: int) -> None:
    if not 0 <= degree <= 3:
        raise ValueError(f"sh degree must be in [0,3], got {degree}")


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH radiance: sh (..., K, 3) coefficients, DC first; dirs (..., 3)
    normalized. Returns (..., 3) radiance clamped to >= 0."""
    _check_degree(degree)
    L = 0.5 + SH_C0 * sh[..., 0, :]
    if degree >= 1:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        L = L + SH_C1 * (-y * sh[..., 1, :] + z * sh[..., 2, :] - x * sh[..., 3, :])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        L = L + (
            SH_C2_0 * xy * sh[..., 4, :]
            + SH_C2_1 * yz * sh[..., 5, :]
            + SH_C2_2 * (2.0 * zz - xx - yy) * sh[..., 6, :]
            + SH_C2_3 * xz * sh[..., 7, :]
            + SH_C2_4 * (xx - yy) * sh[..., 8, :]
        )
    if degree >= 3:
        L = L + (
            SH_C3_0 * y * (3.0 * xx - yy) * sh[..., 9, :]
            + SH_C3_1 * xy * z * sh[..., 10, :]
            + SH_C3_2 * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
            + SH_C3_3 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
            + SH_C3_4 * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
            + SH_C3_5 * z * (xx - yy) * sh[..., 14, :]
            + SH_C3_6 * x * (xx - 3.0 * yy) * sh[..., 15, :]
        )
    return torch.clamp(L, min=0.0)


def sh_basis(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., K) basis values including band constants and signs, so one
    contraction over K against per-channel coefficients reproduces eval_sh."""
    return torch.stack(sh_basis_list(x, y, z, degree), dim=-1)


def sh_basis_list(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, degree: int) -> list:
    """sh_basis as a list of K same-shape tensors."""
    _check_degree(degree)
    b = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        b += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        b += [
            SH_C2_0 * xy,
            SH_C2_1 * yz,
            SH_C2_2 * (2.0 * zz - xx - yy),
            SH_C2_3 * xz,
            SH_C2_4 * (xx - yy),
        ]
    if degree >= 3:
        b += [
            SH_C3_0 * y * (3.0 * xx - yy),
            SH_C3_1 * xy * z,
            SH_C3_2 * y * (4.0 * zz - xx - yy),
            SH_C3_3 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3_4 * x * (4.0 * zz - xx - yy),
            SH_C3_5 * z * (xx - yy),
            SH_C3_6 * x * (xx - 3.0 * yy),
        ]
    return b
