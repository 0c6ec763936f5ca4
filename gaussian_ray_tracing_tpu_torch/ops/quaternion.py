"""Quaternion utilities (counterpart of gaussian_ray_tracing_tpu/ops/quaternion.py).

Quaternions are (w, x, y, z), as the reference passes the PLY rot_0..rot_3
fields to glm::quat(w, x, y, z).
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis ((..., 4), wxyz)."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(n, min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3), as
    glm::mat3_cast (R @ v rotates v)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
        [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
        [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
