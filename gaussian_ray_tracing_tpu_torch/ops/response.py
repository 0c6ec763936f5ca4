"""Ray--Gaussian max-response math (counterpart of
gaussian_ray_tracing_tpu/ops/response.py).

  M      = S^-1 R^T                       (canonical whitening frame)
  o_g    = M (o - mu),  d_g = M d
  t*     = -<o_g, d_g> / max(1e-6, <d_g, d_g>)
  resp   = exp(-1/2 |o_g + t* d_g|^2)
  radius = sqrt(2 ln(opacity / alpha_min))  (iso-surface where resp*opacity
                                             drops to alpha_min)

All functions broadcast over leading dimensions.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.ops.quaternion import quat_to_rotmat


def canonical_frames(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """M = diag(1/s) @ R^T, shape (..., 3, 3)."""
    R = quat_to_rotmat(quats)
    inv_s = 1.0 / scales
    return inv_s[..., :, None] * R.transpose(-1, -2)


def adaptive_radius(opacity: torch.Tensor, alpha_min: float,
                    clamp_min: float = 0.0) -> torch.Tensor:
    """Canonical-space iso radius sqrt(2 ln(opacity/alpha_min)).

    Opacity <= alpha_min can never pass the alpha_min hit test, so such
    particles get radius `clamp_min` (0: never intersected) instead of NaN.
    """
    ratio = torch.clamp(opacity / alpha_min, min=1.0)
    x = 2.0 * torch.log(ratio)
    safe = torch.sqrt(torch.where(x > 0.0, x, torch.ones_like(x)))
    return torch.clamp(torch.where(x > 0.0, safe, torch.zeros_like(x)), min=clamp_min)


def dot3(a, b) -> torch.Tensor:
    """sum_k a[k] * b[k] over three broadcastable terms as the chain
    fma(a2, b2, fma(a1, b1, a0 * b0)), the order in which XLA's CPU
    backend evaluates a length-3 contraction (so results match the JAX
    package bit for bit), in full float32 with no matmul."""
    out = a[0] * b[0]
    out = torch.addcmul(out, a[1], b[1])
    return torch.addcmul(out, a[2], b[2])


def mat3_apply(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3) with broadcasting."""
    return dot3([M[..., k] for k in range(3)], [v[..., k:k + 1] for k in range(3)])


def max_response(means, M, origins, dirs):
    """Peak response exp(-1/2 |o_g + t* d_g|^2) and its ray parameter t*."""
    o_g = mat3_apply(M, origins - means)
    d_g = mat3_apply(M, dirs)
    dd = torch.sum(d_g * d_g, dim=-1)
    od = torch.sum(o_g * d_g, dim=-1)
    t_star = -od / torch.clamp(dd, min=1e-6)
    p = o_g + t_star[..., None] * d_g
    resp = torch.exp(-0.5 * torch.sum(p * p, dim=-1))
    return resp, t_star


def ray_ellipsoid_span(means, M, radius, origins, dirs):
    """Entry/exit parameters of rays against the iso ellipsoids
    |M(x - mu)| = radius. Returns (hit, t_entry, t_exit)."""
    o_g = mat3_apply(M, origins - means)
    d_g = mat3_apply(M, dirs)
    a = torch.clamp(torch.sum(d_g * d_g, dim=-1), min=1e-12)
    b = torch.sum(o_g * d_g, dim=-1)  # half-b
    c = torch.sum(o_g * o_g, dim=-1) - radius * radius
    disc = b * b - a * c
    hit = (disc >= 0.0) & (radius > 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return hit, (-b - sq) / a, (-b + sq) / a
