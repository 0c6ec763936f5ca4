"""Front-to-back alpha compositing over depth-ordered hits (counterpart of
gaussian_ray_tracing_tpu/ops/composite.py).

The reference composites sequentially (shaders/tracer.cuh:341-369):

    T = 1 - rayData.density
    for each hit in depth order:
        if T > minTransmittance and alpha > alpha_min:
            radiance += T * color * alpha
            T *= (1 - alpha)

Here the same recurrence is a gated cumulative product. T never rises, so
the cumprod agrees with the sequential T wherever a hit's weight is
nonzero, and the sequential early-termination T is the first inclusive
product at or below the threshold, i.e. the largest of those.
"""

from __future__ import annotations

import torch


def effective_alpha(resp: torch.Tensor, opacity: torch.Tensor, alpha_clamp: float = 0.99):
    """Per-hit alpha min(clamp, response * opacity) (tracer.cuh:356-357)."""
    return torch.clamp(resp * opacity, max=alpha_clamp)


def composite_depth_ordered(alphas: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor, *,
                            alpha_min: float, min_transmittance: float,
                            hit_multiplicity: int = 1, t0: torch.Tensor | None = None):
    """Composite hits sorted front to back along the last axis.

    alphas (..., M) clamped per-hit alpha, colors (..., M, 3), valid
    (..., M) bool. A hit counts when valid and alpha > alpha_min, with
    weight 1 - (1 - a)^hit_multiplicity (the reference's double hull hit
    at hit_multiplicity 2). t0 (...,) is an optional carry-in
    transmittance; rays whose carry-in is already at or below
    min_transmittance add nothing and keep it.

    Returns (rgb (..., 3), density (...,) = 1 - t_final, t_final (...,)).
    """
    gate = valid & (alphas > alpha_min)
    a_eff = alphas if hit_multiplicity == 1 else 1.0 - (1.0 - alphas) ** hit_multiplicity
    a = torch.where(gate, a_eff, 0.0)
    p_incl = torch.cumprod(1.0 - a, dim=-1)
    p_excl = torch.cat([torch.ones_like(p_incl[..., :1]), p_incl[..., :-1]], dim=-1)
    if t0 is not None:
        p_incl = p_incl * t0[..., None]
        p_excl = p_excl * t0[..., None]
        t_start = t0
    else:
        t_start = torch.ones(p_incl.shape[:-1], dtype=p_incl.dtype, device=p_incl.device)

    w = a * p_excl * (p_excl > min_transmittance)
    rgb = torch.sum(w[..., None] * colors, dim=-2)

    # the first inclusive product at or below the threshold freezes T
    below = p_incl <= min_transmittance
    frozen = torch.where(below, p_incl, float("-inf")).amax(dim=-1) if a.shape[-1] else t_start
    t_last = p_incl[..., -1] if a.shape[-1] else t_start
    t_final = torch.where(below.any(dim=-1), frozen, t_last)
    live = t_start > min_transmittance
    t_final = torch.where(live, t_final, t_start)
    rgb = torch.where(live[..., None], rgb, 0.0)
    return rgb, 1.0 - t_final, t_final
