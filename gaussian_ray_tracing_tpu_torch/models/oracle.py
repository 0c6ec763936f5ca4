"""Brute-force oracle renderer with exact per-ray depth ordering
(counterpart of gaussian_ray_tracing_tpu/models/oracle.py).

Every ray tests every gaussian, sorts its hits by its own event t and
composites them front to back: O(gaussians x rays), the ground truth the
kernel paths are held against. A gaussian's hit event is its iso-ellipsoid
entry t, or its exit t when the ray starts inside or the entry lies before
the segment start; alphas use the analytic peak response along the whole
ray (shaders/tracer.cuh:187-214), which segment clipping does not change.

Plain torch on whatever device the scene lives on; no kernel. Rays go
through in chunks of `ray_chunk`, which bounds the (chunk, gaussians)
working set.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.ops.composite import composite_depth_ordered, effective_alpha
from gaussian_ray_tracing_tpu_torch.ops.response import (
    adaptive_radius, canonical_frames, max_response, ray_ellipsoid_span,
)
from gaussian_ray_tracing_tpu_torch.ops.sh import eval_sh
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene


def hit_events(means, M, radius, origins, dirs, t_lo, t_hi):
    """Per (ray, gaussian) hit event t within [t_lo, t_hi] (broadcast
    against the ray dims). Returns (event_valid, t_event)."""
    hit, t_entry, t_exit = ray_ellipsoid_span(means, M, radius, origins, dirs)
    t_event = torch.where(t_entry < t_lo, t_exit, t_entry)
    return hit & (t_event >= t_lo) & (t_event <= t_hi), t_event


def _per_ray(x, default: float, R: int, device) -> torch.Tensor:
    x = default if x is None else x
    return torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32, device=device), (R,))


def render_rays_oracle(scene: GaussianScene, origins: torch.Tensor, dirs: torch.Tensor,
                       config: RenderConfig, t_lo=None, t_hi=None, t0: torch.Tensor | None = None,
                       ray_chunk: int = 4096):
    """Render a flat batch of rays against every gaussian.

    origins, dirs (R, 3), dirs normalized (zero: a dead ray); t_lo, t_hi
    segment bounds, scalar or (R,) (default config.t_min / t_max); t0 (R,)
    optional carry-in transmittance. Returns rgb (R, 3), density (R,),
    t_final (R,).
    """
    R, dev = origins.shape[0], origins.device
    t_lo = _per_ray(t_lo, config.t_min, R, dev)
    t_hi = _per_ray(t_hi, config.t_max, R, dev)
    t0 = _per_ray(t0, 1.0, R, dev)
    M = canonical_frames(scene.scales, scene.quats)  # (N, 3, 3)
    radius = adaptive_radius(scene.opacities, config.alpha_min)  # (N,)
    parts = []
    for s in range(0, R, ray_chunk):
        sl = slice(s, s + ray_chunk)
        o, d = origins[sl, None, :], dirs[sl, None, :]  # (C, 1, 3) vs (N, 3)
        valid, t_event = hit_events(scene.means, M, radius, o, d, t_lo[sl, None], t_hi[sl, None])
        live = torch.sum(d * d, dim=-1) > 0.01  # (C, 1): |dir| > 0.1 (tracer.cu:59)
        valid = valid & live
        _, order = torch.sort(torch.where(valid, t_event, float("inf")), dim=-1, stable=True)
        # every ray's valid hits lead its order; the rest are alpha-0 hits
        # after them, which change neither the colour nor the final T
        order = order[:, : int(valid.sum(dim=-1).max())]
        g = lambda x: x[order]  # (C, k, ...) per-hit gaussian parameters
        resp, _ = max_response(g(scene.means), g(M), o, d)
        alpha = effective_alpha(resp, g(scene.opacities), config.alpha_clamp)  # (C, k)
        color = eval_sh(g(scene.sh), d, config.sh_degree)  # (C, k, 3)
        parts.append(composite_depth_ordered(
            alpha, color, torch.gather(valid, -1, order), alpha_min=config.alpha_min,
            min_transmittance=config.min_transmittance,
            hit_multiplicity=config.hit_multiplicity, t0=t0[sl]))
    if not parts:
        z = origins.new_zeros((0,))
        return origins.new_zeros((0, 3)), z, z
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def frame_from_rays(rgb, density, valid) -> dict:
    """(H*W, 3) rgb and (H*W,) density of a frame's rays -> {rgb (H, W, 3)
    clipped to [0, 1], alpha (H, W)}, black where no ray exists (fisheye
    r > 1, as the reference clears its output buffer)."""
    H, W = valid.shape
    rgb = torch.clamp(rgb.reshape(H, W, 3), 0.0, 1.0)
    return {"rgb": torch.where(valid[..., None], rgb, 0.0),
            "alpha": torch.where(valid, density.reshape(H, W), 0.0)}


def render_oracle(scene: GaussianScene, camera: Camera, config: RenderConfig = RenderConfig(),
                  ray_chunk: int = 4096) -> dict:
    """Full-frame primary-ray render (no mesh): {rgb (H, W, 3) in [0, 1],
    alpha (H, W)}, on the scene's device."""
    origins, dirs, valid = generate_rays(camera, config)
    rgb, density, _ = render_rays_oracle(scene, origins.reshape(-1, 3), dirs.reshape(-1, 3),
                                         config, ray_chunk=ray_chunk)
    return frame_from_rays(rgb, density, valid)
