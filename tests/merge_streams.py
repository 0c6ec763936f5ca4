"""Hand-made pair streams for merge order (torch only, any device): each
tile's candidates are isotropic gaussians on the -z axis in front of an eye
at the origin, at depths 1 + spacing * k in stream order (a depth-sorted
stream), with planted inversions and faint (never significant) runs."""

import math

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.ops import march as tmarch


def depth_stream(counts, *, rays=32, op=0.02, scale=0.05, spacing=0.1, jitter=0.0, seed=0,
                 swaps=(), faint=(), alpha_min=0.01, device="cpu"):
    """counts[t] candidates for tile t. swaps: (tile, k) pairs, candidates
    k and k + 1 of the tile trade places (an inversion); faint: (tile, k0,
    k1) triples, candidates k0..k1-1 of the tile take an opacity below
    alpha_min. jitter: the rays' directions spread over a square of that
    half-width (radians) around -z (0: every ray on the axis). Returns
    (starts (T+1,) int32, compact rows (P, ROW) float32, dirs_t (T, rays,
    3) float32, the on-axis entry t of each row (P,) float32)."""
    gen = np.random.default_rng(seed)
    rows, t_entry = [], []
    for t, n in enumerate(counts):
        z = 1.0 + spacing * np.arange(n)
        for tt, k in swaps:
            if tt == t:
                z[[k, k + 1]] = z[[k + 1, k]]
        o = np.full(n, op)
        for tt, k0, k1 in faint:
            if tt == t:
                o[k0:k1] = alpha_min / 2
        r2 = np.maximum(2.0 * np.log(o / alpha_min), 0.0)
        row = np.zeros((n, tmarch.ROW))
        inv_s2 = 1.0 / scale**2
        row[:, 0] = o
        row[:, 1:4] = inv_s2  # q00 q11 q22; the off-diagonal terms stay 0
        row[:, 9] = z * inv_s2  # v = (o - mu) / s^2 = (0, 0, z) / s^2
        row[:, 11] = z * z * inv_s2  # oo
        row[:, 10] = row[:, 11] - r2  # cq = oo - radius^2
        row[:, 12:15] = gen.uniform(0.1, 1.0, (n, 3))
        rows.append(row)
        t_entry.append(z - np.sqrt(r2) * scale)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    side = int(math.ceil(math.sqrt(rays)))
    ang = np.linspace(-jitter, jitter, side) if side > 1 else np.zeros(1)
    ax, ay = (g.ravel()[:rays] for g in np.meshgrid(ang, ang))
    d = np.stack([np.tan(ax), np.tan(ay), -np.ones(rays)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dirs_t = np.broadcast_to(d, (len(counts), rays, 3))
    as_t = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt, device=device)
    return (as_t(starts, torch.int32), as_t(np.concatenate(rows), torch.float32),
            as_t(dirs_t, torch.float32), as_t(np.concatenate(t_entry), torch.float32))
