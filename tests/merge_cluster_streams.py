"""Hand-made K1 calls in merge order on wide tiles (torch only, any device):
the quad response from an eye at the origin on a pair stream, the scalar
response from per-ray origins on a pair stream (with a carry-in t0), the
per-ray-origin quad response on training rows, and block mode (the scalar
response over a table of blocks, each tile listing its own, with a
carry-in). Each tile is one case, its candidates isotropic gaussians on the
+z axis (the rays leave the eye at small angles, or start on a grid near
the axis and run along it), `chunks` chunks of C a tile; in the first
four kinds every third candidate is significant and the others are faint:

  sorted    depth rises along the stream: every chunk passes the tile-wide
            fast test (the pending buffer composites as it stands);
  reversed  depth falls along the stream: every chunk is slow, the first
            while the pending buffer is still fresh (C empties);
  equal     chunks in pairs of equal depths at equal places (colours
            apart): the second's keys equal the pending buffer's, which
            composites first;
  faint     chunks 1 and 3 have no significant candidate (every key a
            running max of none), chunks 0 and 2 reversed;
  skip      opaque gaussians in rising depth: T falls below the skip
            threshold once the first chunk composites, and the tile stops;
  random    depths, opacities and sizes at random (some below alpha_min),
            lane 0 of every warp dead (a zero direction).

Tiles of more than 8192 rays march ceil(R / 8192) rays a thread; at 8320
the second slot holds 128 rays and the rest of its lanes are idle.
"""

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops.sh import SH_C0, num_coeffs

KINDS = ("sorted", "reversed", "equal", "faint", "skip", "random")
MODES = ("quad", "origin", "origin_quad", "block")
SPACING = 1e-3  # ray origins or angles on a square grid


def _ray_grid(rays):
    side = int(np.ceil(np.sqrt(rays)))
    g = (np.arange(side) - (side - 1) / 2) * SPACING
    gx, gy = (x.ravel()[:rays] for x in np.meshgrid(g, g))
    return gx, gy


def _tile(kind, n, c, gen):
    """Depth z, scale and opacity of the n candidates of a tile of `kind`,
    in stream order (chunks of c)."""
    k = np.arange(n)
    z = 1.0 + 0.02 * k
    s = np.full(n, 0.4)
    op = np.where(k % 3 == 0, 0.02, 0.006)  # a third significant (alpha_min 0.01)
    if kind == "reversed":
        z = z[::-1].copy()
    elif kind == "equal":  # chunk 2q + 1 repeats chunk 2q's depths
        z = 1.0 + 0.02 * (k % c) + 3.0 * (k // (2 * c))
    elif kind == "faint":
        z = z[::-1].copy()
        op[(k // c) % 2 == 1] = 0.006  # below alpha_min: no significant candidate
    elif kind == "skip":
        op[:] = 0.99
    elif kind == "random":
        z = gen.uniform(1.0, 6.0, n)
        op = gen.uniform(0.004, 0.08, n)
        s = gen.uniform(0.2, 0.6, n)
    return z, s, op


def crafted_merge_call(mode, rays, degree=0, chunk=128, block_sub=1, chunks=4, seed=0,
                       device="cpu"):
    """(args, kw) of a K1 merge-order call in `mode` (MODES) on one tile of
    each of KINDS, `chunks` chunks of `chunk` candidates a tile (block mode:
    blocks of chunk / block_sub rows, block_sub a chunk)."""
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig

    gen = np.random.default_rng(seed)
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, sh_degree=degree, order="merge",
                       bounce_order="merge")
    n = chunks * chunk
    K = num_coeffs(degree)
    T = len(KINDS)
    cone = mode == "quad"  # rays from the eye at the origin; else per-ray origins along +z
    gx, gy = _ray_grid(rays)
    rows, live = [], np.ones((T, rays), bool)
    for t, kind in enumerate(KINDS):
        z, s, op = _tile(kind, n, chunk, gen)
        r2 = 2.0 * np.log(np.maximum(op, cfg.alpha_min) / cfg.alpha_min)
        sh = gen.uniform(-1.0, 1.0, (n, 3, K))  # SH coefficients per channel
        colour = np.maximum(0.5 + SH_C0 * sh[:, :, 0], 0.0)
        inv = 1.0 / s**2
        if cone:  # the quad rows of a gaussian at (0, 0, z) from the eye at the origin
            row = np.zeros((n, tmarch.quad_row(degree)))
            row[:, 0] = op
            row[:, 1:4] = inv[:, None]
            row[:, 9] = -z * inv  # v = Q (eye - mu)
            row[:, 11] = z * z * inv  # oo
            row[:, 10] = row[:, 11] - r2  # cq
            if degree == 0:
                row[:, 12:15] = colour
            else:
                row[:, 12:12 + 3 * K] = sh.reshape(n, 3 * K)
        else:  # scalar (training) rows: [op, q (6), 5 unused, colour, pad, mean, M, radius, sh]
            row = np.zeros((n, tmarch.scalar_row(degree)))
            row[:, 0] = op
            row[:, 1:4] = inv[:, None]  # Q = M^T M (the per-ray-origin quad response)
            row[:, 12:15] = colour
            row[:, tmarch.T_MX + 2] = z
            row[:, tmarch.T_M0 + 0] = row[:, tmarch.T_M0 + 4] = row[:, tmarch.T_M0 + 8] = 1 / s
            row[:, tmarch.T_RAD] = np.sqrt(r2)
            row[:, tmarch.T_SH0:tmarch.T_SH0 + 3 * K] = sh.reshape(n, 3 * K)
        rows.append(row)
        if kind == "random":
            live[t, ::32] = False
    if cone:
        d = np.stack([gx, gy, np.ones(rays)], -1)
        d = np.broadcast_to(d / np.linalg.norm(d, axis=-1, keepdims=True), (T, rays, 3))
    else:
        d = np.broadcast_to(np.array([0.0, 0.0, 1.0]), (T, rays, 3))
    dirs = np.where(live[..., None], d, 0.0)
    f32 = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
    feats = f32(np.concatenate(rows))
    starts = torch.arange(T + 1, dtype=torch.int32, device=device) * n
    kw = {}
    if not cone:
        kw["origins_t"] = f32(np.broadcast_to(np.stack([gx, gy, np.zeros(rays)], -1),
                                              (T, rays, 3)))
        if mode == "origin_quad":
            kw["quad"] = True
        else:
            kw["t0"] = f32(gen.uniform(0.3, 1.0, (T, rays)))
        if mode == "block":  # tile t lists its own blocks, in order
            bs = chunk // block_sub
            kw.update(block_sub=block_sub,
                      blocks=torch.arange(T * n // bs, dtype=torch.int32, device=device))
    return (starts, feats, f32(dirs), cfg, chunk), kw
