"""Hand-made K1 calls of the mesh tracer's two window-order modes (torch
only, any device): block mode (the scalar response from per-ray origins
over a table of 128-row blocks, each tile listing its own) and segments
(the quad response from an eye at the origin on a pair stream), both with
per-ray t_hi and carry-in t0. Each tile is one case, its candidates
isotropic gaussians on the +z axis (the rays start near it and run along
it, or leave the eye at small angles):

  reversed   depth falls along the stream: every ray's list is reversed;
  equal      two runs of identical gaussians (one key each, colours
             apart), the far run first: a fired chunk of equal keys;
  full       every candidate significant (ns = C), depth-sorted but for
             one swap;
  sparse     small gaussians on two rays' lines (one on the first ray's,
             two, the far one first, on the last ray's), the rest far off
             the axis: ns of 0, 1 and 2 (one inversion) in a fired chunk;
  dead_lanes the reversed geometry with lane 0 of every warp dead;
  dead_warps the same with warps 1 and 2 dead;
  dead_tile  every ray dead, its carry-in 1 (above the skip threshold);
  t_hi_ulps  the reversed geometry with each ray's t_hi within two ulps
             of one candidate's float32 entry t.
"""

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops.sh import SH_C0, num_coeffs

KINDS = ("reversed", "equal", "full", "sparse", "dead_lanes", "dead_warps", "dead_tile",
         "t_hi_ulps")
BLOCK = 128  # rows a Morton block (block mode's chunk / block_sub)
SPACING = 1e-3  # ray origins (block mode) or angles (segments) on a square grid


def _ray_grid(rays):
    side = int(np.ceil(np.sqrt(rays)))
    g = (np.arange(side) - (side - 1) / 2) * SPACING
    gx, gy = (x.ravel()[:rays] for x in np.meshgrid(g, g))
    return gx, gy


def _tile(kind, n, rays, cone):
    """Depth z, offsets (x, y), scale and opacity of the n candidates of a
    tile of `kind`, in stream order (cone: the rays leave the eye at the
    origin, at angles on the grid; else they start on the grid, along
    +z)."""
    z = 1.0 + 0.02 * np.arange(n)
    x, y = np.zeros(n), np.zeros(n)
    s, op = np.full(n, 0.4), np.full(n, 0.03)
    if kind in ("reversed", "dead_lanes", "dead_warps", "dead_tile", "t_hi_ulps"):
        z = z[::-1].copy()
    elif kind == "equal":  # per chunk of 128: the far run of 64, then the near one
        z = 2.0 + 1.0 * ((np.arange(n) % 128) < 64) + 2.0 * (np.arange(n) // 128)
    elif kind == "full":
        z[[5, 6]] = z[[6, 5]]
    elif kind == "sparse":
        x[:] = 5.0
        gx, gy = _ray_grid(rays)
        for k, r, zk in ((3, 0, 2.0), (7, rays - 1, 3.0), (9, rays - 1, 2.5), (BLOCK + 3, 0, 4.0)):
            if k < n:
                a = zk / np.sqrt(1.0 + gx[r] ** 2 + gy[r] ** 2)  # on ray r at distance zk
                x[k], y[k], z[k] = (gx[r] * a, gy[r] * a, a) if cone else (gx[r], gy[r], zk)
                # a few neighbouring rays pass through it too (from the eye
                # at this scale: its quad form rounds coarsely below)
                s[k], op[k] = (7.5e-4 * zk if cone else 2e-4), 0.9
    return z, x, y, s, op


def crafted_call(mode, rays=256, degree=0, chunk=128, block_sub=1, chunks=2, seed=0,
                 device="cpu", **cfg_kw):
    """(args, kw) of a K1 window-order call in `mode` ("block" or "segment")
    on one tile of each of KINDS: `chunks` chunks of chunk * block_sub
    candidates a tile (block mode: 128-row blocks, block_sub a chunk)."""
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig

    gen = np.random.default_rng(seed)
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, sh_degree=degree, **cfg_kw)
    c = chunk * block_sub
    n = chunks * c
    K = num_coeffs(degree)
    T = len(KINDS)
    block = mode == "block"
    gx, gy = _ray_grid(rays)
    rows, live, t_hi = [], np.ones((T, rays), bool), np.full((T, rays), cfg.t_max)
    t0 = gen.uniform(0.3, 1.0, (T, rays))
    for t, kind in enumerate(KINDS):
        z, x, y, s, op = _tile(kind, n, rays, not block)
        r2 = 2.0 * np.log(op / cfg.alpha_min)
        sh = gen.uniform(-1.0, 1.0, (n, 3, K))  # SH coefficients per channel
        if block:  # [op, 15 unused, mean, M, radius, sh_r[K], sh_g[K], sh_b[K]]
            row = np.zeros((n, tmarch.scalar_row(degree)))
            row[:, 0] = op
            row[:, tmarch.T_MX:tmarch.T_MX + 3] = np.stack([x, y, z], -1)
            row[:, tmarch.T_M0 + 0] = row[:, tmarch.T_M0 + 4] = row[:, tmarch.T_M0 + 8] = 1 / s
            row[:, tmarch.T_RAD] = np.sqrt(r2)
            row[:, tmarch.T_SH0:tmarch.T_SH0 + 3 * K] = sh.reshape(n, 3 * K)
        else:  # the quad rows of a gaussian at (x, y, z) from the eye at the origin
            row = np.zeros((n, tmarch.quad_row(degree)))
            inv = 1.0 / s**2
            mu = np.stack([x, y, z], -1)
            row[:, 0] = op
            row[:, 1:4] = inv[:, None]
            row[:, 7:10] = -mu * inv[:, None]  # v = Q (eye - mu)
            row[:, 11] = (mu * mu).sum(-1) * inv  # oo
            row[:, 10] = row[:, 11] - r2  # cq
            if degree == 0:
                row[:, 12:15] = np.maximum(0.5 + SH_C0 * sh[:, :, 0], 0.0)
            else:
                row[:, 12:12 + 3 * K] = sh.reshape(n, 3 * K)
        rows.append(row)
        if kind == "dead_lanes":
            live[t, ::32] = False
        elif kind == "dead_warps":
            live[t, 32:96] = False
        elif kind == "dead_tile":
            live[t] = False
            t0[t] = 1.0
    if block:
        origins = np.broadcast_to(np.stack([gx, gy, np.zeros(rays)], -1), (T, rays, 3))
        d = np.broadcast_to(np.array([0.0, 0.0, 1.0]), (T, rays, 3))
    else:
        origins = None
        d = np.stack([gx, gy, np.ones(rays)], -1)
        d = np.broadcast_to(d / np.linalg.norm(d, axis=-1, keepdims=True), (T, rays, 3))
    dirs = np.where(live[..., None], d, 0.0)
    f32 = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
    feats = f32(np.concatenate(rows))
    dirs_t = f32(dirs)
    starts = torch.arange(T + 1, dtype=torch.int32, device=device) * n
    kw = {"t0": f32(t0)}
    if block:  # tile t lists its own blocks, in order
        kw.update(origins_t=f32(origins), block_sub=block_sub,
                  blocks=torch.arange(T * n // BLOCK, dtype=torch.int32, device=device))
    # t_hi_ulps: each ray's t_hi within two ulps of candidate (r mod n)'s
    # float32 entry t, as K1 computes it
    t = KINDS.index("t_hi_ulps")
    r = torch.arange(rays, device=device)
    od, dd, cq = entry_terms(feats[t * n + r % n], dirs_t[t],
                             None if origins is None else f32(origins[t]))
    e = (-od - torch.sqrt(torch.clamp(od * od - dd * cq, min=0.0))) \
        * (1.0 / torch.clamp(dd, min=1e-12))
    off = r % 5 - 2
    toward = torch.where(off > 0, float("inf"), float("-inf")).to(e)
    for i in range(2):
        e = torch.where(off.abs() > i, torch.nextafter(e, toward), e)
    t_hi = f32(t_hi)
    t_hi[t] = e
    kw["t_hi"] = t_hi
    return (starts, feats, dirs_t, cfg, c), kw


def entry_terms(f, d, o=None):
    """od, dd and cq of candidate rows f (..., row) against rays d (..., 3),
    broadcast, as K1 computes them in float32: the quad response from the
    eye's columns, or with per-ray origins o (..., 3) the scalar response
    (csrc/march.cuh eval_quad, eval_scalar)."""
    col = lambda k: f[..., k]
    dx, dy, dz = d.unbind(-1)
    if o is None:
        m2 = (dx * dx, dy * dy, dz * dz, 2.0 * dx * dy, 2.0 * dx * dz, 2.0 * dy * dz)
        dd = col(1) * m2[0] + col(2) * m2[1] + col(3) * m2[2] + col(4) * m2[3] \
            + col(5) * m2[4] + col(6) * m2[5]
        od = col(7) * dx + col(8) * dy + col(9) * dz
        return od, dd, col(10).expand_as(dd)
    ox, oy, oz = (x - col(tmarch.T_MX + k) for k, x in enumerate(o.unbind(-1)))
    m = [col(tmarch.T_M0 + k) for k in range(9)]
    og = [m[3 * i] * ox + m[3 * i + 1] * oy + m[3 * i + 2] * oz for i in range(3)]
    dg = [m[3 * i] * dx + m[3 * i + 1] * dy + m[3 * i + 2] * dz for i in range(3)]
    dd = dg[0] * dg[0] + dg[1] * dg[1] + dg[2] * dg[2]
    od = og[0] * dg[0] + og[1] * dg[1] + og[2] * dg[2]
    oo = og[0] * og[0] + og[1] * og[1] + og[2] * og[2]
    return od, dd, oo - col(tmarch.T_RAD) * col(tmarch.T_RAD)
