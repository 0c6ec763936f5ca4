"""Hand-made K3 calls on wide tiles (torch only, any device): the training
rows of gaussians (random rotations, scales within 40% of each other)
about +z, replayed in key or window order from the eye at the origin
(rays leave it at small angles) or from per-ray origins (rays start on a
grid in the z = 0 plane and run about +z, diverging, each with its own
window, which on the small_dd tile reaches past the huge gaussians'
exits). The gaussians lie off the axis by up to 0.25 (the single kind's
half a scale off its ray), so that no sum over the rays cancels by
symmetry to rounding noise. Each tile is one case, `chunks` chunks of c
candidates; the saved carry-ins are made, not marched: each chunk's is the
last one's times a factor in [0.5, 0.95]. The kinds:

  all_miss     every candidate below alpha_min (op 0.005): a sure miss
               for every ray;
  every_other  every other candidate such a sure miss, the rest random;
  small_dd     huge gaussians (scale 500 to 2000), so that dd = |M d|^2
               lies at and below 1e-6, hit by every ray;
  dead_rows    random candidates; 96 rays from ray 16 on dead (a zero
               direction: lanes 16-31 of warp 0 to lanes 0-15 of warp 3);
  single       every other candidate a small gaussian beside one ray (a
               different ray each; the tile's rays ten times as far
               apart), which that ray alone gates, the rest sure misses;
  skip         random candidates; from chunk 2 on every carry-in is below
               min_transmittance, so those chunks are skipped;
  random       depths, opacities and sizes at random (some below
               alpha_min), chunk 1 empty (every candidate a sure miss),
               the last chunk 37 candidates short (c / 2 + 3 at c <= 40),
               lane 0 of every warp dead.

Tiles of more than 8192 rays replay ceil(R / 8192) rays a thread; at 8320
the second slot holds 128 rays and the rest of its lanes are idle.
"""

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops.sh import num_coeffs

KINDS = ("all_miss", "every_other", "small_dd", "dead_rows", "single", "skip", "random")
SPACING = 1e-2  # ray origins (or angles from the eye) on a square grid (single: 0.1)


def _ray_grid(rays, spacing):
    side = int(np.ceil(np.sqrt(rays)))
    g = (np.arange(side) - (side - 1) / 2) * spacing
    gx, gy = (x.ravel()[:rays] for x in np.meshgrid(g, g))
    return gx, gy


def crafted_bwd_call(order, origin, rays, degree=0, chunk=128, chunks=4, seed=0, device="cpu"):
    """(args, kw) of a K3 call march_bwd(*args, **kw) in `order` ("key" or
    "window") from the eye at the origin (`origin` "eye") or from per-ray
    origins with per-ray windows ("origins"), one tile of each of KINDS,
    `chunks` chunks of `chunk` candidates a tile."""
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig

    gen = np.random.default_rng(seed)
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, sh_degree=degree, order=order)
    n_full = chunks * chunk
    K = num_coeffs(degree)
    T = len(KINDS)
    eye = origin == "eye"
    rows, counts, dirs, origins = [], [], [], []
    live = np.ones((T, rays), bool)
    tin = np.empty((T, chunks, rays))
    for t, kind in enumerate(KINDS):
        # the tile's rays: from the eye through a grid of angles, or from a
        # grid of origins, diverging as a camera's do (no two parallel)
        gx, gy = _ray_grid(rays, 10.0 * SPACING if kind == "single" else SPACING)
        d = np.stack([gx, gy, np.ones(rays)] if eye else [0.3 * gx, 0.3 * gy, np.ones(rays)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dirs.append(d)
        origins.append(np.stack([gx, gy, np.zeros(rays)], -1))
        n = n_full - (37 if chunk > 40 else chunk // 2 + 3) if kind == "random" else n_full
        k = np.arange(n)
        z = gen.uniform(1.0, 6.0, n)
        s = gen.uniform(0.2, 0.6, n)
        op = gen.uniform(0.004, 0.08, n)
        x = gen.uniform(-0.25, 0.25, n)  # off the axis: no sum cancels by symmetry
        y = gen.uniform(-0.25, 0.25, n)
        if kind == "all_miss":
            op[:] = 0.005
        elif kind == "every_other":
            op[1::2] = 0.005
        elif kind == "small_dd":
            s = np.array([2000.0, 1001.0, 1000.0, 999.0, 500.0])[k % 5]
            op = gen.uniform(0.011, 0.03, n)
        elif kind == "single":  # candidate 2q beside a ray near the axis, 1 to 2 away
            central = np.flatnonzero((np.abs(gx) < 0.35) & (np.abs(gy) < 0.35))
            ray = central[(37 * (k // 2)) % len(central)]
            z = gen.uniform(1.0, 2.0, n)
            s[:] = 0.02  # the tile's rays 0.1 apart: a neighbour's pp >= 12
            o = origins[-1][ray] if not eye else np.zeros((n, 3))
            x, y, z = (o[:, i] + d[ray, i] * z for i in range(3))
            x = x + 0.5 * s  # half a scale off the ray: its sums do not cancel
            y = y - 0.3 * s
            op = np.where(k % 2 == 0, 0.5, 0.005)
        elif kind == "random":
            op[(k // chunk) == 1] = 0.005
        r2 = 2.0 * np.log(np.maximum(op, cfg.alpha_min) / cfg.alpha_min)
        row = np.zeros((n, tmarch.train_row(degree)))
        row[:, 0] = op
        row[:, 1:4] = (1.0 / s**2)[:, None]  # the quad columns K3 does not read
        row[:, tmarch.T_MX] = x
        row[:, tmarch.T_MX + 1] = y
        row[:, tmarch.T_MX + 2] = z
        # M = S^-1 R^T: a random rotation and scales within 40% of s, so
        # that no column of M's gradient cancels to rounding noise (the huge
        # small_dd gaussians and the single kind's stay isotropic)
        q = gen.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        w_, a_, b_, c_ = q.T
        rot = np.stack([1 - 2 * (b_ * b_ + c_ * c_), 2 * (a_ * b_ - w_ * c_), 2 * (a_ * c_ + w_ * b_),
                        2 * (a_ * b_ + w_ * c_), 1 - 2 * (a_ * a_ + c_ * c_), 2 * (b_ * c_ - w_ * a_),
                        2 * (a_ * c_ - w_ * b_), 2 * (b_ * c_ + w_ * a_), 1 - 2 * (a_ * a_ + b_ * b_)],
                       -1).reshape(n, 3, 3)
        if kind == "small_dd":
            rot[:] = np.eye(3)
        s3 = s[:, None] * (gen.uniform(0.6, 1.4, (n, 3)) if kind not in ("small_dd", "single")
                           else 1.0)
        row[:, tmarch.T_M0:tmarch.T_M0 + 9] = (rot.transpose(0, 2, 1) / s3[:, :, None]).reshape(n, 9)
        row[:, tmarch.T_RAD] = np.sqrt(r2)
        row[:, tmarch.T_SH0:tmarch.T_SH0 + 3 * K] = gen.uniform(-1.0, 1.0, (n, 3 * K))
        rows.append(row)
        counts.append(n)
        if kind == "dead_rows":
            live[t, 16:16 + 96] = False
        elif kind == "random":
            live[t, ::32] = False
        f = np.cumprod(np.concatenate([gen.uniform(0.3, 1.0, (1, rays)),
                                       gen.uniform(0.5, 0.95, (chunks - 1, rays))]), axis=0)
        if kind == "skip":
            f[2:] = gen.uniform(1e-5, 9e-4, (chunks - 2, rays))
        tin[t] = f
    dirs = np.where(live[..., None], np.stack(dirs), 0.0)
    f32 = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
    starts = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                          device=device)
    chunk_base = torch.arange(T + 1, dtype=torch.int32, device=device) * chunks
    args = (starts, f32(np.concatenate(rows)), f32(dirs), f32(np.zeros(3)),
            f32(tin.reshape(T * chunks, rays)), chunk_base,
            f32(gen.normal(0.0, 1.0, (T, rays, 3))), f32(gen.normal(0.0, 1.0, (T, rays))),
            cfg, chunk)
    kw = {}
    if not eye:
        kw["origins_t"] = f32(np.stack(origins))
        kw["t_lo"] = f32(gen.uniform(0.0, 0.5, (T, rays)))
        t_hi = gen.uniform(3.0, 8.0, (T, rays))
        t_hi[KINDS.index("small_dd")] = 1e4  # past the huge gaussians' exits
        kw["t_hi"] = f32(t_hi)
    return args, kw
