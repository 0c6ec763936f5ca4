"""Ray-triangle intersection (Moller-Trumbore), brute-force closest hit,
reflection and refraction (counterpart of
gaussian_ray_tracing_tpu/ops/intersect.py).

Triangles are double-sided, as in the reference. `closest_hit` sweeps every
face; the render path uses the culled per-tile kernel K4 instead
(ops/tri.py), and the tests use `closest_hit` as its independent witness.
All math is per component, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MeshHit(NamedTuple):
    t: torch.Tensor  # hit distance (inf = miss)
    face: torch.Tensor  # int32 face index (-1 = miss)
    u: torch.Tensor  # barycentric of vertex 1
    v: torch.Tensor  # barycentric of vertex 2

    @property
    def hit(self):
        return self.face >= 0


def moller_trumbore(origins, dirs, v0, e1, e2, t_min: float, t_max: float,
                    edge_eps: float = 1e-6):
    """Intersect rays (..., 3) with triangles given as v0 and the edges e1 =
    v1 - v0, e2 = v2 - v0 (broadcast). Returns (hit, t, u, v). The
    barycentric test has a small tolerance so a ray on a shared edge cannot
    fall between both triangles; the determinant guard is 1e-12."""
    c = lambda a, i: a[..., i]
    ox, oy, oz = c(origins, 0), c(origins, 1), c(origins, 2)
    dx, dy, dz = c(dirs, 0), c(dirs, 1), c(dirs, 2)
    e1x, e1y, e1z = c(e1, 0), c(e1, 1), c(e1, 2)
    e2x, e2y, e2z = c(e2, 0), c(e2, 1), c(e2, 2)
    px = dy * e2z - dz * e2y  # p = d x e2
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    one = torch.ones_like(det)
    inv = one / torch.where(ok, det, one)  # a true division, as in the kernel
    tx, ty, tz = ox - c(v0, 0), oy - c(v0, 1), oz - c(v0, 2)
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y  # q = (o - v0) x e1
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (ok & (u >= -edge_eps) & (v >= -edge_eps) & (u + v <= 1.0 + edge_eps)
           & (t > t_min) & (t < t_max))
    return hit, t, u, v


def closest_hit(origins, dirs, tri_v0, tri_v1, tri_v2, t_min: float, t_max: float,
                face_chunk: int = 2048) -> MeshHit:
    """Closest hit of rays (R, 3) over all faces (F, 3 each), sweeping
    face chunks in order; within a chunk a tie goes to the lower face, and
    a later chunk wins only with a strictly smaller t."""
    R = origins.shape[0]
    dev = origins.device
    best = MeshHit(t=torch.full((R,), float("inf"), device=dev),
                   face=torch.full((R,), -1, dtype=torch.int32, device=dev),
                   u=torch.zeros((R,), device=dev), v=torch.zeros((R,), device=dev))
    e1, e2 = tri_v1 - tri_v0, tri_v2 - tri_v0
    for f0 in range(0, tri_v0.shape[0], face_chunk):
        sl = slice(f0, f0 + face_chunk)
        hit, t, u, v = moller_trumbore(origins[:, None], dirs[:, None], tri_v0[None, sl],
                                       e1[None, sl], e2[None, sl], t_min, t_max)
        t = torch.where(hit, t, float("inf"))
        j = torch.argmin(t, dim=-1, keepdim=True)  # first minimum
        tj = torch.gather(t, 1, j)[:, 0]
        better = tj < best.t
        take = lambda a: torch.gather(a, 1, j)[:, 0]
        best = MeshHit(t=torch.where(better, tj, best.t),
                       face=torch.where(better, (f0 + j[:, 0]).to(torch.int32), best.face),
                       u=torch.where(better, take(u), best.u),
                       v=torch.where(better, take(v), best.v))
    return best


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection d - 2<d,n>n."""
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def refract_or_tir(d: torch.Tensor, n: torch.Tensor, etai_over_etat: float):
    """Snell refraction with total-internal-reflection fallback (the
    reference's refract()): entering a front face uses 1/etai_over_etat,
    a back face flips the normal. Returns (new_dir, reflected_mask)."""
    entering = torch.sum(d * n, dim=-1, keepdim=True) < 0.0
    ri = torch.where(entering, 1.0 / etai_over_etat, etai_over_etat)[..., 0]
    n_eff = torch.where(entering, n, -n)
    cos_theta = torch.clamp(torch.sum(-d * n_eff, dim=-1), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot = ri * sin_theta > 1.0
    facing = torch.sum(d * n_eff, dim=-1, keepdim=True) < 0.0
    d_reflect = reflect(d, torch.where(facing, n_eff, -n_eff))
    r_out_perp = ri[..., None] * (d + cos_theta[..., None] * n_eff)
    par = -torch.sqrt(torch.abs(1.0 - torch.sum(r_out_perp * r_out_perp, dim=-1)))
    d_refract = r_out_perp + par[..., None] * n_eff
    return torch.where(cannot[..., None], d_reflect, d_refract), cannot
