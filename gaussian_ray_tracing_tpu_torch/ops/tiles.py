"""Footprints and tile binning (gaussian_ray_tracing_tpu/ops/tiles.py: the
pair_keys="gaussian" path with its three pair culls, and the per-pair key
paths "tile", "tile_peak" and "affine") for pinhole, OpenCV and fisheye
cameras, and the fixed-capacity per-tile candidate lists of the tiled march
(`bin_tiles`).

Every gaussian's exact footprint (the projected conic's bbox; for
fisheye the polar rectangle of its hit-cone cap) is expanded into (tile,
gaussian) pairs over its clipped tile rect; the gaussians are argsorted by
depth key first, so pairs are emitted in global front-to-back order and a
tile-only sort leaves each tile owning a contiguous depth-ordered segment
of the stream. Per-pair context (owner rank, in-rect offset, rect origin)
arrives through O(N) delta scatters plus one fused multi-channel O(P)
prefix sum (ops/scan.multi_head_fill, kernel K2 on the GPU). Sorts,
scatters, searchsorted and gathers stay torch ops, as the JAX package left
them to XLA. Integer results are bit-identical to the JAX package given the
same footprints.

The per-pair key paths (bin_pairs with geom and config.pair_keys other
than "gaussian") sort each pair by its own tile's depth key instead:
"tile" and "tile_peak" gather the gaussian's context per pair and take the
event t, or the peak t, along the tile's central ray; "affine" carries a
per-gaussian log-t model (affine_tile_keys) onto the stream through four
head fills (K2) and evaluates it per pair. Their gid holds original
gaussian ids (order None), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera, distort_opencv
from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig
from gaussian_ray_tracing_tpu_torch.ops.quaternion import quat_to_rotmat
from gaussian_ray_tracing_tpu_torch.ops.response import adaptive_radius, dot3
from gaussian_ray_tracing_tpu_torch.ops.scan import multi_head_fill

_MARGIN = 1.1  # multiplicative safety margin of the conservative rect
_EPS = 1e-6
_I32 = torch.int32


class PairStream(NamedTuple):
    """Sorted (tile, depth, gaussian) pair stream.

    Tile t owns the contiguous slots [starts[t], starts[t+1]), front to
    back. With `order` (the pair_keys="gaussian" path) gid holds depth
    RANKS: index per-gaussian tables as table[order]. With order None (the
    per-pair key paths) gid holds original gaussian ids.
    """

    gid: torch.Tensor  # (P,) int32 ranks or ids, -1 in empty slots
    # (P,) int32 sorted keys: tile ids (n_tiles in empty slots), or under a
    # per-pair key JAX's packed tile << depth_bits | depth_q (INT32_MAX empty)
    key: torch.Tensor
    starts: torch.Tensor  # (n_tiles+1,) int32 segment starts
    n_pairs: torch.Tensor  # () int32 pairs emitted (pre-clip)
    n_dropped: torch.Tensor  # () int32 pairs lost to capacity overflow
    order: torch.Tensor | None = None  # (N,) depth permutation, or None (ids)


class TileBinning(NamedTuple):
    """Fixed-capacity per-tile candidate lists of a PairStream (the layout
    of the tiled march, models/tiled.py)."""

    cand: torch.Tensor  # (T, max_per_tile) int32 depth ranks (ids if order is None), -1 = empty
    counts: torch.Tensor  # (T,) int32 candidates per tile (clipped to max_per_tile)
    n_pairs: torch.Tensor  # () int32 pairs emitted
    n_dropped: torch.Tensor  # () pairs lost to the capacity or to a tile's cap
    order: torch.Tensor | None = None  # see PairStream.order


class Footprint(NamedTuple):
    px: torch.Tensor  # (N,) pixel-space centre x
    py: torch.Tensor  # (N,) pixel-space centre y
    rx: torch.Tensor  # (N,) conservative pixel half-extent x
    ry: torch.Tensor  # (N,) conservative pixel half-extent y
    depth: torch.Tensor  # (N,) front-to-back sort key
    visible: torch.Tensor  # (N,) bool
    # fisheye only: the annular sector the rect is the bbox of, in NDC
    # around the optical centre, (cphi, sphi, cos_dphi, r_lo, r_hi) each
    # (N,); cos_dphi = -1 marks all azimuths. The pair expansion culls the
    # rect's tiles provably outside it (config.fisheye_cull)
    sector: tuple | None = None

    def to(self, device) -> "Footprint":
        sector = None if self.sector is None else tuple(x.to(device) for x in self.sector)
        return Footprint(*(x.to(device) for x in self[:6]), sector=sector)


def num_tiles(camera: Camera, config: RenderConfig) -> tuple[int, int]:
    return -(-camera.width // config.tile_w), -(-camera.height // config.tile_h)


def _dot3(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(N, 3) . (3,) -> (N,)."""
    return dot3([x[:, k] for k in range(3)], [a[k] for k in range(3)])


def _rt_apply(R: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """R^T a for (N, 3, 3) R and a (3,) axis -> (N, 3)."""
    return dot3([R[:, k, :] for k in range(3)], [a[k] for k in range(3)])


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt(torch.sum(v * v)), min=1e-12)


def _len(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v))


def camera_axis_extents(scales, quats, radius, camera: Camera):
    """Tight half-extents of each iso ellipsoid along the camera axes:
    radius * |S R^T v| for unit axis v (the ellipsoid's support function)."""
    U, V, W = camera.uvw_frame()
    R = quat_to_rotmat(quats)

    def ext(axis):
        sra = scales * _rt_apply(R, axis)
        return radius * torch.sqrt(torch.sum(sra * sra, dim=-1))

    return ext(_unit(U)), ext(_unit(V)), ext(_unit(W))


def _distort_rect_px(xc, yc, hx, hy, camera: Camera, config: RenderConfig):
    """Map an ideal-NDC rect (centre (xc, yc), half-extent (hx, hy), all
    (N,)) through the forward OPENCV distortion to a conservative pixel
    rect: the 8 boundary samples and the centre are distorted and boxed,
    with a multiplicative and an additive margin for the boundary's
    curvature between samples."""
    U, V, W = camera.uvw_frame()
    wlen = _len(W)
    cu, cv = _len(U) / wlen, _len(V) / wlen
    Wpx, Hpx = camera.width, camera.height
    px_lo = px_hi = py_lo = py_hi = None
    for sx in (xc - hx, xc, xc + hx):
        for sy in (yc - hy, yc, yc + hy):
            xd, yd = distort_opencv(sx * cu, sy * cv, config.distortion)
            pxs = (xd / cu + 1.0) * 0.5 * Wpx
            pys = (yd / cv + 1.0) * 0.5 * Hpx
            px_lo = pxs if px_lo is None else torch.minimum(px_lo, pxs)
            px_hi = pxs if px_hi is None else torch.maximum(px_hi, pxs)
            py_lo = pys if py_lo is None else torch.minimum(py_lo, pys)
            py_hi = pys if py_hi is None else torch.maximum(py_hi, pys)
    px = 0.5 * (px_lo + px_hi)
    py = 0.5 * (py_lo + py_hi)
    rx = 0.5 * (px_hi - px_lo) * 1.15 + 2.0
    ry = 0.5 * (py_hi - py_lo) * 1.15 + 2.0
    return px, py, rx, ry


def _cone_azimuth_interval(gf, q0x, q0y):
    """Exact azimuth interval of the quadratic cone d^T G_f d <= 0 in the
    frame basis (z = optical axis): the meridian half-plane at azimuth p
    holds cone directions iff q^T H q <= 0 for q = (cos p, sin p), with
    H = g33 [[g11, g12], [g12, g22]] - [g13, g23][g13, g23]^T. H indefinite:
    the sector pair bounded by H's null directions, the forward nappe's
    being the one holding the cap-axis azimuth q0; H semidefinite or
    degenerate: all azimuths. Returns (e1x, e1y, e2x, e2y, az_wrap)."""
    g11, g12, g13, g22, g23, g33 = gf
    alpha = g33 * g11 - g13 * g13
    beta = g33 * g12 - g13 * g23
    gamma = g33 * g22 - g23 * g23
    detH = alpha * gamma - beta * beta
    az_wrap = detH >= -1e-12 * torch.clamp(alpha * alpha + gamma * gamma, min=1e-30)
    sq = torch.sqrt(torch.clamp(beta * beta - alpha * gamma, min=0.0))
    # both roots from the stable pairing: s/c = (-beta +- sq)/gamma or
    # c/s = (-beta -+ sq)/alpha, whichever denominator is larger
    big_g = torch.abs(gamma) >= torch.abs(alpha)
    e1x = torch.where(big_g, gamma, -beta - sq)
    e1y = torch.where(big_g, -beta + sq, alpha)
    e2x = torch.where(big_g, gamma, -beta + sq)
    e2y = torch.where(big_g, -beta - sq, alpha)

    def unit(x, y):
        n = torch.sqrt(torch.clamp(x * x + y * y, min=1e-30))
        return x / n, y / n

    e1x, e1y = unit(e1x, e1y)
    e2x, e2y = unit(e2x, e2y)
    # orient the endpoints so the axis azimuth lies inside the sector
    # (q0 = a e1 + b e2, flip each by its coefficient's sign); near-parallel
    # endpoints fall back to all azimuths
    det = e1x * e2y - e1y * e2x
    a_c = q0x * e2y - q0y * e2x
    b_c = e1x * q0y - e1y * q0x
    s1 = torch.sign(a_c * det)
    s2 = torch.sign(b_c * det)
    s1 = torch.where(s1 == 0.0, 1.0, s1)
    s2 = torch.where(s2 == 0.0, 1.0, s2)
    az_wrap = az_wrap | (torch.abs(det) < 1e-6)
    e1x, e1y = e1x * s1, e1y * s1
    e2x, e2y = e2x * s2, e2y * s2
    # widen each endpoint ~2e-3 rad away from the axis azimuth (f32 margin)
    eps = 2e-3
    r1 = -torch.sign(e1x * q0y - e1y * q0x) * eps
    r2 = -torch.sign(e2x * q0y - e2y * q0x) * eps
    e1x, e1y = e1x - r1 * e1y, e1y + r1 * e1x
    e2x, e2y = e2x - r2 * e2y, e2y + r2 * e2x
    return e1x, e1y, e2x, e2y, az_wrap


def _cross3(u, v):
    return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0])


def _eigvec(g, lam):
    """Eigenvector of the symmetric 3x3 g = (g00, g01, g02, g11, g12, g22)
    for eigenvalue lam: the largest cross product of two rows of g - lam I
    (unnormalized)."""
    g00, g01, g02, g11, g12, g22 = g
    r0 = (g00 - lam, g01, g02)
    r1 = (g01, g11 - lam, g12)
    r2 = (g02, g12, g22 - lam)
    cands = [_cross3(r0, r1), _cross3(r0, r2), _cross3(r1, r2)]
    n2 = [cx * cx + cy * cy + cz * cz for cx, cy, cz in cands]
    best = torch.argmax(torch.stack(n2, dim=-1), dim=-1)
    pick = lambda k: torch.where(best == 0, cands[0][k],
                                 torch.where(best == 1, cands[1][k], cands[2][k]))
    return pick(0), pick(1), pick(2)


def fisheye_cone_caps(means, scales, quats, radius, camera: Camera):
    """Exact hit-cone caps: per gaussian, the tightest (axis, half-angle)
    spherical cap holding every direction d whose forward ray eye + t d
    meets the iso-ellipsoid. Those directions are one nappe of the cone
    d^T G d <= 0, G = cq Q - (Q o)(Q o)^T (Q = R S^-2 R^T, o = eye - mu,
    cq = o^T Q o - radius^2); the axis is G's negative-eigenvalue direction
    and tan(half-angle) = sqrt(-l0 / min(l1, l2)).

    Returns (ax, ay, az, delta, inside, az1x, az1y, az2x, az2y, az_wrap,
    pol_sup): the unit cap axis toward the gaussian, the half-angle with a
    2e-3 rad margin, the eye-inside mask, the cone's exact frame-basis
    azimuth interval and the support of its elliptical polar extent."""
    R = quat_to_rotmat(quats)
    inv_s2 = 1.0 / torch.clamp(scales * scales, min=1e-20)
    ox = camera.eye[0] - means[:, 0]
    oy = camera.eye[1] - means[:, 1]
    oz = camera.eye[2] - means[:, 2]

    def q_comp(i, j):  # Q = R diag(1/s^2) R^T
        return torch.sum(R[:, i, :] * R[:, j, :] * inv_s2, dim=-1)

    q00, q01, q02 = q_comp(0, 0), q_comp(0, 1), q_comp(0, 2)
    q11, q12, q22 = q_comp(1, 1), q_comp(1, 2), q_comp(2, 2)
    wx = q00 * ox + q01 * oy + q02 * oz  # Q o
    wy = q01 * ox + q11 * oy + q12 * oz
    wz = q02 * ox + q12 * oy + q22 * oz
    cq = ox * wx + oy * wy + oz * wz - radius * radius
    inside = cq <= 0.0

    # G = cq Q - w w^T, normalized for f32-stable eigenvalues
    g00 = cq * q00 - wx * wx
    g01 = cq * q01 - wx * wy
    g02 = cq * q02 - wx * wz
    g11 = cq * q11 - wy * wy
    g12 = cq * q12 - wy * wz
    g22 = cq * q22 - wz * wz
    gmax = torch.maximum(
        torch.maximum(torch.maximum(torch.abs(g00), torch.abs(g11)), torch.abs(g22)),
        torch.maximum(torch.maximum(torch.abs(g01), torch.abs(g02)), torch.abs(g12)),
    )
    gn = 1.0 / torch.clamp(gmax, min=1e-30)
    g00, g01, g02 = g00 * gn, g01 * gn, g02 * gn
    g11, g12, g22 = g11 * gn, g12 * gn, g22 * gn

    # symmetric 3x3 eigenvalues, trigonometric (Cardano) form
    q = (g00 + g11 + g22) * (1.0 / 3.0)
    p1 = g01 * g01 + g02 * g02 + g12 * g12
    d0, d1, d2 = g00 - q, g11 - q, g22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 * (1.0 / 6.0), min=1e-30))
    ip = 1.0 / p
    b00, b11, b22 = d0 * ip, d1 * ip, d2 * ip
    b01, b02, b12 = g01 * ip, g02 * ip, g12 * ip
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    phi = torch.acos(torch.clamp(detb * 0.5, -1.0, 1.0)) * (1.0 / 3.0)
    lam2 = q + 2.0 * p * torch.cos(phi)  # largest
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam1 = 3.0 * q - lam0 - lam2
    delta = torch.atan2(torch.sqrt(torch.clamp(-lam0, min=0.0)),
                        torch.sqrt(torch.clamp(torch.minimum(lam1, lam2), min=1e-30)))
    delta = torch.clamp(delta + 2e-3, max=0.5 * math.pi)
    # near-grazing (lam0 ~ lam1 ~ 0): the axis is ill-conditioned where the
    # cap nears a hemisphere, so treat the gaussian as covering everything
    inside = inside | (torch.minimum(lam1, lam2) < 1e-6)

    g = (g00, g01, g02, g11, g12, g22)
    vx, vy, vz = _eigvec(g, lam0)
    vn = torch.sqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-30))
    sgn = torch.where(vx * ox + vy * oy + vz * oz > 0.0, -1.0, 1.0) / vn  # toward mu
    vx, vy, vz = vx * sgn, vy * sgn, vz * sgn

    # the cone's exact azimuth interval in the frame basis
    U, V, W = camera.uvw_frame()
    e1 = -U / _len(U)
    e2 = -V / _len(V)
    e3 = W / _len(W)

    def gdot(u, w):  # u^T G w
        return (u[0] * (g00 * w[0] + g01 * w[1] + g02 * w[2])
                + u[1] * (g01 * w[0] + g11 * w[1] + g12 * w[2])
                + u[2] * (g02 * w[0] + g12 * w[1] + g22 * w[2]))

    gf = (gdot(e1, e1), gdot(e1, e2), gdot(e1, e3), gdot(e2, e2), gdot(e2, e3), gdot(e3, e3))
    q0x = vx * e1[0] + vy * e1[1] + vz * e1[2]
    q0y = vx * e2[0] + vy * e2[1] + vz * e2[2]
    az1x, az1y, az2x, az2y, az_wrap = _cone_azimuth_interval(gf, q0x, q0y)

    # elliptical polar support: the cone boundary is axis + tan(d_a) cos(psi)
    # v_a + tan(d_b) sin(psi) v_b, so cos theta over it has the linear part
    # +-A, A = |(tan(d_a) v_a.e3, tan(d_b) v_b.e3)|; v_a is the lam1
    # eigenvector, v_b = axis x v_a; clamped by the circular tan(delta)
    vax, vay, vaz = _eigvec(g, lam1)
    van = torch.sqrt(torch.clamp(vax * vax + vay * vay + vaz * vaz, min=1e-30))
    vax, vay, vaz = vax / van, vay / van, vaz / van
    vbx = vy * vaz - vz * vay
    vby = vz * vax - vx * vaz
    vbz = vx * vay - vy * vax
    ta = torch.sqrt(torch.clamp(-lam0, min=0.0) / torch.clamp(lam1, min=1e-30))
    tb = torch.sqrt(torch.clamp(-lam0, min=0.0) / torch.clamp(lam2, min=1e-30))
    va_e3 = vax * e3[0] + vay * e3[1] + vaz * e3[2]
    vb_e3 = vbx * e3[0] + vby * e3[1] + vbz * e3[2]
    tan_delta = torch.tan(torch.clamp(delta, max=0.5 * math.pi - 1e-3))
    pol_sup = torch.minimum(torch.sqrt((ta * va_e3) ** 2 + (tb * vb_e3) ** 2) + 2e-3, tan_delta)
    return (vx, vy, vz, delta, inside, az1x, az1y, az2x, az2y, az_wrap, pol_sup)


def _fisheye_rect(a, b, c, rho, bound_radius, camera: Camera, config: RenderConfig,
                  cone_caps):
    """Fisheye footprint (before the margin): the bbox of the local polar
    rectangle of the gaussian's cap under the equisolid map. The raygen maps
    the local unit vector through the non-orthonormal frame (-U, -V, W), so
    all of it runs on the local sphere l = normalize(a/|U|, b/|V|, c/|W|):
    azimuth maps monotonically (exactly when |U| = |V|), and the polar angle
    warps as tan(theta') = k(p) tan(theta), k(p) = |W| |(cos p/|U|,
    sin p/|V|)|, bounded by its values at the azimuth interval's extremes.
    Returns (px, py, rx, ry, visible, sector) (Footprint.sector)."""
    U, V, W = camera.uvw_frame()
    ulen, vlen, wlen = _len(U), _len(V), _len(W)
    u_hat, v_hat, w_hat = U / ulen, V / vlen, W / wlen
    Wpx, Hpx = camera.width, camera.height
    rho_safe = torch.clamp(rho, min=_EPS)
    lx, ly = a / ulen, b / vlen
    planar = torch.sqrt(torch.clamp(lx * lx + ly * ly, min=_EPS * _EPS))
    f = config.fisheye_focal
    if cone_caps is not None:
        (cax, cay, caz, delta_w, inside,
         az1x, az1y, az2x, az2y, az_wrap, pol_sup) = cone_caps
        ca = cax * (-u_hat[0]) + cay * (-u_hat[1]) + caz * (-u_hat[2])
        cb = cax * (-v_hat[0]) + cay * (-v_hat[1]) + caz * (-v_hat[2])
        cc_ax = cax * w_hat[0] + cay * w_hat[1] + caz * w_hat[2]
    else:  # the bounding sphere's cap
        az_wrap = pol_sup = None
        delta_w = torch.asin(torch.clamp(bound_radius / rho_safe, 0.0, 1.0))
        inside = rho <= bound_radius
        ca, cb, cc_ax = a / rho_safe, b / rho_safe, c / rho_safe

    # world polar coordinates of the cap centre (frame basis)
    cos_t0w = torch.clamp(cc_ax, -1.0, 1.0)
    sin_t0w = torch.sqrt(torch.clamp(1.0 - cos_t0w * cos_t0w, min=0.0))
    t0w = torch.acos(cos_t0w)
    sin_dw = torch.sin(torch.clamp(delta_w, max=0.5 * math.pi))
    wrap = (delta_w >= t0w) | (sin_t0w <= sin_dw)
    t_lo_w = torch.where(wrap, 0.0, torch.clamp(t0w - delta_w, min=0.0))
    t_hi_w = torch.clamp(t0w + delta_w, max=math.pi)
    if pol_sup is not None:
        # elliptical polar extents: cos theta over the cone lies in
        # [num_min, num_max] / denom, num = cc_ax -+ pol_sup, denom in
        # [1, 1/cos delta]; intersected with the circular rectangle
        cos_dw_c = torch.cos(torch.clamp(delta_w, max=0.5 * math.pi))
        num_min = cc_ax - pol_sup
        num_max = cc_ax + pol_sup
        cos_min = torch.clamp(torch.where(num_min >= 0.0, num_min * cos_dw_c, num_min),
                              -1.0, 1.0)
        cos_max = torch.clamp(torch.where(num_max >= 0.0, num_max, num_max * cos_dw_c),
                              -1.0, 1.0)
        t_lo_w = torch.where(wrap, t_lo_w, torch.maximum(t_lo_w, torch.acos(cos_max)))
        t_hi_w = torch.where(wrap, t_hi_w, torch.minimum(t_hi_w, torch.acos(cos_min)))

    # azimuth interval endpoints (world, frame basis)
    su, sv, sw = 1.0 / ulen, 1.0 / vlen, 1.0 / wlen
    if az_wrap is not None:
        c1w, s1w, c2w, s2w = az1x, az1y, az2x, az2y
        awrap = az_wrap
    else:
        cos_dphi_w = torch.where(
            wrap, -1.0,
            torch.sqrt(torch.clamp(1.0 - (sin_dw / torch.clamp(sin_t0w, min=_EPS)) ** 2,
                                   0.0, 1.0)))
        sin_dphi_w = torch.sqrt(torch.clamp(1.0 - cos_dphi_w * cos_dphi_w, min=0.0))
        planar_w = torch.sqrt(torch.clamp(ca * ca + cb * cb, min=_EPS * _EPS))
        cphi0 = ca / planar_w
        sphi0 = cb / planar_w
        c1w = cphi0 * cos_dphi_w + sphi0 * sin_dphi_w  # cos(p0 - dphi)
        s1w = sphi0 * cos_dphi_w - cphi0 * sin_dphi_w
        c2w = cphi0 * cos_dphi_w - sphi0 * sin_dphi_w  # cos(p0 + dphi)
        s2w = sphi0 * cos_dphi_w + cphi0 * sin_dphi_w
        awrap = wrap

    # polar warp factor k(p) over the azimuth interval: cos^2 p ranges over
    # the endpoints', widened to 1 (0) when the interval holds azimuth 0 or
    # pi (+-pi/2); wrap -> the full range
    mxw = c1w + c2w
    myw = s1w + s2w
    mnw = torch.sqrt(torch.clamp(mxw * mxw + myw * myw, min=_EPS * _EPS))
    degen_w = (mxw * mxw + myw * myw) < 1e-8
    cphi_w = mxw / mnw
    sphi_w = myw / mnw
    coshw = torch.clamp(cphi_w * c1w + sphi_w * s1w, -1.0, 1.0)
    full_k = awrap | degen_w
    c2_1 = c1w * c1w
    c2_2 = c2w * c2w
    c2_min = torch.minimum(c2_1, c2_2)
    c2_max = torch.maximum(c2_1, c2_2)
    c2_max = torch.where(full_k | (cphi_w >= coshw) | (-cphi_w >= coshw), 1.0, c2_max)
    c2_min = torch.where(full_k | (sphi_w >= coshw) | (-sphi_w >= coshw), 0.0, c2_min)
    k_of = lambda c2: torch.sqrt(sv * sv + (su * su - sv * sv) * c2) / sw
    ka, kb = k_of(c2_min), k_of(c2_max)
    k_lo = torch.minimum(ka, kb)
    k_hi = torch.maximum(ka, kb)
    warp_t = lambda t, k: torch.atan2(k * torch.sin(t), torch.cos(t))
    theta_lo = torch.minimum(warp_t(t_lo_w, k_lo), warp_t(t_lo_w, k_hi))
    theta_lo = torch.where(wrap, 0.0, torch.clamp(theta_lo, min=0.0))
    # rays exist for theta' <= pi/2 only (r <= 1): clip to the hemisphere
    theta_hi = torch.maximum(warp_t(t_hi_w, k_lo), warp_t(t_hi_w, k_hi))
    theta_hi = torch.clamp(theta_hi, 0.0, 0.5 * math.pi + 0.02)
    r_hi = 2.0 * f * torch.sin(0.5 * theta_hi)
    r_lo = 2.0 * f * torch.sin(0.5 * theta_lo)

    def img_az(cw, sw_):
        x, y = su * cw, sv * sw_
        nrm = torch.sqrt(torch.clamp(x * x + y * y, min=_EPS * _EPS))
        return x / nrm, y / nrm

    c1, s1 = img_az(c1w, s1w)
    c2, s2 = img_az(c2w, s2w)
    # image azimuth centre and half-width (midpoint of the endpoint images;
    # a degenerate midpoint falls back to all azimuths)
    mx, my = c1 + c2, s1 + s2
    mn = torch.sqrt(torch.clamp(mx * mx + my * my, min=_EPS * _EPS))
    degen = (mx * mx + my * my) < 1e-8
    cphi = torch.where(degen, lx / planar, mx / mn)
    sphi = torch.where(degen, ly / planar, my / mn)
    cos_dphi = torch.where(awrap | degen, -1.0,
                           torch.clamp(cphi * c1 + sphi * s1, -1.0, 1.0))
    # the interval holds angle x iff cos(phi0 - x) >= cos(dphi)
    has_xp = cphi >= cos_dphi
    has_xm = -cphi >= cos_dphi
    has_yp = sphi >= cos_dphi
    has_ym = -sphi >= cos_dphi
    big = 4.0

    def extent(cc1, cc2, has_p, has_m):
        hi = torch.maximum(torch.maximum(r_lo * cc1, r_hi * cc1),
                           torch.maximum(r_lo * cc2, r_hi * cc2))
        hi = torch.where(has_p, torch.maximum(hi, r_hi), hi)
        lo = torch.minimum(torch.minimum(r_lo * cc1, r_hi * cc1),
                           torch.minimum(r_lo * cc2, r_hi * cc2))
        lo = torch.where(has_m, torch.minimum(lo, -r_hi), lo)
        return lo, hi

    x_min, x_max = extent(c1, c2, has_xp, has_xm)
    y_min, y_max = extent(s1, s2, has_yp, has_ym)
    x_min = torch.where(inside, -big, x_min)
    x_max = torch.where(inside, big, x_max)
    y_min = torch.where(inside, -big, y_min)
    y_max = torch.where(inside, big, y_max)
    px = (0.5 * (x_min + x_max) + 1.0) * 0.5 * Wpx
    py = (0.5 * (y_min + y_max) + 1.0) * 0.5 * Hpx
    rx = 0.5 * (x_max - x_min) * 0.5 * Wpx
    ry = 0.5 * (y_max - y_min) * 0.5 * Hpx
    # visible hemisphere: theta' <= pi/2 (+ slack); inside-gaussians always
    visible = (theta_lo <= (0.5 * math.pi + 0.05)) | inside
    # the annular sector the bbox came from; inside-gaussians (full cover)
    # keep all azimuths and the full radial range
    sector = (cphi, sphi, torch.where(inside, -1.0, cos_dphi), torch.where(inside, 0.0, r_lo),
              torch.where(inside, big, r_hi))
    return px, py, rx, ry, visible, sector


def project_footprints(means, bound_radius, camera: Camera, config: RenderConfig,
                       extents: tuple | None = None, cone_caps: tuple | None = None
                       ) -> Footprint:
    """Conservative footprints. Pinhole and OpenCV: the extent/z_near rect
    of the camera-axis half-extents `extents` (camera_axis_extents; the
    bounding sphere when None), OpenCV's through the forward distortion.
    Fisheye: the polar rectangle of the hit-cone caps `cone_caps`
    (fisheye_cone_caps), or of the bounding sphere's cap when None."""
    U, V, W = camera.uvw_frame()
    ulen, vlen, wlen = _len(U), _len(V), _len(W)
    rel = means - camera.eye
    a = _dot3(rel, -(U / ulen))
    b = _dot3(rel, -(V / vlen))
    c = _dot3(rel, W / wlen)
    Wpx, Hpx = camera.width, camera.height
    if config.camera_model in (CameraModel.PINHOLE, CameraModel.OPENCV):
        z = torch.clamp(c, min=_EPS)
        ndc_x = a / z * (wlen / ulen)
        ndc_y = b / z * (wlen / vlen)
        px = (ndc_x + 1.0) * 0.5 * Wpx
        py = (ndc_y + 1.0) * 0.5 * Hpx
        ru, rv, rw = extents if extents is not None else (bound_radius,) * 3
        z_near = torch.clamp(c - rw, min=_EPS)
        rx = ru / z_near * (wlen / ulen) * 0.5 * Wpx
        ry = rv / z_near * (wlen / vlen) * 0.5 * Hpx
        visible = (c + rw) > _EPS
        depth = c
        sector = None
        if config.camera_model == CameraModel.OPENCV:
            px, py, rx, ry = _distort_rect_px(ndc_x, ndc_y, rx / (0.5 * Wpx), ry / (0.5 * Hpx),
                                              camera, config)
    elif config.camera_model == CameraModel.FISHEYE:
        rho = torch.sqrt(torch.sum(rel * rel, dim=-1))
        px, py, rx, ry, visible, sector = _fisheye_rect(a, b, c, rho, bound_radius, camera,
                                                        config, cone_caps)
        depth = rho
    else:
        raise ValueError(config.camera_model)
    return Footprint(px=px, py=py, rx=rx * _MARGIN + 1.0, ry=ry * _MARGIN + 1.0, depth=depth,
                     visible=visible & (bound_radius > 0.0), sector=sector)


def project_footprints_conic(means, scales, quats, radius, bound_radius,
                             camera: Camera, config: RenderConfig) -> Footprint:
    """Exact footprints: for pinhole and OpenCV the tight bounding box of
    each iso ellipsoid's projected conic (OpenCV's through the forward
    distortion), falling back to the conservative rect where the ellipsoid
    is not strictly in front of the eye plane; for fisheye the exact
    hit-cone caps through the polar rectangle.

    The supporting planes n(k) = cc*u' - k*w_hat of {ndc_x >= k} touch the
    ellipsoid where n.(mu - eye) = -radius |S R^T n|, which squares to
    a k^2 - 2 b k + c = 0 with B = (mu-eye).w_hat, X = (mu-eye).n0,
    P = S R^T n0, Q = S R^T w_hat and
      a = B^2 - r^2 |Q|^2,  b = X B - r^2 P.Q,  c = X^2 - r^2 |P|^2;
    the discriminant is taken in the cancellation-free product form
    r^2 (|B P - X Q|^2 - r^2 |P x Q|^2). Lossless: rays outside the conic
    never clear alpha_min in the march.
    """
    if config.camera_model == CameraModel.FISHEYE and config.exact_bbox:
        caps = fisheye_cone_caps(means, scales, quats, radius, camera)
        return project_footprints(means, bound_radius, camera, config, cone_caps=caps)
    extents = camera_axis_extents(scales, quats, radius, camera)
    fp = project_footprints(means, bound_radius, camera, config, extents)
    if config.camera_model == CameraModel.FISHEYE or not config.exact_bbox:
        return fp

    U, V, W = camera.uvw_frame()
    ulen, vlen, wlen = _len(U), _len(V), _len(W)
    u_p = -U / ulen
    v_p = -V / vlen
    w_hat = W / wlen
    cu, cv = wlen / ulen, wlen / vlen

    rel = means - camera.eye
    B = _dot3(rel, w_hat)
    Xu = _dot3(rel, cu * u_p)
    Xv = _dot3(rel, cv * v_p)

    R = quat_to_rotmat(quats)
    srt = lambda axis: scales * _rt_apply(R, axis)  # S R^T axis, (N, 3)
    Pu, Pv, Q = srt(cu * u_p), srt(cv * v_p), srt(w_hat)
    r2 = radius * radius
    qq = torch.sum(Q * Q, dim=-1)
    a = B * B - r2 * qq

    def interval(X, P):
        b = X * B - r2 * torch.sum(P * Q, dim=-1)
        Vv = B[:, None] * P - X[:, None] * Q
        C = torch.linalg.cross(P, Q)
        D = r2 * (torch.sum(Vv * Vv, dim=-1) - r2 * torch.sum(C * C, dim=-1))
        sq = torch.sqrt(torch.clamp(D, min=0.0))
        a_safe = torch.clamp(a, min=_EPS)
        return b / a_safe, sq / a_safe  # (ndc centre, ndc half-extent)

    kcu, khu = interval(Xu, Pu)
    kcv, khv = interval(Xv, Pv)
    exact = (a > 0.0) & (B > 0.0)
    Wpx, Hpx = camera.width, camera.height
    if config.camera_model == CameraModel.OPENCV:
        px, py, rx, ry = _distort_rect_px(kcu, kcv, khu, khv, camera, config)
    else:
        px = (kcu + 1.0) * 0.5 * Wpx
        py = (kcv + 1.0) * 0.5 * Hpx
        rx = khu * 0.5 * Wpx + 1.0
        ry = khv * 0.5 * Hpx + 1.0
    return Footprint(
        px=torch.where(exact, px, fp.px),
        py=torch.where(exact, py, fp.py),
        rx=torch.where(exact, rx, fp.rx),
        ry=torch.where(exact, ry, fp.ry),
        depth=fp.depth,
        visible=fp.visible,
    )


def projection_conics(geom: tuple, camera: Camera) -> tuple:
    """Per-gaussian homogeneous quadratic G of the exact hit conic in NDC
    (JAX ops/tiles.py projection_conics). With the unit-sphere canonical
    map Mt = M / radius, a primary ray of NDC coords k = (kx, ky) has
    direction d(k) = kx (-U) + ky (-V) + W, and its line meets the iso
    ellipsoid iff q(k) = (o.d~)^2 - (|o|^2 - 1) |d~|^2 >= 0 with d~ = Mt
    d(k), o = Mt (eye - mu): a quadratic form khat^T G khat in khat = (kx,
    ky, 1), the march's disc >= 0 gate. G holds for every gaussian (an eye
    inside the ellipsoid makes q > 0 everywhere: nothing is culled).

    geom: (means (N, 3), M9 (N, 9) rows of S^-1 R^T, radius (N,)). Returns
    six (N,) float32 columns (g00, g01, g11, g02, g12, g22), normalized
    per gaussian to unit max-abs for float32 headroom."""
    means, M9, radius = geom
    eye = camera.eye
    U, V, W = camera.uvw_frame()
    Mt = M9 * (1.0 / torch.clamp(radius, min=1e-12))[:, None]

    def mdot(v):
        return tuple(dot3([Mt[:, 3 * i + k] for k in range(3)], [v[k] for k in range(3)])
                     for i in range(3))

    o = mdot([eye[k] - means[:, k] for k in range(3)])
    au, av, aw = mdot(-U), mdot(-V), mdot(W)
    lam = dot3(o, o) - 1.0
    s_u, s_v, s_w = dot3(au, o), dot3(av, o), dot3(aw, o)
    g = (s_u * s_u - lam * dot3(au, au), s_u * s_v - lam * dot3(au, av),
         s_v * s_v - lam * dot3(av, av), s_u * s_w - lam * dot3(au, aw),
         s_v * s_w - lam * dot3(av, aw), s_w * s_w - lam * dot3(aw, aw))
    gmax = torch.stack([x.abs() for x in g]).amax(dim=0)
    sc = 1.0 / torch.clamp(gmax, min=1e-30)
    return tuple(x * sc for x in g)


def _conic_rect_cull(gc, kx0, kx1, ky0, ky1):
    """True where the pair is provably dead: the max of q over the NDC
    rect [kx0, kx1] x [ky0, ky1] is < 0 (no ray through the tile clears
    alpha_min). The max of a 2D quadratic over a box is at a corner, an
    edge critical point or the interior critical point; every candidate is
    clamped into the rect, so the running max never exceeds the true max
    (sound) and the candidates hold every possible argmax (complete). NaNs
    keep the pair."""
    g00, g01, g11, g02, g12, g22 = gc

    def q(x, y):
        return (g00 * x + 2.0 * g01 * y + 2.0 * g02) * x + (g11 * y + 2.0 * g12) * y + g22

    m = torch.maximum(torch.maximum(q(kx0, ky0), q(kx0, ky1)),
                      torch.maximum(q(kx1, ky0), q(kx1, ky1)))
    # edge criticals (the denominator forced negative: a convex edge lands
    # on an endpoint after the clamp, which the corners cover)
    den_y = torch.clamp(g11, max=-1e-30)
    for x in (kx0, kx1):
        m = torch.maximum(m, q(x, torch.clamp(-(g01 * x + g12) / den_y, ky0, ky1)))
    den_x = torch.clamp(g00, max=-1e-30)
    for y in (ky0, ky1):
        m = torch.maximum(m, q(torch.clamp(-(g01 * y + g02) / den_x, kx0, kx1), y))
    det = g00 * g11 - g01 * g01
    det_s = torch.where(det.abs() < 1e-30, 1e-30, det)
    xi = torch.clamp((g01 * g12 - g11 * g02) / det_s, kx0, kx1)
    yi = torch.clamp((g01 * g02 - g00 * g12) / det_s, ky0, ky1)
    m = torch.maximum(m, q(xi, yi))
    return m < -1e-5  # the margin absorbs float32 rounding of the normalized form


def _conic_row_span(gc, ky0, ky1):
    """Conservative NDC x-interval of the live region {q >= 0} over the NDC
    y-slab [ky0, ky1]. For an ellipse (g00 < 0, g11 < 0, det > 0) the live
    region is convex, so the slab's x-extent lies at a slab boundary (the
    roots of the fixed-ky quadratic) or at the region's global x-extreme
    (the y-eliminated quadratic) when its critical ky is inside the slab.
    Returns (xmin, xmax, ok): ok False means not provably boundable (the
    caller keeps the full rect row); xmin > xmax with ok means a dead row."""
    g00, g01, g11, g02, g12, g22 = gc
    ok = (g00 < -1e-12) & (g11 < -1e-12) & (g00 * g11 - g01 * g01 > 0.0)
    inf = float("inf")

    def fold(lo, hi, r1, r2, has):
        lo = torch.minimum(lo, torch.where(has, torch.minimum(r1, r2), inf))
        hi = torch.maximum(hi, torch.where(has, torch.maximum(r1, r2), -inf))
        return lo, hi

    lo, hi = torch.full_like(g00, inf), torch.full_like(g00, -inf)
    inv = 1.0 / torch.clamp(g00, max=-1e-30)
    for ky in (ky0, ky1):
        b = g01 * ky + g02
        cc = (g11 * ky + 2.0 * g12) * ky + g22
        disc = b * b - g00 * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        lo, hi = fold(lo, hi, (-b - sq) * inv, (-b + sq) * inv, disc >= 0.0)
    # global x-extremes: eliminate ky (critical ky(x) = -(g01 x + g12) / g11)
    inv11 = 1.0 / torch.clamp(g11, max=-1e-30)
    a_t = g00 - g01 * g01 * inv11
    b_t = g02 - g01 * g12 * inv11
    c_t = g22 - g12 * g12 * inv11
    disc_t = b_t * b_t - a_t * c_t
    s_t = torch.sqrt(torch.clamp(disc_t, min=0.0))
    inv_t = 1.0 / torch.clamp(a_t, max=-1e-30)
    for sgn in (-1.0, 1.0):
        x_e = (-b_t + sgn * s_t) * inv_t
        ky_e = -(g01 * x_e + g12) * inv11
        lo, hi = fold(lo, hi, x_e, x_e, (disc_t >= 0.0) & (ky_e > ky0) & (ky_e < ky1))
    margin = 1e-4  # NDC; |g| <= 1 keeps root rounding well below this
    return lo - margin, hi + margin, ok


def _edge_row_spans(conics, x0, y0, sw, sh, camera: Camera, config: RenderConfig,
                    row_lo: int = 0):
    """Exact conic x-spans of each gaussian's top and bottom tile rows;
    middle rows keep the rect's full width, so the expansion's slot
    arithmetic stays invertible with per-gaussian constants. A single row
    gets its exact span (w1 = 0); a dead edge row gets w = 0. Returns (d0,
    w0, d1, w1) (N,) int32: offsets from x0 and widths, conservative
    (rows that cannot be bounded keep the full width)."""
    th, tw = config.tile_h, config.tile_w
    Hpx, Wpx = camera.height, camera.width

    def span_for(ty_local):
        fy = (ty_local + row_lo).to(torch.float32)
        ky0 = 2.0 * (fy * th) / Hpx - 1.0
        ky1 = 2.0 * (fy * th + th) / Hpx - 1.0
        xmin, xmax, ok = _conic_row_span(conics, ky0, ky1)
        sx0 = torch.floor((xmin + 1.0) * (0.5 * Wpx / tw)).to(_I32)
        sx1 = torch.floor((xmax + 1.0) * (0.5 * Wpx / tw)).to(_I32)
        x1 = x0 + sw - 1
        empty = ok & ((sx1 < x0) | (sx0 > x1) | (xmin > xmax))
        a = torch.where(ok, torch.clamp(sx0, x0, x1), x0)
        b = torch.where(ok, torch.clamp(sx1, x0, x1), x1)
        return torch.where(empty, 0, a - x0), torch.where(empty, 0, b - a + 1)

    d0, w0 = span_for(y0)
    d1, w1 = span_for(y0 + sh - 1)
    one_row = sh <= 1
    return d0, w0, torch.where(one_row, 0, d1), torch.where(one_row, 0, w1)


def _tile_ndc(tx, ty, camera: Camera, config: RenderConfig):
    """NDC rect (kx0, kx1, ky0, ky1) of tiles (tx, ty) (the pixel_ndc
    convention k = 2 px / W - 1, covering every pixel centre of the tile)."""
    tw, th = config.tile_w, config.tile_h
    fx, fy = tx.to(torch.float32), ty.to(torch.float32)
    return (2.0 * (fx * tw) / camera.width - 1.0, 2.0 * (fx * tw + tw) / camera.width - 1.0,
            2.0 * (fy * th) / camera.height - 1.0, 2.0 * (fy * th + th) / camera.height - 1.0)


def _sector_cull(sector, kx0, kx1, ky0, ky1, camera: Camera):
    """True where a fisheye pair's tile rect lies provably outside its
    gaussian's annular sector (cphi, sphi, cos_dphi, r_lo, r_hi): entirely
    beyond r_hi or inside the r_lo hole, or (cos_dphi >= 0, the sector
    within its centre-azimuth cone) entirely beyond either boundary line of
    the wedge, a linear functional whose minimum over the rect is the sum of
    per-axis minima. pad covers the rect's own margin and pixel-centre
    slack."""
    cph, sph, cdp, rlo, rhi = sector
    nx = torch.clamp(torch.zeros_like(kx0), kx0, kx1)  # the rect's point nearest the centre
    ny = torch.clamp(torch.zeros_like(ky0), ky0, ky1)
    mind2 = nx * nx + ny * ny
    ax_m = torch.maximum(kx0.abs(), kx1.abs())
    ay_m = torch.maximum(ky0.abs(), ky1.abs())
    maxd2 = ax_m * ax_m + ay_m * ay_m
    pad = 0.002 + 6.0 / camera.width  # eigensolve margin + ~3 px slack (NDC)
    rhi_p = rhi + pad
    rlo_p = torch.clamp(rlo - pad, min=0.0)
    dead_r = (mind2 > rhi_p * rhi_p) | (maxd2 < rlo_p * rlo_p)
    # with m = (cph, sph): L(p) = cross(m, p) cdp - dot(m, p) sdp and R(p) =
    # -cross(m, p) cdp - dot(m, p) sdp, each > 0 beyond its boundary line
    sdp = torch.sqrt(torch.clamp(1.0 - cdp * cdp, min=0.0))
    ax_l, ay_l = -sph * cdp - cph * sdp, cph * cdp - sph * sdp
    ax_r, ay_r = sph * cdp - cph * sdp, -cph * cdp - sph * sdp
    min_l = torch.minimum(kx0 * ax_l, kx1 * ax_l) + torch.minimum(ky0 * ay_l, ky1 * ay_l)
    min_r = torch.minimum(kx0 * ax_r, kx1 * ax_r) + torch.minimum(ky0 * ay_r, ky1 * ay_r)
    dead_az = (cdp >= 0.0) & ((min_l > pad) | (min_r > pad))
    return dead_r | dead_az


def _tile_rects(fp: Footprint, camera: Camera, config: RenderConfig, tile_rows=None):
    """Clipped tile-rect origin (x0, y0), width sw and pair count per
    gaussian. An invisible gaussian counts 0 pairs whatever its px, py,
    rx, ry: its head-fill deltas share a slot with the next owner's and
    telescope away, so the pair stream never reads its rect.

    tile_rows: optional (row_lo, n_rows), the band of tile rows [row_lo,
    row_lo + n_rows) one ray shard bins (parallel/sharded.py); y0 is then
    band-local. As in the JAX package (ops/tiles.py:971-1000), a band that
    reaches past the grid keeps the rows of a footprint that reaches past
    the image's last row (the float clip to ty_n + 1), so its padded rows
    may hold pairs; the frame never reads them."""
    tw, th = config.tile_w, config.tile_h
    tx_n, ty_n = num_tiles(camera, config)
    row_lo, row_hi = (0, ty_n) if tile_rows is None else (tile_rows[0], sum(tile_rows))

    # float-clip before the int cast: projected centres of near/behind-
    # camera gaussians can be astronomically large
    def tile_of(v, size, n_t):
        return torch.floor(torch.clamp(v / size, -2.0, n_t + 1.0)).to(_I32)

    fx0 = tile_of(fp.px - fp.rx, tw, tx_n)
    fx1 = tile_of(fp.px + fp.rx, tw, tx_n)
    fy0 = tile_of(fp.py - fp.ry, th, ty_n)
    fy1 = tile_of(fp.py + fp.ry, th, ty_n)
    on = (fx1 >= 0) & (fy1 >= row_lo) & (fx0 < tx_n) & (fy0 < row_hi) & fp.visible
    x0 = torch.clamp(fx0, 0, tx_n - 1)
    x1 = torch.clamp(fx1, 0, tx_n - 1)
    y0 = torch.clamp(fy0, row_lo, row_hi - 1) - row_lo
    y1 = torch.clamp(fy1, row_lo, row_hi - 1) - row_lo
    sw = x1 - x0 + 1
    count = torch.where(on, sw * (y1 - y0 + 1), torch.zeros_like(sw))
    return x0, y0, sw, count


def footprint_pair_count(fp: Footprint, camera: Camera, config: RenderConfig,
                         tile_rows=None) -> torch.Tensor:
    """Exact pair count of footprints over the grid (or a band of tile
    rows, as in bin_pairs), without expanding the stream."""
    return torch.sum(_tile_rects(fp, camera, config, tile_rows)[3], dtype=torch.int64)


def count_pairs(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Exact (tile, gaussian) pair count of a frame, from O(N) footprint
    math only (no expansion), for sizing the pair capacity up front."""
    radius = adaptive_radius(scene.opacities, config.alpha_min)
    bound_radius = radius * torch.amax(scene.scales, dim=-1)
    fp = project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                  bound_radius, camera, config)
    return footprint_pair_count(fp, camera, config)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0).to(_I32)  # cumsum promotes to int64


def _bin_pairs_presorted(fp: Footprint, camera: Camera, config: RenderConfig,
                         cap: int, use_kernel: bool = True, tile_rows=None, conics=None,
                         spans=None, sector=None) -> PairStream:
    """Gather-free pair expansion over depth-sorted gaussians
    (gaussian_ray_tracing_tpu/ops/tiles.py _bin_pairs_presorted). With
    tile_rows (see _tile_rects) the tiles, their ids and starts are the
    band's.

    Optional culls, each lossless: spans (_edge_row_spans: each gaussian's
    top and bottom rows emit only their conic x-span, so the count shrinks
    and every stage downstream with it); conics (projection_conics: a pair
    whose tile rect lies outside its conic is dropped before the tile
    sort); sector (Footprint.sector: a fisheye pair whose tile rect lies
    outside its annular sector is dropped). Their per-gaussian columns ride
    the same fused head fill as the integer context, the float ones as
    their int32 bits (delta and prefix sum are exact integer arithmetic, so
    the bits round-trip). n_pairs counts the emitted pairs, the culled
    ones among them; starts[-1] the pairs kept."""
    tx_n, ty_n = num_tiles(camera, config)
    n_tiles = tx_n * (ty_n if tile_rows is None else tile_rows[1])
    n = fp.px.shape[0]
    dev = fp.px.device
    row_lo = 0 if tile_rows is None else tile_rows[0]

    x0, y0, sw, count = _tile_rects(fp, camera, config, tile_rows)
    bx = max(1, (tx_n - 1).bit_length())
    by = max(1, (ty_n - 1).bit_length())
    bsw = max(1, tx_n.bit_length())  # sw can equal tx_n
    if bx + by + bsw > 31:
        raise ValueError(f"tile grid too large to pack: {tx_n}x{ty_n}")

    bsh = max(1, ty_n.bit_length())  # sh can equal ty_n
    span_chans = None
    if spans is not None and 2 * bsw + bsh <= 31:
        # 3-zone expansion: row 0 emits [d0, d0 + w0), middle rows the full
        # width, the last row [d1, d1 + w1)
        d0, w0, d1, w1 = spans
        sw1 = torch.clamp(sw, min=1)
        sh = torch.floor(count.to(torch.float32) / sw1.to(torch.float32)).to(_I32)
        count = torch.where(count > 0, w0 + torch.clamp(sh - 2, min=0) * sw1
                            + torch.where(sh >= 2, w1, 0), 0).to(_I32)
        span_chans = ((d0 << bsw) | w0, (d1 << (bsw + bsh)) | (w1 << bsh) | sh)

    # depth pre-sort (N): float bits of a positive key sort like the key
    d = torch.clamp(fp.depth, 1e-30, 1e30)
    order = torch.sort(d.view(_I32), stable=True).indices
    x0, y0, count = x0[order], y0[order], count[order]
    sw = torch.clamp(sw[order], min=1)
    bits = lambda v: v[order].contiguous().view(_I32)  # float columns as int32 bits

    offsets = _cumsum_i32(count) - count  # exclusive
    total = (offsets[-1] + count[-1]) if n else torch.zeros((), dtype=_I32, device=dev)
    first = torch.clamp(offsets, max=cap)

    ranks = torch.arange(n, dtype=_I32, device=dev)
    packedv = (x0 << (by + bsw)) | (y0 << bsw) | sw
    # rank + in-rect offset share one channel when they fit 31 bits: the
    # pair index r = slot - offsets[owner] < count <= n_tiles, so only the
    # low b_off offset bits matter (the subtraction is exact mod 2^b_off)
    rank_bits_n = max(1, n.bit_length())
    b_off = max(1, n_tiles.bit_length())
    pack_off = rank_bits_n + b_off <= 31
    if pack_off:
        off_mask = (1 << b_off) - 1
        fill_vals = [((ranks + 1) << b_off) | (offsets & off_mask), packedv]
    else:
        fill_vals = [ranks + 1, offsets, packedv]
    base = len(fill_vals)
    if span_chans is not None:
        fill_vals += [ch[order] for ch in span_chans]
    base_conics = len(fill_vals)
    if conics is not None:
        fill_vals += [bits(g) for g in conics]
    base_sector = len(fill_vals)
    if sector is not None:
        fill_vals += [bits(v) for v in sector]
    filled = multi_head_fill(first, fill_vals, cap, use_kernel=use_kernel)
    slot = torch.arange(cap, dtype=_I32, device=dev)
    if pack_off:
        ch0, packed = filled[:2]
        rank_f = _srl(ch0, b_off)
        r = (slot - (ch0 & off_mask)) & off_mask
    else:
        rank_f, off_pair, packed = filled[:3]
        r = slot - off_pair
    gsrc = rank_f - 1
    valid = (slot < torch.clamp(total, max=cap)) & (gsrc >= 0)

    sw_p = packed & ((1 << bsw) - 1)
    y0_p = _srl(packed, bsw) & ((1 << by) - 1)
    x0_p = _srl(packed, by + bsw)
    # float reciprocal division is exact here (r, sw < 2^24)
    swf = sw_p.to(torch.float32)
    if span_chans is not None:
        # 3-zone decode (sh == 1: row 0 only; w == 0 rows emit nothing)
        chb, chc = filled[base], filled[base + 1]
        mask_sw = (1 << bsw) - 1
        w0p, d0p = chb & mask_sw, _srl(chb, bsw)
        sh_p = chc & ((1 << bsh) - 1)
        w1p = _srl(chc, bsh) & mask_sw
        d1p = _srl(chc, bsh + bsw)
        in0 = r < w0p
        rm = r - w0p
        nmid = sh_p - 2
        qm = torch.floor(rm.to(torch.float32) / swf).to(_I32)
        in_last = ~in0 & (qm >= nmid)
        q = torch.where(in0, 0, torch.where(in_last, sh_p - 1, 1 + qm))
        col = torch.where(in0, d0p + r, torch.where(in_last, d1p + (rm - nmid * sw_p),
                                                    rm - qm * sw_p))
    else:
        q = torch.floor(r.to(torch.float32) / swf).to(_I32)
        col = r - q * sw_p
    tile = (y0_p + q) * tx_n + x0_p + col
    if conics is not None or sector is not None:
        rect = _tile_ndc(x0_p + col, y0_p + q + row_lo, camera, config)
        as_f32 = lambda chans: tuple(x.view(torch.float32) for x in chans)
        if conics is not None:
            valid = valid & ~_conic_rect_cull(as_f32(filled[base_conics : base_conics + 6]),
                                              *rect)
        if sector is not None:
            valid = valid & ~_sector_cull(as_f32(filled[base_sector : base_sector + 5]), *rect,
                                          camera)

    # tile sort: with tile and rank bits fitting 31, one packed key array
    # (tile << rank_bits | rank) is globally unique, so an unstable
    # keys-only sort keeps the within-tile depth order
    rank_bits = max(1, (n - 1).bit_length()) if n > 1 else 1
    tile_bits = max(1, n_tiles.bit_length())
    bounds = torch.arange(n_tiles + 1, dtype=_I32, device=dev)
    if rank_bits + tile_bits <= 31:
        sentinel = n_tiles << rank_bits
        pkey = torch.where(valid, (tile << rank_bits) | gsrc,
                           torch.full_like(tile, sentinel))
        key_s = torch.sort(pkey).values
        gid_s = torch.where(key_s >= sentinel, torch.full_like(key_s, -1),
                            key_s & ((1 << rank_bits) - 1))
        starts = torch.searchsorted(key_s, bounds << rank_bits, out_int32=True)
        key_s = _srl(key_s, rank_bits)
    else:
        key = torch.where(valid, tile, torch.full_like(tile, n_tiles))
        payload = torch.where(valid, gsrc, torch.full_like(gsrc, -1))
        key_s, perm = torch.sort(key, stable=True)  # keeps emission order
        gid_s = payload[perm]
        starts = torch.searchsorted(key_s, bounds, out_int32=True)
    n_dropped = torch.clamp(total - cap, min=0)
    return PairStream(gid=gid_s, key=key_s, starts=starts, n_pairs=total,
                      n_dropped=n_dropped, order=order)


_INT32_MAX = 2**31 - 1
_LOGT_RANGE = (math.log(1e-4), math.log(1e6))
_QBITS = 16  # value-quantization bits of the affine key model
_SLOPE_MAX = 4095
_SLOPE_OFF = 4096


def _depth_bits(n_tiles: int) -> tuple[int, int]:
    """(tile_bits, depth_bits) splitting a non-negative int32 sort key."""
    tile_bits = max(1, math.ceil(math.log2(n_tiles + 2)))
    if tile_bits > 24:
        raise ValueError(f"too many tiles for packed binning: {n_tiles}")
    return tile_bits, 31 - tile_bits


def _quantize_depth(depth: torch.Tensor, depth_bits: int) -> torch.Tensor:
    """Monotone quantization of positive float depth: the top depth_bits of
    its float32 bits (a positive float's bits sort like the float)."""
    d = torch.clamp(depth, 1e-30, 1e30).contiguous()
    return _srl(d.view(_I32), 31 - depth_bits)


def _owners(count: torch.Tensor, cap: int):
    """Exclusive offsets, the total and each slot's owning gaussian of the
    pair expansion (JAX's scatter-max at each head slot, then a running
    max: offsets never decrease, so the largest id marked at or before a
    slot owns it; zero-count gaussians share their successor's slot and
    lose the max). Returns (offsets, total, first, gsrc (cap,), valid)."""
    n, dev = count.shape[0], count.device
    offsets = _cumsum_i32(count) - count
    total = (offsets[-1] + count[-1]) if n else torch.zeros((), dtype=_I32, device=dev)
    first = torch.clamp(offsets, max=cap)
    buf = torch.zeros(cap + 1, dtype=_I32, device=dev).scatter_reduce_(
        0, first.long(), torch.arange(1, n + 1, dtype=_I32, device=dev), reduce="amax")
    gsrc = torch.cummax(buf[:cap], dim=0).values - 1
    slot = torch.arange(cap, dtype=_I32, device=dev)
    valid = (slot < torch.clamp(total, max=cap)) & (gsrc >= 0)
    return offsets, total, first, gsrc, valid


def _sorted_stream(key, gsrc, valid, n_tiles: int, depth_bits: int, total, cap: int) -> PairStream:
    """Sort the packed per-pair keys (tile << depth_bits | depth_q) with
    the owners as payload. JAX sorts with jax.lax.sort_key_val, which
    promises no stability but on XLA's CPU backend returns equal keys in
    slot order; the stable sort here does so everywhere, so equal keys keep
    ascending gaussian id."""
    key = torch.where(valid, key, torch.full_like(key, _INT32_MAX))
    payload = torch.where(valid, gsrc, torch.full_like(gsrc, -1))
    key_s, perm = torch.sort(key, stable=True)
    bounds = torch.arange(n_tiles + 1, dtype=_I32, device=key.device) << depth_bits
    starts = torch.searchsorted(key_s, bounds, out_int32=True)
    return PairStream(gid=payload[perm], key=key_s, starts=starts, n_pairs=total,
                      n_dropped=torch.clamp(total - cap, min=0))


def _pinhole_dir(ndc_x, ndc_y, U, V, W) -> list:
    """The unnormalized pinhole direction ndc_x (-U) + ndc_y (-V) + W per
    component, rounded as XLA's CPU backend evaluates it."""
    return [torch.addcmul(ndc_x * -U[k], ndc_y, -V[k]) + W[k] for k in range(3)]


def _tile_center_dirs(tx, ty, camera: Camera, config: RenderConfig):
    """Unnormalized central-ray direction of tile (tx, ty) per pair (JAX
    ops/tiles.py:1768-1796): the camera's ray at the tile-centre pixel;
    OpenCV takes the undistorted direction (an ordering key, not a ray);
    a fisheye tile centre outside the image circle gets the zero
    direction."""
    U, V, W = camera.uvw_frame()
    px = (tx.to(torch.float32) + 0.5) * config.tile_w
    py = (ty.to(torch.float32) + 0.5) * config.tile_h
    ndc_x = 2.0 * px / camera.width - 1.0
    ndc_y = 2.0 * py / camera.height - 1.0
    if config.camera_model != CameraModel.FISHEYE:
        return _pinhole_dir(ndc_x, ndc_y, U, V, W)
    rr = torch.sqrt(torch.addcmul(ndc_x * ndc_x, ndc_y, ndc_y))
    f = config.fisheye_focal
    theta = 2.0 * torch.asin(torch.clamp(rr / (2.0 * f), -1.0, 1.0))
    phi = torch.atan2(ndc_y, ndc_x)
    st, ct = torch.sin(theta), torch.cos(theta)
    loc = [st * torch.cos(phi), st * torch.sin(phi), ct]
    live = (rr <= 1.0).to(torch.float32)
    return tuple(dot3(loc, [-U[k], -V[k], W[k]]) * live for k in range(3))


def _bin_pairs_tile_keys(fp: Footprint, camera: Camera, config: RenderConfig, cap: int,
                         geom: tuple) -> PairStream:
    """Pair expansion with per-pair keys along each pair's tile central ray
    (JAX ops/tiles.py:1661-1765, pair_keys "tile" or "tile_peak"): per pair
    ONE gather of its gaussian's context row (the four int32 columns ride
    as float32 bits), then the iso-ellipsoid event t ("tile": entry, or
    exit from inside; a miss keeps the gaussian's own key fp.depth) or the
    peak-response t ("tile_peak") along the tile's central ray, in world
    units; a tile with no ray (the fisheye blank) keeps fp.depth.

    Rounding: the per-pair sums round each float32 operation on its own
    (the tile ray as _pinhole_dir rounds it). XLA's CPU backend
    fuses this per-pair math and contracts some products into FMAs, so a
    small share of the quantized keys differs from the JAX package's, by
    one step under "tile_peak" and by a few where "tile"'s entry takes the
    square root of a cancelling discriminant (tests/test_torch_pair_keys.py
    states the measured shares); tile ids, starts and each tile's set of
    gaussians are exact."""
    means, M9, radius = geom
    tx_n, ty_n = num_tiles(camera, config)
    n_tiles = tx_n * ty_n
    _, depth_bits = _depth_bits(n_tiles)
    x0, y0, sw, count = _tile_rects(fp, camera, config)
    offsets, total, _, gsrc, valid = _owners(count, cap)
    info_i = torch.stack([offsets, x0, y0, torch.clamp(sw, min=1)], dim=1)
    info = torch.cat([info_i.view(torch.float32), means, M9, radius[:, None],
                      fp.depth[:, None]], dim=1)  # (N, 18)
    rows_f = info[torch.clamp(gsrc, min=0).long()]
    rows = rows_f[:, :4].contiguous().view(_I32)
    slot = torch.arange(cap, dtype=_I32, device=count.device)
    r = slot - rows[:, 0]
    # float reciprocal division is exact here (r, sw < 2^24)
    q = torch.floor(r.to(torch.float32) / rows[:, 3].to(torch.float32)).to(_I32)
    tx = rows[:, 1] + (r - q * rows[:, 3])
    ty = rows[:, 2] + q
    tile = ty * tx_n + tx

    dc = _tile_center_dirs(tx, ty, camera, config)
    m = [rows_f[:, 7 + k] for k in range(9)]
    o = [camera.eye[k] - rows_f[:, 4 + k] for k in range(3)]
    sum3 = lambda a, b: a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    og = [sum3(m[3 * i:3 * i + 3], o) for i in range(3)]
    dg = [sum3(m[3 * i:3 * i + 3], dc) for i in range(3)]
    dd = torch.clamp(sum3(dg, dg), min=1e-12)
    od = sum3(og, dg)
    dn = torch.sqrt(sum3(dc, dc))
    gkey = rows_f[:, 17]
    if config.pair_keys == "tile_peak":
        depth_pair = (-od / dd) * dn
    else:  # "tile": the iso-ellipsoid entry (exit from inside) along the tile ray
        rad = rows_f[:, 16]
        disc = od * od - dd * (sum3(og, og) - rad * rad)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_entry = (-od - sq) / dd
        t_exit = (-od + sq) / dd
        t_event = torch.where(t_entry > 0.0, t_entry, t_exit) * dn
        depth_pair = torch.where(disc >= 0.0, t_event, gkey)
    depth_pair = torch.where(dn > 1e-6, depth_pair, gkey)
    key = (tile << depth_bits) | _quantize_depth(depth_pair, depth_bits)
    return _sorted_stream(key, gsrc, valid, n_tiles, depth_bits, total, cap)


def affine_tile_keys(means: torch.Tensor, M9: torch.Tensor, fp: Footprint, camera: Camera,
                     config: RenderConfig, depth_bits: int):
    """Per-gaussian affine model of the per-tile depth key, quantized for
    gather-free binning (pair_keys="affine"; JAX ops/tiles.py:831-962).

    The peak-response t along the ray through pixel p, t*(p) = -<o_g,
    M d(p)> / |M d(p)|^2, is smooth in p, so within one footprint log t*
    is well approximated by its first-order expansion around the
    footprint-centre pixel, in world units t* |d|. Quantized at qbits =
    min(depth_bits, 16) over log t in [log 1e-4, log 1e6]: a_q the value at
    the centre of the footprint's clipped corner tile, b and c the slopes
    per tile step in x and y, clipped to 13 signed bits. Gaussians where
    the model is invalid (t* <= 1e-6, dd <= 1e-12, a non-finite slope), and
    every gaussian of a non-pinhole camera, take the constant fp.depth key
    with zero slopes. Returns (a_q, bc_q) int32 (N,), bc_q = (b + 4096) <<
    13 | (c + 4096)."""
    lmin, lmax = _LOGT_RANGE
    qbits = min(depth_bits, _QBITS)
    scale = ((1 << qbits) - 2) / (lmax - lmin)
    top = float((1 << qbits) - 2)
    l_const = torch.log(torch.clamp(fp.depth, 1e-30, 1e30))
    a_const = torch.clamp((l_const - lmin) * scale, 0.0, top).to(_I32)
    zero_slopes = _SLOPE_OFF << 13 | _SLOPE_OFF
    if config.camera_model != CameraModel.PINHOLE:
        return a_const, torch.full_like(a_const, zero_slopes)

    U, V, W = camera.uvw_frame()
    Wpx, Hpx = camera.width, camera.height
    eye = camera.eye.to(torch.float32)
    px = torch.clamp(fp.px, 0.0, Wpx)
    py = torch.clamp(fp.py, 0.0, Hpx)
    ndc_x = 2.0 * px / Wpx - 1.0
    ndc_y = 2.0 * py / Hpx - 1.0
    m = [M9[:, k] for k in range(9)]
    rel = [eye[k] - means[:, k] for k in range(3)]
    og = [dot3(m[3 * i:3 * i + 3], rel) for i in range(3)]
    mdot = lambda v: [dot3(m[3 * i:3 * i + 3], v) for i in range(3)]
    d = _pinhole_dir(ndc_x, ndc_y, U, V, W)
    dg = mdot(d)
    dd = dot3(dg, dg)
    od = dot3(og, dg)
    dd_s = torch.clamp(dd, min=1e-12)
    t_star = -od / dd_s
    dw_s = torch.clamp(dot3(d, d), min=1e-12)
    t_world = t_star * torch.sqrt(dw_s)

    def dlog_dt(dvec):  # per-pixel slope of log(t* |d|) along the constant dvec
        gv = mdot(dvec)
        od_p = dot3(og, gv)
        dd_p = 2.0 * dot3(dg, gv)
        t_p = -(od_p * dd - od * dd_p) / (dd_s * dd_s)
        return t_p / torch.clamp(t_star, min=1e-12) + dot3(d, dvec) / dw_s

    gpx = dlog_dt([(2.0 / Wpx) * -U[k] for k in range(3)]) * config.tile_w
    gpy = dlog_dt([(2.0 / Hpx) * -V[k] for k in range(3)]) * config.tile_h
    valid = (t_star > 1e-6) & (dd > 1e-12) & torch.isfinite(gpx) & torch.isfinite(gpy)

    l0 = torch.log(torch.clamp(t_world, 1e-30, 1e30))
    x0t, y0t = px / config.tile_w, py / config.tile_h  # footprint centre in tiles
    b = torch.clamp(torch.round(gpx * scale), -_SLOPE_MAX, _SLOPE_MAX)
    c = torch.clamp(torch.round(gpy * scale), -_SLOPE_MAX, _SLOPE_MAX)
    # the value at the centre of the clipped corner tile _tile_rects emits
    tx_n, ty_n = num_tiles(camera, config)
    fx0 = torch.floor(torch.clamp((fp.px - fp.rx) / config.tile_w, -2.0, tx_n + 1.0))
    fy0 = torch.floor(torch.clamp((fp.py - fp.ry) / config.tile_h, -2.0, ty_n + 1.0))
    x0 = torch.clamp(fx0, 0.0, tx_n - 1.0)
    y0 = torch.clamp(fy0, 0.0, ty_n - 1.0)
    a = torch.addcmul(torch.addcmul((l0 - lmin) * scale, b, x0 + 0.5 - x0t), c, y0 + 0.5 - y0t)
    a_q = torch.clamp(torch.round(a), -(1 << 29), 1 << 29).to(_I32)
    bc_q = ((b.to(_I32) + _SLOPE_OFF) << 13) | (c.to(_I32) + _SLOPE_OFF)
    return (torch.where(valid, a_q, a_const),
            torch.where(valid, bc_q, torch.full_like(bc_q, zero_slopes)))


def _bin_pairs_affine(fp: Footprint, camera: Camera, config: RenderConfig, cap: int,
                      akey: tuple, use_kernel: bool = True) -> PairStream:
    """Gather-free pair expansion with per-pair affine depth keys (JAX
    ops/tiles.py:1514-1598): the owners as in _bin_pairs_tile_keys, then
    ONE multi-channel head fill (K2 on CUDA) carries each gaussian's
    offset, packed rect (x0, y0, sw), a_q and bc_q onto the stream, and
    each pair evaluates its tile's key a_q + b dtx + c q, clipped to
    [0, 2^qbits - 2], with two integer multiply-adds. akey = (a_q, bc_q)
    of affine_tile_keys."""
    tx_n, ty_n = num_tiles(camera, config)
    n_tiles = tx_n * ty_n
    _, depth_bits = _depth_bits(n_tiles)
    a_q, bc_q = akey
    x0, y0, sw, count = _tile_rects(fp, camera, config)
    offsets, total, first, gsrc, valid = _owners(count, cap)
    by = max(1, (ty_n - 1).bit_length())
    bsw = max(1, tx_n.bit_length())
    if max(1, (tx_n - 1).bit_length()) + by + bsw > 31:
        raise ValueError(f"tile grid too large to pack: {tx_n}x{ty_n}")
    packedv = (x0 << (by + bsw)) | (y0 << bsw) | torch.clamp(sw, min=1)
    off_p, packed, a_p, bc_p = multi_head_fill(first, [offsets, packedv, a_q, bc_q], cap,
                                               use_kernel=use_kernel)
    sw_p = packed & ((1 << bsw) - 1)
    y0_p = _srl(packed, bsw) & ((1 << by) - 1)
    x0_p = _srl(packed, by + bsw)
    b_p = _srl(bc_p, 13) - _SLOPE_OFF
    c_p = (bc_p & 8191) - _SLOPE_OFF
    r = torch.arange(cap, dtype=_I32, device=count.device) - off_p
    q = torch.floor(r.to(torch.float32) / sw_p.to(torch.float32)).to(_I32)
    dtx = r - q * sw_p
    tile = (y0_p + q) * tx_n + x0_p + dtx
    qbits = min(depth_bits, _QBITS)
    dq = torch.clamp(a_p + b_p * dtx + c_p * q, 0, (1 << qbits) - 2)
    key = (tile << depth_bits) | (dq << (depth_bits - qbits))
    return _sorted_stream(key, gsrc, valid, n_tiles, depth_bits, total, cap)


def bin_pairs(fp: Footprint, camera: Camera, config: RenderConfig,
              pair_capacity: int, use_kernel: bool = True, tile_rows=None,
              geom: tuple | None = None) -> PairStream:
    """Expand footprints into the depth-sorted per-tile pair stream.

    use_kernel=False runs the plain torch scan on any device; otherwise the
    scan picks its CUDA kernel for CUDA tensors. tile_rows=(row_lo,
    n_rows) bins only that band of tile rows (its tiles row-major, y
    band-local): each tile's pairs are the full stream's, in the same
    order. geom = (means (N, 3), M9 (N, 9) rows of S^-1 R^T, radius (N,)).

    The branches are JAX's (ops/tiles.py:1622-1660). With geom and
    config.pair_keys "tile" or "tile_peak" (_bin_pairs_tile_keys) or
    "affine" (affine_tile_keys, _bin_pairs_affine) each pair sorts by its
    own tile's key and the culls are ignored; a pair key with geom and
    tile_rows raises ValueError. Otherwise (pair_keys "gaussian", or no
    geom whatever pair_keys says) the depth-presorted expansion runs, where
    a pinhole frame with geom takes conic_cull and row_span (both need the
    conics) and fisheye_cull takes the footprint's sector wherever it has
    one, with or without geom.
    """
    pair_key = geom is not None and config.pair_keys != "gaussian"
    if pair_key and tile_rows is not None:
        raise ValueError("per-shard binning supports the default pair_keys only")
    if pair_key and config.pair_keys == "affine":
        _, depth_bits = _depth_bits(math.prod(num_tiles(camera, config)))
        akey = affine_tile_keys(geom[0], geom[1], fp, camera, config, depth_bits)
        return _bin_pairs_affine(fp, camera, config, pair_capacity, akey, use_kernel)
    if pair_key and config.pair_keys in ("tile", "tile_peak"):
        return _bin_pairs_tile_keys(fp, camera, config, pair_capacity, geom)
    conics = spans = None
    if geom is not None and config.camera_model == CameraModel.PINHOLE \
            and (config.conic_cull or config.row_span):
        conics = projection_conics(geom, camera)
        if config.row_span:
            x0, y0, sw, count = _tile_rects(fp, camera, config, tile_rows)
            sw1 = torch.clamp(sw, min=1)
            sh = torch.floor(count.to(torch.float32) / sw1.to(torch.float32)).to(_I32)
            spans = _edge_row_spans(conics, x0, y0, sw1, sh, camera, config,
                                    row_lo=0 if tile_rows is None else tile_rows[0])
            if not config.conic_cull:
                conics = None
    sector = fp.sector if config.fisheye_cull and fp.sector is not None else None
    return _bin_pairs_presorted(fp, camera, config, pair_capacity, use_kernel=use_kernel,
                                tile_rows=tile_rows, conics=conics, spans=spans, sector=sector)


def bin_tiles(fp: Footprint, camera: Camera, config: RenderConfig, pair_capacity: int,
              use_kernel: bool = True, geom: tuple | None = None) -> TileBinning:
    """Fixed-capacity per-tile candidate lists (T, config.max_per_tile) of
    the pair stream (bin_pairs, whose scan is kernel K2 on CUDA tensors):
    tile t lists its first max_per_tile pairs front to back, -1 after them,
    as depth ranks (order) or, under a per-pair key, gaussian ids (order
    None). n_dropped adds each tile's overflow to the stream's capacity
    drops."""
    stream = bin_pairs(fp, camera, config, pair_capacity, use_kernel=use_kernel, geom=geom)
    tx_n, ty_n = num_tiles(camera, config)
    m_cap = config.max_per_tile
    counts = stream.starts[1:] - stream.starts[:-1]
    clipped = torch.clamp(counts, max=m_cap)
    slots = torch.arange(m_cap, dtype=_I32, device=counts.device)
    pos = torch.clamp(stream.starts[: tx_n * ty_n, None] + slots[None, :], 0, pair_capacity - 1)
    cand = torch.where(slots[None, :] < clipped[:, None], stream.gid[pos.long()],
                       torch.full_like(pos, -1))
    return TileBinning(cand=cand, counts=clipped, n_pairs=stream.n_pairs,
                       n_dropped=stream.n_dropped + torch.sum(counts - clipped),
                       order=stream.order)
