"""Tile binning for pinhole frames (the default-path parts of
gaussian_ray_tracing_tpu/ops/tiles.py).

Every gaussian's exact projected-conic footprint is expanded into (tile,
gaussian) pairs over its clipped tile rect; the gaussians are argsorted by
depth key first, so pairs are emitted in global front-to-back order and a
tile-only sort leaves each tile owning a contiguous depth-ordered segment
of the stream. Per-pair context (owner rank, in-rect offset, rect origin)
arrives through O(N) delta scatters plus one fused multi-channel O(P)
prefix sum (ops/scan.multi_head_fill, kernel K2 on the GPU). Sorts,
scatters, searchsorted and gathers stay torch ops, as the JAX package left
them to XLA. Integer results are bit-identical to the JAX package given the
same footprints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera
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
    back. gid holds depth RANKS: index per-gaussian tables as table[order].
    """

    gid: torch.Tensor  # (P,) int32 ranks, -1 in empty slots
    key: torch.Tensor  # (P,) int32 sorted tile ids
    starts: torch.Tensor  # (n_tiles+1,) int32 segment starts
    n_pairs: torch.Tensor  # () int32 pairs emitted (pre-clip)
    n_dropped: torch.Tensor  # () int32 pairs lost to capacity overflow
    order: torch.Tensor | None = None  # (N,) depth permutation


class Footprint(NamedTuple):
    px: torch.Tensor  # (N,) pixel-space centre x
    py: torch.Tensor  # (N,) pixel-space centre y
    rx: torch.Tensor  # (N,) conservative pixel half-extent x
    ry: torch.Tensor  # (N,) conservative pixel half-extent y
    depth: torch.Tensor  # (N,) front-to-back sort key
    visible: torch.Tensor  # (N,) bool


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


def project_footprints(means, bound_radius, camera: Camera, config: RenderConfig,
                       extents: tuple) -> Footprint:
    """Conservative pinhole footprints: the extent/z_near rect of the
    camera-axis half-extents `extents` (camera_axis_extents)."""
    if config.camera_model != CameraModel.PINHOLE or config.distortion:
        raise NotImplementedError(
            f"camera model {config.camera_model.value} is not ported yet"
        )
    U, V, W = camera.uvw_frame()
    ulen, vlen, wlen = _len(U), _len(V), _len(W)
    rel = means - camera.eye
    a = _dot3(rel, -(U / ulen))
    b = _dot3(rel, -(V / vlen))
    c = _dot3(rel, W / wlen)
    Wpx, Hpx = camera.width, camera.height
    z = torch.clamp(c, min=_EPS)
    px = (a / z * (wlen / ulen) + 1.0) * 0.5 * Wpx
    py = (b / z * (wlen / vlen) + 1.0) * 0.5 * Hpx
    ru, rv, rw = extents
    z_near = torch.clamp(c - rw, min=_EPS)
    rx = ru / z_near * (wlen / ulen) * 0.5 * Wpx
    ry = rv / z_near * (wlen / vlen) * 0.5 * Hpx
    return Footprint(
        px=px, py=py, rx=rx * _MARGIN + 1.0, ry=ry * _MARGIN + 1.0, depth=c,
        visible=((c + rw) > _EPS) & (bound_radius > 0.0),
    )


def project_footprints_conic(means, scales, quats, radius, bound_radius,
                             camera: Camera, config: RenderConfig) -> Footprint:
    """Exact pinhole footprints: the tight bounding box of each iso
    ellipsoid's projected conic, falling back to the conservative rect
    where the ellipsoid is not strictly in front of the eye plane.

    The supporting planes n(k) = cc*u' - k*w_hat of {ndc_x >= k} touch the
    ellipsoid where n.(mu - eye) = -radius |S R^T n|, which squares to
    a k^2 - 2 b k + c = 0 with B = (mu-eye).w_hat, X = (mu-eye).n0,
    P = S R^T n0, Q = S R^T w_hat and
      a = B^2 - r^2 |Q|^2,  b = X B - r^2 P.Q,  c = X^2 - r^2 |P|^2;
    the discriminant is taken in the cancellation-free product form
    r^2 (|B P - X Q|^2 - r^2 |P x Q|^2). Lossless: rays outside the conic
    never clear alpha_min in the march.
    """
    extents = camera_axis_extents(scales, quats, radius, camera)
    fp = project_footprints(means, bound_radius, camera, config, extents)
    if not config.exact_bbox:
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
    return Footprint(
        px=torch.where(exact, (kcu + 1.0) * 0.5 * Wpx, fp.px),
        py=torch.where(exact, (kcv + 1.0) * 0.5 * Hpx, fp.py),
        rx=torch.where(exact, khu * 0.5 * Wpx + 1.0, fp.rx),
        ry=torch.where(exact, khv * 0.5 * Hpx + 1.0, fp.ry),
        depth=fp.depth,
        visible=fp.visible,
    )


def _tile_rects(fp: Footprint, camera: Camera, config: RenderConfig):
    """Clipped tile-rect origin (x0, y0), width sw and pair count per
    gaussian."""
    tw, th = config.tile_w, config.tile_h
    tx_n, ty_n = num_tiles(camera, config)

    # float-clip before the int cast: projected centres of near/behind-
    # camera gaussians can be astronomically large
    def tile_of(v, size, n_t):
        return torch.floor(torch.clamp(v / size, -2.0, n_t + 1.0)).to(_I32)

    fx0 = tile_of(fp.px - fp.rx, tw, tx_n)
    fx1 = tile_of(fp.px + fp.rx, tw, tx_n)
    fy0 = tile_of(fp.py - fp.ry, th, ty_n)
    fy1 = tile_of(fp.py + fp.ry, th, ty_n)
    on = (fx1 >= 0) & (fy1 >= 0) & (fx0 < tx_n) & (fy0 < ty_n) & fp.visible
    x0 = torch.clamp(fx0, 0, tx_n - 1)
    x1 = torch.clamp(fx1, 0, tx_n - 1)
    y0 = torch.clamp(fy0, 0, ty_n - 1)
    y1 = torch.clamp(fy1, 0, ty_n - 1)
    sw = x1 - x0 + 1
    count = torch.where(on, sw * (y1 - y0 + 1), torch.zeros_like(sw))
    return x0, y0, sw, count


def count_pairs(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Exact (tile, gaussian) pair count of a frame, from O(N) footprint
    math only (no expansion), for sizing the pair capacity up front."""
    radius = adaptive_radius(scene.opacities, config.alpha_min)
    bound_radius = radius * torch.amax(scene.scales, dim=-1)
    fp = project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                  bound_radius, camera, config)
    return torch.sum(_tile_rects(fp, camera, config)[3], dtype=torch.int64)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0).to(_I32)  # cumsum promotes to int64


def _bin_pairs_presorted(fp: Footprint, camera: Camera, config: RenderConfig,
                         cap: int, use_kernel: bool = True) -> PairStream:
    """Gather-free pair expansion over depth-sorted gaussians
    (gaussian_ray_tracing_tpu/ops/tiles.py _bin_pairs_presorted, default
    branch: no conic cull, row spans or fisheye sectors)."""
    tx_n, ty_n = num_tiles(camera, config)
    n_tiles = tx_n * ty_n
    n = fp.px.shape[0]
    dev = fp.px.device

    x0, y0, sw, count = _tile_rects(fp, camera, config)
    bx = max(1, (tx_n - 1).bit_length())
    by = max(1, (ty_n - 1).bit_length())
    bsw = max(1, tx_n.bit_length())  # sw can equal tx_n
    if bx + by + bsw > 31:
        raise ValueError(f"tile grid too large to pack: {tx_n}x{ty_n}")

    # depth pre-sort (N): float bits of a positive key sort like the key
    d = torch.clamp(fp.depth, 1e-30, 1e30)
    order = torch.sort(d.view(_I32), stable=True).indices
    x0, y0, count = x0[order], y0[order], count[order]
    sw = torch.clamp(sw[order], min=1)

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
    filled = multi_head_fill(first, fill_vals, cap, use_kernel=use_kernel)
    slot = torch.arange(cap, dtype=_I32, device=dev)
    if pack_off:
        ch0, packed = filled
        rank_f = _srl(ch0, b_off)
        r = (slot - (ch0 & off_mask)) & off_mask
    else:
        rank_f, off_pair, packed = filled
        r = slot - off_pair
    gsrc = rank_f - 1
    valid = (slot < torch.clamp(total, max=cap)) & (gsrc >= 0)

    sw_p = packed & ((1 << bsw) - 1)
    y0_p = _srl(packed, bsw) & ((1 << by) - 1)
    x0_p = _srl(packed, by + bsw)
    # float reciprocal division is exact here (r, sw < 2^24)
    q = torch.floor(r.to(torch.float32) / sw_p.to(torch.float32)).to(_I32)
    tile = (y0_p + q) * tx_n + x0_p + (r - q * sw_p)

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


def bin_pairs(fp: Footprint, camera: Camera, config: RenderConfig,
              pair_capacity: int, use_kernel: bool = True) -> PairStream:
    """Expand footprints into the depth-sorted per-tile pair stream (the
    default pair_keys="gaussian" path without culls or row spans).

    use_kernel=False runs the plain torch scan on any device; otherwise the
    scan picks its CUDA kernel for CUDA tensors.
    """
    if config.pair_keys != "gaussian" or config.conic_cull or config.row_span \
            or config.fisheye_cull:
        raise NotImplementedError(
            "only the default binning (pair_keys='gaussian', no conic_cull, "
            "row_span or fisheye_cull) is ported"
        )
    return _bin_pairs_presorted(fp, camera, config, pair_capacity,
                                use_kernel=use_kernel)
