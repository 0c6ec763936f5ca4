"""Morton-block acceleration structure for secondary rays (counterpart of
gaussian_ray_tracing_tpu/ops/blocks.py).

Bounced rays have arbitrary origins and directions, so they cannot use the
screen-space pair stream. Instead, once per frame:

  1. points (gaussian means, or triangle centroids in ops/tri.py) are
     sorted along a 30-bit Morton curve, with a STABLE sort (jnp.argsort
     is stable, so equal codes keep index order on both sides);
  2. consecutive runs of `block_size` sorted items form blocks with
     bounding spheres;
  3. per bounce, each tile's live rays are bounded by an origin sphere and
     a direction cone, blocks are culled against it, and the survivors are
     listed near to far per tile (stable again), at most `max_per_tile`
     per tile: a block stream the march (K1 block mode) and the
     closest-hit kernel (K4) consume.

All (T, B)- and (T, R)-sized math is per component, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_I32 = torch.int32


class BlockIndex(NamedTuple):
    perm: torch.Tensor  # (N,) morton order of the original items
    centers: torch.Tensor  # (B, 3) block bounding-sphere centres
    radii: torch.Tensor  # (B,) block bounding-sphere radii
    block_size: int


def morton_codes(points: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """30-bit int32 Morton codes of points quantized inside their AABB."""
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    q = (points - lo) / torch.clamp(hi - lo, min=1e-12)
    cells = torch.clamp((q * (1 << bits)).to(_I32), 0, (1 << bits) - 1)

    def spread(v):  # x_9 .. x_0 -> x_9 0 0 x_8 0 0 ...
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return spread(cells[:, 0]) | (spread(cells[:, 1]) << 1) | (spread(cells[:, 2]) << 2)


def morton_order(points: torch.Tensor) -> torch.Tensor:
    """Stable argsort of the Morton codes."""
    return torch.argsort(morton_codes(points), stable=True)


def _pad_rows(x: torch.Tensor, block_size: int, fill: torch.Tensor) -> torch.Tensor:
    pad = (-x.shape[0]) % block_size
    if not pad:
        return x
    return torch.cat([x, fill.expand((pad,) + tuple(x.shape[1:]))], 0)


def build_block_index(means: torch.Tensor, bound_radius: torch.Tensor,
                      block_size: int = 256) -> BlockIndex:
    """Morton-sort points and bound each `block_size` run by a sphere that
    also holds each item's own bound_radius (the tail block repeats the last
    point with radius 0)."""
    perm = morton_order(means)
    means_s = _pad_rows(means[perm], block_size, means[perm][-1:])
    rad_s = _pad_rows(bound_radius[perm], block_size, bound_radius.new_zeros(1))
    nb = means_s.shape[0] // block_size
    mb = means_s.reshape(nb, block_size, 3)
    centers = 0.5 * (mb.amin(dim=1) + mb.amax(dim=1))
    radii = (torch.linalg.norm(mb - centers[:, None, :], dim=-1)
             + rad_s.reshape(nb, block_size)).amax(dim=1)
    return BlockIndex(perm=perm, centers=centers, radii=radii, block_size=block_size)


class RayBundles(NamedTuple):
    o_c: torch.Tensor  # (T, 3) origin-sphere centres
    o_r: torch.Tensor  # (T,) origin-sphere radii
    axis: torch.Tensor  # (T, 3) unit cone axis
    cos_half: torch.Tensor  # (T,) cosine of the cone half angle
    any_live: torch.Tensor  # (T,) bool


def bundle_rays(origins_t: torch.Tensor, dirs_t: torch.Tensor) -> RayBundles:
    """Bound each tile's live rays (|d| > 0.1) by origin sphere + dir cone."""
    ox, oy, oz = origins_t.unbind(-1)
    dx, dy, dz = dirs_t.unbind(-1)
    live = dx * dx + dy * dy + dz * dz > 0.01  # (T, R)
    nlive = torch.clamp(live.sum(dim=-1), min=1).to(origins_t.dtype)
    lw = live.to(origins_t.dtype)
    ocx = (ox * lw).sum(dim=1) / nlive
    ocy = (oy * lw).sum(dim=1) / nlive
    ocz = (oz * lw).sum(dim=1) / nlive
    r2 = (ox - ocx[:, None]) ** 2 + (oy - ocy[:, None]) ** 2 + (oz - ocz[:, None]) ** 2
    o_r = torch.sqrt(torch.where(live, r2, 0.0).amax(dim=-1))
    dsx, dsy, dsz = (dx * lw).sum(dim=1), (dy * lw).sum(dim=1), (dz * lw).sum(dim=1)
    dn = torch.clamp(torch.sqrt(dsx * dsx + dsy * dsy + dsz * dsz), min=1e-9)
    ax, ay, az = dsx / dn, dsy / dn, dsz / dn
    cosd = dx * ax[:, None] + dy * ay[:, None] + dz * az[:, None]
    cos_half = torch.where(live, cosd, 1.0).amin(dim=-1)
    return RayBundles(o_c=torch.stack([ocx, ocy, ocz], -1), o_r=o_r,
                      axis=torch.stack([ax, ay, az], -1),
                      cos_half=torch.clamp(cos_half, -1.0, 1.0), any_live=live.any(dim=-1))


def _center_offsets(index: BlockIndex, bundles: RayBundles):
    return [index.centers[None, :, k] - bundles.o_c[:, None, k] for k in range(3)]


def cull_blocks(index: BlockIndex, bundles: RayBundles, t_max) -> torch.Tensor:
    """(T, B) bool: the block's sphere may meet the bundle's cone.

    Conservative cone-vs-sphere with the origin sphere folded into the
    block radius: visible iff inside, or the angle from the axis to the
    centre is within half angle + asin(r / dist), the block is not wholly
    behind the bundle, and it starts within t_max (a scalar or a per-tile
    (T,) cap)."""
    vx, vy, vz = _center_offsets(index, bundles)
    dist = torch.sqrt(vx * vx + vy * vy + vz * vz)
    rr = index.radii[None, :] + bundles.o_r[:, None]
    inside = dist <= rr
    ax = bundles.axis
    along = vx * ax[:, None, 0] + vy * ax[:, None, 1] + vz * ax[:, None, 2]
    safe = torch.clamp(dist, min=1e-9)
    ang_to = torch.arccos(torch.clamp(along / safe, -1.0, 1.0))
    half = torch.arccos(bundles.cos_half)[:, None]
    delta = torch.arcsin(torch.clamp(rr / safe, 0.0, 1.0))
    in_cone = ang_to <= half + delta
    forward = along + rr > 0.0
    t_cap = torch.as_tensor(t_max, dtype=dist.dtype, device=dist.device)
    if t_cap.dim() == 1:
        t_cap = t_cap[:, None]
    near = dist - rr <= t_cap
    return (inside | (in_cone & forward & near)) & bundles.any_live[:, None]


class BlockStream(NamedTuple):
    blk: torch.Tensor  # (cap_b,) int32 block id of each chunk slot
    starts: torch.Tensor  # (T+1,) int32 per-tile starts, in item slots
    n_slots: torch.Tensor  # () int32 slots needed (before the capacity clip)
    n_dropped: torch.Tensor  # () int32 slots lost to the budget and capacity


def block_stream(visible: torch.Tensor, index: BlockIndex, bundles: RayBundles,
                 capacity: int, max_per_tile: int | None = None) -> BlockStream:
    """List each tile's visible blocks near to far (by centre distance,
    stable), at most max_per_tile of them: the farthest are dropped first.
    Tile t's slots are [starts[t], starts[t+1]) in items; slot group g
    (of block_size items) reads block blk[g]."""
    T, B = visible.shape
    bs = index.block_size
    cap_b = capacity // bs
    vx, vy, vz = _center_offsets(index, bundles)
    dist = torch.sqrt(vx ** 2 + vy ** 2 + vz ** 2)
    keys = torch.where(visible, dist, float("inf"))
    order = torch.argsort(keys, dim=-1, stable=True).to(_I32)  # near to far
    counts = visible.sum(dim=-1).to(_I32)
    n_clipped = counts.new_zeros(())
    if max_per_tile is not None and max_per_tile < B:
        clipped = torch.clamp(counts, max=max_per_tile)
        n_clipped = (counts - clipped).sum().to(_I32)
        counts = clipped
    starts_b = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0).to(_I32)])
    total = starts_b[-1]
    # owner tile of each block slot: the last tile whose start is <= slot
    slot = torch.arange(cap_b, dtype=_I32, device=visible.device)
    owner = torch.searchsorted(starts_b[:-1], slot, right=True).to(_I32) - 1
    valid = slot < torch.clamp(total, max=cap_b)
    owner = torch.clamp(owner, min=0)
    rank = torch.clamp(slot - starts_b[owner.long()], 0, B - 1)
    blk = order.reshape(-1)[owner.long() * B + rank.long()]
    blk = torch.where(valid, blk, 0).to(_I32)
    n_dropped = (torch.clamp(total - cap_b, min=0) + n_clipped) * bs
    return BlockStream(blk=blk, starts=starts_b * bs, n_slots=total * bs,
                       n_dropped=n_dropped.to(_I32))
