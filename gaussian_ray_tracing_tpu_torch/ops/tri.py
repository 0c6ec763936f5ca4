"""Per-tile closest hit over culled triangle blocks -- kernel K4.

Counterpart of gaussian_ray_tracing_tpu/ops/pallas_tri.py (`_tri_kernel`,
wrapper `pallas_closest_hit`). Faces are sorted along a Morton curve by
centroid (stable) and stored one row per face, [v0 xyz, e1 xyz, e2 xyz]
with e1 = v1 - v0 and e2 = v2 - v0, padded with zero (degenerate, never
hit) faces to whole blocks of 256. Consecutive 256-face blocks carry
bounding spheres (`face_block_index`), each tile's ray bundle cone-culls
them (ops/blocks.py), and the kernel intersects the tile's rays with the
listed blocks only: double-sided Moller-Trumbore, determinant guard 1e-12,
barycentric tolerance 1e-6, t in (t_min, t_max).

Ties follow the TPU kernel's visit order exactly. It held a block as 32
rows of 8 face slots (face id = block * 256 + row * 8 + slot), took for
each slot s = 0..7 the minimum t over the 32 rows (ties to the lower row)
and replaced its running best only on a strictly smaller t. So an equal t
goes to the block listed first, then to the lower slot, then to the lower
row. Both versions here walk the faces in that order. The 8-faces-per-row
packing itself is TPU layout and is not kept.

Pretests. Given the bounds of each block and of each of its 32 rows of 8
faces, a bounding sphere and a normal cone (`face_bounds`), the kernel
skips, per ray, every listed block and every row of a block that
`block_may_hit` and `row_may_hit` prove the ray's segment (t_min,
min(t_max, best_t)) cannot hit, and every face that `face_may_hit` proves
missed; they are the kernel's rules operation for operation (their proof is in
csrc/tri.cu). The result never depends on the bounds: the plain version
takes and ignores them. The kernel counts per tile what it ran (`stats`);
`pretest_stats` computes the same counts from these rules. A tile of more
than 1024 rays (any multiple of 128) runs as `tile_splits(R)`
blocks over slices of `split_width(R)` rays, each walking the tile's
block list and skipping what no ray of its slice needs (no pretest spans
the tile); its counts are the sums of its slices'.

`closest_hit_blocks` is the wrapper: CUDA tensors launch csrc/tri.cu, CPU
tensors run `closest_hit_blocks_plain`, anything else raises.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.config import tile_rays_supported
from gaussian_ray_tracing_tpu_torch.ops.blocks import BlockIndex, _pad_rows, morton_order
from gaussian_ray_tracing_tpu_torch.ops.intersect import moller_trumbore

FACES_PER_BLOCK = 256
SLOTS, ROWS = 8, 32  # the TPU kernel's visit order: slot outer, row inner
FACE_ROW = 9  # v0 xyz, e1 xyz, e2 xyz
_MISS = 3.0e38
_F32 = torch.float32
_PLAIN_BATCH = 1 << 24  # (tile, face, ray) elements per plain batch
# sphere pretest margins (csrc/tri.cu kGrow, kSlack): the sphere's radius
# times BLOCK_GROW, plus BLOCK_SLACK of |c - o| + radius
BLOCK_GROW, BLOCK_SLACK = 1.0001, 4e-3
# the normal cones keep a group for a ray that meets one of its faces at
# less than about GRAZE_ANGLE radians to its plane (csrc/tri.cu kAngle)
GRAZE_ANGLE = 1e-3
# a face with |e1| |e2| <= 1e-12 / (1.00001 MAX_DIR) never passes the
# determinant guard of a ray with |d| <= MAX_DIR, and the cones leave it
# out; a longer ray grazes every group (csrc/tri.cu kMaxDir)
MAX_DIR = 1e4
WARP = 32
STATS = ("staged_blocks", "needed_pairs", "warp_blocks", "warp_rows", "divided_pairs")


def tile_splits(rays: int) -> int:
    """Blocks the kernel splits a tile of `rays` rays into (csrc/tri.cu)."""
    return -(-rays // 1024)


def split_width(rays: int) -> int:
    """Rays of each block of a split tile: a multiple of 32 (whole warps);
    the last block's lanes past the tile are idle."""
    s = tile_splits(rays)
    return -(-rays // (32 * s)) * 32


def pack_triangles(v0, v1, v2):
    """Morton-order faces by centroid (stable) -> (face_rows (F_pad, 9),
    perm), perm mapping packed face id -> original face index."""
    perm = morton_order((v0 + v1 + v2) / 3.0)
    v0, v1, v2 = v0[perm], v1[perm], v2[perm]
    rows = torch.cat([v0, v1 - v0, v2 - v0], dim=1)
    return _pad_rows(rows, FACES_PER_BLOCK, rows.new_zeros((1, FACE_ROW))), perm


def face_block_index(v0, v1, v2, perm) -> BlockIndex:
    """Bounding spheres of consecutive 256-face (Morton-ordered) blocks; the
    tail block repeats the last face."""
    v0, v1, v2 = (_pad_rows(v[perm], FACES_PER_BLOCK, v[perm][-1:]) for v in (v0, v1, v2))
    nb = v0.shape[0] // FACES_PER_BLOCK
    pts = torch.stack([v0, v1, v2], 1).reshape(nb, FACES_PER_BLOCK * 3, 3)
    centers = 0.5 * (pts.amin(dim=1) + pts.amax(dim=1))
    radii = torch.linalg.norm(pts - centers[:, None, :], dim=-1).amax(dim=1)
    return BlockIndex(perm=perm, centers=centers, radii=radii, block_size=FACES_PER_BLOCK)


def _sphere(pts, live):
    """Centre and radius (float32) of the points (..., N, 3) with `live`
    (..., N): the box's middle and the largest distance to it (radius 0 at
    the origin where none is live)."""
    big = torch.tensor(float("inf"), dtype=pts.dtype, device=pts.device)
    lo = torch.where(live[..., None], pts, big).amin(dim=-2)
    hi = torch.where(live[..., None], pts, -big).amax(dim=-2)
    c = torch.where(live.any(-1)[..., None], 0.5 * (lo + hi), 0.0)
    r = torch.where(live, torch.linalg.norm(pts - c[..., None, :], dim=-1), 0.0).amax(dim=-1)
    return torch.cat([c, r[..., None]], -1)


def _cone(e1, e2, live):
    """Normal cone [unit axis a, g] (float32) of the faces (..., N) with
    edges e1, e2 (..., N, 3) and `live` (e1 and e2 nonzero): for each
    such face f that a ray with |d| <= MAX_DIR may have accepted, g >=
    |n_f -+ a| + GRAZE_ANGLE |e1| |e2| / |e1 x e2| (+inf for a face with
    parallel edges), raised by 1e-5 for rounding; g = -1 where there is no
    such face (csrc/tri.cu, grazes)."""
    e1, e2 = e1.double(), e2.double()
    n = torch.linalg.cross(e1, e2)
    nn = torch.linalg.norm(n, dim=-1)
    l12 = torch.linalg.norm(e1, dim=-1) * torch.linalg.norm(e2, dim=-1)
    live = live & (l12 * (1.00001 * MAX_DIR) > 1e-12)
    sine = nn / l12.clamp_min(1e-300)
    unit = live & (nn > 0)
    nh = torch.where(unit[..., None], n / nn.clamp_min(1e-300)[..., None], 0.0)
    ref = torch.gather(nh, -2, unit.double().argmax(-1)[..., None, None].expand(
        *nh.shape[:-2], 1, 3))  # the first such face's normal
    nh = torch.where((nh * ref).sum(-1, keepdim=True) < 0, -nh, nh)  # the sign nearer ref
    a = nh.sum(-2)
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True).clamp_min(1e-300)
    g_f = torch.where(unit, torch.linalg.norm(nh - a[..., None, :], dim=-1)
                      + GRAZE_ANGLE / sine.clamp_min(1e-300), float("inf"))
    g = torch.where(live, g_f, float("-inf")).amax(-1)
    g = torch.where(live.any(-1), g * (1 + 1e-5) + 1e-5, -1.0)
    return torch.cat([a, g[..., None]], -1).to(_F32)


def face_bounds(centers, radii, face_rows) -> torch.Tensor:
    """(B, 33, 2, 4) float32 by block id: the pretests' bounds of each face
    block (index 0: face_block_index's sphere, centers and radii) and of
    its 32 rows of 8 faces (index 1 + r: row r holds faces 8 r .. 8 r + 7),
    each a bounding sphere [centre xyz, radius] (a row's holds the
    vertices v0, v0 + e1 and v0 + e2 of its nonzero faces) and a normal
    cone [unit axis xyz, g] (`_cone`, over the faces with e1 and e2 both
    nonzero, the only ones Moller-Trumbore may accept): the kernel's
    `bounds` argument."""
    f = face_rows.reshape(-1, ROWS, SLOTS, FACE_ROW)
    v0, e1, e2 = f[..., 0:3], f[..., 3:6], f[..., 6:9]
    live = (e1 != 0).any(-1) & (e2 != 0).any(-1)  # (B, 32, 8)
    nonzero = (f != 0).any(-1)
    pts = torch.stack([v0, v0 + e1, v0 + e2], -2).reshape(*f.shape[:2], SLOTS * 3, 3)
    rows = torch.stack([_sphere(pts, nonzero.repeat_interleave(3, -1)),
                        _cone(e1, e2, live)], -2)  # (B, 32, 2, 4)
    B = f.shape[0]
    block = torch.stack([torch.cat([centers, radii[:, None]], 1).to(_F32),
                         _cone(e1.reshape(B, -1, 3), e2.reshape(B, -1, 3), live.reshape(B, -1))],
                        1)[:, None]
    return torch.cat([block, rows], 1).contiguous()


def slack_bound(sphere, o) -> torch.Tensor:
    """|c - o| + radius of a block's sphere (..., 4) for origins o (..., 3):
    the bound on |o - v0| that the block's and its rows' tests use."""
    xx, xy, xz = (sphere[..., k] - o[..., k] for k in range(3))
    return torch.sqrt(xx * xx + xy * xy + xz * xz) + sphere[..., 3]


def ball_may_hit(spheres, x_bound, o, d, t_lo, t_hi) -> torch.Tensor:
    """The kernel's sphere test (csrc/tri.cu ball_may_hit), operation for
    operation in float32, broadcast over leading dimensions: spheres (..., 4)
    that hold the faces tested, x_bound (...) >= |o - v0| of each (the
    block's slack_bound), ray origins o and directions d (..., 3), the
    segment (t_lo, t_hi) (scalars or (...)). False proves that
    Moller-Trumbore accepts none of those faces at a t in (t_lo, t_hi),
    for a ray that grazes none of them (`grazes`)."""
    f = lambda x: torch.as_tensor(x, dtype=_F32, device=spheres.device)
    dx, dy, dz = d.unbind(-1)
    dl2 = dx * dx + dy * dy + dz * dz
    dlen = torch.sqrt(dl2)
    xx, xy, xz = (spheres[..., k] - o[..., k] for k in range(3))
    rr = spheres[..., 3] * f(BLOCK_GROW) + f(BLOCK_SLACK) * x_bound
    cx, cy, cz = xy * dz - xz * dy, xz * dx - xx * dz, xx * dy - xy * dx
    miss = cx * cx + cy * cy + cz * cz > rr * rr * dl2
    proj = xx * dx + xy * dy + xz * dz
    before = proj + rr * dlen <= f(t_lo) * dl2
    beyond = proj - rr * dlen >= f(t_hi) * dl2
    return ~(miss | before | beyond)


def grazes(cones, d) -> torch.Tensor:
    """The kernel's cone test (csrc/tri.cu grazes): may the rays d (..., 3)
    meet a face of the groups with normal cones (..., 4) at less than the
    cone's angle (|d.a| < g |d|, or NaN; every group for |d| > MAX_DIR)?"""
    dx, dy, dz = d.unbind(-1)
    dlen = torch.sqrt(dx * dx + dy * dy + dz * dz)
    glen = torch.where(dlen <= MAX_DIR, dlen, float("inf"))
    return ~((dx * cones[..., 0] + dy * cones[..., 1] + dz * cones[..., 2]).abs()
             >= cones[..., 3] * glen)


def row_may_hit(rows, block_ball, x_bound, o, d, t_lo, t_hi) -> torch.Tensor:
    """The kernel's row pretest (csrc/tri.cu row_may_hit): rows (..., 2, 4)
    [sphere, cone] (`face_bounds`), block_ball (...) the block's
    ball_may_hit, otherwise ball_may_hit's arguments. False proves that
    Moller-Trumbore accepts none of the row's faces at a t in (t_lo,
    t_hi)."""
    return (block_ball & ball_may_hit(rows[..., 0, :], x_bound, o, d, t_lo, t_hi)) | grazes(
        rows[..., 1, :], d)


def block_may_hit(bounds, o, d, t_lo, t_hi) -> torch.Tensor:
    """The kernel's block pretest (csrc/tri.cu block_may_hit): a block's
    bounds (..., 33, 2, 4) (`face_bounds`), rays o, d (..., 3), the segment
    (t_lo, t_hi). False proves that Moller-Trumbore accepts none of the
    block's faces at a t in (t_lo, t_hi)."""
    sphere = bounds[..., 0, 0, :]
    ball = ball_may_hit(sphere, slack_bound(sphere, o), o, d, t_lo, t_hi)
    return ball | (grazes(bounds[..., 0, 1, :], d)
                   & grazes(bounds[..., 1:, 1, :], d[..., None, :]).any(-1))


def row_mask(bounds, o, d, t_lo, t_hi) -> torch.Tensor:
    """(..., 32) the rows of a block (bounds (..., 33, 2, 4)) that a ray o, d
    (..., 3) tests in the kernel (csrc/tri.cu tri_kernel's `rows`): none
    where the block's sphere misses and the block's cone proves that it
    grazes no face, else those row_may_hit keeps. t_hi is a scalar or
    (...)."""
    sphere = bounds[..., 0, 0, :]
    xb = slack_bound(sphere, o)
    ball = ball_may_hit(sphere, xb, o, d, t_lo, t_hi)
    t_hi = torch.as_tensor(t_hi, device=o.device)
    t_hi = t_hi[..., None] if t_hi.dim() else t_hi
    rows = row_may_hit(bounds[..., 1:, :, :], ball[..., None], xb[..., None], o[..., None, :],
                       d[..., None, :], t_lo, t_hi)
    return (ball | grazes(bounds[..., 0, 1, :], d))[..., None] & rows


def face_may_hit(det, nu) -> torch.Tensor:
    """The kernel's face pretest on Moller-Trumbore's determinant and the
    numerator of u: False proves the face missed (|det| at or below the
    1e-12 guard, or u certainly below -1e-6 or above 1.000002)."""
    ad = det.abs()
    un = torch.where(det < 0.0, -nu, nu)
    return ~(~(ad > 1e-12) | (un < -4e-6 * ad) | (un > 2.0 * ad))


def _check_args(starts, blocks, face_rows, dirs_t, eye, origins_t, bounds=None):
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise ValueError("starts must be (T+1,) int32")
    if blocks.dtype != torch.int32 or blocks.dim() != 1:
        raise ValueError("blocks must be (cap_b,) int32")
    if (face_rows.dtype != _F32 or face_rows.dim() != 2 or face_rows.shape[1] != FACE_ROW
            or face_rows.shape[0] % FACES_PER_BLOCK):
        raise ValueError("face_rows must be (256 k, 9) float32")
    if dirs_t.dtype != _F32 or dirs_t.dim() != 3 or dirs_t.shape[2] != 3:
        raise ValueError("dirs_t must be (T, R, 3) float32")
    if starts.shape[0] != dirs_t.shape[0] + 1:
        raise ValueError("starts must have one entry more than dirs_t has tiles")
    if origins_t is not None and origins_t.shape != dirs_t.shape:
        raise ValueError("origins_t must be shaped like dirs_t")
    if eye.numel() != 3:
        raise ValueError("eye must hold 3 values")
    if bounds is not None and (bounds.dtype != _F32 or bounds.shape != (
            face_rows.shape[0] // FACES_PER_BLOCK, 1 + ROWS, 2, 4)):
        raise ValueError("bounds must be (face blocks, 33, 2, 4) float32 (face_bounds)")
    tensors = (starts, blocks, face_rows, dirs_t, eye) + tuple(
        x for x in (origins_t, bounds) if x is not None)
    if len({x.device for x in tensors}) != 1:
        raise ValueError("all tensors must share one device")


def closest_hit_blocks(starts, blocks, face_rows, dirs_t, eye, t_min: float, t_max: float,
                       origins_t=None, bounds=None, stats=None):
    """Kernel K4 wrapper. starts (T+1,) int32 per-tile face-slot starts
    (multiples of 256), blocks (cap_b,) int32: chunk j of tile t tests
    block blocks[starts[t] // 256 + j]; face_rows (F_pad, 9) float32;
    dirs_t (T, R, 3); rays start at eye (3,) or at origins_t (T, R, 3);
    bounds (F_pad / 256, 33, 2, 4) float32 (`face_bounds`), the pretests'
    bounds of each block and its rows by block id: the kernel needs them,
    the plain version ignores them. Given stats, a (T, 5) int32 tensor, it
    writes there per tile what the kernel ran (STATS, csrc/tri.cu
    Params::stats); on the CPU, what `pretest_stats` says it runs.

    Returns (t (T, R), +inf on a miss; face (T, R) int32 packed face id, -1
    on a miss; u (T, R); v (T, R))."""
    _check_args(starts, blocks, face_rows, dirs_t, eye, origins_t, bounds)
    T = dirs_t.shape[0]
    if stats is not None and (stats.dtype != torch.int32 or stats.shape != (T, len(STATS))
                              or stats.device != dirs_t.device):
        raise ValueError("stats must be (T, 5) int32 on the rays' device")
    if dirs_t.device.type == "cpu":
        if stats is not None:
            stats.copy_(pretest_stats(starts, blocks, face_rows, dirs_t, eye, t_min, t_max,
                                      origins_t, bounds))
        return closest_hit_blocks_plain(starts, blocks, face_rows, dirs_t, eye, t_min, t_max,
                                        origins_t, bounds)
    if dirs_t.device.type != "cuda":
        raise ValueError(f"no closest hit for device {dirs_t.device}")
    if bounds is None:
        raise ValueError("the kernel needs the face blocks' bounds (face_bounds)")
    if stats is None:
        stats = torch.empty((T, len(STATS)), dtype=torch.int32, device=dirs_t.device)
    return _closest_hit_cuda(starts.contiguous(), blocks.contiguous(), face_rows.contiguous(),
                             dirs_t.contiguous(), eye.to(_F32).contiguous(), t_min, t_max,
                             None if origins_t is None else origins_t.contiguous(),
                             bounds.contiguous(), stats)


def _closest_hit_cuda(starts, blocks, face_rows, dirs_t, eye, t_min, t_max, origins_t, bounds,
                      stats):
    from gaussian_ray_tracing_tpu_torch.ops.cuda_build import check, load_library

    lib = load_library()
    T, R, _ = dirs_t.shape
    if not tile_rays_supported(R):
        raise ValueError(f"rays per tile {R}: the kernel takes a multiple of 32 up to 1024 or "
                         f"of 128 above")
    if face_rows.data_ptr() % 16 or bounds.data_ptr() % 16 or not stats.is_contiguous():
        raise ValueError("face_rows and bounds must be 16-byte aligned (cp.async, float4), "
                         "stats contiguous")
    dev = dirs_t.device
    t = torch.empty((T, R), dtype=_F32, device=dev)
    face = torch.empty((T, R), dtype=torch.int32, device=dev)
    u = torch.empty((T, R), dtype=_F32, device=dev)
    v = torch.empty((T, R), dtype=_F32, device=dev)
    S = tile_splits(R)  # a split tile's slices count apart, then add up
    slices = stats if S == 1 else torch.empty((T * S, len(STATS)), dtype=torch.int32,
                                              device=dev)
    if T > 0:
        with torch.cuda.device(dev):
            err = lib.grt_closest_hit(
                starts.data_ptr(), blocks.data_ptr(), face_rows.data_ptr(), bounds.data_ptr(),
                dirs_t.data_ptr(), None if origins_t is None else origins_t.data_ptr(),
                eye.data_ptr(), t.data_ptr(), face.data_ptr(), u.data_ptr(), v.data_ptr(),
                slices.data_ptr(), T, R, t_min, t_max, torch.cuda.current_stream().cuda_stream,
            )
        check(err, "grt_closest_hit")
        closest_hit_blocks.launches += 1
        if S > 1:
            closest_hit_blocks.split_launches += 1
            stats.copy_(slices.reshape(T, S, len(STATS)).sum(1))
    return t, face, u, v


closest_hit_blocks.launches = 0
closest_hit_blocks.split_launches = 0  # of those, on tiles split over blocks (above 1024 rays)


def _det_and_nu(o, d, f):
    """Moller-Trumbore's determinant and numerator of u (ops/intersect.py's
    arithmetic) of rays (..., 3) against face rows f (..., 9)."""
    c = lambda a, i: a[..., i]
    dx, dy, dz = c(d, 0), c(d, 1), c(d, 2)
    e2x, e2y, e2z = c(f, 6), c(f, 7), c(f, 8)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = c(f, 3) * px + c(f, 4) * py + c(f, 5) * pz
    tx, ty, tz = c(o, 0) - c(f, 0), c(o, 1) - c(f, 1), c(o, 2) - c(f, 2)
    return det, tx * px + ty * py + tz * pz


def _walk(starts, blocks, face_rows, dirs_t):
    """The plain versions' visit: for each listed position j, the tiles
    listing a block there, in batches of at most _PLAIN_BATCH (tile, face,
    ray) elements: (tile ids (B,), block ids (B,), faces (B, 32, 8, 1, 9))."""
    R = dirs_t.shape[1]
    n_chunks = (starts[1:] - starts[:-1] + FACES_PER_BLOCK - 1).div(
        FACES_PER_BLOCK, rounding_mode="floor")
    blocks_of = face_rows.reshape(-1, ROWS, SLOTS, FACE_ROW)
    batch = max(1, _PLAIN_BATCH // (FACES_PER_BLOCK * R))
    for j in range(int(n_chunks.max()) if n_chunks.numel() else 0):
        for tb in (n_chunks > j).nonzero().squeeze(1).split(batch):
            blk = blocks[starts[tb].long() // FACES_PER_BLOCK + j]
            yield tb, blk, blocks_of[blk.long()][:, :, :, None, :]


def closest_hit_blocks_plain(starts, blocks, face_rows, dirs_t, eye, t_min: float,
                             t_max: float, origins_t=None, bounds=None):
    """Plain torch K4 on any device: all tiles advance block by block, in
    batches of at most _PLAIN_BATCH (tile, face, ray) elements, each block
    visited slot by slot (module docstring). `bounds` is ignored: the
    result never depends on it."""
    _check_args(starts, blocks, face_rows, dirs_t, eye, origins_t, bounds)
    T, R, _ = dirs_t.shape
    dev = dirs_t.device
    orig = eye.to(_F32).reshape(1, 1, 3).expand(T, R, 3) if origins_t is None else origins_t
    best_t = torch.full((T, R), _MISS, dtype=_F32, device=dev)
    best_f = torch.full((T, R), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((T, R), dtype=_F32, device=dev)
    best_v = torch.zeros((T, R), dtype=_F32, device=dev)
    for tb, blk, f in _walk(starts, blocks, face_rows, dirs_t):
        hit, tt, u, v = moller_trumbore(
            orig[tb][:, None, None], dirs_t[tb][:, None, None], f[..., 0:3], f[..., 3:6],
            f[..., 6:9], t_min, t_max)  # (B, 32, 8, R)
        tm = torch.where(hit, tt, _MISS)
        for s in range(SLOTS):
            row = torch.argmin(tm[:, :, s], dim=1, keepdim=True)  # first minimum
            t_s = torch.gather(tm[:, :, s], 1, row)[:, 0]
            better = t_s < best_t[tb]
            fid = blk[:, None] * FACES_PER_BLOCK + row[:, 0] * SLOTS + s
            best_t[tb] = torch.where(better, t_s, best_t[tb])
            best_f[tb] = torch.where(better, fid.to(torch.int32), best_f[tb])
            best_u[tb] = torch.where(better, torch.gather(u[:, :, s], 1, row)[:, 0], best_u[tb])
            best_v[tb] = torch.where(better, torch.gather(v[:, :, s], 1, row)[:, 0], best_v[tb])
    return (torch.where(best_t >= _MISS, float("inf"), best_t), best_f, best_u, best_v)


def pretest_stats(starts, blocks, face_rows, dirs_t, eye, t_min: float, t_max: float,
                  origins_t, bounds) -> torch.Tensor:
    """(T, 5) int32: what the kernel runs per tile under its pretests
    (STATS, csrc/tri.cu Params::stats), from their torch mirrors and each
    ray's best hit before each block. A tile stages a listed block when
    some ray needs it by block_may_hit with the best hits from before the
    last block it staged (it judges one block ahead); at a staged block,
    each ray finds the rows it needs (row_mask), the warp tests the rows
    some lane needs, and every lane of it computes face_may_hit on their
    faces. A block it does not stage no ray needs later either. A tile of
    more than 1024 rays counts as the sum of its slices (tile_splits), each
    a tile of split_width rays of its own over the same block list, the
    last padded with dead rays (zero direction), as the kernel's idle lanes
    are."""
    _check_args(starts, blocks, face_rows, dirs_t, eye, origins_t, bounds)
    T, R, _ = dirs_t.shape
    S = tile_splits(R)
    if S > 1:
        W = split_width(R)
        pad = lambda x: torch.cat([x, x.new_zeros((T, S * W - R, 3))], 1).reshape(T * S, W, 3)
        nb = (starts[1:] - starts[:-1]).long().repeat_interleave(S) // FACES_PER_BLOCK
        first = (starts[:-1].long() // FACES_PER_BLOCK).repeat_interleave(S)
        # each slice's copy of its tile's listed blocks
        ends = torch.cumsum(nb, 0)
        k = torch.arange(int(ends[-1]) if T else 0, device=starts.device)
        owner = torch.repeat_interleave(torch.arange(T * S, device=starts.device), nb)
        slot = first[owner] + k - (ends - nb)[owner]
        s_starts = torch.cat([ends.new_zeros(1), ends]).to(torch.int32) * FACES_PER_BLOCK
        per = pretest_stats(s_starts, blocks[slot], face_rows, pad(dirs_t), eye, t_min, t_max,
                            None if origins_t is None else pad(origins_t), bounds)
        return per.reshape(T, S, len(STATS)).sum(1, dtype=torch.int32)
    dev = dirs_t.device
    orig = eye.to(_F32).reshape(1, 1, 3).expand(T, R, 3) if origins_t is None else origins_t
    best_t = torch.full((T, R), _MISS, dtype=_F32, device=dev)
    judged = best_t.clone()  # the best hits the next staging is judged with
    stats = torch.zeros((T, len(STATS)), dtype=torch.int64, device=dev)
    for tb, blk, f in _walk(starts, blocks, face_rows, dirs_t):
        bnd = bounds[blk.long()]  # (B, 33, 2, 4)
        o_b, d_b = orig[tb], dirs_t[tb]  # (B, R, 3)
        B = tb.shape[0]
        staged = block_may_hit(bnd[:, None], o_b, d_b, t_min,
                               torch.clamp(judged[tb], max=t_max)).any(1)
        judged[tb] = torch.where(staged[:, None], best_t[tb], judged[tb])
        t_hi = torch.clamp(best_t[tb], max=t_max)
        need = block_may_hit(bnd[:, None], o_b, d_b, t_min, t_hi)  # (B, R)
        rows = row_mask(bnd[:, None], o_b, d_b, t_min, t_hi)  # (B, R, 32)
        wrows = rows.reshape(B, -1, WARP, ROWS).any(2).transpose(1, 2)  # (B, 32, R / 32)
        det, nu = _det_and_nu(o_b[:, None, None], d_b[:, None, None], f)  # (B, 32, 8, R)
        ran = wrows.repeat_interleave(WARP, 2)[:, :, None, :]
        stats[tb] += torch.stack([staged.long(), need.sum(1), wrows.any(1).sum(1),
                                  wrows.sum((1, 2)), (face_may_hit(det, nu) & ran).sum((1, 2, 3))],
                                 1)
        hit, tt, _, _ = moller_trumbore(o_b[:, None, None], d_b[:, None, None], f[..., 0:3],
                                        f[..., 3:6], f[..., 6:9], t_min, t_max)
        best_t[tb] = torch.minimum(best_t[tb], torch.where(hit, tt, _MISS).amin((1, 2)))
    return stats.to(torch.int32)
