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

`closest_hit_blocks` is the wrapper: CUDA tensors launch csrc/tri.cu, CPU
tensors run `closest_hit_blocks_plain`, anything else raises.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.ops.blocks import BlockIndex, _pad_rows, morton_order
from gaussian_ray_tracing_tpu_torch.ops.intersect import moller_trumbore

FACES_PER_BLOCK = 256
SLOTS, ROWS = 8, 32  # the TPU kernel's visit order: slot outer, row inner
FACE_ROW = 9  # v0 xyz, e1 xyz, e2 xyz
_MISS = 3.0e38
_F32 = torch.float32
_PLAIN_BATCH = 1 << 24  # (tile, face, ray) elements per plain batch


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


def _check_args(starts, blocks, face_rows, dirs_t, eye, origins_t):
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
    tensors = (starts, blocks, face_rows, dirs_t, eye) + (() if origins_t is None else (origins_t,))
    if len({x.device for x in tensors}) != 1:
        raise ValueError("all tensors must share one device")


def closest_hit_blocks(starts, blocks, face_rows, dirs_t, eye, t_min: float, t_max: float,
                       origins_t=None):
    """Kernel K4 wrapper. starts (T+1,) int32 per-tile face-slot starts
    (multiples of 256), blocks (cap_b,) int32: chunk j of tile t tests
    block blocks[starts[t] // 256 + j]; face_rows (F_pad, 9) float32;
    dirs_t (T, R, 3); rays start at eye (3,) or at origins_t (T, R, 3).

    Returns (t (T, R), +inf on a miss; face (T, R) int32 packed face id, -1
    on a miss; u (T, R); v (T, R))."""
    _check_args(starts, blocks, face_rows, dirs_t, eye, origins_t)
    if dirs_t.device.type == "cpu":
        return closest_hit_blocks_plain(starts, blocks, face_rows, dirs_t, eye, t_min, t_max,
                                        origins_t)
    if dirs_t.device.type != "cuda":
        raise ValueError(f"no closest hit for device {dirs_t.device}")
    return _closest_hit_cuda(starts.contiguous(), blocks.contiguous(), face_rows.contiguous(),
                             dirs_t.contiguous(), eye.to(_F32).contiguous(), t_min, t_max,
                             None if origins_t is None else origins_t.contiguous())


def _closest_hit_cuda(starts, blocks, face_rows, dirs_t, eye, t_min, t_max, origins_t):
    from gaussian_ray_tracing_tpu_torch.ops.cuda_build import check, load_library

    lib = load_library()
    T, R, _ = dirs_t.shape
    if R % 32 or not 32 <= R <= 1024:
        raise ValueError(f"rays per tile {R} must be a multiple of 32 in [32, 1024]")
    dev = dirs_t.device
    t = torch.empty((T, R), dtype=_F32, device=dev)
    face = torch.empty((T, R), dtype=torch.int32, device=dev)
    u = torch.empty((T, R), dtype=_F32, device=dev)
    v = torch.empty((T, R), dtype=_F32, device=dev)
    if T > 0:
        with torch.cuda.device(dev):
            err = lib.grt_closest_hit(
                starts.data_ptr(), blocks.data_ptr(), face_rows.data_ptr(), dirs_t.data_ptr(),
                None if origins_t is None else origins_t.data_ptr(), eye.data_ptr(),
                t.data_ptr(), face.data_ptr(), u.data_ptr(), v.data_ptr(),
                T, R, t_min, t_max, torch.cuda.current_stream().cuda_stream,
            )
        check(err, "grt_closest_hit")
        closest_hit_blocks.launches += 1
    return t, face, u, v


closest_hit_blocks.launches = 0


def closest_hit_blocks_plain(starts, blocks, face_rows, dirs_t, eye, t_min: float,
                             t_max: float, origins_t=None):
    """Plain torch K4 on any device: all tiles advance block by block, in
    batches of at most _PLAIN_BATCH (tile, face, ray) elements, each block
    visited slot by slot (module docstring)."""
    _check_args(starts, blocks, face_rows, dirs_t, eye, origins_t)
    T, R, _ = dirs_t.shape
    dev = dirs_t.device
    orig = eye.to(_F32).reshape(1, 1, 3).expand(T, R, 3) if origins_t is None else origins_t
    best_t = torch.full((T, R), _MISS, dtype=_F32, device=dev)
    best_f = torch.full((T, R), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((T, R), dtype=_F32, device=dev)
    best_v = torch.zeros((T, R), dtype=_F32, device=dev)
    n_chunks = (starts[1:] - starts[:-1] + FACES_PER_BLOCK - 1).div(
        FACES_PER_BLOCK, rounding_mode="floor")
    blocks_of = face_rows.reshape(-1, ROWS, SLOTS, FACE_ROW)
    batch = max(1, _PLAIN_BATCH // (FACES_PER_BLOCK * R))
    for j in range(int(n_chunks.max()) if T else 0):
        for tb in (n_chunks > j).nonzero().squeeze(1).split(batch):
            blk = blocks[starts[tb].long() // FACES_PER_BLOCK + j]  # (B,)
            f = blocks_of[blk.long()][:, :, :, None, :]  # (B, 32, 8, 1, 9)
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
