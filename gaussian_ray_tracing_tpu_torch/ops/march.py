"""Fused forward march over the sorted pair stream -- kernel K1.

Counterpart of `pallas_march_stream` / `_march_kernel` in
gaussian_ray_tracing_tpu/ops/pallas_march.py (forward), in the modes the
primary render, the training forward, the mesh tracer and the rolling
shutter use: SH degree 0 to 3; the quad response with a shared ray origin
on full [t_min, t_max] rays (or on segments, below), or the scalar
response with per-ray origins (rolling shutter, and block mode below); and
either

  - window order (config.order == "window", the render): exact event-t gate
    and the tile-wide window-sort fire, described below; or
  - key order (config.order == "key", render and training): the sqrt-free
    full-range gate alpha > alpha_min & (t* >= t_lo | q(t_lo) < 0), with
    q(t_lo) = cq + t_lo (2 od + t_lo dd), and a plain stream-order
    composite (pallas_march.py:552-569, 963-968); or
  - merge order (config.order == "merge", render only): the exact event-t
    gate and the cross-chunk streaming merge described below; or
  - oddeven (config.order == "oddeven"): JAX's kernel has no odd-even
    network, so it composites in stream order as key order does, with the
    exact event-t gate (the sqrt-free one only under the peak key,
    pallas_march.py:560-562, 966); it trains as key order does.

Each tile (R = tile_w * tile_h rays) owns the contiguous pair segment
[starts[t], starts[t+1]) and marches it front to back in chunks of c
candidates (key order and oddeven: any c, e.g. chunk_for's 96 or block
mode's chunk * block_sub = 512, which K1 stages in pieces of its build's
capacity; window and merge order: c in config.SORT_CHUNKS, where their sorts
sort), with these per-tile (not per-ray) decisions, as on the TPU:

  - chunk skip: the chunk is skipped once the max transmittance over ALL R
    rays of the tile is <= the skip threshold, max(chunk_skip_transmittance,
    min_transmittance) for a render and min_transmittance for the training
    forward (padded rays of a partial tile keep T = 1, so such tiles never
    skip);
  - window-sort fire (window order): if ANY ray of the fire group sees a
    significant (a > 0) candidate whose order key is below the running
    max of the keys of the significant ones before it, every ray of the
    group composites that chunk in sorted order of the key tq16 << 15 |
    a15, where tq16 quantizes the key over the group's [min, max] of
    significant keys, a15 = a*32767, alpha is decoded from the key and
    colours ride as 3x10-bit packs over [0, 4), one per (ray, candidate);
    otherwise the chunk composites in stream order with exact values. The
    fire group is the tile, or under config.sort_lane_groups each 128
    rays of a tile of more than 128 (pallas_march.py:775-779, 909-965);
    the chunk skip stays tile-wide. With config.sort_alpha_min > 0 the
    fire test, its running max included, only counts candidates with a >
    sort_alpha_min (:925-937), and where 0 < sort_repair = w < chunk and
    the group's band fits (i1 - i0 < w: i1 the last significant candidate
    below that running max, i0 the first above the least significant key
    after it, both over the group) only the candidates of the window
    [min(i0, chunk - w), + w) are sorted; the others keep their stream
    places, every candidate still through the pack (:858-893). At
    sort_alpha_min 0 the band covers every out-of-place candidate, so the
    whole list is sorted, the same order (the band is still counted for
    the stats);
  - merge step (merge order, pallas_march.py:352-363, 677-742, 974-982):
    each tile keeps a pending buffer of c (key, alpha, colour pack) slots
    per ray, empty slots INT32_MIN with alpha 0. A candidate's key is kb =
    bits(max(t_event, 0)) & ~0xFF for a significant one (a > 0), else the
    exclusive running max of the significant kb before it (INT32_MIN
    before the first), OR the source index in the low 8 bits. If no ray of
    the tile sees an inversion among its significant kb and every ray's
    least significant kb is at or above the largest key of its pending
    slots with a > 0 (the tile-wide fast test), the pending buffer
    composites as it stands and the chunk, in stream order, becomes the
    pending buffer; else each ray composites the c smallest of the
    ascending union of pending and chunk and keeps the c largest pending.
    The test is tile-wide because it decides what composites before the
    next chunk's skip test. Every composited colour rides the 3x10-bit
    pack; alphas are exact. After the last chunk the pending buffer
    composites where T > min_transmittance.

Colour (pallas_march.py:640-669): SH degree 0 reads max(0.5 + C0 sh0, 0),
precomputed per gaussian; degrees 1-3 evaluate max(0.5 + sum_k
basis_k(d) sh_k, 0) per (ray, candidate) in float32, k = 0..K-1 added in
turn onto 0.5 (K = (deg+1)^2), with the basis of ops/sh.sh_basis_list at
the ray's direction. The TPU kernel's default `sh_mxu` path (bf16 hi/lo
MXU splits of the same sum, ~4e-6 relative) is TPU layout and not ported.

Order key (config.window_key, pallas_march.py:552-575, 672-675): the
event t, or under "peak" t* = -od/dd, the peak response's t, in window
and merge order (key order reads neither). On full-range rays of the quad
response the peak key takes key order's sqrt-free gate; every other march
(segments, per-ray origins, block mode, the scalar response) keeps the
event gate and only orders by t*.

Compositing per chunk: p_excl = T * exp(exclusive prefix of log1p(-a)),
or under config.composite_scan (render only, every order) T * the
exclusive running product of (1 - a), multiplied in sequence;
w = a * p_excl * (p_excl > minT); the next T is the max of the
{p_incl <= minT} set when it is non-empty (the first candidate to cross
the threshold freezes it), else the whole-chunk product; T only advances
while T > minT. All of it in float32: the response
dd = q . m2(d), od = v . d, pp = oo - od^2/dd cancels by orders of
magnitude and must not see TF32 or bf16 inputs.

save_tin (the training forward, as the render up to 1024 rays per tile): every chunk's
carry-in T is stored BEFORE its skip test, so skipped chunks are saved
too, at row chunk_base[t] + j of a (sum of chunks, R) array, chunk_base =
[0, cumsum(ceil(count_t / c))] (pallas_march.py:461-473, 1075-1081); the
skip threshold is min_transmittance. The backward (ops/march_bwd.py,
kernel K3) replays each chunk from it. The training forward reads the
training rows (`train_features`). Key order runs the quad response from
the shared eye, the scalar response from per-ray origins (JAX's
quad=False; every origin the eye for the shared-origin scalar form) or
the per-ray-origin quad response (quad=True); window order the scalar
response from per-ray origins (`origins_t`, each the eye on the primary
render; JAX's quad=False, pallas_renderer.py:234-238) with the training
key: a fired chunk sorts its significant candidates by the unique key
(tq16 << 8) | src and composites them with the EXACT alpha and the
3x10-bit colours (pallas_march.py:833-842). The render-only options
(composite_scan, sort_lane_groups, sort_alpha_min, sort_repair) are
ignored there, as on the TPU; the peak key is not. Either order
takes per-ray windows t_lo / t_hi and a carry-in t0 (the saved carry of
chunk 0 is then t0); no block list.

Segments and bounced rays (the mesh tracer; pallas_march.py:236-241,
407-442, 586-633, 1046-1074, 1121-1124). Optional per-ray arguments, all
None on the primary render:

  - t_lo, t_hi (T, R): a per-ray window [t_lo, t_hi] of the event t, and
    t0 (T, R): the carry-in transmittance (a segment chained on an earlier
    one). Whenever a window, origin or block argument is given the ray is
    not a full-range ray, so key order takes the exact entry/exit event gate
    instead of the sqrt-free one.
  - origins_t (T, R, 3): per-ray origins, with the SCALAR response on the
    scalar rows (`scalar_features`, or the training rows with save_tin):
    o_g = M (o - mu), d_g = M d, t* = -od / max(dd, 1e-6) as a true
    division, pp = oo + t* (2 od + t* dd), the gate with disc >= 0, and the
    colour from the row's SH coefficients at the ray's own direction. The
    rolling shutter uses this mode on the pair stream, window-order
    training with every origin the eye, the mesh tracer's bounced rays in
    block mode (below) at SH 0-3.
  - origins_t with quad=True: the per-ray-origin QUAD response
    (pallas_march.py:378-405, 525-548) on the training rows, whose Q
    columns are view-independent. Each tile expands around its origin
    centroid o_bar, the mean of its R origins (all R rays, padded ones
    included, as jnp.mean takes it), summed as a fixed halving tree
    (`origin_centroid`, the kernel's order too) and divided by R. With a =
    o - o_bar per ray and b = mu - o_bar, Qb and b^T Q b per candidate:
    od = q . od6(a, d) - (Qb) . d, oo = q . oo6(a) - 2 (Qb) . a + b^T Q b,
    cq = oo - rad^2, then the quad response and the exact event gate. On the
    pair stream only (no block list).
  - blocks (cap_b,) int32 with block_sub: block mode over the Morton-sorted
    table (ops/blocks.block_stream). With bs = chunk / block_sub, chunk j of
    tile t reads rows [blocks[starts[t] / bs + j * block_sub + s] * bs, +bs)
    for s < block_sub.

Row layouts. `march_stream` takes per-pair rows in the JAX feature-table
layout (the very array `pallas_march_stream` takes) and gathers the
columns the march reads (`compact_features`): at SH 0 the compact 16-float
row [op, q00 q11 q22 q01 q02 q12, v, cq, oo, r g b, pad]; at SH 1-3 the
quad SH row [op, q (6), v (3), cq, oo, sh_r[K], sh_g[K], sh_b[K]], 12 + 3K
floats padded to a multiple of 4 (`quad_row`). The scalar rows
(`scalar_features`) are [op, 15 unused, mean (3), M (9), radius, sh_r[K],
sh_g[K], sh_b[K]], 29 + 3K floats padded to a multiple of 4. The training
rows (`train_features`, width `train_row`) are the scalar rows with the
quad columns in front: at SH 0 the 32-float row [compact row (16), mean,
M, radius, sh0], at SH 1-3 [op, q (6), v (3), cq, oo, 4 pad, mean, M,
radius, sh_r[K], sh_g[K], sh_b[K]] (80 floats at SH 3), so one gather
feeds both responses and the backward; saved carries (save_tin) and the
per-ray-origin quad response take these rows and only these, so the quad
response then reads the coefficients from column T_SH0 (and, with per-ray
origins, the mean from T_MX and the radius from T_RAD). `march` is the
wrapper: CUDA tensors go to the kernel (csrc/march.cuh, built as
csrc/march.cu and, for SH 1-3, csrc/march_sh{1,2,3}.cu), CPU tensors to
the plain torch version `march_plain`, anything else raises. The TPU's
packed16 int16 layout, 128-column padding, 8-row ray panels and bf16
hi/lo MXU splits are TPU layout work and are not ported.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.config import (
    RenderConfig, sort_chunk_refusal, tile_rays_supported,
)
from gaussian_ray_tracing_tpu_torch.ops.sh import SH_C0, num_coeffs, sh_basis_list

# JAX feature-table columns read by the quad/sh0 march: op 12, q 64..69,
# v 72..74, cq 75, oo 76, rgb 77..79
COMPACT_COLUMNS = (12, 64, 65, 66, 67, 68, 69, 72, 73, 74, 75, 76, 77, 78, 79)
ROW = 16  # compact row width in floats (15 used + 1 pad = 64 bytes)
_OP, _Q0, _V0, _CQ, _OO, _RGB0 = 0, 1, 7, 10, 11, 12
# Training row (TRAIN_ROW = 32 floats = 128 bytes): the compact row K1
# reads (0..15), then the scalar columns the backward K3 recomputes the
# response from (16..31): mean 16..18, M = S^-1 R^T row-major 19..27, the
# iso radius 28 and sh0 r, g, b 29..31. Opacity is column 0 for both.
# JAX feature-table column of each training column (None: zero pad).
TRAIN_COLUMNS = COMPACT_COLUMNS + (None,) + tuple(range(12)) + (13, 14, 15, 16)
TRAIN_ROW = 32
T_MX, T_M0, T_RAD, T_SH0 = 16, 19, 28, 29
_SH0 = 12  # first SH column of the quad SH rows (the JAX table's 14)
MAX_TRAIN_CHUNK = 256  # K3's largest chunk: training marches chunk_for's chunks
ORDERS = ("window", "key", "merge", "oddeven")  # grt_march's order codes 0, 1, 2, 3
_IMIN, _IMAX = -(2**31), 2**31 - 1
_ZBASE = 65535 << 15  # sort key of non-significant candidates (sorts last)
_F32 = torch.float32
_PLAIN_BATCH = 1 << 24  # (tile, candidate, ray) elements per plain-march batch
# Most bytes of scratch (K1's carry, K3's sums and dT) a launch of several
# rays a thread holds: a frame whose tiles need more runs as launches of
# the tiles that fit, at least one (scratch_tiles).
SCRATCH_BYTES = 4 << 30


def _gather_columns(feats: torch.Tensor, columns, width: int) -> torch.Tensor:
    used = [(i, c) for i, c in enumerate(columns) if c is not None]
    out = feats.new_zeros((feats.shape[0], width))
    dst = torch.tensor([i for i, _ in used], device=feats.device)
    src = torch.tensor([c for _, c in used], device=feats.device)
    out[:, dst] = feats.index_select(1, src)
    return out


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def quad_row(sh_degree: int) -> int:
    """Width of the shared-origin rows: 16 at SH 0, else 12 + 3K padded."""
    return ROW if sh_degree == 0 else _pad4(12 + 3 * num_coeffs(sh_degree))


def scalar_row(sh_degree: int) -> int:
    """Width of the per-ray-origin scalar rows: 29 + 3K padded (32 at SH 0)."""
    return _pad4(T_SH0 + 3 * num_coeffs(sh_degree))


def _sh_columns(sh_degree: int) -> tuple:
    """JAX feature-table columns of sh_r[0..K-1], sh_g[...], sh_b[...]."""
    return tuple(range(14, 14 + 3 * num_coeffs(sh_degree)))


def compact_features(feats: torch.Tensor, sh_degree: int = 0) -> torch.Tensor:
    """(N, F) JAX-layout rows with the quad block -> (N, quad_row) rows:
    the compact 16-float rows at SH 0, the quad SH rows above."""
    if sh_degree == 0:
        return _gather_columns(feats, COMPACT_COLUMNS, ROW)
    return _gather_columns(feats, COMPACT_COLUMNS[:12] + _sh_columns(sh_degree),
                           quad_row(sh_degree))


def scalar_features(feats: torch.Tensor, sh_degree: int = 0) -> torch.Tensor:
    """(N, F >= 14 + 3K) JAX-layout rows (no quad block needed) -> (N,
    scalar_row) rows for the per-ray-origin scalar response."""
    columns = (12,) + (None,) * 15 + tuple(range(12)) + (13,) + _sh_columns(sh_degree)
    return _gather_columns(feats, columns, scalar_row(sh_degree))


def train_row(sh_degree: int) -> int:
    """Width of the training rows: 32 at SH 0, scalar_row above (80 at SH 3)."""
    return TRAIN_ROW if sh_degree == 0 else scalar_row(sh_degree)


def train_columns(sh_degree: int) -> tuple:
    """JAX feature-table column of each training-row column (None: zero)."""
    if sh_degree == 0:
        return TRAIN_COLUMNS
    cols = COMPACT_COLUMNS[:12] + (None,) * 4 + tuple(range(12)) + (13,) + _sh_columns(sh_degree)
    return cols + (None,) * (train_row(sh_degree) - len(cols))


def diff_columns(sh_degree: int) -> frozenset:
    """JAX feature-table columns whose gradient K3 writes: mean, M, opacity
    and the 3K SH coefficients (the quad and radius columns get exactly
    zero)."""
    return frozenset(range(13)) | frozenset(_sh_columns(sh_degree))


def train_features(feats: torch.Tensor, sh_degree: int = 0) -> torch.Tensor:
    """(N, F) JAX-layout rows with the quad block -> (N, train_row) training
    rows. Only the diff_columns keep autograd; the quad and radius columns
    are detached, as K3 writes them no gradient, so a scene's parameters
    are reached once, through mean, M, opacity and the SH coefficients."""
    fixed = feats.detach()
    diff = diff_columns(sh_degree)
    zero = feats.new_zeros((feats.shape[0], 1))
    return torch.cat([
        zero if c is None else (feats if c in diff else fixed)[:, c : c + 1]
        for c in train_columns(sh_degree)
    ], dim=1)


def chunk_bases(starts: torch.Tensor, chunk: int) -> torch.Tensor:
    """(T+1,) int32 [0, cumsum(ceil(count_t / chunk))]: the row of tile t's
    first chunk in the saved-carry array."""
    n = (starts[1:] - starts[:-1] + chunk - 1).div(chunk, rounding_mode="floor")
    return torch.cat([n.new_zeros(1), torch.cumsum(n, 0)]).to(torch.int32)


def _skip_threshold(config: RenderConfig, save_tin: bool) -> float:
    """Chunk-skip threshold: min_transmittance for the training forward
    (its backward replays the skips from the saved carries), else
    max(chunk_skip_transmittance, min_transmittance)."""
    if save_tin:
        return config.min_transmittance
    return max(config.chunk_skip_transmittance, config.min_transmittance)


def march_stream(starts, pair_feats, dirs_t, config: RenderConfig, chunk: int,
                 save_tin: bool = False):
    """March every tile over its pair segment (JAX feature layout).

    starts (T+1,) int32, pair_feats (P, F >= 77) float32 with the quad
    block, dirs_t (T, R, 3). Returns (rgb (T, R, 3), t_final (T, R)) and,
    with save_tin (key order, on the training rows), also (tin (sum of
    chunks, R), chunk_base (T+1,)).
    """
    rows = (train_features if save_tin else compact_features)(pair_feats, config.sh_degree)
    return march(starts, rows, dirs_t, config, chunk, save_tin=save_tin)


def _check_args(starts, feats, dirs_t, config: RenderConfig, chunk, save_tin, seg=None,
                stats=False):
    seg = seg or {}
    if stats and save_tin:
        raise ValueError("stats are the render's window-order telemetry; save_tin returns "
                         "the carries instead (pallas_march.py:1168-1185)")
    if config.window_key not in ("event", "peak"):
        raise NotImplementedError(f"window_key {config.window_key!r} is not ported")
    origins, quad = seg.get("origins_t"), seg.get("quad", False)
    if config.order not in ORDERS:
        raise NotImplementedError(f"march order {config.order!r} is not ported")
    if chunk < 1:
        raise ValueError(f"march chunk {chunk}: a chunk holds at least one candidate")
    for bad in sort_chunk_refusal("order", config.order, chunk, f"march chunk {chunk}"):
        raise NotImplementedError(bad)
    if save_tin and chunk > MAX_TRAIN_CHUNK:
        raise NotImplementedError(f"saved carries at march chunk {chunk}: training marches "
                                  f"chunks of at most {MAX_TRAIN_CHUNK} (chunk_for's), which "
                                  f"the backward K3 replays")
    if save_tin and config.order == "merge":
        raise ValueError("order='merge' is a forward-render ordering; training runs window "
                         "or key order (pallas_march.py:1659-1663)")
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise ValueError("starts must be (T+1,) int32")
    if not 0 <= config.sh_degree <= 3:
        raise NotImplementedError(f"sh_degree {config.sh_degree} not in 0..3")
    if quad and origins is None:
        raise ValueError("quad=True is the per-ray-origin quad response and needs origins_t "
                         "(without origins the quad rows run the quad response)")
    if quad and seg.get("blocks") is not None:
        raise NotImplementedError("the per-ray-origin quad response runs on the pair stream, "
                                  "not in block mode")
    if save_tin and config.order == "window" and (origins is None or quad):
        raise NotImplementedError("window-order saved carries run the scalar response from "
                                  "per-ray origins (quad training needs key order, "
                                  "pallas_march.py:1664-1665)")
    if save_tin and seg.get("blocks") is not None:
        raise NotImplementedError("save_tin (training) takes no block list")
    deg = config.sh_degree
    width, rows = ((train_row(deg), "training") if save_tin or quad
                   else (scalar_row(deg), "scalar") if origins is not None
                   else (quad_row(deg), "quad"))
    if feats.dtype != _F32 or feats.dim() != 2 or feats.shape[1] != width:
        raise ValueError(f"feats must be float32 {rows} rows of width {width} at SH degree {deg}")
    if dirs_t.dtype != _F32 or dirs_t.dim() != 3 or dirs_t.shape[2] != 3:
        raise ValueError("dirs_t must be (T, R, 3) float32")
    if starts.shape[0] != dirs_t.shape[0] + 1:
        raise ValueError("starts must have one entry more than dirs_t has tiles")
    T, R = dirs_t.shape[:2]
    for name in ("t_lo", "t_hi", "t0"):
        x = seg.get(name)
        if x is not None and (x.dtype != _F32 or tuple(x.shape) != (T, R)):
            raise ValueError(f"{name} must be (T, R) float32")
    if origins is not None and (origins.dtype != _F32 or origins.shape != dirs_t.shape):
        raise ValueError("origins_t must be (T, R, 3) float32")
    blocks, block_sub = seg.get("blocks"), seg.get("block_sub", 1)
    if blocks is not None and (blocks.dtype != torch.int32 or blocks.dim() != 1):
        raise ValueError("blocks must be (cap_b,) int32")
    if block_sub < 1 or chunk % block_sub or (block_sub > 1 and blocks is None):
        raise ValueError("block_sub > 1 is block mode's multi-block chunk "
                         "(chunk % block_sub == 0)")
    devices = {starts.device, feats.device, dirs_t.device}
    devices |= {x.device for k, x in seg.items() if torch.is_tensor(x)}
    if len(devices) != 1:
        raise ValueError("all tensors must share one device")


def march(starts, feats, dirs_t, config: RenderConfig, chunk: int, save_tin: bool = False, *,
          origins_t=None, t_lo=None, t_hi=None, t0=None, blocks=None, block_sub: int = 1,
          quad: bool = False, stats: bool = False):
    """Kernel K1 wrapper on quad, scalar or (save_tin, or the per-ray-origin
    quad response: origins_t with quad=True) training rows (see module
    docstring).

    CUDA tensors launch csrc/march.cu; CPU tensors run march_plain.
    Returns (rgb (T, R, 3), t_final (T, R)) and, with save_tin, also (tin
    (sum of chunks, R), chunk_base (T+1,) int32), or with stats (render
    only) also (fired (T,), repaired (T,)) int32: per tile, the most
    chunks any of its fire groups sorted, and sorted by the span repair's
    band (window order; zeros in the others), JAX's stats=True telemetry
    (pallas_march.py:1174-1185).
    """
    seg = dict(origins_t=origins_t, t_lo=t_lo, t_hi=t_hi, t0=t0, blocks=blocks,
               block_sub=block_sub, quad=quad)
    _check_args(starts, feats, dirs_t, config, chunk, save_tin, seg, stats)
    if dirs_t.device.type == "cpu":
        return march_plain(starts, feats, dirs_t, config, chunk, save_tin, **seg, stats=stats)
    if dirs_t.device.type != "cuda":
        raise ValueError(f"no march for device {dirs_t.device}")
    seg = {k: v.contiguous() if torch.is_tensor(v) else v for k, v in seg.items()}
    return _march_cuda(starts.contiguous(), feats.contiguous(), dirs_t.contiguous(), config,
                       chunk, save_tin, **seg, stats=stats)


def scratch_tiles(tile_bytes: int, n_tiles: int) -> int:
    """Tiles of `tile_bytes` bytes of scratch each that one launch holds:
    all n_tiles where they fit in SCRATCH_BYTES, else as many as fit, at
    least one."""
    return max(1, min(n_tiles, SCRATCH_BYTES // max(1, tile_bytes)))


def _full_range(origins_t, t_lo, t_hi, blocks) -> bool:
    """Whole-ray march: no window, per-ray origin or block list
    (pallas_march.py:1121-1124); key order may then use the sqrt-free gate."""
    return origins_t is None and t_lo is None and t_hi is None and blocks is None


def _march_cuda(starts, feats, dirs_t, config: RenderConfig, chunk: int, save_tin: bool,
                origins_t, t_lo, t_hi, t0, blocks, block_sub, quad, stats):
    from gaussian_ray_tracing_tpu_torch.ops.cuda_build import check, load_library

    lib = load_library()
    T, R, _ = dirs_t.shape
    if not tile_rays_supported(R):
        raise ValueError(f"rays per tile {R}: the kernel takes a multiple of 32 up to 1024 or "
                         f"of 128 above")
    dev = dirs_t.device
    rgb = torch.empty((T, R, 3), dtype=_F32, device=dev)
    t_final = torch.empty((T, R), dtype=_F32, device=dev)
    tin = chunk_base = counts = None
    if save_tin:
        chunk_base = chunk_bases(starts, chunk)
        tin = torch.empty((int(chunk_base[-1]), R), dtype=_F32, device=dev)
    if stats:
        counts = torch.zeros((T, 2), dtype=torch.int32, device=dev)
    opts = window_options(config, R, chunk, save_tin)
    ptr = lambda x: None if x is None else x.data_ptr()
    # each ray's state between its turns where a thread marches several,
    # for the tiles of one launch
    fields = lib.grt_march_carry_floats(chunk, ORDERS.index(config.order), R)
    held = scratch_tiles(4 * fields * R, T)
    carry = torch.empty((held, fields, R), dtype=_F32, device=dev) if fields and T else None
    if T > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.grt_march(
                starts.data_ptr(), feats.data_ptr(), dirs_t.data_ptr(),
                rgb.data_ptr(), t_final.data_ptr(), ptr(tin), ptr(chunk_base),
                ptr(origins_t), ptr(t_lo), ptr(t_hi), ptr(t0), ptr(blocks),
                block_sub, T, R, chunk, feats.shape[1], ORDERS.index(config.order),
                int(_full_range(origins_t, t_lo, t_hi, blocks)),
                config.t_min, config.t_max, config.min_transmittance,
                _skip_threshold(config, save_tin), config.alpha_min, config.alpha_clamp,
                config.hit_multiplicity, num_coeffs(config.sh_degree), int(quad),
                int(config.window_key == "peak"), int(opts["scan"]), opts["group"],
                opts["a_fire"], opts["repair"], ptr(counts), ptr(carry), held, stream,
            )
        check(err, "grt_march")
        march.launches += 1
        if R > 1024:
            march.cluster_launches += 1
        if carry is not None:
            march.slot_launches += 1
        key, sh = config.order in ("key", "oddeven"), config.sh_degree > 0
        if config.order == "oddeven":
            march.oddeven_launches += 1
        if config.order == "merge":
            march.merge_launches += 1
            if blocks is not None:
                march.merge_block_launches += 1
        if save_tin and quad:
            march.origin_quad_save_tin_launches += 1
        elif save_tin and key and origins_t is not None:
            march.key_scalar_save_tin_launches += 1
        elif save_tin:
            attr = {(True, False): "save_tin_launches", (False, False): "window_save_tin_launches",
                    (True, True): "sh_key_save_tin_launches",
                    (False, True): "sh_save_tin_launches"}[key, sh]
            setattr(march, attr, getattr(march, attr) + 1)
        elif quad:
            march.origin_quad_launches += 1
        elif blocks is not None:
            march.block_launches += 1
        elif t_lo is not None or t_hi is not None or t0 is not None:
            march.segment_launches += 1
        elif origins_t is not None:
            march.origin_launches += 1
        if sh and not save_tin:
            if key:
                march.sh_key_launches += 1
            elif config.order == "window":
                march.sh_launches += 1
        for attr, on in (("peak_launches", config.window_key == "peak" and not key),
                         ("scan_launches", opts["scan"]),
                         ("group_launches", config.order == "window" and opts["group"] < R),
                         ("fire_alpha_launches", config.order == "window" and opts["a_fire"] > 0)):
            if on:
                setattr(march, attr, getattr(march, attr) + 1)
    if save_tin:
        return rgb, t_final, tin, chunk_base
    if stats:
        return rgb, t_final, tuple(counts.unbind(-1))
    return rgb, t_final


march.launches = 0  # every K1 launch
march.cluster_launches = 0  # of those, the cluster builds' (tiles of more than 1024 rays)
march.slot_launches = 0  # of those, several rays a thread (tiles of more than 8192 rays)
# saved carries (training forwards), by order and SH degree
march.save_tin_launches = 0  # key order, SH 0
march.window_save_tin_launches = 0  # window order (scalar response from per-ray origins), SH 0
march.sh_key_save_tin_launches = 0  # key order, SH 1-3
march.sh_save_tin_launches = 0  # window order, SH 1-3
march.key_scalar_save_tin_launches = 0  # key order on the scalar response (per-ray origins)
march.origin_quad_save_tin_launches = 0  # key order on the per-ray-origin quad response
march.origin_quad_launches = 0  # the per-ray-origin quad response (no saved carries)
march.segment_launches = 0  # windowed or chained segments on the pair stream
march.block_launches = 0  # block mode (bounced rays over the Morton table)
march.origin_launches = 0  # per-ray origins on the pair stream (rolling shutter)
march.sh_launches = 0  # SH degree 1-3, window order (no saved carries)
march.sh_key_launches = 0  # SH degree 1-3, key order (no saved carries)
march.merge_launches = 0  # merge order, every mode and SH degree
march.merge_block_launches = 0  # merge order in block mode (bounced rays)
march.oddeven_launches = 0  # oddeven: key order's kernel on the exact event gate, every mode
# the window-order render options (window_options) and the peak key
march.peak_launches = 0  # window_key "peak" in window or merge order (saved carries too)
march.scan_launches = 0  # composite_scan's product form (render, any order)
march.group_launches = 0  # sort_lane_groups: fire groups of 128 rays (window order)
march.fire_alpha_launches = 0  # sort_alpha_min > 0 (window order)


# --- plain torch version ---------------------------------------------------

def _pack_colors(cols):
    """3 colour tensors in [0, 4) -> int32 3x10-bit packs (1/255.75 steps)."""
    q = lambda x: torch.clamp(x * 255.75, 0.0, 1023.0).to(torch.int32)
    return (q(cols[0]) << 20) | (q(cols[1]) << 10) | q(cols[2])


def _unpack_colors(cp):
    unq = lambda x: x.to(_F32) * (1.0 / 255.75)
    return [unq((cp >> 20) & 1023), unq((cp >> 10) & 1023), unq(cp & 1023)]


def _composite(t_carry, a, cols, min_t: float, scan: bool = False):
    """Front-to-back composite of ordered (B, c, R) alphas from carry-in
    t_carry (B, 1, R). Returns (rgb_part (B, R, 3), t_next (B, R)).
    scan (config.composite_scan, render only): the product form
    (pallas_march.py:276-290), p_excl = t_carry * P with P the running
    product of (1 - a) over the earlier candidates and the last P for the
    whole chunk, multiplied in sequence (torch.cumprod), as K1 does; else
    exp of the running sum of log1p(-a)."""
    if scan:
        one_m = 1.0 - a
        prod = torch.cumprod(one_m, dim=1)
        p_excl = t_carry * torch.cat([torch.ones_like(prod[:, :1]), prod[:, :-1]], dim=1)
        p_incl = p_excl * one_m
        p_last = t_carry[:, 0] * prod[:, -1]
    else:
        logp = torch.log1p(-a)
        s_incl = torch.cumsum(logp, dim=1)
        s_excl = torch.cat([torch.zeros_like(s_incl[:, :1]), s_incl[:, :-1]], dim=1)
        p_excl = t_carry * torch.exp(s_excl)
        p_incl = p_excl * (1.0 - a)
        p_last = t_carry[:, 0] * torch.exp(logp.sum(dim=1))
    w = a * p_excl * (p_excl > min_t)
    below = p_incl <= min_t
    frozen = torch.where(below, p_incl, float("-inf")).amax(dim=1)
    t_next = torch.where(below.any(dim=1), frozen, p_last)
    rgb_part = torch.stack([(w * col).sum(dim=1) for col in cols], dim=-1)
    return rgb_part, t_next


def _event_gate(od, dd, cq, t_lo, t_hi):
    """Exact iso-ellipsoid event t (entry, or exit from inside) and its
    window test t_lo <= t_event <= t_hi."""
    disc = od * od - dd * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_dd = 1.0 / torch.clamp(dd, min=1e-12)
    t_entry = (-od - sq) * inv_dd
    t_exit = (-od + sq) * inv_dd
    t_ev = torch.where(t_entry < t_lo, t_exit, t_entry)
    return t_ev, (t_ev >= t_lo) & (t_ev <= t_hi), disc


def _effective(alpha, gate, config: RenderConfig):
    hm = config.hit_multiplicity
    a_eff = alpha if hm == 1 else 1.0 - (1.0 - alpha) ** hm
    return torch.where(gate, a_eff, 0.0)


def origin_centroid(x: torch.Tensor) -> torch.Tensor:
    """(T, R) -> (T, 1): each tile's mean of its R values, summed as a
    halving tree (with n values left and h = ceil(n / 2), value i < n - h
    takes value i + h), then divided by R: the order K1 sums it in."""
    R = x.shape[1]
    n = R
    while n > 1:
        h = (n + 1) // 2
        x = torch.cat([x[:, : n - h] + x[:, h:n], x[:, n - h : h]], dim=1)
        n = h
    return x[:, :1] / R


def _origin_quad(q, f, rays, dx, dy, dz):
    """od, oo and cq of the per-ray-origin quad response (pallas_march.py
    :378-405, 525-548): the expansion around the tile's origin centroid,
    from the Q columns, the mean and the radius of the training rows."""
    col = lambda k: f[:, :, k : k + 1]
    ob = rays["obar"]  # 3 x (B, 1, 1)
    ax, ay, az = (o - c for o, c in zip(rays["o"], ob))  # (B, 1, R)
    od6 = (ax * dx, ay * dy, az * dz, ax * dy + ay * dx, ax * dz + az * dx, ay * dz + az * dy)
    oo6 = (ax * ax, ay * ay, az * az, 2.0 * ax * ay, 2.0 * ax * az, 2.0 * ay * az)
    bx, by, bz = (col(T_MX + k) - ob[k] for k in range(3))  # (B, c, 1) b = mu - o_bar
    vx = q[0] * bx + q[3] * by + q[4] * bz  # Q b
    vy = q[3] * bx + q[1] * by + q[5] * bz
    vz = q[4] * bx + q[5] * by + q[2] * bz
    mqm = vx * bx + vy * by + vz * bz  # b^T Q b
    od = q[0] * od6[0] + q[1] * od6[1] + q[2] * od6[2] + q[3] * od6[3] + q[4] * od6[4] \
        + q[5] * od6[5] - (vx * dx + vy * dy + vz * dz)
    oo = q[0] * oo6[0] + q[1] * oo6[1] + q[2] * oo6[2] + q[3] * oo6[3] + q[4] * oo6[4] \
        + q[5] * oo6[5] - 2.0 * (vx * ax + vy * ay + vz * az) + mqm
    rad = col(T_RAD)
    return od, oo, oo - rad * rad


def _quad_alpha(f, rays, present, config: RenderConfig):
    """Quad-form response of a (B, c, ROW+) candidate block against the
    rays of `rays` (each (B, 1, R)), from the shared eye's columns or, with
    per-ray origins, the expansion around the tile's origin centroid: the
    gated effective alpha (B, c, R), the event t (None under the full-range
    key gate) and the colours."""
    col = lambda k: f[:, :, k : k + 1]  # (B, c, 1)
    dx, dy, dz = rays["d"]
    m2 = (dx * dx, dy * dy, dz * dz, 2.0 * dx * dy, 2.0 * dx * dz, 2.0 * dy * dz)
    q = [col(_Q0 + k) for k in range(6)]
    dd = q[0] * m2[0] + q[1] * m2[1] + q[2] * m2[2] + q[3] * m2[3] \
        + q[4] * m2[4] + q[5] * m2[5]  # (B, c, R)
    if rays["o"] is None:
        od = col(_V0) * dx + col(_V0 + 1) * dy + col(_V0 + 2) * dz
        cq, oo = col(_CQ), col(_OO)
    else:
        od, oo, cq = _origin_quad(q, f, rays, dx, dy, dz)
    rcp6 = 1.0 / torch.clamp(dd, min=1e-6)
    t_star = -od * rcp6
    pp = oo + od * t_star  # oo - od^2/dd
    resp = torch.exp(-0.5 * torch.clamp(pp, min=0.0))
    alpha = torch.clamp(resp * col(_OP), max=config.alpha_clamp)
    t_lo, live = rays["t_lo"], rays["live"]
    peak = config.window_key == "peak"
    if rays["full_range"] and (config.order == "key" or peak):
        # sqrt-free full-range gate: the convex q(t) = |o_g + t d_g|^2 -
        # rad^2 is negative somewhere in [t_lo, inf); its order key is t*
        # (pallas_march.py:561-569)
        q_lo = cq + t_lo * (2.0 * od + t_lo * dd)
        gate = present & live & (alpha > config.alpha_min) \
            & ((t_star >= t_lo) | (q_lo < 0.0))
        t_ev = t_star
    else:
        t_ev, in_window, _ = _event_gate(od, dd, cq, t_lo, rays["t_hi"])
        # disc >= 0 is implied by alpha > alpha_min (the adaptive radius is
        # the alpha_min iso-surface), so the gate drops it, as on the TPU
        gate = present & in_window & live & (alpha > config.alpha_min)
        if peak:  # the event gate, the order key t* (pallas_march.py:672-675)
            t_ev = t_star
    if rays["basis"] is None:
        cols = [col(_RGB0 + ch) for ch in range(3)]
    else:
        cols = _sh_colors(f, rays["sh_col"], rays["basis"])
    return _effective(alpha, gate, config), t_ev, cols


def _scalar_alpha(f, rays, present, config: RenderConfig):
    """Scalar (canonical-frame) response of (B, c, scalar_row) rows against
    per-ray origins: gated effective alpha, event t and colours."""
    col = lambda k: f[:, :, k : k + 1]  # (B, c, 1)
    dx, dy, dz = rays["d"]
    ox, oy, oz = (o - col(T_MX + k) for k, o in enumerate(rays["o"]))  # (B, c, R)
    m = [col(T_M0 + k) for k in range(9)]
    og = [m[3 * i] * ox + m[3 * i + 1] * oy + m[3 * i + 2] * oz for i in range(3)]
    dg = [m[3 * i] * dx + m[3 * i + 1] * dy + m[3 * i + 2] * dz for i in range(3)]
    dd = dg[0] * dg[0] + dg[1] * dg[1] + dg[2] * dg[2]
    od = og[0] * dg[0] + og[1] * dg[1] + og[2] * dg[2]
    oo = og[0] * og[0] + og[1] * og[1] + og[2] * og[2]
    t_star = -od / torch.clamp(dd, min=1e-6)  # a true division, as on the TPU
    pp = oo + t_star * (2.0 * od + t_star * dd)
    resp = torch.exp(-0.5 * torch.clamp(pp, min=0.0))
    alpha = torch.clamp(resp * col(0), max=config.alpha_clamp)
    rad = col(T_RAD)
    t_ev, in_window, disc = _event_gate(od, dd, oo - rad * rad, rays["t_lo"], rays["t_hi"])
    gate = present & (disc >= 0.0) & in_window & rays["live"] & (alpha > config.alpha_min)
    if config.window_key == "peak":
        # the order key t*; the scalar response keeps the event gate on every
        # march, full-range or not (pallas_march.py:586-633 has no fast gate)
        t_ev = t_star
    if rays["basis"] is None:
        cols = [torch.clamp(0.5 + SH_C0 * col(T_SH0 + ch), min=0.0) for ch in range(3)]
    else:
        cols = _sh_colors(f, T_SH0, rays["basis"])
    return _effective(alpha, gate, config), t_ev, cols


def _sh_colors(f, base: int, basis):
    """Per-(ray, candidate) SH colours (B, c, R) of rows f (B, c, row) whose
    coefficients sh_r[K], sh_g[K], sh_b[K] start at column `base`: 0.5 plus
    basis_k * sh_k for k = 0..K-1 in turn, clamped at 0 (pallas_march.py
    :666-669)."""
    K = len(basis)
    cols = []
    for ch in range(3):
        acc = 0.5 + basis[0] * f[:, :, base + ch * K : base + ch * K + 1]
        for k in range(1, K):
            acc = acc + basis[k] * f[:, :, base + ch * K + k : base + ch * K + k + 1]
        cols.append(torch.clamp(acc, min=0.0))
    return cols


def _chunk_rows(tb, j, starts, c, n_rows, blocks, block_sub):
    """(B, c) row indices of chunk j of tiles tb and the (B, c, 1) tail mask."""
    dev = starts.device
    base = starts[tb].long()
    k = torch.arange(c, device=dev)
    present = (j * c + k)[None, :] < (starts[tb + 1].long() - base)[:, None]
    if blocks is None:
        idx = base[:, None] + j * c + k[None, :]
    else:
        bs = c // block_sub
        slot = base[:, None] // bs + j * block_sub + (k // bs)[None, :]
        slot = torch.clamp(slot, max=blocks.shape[0] - 1)  # tail lookups are masked
        idx = blocks[slot].long() * bs + (k % bs)[None, :]
    return torch.clamp(idx, max=n_rows - 1), present[..., None]


def _chunk_plain(tb, j, starts, feats, rays, trans, rgb, config, c, blocks, block_sub,
                 train: bool, pend, opts: dict, groups):
    """March chunk j of tiles `tb` (in place on trans/rgb, and in merge
    order on the pending buffers `pend`; in window order adds each fire
    group's fired and repaired chunk to groups (T, G, 2)). Returns the
    number of significant (a > 0) (ray, candidate) pairs, whose colour the
    march evaluates, the number of these tiles whose chunk fired in some
    fire group (window order) and the number whose tile-wide fast test
    failed (merge order)."""
    idx, present = _chunk_rows(tb, j, starts, c, feats.shape[0], blocks, block_sub)
    f = feats[idx]  # (B, c, row)
    # per-ray lists and tensors are cut to the batch
    sub = {k: ([x[tb][:, None] for x in v] if isinstance(v, list)
               else v[tb][:, None] if torch.is_tensor(v) else v) for k, v in rays.items()}
    alpha_fn = _quad_alpha if rays["quad"] else _scalar_alpha
    a, t_ev, cols = alpha_fn(f, sub, present, config)
    min_t, scan = config.min_transmittance, opts["scan"]
    t_carry = trans[tb][:, None]  # (B, 1, R)
    fired = slow = 0
    if config.order in ("key", "oddeven"):  # stream order
        part, t_next = _composite(t_carry, a, cols, min_t, scan)
    elif config.order == "merge":
        part, t_next, new, slow = _merge_composite(t_carry, a, t_ev, cols,
                                                   [x[tb] for x in pend], min_t, scan)
        for x, y in zip(pend, new):
            x[tb] = y
    else:
        part, t_next, g_fired, g_rep = _window_composite(t_carry, a, t_ev, cols, min_t, train,
                                                         opts)
        groups[tb] += torch.stack([g_fired, g_rep], dim=-1).to(groups.dtype)
        fired = int(g_fired.any(dim=1).sum())
    tc = trans[tb]
    trans[tb] = torch.where(tc > min_t, t_next, tc)
    rgb[tb] += part
    return (a > 0.0).sum(), fired, slow


def window_options(config: RenderConfig, rays: int, chunk: int, save_tin: bool) -> dict:
    """The window-order options of a K1 call, at their neutral values under
    saved carries, where JAX ignores them (pallas_march.py:775-796, 925-930):
    group, the rays of a fire group (128 under sort_lane_groups where the
    tile holds more than one whole group, else the tile); a_fire, the alpha
    the fire test's candidates must exceed (sort_alpha_min); repair, the
    span-repair width (sort_repair where 0 < sort_repair < chunk, else 0);
    scan, composite_scan's product form (every order)."""
    lanes = config.sort_lane_groups and not save_tin and rays % 128 == 0 and rays > 128
    return dict(
        group=128 if lanes else rays,
        a_fire=float(config.sort_alpha_min) if config.sort_alpha_min > 0 and not save_tin
        else 0.0,
        repair=config.sort_repair if not save_tin and 0 < config.sort_repair < chunk else 0,
        scan=bool(config.composite_scan) and not save_tin)


def window_fire(a, t_ev, a_fire: float = 0.0):
    """(B,) bool: the window-sort fire test of (B, c, R) alphas and order
    keys over each fire group's rays: a candidate with a > a_fire below the
    exclusive running max of the order keys of those before it."""
    sig = a > a_fire
    run = torch.cummax(torch.where(sig, t_ev, float("-inf")), dim=1).values
    rmax = torch.cat([torch.full_like(run[:, :1], float("-inf")), run[:, :-1]], 1)
    return (sig & (t_ev < rmax)).flatten(1).any(dim=1)


def window_tq(a, t_ev):
    """(B, c, R) int32 tq16: the order key quantized over each fire group's
    [min, max] of significant keys (B, 1, 1)."""
    sig = a > 0.0
    inf = float("inf")
    t_lo = torch.where(sig, t_ev, inf).amin(dim=(1, 2), keepdim=True)
    t_hi = torch.where(sig, t_ev, -inf).amax(dim=(1, 2), keepdim=True)
    t_rng = torch.clamp(t_hi - t_lo, min=1e-20)
    # a true division: torch computes `65534.0 / t_rng` as
    # reciprocal(t_rng) * 65534, which rounds twice and moves the
    # quantization bucket edges away from the kernel's and the TPU's
    scale = torch.full_like(t_rng, 65534.0) / t_rng
    return torch.clamp((t_ev - t_lo) * scale, 0.0, 65534.0).to(torch.int32)


def repair_band(a, t_ev, a_fire: float, w: int):
    """The span repair's band of (B, c, R) fire groups (pallas_march.py
    :858-874): i1, the last candidate index where a significant key lies
    below the running max of the keys with a > a_fire before it; i0, the
    first where a significant key lies above the least significant key
    after it; both over the group's rays. Returns ((B,) bool: the band fits,
    i1 - i0 < w; (B,) the window start min(i0, c - w))."""
    B, c, _ = a.shape
    sig = a > 0.0
    idx = torch.arange(c, device=a.device)[None, :, None]
    run = torch.cummax(torch.where(a > a_fire, t_ev, float("-inf")), dim=1).values
    rmax = torch.cat([torch.full_like(run[:, :1], float("-inf")), run[:, :-1]], 1)
    i1 = torch.where(sig & (t_ev < rmax), idx, -1).flatten(1).amax(dim=1)
    suffix = torch.cummin(torch.where(sig, t_ev, float("inf")).flip(1), dim=1).values.flip(1)
    smin = torch.cat([suffix[:, 1:], torch.full_like(suffix[:, :1], float("inf"))], 1)
    i0 = torch.where(sig & (t_ev > smin), idx, c).flatten(1).amin(dim=1)
    return i1 - i0 < w, torch.clamp(i0, max=c - w)


def train_sort_key(a, t_ev):
    """(B, c, R) int32 training sort key: (tq16 << 8) | src for significant
    candidates, (65535 << 8) | src for the rest, unique per ray
    (pallas_march.py:833-838)."""
    src = torch.arange(a.shape[1], dtype=torch.int32, device=a.device)[None, :, None]
    return torch.where(a > 0.0, window_tq(a, t_ev) << 8, 65535 << 8) | src


def _split_groups(x, G: int):
    """(B, c, R) -> (B G, c, R / G): each fire group as a tile of its own
    ((B, c, 1) columns repeat)."""
    B, c, r = x.shape
    if r == 1:
        return x.repeat_interleave(G, dim=0)
    return x.reshape(B, c, G, r // G).transpose(1, 2).reshape(B * G, c, r // G)


def _window_composite(t_carry, a, t_ev, cols, min_t: float, train: bool, opts: dict):
    """Window order, per fire group (opts: window_options): stream-order
    composite of the unfired groups, sorted composite of those whose chunk
    fired (train: the unique training key with exact alphas; render: the
    key tq16 << 15 | a15, the whole chunk, or with a_fire > 0 only the
    repair band's window of candidates where the band fits). Returns
    (rgb_part (B, R, 3), t_next (B, R), (B, G) fired and repaired)."""
    B, c, R = a.shape
    G = R // opts["group"]
    scan = opts["scan"]
    if G > 1:  # each group a tile of its own
        t_carry, a, t_ev = (_split_groups(x, G) for x in (t_carry, a, t_ev))
        cols = [_split_groups(x, G) for x in cols]
    fired = window_fire(a, t_ev, opts["a_fire"])  # (B G,)
    repaired = torch.zeros_like(fired)
    part = a.new_empty((a.shape[0], a.shape[2], 3))
    t_next = a.new_empty(a.shape[::2])
    nf = (~fired).nonzero().squeeze(1)
    if nf.numel():
        part[nf], t_next[nf] = _composite(t_carry[nf], a[nf], [x[nf] for x in cols], min_t, scan)
    fb = fired.nonzero().squeeze(1)
    if fb.numel():
        a_f, t_f = a[fb], t_ev[fb]
        if train:
            a_f = a_f.expand(-1, -1, t_f.shape[2])
            key_s, perm = torch.sort(train_sort_key(a_f, t_f), dim=1)  # unique keys
            a_s = torch.gather(a_f, 1, perm)
        else:
            aq = torch.clamp(a_f * 32767.0, 0.0, 32767.0).to(torch.int32)
            key = torch.where(a_f > 0.0, (window_tq(a_f, t_f) << 15) | aq, _ZBASE)
            order = key
            w = opts["repair"]
            if w:
                ok, ws = repair_band(a_f, t_f, opts["a_fire"], w)
                repaired[fb] = ok
                if opts["a_fire"] > 0.0:
                    # sort the window [ws, ws + w) alone; the candidates
                    # before and after it keep their stream places
                    idx = torch.arange(c, device=a.device)[None, :, None]
                    lo = ws[:, None, None]
                    inwin = (idx >= lo) & (idx < lo + w)
                    part_of = torch.where(idx < lo, 0, torch.where(inwin, 1, 2)).long()
                    band = (part_of << 40) | torch.where(inwin, key, idx).long()
                    order = torch.where(ok[:, None, None], band, key.long())
            _, perm = torch.sort(order, dim=1, stable=True)
            key_s = torch.gather(key, 1, perm)
            a_s = torch.where(key_s >= _ZBASE, 0.0,
                              (key_s & 32767).to(_F32) * (1.0 / 32767.0))
        cp = _pack_colors([x[fb] for x in cols]).expand(-1, -1, perm.shape[2])
        cp_s = torch.gather(cp, 1, perm)
        part[fb], t_next[fb] = _composite(t_carry[fb], a_s, _unpack_colors(cp_s), min_t, scan)
    return part.reshape(B, R, 3), t_next.reshape(B, R), fired.reshape(B, G), \
        repaired.reshape(B, G)


def merge_keys(a, t_ev):
    """(B, c, R) merge keys of a chunk's alphas and event t, and (B,) the
    tile-wide inversion test: kb = bits(max(t_ev, 0)) & ~0xFF for the
    significant candidates, else the exclusive running max of the
    significant kb (INT32_MIN before the first), OR the source index.
    Returns (keys, kb, has_inv)."""
    sig = a > 0.0
    kb = torch.clamp(t_ev, min=0.0).contiguous().view(torch.int32) & ~0xFF
    run = torch.cummax(torch.where(sig, kb, _IMIN), dim=1).values
    rmax = torch.cat([torch.full_like(run[:, :1], _IMIN), run[:, :-1]], dim=1)
    src = torch.arange(a.shape[1], dtype=torch.int32, device=a.device)[None, :, None]
    keys = torch.where(sig, kb, rmax) | src
    return keys, kb, (sig & (kb < rmax)).flatten(1).any(dim=1)


def _merge_composite(t_carry, a, t_ev, cols, pend, min_t: float, scan: bool = False):
    """Merge order, one chunk of (B, c, R) candidates against the tiles'
    pending buffers pend = [keys, alphas, colour packs] (B, c, R): the
    tile-wide fast test, then either the pending buffer as it stands or
    the c smallest of the stably sorted union (pending first on equal
    keys) composite. Returns (rgb_part (B, R, 3), t_next (B, R), the new
    pending buffers, the number of tiles whose fast test failed)."""
    B, c, R = a.shape
    pk, pa, pc = pend
    keys, kb, has_inv = merge_keys(a, t_ev)
    new_min = torch.where(a > 0.0, kb, _IMAX).amin(dim=1)  # (B, R)
    pend_max = torch.where(pa > 0.0, pk, _IMIN).amax(dim=1)
    fast = (~has_inv & (new_min >= pend_max).all(dim=1))[:, None, None]
    n_slow = int((~fast).sum())
    chunk = (keys, a, _pack_colors(cols).expand(B, c, R))
    mk, perm = torch.sort(torch.cat([pk, keys], dim=1), dim=1, stable=True)
    union = (mk, torch.gather(torch.cat([pa, a], 1), 1, perm),
             torch.gather(torch.cat([pc, chunk[2]], 1), 1, perm))
    ready = [torch.where(fast, p, u[:, :c]) for p, u in zip(pend, union)]
    new = [torch.where(fast, x, u[:, c:]) for x, u in zip(chunk, union)]
    part, t_next = _composite(t_carry, ready[1], _unpack_colors(ready[2]), min_t, scan)
    return part, t_next, new, n_slow


def march_plain(starts, feats, dirs_t, config: RenderConfig, chunk: int,
                save_tin: bool = False, *, origins_t=None, t_lo=None, t_hi=None, t0=None,
                blocks=None, block_sub: int = 1, quad: bool = False, stats: bool = False):
    """Plain torch march on any device: all tiles advance chunk by chunk,
    in batches of at most _PLAIN_BATCH (tile, candidate, ray) elements, with
    a stable per-ray torch.sort in fired chunks (window order). Records in
    march_plain.candidates the (tile, candidate) slots of the chunks it did
    not skip, in march_plain.chunks those (tile, chunk) pairs, in
    march_plain.significant the (ray, candidate) pairs that passed the gate,
    in march_plain.fired the (tile, chunk) pairs whose window-sort fire
    test (window_fire) fired in some fire group, in window order (0 in the
    others), and in march_plain.slow those whose tile-wide fast test
    failed, in merge order (0 in the others). stats: as march."""
    _check_args(starts, feats, dirs_t, config, chunk, save_tin,
                dict(origins_t=origins_t, t_lo=t_lo, t_hi=t_hi, t0=t0, blocks=blocks,
                     block_sub=block_sub, quad=quad), stats)
    T, R, _ = dirs_t.shape
    dev = dirs_t.device
    dirs = dirs_t.to(_F32)
    dx, dy, dz = dirs.unbind(-1)
    origins = None if origins_t is None else list(origins_t.unbind(-1))
    rays = dict(
        d=[dx, dy, dz], o=origins, quad=origins is None or quad,
        obar=[origin_centroid(o) for o in origins] if quad else None,  # (T, 1) each
        basis=sh_basis_list(dx, dy, dz, config.sh_degree) if config.sh_degree > 0 else None,
        sh_col=T_SH0 if save_tin or quad else _SH0,  # the training rows' coefficients
        live=dx * dx + dy * dy + dz * dz > 0.01,  # |dir| > 0.1
        t_lo=config.t_min if t_lo is None else t_lo,
        t_hi=config.t_max if t_hi is None else t_hi,
        full_range=_full_range(origins_t, t_lo, t_hi, blocks),
    )
    trans = torch.ones((T, R), dtype=_F32, device=dev) if t0 is None else t0.clone()
    rgb = torch.zeros((T, R, 3), dtype=_F32, device=dev)
    n_chunks = (starts[1:] - starts[:-1] + chunk - 1).div(chunk, rounding_mode="floor")
    t_skip = _skip_threshold(config, save_tin)
    if save_tin:
        chunk_base = chunk_bases(starts, chunk)
        tin = torch.empty((int(chunk_base[-1]), R), dtype=_F32, device=dev)
    batch = max(1, _PLAIN_BATCH // (chunk * R))
    opts = window_options(config, R, chunk, save_tin)
    # fired and repaired chunks of each tile's fire groups (window order)
    groups = torch.zeros((T, R // opts["group"], 2), dtype=torch.int32, device=dev)
    pend = None
    if config.order == "merge":  # empty slots: INT32_MIN keys, alpha 0
        shape = (T, chunk, R)
        pend = [torch.full(shape, _IMIN, dtype=torch.int32, device=dev),
                torch.zeros(shape, dtype=_F32, device=dev),
                torch.zeros(shape, dtype=torch.int32, device=dev)]
    counts = (starts[1:] - starts[:-1]).long()
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    significant = torch.zeros((), dtype=torch.int64, device=dev)
    chunks = fired = slow = 0
    for j in range(int(n_chunks.max()) if T else 0):
        if save_tin:  # every chunk's carry-in, skipped chunks included
            has = (n_chunks > j).nonzero().squeeze(1)
            tin[chunk_base[has].long() + j] = trans[has]
        active = (n_chunks > j) & (trans.amax(dim=1) > t_skip)
        evaluated += torch.where(active, torch.clamp(counts - j * chunk, max=chunk), 0).sum()
        for tb in active.nonzero().squeeze(1).split(batch):
            sig, n_fired, n_slow = _chunk_plain(tb, j, starts, feats, rays, trans, rgb, config,
                                                chunk, blocks, block_sub, save_tin, pend, opts,
                                                groups)
            significant += sig
            chunks += tb.numel()
            fired += n_fired
            slow += n_slow
    if pend is not None:  # flush the pending buffers
        min_t = config.min_transmittance
        for tb in torch.arange(T, device=dev).split(batch):
            part, t_next = _composite(trans[tb][:, None], pend[1][tb],
                                      _unpack_colors(pend[2][tb]), min_t, opts["scan"])
            tc = trans[tb]
            trans[tb] = torch.where(tc > min_t, t_next, tc)
            rgb[tb] += part
    march_plain.candidates, march_plain.significant = int(evaluated), int(significant)
    march_plain.chunks, march_plain.fired, march_plain.slow = chunks, fired, slow
    if save_tin:
        return rgb, trans, tin, chunk_base
    if stats:
        return rgb, trans, tuple(groups.amax(dim=1).unbind(-1))
    return rgb, trans


march_plain.candidates = 0  # (tile, candidate) slots of the chunks the last call did not skip
march_plain.significant = 0  # (ray, candidate) pairs of the last call that passed the gate
march_plain.chunks = 0  # (tile, chunk) pairs the last call did not skip
march_plain.fired = 0  # of those, the chunks whose window-sort fire test fired (window order)
march_plain.slow = 0  # of those, the chunks whose tile-wide fast test failed (merge order)
