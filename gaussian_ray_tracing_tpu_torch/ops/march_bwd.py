"""Hand-written backward of the training march -- kernel K3 -- and the
autograd Function that pairs it with the forward K1.

Counterpart of `_march_bwd_kernel` / `pallas_march_bwd` and of the
`march_stream_diff` custom_vjp in gaussian_ray_tracing_tpu/ops/pallas_march.py
(:1189-1709): key order and window order (oddeven replays as key order,
as JAX's backward does: its forward composites in stream order), a shared
ray origin (the camera
eye) or per-ray origins (rolling-shutter renders and bounced segments),
full [t_min, t_max] rays or per-ray windows [t_lo, t_hi], SH degree 0 to
3, any hit_multiplicity.

Each tile's chunks are replayed in REVERSE from the carry-in transmittance
the forward saved (ops/march.py, save_tin), carrying dT per ray from
d(t_final). Per chunk (pallas_march.py:1265-1535):

  1. skip replay: if the tile's max saved t_in is <= min_transmittance the
     chunk's gradient rows are zero and dT passes through unchanged;
  2. recompute, from the SCALAR columns of the training rows (mean, M =
     S^-1 R^T, opacity, iso radius, SH coefficients), the scalar-form
     response from the eye or each ray's origin and the exact gate disc >=
     0 & t_event in [t_lo, t_hi] & live & alpha > alpha_min, with the
     forward's per-ray windows. In key order the forward may have run the
     quad form (with the fast gate on full-range rays from the eye); this
     asymmetry is the reference's own (pallas_renderer.py:234-238,
     pallas_march.py:1647-1653) and is kept. Otherwise the forward ran
     this very scalar form;
  3. window order only (pallas_march.py:1343-1425): replay the forward's
     tile-wide fire test on the same order key (the event t, or t* under
     window_key "peak") and alphas; in a fired chunk
     order the candidates by the unique training key (tq16 << 8) | src
     (ops/march.train_sort_key), else keep stream order. The sweep below
     runs in that order with the 3x10-bit colours in d_w (straight-through,
     in unfired chunks too, as the reference does), and d_a and w go back
     to their source candidates through the inverse permutation;
  4. reverse sweep: P = t_in exp(exclusive prefix of log1p(-a)), gate_w =
     P > minT, d_a, d_P, the new dT = dT prod + sum(d_P E), d_lp = dT_old
     t_in prod + (strict suffix sum of d_P P), d_a -= d_lp / (1 - a). The
     exclusive prefix is summed sequentially per ray, in the forward's
     order; the strict suffix sum is taken as the last inclusive prefix
     minus the inclusive prefix (the same form in the kernel and here);
  5. per-candidate gradients summed over the tile's R rays: the colour
     (SH 0: sh0 = C0 sum(dR w) [colour > 0]; SH 1-3: sh_k = sum(dR w
     [colour > 0] basis_k), the mask from the exact colours), opacity, the
     9 M columns through the shared-origin d_og / d_dg algebra, and the
     means as -d_o. With per-ray origins o_g and oo are per (ray,
     candidate): d_og stays per ray and the nine d(M) terms and d(mean) =
     -d(o) are summed over the rays (pallas_march.py:1481-1501), d_oo is
     not reduced first. The radius column and every quad column get
     exactly zero.

Early termination is a non-differentiable cutoff, as in the reference.
Each row of the pair stream belongs to exactly one (tile, chunk), so rows
are written, not accumulated; rows outside [starts[0], starts[T]) are zero.

`march_bwd` is the wrapper: CUDA tensors launch csrc/march_bwd.cu, CPU
tensors run the plain torch version `march_bwd_plain`, anything else raises.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.config import (
    RenderConfig, sort_chunk_refusal, tile_rays_supported,
)
from gaussian_ray_tracing_tpu_torch.ops.march import (
    MAX_TRAIN_CHUNK, T_M0, T_MX, T_RAD, T_SH0, _OP, _pack_colors, _unpack_colors,
    march, march_plain, scratch_tiles, train_row, train_sort_key, window_fire,
)
from gaussian_ray_tracing_tpu_torch.ops.sh import SH_C0, num_coeffs, sh_basis_list

_F32 = torch.float32
_PLAIN_BATCH = 1 << 23  # (tile, candidate, ray) elements per plain batch


def _check_args(starts, rows, dirs_t, eye, tin, chunk_base, d_rgb, d_tfinal,
                config: RenderConfig, chunk: int, dtypes=(_F32,), seg=None):
    if config.order not in ("window", "key", "oddeven") or not 0 <= config.sh_degree <= 3:
        raise NotImplementedError("the backward is ported for window, key and oddeven order "
                                  "(key order's replay) at SH 0-3")
    for bad in sort_chunk_refusal("order", config.order, chunk, f"march chunk {chunk}"):
        raise NotImplementedError(bad)
    if not 1 <= chunk <= MAX_TRAIN_CHUNK:
        raise NotImplementedError(f"march chunk {chunk}: the backward replays chunks of 1 to "
                                  f"{MAX_TRAIN_CHUNK} (chunk_for's, the training forward's)")
    if starts.dtype != torch.int32 or chunk_base.dtype != torch.int32:
        raise ValueError("starts and chunk_base must be int32")
    width = train_row(config.sh_degree)
    if rows.dtype not in dtypes or rows.dim() != 2 or rows.shape[1] != width:
        raise ValueError(f"rows must be (P, {width}) training rows of {dtypes}")
    T, R, _ = dirs_t.shape
    if starts.shape != (T + 1,) or chunk_base.shape != (T + 1,):
        raise ValueError("starts and chunk_base must be (T+1,)")
    if tin.dim() != 2 or tin.shape[1] != R or eye.shape != (3,):
        raise ValueError("tin must be (sum of chunks, R) and eye (3,)")
    if d_rgb.shape != (T, R, 3) or d_tfinal.shape != (T, R):
        raise ValueError("d_rgb must be (T, R, 3) and d_tfinal (T, R)")
    seg = {k: v for k, v in (seg or {}).items() if v is not None}
    for name, x in seg.items():
        if tuple(x.shape) != ((T, R, 3) if name == "origins_t" else (T, R)):
            raise ValueError("origins_t must be (T, R, 3), t_lo and t_hi (T, R)")
    tensors = (starts, rows, dirs_t, eye, tin, chunk_base, d_rgb, d_tfinal, *seg.values())
    if len({t.device for t in tensors}) != 1:
        raise ValueError("march_bwd's tensors must share one device")
    if any(t.dtype != rows.dtype for t in (dirs_t, eye, tin, d_rgb, d_tfinal, *seg.values())):
        raise ValueError("dirs_t, eye, tin, d_rgb, d_tfinal, origins_t, t_lo and t_hi must "
                         "have the rows' dtype")


def march_bwd(starts, rows, dirs_t, eye, tin, chunk_base, d_rgb, d_tfinal,
              config: RenderConfig, chunk: int, *, origins_t=None, t_lo=None, t_hi=None):
    """Kernel K3 wrapper: d(rows) (P, train_row) of the training march.

    starts (T+1,) int32, rows (P, train_row) training rows, dirs_t (T, R, 3),
    eye (3,), tin / chunk_base as the forward saved them, d_rgb (T, R, 3),
    d_tfinal (T, R); optional per-ray origins_t (T, R, 3) (the eye is then
    unused) and windows t_lo, t_hi (T, R), as the forward took them. CUDA
    tensors launch csrc/march_bwd.cu; CPU tensors run march_bwd_plain.
    """
    args = (starts, rows, dirs_t, eye, tin, chunk_base, d_rgb, d_tfinal)
    seg = dict(origins_t=origins_t, t_lo=t_lo, t_hi=t_hi)
    _check_args(*args, config, chunk, seg=seg)
    if dirs_t.device.type == "cpu":
        return march_bwd_plain(*args, config, chunk, **seg)
    if dirs_t.device.type != "cuda":
        raise ValueError(f"no march_bwd for device {dirs_t.device}")
    seg = {k: None if v is None else v.contiguous() for k, v in seg.items()}
    return _march_bwd_cuda(*(t.contiguous() for t in args), config, chunk, **seg)


def _march_bwd_cuda(starts, rows, dirs_t, eye, tin, chunk_base, d_rgb, d_tfinal,
                    config: RenderConfig, chunk: int, origins_t, t_lo, t_hi):
    from gaussian_ray_tracing_tpu_torch.ops.cuda_build import check, load_library

    lib = load_library()
    T, R, _ = dirs_t.shape
    if not tile_rays_supported(R):
        raise ValueError(f"rays per tile {R}: the kernel takes a multiple of 32 up to 1024 or "
                         f"of 128 above")
    d_rows = torch.zeros_like(rows)  # rows no tile owns, and skipped chunks, stay 0
    if T == 0:
        return d_rows
    ptr = lambda x: None if x is None else x.data_ptr()
    window, sh_k = int(config.order == "window"), num_coeffs(config.sh_degree)
    # the block sums and each ray's dT where a thread replays several rays,
    # for the tiles of one launch
    held = scratch_tiles(lib.grt_march_bwd_scratch_bytes(chunk, window, sh_k, R, 1), T)
    nbytes = lib.grt_march_bwd_scratch_bytes(chunk, window, sh_k, R, held)
    scratch = torch.empty(nbytes // 8, dtype=torch.float64, device=dirs_t.device) if nbytes \
        else None
    with torch.cuda.device(dirs_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grt_march_bwd(
            starts.data_ptr(), chunk_base.data_ptr(), rows.data_ptr(), dirs_t.data_ptr(),
            eye.data_ptr(), tin.data_ptr(), d_rgb.data_ptr(), d_tfinal.data_ptr(),
            d_rows.data_ptr(), ptr(origins_t), ptr(t_lo), ptr(t_hi), T, R, chunk, rows.shape[1],
            window, sh_k, config.t_min, config.t_max, config.min_transmittance,
            config.alpha_min, config.alpha_clamp, config.hit_multiplicity,
            int(config.window_key == "peak"), ptr(scratch), held, stream,
        )
    check(err, "grt_march_bwd")
    march_bwd.launches += 1
    attr = {(False, False): "key_launches", (True, False): "window_launches",
            (False, True): "sh_key_launches",
            (True, True): "sh_launches"}[config.order == "window", config.sh_degree > 0]
    setattr(march_bwd, attr, getattr(march_bwd, attr) + 1)
    if origins_t is not None:
        march_bwd.origin_launches += 1
    if config.order == "window" and config.window_key == "peak":
        march_bwd.peak_launches += 1
    if R > 1024:
        march_bwd.cluster_launches += 1
    if scratch is not None:
        march_bwd.slot_launches += 1
    return d_rows


march_bwd.launches = 0  # every K3 launch, and by mode:
march_bwd.key_launches = 0  # key order, SH 0
march_bwd.window_launches = 0  # window order (the sort replay), SH 0
march_bwd.sh_key_launches = 0  # key order, SH 1-3
march_bwd.sh_launches = 0  # window order, SH 1-3
march_bwd.origin_launches = 0  # per-ray origins, either order and any SH degree
march_bwd.peak_launches = 0  # window order replayed on the peak key (window_key "peak")
march_bwd.cluster_launches = 0  # the cluster builds (tiles of more than 1024 rays), any mode
march_bwd.slot_launches = 0  # of those, several rays a thread (tiles of more than 8192 rays)


# --- plain torch version ---------------------------------------------------

def _chunk_bwd_plain(tb, j, starts, rows, dirs, live, basis, eye, seg, tin, chunk_base, d_rgb,
                     dT, d_rows, config: RenderConfig, c: int):
    """Backward of chunk j of tiles `tb`: writes their rows of d_rows and
    advances dT (in place). Returns the number of (ray, candidate) pairs
    that pass the gate, whose colour and colour gradients are needed, and
    (window order) the number of these tiles whose chunk fired."""
    dev = rows.device
    K = num_coeffs(config.sh_degree)
    base = starts[tb].long() + j * c
    idx = base[:, None] + torch.arange(c, device=dev)[None, :]  # (B, c)
    present = idx < starts[tb + 1].long()[:, None]  # (B, c)
    f = rows[torch.clamp(idx, max=rows.shape[0] - 1)]  # (B, c, row)
    col = lambda k: f[:, :, k : k + 1]  # (B, c, 1)
    d = dirs[tb][:, None]  # (B, 1, R, 3)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]  # (B, 1, R)
    t_in = tin[chunk_base[tb].long() + j][:, None]  # (B, 1, R)
    dR = [d_rgb[tb][:, None, :, ch] for ch in range(3)]  # (B, 1, R)
    dT_c = dT[tb][:, None]  # (B, 1, R)

    # ---- forward recompute, scalar form (pallas_march.py:1291-1331) ----
    m = [col(T_M0 + k) for k in range(9)]
    op, rad = col(_OP), col(T_RAD)
    origins = seg["origins_t"]
    if origins is None:  # (B, c, 1): rays share the eye
        ox, oy, oz = eye[0] - col(T_MX), eye[1] - col(T_MX + 1), eye[2] - col(T_MX + 2)
    else:  # (B, c, R): per-ray origins
        o = origins[tb][:, None]  # (B, 1, R, 3)
        ox, oy, oz = o[..., 0] - col(T_MX), o[..., 1] - col(T_MX + 1), o[..., 2] - col(T_MX + 2)
    ogx = m[0] * ox + m[1] * oy + m[2] * oz  # (B, c, 1) or (B, c, R)
    ogy = m[3] * ox + m[4] * oy + m[5] * oz
    ogz = m[6] * ox + m[7] * oy + m[8] * oz
    dgx = m[0] * dx + m[1] * dy + m[2] * dz  # (B, c, R)
    dgy = m[3] * dx + m[4] * dy + m[5] * dz
    dgz = m[6] * dx + m[7] * dy + m[8] * dz
    dd = dgx * dgx + dgy * dgy + dgz * dgz
    od = ogx * dgx + ogy * dgy + ogz * dgz
    oo = ogx * ogx + ogy * ogy + ogz * ogz  # (B, c, 1) or (B, c, R)
    dd_s = torch.clamp(dd, min=1e-6)
    t_star = -od / dd_s
    pp = oo + t_star * (2.0 * od + t_star * dd)
    resp = torch.exp(-0.5 * torch.clamp(pp, min=0.0))
    alpha = torch.clamp(resp * op, max=config.alpha_clamp)
    cq = oo - rad * rad
    disc = od * od - dd * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_dd = 1.0 / torch.clamp(dd, min=1e-12)
    t_entry = (-od - sq) * inv_dd
    t_exit = (-od + sq) * inv_dd
    t_lo = config.t_min if seg["t_lo"] is None else seg["t_lo"][tb][:, None]
    t_hi = config.t_max if seg["t_hi"] is None else seg["t_hi"][tb][:, None]
    t_event = torch.where(t_entry < t_lo, t_exit, t_entry)
    in_window = (t_event >= t_lo) & (t_event <= t_hi)
    gate = present[..., None] & (disc >= 0.0) & in_window & live[tb][:, None] \
        & (alpha > config.alpha_min)
    hm = config.hit_multiplicity
    a_eff = alpha if hm == 1 else 1.0 - (1.0 - alpha) ** hm
    a = torch.where(gate, a_eff, 0.0)
    # unclamped colours: (B, c, 1) at SH 0, (B, c, R) above
    sub_basis = [b[tb][:, None] for b in basis]  # (B, 1, R) each
    colors = []
    for ch in range(3):
        raw = 0.5 + (SH_C0 if K == 1 else sub_basis[0]) * col(T_SH0 + ch * K)
        for k in range(1, K):
            raw = raw + sub_basis[k] * col(T_SH0 + ch * K + k)
        colors.append(raw)
    clamped = [torch.clamp(x, min=0.0) for x in colors]

    # ---- the sweep's order: stream order, or the replayed training sort ----
    if config.order == "window":
        # the forward's order key: t* under window_key "peak" (K3's own gate
        # stays the event gate, pallas_march.py:1343-1360)
        t_key = t_star if config.window_key == "peak" else t_event
        a_full = a.expand(-1, -1, dx.shape[2])
        src = torch.arange(c, dtype=torch.int32, device=dev)[None, :, None]
        fire = window_fire(a_full, t_key)
        fired = int(fire.sum())
        _, perm = torch.sort(torch.where(fire[:, None, None], train_sort_key(a_full, t_key),
                                         src), dim=1)
        a_s = torch.gather(a_full, 1, perm)
        cp = _pack_colors(clamped).expand(-1, -1, dx.shape[2])
        cols_s = _unpack_colors(torch.gather(cp, 1, perm))  # straight-through 10-bit
    else:
        a_s, cols_s, fired = a, clamped, 0

    # ---- reverse sweep (pallas_march.py:1397-1446) ----
    min_t = config.min_transmittance
    lp = torch.log1p(-a_s)
    s_incl = torch.cumsum(lp, dim=1)
    S = torch.cat([torch.zeros_like(s_incl[:, :1]), s_incl[:, :-1]], dim=1)
    E = torch.exp(S)
    P = t_in * E
    gate_w = (P > min_t).to(f.dtype)
    w = a_s * P * gate_w
    d_w = dR[0] * cols_s[0] + dR[1] * cols_s[1] + dR[2] * cols_s[2]
    d_a = d_w * P * gate_w
    d_P = d_w * a_s * gate_w
    prod = torch.exp(s_incl[:, -1:])  # (B, 1, R)
    dT[tb] = (dT_c * prod + torch.sum(d_P * E, dim=1, keepdim=True))[:, 0]
    dpp_incl = torch.cumsum(d_P * P, dim=1)
    d_lp = dT_c * t_in * prod + (dpp_incl[:, -1:] - dpp_incl)  # strict suffix sum
    d_a = d_a - d_lp / (1.0 - a_s)
    if config.order == "window":  # the inverse permutation
        d_a = torch.empty_like(d_a).scatter_(1, perm, d_a)
        w = torch.empty_like(w).scatter_(1, perm, w)

    # ---- per-candidate gradients (pallas_march.py:1448-1525) ----
    red = lambda x: torch.sum(x, dim=2, keepdim=True)  # over the tile's rays
    g = torch.zeros_like(f)  # (B, c, row)
    for ch in range(3):
        dcm = dR[ch] * w * (colors[ch] > 0.0).to(f.dtype)
        if K == 1:
            g[:, :, T_SH0 + ch : T_SH0 + ch + 1] = SH_C0 * red(dcm)
        else:
            for k in range(K):
                g[:, :, T_SH0 + ch * K + k : T_SH0 + ch * K + k + 1] = red(dcm * sub_basis[k])
    d_alpha = d_a if hm == 1 else d_a * hm * (1.0 - alpha) ** (hm - 1)
    d_alpha = torch.where(gate, d_alpha, 0.0)
    notclamp = (resp * op < config.alpha_clamp).to(f.dtype)
    d_resp = d_alpha * op * notclamp
    g[:, :, _OP : _OP + 1] = red(d_alpha * resp * notclamp)
    d_pp = -0.5 * resp * d_resp * (pp > 0.0).to(f.dtype)
    # pp = oo - od^2/dd (dd > eps branch)
    d_od = d_pp * (-2.0 * od / dd_s)
    d_dd = d_pp * (od * od / (dd_s * dd_s))
    d_dgx = d_od * ogx + 2.0 * dgx * d_dd
    d_dgy = d_od * ogy + 2.0 * dgy * d_dd
    d_dgz = d_od * ogz + 2.0 * dgz * d_dd
    if origins is None:  # d_oo and d_og per candidate, then the M algebra
        d_oo = red(d_pp)  # (B, c, 1)
        d_ogx = red(d_od * dgx) + 2.0 * ogx * d_oo
        d_ogy = red(d_od * dgy) + 2.0 * ogy * d_oo
        d_ogz = red(d_od * dgz) + 2.0 * ogz * d_oo
        d_m = [
            red(d_dgx * dx) + d_ogx * ox, red(d_dgx * dy) + d_ogx * oy,
            red(d_dgx * dz) + d_ogx * oz, red(d_dgy * dx) + d_ogy * ox,
            red(d_dgy * dy) + d_ogy * oy, red(d_dgy * dz) + d_ogy * oz,
            red(d_dgz * dx) + d_ogz * ox, red(d_dgz * dy) + d_ogz * oy,
            red(d_dgz * dz) + d_ogz * oz,
        ]
        d_o = [m[k] * d_ogx + m[k + 3] * d_ogy + m[k + 6] * d_ogz for k in range(3)]
    else:  # o_g and oo are (B, c, R): d_og stays per ray, the sums come last
        d_ogx = d_od * dgx + 2.0 * ogx * d_pp
        d_ogy = d_od * dgy + 2.0 * ogy * d_pp
        d_ogz = d_od * dgz + 2.0 * ogz * d_pp
        d_m = [
            red(d_dgx * dx + d_ogx * ox), red(d_dgx * dy + d_ogx * oy),
            red(d_dgx * dz + d_ogx * oz), red(d_dgy * dx + d_ogy * ox),
            red(d_dgy * dy + d_ogy * oy), red(d_dgy * dz + d_ogy * oz),
            red(d_dgz * dx + d_ogz * ox), red(d_dgz * dy + d_ogz * oy),
            red(d_dgz * dz + d_ogz * oz),
        ]
        d_o = [red(m[k] * d_ogx + m[k + 3] * d_ogy + m[k + 6] * d_ogz) for k in range(3)]
    for k in range(9):
        g[:, :, T_M0 + k : T_M0 + k + 1] = d_m[k]
    for k in range(3):  # means: o - mu
        g[:, :, T_MX + k : T_MX + k + 1] = -d_o[k]
    # rad only gates hits (discontinuous): zero gradient, as in 3DGRT
    d_rows[idx[present]] = g[present]
    return (a > 0.0).sum(), fired


def march_bwd_plain(starts, rows, dirs_t, eye, tin, chunk_base, d_rgb, d_tfinal,
                    config: RenderConfig, chunk: int, *, origins_t=None, t_lo=None, t_hi=None):
    """Plain torch backward on any device, batched over tiles like
    march_plain; chunks run last to first. Float32, as the kernel; float64
    inputs give a witness of the float32 rounding (the reference's
    response algebra cancels: see PERF.md, K3 per column). Records in
    march_bwd_plain.candidates the (tile, candidate) slots of the chunks it
    replayed, in march_bwd_plain.chunks those (tile, chunk) pairs, in
    march_bwd_plain.significant the (ray, candidate) pairs that passed the
    gate and in march_bwd_plain.fired the replayed chunks that fired
    (window order; 0 in key order)."""
    seg = dict(origins_t=origins_t, t_lo=t_lo, t_hi=t_hi)
    _check_args(starts, rows, dirs_t, eye, tin, chunk_base, d_rgb, d_tfinal,
                config, chunk, (_F32, torch.float64), seg)
    T, R, _ = dirs_t.shape
    dev = dirs_t.device
    dx, dy, dz = dirs_t[..., 0], dirs_t[..., 1], dirs_t[..., 2]
    live = dx * dx + dy * dy + dz * dz > 0.01
    basis = sh_basis_list(dx, dy, dz, config.sh_degree) if config.sh_degree > 0 else []
    dT = d_tfinal.clone()
    d_rows = torch.zeros_like(rows)
    n_chunks = (starts[1:] - starts[:-1] + chunk - 1).div(chunk, rounding_mode="floor")
    batch = max(1, _PLAIN_BATCH // (chunk * R))
    min_t = config.min_transmittance
    counts = (starts[1:] - starts[:-1]).long()
    replayed = significant = chunks = fired = 0
    for j in reversed(range(int(n_chunks.max()) if T else 0)):
        has = (n_chunks > j).nonzero().squeeze(1)
        t_max = tin[chunk_base[has].long() + j].amax(dim=1)
        live_tiles = has[t_max > min_t]
        replayed += torch.clamp(counts[live_tiles] - j * chunk, max=chunk).sum()
        for tb in live_tiles.split(batch):
            sig, n_fired = _chunk_bwd_plain(tb, j, starts, rows, dirs_t, live, basis, eye, seg,
                                            tin, chunk_base, d_rgb, dT, d_rows, config, chunk)
            significant += sig
            chunks += tb.numel()
            fired += n_fired
    march_bwd_plain.candidates, march_bwd_plain.significant = int(replayed), int(significant)
    march_bwd_plain.chunks, march_bwd_plain.fired = chunks, fired
    return d_rows


march_bwd_plain.candidates = 0  # (tile, candidate) slots the last call replayed
march_bwd_plain.significant = 0  # (ray, candidate) pairs of the last call that passed the gate
march_bwd_plain.chunks = 0  # (tile, chunk) pairs the last call replayed
march_bwd_plain.fired = 0  # of those, the chunks that fired (window order)


# --- autograd ----------------------------------------------------------------

class MarchStreamDiff(torch.autograd.Function):
    """Differentiable training march: the forward is K1 with saved carries
    (march_plain for use_kernels=False), the backward is K3
    (march_bwd_plain). quad (key order only): the forward runs the quad
    response, from the shared eye or, with origins_t, the per-ray-origin
    expansion; otherwise the scalar response from origins_t, or from the
    eye as per-ray origins. Either way the backward recomputes the scalar
    form, as the reference's does (pallas_march.py:1647-1653). Gradients
    flow to the training rows only; starts, directions, the eye, origins,
    windows and the carry-in get none, as in the reference
    (pallas_march.py:1703-1706)."""

    @staticmethod
    def forward(ctx, rows, starts, dirs_t, eye, config: RenderConfig, chunk: int,
                use_kernels: bool, quad: bool, origins_t, t_lo, t_hi, t0):
        if config.order == "merge":
            raise ValueError("order='merge' is a forward-render ordering; train with window or "
                             "key order (pallas_march.py:1659-1663)")
        if quad and config.order != "key":
            raise ValueError("quad training requires order='key' (pallas_march.py:1664-1665)")
        fwd = march if use_kernels else march_plain
        fwd_origins = origins_t
        if origins_t is None and not quad:  # the scalar response from the eye
            fwd_origins = eye.expand(dirs_t.shape).contiguous()
        rgb, t_final, tin, chunk_base = fwd(
            starts, rows, dirs_t, config, chunk, save_tin=True, origins_t=fwd_origins,
            t_lo=t_lo, t_hi=t_hi, t0=t0, quad=quad and origins_t is not None)
        ctx.save_for_backward(rows, starts, dirs_t, eye, tin, chunk_base, origins_t, t_lo, t_hi)
        ctx.config, ctx.chunk, ctx.use_kernels = config, chunk, use_kernels
        return rgb, t_final

    @staticmethod
    def backward(ctx, d_rgb, d_tfinal):
        rows, starts, dirs_t, eye, tin, chunk_base, origins_t, t_lo, t_hi = ctx.saved_tensors
        bwd = march_bwd if ctx.use_kernels else march_bwd_plain
        d_rows = bwd(starts, rows, dirs_t, eye, tin, chunk_base, d_rgb.contiguous(),
                     d_tfinal.contiguous(), ctx.config, ctx.chunk, origins_t=origins_t,
                     t_lo=t_lo, t_hi=t_hi)
        return (d_rows,) + (None,) * 11


def march_stream_diff(rows, starts, dirs_t, eye, config: RenderConfig, chunk: int,
                      use_kernels: bool = True, *, quad: bool | None = None, origins_t=None,
                      t_lo=None, t_hi=None, t0=None):
    """(rgb (T, R, 3), t_final (T, R)) of the training march (window, key
    or oddeven order), differentiable with respect to the (P, train_row)
    training rows; the counterpart of JAX's march_stream_diff
    (pallas_march.py:1632-1709). quad None takes the render's choice, quad
    in key order and scalar in the others (pallas_renderer.py:224-238);
    oddeven composites in stream order with the exact event gate and
    replays as key order, and quad=True needs key order, as in JAX
    (pallas_march.py:1664-1665); origins_t (T, R,
    3), t_lo, t_hi and t0 (T, R) are per-ray origins, windows and carry-in
    (each None: the eye, [t_min, t_max] and 1)."""
    if quad is None:
        quad = config.order == "key"
    return MarchStreamDiff.apply(rows, starts, dirs_t, eye, config, chunk, use_kernels, quad,
                                 origins_t, t_lo, t_hi, t0)
