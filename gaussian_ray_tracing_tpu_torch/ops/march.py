"""Fused forward march over the sorted pair stream -- kernel K1.

Counterpart of `pallas_march_stream` / `_march_kernel` in
gaussian_ray_tracing_tpu/ops/pallas_march.py (forward only), for the mode
the primary render uses: window order on the exact event t, the quad
response with a shared ray origin, SH degree 0, full [t_min, t_max] rays.

Each tile (R = tile_w * tile_h rays) owns the contiguous pair segment
[starts[t], starts[t+1]) and marches it front to back in chunks of c
candidates, with these per-tile (not per-ray) decisions, as on the TPU:

  - chunk skip: the chunk is skipped once the max transmittance over ALL R
    rays of the tile is <= max(chunk_skip_transmittance, min_transmittance)
    (padded rays of a partial tile keep T = 1, so such tiles never skip);
  - window-sort fire: if ANY ray of the tile sees a significant (a > 0)
    candidate whose event t is below the running max of the significant
    ones before it, every ray of the tile composites that chunk in sorted
    order of the key tq16 << 15 | a15, where tq16 quantizes t over the
    tile-wide [min, max] of significant event t, a15 = a*32767, alpha is
    decoded from the key and colours ride as 3x10-bit packs over [0, 4);
    otherwise the chunk composites in stream order with exact values.

Compositing per chunk: p_excl = T * exp(exclusive prefix of log1p(-a)),
w = a * p_excl * (p_excl > minT); the next T is the max of the
{p_incl <= minT} set when it is non-empty (the first candidate to cross
the threshold freezes it), else the whole-chunk product; T only advances
while T > minT. All of it in float32: the response
dd = q . m2(d), od = v . d, pp = oo - od^2/dd cancels by orders of
magnitude and must not see TF32 or bf16 inputs.

`march_stream` takes per-pair rows in the JAX feature-table layout (the
very array `pallas_march_stream` takes); it gathers the 15 columns this
mode reads into compact 16-float rows (`compact_features`) and calls
`march`, the wrapper: CUDA tensors go to csrc/march.cu, CPU tensors to the
plain torch version `march_plain`, anything else raises. The TPU's packed16
int16 layout, 128-column padding, 8-row ray panels and bf16 hi/lo MXU
splits are TPU layout work and are not ported.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.config import RenderConfig

# JAX feature-table columns read by the quad/sh0 march: op 12, q 64..69,
# v 72..74, cq 75, oo 76, rgb 77..79
COMPACT_COLUMNS = (12, 64, 65, 66, 67, 68, 69, 72, 73, 74, 75, 76, 77, 78, 79)
ROW = 16  # compact row width in floats (15 used + 1 pad = 64 bytes)
_OP, _Q0, _V0, _CQ, _OO, _RGB0 = 0, 1, 7, 10, 11, 12
CHUNKS = (32, 64, 128, 256)
_ZBASE = 65535 << 15  # sort key of non-significant candidates (sorts last)
_F32 = torch.float32
_PLAIN_BATCH = 1 << 24  # (tile, candidate, ray) elements per plain-march batch


def chunk_for(config: RenderConfig) -> int:
    """March chunk of the primary render: max(32, min(march_chunk, 256))."""
    return max(32, min(config.march_chunk, 256))


def compact_features(feats: torch.Tensor) -> torch.Tensor:
    """(N, F >= 80) JAX-layout rows -> (N, 16) compact rows."""
    cols = torch.tensor(COMPACT_COLUMNS, device=feats.device)
    out = feats.new_zeros((feats.shape[0], ROW))
    out[:, : len(COMPACT_COLUMNS)] = feats.index_select(1, cols)
    return out


def march_stream(starts, pair_feats, dirs_t, config: RenderConfig, chunk: int):
    """March every tile over its pair segment (JAX feature layout).

    starts (T+1,) int32, pair_feats (P, F >= 80) float32, dirs_t (T, R, 3).
    Returns (rgb (T, R, 3), t_final (T, R)).
    """
    return march(starts, compact_features(pair_feats), dirs_t, config, chunk)


def _check_args(starts, feats, dirs_t, chunk):
    if chunk not in CHUNKS:
        raise NotImplementedError(f"march chunk {chunk} not in {CHUNKS}")
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise ValueError("starts must be (T+1,) int32")
    if feats.dtype != _F32 or feats.dim() != 2 or feats.shape[1] != ROW:
        raise ValueError(f"feats must be (P, {ROW}) float32 compact rows")
    if dirs_t.dtype != _F32 or dirs_t.dim() != 3 or dirs_t.shape[2] != 3:
        raise ValueError("dirs_t must be (T, R, 3) float32")
    if starts.shape[0] != dirs_t.shape[0] + 1:
        raise ValueError("starts must have one entry more than dirs_t has tiles")
    if len({starts.device, feats.device, dirs_t.device}) != 1:
        raise ValueError("starts, feats and dirs_t must share one device")


def march(starts, feats, dirs_t, config: RenderConfig, chunk: int):
    """Kernel K1 wrapper on compact rows (see module docstring).

    CUDA tensors launch csrc/march.cu; CPU tensors run march_plain.
    Returns (rgb (T, R, 3), t_final (T, R)).
    """
    _check_args(starts, feats, dirs_t, chunk)
    if dirs_t.device.type == "cpu":
        return march_plain(starts, feats, dirs_t, config, chunk)
    if dirs_t.device.type != "cuda":
        raise ValueError(f"no march for device {dirs_t.device}")
    return _march_cuda(starts.contiguous(), feats.contiguous(),
                       dirs_t.contiguous(), config, chunk)


def _skip_threshold(config: RenderConfig) -> float:
    return max(config.chunk_skip_transmittance, config.min_transmittance)


def _march_cuda(starts, feats, dirs_t, config: RenderConfig, chunk: int):
    from gaussian_ray_tracing_tpu_torch.ops.cuda_build import check, load_library

    lib = load_library()
    T, R, _ = dirs_t.shape
    if R % 32 or not 32 <= R <= 1024:
        raise ValueError(f"rays per tile {R} must be a multiple of 32 in [32, 1024]")
    rgb = torch.empty((T, R, 3), dtype=_F32, device=dirs_t.device)
    t_final = torch.empty((T, R), dtype=_F32, device=dirs_t.device)
    if T == 0:
        return rgb, t_final
    with torch.cuda.device(dirs_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grt_march(
            starts.data_ptr(), feats.data_ptr(), dirs_t.data_ptr(),
            rgb.data_ptr(), t_final.data_ptr(), T, R, chunk,
            config.t_min, config.t_max, config.min_transmittance,
            _skip_threshold(config), config.alpha_min, config.alpha_clamp,
            config.hit_multiplicity, stream,
        )
    check(err, "grt_march")
    march.launches += 1
    return rgb, t_final


march.launches = 0


# --- plain torch version ---------------------------------------------------

def _pack_colors(cols):
    """3 colour tensors in [0, 4) -> int32 3x10-bit packs (1/255.75 steps)."""
    q = lambda x: torch.clamp(x * 255.75, 0.0, 1023.0).to(torch.int32)
    return (q(cols[0]) << 20) | (q(cols[1]) << 10) | q(cols[2])


def _unpack_colors(cp):
    unq = lambda x: x.to(_F32) * (1.0 / 255.75)
    return [unq((cp >> 20) & 1023), unq((cp >> 10) & 1023), unq(cp & 1023)]


def _composite(t_carry, a, cols, min_t: float):
    """Front-to-back composite of ordered (B, c, R) alphas from carry-in
    t_carry (B, 1, R). Returns (rgb_part (B, R, 3), t_next (B, R))."""
    logp = torch.log1p(-a)
    s_incl = torch.cumsum(logp, dim=1)
    s_excl = torch.cat([torch.zeros_like(s_incl[:, :1]), s_incl[:, :-1]], dim=1)
    p_excl = t_carry * torch.exp(s_excl)
    p_incl = p_excl * (1.0 - a)
    w = a * p_excl * (p_excl > min_t)
    below = p_incl <= min_t
    frozen = torch.where(below, p_incl, float("-inf")).amax(dim=1)
    p_last = t_carry[:, 0] * torch.exp(logp.sum(dim=1))
    t_next = torch.where(below.any(dim=1), frozen, p_last)
    rgb_part = torch.stack([(w * col).sum(dim=1) for col in cols], dim=-1)
    return rgb_part, t_next


def _chunk_plain(tb, j, starts, feats, dirs, live, trans, rgb, config, c):
    """March chunk j of tiles `tb` (in place on trans/rgb)."""
    dev = feats.device
    base = starts[tb].long() + j * c
    idx = base[:, None] + torch.arange(c, device=dev)[None, :]  # (B, c)
    present = (idx < starts[tb + 1].long()[:, None])[..., None]  # (B, c, 1)
    f = feats[torch.clamp(idx, max=feats.shape[0] - 1)]  # (B, c, ROW)
    col = lambda k: f[:, :, k : k + 1]  # (B, c, 1)
    d = dirs[tb][:, None]  # (B, 1, R, 3)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]  # (B, 1, R)

    m2 = (dx * dx, dy * dy, dz * dz, 2.0 * dx * dy, 2.0 * dx * dz, 2.0 * dy * dz)
    q = [col(_Q0 + k) for k in range(6)]
    dd = q[0] * m2[0] + q[1] * m2[1] + q[2] * m2[2] + q[3] * m2[3] \
        + q[4] * m2[4] + q[5] * m2[5]  # (B, c, R)
    od = col(_V0) * dx + col(_V0 + 1) * dy + col(_V0 + 2) * dz
    cq, oo = col(_CQ), col(_OO)
    rcp6 = 1.0 / torch.clamp(dd, min=1e-6)
    t_star = -od * rcp6
    pp = oo + od * t_star  # oo - od^2/dd
    resp = torch.exp(-0.5 * torch.clamp(pp, min=0.0))
    alpha = torch.clamp(resp * col(_OP), max=config.alpha_clamp)
    disc = od * od - dd * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_dd = 1.0 / torch.clamp(dd, min=1e-12)
    t_entry = (-od - sq) * inv_dd
    t_exit = (-od + sq) * inv_dd
    t_ev = torch.where(t_entry < config.t_min, t_exit, t_entry)
    # disc >= 0 is implied by alpha > alpha_min (the adaptive radius is the
    # alpha_min iso-surface), so the gate drops it, as on the TPU
    gate = present & (t_ev >= config.t_min) & (t_ev <= config.t_max) \
        & live[tb][:, None] & (alpha > config.alpha_min)
    hm = config.hit_multiplicity
    a_eff = alpha if hm == 1 else 1.0 - (1.0 - alpha) ** hm
    a = torch.where(gate, a_eff, 0.0)

    # tile-wide window-sort fire test: a significant candidate below the
    # exclusive running max of the significant event t before it
    sig = a > 0.0
    run = torch.cummax(torch.where(sig, t_ev, float("-inf")), dim=1).values
    rmax = torch.cat([torch.full_like(run[:, :1], float("-inf")), run[:, :-1]], 1)
    fired = (sig & (t_ev < rmax)).flatten(1).any(dim=1)  # (B,)

    min_t = config.min_transmittance
    t_carry = trans[tb][:, None]  # (B, 1, R)
    cols = [col(_RGB0 + ch) for ch in range(3)]
    part = torch.empty((tb.shape[0],) + rgb.shape[1:], dtype=_F32, device=dev)
    t_next = torch.empty_like(trans[tb])

    nf = (~fired).nonzero().squeeze(1)
    if nf.numel():
        part[nf], t_next[nf] = _composite(t_carry[nf], a[nf],
                                          [x[nf] for x in cols], min_t)
    fb = fired.nonzero().squeeze(1)
    if fb.numel():
        a_f, t_f, sig_f = a[fb], t_ev[fb], sig[fb]
        inf = float("inf")
        t_lo = torch.where(sig_f, t_f, inf).amin(dim=(1, 2), keepdim=True)
        t_hi = torch.where(sig_f, t_f, -inf).amax(dim=(1, 2), keepdim=True)
        t_rng = torch.clamp(t_hi - t_lo, min=1e-20)
        # a true division: torch computes `65534.0 / t_rng` as
        # reciprocal(t_rng) * 65534, which rounds twice and moves the
        # quantization bucket edges away from the kernel's and the TPU's
        scale = torch.full_like(t_rng, 65534.0) / t_rng
        tq = torch.clamp((t_f - t_lo) * scale, 0.0, 65534.0).to(torch.int32)
        aq = torch.clamp(a_f * 32767.0, 0.0, 32767.0).to(torch.int32)
        key = torch.where(sig_f, (tq << 15) | aq, _ZBASE)
        key_s, perm = torch.sort(key, dim=1, stable=True)
        cp = _pack_colors([x[fb] for x in cols]).expand(-1, -1, key.shape[2])
        cp_s = torch.gather(cp, 1, perm)
        a_s = torch.where(key_s >= _ZBASE, 0.0,
                          (key_s & 32767).to(_F32) * (1.0 / 32767.0))
        part[fb], t_next[fb] = _composite(t_carry[fb], a_s, _unpack_colors(cp_s), min_t)

    tc = trans[tb]
    trans[tb] = torch.where(tc > min_t, t_next, tc)
    rgb[tb] += part


def march_plain(starts, feats, dirs_t, config: RenderConfig, chunk: int):
    """Plain torch march on any device: all tiles advance chunk by chunk,
    in batches of at most _PLAIN_BATCH (tile, candidate, ray) elements, with
    a stable per-ray torch.sort in fired chunks."""
    _check_args(starts, feats, dirs_t, chunk)
    T, R, _ = dirs_t.shape
    dev = dirs_t.device
    dirs = dirs_t.to(_F32)
    dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    live = dx * dx + dy * dy + dz * dz > 0.01  # |dir| > 0.1
    trans = torch.ones((T, R), dtype=_F32, device=dev)
    rgb = torch.zeros((T, R, 3), dtype=_F32, device=dev)
    n_chunks = (starts[1:] - starts[:-1] + chunk - 1).div(chunk, rounding_mode="floor")
    t_skip = _skip_threshold(config)
    batch = max(1, _PLAIN_BATCH // (chunk * R))
    for j in range(int(n_chunks.max()) if T else 0):
        active = (n_chunks > j) & (trans.amax(dim=1) > t_skip)
        for tb in active.nonzero().squeeze(1).split(batch):
            _chunk_plain(tb, j, starts, feats, dirs, live, trans, rgb, config, chunk)
    return rgb, trans
