"""Tiled march, per-gaussian feature table and tile layout helpers
(counterpart of gaussian_ray_tracing_tpu/models/tiled.py).

Per frame: the feature table -> conservative footprints and the
central-ray depth key -> fixed-capacity per-tile candidate lists
(ops/tiles.bin_tiles, whose scan is kernel K2 on CUDA) -> a chunked march
over each tile's candidates with a running-transmittance carry
(`march_tile_chunk`), in plain torch ops on any device. It is the
package's autodiff reference: `render_tiled` is differentiable by torch
autograd (each march step is recomputed in the backward pass,
torch.utils.checkpoint), independent of the hand-written kernels K1 and
K3, and runs in float64 with `compute_dtype="float64"`.

The march is the JAX tiled march's: window order re-sorts each chunk per
ray by exact event t (stable), oddeven by `window_passes` odd-even
transposition passes (`oddeven_perm`), every other order composites in
stream order (key); the frozen-transmittance early stop, hit multiplicity, the
[t_min, t_max] event gate and an optional view-depth gate (`depth_gate`).

Rounding. The float32 response pp = |o_g|^2 + t* (2 od + t* dd) cancels
from |o_g|^2 ~ 1e3..1e4, so one ulp there moves alpha by up to ~3e-4
relative. By default the march rounds each operation as the port's
kernels K1 and K3 and their plain versions do (the kernels build with
-fmad=false), which is what lets it hold them at the JAX suite's
kernel-vs-tiled bars. `xla_rounding=True` contracts the response's sums
into FMAs as XLA's CPU backend does for the JAX package, which holds the
march against the JAX tiled march on identical inputs.
Three things differ from the JAX layout and none changes a value: the
march loops where JAX scans and maps; it gathers a tile chunk's rows
when it marches the chunk (not the whole frame's up front); and a tile
chunk marches only up to its fullest tile's last candidate (the empty
chunks after it change neither colour nor transmittance).
Under `window_key="peak"` window order sorts by t* in place of the event
t, with the event gate, as the JAX tiled march does (its tiled.py:199).
Under a per-pair key (config.pair_keys) the candidate lists hold gaussian
ids (the binning's order is None) and the table stays in gaussian order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import RenderConfig, check_tiled_supported
from gaussian_ray_tracing_tpu_torch.ops.response import (
    adaptive_radius,
    canonical_frames,
    dot3,
    mat3_apply,
)
from gaussian_ray_tracing_tpu_torch.ops.sh import SH_C0, num_coeffs, sh_basis
from gaussian_ray_tracing_tpu_torch.ops.tiles import TileBinning, bin_tiles, project_footprints_conic
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

# tiles marched together: JAX's default on the CPU; on CUDA 256 tiles make
# each (tiles, rays, march_chunk) work array 32 MiB at c=128 and keep a
# 1280x720 frame to ~15 chunks (the Python loop's launches dominate)
TILE_CHUNK_CPU = 16
TILE_CHUNK_CUDA = 256

# fixed column indices of the quadratic-form block (see feature_table)
QUAD_Q0 = 64  # q00,q11,q22,q01,q02,q12 at 64..69 (+2 pad)
QUAD_V0 = 72  # vx,vy,vz at 72..74
QUAD_CQ = 75
QUAD_OO = 76
QUAD_RGB = 77  # cr,cg,cb at 77..79 (sh_degree 0)


def tile_rays(dirs: torch.Tensor, tile_w: int, tile_h: int) -> torch.Tensor:
    """(H, W, C) -> (T, tile_h*tile_w, C), zero-padding H/W up to tile
    multiples (padded rays have zero direction and are never live)."""
    H, W = dirs.shape[:2]
    Hp, Wp = -(-H // tile_h) * tile_h, -(-W // tile_w) * tile_w
    if (Hp, Wp) != (H, W):
        dirs = F.pad(dirs, (0, 0, 0, Wp - W, 0, Hp - H))
    ty, tx = Hp // tile_h, Wp // tile_w
    x = dirs.reshape(ty, tile_h, tx, tile_w, -1).permute(0, 2, 1, 3, 4)
    return x.reshape(ty * tx, tile_h * tile_w, -1).contiguous()


def untile_image(tiles: torch.Tensor, height: int, width: int, tile_w: int,
                 tile_h: int) -> torch.Tensor:
    """(T, tile_h*tile_w, C) -> (H, W, C), cropping tile padding."""
    ty, tx = -(-height // tile_h), -(-width // tile_w)
    c = tiles.shape[-1]
    x = tiles.reshape(ty, tx, tile_h, tile_w, c).permute(0, 2, 1, 3, 4)
    return x.reshape(ty * tile_h, tx * tile_w, c)[:height, :width]


def feature_table(scene: GaussianScene, config: RenderConfig, eye=None):
    """Per-gaussian feature table (N, 14+3K), or (N, 80) with `eye`.

    Columns: [mx, my, mz, m00..m22 (rows of M = S^-1 R^T), opacity, iso
    radius, sh_r[0..K-1], sh_g[...], sh_b[...]]. With `eye` (the shared
    primary-ray origin) the quadratic-form block follows at the JAX
    package's fixed indices, with Q = M^T M and rel = eye - mu:

      64..69: q00, q11, q22, q01, q02, q12
      72..74: v = Q rel
      75:     cq = rel^T Q rel - radius^2
      76:     oo = rel^T Q rel
      77..79: max(0.5 + C0*sh0, 0) per channel (sh_degree 0 only)

    Returns (table, M (N, 3, 3), radius (N,)).
    """
    M = canonical_frames(scene.scales, scene.quats)
    radius = adaptive_radius(scene.opacities, config.alpha_min)
    k = num_coeffs(config.sh_degree)
    cols = [
        scene.means,
        M.reshape(-1, 9),
        scene.opacities[:, None],
        radius[:, None],
        scene.sh[:, :k, 0],
        scene.sh[:, :k, 1],
        scene.sh[:, :k, 2],
    ]
    table = torch.cat(cols, dim=1)
    if eye is None:
        return table, M, radius
    n, nf = table.shape
    if nf > QUAD_Q0:
        raise ValueError(f"feature table width {nf} collides with quad columns at {QUAD_Q0}")
    # Q[i, j] = sum_k M[k, i] M[k, j], v = Q rel
    Q = dot3([M[:, k, :, None] for k in range(3)], [M[:, k, None, :] for k in range(3)])
    rel = eye.to(torch.float32)[None, :] - scene.means
    v = mat3_apply(Q, rel)
    oo = torch.sum(rel * v, dim=-1)
    cq = oo - radius * radius
    z = torch.zeros((n, 1), dtype=torch.float32, device=table.device)
    quad = [
        Q[:, 0, 0, None], Q[:, 1, 1, None], Q[:, 2, 2, None],
        Q[:, 0, 1, None], Q[:, 0, 2, None], Q[:, 1, 2, None],
        z, z,  # 70, 71
        v,  # 72..74
        cq[:, None], oo[:, None],  # 75, 76
    ]
    if config.sh_degree == 0:
        quad.append(torch.clamp(0.5 + SH_C0 * scene.sh[:, 0, :], min=0.0))
    pad = torch.zeros((n, QUAD_Q0 - nf), dtype=torch.float32, device=table.device)
    return torch.cat([table, pad, *quad], dim=1), M, radius


def default_pair_capacity(n: int) -> int:
    return max(8 * n, 1 << 16)


def default_tile_chunk(device, rays: int = 256) -> int:
    """Tiles marched together on `device`; on CUDA, tiles of more than 1024
    rays in fewer, so that a work array stays the size 1024-ray tiles give."""
    if torch.device(device).type != "cuda":
        return TILE_CHUNK_CPU
    return TILE_CHUNK_CUDA if rays <= 1024 else max(1, TILE_CHUNK_CUDA * 1024 // rays)


def compute_dtype(config: RenderConfig) -> torch.dtype:
    return getattr(torch, config.compute_dtype)


def depth_key(scene: GaussianScene, M, radius, eye, config: RenderConfig) -> torch.Tensor:
    """Front-to-back key: the event t (entry, or exit from inside) along the
    central ray from `eye` through each gaussian, else its distance.
    Rounded as XLA's CPU backend evaluates the JAX package's key (its sums
    of three contract as ops/response.dot3, c = fma(-r, r, |o_g|^2), disc
    = fma(b, b, -a c)), so that near-equal keys sort alike in both."""
    rel = scene.means - eye
    cols = lambda v: [v[..., k] for k in range(3)]
    rho = torch.clamp(torch.sqrt(dot3(cols(rel), cols(rel))), min=1e-9)
    o_g = mat3_apply(M, eye - scene.means)
    d_g = mat3_apply(M, rel / rho[:, None])
    a = torch.clamp(dot3(cols(d_g), cols(d_g)), min=1e-12)
    b = dot3(cols(o_g), cols(d_g))  # half-b
    c = torch.addcmul(dot3(cols(o_g), cols(o_g)), -radius, radius)
    disc = torch.addcmul(-(a * c), b, b)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_in, t_out = (-b - sq) / a, (-b + sq) / a
    key = torch.where(t_in >= config.t_min, t_in, t_out)
    return torch.where((disc >= 0.0) & (radius > 0.0), key, rho)


def unpack_columns(g: torch.Tensor, n_coeffs: int) -> dict:
    """Split gathered feature rows (..., F) into per-feature (...,) views."""
    out = {"mx": g[..., 0], "my": g[..., 1], "mz": g[..., 2], "op": g[..., 12],
           "rad": g[..., 13]}
    for i in range(9):
        out[f"m{i}"] = g[..., 3 + i]
    for c, name in enumerate(("sh_r", "sh_g", "sh_b")):
        for k in range(n_coeffs):
            out[f"{name}_{k}"] = g[..., 14 + c * n_coeffs + k]
    return out


def _sum3(a, b, xla: bool) -> torch.Tensor:
    """a0 b0 + a1 b1 + a2 b2, rounded per operation left to right (as the
    port's kernels and their plain versions round) or, with `xla`, as
    XLA's CPU backend contracts the sum in the JAX tiled march:
    fma(a2, b2, fma(a0, b0, a1 b1))."""
    if xla:
        return torch.addcmul(torch.addcmul(a[1] * b[1], a[0], b[0]), a[2], b[2])
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def oddeven_perm(key: torch.Tensor, passes: int) -> torch.Tensor:
    """Permutation (int64) from `passes` odd-even transposition passes over
    the last axis, ascending (JAX models/tiled.py:63-83): pass p
    compare-exchanges (i, i + 1) for every i of parity p, i < m - 1, where
    key[i] > key[i + 1]. Exact when no element is displaced more than
    `passes` from its sorted place; equal keys never swap."""
    m = key.shape[-1]
    idx = torch.arange(m, device=key.device).expand(key.shape)
    pos = torch.arange(m, device=key.device)
    for p in range(passes):
        k_next, i_next = torch.roll(key, -1, -1), torch.roll(idx, -1, -1)
        swap_hi = (pos % 2 == p % 2) & (pos < m - 1) & (key > k_next)
        swap_lo = torch.roll(swap_hi, 1, -1)  # position 0 never: swap_hi[m - 1] is False
        key = torch.where(swap_hi, k_next, torch.where(swap_lo, torch.roll(key, 1, -1), key))
        idx = torch.where(swap_hi, i_next, torch.where(swap_lo, torch.roll(idx, 1, -1), idx))
    return idx


def _march_step(t_carry, racc, gacc, bacc, ids, gf: dict, rays: dict, eye, config: RenderConfig):
    """One march chunk of a tile chunk: (Tc, R) carries, ids (Tc, mc) and
    per-slot features (Tc, mc) -> the next carries. Gradients flow through
    alpha, the weights and the colours only; the event t, the hit test
    and the sort key are computed on detached values."""
    dt = t_carry.dtype
    zero, eps, clamp = rays["consts"]
    present = ids >= 0
    m = [gf[f"m{k}"].to(dt) for k in range(9)]  # rows of M = S^-1 R^T
    o = [eye[k] - gf[c].to(dt) for k, c in enumerate(("mx", "my", "mz"))]
    op, rad = gf["op"].to(dt), gf["rad"].to(dt)

    # canonical-space origin o_g = M (eye - mu) (Tc, mc), shared by the
    # tile's rays; d_g = M d per (ray, candidate) (Tc, R, mc)
    xla = rays["xla"]
    og = [_sum3(m[3 * i:3 * i + 3], o, xla) for i in range(3)]
    ex_m = lambda a: a[:, None, :]
    dg = [_sum3([ex_m(x) for x in m[3 * i:3 * i + 3]], rays["d"], xla) for i in range(3)]
    dd = _sum3(dg, dg, xla)
    od = _sum3([ex_m(x) for x in og], dg, xla)
    oo = ex_m(_sum3(og, og, xla))

    # torch.maximum and minimum split a tie's gradient, as jnp's do
    t_star = -od / torch.maximum(dd, eps)
    # |o_g + t* d_g|^2
    pp = torch.addcmul(oo, t_star, 2.0 * od + t_star * dd) if xla \
        else oo + t_star * (2.0 * od + t_star * dd)
    resp = torch.exp(-0.5 * torch.maximum(pp, zero))
    alpha = torch.minimum(clamp, resp * ex_m(op))

    # iso-ellipsoid event time within [t_min, t_max] (the oracle's hit rule)
    odd, ddd = od.detach(), dd.detach()
    cq = oo.detach() - ex_m(rad * rad).detach()
    disc = odd * odd - ddd * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_dd = 1.0 / torch.clamp(ddd, min=1e-12)
    t_entry = (-odd - sq) * inv_dd
    t_exit = (-odd + sq) * inv_dd
    t_event = torch.where(t_entry < config.t_min, t_exit, t_entry)
    valid = ex_m(present) & (disc >= 0.0) & (t_event >= config.t_min) \
        & (t_event <= config.t_max) & rays["live"][..., None]
    if rays["gate"] is not None:
        # slab ownership by the event's view depth z = t_event (w_hat . d)
        wdot, lo, hi = rays["gate"]
        z = t_event * wdot[..., None]
        valid = valid & (z >= lo) & (z < hi)

    gate = valid & (alpha > config.alpha_min)
    hm = config.hit_multiplicity
    a_eff = alpha if hm == 1 else 1.0 - (1.0 - alpha) ** hm
    a = torch.where(gate, a_eff, zero)

    t0 = t_carry[..., None]
    min_t = config.min_transmittance
    if config.order in ("window", "oddeven"):
        # per-ray stable sort of the chunk by exact event t (oddeven:
        # window_passes odd-even transposition passes); weights are
        # computed in sorted order and scattered back to candidate order
        order_t = t_star.detach() if config.window_key == "peak" else t_event
        sort_key = torch.where(valid, order_t, math.inf)
        perm = oddeven_perm(sort_key, config.window_passes) if config.order == "oddeven" \
            else torch.argsort(sort_key, dim=-1, stable=True)
        a_s = torch.gather(a, -1, perm)
        p_incl = torch.cumprod(1.0 - a_s, dim=-1) * t0
        p_excl = torch.cat([t0, p_incl[..., :-1]], dim=-1)
        w_s = a_s * p_excl * (p_excl > min_t)
        inv = torch.empty_like(perm).scatter_(-1, perm, torch.arange(
            perm.shape[-1], device=perm.device).expand_as(perm))
        w = torch.gather(w_s, -1, inv)
    else:
        p_incl = torch.cumprod(1.0 - a, dim=-1) * t0
        p_excl = torch.cat([t0, p_incl[..., :-1]], dim=-1)
        w = a * p_excl * (p_excl > min_t)

    # sequential early termination: T freezes at the first value <= min_T
    below = p_incl <= min_t
    frozen = torch.amax(torch.where(below, p_incl, -math.inf), dim=-1)
    t_next = torch.where(below.any(dim=-1), frozen, p_incl[..., -1])
    t_next = torch.where(t_carry > min_t, t_next, t_carry)

    accs = []
    basis = rays["basis"]
    for ch, acc in (("sh_r", racc), ("sh_g", gacc), ("sh_b", bacc)):
        if basis is None:
            col = ex_m(torch.maximum(0.5 + SH_C0 * gf[f"{ch}_0"].to(dt), zero))
        else:  # (Tc, R, K) x (Tc, K, mc): the colour per (ray, candidate)
            shc = torch.stack([gf[f"{ch}_{k}"].to(dt) for k in range(basis.shape[-1])], 1)
            col = torch.maximum(0.5 + torch.bmm(basis, shc), zero)
        accs.append(acc + torch.sum(w * col, dim=-1))
    return (t_next, *accs)


def march_tile_chunk(cand: torch.Tensor, dirs: torch.Tensor, eye: torch.Tensor, gfeats: dict,
                     config: RenderConfig, depth_gate=None, xla_rounding: bool = False):
    """March a chunk of tiles through their candidate lists.

    cand (Tc, M) int32 (-1 = empty), dirs (Tc, R, 3), eye (3,) the shared
    ray origin, gfeats per-slot (Tc, M) features (unpack_columns).
    depth_gate, optional (w_hat (3,), lo, hi): keep only the hits whose
    event view depth t_event * (w_hat . d) lies in [lo, hi) (the depth-slab
    decomposition of the sharded renderers). xla_rounding: round the
    response's sums as the JAX package does on the CPU (see module
    docstring). Returns rgb (Tc, R, 3) and alpha (Tc, R) in
    config.compute_dtype. With autograd on, each march step is recomputed
    in the backward pass instead of saved.
    """
    Tc, m_cap = cand.shape
    mc = min(config.march_chunk, m_cap)
    n_steps = -(-m_cap // mc)
    dt = compute_dtype(config)
    d = [dirs[..., k].to(dt) for k in range(3)]  # (Tc, R)
    const = lambda v: torch.tensor(v, dtype=dt, device=dirs.device)
    rays = {"d": [x[..., None] for x in d], "basis": None, "gate": None,
            "xla": xla_rounding,
            "live": _sum3(d, d, xla_rounding) > 0.01,  # |dir| > 0.1 guard (tracer.cu:59)
            "consts": (const(0.0), const(1e-6), const(config.alpha_clamp))}
    if config.sh_degree > 0:
        rays["basis"] = sh_basis(*d, config.sh_degree)  # (Tc, R, K)
    if depth_gate is not None:
        w_hat, lo, hi = depth_gate
        w_hat = torch.as_tensor(w_hat, device=dirs.device).to(dt)
        rays["gate"] = (dot3(d, [w_hat[0], w_hat[1], w_hat[2]]), lo, hi)
    eye_c = eye.to(dt)

    pad = n_steps * mc - m_cap
    if pad:
        cand = F.pad(cand, (0, pad), value=-1)
        gfeats = {k: F.pad(v, (0, pad)) for k, v in gfeats.items()}
    R = dirs.shape[1]
    carry = (torch.ones((Tc, R), dtype=dt, device=dirs.device),
             *(torch.zeros((Tc, R), dtype=dt, device=dirs.device) for _ in range(3)))
    remat = torch.is_grad_enabled() and any(v.requires_grad for v in gfeats.values())
    for j in range(n_steps):
        sl = slice(j * mc, (j + 1) * mc)
        args = (*carry, cand[:, sl], {k: v[:, sl] for k, v in gfeats.items()}, rays, eye_c,
                config)
        carry = checkpoint(_march_step, *args, use_reentrant=False) if remat \
            else _march_step(*args)
    t_final, r, g, b = carry
    return torch.stack([r, g, b], dim=-1), 1.0 - t_final


def prepare_frame(scene: GaussianScene, camera: Camera, config: RenderConfig,
                  pair_capacity: int):
    """Frame setup of the tiled march: the feature table (differentiable),
    the tile binning (on detached values; its scan is kernel K2 on CUDA)
    and the per-tile ray directions. Returns (table, binning, dirs_t (T,
    R, 3), valid (H, W)); with a presorted binning the table's rows are in
    depth-rank order, as the candidate ids are (under a per-pair key both
    stay in gaussian order)."""
    table, M, radius = feature_table(scene, config)
    with torch.no_grad():
        bound_radius = radius * torch.amax(scene.scales, dim=-1)
        fp = project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                      bound_radius, camera, config)
        fp = fp._replace(depth=depth_key(scene, M, radius, camera.eye, config))
        binning: TileBinning = bin_tiles(fp, camera, config, pair_capacity,
                                         geom=(scene.means, M.reshape(-1, 9), radius))
    if binning.order is not None:
        table = table[binning.order]  # its backward routes rows back to the gaussians
    _, dirs, valid = generate_rays(camera, config)
    return table, binning, tile_rays(dirs, config.tile_w, config.tile_h), valid


def march_frame(cand: torch.Tensor, dirs_t: torch.Tensor, eye: torch.Tensor,
                table: torch.Tensor, config: RenderConfig, tile_chunk: int, depth_gate=None,
                xla_rounding: bool = False):
    """March every tile, `tile_chunk` tiles at a time: (T, M) candidates +
    (T, R, 3) directions -> rgb (T, R, 3), alpha (T, R). Each chunk gathers
    its candidates' feature rows (one gather, column-major so that every
    feature is a contiguous (tiles, slots) array) and marches up to its
    fullest tile's last candidate. `depth_gate` and `xla_rounding` as for
    march_tile_chunk."""
    T, m_cap = cand.shape
    mc = min(config.march_chunk, m_cap)
    counts = (cand >= 0).sum(dim=1).tolist()
    n_coeffs = num_coeffs(config.sh_degree)
    dt = compute_dtype(config)
    rgb, alpha = [], []
    for s in range(0, T, tile_chunk):
        tc = min(tile_chunk, T - s)
        m = min(m_cap, -(-max(counts[s:s + tc]) // mc) * mc)
        if m == 0:  # no candidate: T stays 1 and nothing is composited
            rgb.append(dirs_t.new_zeros((tc, dirs_t.shape[1], 3), dtype=dt))
            alpha.append(dirs_t.new_zeros((tc, dirs_t.shape[1]), dtype=dt))
            continue
        c = cand[s:s + tc, :m]
        g = table[torch.clamp(c, min=0).long()]  # (tc, m, F)
        g = g.movedim(-1, 0).contiguous().movedim(0, -1)
        out = march_tile_chunk(c, dirs_t[s:s + tc], eye, unpack_columns(g, n_coeffs), config,
                               depth_gate=depth_gate, xla_rounding=xla_rounding)
        rgb.append(out[0])
        alpha.append(out[1])
    return torch.cat(rgb), torch.cat(alpha)


def render_tiled(scene: GaussianScene, camera: Camera, config: RenderConfig = RenderConfig(),
                 tile_chunk: int | None = None, pair_capacity: int | None = None,
                 return_aux: bool = False, xla_rounding: bool = False) -> dict:
    """Full-frame tiled render on the scene's device, differentiable by
    autograd. Returns {rgb (H, W, 3) in [0, 1], alpha (H, W)} in float32
    and, with return_aux, {"aux": {n_pairs, n_dropped}} (pairs lost to the
    pair capacity or to config.max_per_tile; the frame is rendered
    without them, as in the JAX package). tile_chunk defaults to 16 on
    the CPU and 256 on CUDA; the frame does not depend on it.
    xla_rounding as for march_tile_chunk."""
    check_tiled_supported(config)
    if camera.device != scene.device:
        raise ValueError(f"camera on {camera.device} but scene on {scene.device}")
    if pair_capacity is None:
        pair_capacity = default_pair_capacity(scene.num_gaussians)
    if tile_chunk is None:
        tile_chunk = default_tile_chunk(scene.device, config.rays_per_tile)
    table, binning, dirs_t, valid = prepare_frame(scene, camera, config, pair_capacity)
    rgb_t, alpha_t = march_frame(binning.cand, dirs_t, camera.eye, table, config, tile_chunk,
                                 xla_rounding=xla_rounding)
    H, W, tw, th = camera.height, camera.width, config.tile_w, config.tile_h
    rgb = torch.clamp(untile_image(rgb_t.to(torch.float32), H, W, tw, th), 0.0, 1.0)
    alpha = untile_image(alpha_t.to(torch.float32)[..., None], H, W, tw, th)[..., 0]
    out = {"rgb": torch.where(valid[..., None], rgb, 0.0),
           "alpha": torch.where(valid, alpha, 0.0)}
    if return_aux:
        out["aux"] = {"n_pairs": int(binning.n_pairs), "n_dropped": int(binning.n_dropped)}
    return out
