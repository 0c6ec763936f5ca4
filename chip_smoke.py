#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gaussian_ray_tracing_tpu_torch) on
one NVIDIA GPU: builds the hand-written kernels from the checkout, holds
each against its plain torch version, renders the exact-oracle goldens
(pinhole and fisheye) through the kernel path, drives the render main path
(GaussianRayTracer, 1280x720, 100k gaussians, bench config), the training
main path (Trainer.fit, 512x512, 50k gaussians, key order; then window
order at SH 0, and window and key order at SH 3 on fitted_20k.ply, with
K1's saved-carry modes and K3's window replay and SH 3 modes held against
their plain versions), the mesh-bounce path (GaussianRayTracer with a
mirror plane and a 180x90 glass sphere, 1280x720, 100k) and the camera
path (fisheye 768x768 on 100k, fitted_20k.ply at SH 0 and 3, OpenCV
distortion and a rolling shutter at 1280x720), the merge-order path (K1's
merge mode against its plain version on the golden and camera streams and
in block mode, the exact torch oracle against the goldens, merge renders
against all six goldens, a 1280x720 / 100k merge frame, and mirror and
glass frames with order and bounce_order "merge"), mesh bounces under a
fisheye camera and at SH 3 (fisheye mirror and glass_front frames on 100k,
an SH 3 glass_front frame on fitted_20k.ply, every bounce's K4 and K1 held
against their plain versions, 256x256 NORMAL-plane frames against the mesh
oracle), the viewer (viewer.serve over HTTP: pinhole, fisheye, fisheye
mirror and SH 3 glass frames at 1280x720) and `cli orbit`, `cli warmup
--assert` and `cli bench`, the tiled march (a 1280x720 / 100k frame,
the 720p golden, three tiled training steps at 512x512 / 50k, K1's
scalar and quad key modes and K3's gradients held against it, `cli
grad-check` and `cli info` with the native C++ core built by g++ beside
the kernels), two witnesses of ROADMAP Queue 3 (K1's plain quad version
on the rays where K1 and the tiled march part; K3 against its float64
backward per column), the per-ray-origin differentiable march
(march_stream_diff through a 512x512 rolling shutter with per-ray
windows and carry-in, key and window order at SH 0 and on fitted_20k.ply
at SH 3, key order on the per-ray-origin quad response; the
per-ray-origin quad response on a 1280x720 / 100k rolling frame), the
multi-device layer on 4 shards of the card
(parallel/: the ray-sharded forward bit for bit as the single-device
frame, the sharded gradients and Trainer with ZeRO-1 moments, depth
slabs on K1 in gather and ring order, the tiled, oracle and
gaussian-sharded reference renderers, a world of one over NCCL), training
on tiles of 1024 and 512 rays (Trainer.fit in key and window order at SH
0 and 3, march_stream_diff from per-ray origins and the rolling 720p
frame on the per-ray-origin quad response at 1024 rays a tile, every
launch of the 1024-ray builds of K1 and K3 held against its plain
version) and the binning's pair culls (conic_cull, row_span and both on
the 720p / 100k headline, fisheye_cull on fisheye_768 and on the fisheye
glass_front frame: drop-free subsets of the uncut streams, key order
within 5e-4 of the uncut image, window order on the goldens; K2 at their
channel counts), tiles of more than 1024 rays (the 720p / 100k headline
on 64x32 and 64x64 tiles in window, key and merge order, Trainer.fit on
64x32 tiles in key and window order, render_rolling and the
per-ray-origin quad rolling frame and the fisheye glass_front mesh frame
at R = 2048: every launch of K1's and K3's cluster builds and of K4 split
over blocks held against its plain version), tiles of more than 8192 rays
(the headline on 128x128 tiles in window, key, merge and oddeven order and
on 130x64, 192x128 and 256x256 tiles, Trainer.fit on 128x128 tiles in key
and window order, render_rolling and the per-ray-origin quad rolling
frames at 128x128 and 256x256, the fisheye glass_front mesh frame and a
4-shard sharded frame on 128x128 tiles, and one key-order render of the
512x512 view as a single tile of 262,144 rays: every launch of K1 and K3
marching several rays a thread and of K4 over 16 blocks a tile held
against its plain version and timed in turns with 64x64 and 16x16 tiles),
K1's window-order options
and the peak key, the
per-pair sort keys, oddeven and bfloat16 (the headline under pair_keys
"tile", "tile_peak" and "affine" in window, key and merge order and
under order="oddeven", each key's stream holding the default's pairs,
K1 against its plain version on each, the affine fills' K2 launch bit
for bit, tile-key training's K1 saved carries and K3; the tiled march
under oddeven and bfloat16), key order and oddeven at march chunks that
are not a power of two (the headline in key order at chunk 96 and oddeven
at 100, three key training steps at chunk 96, the glass_front frame
under bounce_order "key" at 256 x 2 = 512 block rows: every launch of
K1's key kernel and K3's key replay at a runtime chunk held against its
plain version and timed in turns with chunk 128), times each against the
plain path, profiles the 720p/100k, fisheye and SH 3 frames and the window
and key SH 3 train steps, runs `cli render` (plain, with a glass sphere, fisheye at
SH 3, and --order merge) and `cli fit`, and finally writes the
NeRF-synthetic dataset of
data/nerf_fitted/ to build/nerf_fitted/ (400x400 renders of
fitted_20k.ply) and runs `cli fit --dataset` (window order, SH 3, density
control, resumed from its checkpoint) and `cli eval` on its test split.

    python3 chip_smoke.py

Run from (a copy of) the repository. Exits non-zero, printing no result,
without CUDA or without the package beside this file. On success the last
two lines are the kernel table and {"ok": true, "device": {...}}. Each
kernel's bound_ms is the larger of the bytes it must move (the columns it
reads of its inputs read once, its outputs written once) over 3.35 TB/s
and the float operations this run's data needs (the (ray, candidate)
pairs of the chunks its plain version did not skip, times a lower count
of operations per pair, plus the SH 1-3 colour of the pairs that pass the
gate) over 67 TFLOP/s, the published H100 SXM peaks at 700 W. The K1 and
K3 rows also carry what explains their time (`design`): the significant
and fire shares of their stream, the launch's resident blocks per SM and
shared memory, and the registers, stack frame and spills that ptxas
reports; the smoke fails if K3 at SH 3 has fewer than two resident blocks
per SM, or K1's merge kernel other than two. The K2 row carries its
tiles, resident blocks per SM, registers and stack (`scan_design`); K2 is
held exact on seven shapes, each called twice. The K4 row also carries, on
glass_front's bounce 1, the shares of (ray, block) pairs and (ray, face)
tests that its pretests skip (the kernel's own counts, which must equal
ops/tri.pretest_stats' on every bounce), its resident blocks per SM,
registers and stack, and the smoke fails if the pretests skip nothing
there. Each log line carries the seconds
since the start.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "gaussian_ray_tracing_tpu_torch"
BENCH_KW = dict(hit_multiplicity=1, order="window", march_chunk=128)
GOLDEN_EYE = (0.0, 0.3, 2.8)
PSNR_KERNEL, MAXABS_KERNEL = 70.0, 1e-2  # the JAX suite's quad-path bars
PSNR_GOLDEN = 40.0  # the exact-oracle parity bar
PSNR_ORACLE = 60.0  # the torch oracle vs the float16 goldens of the same oracle
ORACLE_720P_S = 30.0  # the 720p oracle frame runs only if estimated below this
TIN_ABS = 1e-4  # saved carries, kernel vs plain
# K3 vs plain, per written column max|a-b| / max|b|: the JAX suite's
# hand-written-backward bar, and twice it on the 9 M columns, whose
# reference algebra cancels in float32 (PERF.md, "K3 per column"); on every
# written column K3 stays as close to the float64 witness as the plain does
BWD_REL, BWD_REL_M, WITNESS_RATIO = 1e-3, 2e-3, 1.25
TRAIN_KW = dict(hit_multiplicity=1, order="key", march_chunk=256)  # cli fit's default
PSNR_MESH_FRAME = 60.0  # mesh frames, kernel path vs plain path
PSNR_FRAME = 60.0  # whole frames, kernel path vs plain path
# H100 SXM published peaks: HBM3 bandwidth and dense FP32 rate
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
# float operations per (ray, candidate) pair, counted low from the plain
# versions' arithmetic (response and gate only; no colour, no composite);
# the SH 1-3 colour (sh_ops) counts only where the gate passes
OPS_QUAD, OPS_SCALAR, OPS_BWD, OPS_TRI = 30, 60, 100, 40
OPS_QUAD_ORIGIN = 60  # the per-ray-origin quad response: od and oo cost 36 more than from the eye
T_START = time.perf_counter()


def log(phase: str, msg: str) -> None:
    print(f"[{phase} {time.perf_counter() - T_START:.0f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call milliseconds of fn(), each bracketed by CUDA events."""
    import torch

    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for moving nbytes and doing ops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def march_bound(args, kw, plain, tin=None) -> tuple[float, str]:
    """Bound of one K1 call march(*args, **kw) whose plain version, run last
    on the same inputs, counted `plain.candidates` (tile, candidate) slots in
    the chunks it did not skip and `plain.significant` (ray, candidate)
    pairs through the gate: the columns K1 reads of each pair row (block
    mode: of each listed block's rows; 12 + 3K quad, 14 + 3K scalar, 11 +
    3K per-ray-origin quad) read once, the per-ray inputs and outputs once,
    the saved carries written once; OPS_QUAD, OPS_SCALAR or OPS_QUAD_ORIGIN
    per (ray, candidate) pair of those slots and the SH 1-3 colour per pair
    through the gate."""
    import torch

    starts, feats, dirs_t, cfg, chunk = args[:5]
    T, R = dirs_t.shape[:2]
    if kw.get("blocks") is not None:
        bs = chunk // kw.get("block_sub", 1)
        listed = kw["blocks"][: int(starts[-1]) // bs]
        rows = int(torch.unique(listed).numel()) * bs
    else:
        rows = int(starts[-1] - starts[0])
    origin_quad = kw.get("quad", False)
    scalar = kw.get("origins_t") is not None and not origin_quad
    columns = (14 if scalar else 11 if origin_quad else 12) + 3 * (cfg.sh_degree + 1) ** 2
    per_ray = 3 + 4  # direction in; rgb, T out
    per_ray += sum({"origins_t": 3}.get(k, 1) for k in ("origins_t", "t_lo", "t_hi", "t0")
                   if kw.get(k) is not None)
    nbytes = 4 * (rows * columns + T * R * per_ray + T + 1)
    if tin is not None:
        nbytes += 4 * (tin.numel() + T + 1)  # the carries and chunk_base
    per_pair = OPS_SCALAR if scalar else OPS_QUAD_ORIGIN if origin_quad else OPS_QUAD
    ops = plain.candidates * R * per_pair + plain.significant * sh_ops(cfg.sh_degree)
    return bound(nbytes, ops)


def sh_ops(degree: int) -> int:
    """Colour operations per (ray, candidate) pair at SH 1-3: a multiply and
    an add per coefficient and channel (SH 0 reads a precomputed colour)."""
    return 0 if degree == 0 else 6 * (degree + 1) ** 2


def bwd_bound(args, plain, kw=None) -> tuple[float, str]:
    """Bound of one K3 call march_bwd(*args) whose plain version, run last on
    the same inputs, counted `plain.candidates` replayed (tile, candidate)
    slots and `plain.significant` (ray, candidate) pairs through the gate:
    of each row the 14 + 3K columns K3 reads, once, and the 13 + 3K it
    writes (mean, M, opacity, SH), once; the per-ray inputs (direction,
    d_rgb, d_tfinal), the carries and the eye read once; OPS_BWD per (ray,
    candidate) pair of the replayed slots and twice the SH 1-3 colour (the
    colour and its gradient) per pair through the gate; the per-ray
    origins and windows of `kw`, once."""
    starts, rows, dirs_t, tin, cfg = args[0], args[1], args[2], args[4], args[8]
    T, R = dirs_t.shape[:2]
    K = (cfg.sh_degree + 1) ** 2
    per_ray = 7 + sum(v[0, 0].numel() for v in (kw or {}).values() if v is not None)
    nbytes = 4 * (rows.shape[0] * ((14 + 3 * K) + (13 + 3 * K)) + per_ray * T * R + tin.numel()
                  + 2 * starts.numel() + 3)
    return bound(nbytes, plain.candidates * R * OPS_BWD
                 + plain.significant * 2 * sh_ops(cfg.sh_degree))


def tri_bound(args, kw) -> tuple[float, str]:
    """Bound of one K4 call: each listed face block read once, the rays in,
    (t, face, u, v) out; ray-face tests of the live rays of each tile."""
    import torch

    starts, blocks, face_rows, dirs_t = args[:4]
    T, R = dirs_t.shape[:2]
    faces = (starts[1:] - starts[:-1]).long()  # listed face slots per tile
    live = ((dirs_t * dirs_t).sum(-1) > 0.01).sum(-1).long()
    n_blocks = int(torch.unique(blocks[: int(starts[-1]) // 256]).numel())
    per_ray = 3 + 4 + (3 if kw.get("origins_t") is not None else 0)
    nbytes = 4 * (n_blocks * 256 * face_rows.shape[1] + T * R * per_ray + T + 1)
    return bound(nbytes, int((faces * live).sum()) * OPS_TRI)


PTXAS = {}  # mangled kernel name: (registers, stack, spill stores, spill loads), from the build


def kernel_name(kernel: str, order: str, C: int, degree: int, R: int, *, scalar: bool = False,
                quad: bool = False, train: bool = False) -> str:
    """The mangled name, as -Xptxas -v prints it (past the namespace), of the
    K1 ("march") or K3 ("march_bwd") instantiation a launch runs: staging
    capacity C, SH degree, order (oddeven runs the key kernel), per-ray
    origins with the scalar response `scalar` or the quad one `quad` (K3:
    per-ray origins `scalar`), saved carries `train`, and kMaxR from R rays a
    tile: the 256-ray build up to 256 rays, the 1024-ray one up to 1024, else
    the cluster build (kClusterR, 8192: one ray a thread up to 8192 rays,
    several above; merge order's is march_merge_cluster_kernel)."""
    K, b = (degree + 1) ** 2, lambda x: f"Lb{int(x)}E"
    build = f"Li{256 if R <= 256 else 1024 if R <= 1024 else 8192}E"  # kMaxR
    if kernel == "march_bwd":
        return f"16march_bwd_kernelILi{C}ELi{K}E{b(order == 'window')}{b(scalar)}{build}"
    resp = f"Li{2 if quad else int(scalar)}E"  # k1::Resp
    if order == "window":
        return f"12march_kernelILi{C}E{resp}Li{K}E{b(train)}{build}"
    if order == "merge":  # above 1024 rays its own cluster kernel
        return (f"26march_merge_cluster_kernelILi{C}E{resp}Li{K}E{b(R > 8192)}E" if R > 1024
                else f"18march_merge_kernelILi{C}E{resp}Li{K}E{build}")
    return f"16march_key_kernelILi{C}E{resp}Li{K}E{b(train)}{build}"


def design(kernel: str, cfg, chunk: int, *, scalar: bool = False, train: bool = False,
           quad: bool = False, rays: int = 256, call=None) -> dict:
    """What explains a K1 ("march") or K3 ("march_bwd") row: the (tile,
    candidate) slots of the chunks not skipped, the significant share (pairs
    through the gate over the (ray, candidate) pairs of those chunks), the
    fire share (fired chunks over the chunks not skipped; None outside
    window order) and the slow share (chunks whose tile-wide fast test
    failed over the chunks not skipped; None outside merge order) of the
    plain version's last call (K1: per-ray origins with the scalar response
    `scalar` or the quad one `quad`; K3: per-ray origins `scalar`), and the
    launch's resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    at `rays` rays a tile), dynamic shared memory, registers, stack frame and
    spills (-Xptxas -v of the build: the 256-ray build up to 256 rays, the
    1024-ray one up to 1024, else the cluster build), and the blocks of a
    tile's cluster and the clusters resident at once
    (cudaOccupancyMaxActiveClusters; None up to 1024 rays). call: the K1
    call's (args, kw), whose k1_stops shares join the line (the plain
    version's counters are then that call's)."""
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd

    plain = kmarch.march_plain if kernel == "march" else kbwd.march_bwd_plain
    R, order = rays, cfg.order
    info = cuda_build.launch_info(kernel, chunk, cfg.sh_degree, R, order=order, scalar=scalar,
                                  train=train, quad=quad)
    C = info["build_chunk"]  # the staging capacity of this chunk's build
    name = kernel_name(kernel, order, C, cfg.sh_degree, R, scalar=scalar, quad=quad, train=train)
    regs, stack, st, ld = next((v for k, v in PTXAS.items() if name in k), (None,) * 4)
    check(regs == info["registers"], f"{kernel} {name}: ptxas says {regs} registers, the "
                                     f"runtime {info['registers']}")
    stops = k1_stops(*call) if call is not None else {}
    out = {"marched_slots": plain.candidates,
           "significant_share": plain.significant / max(1, plain.candidates * R),
           "fire_share": plain.fired / max(1, plain.chunks) if order == "window" else None,
           "slow_share": plain.slow / max(1, plain.chunks) if order == "merge" else None,
           "blocks_per_sm": info["blocks_per_sm"], "smem_bytes": info["smem_bytes"],
           "registers": regs, "stack_bytes": stack, "spill_store_bytes": st,
           "spill_load_bytes": ld, "cluster_blocks": info["cluster_blocks"],
           "resident_clusters": info["resident_clusters"], "build_chunk": C, **stops}
    log("design", f"{kernel} {order} sh{cfg.sh_degree} c={chunk} (build C={C}) R={R}"
        + " scalar" * scalar
        + " origin quad" * quad + " save_tin" * train + f": {json.dumps(out)}")
    return out


def _hist_stats(h) -> tuple[float, int]:
    """Mean and 99th percentile of the values whose counts are h (h[v]: how
    many times v occurs)."""
    import torch

    n = int(h.sum())
    if n == 0:
        return 0.0, 0
    v = torch.arange(h.numel(), dtype=torch.float64, device=h.device)
    p99 = int(torch.searchsorted(torch.cumsum(h, 0), torch.tensor(
        [0.99 * n], dtype=h.dtype, device=h.device))[0])
    return float((h.double() * v).sum()) / n, p99


def k1_stops(args, kw=None) -> dict:
    """Where K1's pass 1 stops on each (ray, candidate) of a call and what
    window order's pass 2 sorts, counted in torch over march_plain's own
    chunks (those its tile-wide skip did not skip; tail slots left out):
    the tiles with a marched chunk, and the most chunks one of them marched
    (its chunks run one after the other: the launch's critical path).
    Each pair stops at the first of: a dead ray (dead), the sure-miss test
    (sure_miss; the scalar form only where dd >= 1e-6), alpha <= alpha_min
    (alpha), a failed gate with the event t past t_hi (past_t_hi) or
    another failed gate (gate); the rest are significant. Per (warp, slot)
    of warps with a live lane: every live lane a sure miss
    (warp_sure_miss_share); warp_dead the share of (warp, slot) pairs
    without a live lane. Window order: the fire share of the (tile, chunk)
    pairs, and per live ray of a fired fire group ns (its significant candidates) and the inversions of its list
    under the sort key (pass 2's insertion-sort shifts), mean and 99th
    percentile, and per warp of those the mean of its lanes' largest
    (warp_ns_mean, warp_inv_mean: a warp's loop runs as long as its longest
    lane's). Merge order, the work of the merge kernel's design at commit
    309918a (PERF.md's step 0 of its redesign; the cluster build since lists
    only the significant candidates and copies no pending buffer), summed over the
    rays (merge_counts): the marched and slow (tile, chunk) pairs and the
    slow ones on a fresh pending buffer; pass 1's evaluations and, above
    8192 rays, the first pass's; the insertion's shifts (the inversions of
    each ray's C keys); the walk's steps (2C a slow chunk, C on a fresh
    buffer), the significant slots it moves into the pending buffer and
    those that composite (fast chunks: the pending buffer's); above 8192
    rays the bytes a ray's pending buffer moved in and out of device memory
    (every marched chunk); and the cluster barriers a tile (skip test and
    fast test a chunk, the last skip test, the end)."""
    import torch

    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch

    kw = kw or {}
    if kw.get("quad"):
        return {}  # the per-ray-origin quad response: not counted here
    dirs_t, cfg = args[2], args[3]
    dev = dirs_t.device
    scalar = kw.get("origins_t") is not None
    names = ("dead", "sure_miss", "alpha", "past_t_hi", "gate", "significant")
    acc = {k: 0 for k in (*names, "live", "pairs", "warps", "warp_sm", "warp_slots",
                          "warp_dead", "fire_chunks", "fired", "warp_ns", "warp_inv",
                          "fired_warps")}
    h_ns = torch.zeros(257, dtype=torch.int64, device=dev)
    h_inv = torch.zeros(256 * 255 // 2 + 1, dtype=torch.int64, device=dev)

    def sure_miss(oo, od, D, op):  # csrc/march.cuh sure_miss and miss_threshold
        thr = 2.0 * torch.log(op / cfg.alpha_min) + 1e-4
        return oo * D - od * od > (thr + 2e-6 * oo.abs()) * D

    orig_chunk, orig_window = kmarch._chunk_plain, kmarch._window_composite
    orig_merge = kmarch._merge_composite
    mc = {k: 0 for k in ("chunks", "slow", "fresh_slow", "shifts", "walk_steps", "sig_moves",
                         "sig_composited")}
    state = {}  # the live rays of the batch whose chunk window_hook composites
    tile_chunks = torch.zeros(dirs_t.shape[0], dtype=torch.int64, device=dev)  # marched

    def chunk_hook(tb, j, starts, feats, rays, trans, rgb, config, c, blocks, block_sub, *rest):
        idx, present = kmarch._chunk_rows(tb, j, starts, c, feats.shape[0], blocks, block_sub)
        f = feats[idx]
        col = lambda k: f[:, :, k:k + 1]
        sub = {k: ([x[tb][:, None] for x in v] if isinstance(v, list)
                   else v[tb][:, None] if torch.is_tensor(v) else v) for k, v in rays.items()}
        dx, dy, dz = sub["d"]
        live = sub["live"]
        op = col(0)
        if not scalar:  # the quad response from the eye (eval_quad)
            m2 = (dx * dx, dy * dy, dz * dz, 2.0 * dx * dy, 2.0 * dx * dz, 2.0 * dy * dz)
            dd = col(1) * m2[0] + col(2) * m2[1] + col(3) * m2[2] + col(4) * m2[3] \
                + col(5) * m2[4] + col(6) * m2[5]
            od = col(7) * dx + col(8) * dy + col(9) * dz
            cq, oo = col(10).expand_as(dd), col(11).expand_as(dd)
            D = torch.clamp(dd, min=1e-6)
            sm = sure_miss(oo, od, D, op)
            t_star = -od * (1.0 / D)
            pp = oo + od * t_star
        else:  # the scalar response from per-ray origins (eval_scalar)
            ox, oy, oz = (o - col(kmarch.T_MX + k) for k, o in enumerate(sub["o"]))
            m = [col(kmarch.T_M0 + k) for k in range(9)]
            og = [m[3 * i] * ox + m[3 * i + 1] * oy + m[3 * i + 2] * oz for i in range(3)]
            dg = [m[3 * i] * dx + m[3 * i + 1] * dy + m[3 * i + 2] * dz for i in range(3)]
            dd = dg[0] * dg[0] + dg[1] * dg[1] + dg[2] * dg[2]
            od = og[0] * dg[0] + og[1] * dg[1] + og[2] * dg[2]
            oo = og[0] * og[0] + og[1] * og[1] + og[2] * og[2]
            D = torch.clamp(dd, min=1e-6)
            sm = (dd >= 1e-6) & sure_miss(oo, od, D, op)
            t_star = -od / D
            pp = oo + t_star * (2.0 * od + t_star * dd)
            cq = oo - col(kmarch.T_RAD) * col(kmarch.T_RAD)
        alpha = torch.clamp(torch.exp(-0.5 * torch.clamp(pp, min=0.0)) * op, max=cfg.alpha_clamp)
        t_ev, _, _ = kmarch._event_gate(od, dd, cq, sub["t_lo"], sub["t_hi"])
        a = (kmarch._quad_alpha if rays["quad"] else kmarch._scalar_alpha)(f, sub, present,
                                                                           config)[0]
        pres = present.expand_as(dd)
        lv = live.expand_as(dd) & pres
        sm = lv & sm
        low = lv & ~sm & ~(alpha > cfg.alpha_min)
        sig = a > 0.0
        fail = lv & ~sm & ~low & ~sig
        past = fail & (t_ev > sub["t_hi"])
        stop = dict(dead=pres & ~lv, sure_miss=sm, alpha=low, past_t_hi=past, gate=fail & ~past,
                    significant=sig)
        for k, v in stop.items():
            acc[k] += int(v.sum())
        acc["pairs"] += int(pres.sum())
        acc["live"] += int(lv.sum())
        B, cc, R = dd.shape
        w = lambda x: x.reshape(B, cc, R // 32, 32)
        has = w(lv).any(-1)
        acc["warp_slots"] += int(w(pres).any(-1).sum())
        acc["warp_dead"] += int((w(pres).any(-1) & ~has).sum())
        acc["warps"] += int(has.sum())
        acc["warp_sm"] += int((has & (w(sm) == w(lv)).all(-1)).sum())
        tile_chunks.index_add_(0, tb, torch.ones_like(tb))
        state["live"] = live
        return orig_chunk(tb, j, starts, feats, rays, trans, rgb, config, c, blocks, block_sub,
                          *rest)

    def window_hook(t_carry, a, t_ev, cols, min_t, train, opts):
        B, c, R = a.shape
        G = R // opts["group"]
        ag, tg = (kmarch._split_groups(x, G) if G > 1 else x for x in (a, t_ev))
        fired = kmarch.window_fire(ag, tg, opts["a_fire"])
        acc["fire_chunks"] += ag.shape[0]
        acc["fired"] += int(fired.sum())
        fb = fired.nonzero().squeeze(1)
        if fb.numel():
            a_f, t_f = ag[fb], tg[fb]
            sig = a_f > 0.0
            if train:
                key = kmarch.train_sort_key(a_f.expand(-1, -1, t_f.shape[2]), t_f).long()
            else:
                aq = torch.clamp(a_f * 32767.0, 0.0, 32767.0).to(torch.int32)
                key = torch.where(sig, (kmarch.window_tq(a_f, t_f) << 15) | aq,
                                  kmarch._ZBASE).long()
            ns = sig.sum(1)  # (Bf, r)
            r = ns.shape[1]
            step = max(1, (1 << 24) // (c * c * r))
            inv = torch.cat([
                ((key[s:s + step, :, None] > key[s:s + step, None])  # (i, k) with i < k
                 & sig[s:s + step, :, None] & sig[s:s + step, None]
                 & torch.ones(c, c, dtype=torch.bool, device=a.device).triu(1)[None, :, :, None]
                 ).sum((1, 2)) for s in range(0, key.shape[0], step)])
            lv = state["live"]  # the batch's live rays (chunk_hook), (B, 1, R)
            dl = (kmarch._split_groups(lv, G) if G > 1 else lv)[fb][:, 0]
            h_ns.index_add_(0, ns[dl], torch.ones_like(ns[dl]))
            h_inv.index_add_(0, inv[dl], torch.ones_like(inv[dl]))
            wl = dl.reshape(-1, r // 32, 32).any(-1)
            acc["fired_warps"] += int(wl.sum())
            acc["warp_ns"] += int(ns.reshape(-1, r // 32, 32).amax(-1)[wl].sum())
            acc["warp_inv"] += int(inv.reshape(-1, r // 32, 32).amax(-1)[wl].sum())
        return orig_window(t_carry, a, t_ev, cols, min_t, train, opts)

    def merge_hook(t_carry, a, t_ev, cols, pend, min_t, scan=False):
        B, c, R = a.shape
        pk, pa, _ = pend
        keys, kb, has_inv = kmarch.merge_keys(a, t_ev)
        new_min = torch.where(a > 0.0, kb, kmarch._IMAX).amin(dim=1)
        pend_max = torch.where(pa > 0.0, pk, kmarch._IMIN).amax(dim=1)
        slow = ~(~has_inv & (new_min >= pend_max).all(dim=1))
        fresh = (pk == kmarch._IMIN).flatten(1).all(dim=1)
        mc["chunks"] += B
        mc["slow"] += int(slow.sum())
        mc["fresh_slow"] += int((slow & fresh).sum())
        mc["walk_steps"] += int(torch.where(fresh, c, 2 * c)[slow].sum()) * R
        for i in range(1, c):  # the shifts that insert key i after keys 0..i-1
            mc["shifts"] += int((keys[slow, :i] > keys[slow, i:i + 1]).sum())
        union = torch.sort(torch.cat([pk, keys], dim=1), dim=1, stable=True)[1]
        u_sig = torch.gather(torch.cat([pa, a], 1) > 0.0, 1, union)
        mc["sig_moves"] += int(u_sig[slow, c:].sum())
        mc["sig_composited"] += int(u_sig[slow, :c].sum()) + int((pa[~slow] > 0.0).sum())
        return orig_merge(t_carry, a, t_ev, cols, pend, min_t, scan)

    kmarch._chunk_plain, kmarch._window_composite = chunk_hook, window_hook
    kmarch._merge_composite = merge_hook
    try:
        kmarch.march_plain(*args, **kw)
    finally:
        kmarch._chunk_plain, kmarch._window_composite = orig_chunk, orig_window
        kmarch._merge_composite = orig_merge
    n, nl = max(1, acc["pairs"]), max(1, acc["live"])
    out = {f"stop_{k}": acc[k] / n for k in names}
    out.update(sure_miss_share=acc["sure_miss"] / nl,
               warp_sure_miss_share=acc["warp_sm"] / max(1, acc["warps"]),
               warp_dead=acc["warp_dead"] / max(1, acc["warp_slots"]),
               live_share=float(((dirs_t * dirs_t).sum(-1) > 0.01).float().mean()),
               tiles_marched=int((tile_chunks > 0).sum()),
               tile_chunks_max=int(tile_chunks.max()) if tile_chunks.numel() else 0)
    if cfg.order == "window":
        ns_mean, ns_p99 = _hist_stats(h_ns)
        inv_mean, inv_p99 = _hist_stats(h_inv)
        fw = max(1, acc["fired_warps"])
        out.update(fire_share=acc["fired"] / max(1, acc["fire_chunks"]), ns_mean=ns_mean,
                   ns_p99=ns_p99, inv_mean=inv_mean, inv_p99=inv_p99,
                   warp_ns_mean=acc["warp_ns"] / fw, warp_inv_mean=acc["warp_inv"] / fw)
    if cfg.order == "merge":  # merge_counts
        T, R, C = dirs_t.shape[0], dirs_t.shape[1], args[4]
        multi = R > 8192
        marched = mc["chunks"] * R  # (ray, chunk) pairs
        starts = args[0]
        n_chunks = (starts[1:] - starts[:-1] + C - 1).div(C, rounding_mode="floor")
        stopped = int((tile_chunks < n_chunks).sum())  # a skip test that ended the tile
        fields = 5 + 3 * C + C // 32  # csrc/march.cuh merge_fields
        out["merge_counts"] = dict(
            chunks=mc["chunks"], slow=mc["slow"], fresh_slow=mc["fresh_slow"],
            slow_share=mc["slow"] / max(1, mc["chunks"]),
            evals=acc["pairs"], evals_first=acc["pairs"] if multi else 0,
            shifts=mc["shifts"], walk_steps=mc["walk_steps"], sig_moves=mc["sig_moves"],
            sig_composited=mc["sig_composited"],
            copy_bytes=2 * 4 * fields * marched if multi else 0,
            barriers_per_tile=(2 * mc["chunks"] + stopped + T) / max(1, T),
            per_ray_chunk={k: mc[k] / max(1, marched) for k in ("shifts", "walk_steps",
                                                                 "sig_moves")})
    return out


def scan_design(x) -> dict:
    """What explains the K2 row at x's shape: the tiles (one block each) of
    the call, and the launch's resident blocks per SM, static shared
    memory, registers, stack frame and spills."""
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build

    lib = cuda_build.load_library()
    info = cuda_build.launch_info("scan", 0, 0, 0)
    regs, stack, st, ld = next((v for k, v in PTXAS.items() if "scan_kernel" in k), (None,) * 4)
    check(regs == info["registers"], f"scan_kernel: ptxas says {regs} registers, the runtime "
                                     f"{info['registers']}")
    out = {"tiles": lib.grt_scan_scratch_bytes(*x.shape) // 8 - 1,
           "blocks_per_sm": info["blocks_per_sm"], "smem_bytes": info["smem_bytes"],
           "registers": regs, "stack_bytes": stack, "spill_store_bytes": st,
           "spill_load_bytes": ld}
    log("design", f"K2 {tuple(x.shape)}: {json.dumps(out)}")
    return out


def tri_design(args, kw) -> dict:
    """What explains a K4 row, read from the kernel's own counts (its
    `stats`, which must equal pretest_stats'): the share of listed (tile,
    block) pairs it did not stage (tile_block_skip), of listed (ray,
    block) pairs whose block pretest failed (ray_block_skip), of listed
    (warp, block) pairs that tested no row (warp_block_skip), of listed
    (ray, face) pairs its warps never tested (row_face_skip) and of those
    that did not reach the divide (face_test_skip: the face pretest's
    rejections too); and the launch's resident blocks per SM, registers,
    stack and spills."""
    import torch

    from gaussian_ray_tracing_tpu_torch.ops import cuda_build
    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri

    starts, dirs_t = args[0], args[3]
    T, R = dirs_t.shape[:2]
    stats = torch.zeros((T, len(ktri.STATS)), dtype=torch.int32, device=dirs_t.device)
    ktri.closest_hit_blocks(*args, **kw, stats=stats)
    want = ktri.pretest_stats(*args, kw["origins_t"], kw["bounds"])
    check(torch.equal(stats, want), "K4: the kernel's counts differ from pretest_stats")
    staged, needed, warp_blocks, warp_rows, divided = stats.long().sum(0).tolist()
    listed = int(((starts[1:] - starts[:-1]) // 256).sum())  # (tile, block) pairs
    pairs = max(1, listed * R)
    info = cuda_build.launch_info("closest_hit", 0, 0, R)
    regs, stack, st, ld = next((v for k, v in PTXAS.items() if "tri_kernel" in k), (None,) * 4)
    check(regs == info["registers"], f"tri_kernel: ptxas says {regs} registers, the runtime "
                                     f"{info['registers']}")
    out = {"tile_block_skip": 1.0 - staged / max(1, listed),
           "ray_block_skip": 1.0 - needed / pairs,
           "warp_block_skip": 1.0 - warp_blocks * 32 / pairs,
           "row_face_skip": 1.0 - warp_rows * 32 * 8 / (pairs * 256),
           "face_test_skip": 1.0 - divided / (pairs * 256),
           "tile_warp_blocks_max": int(stats[:, 2].max()) if T else 0,
           "tile_warp_blocks_mean": warp_blocks / max(1, T),
           "blocks_per_sm": info["blocks_per_sm"], "smem_bytes": info["smem_bytes"],
           "registers": regs, "stack_bytes": stack, "spill_store_bytes": st,
           "spill_load_bytes": ld}
    log("design", f"K4, {listed} listed blocks, the kernel's counts: {json.dumps(out)}")
    return out


def device_reading(fn, event_ms: float, what: str) -> float | None:
    """The profiler's device ms of one call of fn, or None where no two
    traces agree. A trace can lose kernel events (late in a long smoke run
    the first traces of a call read 0 ms, or 0.11 ms for a 0.22 ms K1
    launch), which lowers its reading and its device ops a call: a first
    trace is thrown away, and a reading counts once two traces see the
    same device ops a call and device ms within 10% of each other, in (0,
    event_ms] (event_ms the call's own event time); the larger one is
    kept. A third trace is taken before the reading is given up."""
    profile_frames(fn, frames=5, top=1, host=False)
    reads = []
    for _ in range(3):
        prof = profile_frames(fn, frames=5, top=1, host=False)
        reads.append((prof["device_ops"], prof["device_ms"]))
        for (ops_a, ms_a), (ops_b, ms_b) in itertools.combinations(reads, 2):
            lo, hi = min(ms_a, ms_b), max(ms_a, ms_b)
            if ops_a == ops_b and 0.0 < lo and hi <= min(event_ms, 1.1 * lo):
                return hi
    log("profile", f"{what}: device ms not measured (traces of {event_ms:.4f} ms event calls "
                   f"read (ops, ms) {[(round(o, 2), round(m, 4)) for o, m in reads]})")
    return None


def fms(x: float | None) -> str:
    """A device reading for a log line."""
    return "not measured" if x is None else f"{x:.3f}"


def turns(fns: dict, reps: int = 10, device: bool = True) -> dict:
    """{name: (median event ms, device ms)} of each fn, called in turns a,
    b, b, a, reps times each; the device ms (with `device`) device_reading's
    for one call of each, else None."""
    ms = {k: [] for k in fns}
    names = list(fns)
    for name in names + names[::-1]:
        fns[name]()
        ms[name] += cuda_ms(fns[name], reps)
    ev = {k: statistics.median(v) for k, v in ms.items()}
    dev = {k: device_reading(f, ev[k], k) for k, f in fns.items()} if device else {}
    return {k: (ev[k], dev.get(k)) for k in fns}


def k1_check(phase: str, what: str, args, kw=None) -> float:
    """K1 against march_plain on one call's inputs: rgb and T_final at the
    K1 bars. Returns the max abs difference."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    kw = kw or {}
    got = kmarch.march(*args, **kw)
    torch.cuda.synchronize()
    want = kmarch.march_plain(*args, **kw)
    err = 0.0
    for part, a, b in (("rgb", got[0], want[0]), ("T_final", got[1], want[1])):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        p, m = psnr(a, b), float(np.abs(a - b).max())
        err = max(err, m)
        log(phase, f"{what} {part}: PSNR {p:.2f} dB max abs {m:.3g}")
        check(p >= PSNR_KERNEL and m <= MAXABS_KERNEL, f"K1 {what} vs plain {part}")
    return err


def k4_check(phase: str, what: str, args, kw) -> tuple[float, int]:
    """K4 against closest_hit_blocks_plain on one call's inputs: face ids,
    t, u and v bit-identical, and the kernel's counts (`stats`) those of
    ops/tri.pretest_stats. Returns (the max abs difference of t, u and v,
    the hits)."""
    import torch

    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri

    stats = torch.zeros((args[3].shape[0], len(ktri.STATS)), dtype=torch.int32,
                        device=args[3].device)
    got = ktri.closest_hit_blocks(*args, **kw, stats=stats)
    torch.cuda.synchronize()
    want = ktri.closest_hit_blocks_plain(*args, **kw)
    check(torch.equal(got[1], want[1]), f"K4 {what}: face ids differ")
    check(all(torch.equal(a, w) for a, w in zip(got, want)),
          f"K4 {what}: t, u or v not bit-identical to the plain version")
    check(torch.equal(stats, ktri.pretest_stats(*args, kw["origins_t"], kw["bounds"])),
          f"K4 {what}: the kernel's counts differ from pretest_stats")
    pairs = list(zip(got[0::2] + got[3:], want[0::2] + want[3:]))  # t, u, v
    err = max(float((a - w).nan_to_num(0.0).abs().max()) for a, w in pairs)
    live = int(((args[3] * args[3]).sum(-1) > 0.01).sum())
    hits = int((want[1] >= 0).sum())
    origin = "shared origin" if kw["origins_t"] is None else "per-ray origins"
    log(phase, f"{what} ({origin}): {live} live rays, {int(args[0][-1]) // 256} face blocks "
               f"listed, {hits} hits, face ids, t, u and v bit-identical, "
               f"{int(stats[:, 0].sum())} blocks staged, the kernel's counts those of "
               f"pretest_stats")
    return err, hits


def merge_cluster_crafted(phase: str, rays: tuple) -> dict:
    """K1 merge order's cluster build on the crafted calls of
    tests/test_torch_gpu.py's MERGE_CLUSTER_CASES at these tile widths
    (tests/merge_cluster_streams.py): each launch's (rgb, t_final) bit for
    bit as MERGE_CLUSTER_DIGESTS (the kernels of commit 309918a) and at the
    K1 bars of march_plain. Returns {case: max abs difference}."""
    import hashlib

    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_gpu as gpu_tests
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch

    errs = {}
    for case in gpu_tests.MERGE_CLUSTER_CASES:
        if case[1] not in rays:
            continue
        name = gpu_tests._merge_case_name(case)
        args, kw = gpu_tests._merge_cluster_call(case)
        h = hashlib.sha256()
        for x in kmarch.march(*args, **kw):
            h.update(x.contiguous().cpu().numpy().tobytes())
        check(h.hexdigest() == gpu_tests.MERGE_CLUSTER_DIGESTS[name],
              f"K1 merge crafted {name}: not the bits of commit 309918a")
        errs[name] = k1_check(phase, f"merge crafted {name}", args, kw)
    log(phase, f"merge order's crafted cluster calls at R in {rays}: {len(errs)} bit for bit "
               f"as commit 309918a's")
    return errs


def k3_wide_crafted(rays: tuple) -> dict:
    """K3's 1024-ray and cluster builds on the crafted calls of
    tests/test_torch_gpu.py's K3_WIDE_CASES at these tile widths
    (tests/bwd_wide_streams.py): each launch's d_rows bit for bit as
    K3_WIDE_DIGESTS (the kernels of commit 1d2f322) and at the K3 bars of
    march_bwd_plain (k3_check). Returns {case: max abs difference}."""
    import hashlib

    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_gpu as gpu_tests
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd

    errs = {}
    for case in gpu_tests.K3_WIDE_CASES:
        if case[2] not in rays:
            continue
        name = gpu_tests._k3_case_name(case)
        args, kw = gpu_tests._k3_wide_call(case)
        got = kbwd.march_bwd(*args, **kw).contiguous().cpu().numpy()
        check(hashlib.sha256(got.tobytes()).hexdigest() == gpu_tests.K3_WIDE_DIGESTS[name],
              f"K3 crafted {name}: not the bits of commit 1d2f322")
        errs[name] = k3_check(f"crafted {name}", args, kw)
    log("K3", f"crafted calls at R in {rays}: {len(errs)} bit for bit as commit 1d2f322's")
    return errs


def k1_train_check(what: str, got, want) -> float:
    """K1 with saved carries against march_plain on one stream: rgb and T
    at the quad-path bars, the carries to TIN_ABS, chunk_base equal.
    Returns the max abs difference."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    check(torch.equal(got[3], want[3]), f"K1 {what}: chunk_base differs")
    err = 0.0
    for part, a, b in (("rgb", got[0], want[0]), ("T_final", got[1], want[1])):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        p, m = psnr(a, b), float(np.abs(a - b).max())
        err = max(err, m)
        log("K1train", f"{what} {part}: PSNR {p:.2f} dB max abs {m:.3g}")
        check(p >= PSNR_KERNEL and m <= MAXABS_KERNEL, f"K1 {what} vs plain {part}")
    m = float((got[2] - want[2]).abs().max())
    log("K1train", f"{what} tin ({got[2].shape[0]} chunks): max abs {m:.3g}")
    check(m <= TIN_ABS, f"K1 saved carries vs plain {what}: {m:.3g}")
    return max(err, m)


def k3_check(what: str, args, kw=None) -> float:
    """K3 against march_bwd_plain and its float64 witness, per written
    column (mean, M, opacity, SH coefficients); two launches bit-identical.
    kw: per-ray origins and windows. Returns the max abs difference."""
    import torch

    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd

    degree = args[8].sh_degree
    diff = kmarch.diff_columns(degree)
    written = [i for i, c in enumerate(kmarch.train_columns(degree)) if c in diff]
    m_cols = range(kmarch.T_M0, kmarch.T_M0 + 9)
    kw = kw or {}
    g1, g2 = kbwd.march_bwd(*args, **kw), kbwd.march_bwd(*args, **kw)
    torch.cuda.synchronize()
    gp = kbwd.march_bwd_plain(*args, **kw)
    f64 = lambda a: a.double() if torch.is_tensor(a) and a.is_floating_point() else a
    g64 = kbwd.march_bwd_plain(*map(f64, args), **{k: f64(v) for k, v in kw.items()})
    check(torch.equal(g1, g2), f"K3 {what} is not deterministic")
    check(not g1[:, [i for i in range(g1.shape[1]) if i not in written]].any(),
          f"K3 {what}: a quad, radius or pad column is not zero")
    rel, wit = {}, {}
    for i in written:
        rel[i] = float((g1[:, i] - gp[:, i]).abs().max() / gp[:, i].abs().max())
        w = g64[:, i].abs().max()
        wit[i] = (float((g1[:, i] - g64[:, i]).abs().max() / w),
                  float((gp[:, i] - g64[:, i]).abs().max() / w))
    iw = max(written, key=lambda i: wit[i][0])
    ir = max(written, key=lambda i: rel[i])
    log("K3", f"{what}: {len(written)} written columns, worst max|a-b|/max|b| {rel[ir]:.3g} "
              f"(col {ir}), M columns " + " ".join(f"{rel[i]:.3g}" for i in m_cols)
              + f"; worst vs float64 witness K3 {wit[iw][0]:.3g} plain {wit[iw][1]:.3g} "
                f"(col {iw}); two launches bit-identical")
    for i in written:
        bar = BWD_REL_M if i in m_cols else BWD_REL
        check(rel[i] <= bar, f"K3 vs plain {what} column {i}: {rel[i]:.3g} > {bar}")
        check(wit[i][0] <= WITNESS_RATIO * wit[i][1],
              f"K3 {what} column {i}: {wit[i][0]:.3g} from the float64 witness, plain "
              f"{wit[i][1]:.3g}")
    return float((g1 - gp).abs().max())


def run_cli(*argv) -> str:
    """`python -m gaussian_ray_tracing_tpu_torch.cli *argv` in this process
    (cli.main: the same entry point without an interpreter's start-up);
    logs its time and last line and returns its standard output."""
    import contextlib
    import io

    from gaussian_ray_tracing_tpu_torch import cli

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    out = buf.getvalue().strip()
    log("cli", f"{' '.join(argv[:1])} in {time.perf_counter() - t:.1f} s: "
               f"{out.splitlines()[-1] if out else ''}")
    return out


def profile_frames(fn, frames: int = 5, top: int = 5, host: bool = True) -> dict:
    """torch.profiler over `frames` calls of fn() after one warm-up: device
    time per frame, device ops (kernels, copies) per frame, the `top` ops by
    device time, and with `host` the host ops by host time (self CPU time
    per call of fn: where a host-bound call spends its time; without it only
    the device is traced, which costs far less on calls of ~10^4 ops)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device-side events only (kernels, copies, sets): a CPU op's device
    # time is its kernels', which are listed themselves
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0.0)
    ops = [(e.key, dev_us(e) / 1e3 / frames, e.count / frames) for e in events
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    ops.sort(key=lambda x: -x[1])
    hosts = [(e.key, e.self_cpu_time_total / 1e3 / frames, e.count / frames)
             for e in events if host and e.device_type == DeviceType.CPU]
    hosts.sort(key=lambda x: -x[1])
    return {"device_ms": sum(o[1] for o in ops), "device_ops": sum(o[2] for o in ops),
            "top": [(k[:48], round(ms, 4)) for k, ms, _ in ops[:top]],
            "host_ms": sum(h[1] for h in hosts),
            "host_top": [(k[:40], round(ms, 3), round(n, 1)) for k, ms, n in hosts[:top]]}


def main() -> None:
    if not (ROOT / PKG / "__init__.py").is_file():
        fail(f"{PKG}/ not found beside {Path(__file__).name}: run from a checkout")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
               f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        prepare_pair_stream, prepare_train_stream,
    )
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain
    from gaussian_ray_tracing_tpu_torch.train.losses import dssim_l1_loss
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    # --- phase 1: build --------------------------------------------------
    # the native C++ core (g++) builds beside the kernels (nvcc); without
    # g++ the smoke fails here instead of falling back to numpy
    from gaussian_ray_tracing_tpu_torch.native import bindings as native

    t0 = time.perf_counter()
    native_build = threading.Thread(target=native.build)
    native_build.start()
    lib_path = cuda_build.build()
    cuda_build.load_library()
    log("build", f"{lib_path.name} in {time.perf_counter() - t0:.1f} s")
    native_build.join()
    check(native.available(), "the native C++ core (native/grtcore.cpp) did not build")
    log("build", f"{native.library_path('grtcore', native.CORE_FLAGS).name} by "
                 f"{time.perf_counter() - t0:.1f} s")
    PTXAS.update(cuda_build.ptxas_table(cuda_build.build_log))
    for line in cuda_build.build_log.splitlines():
        if "error" in line.lower():
            log("ptxas", line.strip())
    for name, (regs, stack, st, ld) in sorted(PTXAS.items()):
        log("ptxas", f"{name}: {regs} registers, {stack} B stack, {st} B spill stores, "
                     f"{ld} B spill loads")

    # --- phase 2: K2 scan vs plain (exact) ------------------------------
    # the headline's capacity, one 8,192-element tile less one and one
    # tile and one (and half a tile either side), rows that start off
    # 16-byte alignment (P odd), 16 channels; each shape twice in a row (the
    # status words of the first call must not leak)
    g = torch.Generator(device=dev).manual_seed(0)
    scan_err = 0
    for shape in ((2, 1_500_000), (2, 2_097_152), (1, 4095), (1, 4097), (1, 8191), (1, 8193),
                  (16, 1_000_003)):
        x = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device=dev,
                          generator=g)
        x[:, ::997] = 2**31 - 1  # partial sums wrap
        want = kscan.multi_cumsum_i32_plain(x)
        for call in (1, 2):
            got = kscan.multi_cumsum_i32(x)
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            scan_err = max(scan_err, err)
            check(torch.equal(got, want), f"K2 scan differs from plain at {shape}, call {call}")
        log("K2", f"scan {shape} == plain (exact), called twice")

    # --- phase 3: K1 march vs plain on identical pair streams -----------
    def golden(name):
        z = np.load(ROOT / "data" / "golden" / f"{name}.npz")
        n, seed, width, height, hm, fisheye = (int(v) for v in z["meta"])
        scene = random_scene(n, seed=seed, device=dev)
        cam = cameras.Camera.create(eye=GOLDEN_EYE, lookat=(0.0, 0.0, 0.0),
                                    width=width, height=height, device=dev)
        model = CameraModel.FISHEYE if fisheye else CameraModel.PINHOLE
        return z["rgb"].astype(np.float32), scene, cam, hm, model

    # window, key (SH 0 quad) and merge order on each golden's stream
    # (binning does not depend on the order)
    err3 = {"window": 0.0, "key": 0.0, "merge": 0.0}
    for order, tag, chunks in (("window", "K1", (128, 256)), ("key", "K1key", (128, 256)),
                               ("merge", "K1merge", (64, 128, 256))):
        for name in ("small_pinhole_256", "pinhole_720p"):
            _, scene, cam, hm, _ = golden(name)
            for chunk in chunks:
                for skip in (0.02, 1e-3):
                    cfg = RenderConfig(hit_multiplicity=hm, march_chunk=chunk, order=order,
                                       chunk_skip_transmittance=skip)
                    stream, feats, _ = prepare_pair_stream(scene, cam, cfg, 1 << 16)
                    dirs_t = tile_rays(cameras.generate_rays(cam, cfg)[1], 16, 16)
                    err3[order] = max(err3[order], k1_check(
                        tag, f"{name} c={chunk} skip={skip}",
                        (stream.starts, feats, dirs_t, cfg, chunk)))
    march_err, key_render_err, merge_err = err3["window"], err3["key"], err3["merge"]

    # --- phase 3b: K1 key + saved carries and K3 vs plain ---------------
    def train_stream(scene, cam, cfg):
        stream, rows, n_pairs = prepare_train_stream(scene, cam, cfg)
        dirs_t = tile_rays(cameras.generate_rays(cam, cfg)[1], 16, 16)
        return stream.starts, rows.detach().contiguous(), dirs_t, n_pairs

    key_err, bwd_err = 0.0, 0.0
    for name in ("small_pinhole_256", "pinhole_720p"):
        _, scene, cam, _, _ = golden(name)
        for chunk in (128, 256):
            cfg = RenderConfig(**{**TRAIN_KW, "march_chunk": chunk})
            starts, rows, dirs_t, _ = train_stream(scene, cam, cfg)
            got = kmarch.march(starts, rows, dirs_t, cfg, chunk, save_tin=True)
            torch.cuda.synchronize()
            want = kmarch.march_plain(starts, rows, dirs_t, cfg, chunk, save_tin=True)
            key_err = max(key_err, k1_train_check(f"key {name} c={chunk}", got, want))

            gen = torch.Generator(device=dev).manual_seed(chunk)
            d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dev)
            d_t = torch.randn(dirs_t.shape[:2], generator=gen, device=dev)
            args = (starts, rows, dirs_t, cam.eye, got[2], got[3], d_rgb, d_t, cfg, chunk)
            bwd_err = max(bwd_err, k3_check(f"{name} c={chunk}", args))

    # --- phase 4: goldens through the full GPU path ---------------------
    for name in ("pinhole_720p", "hm2_720p", "small_pinhole_256", "small_hm2_256",
                 "small_fisheye_256", "fisheye_720"):
        ref, scene, cam, hm, model = golden(name)
        cfg = RenderConfig(hit_multiplicity=hm, order="window", march_chunk=128,
                           camera_model=model)
        out = render(scene, cam, cfg, method="gpu", return_aux=True)
        p = psnr(out["rgb"].cpu().numpy(), ref)
        log("golden", f"{name}: PSNR {p:.2f} dB vs exact oracle, "
                      f"{out['aux']['n_pairs']} pairs")
        check(p >= PSNR_GOLDEN, f"golden {name} PSNR {p:.2f} < {PSNR_GOLDEN}")
    oracle_goldens(golden, card)
    for name in ("pinhole_720p", "hm2_720p", "small_pinhole_256", "small_hm2_256",
                 "small_fisheye_256", "fisheye_720"):
        ref, scene, cam, hm, model = golden(name)
        for chunk in (64, 128):
            p = {}
            for order in ("merge", "window"):
                cfg = RenderConfig(hit_multiplicity=hm, order=order, march_chunk=chunk,
                                   camera_model=model)
                p[order] = psnr(render(scene, cam, cfg, method="gpu")["rgb"].cpu().numpy(), ref)
            log("golden", f"{name} c={chunk}: merge PSNR {p['merge']:.2f} dB, window "
                          f"{p['window']:.2f} dB vs exact oracle")
            check(p["merge"] >= PSNR_GOLDEN,
                  f"golden {name} merge c={chunk} PSNR {p['merge']:.2f} < {PSNR_GOLDEN}")

    # --- phase 5: the main path at full size ----------------------------
    cfg = RenderConfig(**BENCH_KW)
    scene = random_scene(100_000, seed=0, device=dev)
    tracer = GaussianRayTracer(scene=scene, config=cfg)
    tracer.set_size(1280, 720)
    radius = float(np.linalg.norm(GOLDEN_EYE))
    poses = [cameras.orbit_camera((0.0, 0.0, 0.0), radius, az, 6.0, width=1280,
                                  height=720, device=dev) for az in (0, 90, 180, 270)]
    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    ply_tracer = GaussianRayTracer(scene=ply, config=cfg)
    ply_tracer.set_size(1280, 720)
    ply_cam = cameras.Camera.create(
        eye=ply.center().cpu().numpy() + np.array([0.0, 0.0, 3.0]),
        lookat=ply.center().cpu().numpy(), width=1280, height=720, device=dev,
    )
    ply_tracer.update_camera(ply_cam)

    kmarch.march.launches = 0
    kscan.multi_cumsum_i32.launches = 0
    frames = []
    for i, (tr, cam) in enumerate([(tracer, c) for c in poses] + [(ply_tracer, ply_cam)]):
        k1, k2 = kmarch.march.launches, kscan.multi_cumsum_i32.launches
        tr.update_camera(cam)
        out = tr.render()
        rgb = out["rgb"]
        torch.cuda.synchronize()
        check(kmarch.march.launches > k1 and kscan.multi_cumsum_i32.launches > k2,
              f"frame {i}: a kernel was not launched")
        check(tuple(rgb.shape) == (720, 1280, 3) and bool(torch.isfinite(rgb).all()),
              f"frame {i}: bad output {tuple(rgb.shape)}")
        check(float(rgb.max()) > 0.1, f"frame {i} is black")
        frames.append(rgb)
    launches = {"march": kmarch.march.launches, "scan": kscan.multi_cumsum_i32.launches}
    log("main", f"5 frames (4 orbit poses of 100k, fitted_20k.ply), launches {launches}")

    # drop-free stream and GPU-vs-plain agreement on the first pose
    cap = tracer._pair_capacity
    out = render(scene, poses[0], cfg, method="gpu", return_aux=True)
    check(out["aux"]["n_dropped"] == 0, "pairs dropped")
    plain0 = render(scene, poses[0], cfg, method="plain")["rgb"]
    p = psnr(out["rgb"].cpu().numpy(), plain0.cpu().numpy())
    log("main", f"100k 720p: {out['aux']['n_pairs']} pairs, n_dropped 0, bucket {cap}, "
                f"gpu vs plain PSNR {p:.2f} dB")
    check(p >= 60.0, f"gpu vs plain frame PSNR {p:.2f} < 60")

    reps = 12
    tracer.update_camera(poses[0])
    ms = {}
    for label, tr, meth in (("gpu", tracer, "gpu"), ("plain", tracer, "plain"),
                            ("ply_gpu", ply_tracer, "gpu"), ("ply_plain", ply_tracer, "plain")):
        tr.render(method=meth)  # warm-up
        ms[label] = statistics.median(cuda_ms(lambda: tr.render(method=meth), reps))
    log("frame", f"1280x720 100k bench config, median of {reps}: gpu {ms['gpu']:.3f} ms, "
                 f"plain {ms['plain']:.3f} ms ({card})")
    log("frame", f"1280x720 fitted_20k.ply, median of {reps}: gpu {ms['ply_gpu']:.3f} ms, "
                 f"plain {ms['ply_plain']:.3f} ms ({card})")
    tracer.update_camera(poses[0])
    prof = profile_frames(tracer.render, top=8)
    idle = 1.0 - prof["device_ms"] / ms["gpu"]
    log("profile", f"1280x720 100k bench config: device busy {prof['device_ms']:.3f} ms of a "
                   f"{ms['gpu']:.3f} ms frame (idle share {idle:.3f}), "
                   f"{prof['device_ops']:.0f} device ops per frame, top {prof['top']} ({card})")

    # kernels alone at the main path's shapes (100k, 720p, first pose)
    stream, feats, n_pairs = prepare_pair_stream(scene, poses[0], cfg, cap)
    dirs_t = tile_rays(cameras.generate_rays(poses[0], cfg)[1], 16, 16)
    chunk = chunk_for(cfg)
    k1_ms = statistics.median(cuda_ms(
        lambda: kmarch.march(stream.starts, feats, dirs_t, cfg, chunk), 20))
    k1_plain = statistics.median(cuda_ms(
        lambda: kmarch.march_plain(stream.starts, feats, dirs_t, cfg, chunk), 5))
    k1_bound = march_bound((stream.starts, feats, dirs_t, cfg, chunk), {}, kmarch.march_plain)
    k1_design = design("march", cfg, chunk)
    x = torch.randint(-1000, 1000, (2, cap), dtype=torch.int32, device=dev, generator=g)
    k2_ms = statistics.median(cuda_ms(lambda: kscan.multi_cumsum_i32(x), 50))
    k2_plain = statistics.median(cuda_ms(lambda: kscan.multi_cumsum_i32_plain(x), 50))
    k2_lib = statistics.median(cuda_ms(lambda: torch.cumsum(x, dim=1), 50))
    k2_bound = bound(2 * x.numel() * 4, x.numel())
    # the device time of a call (the memset and the scan), without the
    # wrapper's host work that the event times above include
    k2_design = {"device_ms": profile_frames(lambda: kscan.multi_cumsum_i32(x), 50)["device_ms"],
                 **scan_design(x)}
    log("kernel", f"K1 march {n_pairs} pairs c={chunk}: {k1_ms:.3f} ms, plain "
                  f"{k1_plain:.3f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]}); K2 scan "
                  f"(2, {cap}): {k2_ms:.4f} ms (device {k2_design['device_ms']:.4f} ms), plain "
                  f"{k2_plain:.4f} ms, torch.cumsum "
                  f"{k2_lib:.4f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]}) ({card})")

    # --- phase 6: the training main path at full size --------------------
    # cli fit's defaults at the bench's training size (bench.py:109-160):
    # 8 orbit targets of random_scene(50k, seed 0) at 512x512, rendered by
    # the port in key order, fitted from random_scene(50k, seed 1)
    tcfg = RenderConfig(**TRAIN_KW)
    target_scene = random_scene(50_000, seed=0, device=dev)
    center = target_scene.center().cpu().numpy()
    views = []
    with torch.no_grad():
        for i in range(8):
            cam = cameras.orbit_camera(center, 2.8, 360.0 * i / 8, 15.0, width=512,
                                       height=512, device=dev)
            views.append((cam, render(target_scene, cam, tcfg, method="gpu")["rgb"]))
    init = random_scene(50_000, seed=1, device=dev)
    trainer = ktrain.Trainer(GaussianModel.from_scene(init), config=tcfg, lr=2e-3)
    kmarch.march.launches = kmarch.march.save_tin_launches = 0
    kbwd.march_bwd.launches = kscan.multi_cumsum_i32.launches = 0
    losses = []
    for step in range(1, 21):  # steps is the total schedule: one more each call
        k1, k3 = kmarch.march.save_tin_launches, kbwd.march_bwd.launches
        losses += trainer.fit(views, steps=step)
        check(kmarch.march.save_tin_launches > k1 and kbwd.march_bwd.launches > k3,
              f"train step {step}: K1 save_tin or K3 was not launched")
    torch.cuda.synchronize()
    train_launches = {"march_key_save_tin": kmarch.march.save_tin_launches,
                      "march_bwd": kbwd.march_bwd.launches,
                      "scan": kscan.multi_cumsum_i32.launches}
    check(train_launches["scan"] > 0, "training did not launch K2")
    check(len(losses) == 20 and all(np.isfinite(losses)), f"bad losses {losses}")
    log("train", f"20 steps 512x512 50k: loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
                 f"same view (0) {losses[0]:.6f} -> {losses[16]:.6f}, launches {train_launches}")
    check(losses[16] < losses[0], f"loss on view 0 did not fall: {losses[0]} -> {losses[16]}")

    step_ms = {"gpu": [], "plain": []}
    model = trainer.model
    steppers = {m: ktrain.make_train_step(tcfg, trainer.optimizer, method=m,
                                          pair_capacity=trainer._pair_capacity)
                for m in step_ms}
    for _ in range(2):  # kernel, plain, kernel, plain: 12 + 10 timed steps
        for method, n in (("gpu", 6), ("plain", 5)):
            for i in range(n):
                cam, target = views[i % 8]
                step_ms[method] += cuda_ms(lambda: steppers[method](model, cam, target), 1)
    step_med = {m: statistics.median(v) for m, v in step_ms.items()}
    log("train", f"train step 512x512 50k key order, median of {len(step_ms['gpu'])}/"
                 f"{len(step_ms['plain'])}: gpu {step_med['gpu']:.3f} ms, plain "
                 f"{step_med['plain']:.3f} ms ({card})")

    # kernels alone at the training path's shapes (first view, c=256),
    # held against their plain versions there too
    cam0 = views[0][0]
    starts, rows, dirs_t, n_pairs_t = train_stream(model.activate(), cam0, tcfg)
    fwd = lambda f: f(starts, rows, dirs_t, tcfg, 256, save_tin=True)
    got = fwd(kmarch.march)
    torch.cuda.synchronize()
    key_err = max(key_err, k1_train_check("key train 512x512 50k c=256", got,
                                          fwd(kmarch.march_plain)))
    tin, base = got[2], got[3]
    gen = torch.Generator(device=dev).manual_seed(0)
    d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dev)
    d_t = torch.randn(dirs_t.shape[:2], generator=gen, device=dev)
    bargs = (starts, rows, dirs_t, cam0.eye, tin, base, d_rgb, d_t, tcfg, 256)
    bwd_err = max(bwd_err, k3_check("train 512x512 50k c=256", bargs))
    k1key_ms = statistics.median(cuda_ms(lambda: fwd(kmarch.march), 20))
    k1key_plain = statistics.median(cuda_ms(lambda: fwd(kmarch.march_plain), 5))
    k3_ms = statistics.median(cuda_ms(lambda: kbwd.march_bwd(*bargs), 20))
    k3_plain = statistics.median(cuda_ms(lambda: kbwd.march_bwd_plain(*bargs), 5))
    k1key_bound = march_bound((starts, rows, dirs_t, tcfg, 256), {}, kmarch.march_plain, tin=tin)
    k1key_design = design("march", tcfg, 256, train=True)
    k3_bound = bwd_bound(bargs, kbwd.march_bwd_plain)
    k3_design = design("march_bwd", tcfg, 256)
    log("kernel", f"K1 key+save_tin {n_pairs_t} pairs c=256: {k1key_ms:.3f} ms, plain "
                  f"{k1key_plain:.3f} ms, bound {k1key_bound[0]:.4f} ms ({k1key_bound[1]}); K3 "
                  f"{k3_ms:.3f} ms, plain {k3_plain:.3f} ms, bound {k3_bound[0]:.4f} ms "
                  f"({k3_bound[1]}) ({card})")

    # one dssim_l1 step on the card against the same step on the CPU
    small = random_scene(5000, seed=2)
    dl = {}
    for where in ("cuda", "cpu"):
        cam = cameras.Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0),
                                    width=128, height=128, device=where)
        target = render(random_scene(5000, seed=3, device=where), cam, tcfg)["rgb"]
        m = GaussianModel.from_scene(small.to(where)).requires_grad_(True)
        step = ktrain.make_train_step(tcfg, ktrain.default_optimizer(m), dssim_l1_loss)
        dl[where] = float(step(m, cam, target)["loss"])
    log("dssim", f"dssim_l1 step 128x128 5k: card {dl['cuda']:.8f}, cpu {dl['cpu']:.8f}")
    check(abs(dl["cuda"] - dl["cpu"]) <= 1e-4 * abs(dl["cpu"]), "dssim_l1 card vs cpu")

    train_rows = training_phase(dev, card, views, init)
    tiled_rows, k2_tiled = tiled_phase(dev, card, views, init)
    witness_phase(dev, card, views, init)
    t_phase = time.perf_counter()
    origin_rows = per_ray_origin_phase(dev, card, scene, init)
    log("phase", f"per-ray origins in {time.perf_counter() - t_phase:.1f} s")
    wide_rows = wide_tile_phase(dev, card, scene, poses[0], views, init)
    huge_rows = huge_tile_phase(dev, card, scene, poses[0], views, init)
    option_rows = window_options_phase(dev, card, scene, poses[0], golden, views, init)
    pair_rows = pair_keys_phase(dev, card, scene, poses[0], golden, views, init)
    parallel_rows = parallel_phase(dev, card, scene, poses[0], golden, views, init)


    # --- phase 7: mesh bounces at full size ------------------------------
    # scripts/mesh_probe.py's configuration: 1280x720, random_scene(100k,
    # seed 0), bench config, eye (0, 0.3, 2.8) looking at the origin; a
    # MIRROR plane (planar path: K1 segments) and a 180x90 GLASS sphere
    # (fast path: K4 every bounce, K1 segments, then K1 block mode), both
    # at (0, 0, 0.5). There the meshes sit inside the scene's shell of
    # gaussians: every ray reaching them carries T < 0.02, so the bounced
    # rays are retired and the block march gets no live ray. The same
    # sphere at (0, 0, 1.6), in front of the shell ("glass_front"), gives
    # bounce 1 live rays with per-ray origins, whose exits K4 misses: the
    # 16-block budget keeps the faces nearest the entry point, as in the
    # JAX package. cli render's 36x18 sphere there ("glass_cli", 5 face
    # blocks) is hit on the way out too, so its bounces 1-3 run K4 with hits
    # and the block march behind the sphere. The kernels are held against
    # their plain versions on every bounce of all three frames.
    from gaussian_ray_tracing_tpu_torch.config import MeshType
    from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as kmesh
    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_sphere, merge_meshes

    mcam = cameras.Camera.create(eye=GOLDEN_EYE, lookat=(0.0, 0.0, 0.0), width=1280,
                                 height=720, device=dev)
    at_probe = np.eye(4, dtype=np.float32)
    at_probe[:3, 3] = (0.0, 0.0, 0.5)
    mcfg = RenderConfig(**BENCH_KW)
    front = make_sphere((0.0, 0.0, 1.6), device=dev).with_type(MeshType.GLASS)
    check(front.num_faces == 32_040, "the 180x90 sphere has 32,040 faces")
    records = {}
    for name, mesh in (("glass", make_sphere((0.0, 0.0, 0.5), device=dev)), ("glass_front", front),
                       ("glass_cli", make_sphere((0.0, 0.0, 1.6), tess_u=36, tess_v=18,
                                                 device=dev))):
        records[name] = []
        kmesh.render_with_mesh_fast(scene, mesh.with_type(MeshType.GLASS), mcam, mcfg,
                                    record=records[name])
        torch.cuda.synchronize()
        check(len(records[name]) >= 2, f"{name} frame ran {len(records[name])} bounces")

    k4_err, k4_hits = 0.0, {}
    for name, record in records.items():
        for b, rec in enumerate(record):
            err, k4_hits[name, b] = k4_check("K4", f"{name} bounce {b}", *rec["k4"])
            k4_err = max(k4_err, err)
    check(k4_hits["glass_cli", 1] > 0, "glass_cli bounce 1: K4 found no exit hit")

    block_err = seg_err = 0.0
    seg_args, seg_kw = records["glass"][0]["k1"]
    blk_args, blk_kw = records["glass_front"][1]["k1"]
    check(int(blk_args[0][-1]) > 0, "glass_front bounce 1: the block march listed no block")
    cli_args, cli_kw = records["glass_cli"][2]["k1"]
    modes = [("glass segment t_hi+t0 window", seg_args, seg_kw),
             ("glass segment t_hi+t0 key",
              (*seg_args[:3], mcfg.replace(order="key"), seg_args[4]), seg_kw),
             ("glass block (bounce 1)", *records["glass"][1]["k1"]),
             ("glass_front segment t_hi+t0 window", *records["glass_front"][0]["k1"]),
             ("glass_front block block_sub=1", blk_args, blk_kw),
             ("glass_front block block_sub=2", (*blk_args[:4], 2 * blk_args[4]),
              {**blk_kw, "block_sub": 2}),
             ("glass_front block key", (*blk_args[:3], mcfg.replace(order="key"), blk_args[4]),
              blk_kw),
             ("glass_cli block (bounce 2)", cli_args, cli_kw),
             ("glass_cli block block_sub=2 (bounce 2)", (*cli_args[:4], 2 * cli_args[4]),
              {**cli_kw, "block_sub": 2})]
    for what, args, kw in modes:
        err = k1_check("K1mesh", f"{what} ({int(args[0][-1])} slots)", args, kw)
        if "block" in what:
            block_err = max(block_err, err)
        else:
            seg_err = max(seg_err, err)

    # the main path: GaussianRayTracer with one mirror plane, then one glass
    # sphere, each moved to (0, 0, 0.5)
    mtracer = GaussianRayTracer(scene=scene, config=mcfg)
    mtracer.set_size(1280, 720)
    mtracer.update_camera(mcam)
    counters = {"march": (kmarch.march, "launches"),
                "march_segment": (kmarch.march, "segment_launches"),
                "march_block": (kmarch.march, "block_launches"),
                "scan": (kscan.multi_cumsum_i32, "launches"),
                "closest_hit": (ktri.closest_hit_blocks, "launches")}
    count = lambda: {label: getattr(fn, attr) for label, (fn, attr) in counters.items()}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    mesh_frames, mesh_launches = {}, {}
    for kind in ("mirror", "glass"):
        before = count()
        idx = (mtracer.create_plane(mesh_type=kind) if kind == "mirror"
               else mtracer.create_sphere(mesh_type=kind))
        mtracer.update_instance_transform(idx, at_probe)
        rgb = mtracer.render()["rgb"]
        torch.cuda.synchronize()
        check(tuple(rgb.shape) == (720, 1280, 3) and bool(torch.isfinite(rgb).all()),
              f"{kind} frame: bad output")
        check(float(rgb.max()) > 0.1, f"{kind} frame is black")
        mesh_launches[kind] = {k: v - before[k] for k, v in count().items()}
        mesh_frames[kind] = merge_meshes(mtracer.primitives)
        mtracer.remove_primitive(idx)
    mesh_counts = count()
    mesh_frames["glass_front"] = front
    m, g = mesh_launches["mirror"], mesh_launches["glass"]
    check(m["march_segment"] == 2 and m["march_block"] == 0 and m["closest_hit"] == 0,
          f"mirror frame: the planar path runs two K1 segments, no K4, no block march ({m})")
    check(g["march_segment"] >= 1 and g["march_block"] >= 1 and g["closest_hit"] >= 2,
          f"glass frame: K4 and K1's segment and block modes must launch ({g})")
    check(m["scan"] > 0 and g["scan"] > 0, "mesh frames: K2 did not launch")
    log("mesh", f"mirror + glass frames through GaussianRayTracer, launches {mesh_launches}")

    mesh_ms = {}
    for kind, mesh in mesh_frames.items():
        out = render(scene, mcam, mcfg, mesh=mesh, method="gpu", return_aux=True)
        plain = render(scene, mcam, mcfg, mesh=mesh, method="plain", return_aux=True)
        p = psnr(out["rgb"].cpu().numpy(), plain["rgb"].cpu().numpy())
        log("mesh", f"{kind} 1280x720 100k: aux gpu {out['aux']} plain {plain['aux']}, "
                    f"gpu vs plain PSNR {p:.2f} dB")
        check(out["aux"]["pair_dropped"] == 0, f"{kind}: pairs dropped")
        check(out["aux"].get("block_dropped") == plain["aux"].get("block_dropped"),
              f"{kind}: block_dropped differs between kernel and plain paths")
        check(p >= PSNR_MESH_FRAME, f"{kind} gpu vs plain frame PSNR {p:.2f} < {PSNR_MESH_FRAME}")
        run = lambda meth: render(scene, mcam, mcfg, mesh=mesh, method=meth)
        run("gpu")  # warm-up
        mesh_ms[kind] = (statistics.median(cuda_ms(lambda: run("gpu"), 10)),
                         statistics.median(cuda_ms(lambda: run("plain"), 2)))
        log("frame", f"{kind} 1280x720 100k, median of 10/2: gpu {mesh_ms[kind][0]:.3f} ms, "
                     f"plain {mesh_ms[kind][1]:.3f} ms ({card})")

    # kernels alone at the glass frames' shapes
    k4_args, k4_kw = records["glass_cli"][1]["k4"]
    k4_ms = statistics.median(cuda_ms(lambda: ktri.closest_hit_blocks(*k4_args, **k4_kw), 20))
    k4_plain = statistics.median(cuda_ms(
        lambda: ktri.closest_hit_blocks_plain(*k4_args, **k4_kw), 5))
    k4f, k4f_kw = records["glass_front"][1]["k4"]
    k4f_ms = statistics.median(cuda_ms(lambda: ktri.closest_hit_blocks(*k4f, **k4f_kw), 20))
    k4f_plain = statistics.median(cuda_ms(lambda: ktri.closest_hit_blocks_plain(*k4f, **k4f_kw),
                                          5))
    k4f_bound = tri_bound(k4f, k4f_kw)
    k4_0, k4_0kw = records["glass"][0]["k4"]
    k40_ms = statistics.median(cuda_ms(lambda: ktri.closest_hit_blocks(*k4_0, **k4_0kw), 20))
    k40_plain = statistics.median(cuda_ms(
        lambda: ktri.closest_hit_blocks_plain(*k4_0, **k4_0kw), 5))
    k40_bound = tri_bound(k4_0, k4_0kw)
    blk_ms = statistics.median(cuda_ms(lambda: kmarch.march(*blk_args, **blk_kw), 20))
    blk_plain = statistics.median(cuda_ms(lambda: kmarch.march_plain(*blk_args, **blk_kw), 5))
    blk_bound = march_bound(blk_args, blk_kw, kmarch.march_plain)
    blk_design = design("march", blk_args[3], blk_args[4], scalar=True, call=(blk_args, blk_kw))
    # K4's pretests on glass_front's bounce 1: what they skip (the kernel's
    # own counts), and its launch
    k4_design = tri_design(k4f, k4f_kw)
    check(k4_design["ray_block_skip"] > 0 and k4_design["row_face_skip"] > 0,
          f"glass_front bounce 1: K4's pretests skipped nothing ({k4_design})")
    seg_ms = statistics.median(cuda_ms(lambda: kmarch.march(*seg_args, **seg_kw), 20))
    seg_plain = statistics.median(cuda_ms(lambda: kmarch.march_plain(*seg_args, **seg_kw), 5))
    seg_bound = march_bound(seg_args, seg_kw, kmarch.march_plain)
    seg_design = design("march", seg_args[3], seg_args[4], call=(seg_args, seg_kw))
    log("kernel", f"K4 glass_cli bounce 1 (per-ray origins): {k4_ms:.3f} ms, plain "
                  f"{k4_plain:.3f} ms; K4 glass_front bounce 1 (per-ray origins): {k4f_ms:.3f} "
                  f"ms, plain {k4f_plain:.3f} ms; K4 glass bounce 0 (shared origin): {k40_ms:.3f} ms, plain "
                  f"{k40_plain:.3f} ms; K1 block glass_front bounce 1: {blk_ms:.3f} ms, plain "
                  f"{blk_plain:.3f} ms; K1 segment glass bounce 0: {seg_ms:.3f} ms, plain "
                  f"{seg_plain:.3f} ms; bounds K4 bounce 0 {k40_bound[0]:.4f} ms ({k40_bound[1]}), "
                  f"K4 glass_front bounce 1 {k4f_bound[0]:.4f} ms ({k4f_bound[1]}), K1 block "
                  f"{blk_bound[0]:.4f} ms ({blk_bound[1]}), K1 segment {seg_bound[0]:.4f} ms "
                  f"({seg_bound[1]}) ({card})")

    cam_rows = camera_phase(dev, card, scene)
    merge_rows = merge_phase(dev, card, scene, poses[0], mcam, at_probe, front, merge_err)
    chunk_rows = any_chunk_phase(dev, card, scene, poses[0], views, init, mcam, front)
    t_phase = time.perf_counter()
    meshcam_rows = mesh_camera_phase(dev, card, scene, mcam, at_probe, front)
    log("phase", f"mesh cameras (fisheye, SH 3) in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    serving_phase(dev, card, scene)
    log("phase", f"viewer and serving CLI in {time.perf_counter() - t_phase:.1f} s")

    # --- CLI, one frame through a user's entry point ---------------------
    os.makedirs(ROOT / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        png = Path(tmp) / "cli.png"
        res = subprocess.run(
            [sys.executable, "-m", f"{PKG}.cli", "render", "--synthetic", "100000",
             "--width", "1280", "--height", "720", "-o", str(png)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        check(res.returncode == 0, f"cli render failed:\n{res.stderr[-4000:]}")
        check(png.is_file() and png.stat().st_size > 0, "cli wrote no PNG")
        img = _png_pixels(png)
        check(img.max() > 0, "cli PNG is all black")
        log("cli", f"{res.stdout.strip()} (max pixel {int(img.max())})")

        # the other renders through cli.main in this process (the same entry
        # point; an interpreter's start-up each cost ~10 s)
        run_cli("render", "--synthetic", "100000", "--width", "1280", "--height", "720",
                "--add-sphere", "--mesh-type", "glass", "-o", str(png))
        img = _png_pixels(png)
        check(img.max() > 0, "cli glass-sphere PNG is all black")
        log("cli", f"--add-sphere --mesh-type glass: max pixel {int(img.max())}")

        run_cli("render", "--ply", str(ROOT / "data" / "fitted_20k.ply"), "--width", "768",
                "--height", "768", "--eye", *map(str, GOLDEN_EYE), "--lookat", "0", "0", "0",
                "--fisheye", "--sh-degree", "3", "--hit-multiplicity", "1", "-o", str(png))
        img = _png_pixels(png)
        check(img.max() > 0 and not img[0, :3].any(), "cli fisheye PNG: black, or corner not blank")
        log("cli", f"--fisheye --sh-degree 3: max pixel {int(img.max())}")

        run_cli("render", "--synthetic", "100000", "--width", "1280", "--height", "720",
                "--order", "merge", "--march-chunk", "128", "--hit-multiplicity", "1",
                "-o", str(png))
        img = _png_pixels(png)
        check(img.max() > 0, "cli merge PNG is all black")
        log("cli", f"--order merge: max pixel {int(img.max())}")

        fit_ply = Path(tmp) / "fit.ply"
        res = subprocess.run(
            [sys.executable, "-m", f"{PKG}.cli", "fit", "--ply", "data/fitted_20k.ply",
             "--fit-gaussians", "20000", "--width", "512", "--height", "512",
             "--steps", "10", "-o", str(fit_ply)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        check(res.returncode == 0, f"cli fit failed:\n{res.stderr[-4000:]}")
        fitted = load_ply(str(fit_ply), device=dev)
        check(fitted.num_active == 20_000 and bool(torch.isfinite(fitted.means).all()),
              "cli fit wrote a bad PLY")
        log("cli", f"fit: {res.stdout.strip().splitlines()[-1]} ({fitted.num_active} read back)")

    dataset_phase(dev, card)
    log("total", f"every phase in {time.perf_counter() - T_START:.1f} s")

    src = f"{PKG}/csrc"
    k1 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    row = lambda name, source, replaces, launches, err, ms, plain_ms, b, lib=None, more=None: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b[0], "bound_by": b[1], "library_ms": lib, **(more or {})}
    print(json.dumps({"kernels": [
        row("march", "march.cuh", k1, launches["march"], march_err, k1_ms, k1_plain, k1_bound,
            more=k1_design),
        row("march_key_save_tin", "march.cuh", k1, train_launches["march_key_save_tin"], key_err,
            k1key_ms, k1key_plain, k1key_bound,
            more={**k1key_design, "render_sh0_max_abs_err": key_render_err}),
        row("multi_cumsum_i32", "scan.cu", "gaussian_ray_tracing_tpu/ops/scan.py:81",
            launches["scan"], scan_err, k2_ms, k2_plain, k2_bound, k2_lib,
            more={**k2_design, "tiled_frame_launches": k2_tiled}),
        row("march_bwd", "march_bwd.cuh", "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189",
            train_launches["march_bwd"], bwd_err, k3_ms, k3_plain, k3_bound, more=k3_design),
        row("closest_hit", "tri.cu", "gaussian_ray_tracing_tpu/ops/pallas_tri.py:77",
            mesh_counts["closest_hit"], k4_err, k40_ms, k40_plain, k40_bound,
            more={"glass_front_bounce1": {"ms": k4f_ms, "plain_ms": k4f_plain,
                                          "bound_ms": k4f_bound[0], **k4_design}}),
        row("march_segment", "march.cuh", k1, mesh_counts["march_segment"], seg_err, seg_ms,
            seg_plain, seg_bound, more=seg_design),
        row("march_block", "march.cuh", k1, mesh_counts["march_block"], block_err, blk_ms,
            blk_plain, blk_bound, more=blk_design),
        *cam_rows,
        *train_rows,
        *tiled_rows,
        *parallel_rows,
        *origin_rows,
        *wide_rows,
        *huge_rows,
        *option_rows,
        *pair_rows,
        *merge_rows,
        *chunk_rows,
        *meshcam_rows,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def mesh_camera_phase(dev, card: str, scene, mcam, at_probe, front) -> list:
    """Mesh bounces under a fisheye camera and at SH 3, at full width
    (1280x720, bench config, phase 7's camera and meshes): on `scene`
    (random_scene(100k, seed 0)) a fisheye frame with phase 7's MIRROR
    plane at (0, 0, 0.5) (the planar path: two K1 segments of the camera
    and its mirror image) and a fisheye `glass_front` frame (the 180x90
    GLASS sphere at (0, 0, 1.6): the fast path, K4 every bounce, K1
    segments then block mode); on data/fitted_20k.ply an SH 3 `glass_front`
    frame. The fisheye focal is the config's default, as in the camera
    phase. The main path: each frame once through GaussianRayTracer (its
    camera model set as the viewer sets it), the launch counts zeroed just
    before. Then, on every bounce of each frame's recorded kernel calls,
    K4 bit-identical to its plain version with its counts those of
    pretest_stats, and K1 within k1_check's bars (at SH 3 also the segment
    in key and merge order and block mode in window, key and merge order at
    block_sub 1 and 2); each frame's kernel path against its plain path
    (>= 60 dB, drop-free, equal block_dropped); frame times and profiles;
    and at 256x256 fisheye and SH 3 frames of the small goldens' scene
    (random_scene(5000, seed 3)) with a NORMAL plane at (0, 0, 1.6), fast
    path against the port's mesh oracle at the golden bar (a GLASS plane
    there is logged beside them). Returns the kernel rows."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import CameraModel, MeshType, RenderConfig
    from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as kmesh
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_plane
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    bench = RenderConfig(**BENCH_KW)
    fish = bench.replace(camera_model=CameraModel.FISHEYE)
    at_front = np.eye(4, dtype=np.float32)
    at_front[:3, 3] = (0.0, 0.0, 1.6)
    # name: (scene, config, primitive kind, its transform, the mesh the records render)
    frames = {
        "fisheye_mirror": (scene, fish, "plane", "mirror", at_probe,
                           make_plane((0.0, 0.0, 0.5), device=dev).with_type(MeshType.MIRROR)),
        "fisheye_glass_front": (scene, fish, "sphere", "glass", at_front, front),
        "sh3_glass_front": (ply, bench.replace(sh_degree=3), "sphere", "glass", at_front, front),
    }
    counters = {"march": (kmarch.march, "launches"),
                "march_segment": (kmarch.march, "segment_launches"),
                "march_block": (kmarch.march, "block_launches"),
                "march_sh": (kmarch.march, "sh_launches"),
                "scan": (kscan.multi_cumsum_i32, "launches"),
                "closest_hit": (ktri.closest_hit_blocks, "launches")}
    count = lambda: {label: getattr(fn, attr) for label, (fn, attr) in counters.items()}
    tracers = {}
    for name, (sc, cfg, kind, mtype, xf, _) in frames.items():
        tr = GaussianRayTracer(scene=sc, config=cfg.replace(camera_model=CameraModel.PINHOLE))
        tr.set_camera_model(cfg.camera_model.value)
        tr.set_size(1280, 720)
        tr.update_camera(mcam)
        idx = tr.create_plane(mesh_type=mtype) if kind == "plane" else tr.create_sphere(
            mesh_type=mtype)
        tr.update_instance_transform(idx, xf)
        tracers[name] = tr

    # the main path: every frame once, counts zeroed just before
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    launches = {}
    for name, (_, cfg, _, _, _, _) in frames.items():
        before = count()
        rgb = tracers[name].render()["rgb"]
        torch.cuda.synchronize()
        launches[name] = {k: v - before[k] for k, v in count().items()}
        check(tuple(rgb.shape) == (720, 1280, 3) and bool(torch.isfinite(rgb).all()),
              f"{name}: bad output {tuple(rgb.shape)}")
        check(float(rgb.max()) > 0.1, f"{name} is black")
        if cfg.camera_model == CameraModel.FISHEYE:
            check(not bool(rgb[0, 0].any()) and not bool(rgb[-1, -1].any()),
                  f"{name}: a corner outside the image circle is not black")
    m, g, s = (launches[k] for k in frames)
    check(m["march_segment"] == 2 and m["march_block"] == 0 and m["closest_hit"] == 0,
          f"fisheye_mirror: the planar path runs two K1 segments, no K4, no block march ({m})")
    for name, n in (("fisheye_glass_front", g), ("sh3_glass_front", s)):
        check(n["march_segment"] >= 1 and n["march_block"] >= 1 and n["closest_hit"] >= 2,
              f"{name}: K4 and K1's segment and block modes must launch ({n})")
    check(s["march_sh"] == s["march"], f"sh3_glass_front: a K1 launch was not at SH 3 ({s})")
    check(all(n["scan"] > 0 for n in launches.values()), "a mesh camera frame did not launch K2")
    log("meshcam", f"fisheye mirror, fisheye glass_front and SH 3 glass_front frames through "
                   f"GaussianRayTracer, launches {launches}")

    # the kernels on every bounce of each frame's own calls
    records = {}
    for name, (sc, cfg, _, _, _, mesh) in frames.items():
        records[name] = []
        kmesh.render_with_mesh(sc, mesh, mcam, cfg, record=records[name])
        torch.cuda.synchronize()
    check(len(records["fisheye_mirror"]) == 2 and "k4" not in records["fisheye_mirror"][0],
          "fisheye_mirror: the planar path records two K1 calls")
    k4_err = seg_err = block_err = 0.0
    for name, record in records.items():
        for b, rec in enumerate(record):
            if "k4" in rec:
                k4_err = max(k4_err, k4_check("K4cam", f"{name} bounce {b}", *rec["k4"])[0])
            args, kw = rec["k1"]
            block = "blocks" in kw
            modes = [(args[3].order, args)]
            if name.startswith("sh3") and b <= 1:  # every order (and block_sub 2) at SH 3
                modes = [(o, (*args[:3], args[3].replace(order=o), args[4]))
                         for o in ("window", "key", "merge")]
            for order, a in modes:
                for bsub in ((1, 2) if block and name.startswith("sh3") and b == 1 else (1,)):
                    a2, kw2 = (a, kw) if bsub == 1 else ((*a[:4], 2 * a[4]),
                                                        {**kw, "block_sub": bsub})
                    what = (f"{name} bounce {b} {'block' if block else 'segment'} {order}"
                            f"{' block_sub=2' if bsub == 2 else ''} ({int(a[0][-1])} slots)")
                    err = k1_check("K1cam", what, a2, kw2)
                    if block:
                        block_err = max(block_err, err)
                    else:
                        seg_err = max(seg_err, err)

    # each frame: kernel path vs plain path, frame times, profiles
    frame_ms = {}
    for name, (sc, cfg, _, _, _, mesh) in frames.items():
        run = lambda meth, aux=False: render(sc, mcam, cfg, mesh=mesh, method=meth,
                                             return_aux=aux)
        out, plain = run("gpu", True), {}
        plain_ms = cuda_ms(lambda: plain.update(run("plain", True)), 1)[0]  # timed and compared
        p = psnr(out["rgb"].cpu().numpy(), plain["rgb"].cpu().numpy())
        check(out["aux"]["pair_dropped"] == 0, f"{name}: pairs dropped")
        check(out["aux"].get("block_dropped") == plain["aux"].get("block_dropped"),
              f"{name}: block_dropped differs between kernel and plain paths")
        check(p >= PSNR_MESH_FRAME, f"{name} gpu vs plain frame PSNR {p:.2f} < {PSNR_MESH_FRAME}")
        run("gpu")  # warm-up
        frame_ms[name] = statistics.median(cuda_ms(lambda: run("gpu"), 10))
        prof = profile_frames(lambda: run("gpu"), frames=2)
        log("frame", f"{name} 1280x720, median of 10/1: gpu {frame_ms[name]:.3f} ms, plain "
                     f"{plain_ms:.3f} ms; gpu vs plain {p:.2f} dB; aux gpu {out['aux']} plain "
                     f"{plain['aux']} ({card})")
        log("profile", f"{name}: device busy {prof['device_ms']:.3f} ms of a "
                       f"{frame_ms[name]:.3f} ms frame (idle share "
                       f"{1.0 - prof['device_ms'] / frame_ms[name]:.3f}), "
                       f"{prof['device_ops']:.0f} device ops per frame, top {prof['top']} ({card})")

    # 256x256 plane frames against the mesh oracle, on the small goldens'
    # scene: a NORMAL plane (K4, then K1 segments ending on the plane) at
    # the golden bar; a GLASS plane logged beside it, whose bounced block
    # march composites the Morton blocks in centre-distance order (the JAX
    # fast path's own approximation, tests/test_torch_mesh_cameras.py)
    small = random_scene(5000, seed=3, device=dev)
    c256 = cameras.Camera.create(eye=GOLDEN_EYE, lookat=(0.0, 0.0, 0.0), width=256, height=256,
                                 device=dev)
    for mtype in (MeshType.NORMAL, MeshType.GLASS):
        plane = make_plane((0.0, 0.0, 1.6), device=dev).with_type(mtype)
        for what, cfg in (("fisheye", fish), ("sh3", bench.replace(sh_degree=3))):
            fast = render(small, c256, cfg, mesh=plane, method="gpu", return_aux=True)
            ref = render(small, c256, cfg, mesh=plane, method="oracle")
            p = psnr(fast["rgb"].cpu().numpy(), ref["rgb"].cpu().numpy())
            log("meshcam", f"5k 256x256 {what} {mtype.name} plane at (0, 0, 1.6): fast path vs "
                           f"mesh oracle {p:.2f} dB, aux {fast['aux']}")
            if mtype == MeshType.NORMAL:
                check(p >= PSNR_GOLDEN, f"{what} plane frame vs mesh oracle {p:.2f} < "
                                        f"{PSNR_GOLDEN}")

    # the new modes alone at these frames' shapes
    def k1_time(args, kw):
        return (statistics.median(cuda_ms(lambda: kmarch.march(*args, **kw), 20)),
                statistics.median(cuda_ms(lambda: kmarch.march_plain(*args, **kw), 3)),
                march_bound(args, kw, kmarch.march_plain),
                design("march", args[3], args[4], scalar="origins_t" in kw, call=(args, kw)))

    def k4_time(args, kw):
        return (statistics.median(cuda_ms(lambda: ktri.closest_hit_blocks(*args, **kw), 20)),
                statistics.median(cuda_ms(lambda: ktri.closest_hit_blocks_plain(*args, **kw), 3)),
                tri_bound(args, kw), {})

    times = {"seg_fish": k1_time(*records["fisheye_glass_front"][0]["k1"]),
             "seg_sh3": k1_time(*records["sh3_glass_front"][0]["k1"]),
             "block_sh3": k1_time(*records["sh3_glass_front"][1]["k1"]),
             "k4_fish0": k4_time(*records["fisheye_glass_front"][0]["k4"]),
             "k4_fish1": k4_time(*records["fisheye_glass_front"][1]["k4"])}
    for what, (ms, plain_ms, (b_ms, b_by), _) in times.items():
        log("kernel", f"{what}: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}) ({card})")

    src = f"{PKG}/csrc"
    k1 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    row = lambda name, source, replaces, launches, err, t, more=None: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
        "bound_ms": t[2][0], "bound_by": t[2][1], "library_ms": None, **t[3], **(more or {})}
    fish_segments = m["march_segment"] + g["march_segment"]
    k4b0 = times["k4_fish0"]
    return [
        row("march_segment_fisheye", "march.cuh", k1, fish_segments, seg_err, times["seg_fish"]),
        row("march_segment_sh3", "march_sh3.cu", k1, s["march_segment"], seg_err,
            times["seg_sh3"]),
        row("march_block_sh3", "march_sh3.cu", k1, s["march_block"], block_err,
            times["block_sh3"]),
        row("closest_hit_fisheye", "tri.cu", "gaussian_ray_tracing_tpu/ops/pallas_tri.py:77",
            g["closest_hit"], k4_err, times["k4_fish1"],
            more={"bounce0": {"ms": k4b0[0], "plain_ms": k4b0[1], "bound_ms": k4b0[2][0],
                              "bound_by": k4b0[2][1]}}),
    ]


def serving_phase(dev, card: str, scene) -> None:
    """The viewer and the serving CLI at full width. viewer.serve(port=0,
    block=False) on `scene` (random_scene(100k, seed 0)) at 1280x720, bench
    config, and a second server on the same scene at SH 3; over HTTP, with
    the launch counts zeroed just before: a pinhole and a fisheye frame,
    then (after /add?kind=plane) a fisheye mirror frame, and from the SH 3
    server (after /add?kind=sphere) a glass frame; each frame three times,
    each a 1280x720 PNG, each request's ms logged; K1, K2 and K4 launched.
    Then `cli orbit` (2 frames), `cli warmup --assert` and `cli bench`
    at 1280x720 on 100k, through cli.main in this process."""
    import urllib.request

    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch.config import RenderConfig
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri
    from gaussian_ray_tracing_tpu_torch.viewer import serve

    bench = RenderConfig(**BENCH_KW)
    t0 = time.perf_counter()
    servers = [serve(GaussianRayTracer(scene=scene, config=cfg), port=0, width=1280, height=720,
                     block=False) for cfg in (bench, bench.replace(sh_degree=3))]
    log("viewer", f"two servers up (a warm frame each) in {time.perf_counter() - t0:.1f} s")
    counters = ((kmarch.march, "launches"), (kscan.multi_cumsum_i32, "launches"),
                (ktri.closest_hit_blocks, "launches"))
    view = "/frame?az=0&el=6&r=2.8"
    requests = [(0, view, "pinhole"), (0, view + "&fisheye=1", "fisheye"),
                (0, "/add?kind=plane", None),
                (0, view + "&fisheye=1&type=mirror", "fisheye mirror"),
                (1, "/add?kind=sphere", None), (1, view + "&type=glass", "SH 3 glass")]
    frames = {}
    try:
        for fn, attr in counters:
            setattr(fn, attr, 0)
        for i, path, what in requests:
            url = f"http://127.0.0.1:{servers[i].server_address[1]}{path}"
            ms = []
            for _ in range(3 if what else 1):
                t = time.perf_counter()
                body = urllib.request.urlopen(url, timeout=300).read()
                ms.append((time.perf_counter() - t) * 1e3)
            if what:
                img = _png_pixels(body)
                check(img.shape == (720, 1280 * 3) and img.max() > 0,
                      f"viewer {what} frame: not a 1280x720 PNG, or black")
                frames[what] = img
                log("viewer", f"{what} frame: {' '.join(f'{x:.1f}' for x in ms)} ms per request "
                              f"({card})")
        launches = [getattr(fn, attr) for fn, attr in counters]
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    check(all(n > 0 for n in launches), f"viewer: K1, K2 and K4 must launch ({launches})")
    check(not np.array_equal(frames["fisheye mirror"], frames["fisheye"]),
          "viewer: the mirror does not show")
    check(not frames["fisheye"][0, :3].any(), "viewer: the fisheye corner is not black")
    log("viewer", f"launches K1 {launches[0]}, K2 {launches[1]}, K4 {launches[2]}")

    size = ("--synthetic", "100000", "--width", "1280", "--height", "720")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        run_cli("orbit", *size, "--frames", "2", "-o", tmp)
        for k in range(2):
            img = _png_pixels(Path(tmp) / f"frame_{k:04d}.png")
            check(img.shape == (720, 1280 * 3) and img.max() > 0, f"cli orbit frame {k}")
    warm = [json.loads(x) for x in run_cli("warmup", "--assert").splitlines()]
    check(len(warm) == 5 and warm[-1]["psnr_vs_golden"] >= PSNR_GOLDEN
          and warm[-1]["n_dropped"] == 0, f"cli warmup --assert: {warm[-1]}")
    res = json.loads(run_cli("bench", *size, "--hit-multiplicity", "1", "--order", "window",
                             "--march-chunk", "128"))
    check(all(k in res for k in ("metric", "value", "unit", "mean_ms", "backend"))
          and res["device"] == torch.cuda.get_device_name(0), f"cli bench: {res}")


def oracle_goldens(golden, card: str) -> dict:
    """The exact torch oracle on the card against the small goldens (float16
    frames of the same oracle) at PSNR_ORACLE, and against pinhole_720p if
    one frame there is estimated (from its first 4096 rays, timed) below
    ORACLE_720P_S. Returns {name: frame ms}."""
    import statistics as st

    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig
    from gaussian_ray_tracing_tpu_torch.models.oracle import render_oracle, render_rays_oracle
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    times = {}
    for name in ("small_pinhole_256", "small_hm2_256", "small_fisheye_256", "pinhole_720p"):
        ref, scene, cam, hm, model = golden(name)
        cfg = RenderConfig(hit_multiplicity=hm, camera_model=model)
        out = {}
        run = lambda: out.update(render_oracle(scene, cam, cfg))
        with torch.no_grad():
            if name == "pinhole_720p":
                _, dirs, _ = cameras.generate_rays(cam, cfg)
                d = dirs.reshape(-1, 3)[:4096].contiguous()
                o = cam.eye.expand(d.shape).contiguous()
                part = lambda: render_rays_oracle(scene, o, d, cfg)
                part()  # warm-up
                ms = st.median(cuda_ms(part, 3))
                est = ms * cam.width * cam.height / 4096 / 1e3
                log("oracle", f"{name}: 4096 rays in {ms:.2f} ms, a frame estimated at "
                              f"{est:.1f} s ({card})")
                if est >= ORACLE_720P_S:
                    continue
            else:
                run()  # warm-up
            times[name] = cuda_ms(run, 1)[0]
        p = psnr(out["rgb"].cpu().numpy(), ref)
        log("oracle", f"{name}: torch oracle PSNR {p:.2f} dB vs the golden, "
                      f"{times[name]:.1f} ms per frame ({card})")
        check(p >= PSNR_ORACLE, f"oracle {name} PSNR {p:.2f} < {PSNR_ORACLE}")
    return times


def merge_phase(dev, card: str, scene, pose, mcam, at_probe, front, merge_err: float) -> list:
    """Merge order at full size. K1's merge mode against its plain version
    at SH 3 on data/fitted_20k.ply's 1280x720 stream (the camera phase's).
    The main path: 1280x720 frames of `scene` (random_scene(100k, seed 0))
    from `pose`, hm 1, order="merge", c=128, through GaussianRayTracer with
    the launch counts zeroed just before; drop-free, kernel vs plain, frame
    and kernel times (window order on the same stream beside them). Then
    phase 7's mirror, glass and glass_front frames with order and
    bounce_order "merge" through GaussianRayTracer (counts zeroed before
    each), kernel path vs plain path, and K1 against its plain version on
    every bounce of the glass_front frame (segment and block mode).
    `merge_err` is phase 3's. Returns the kernel rows."""
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as kmesh
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_pair_stream
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    def stream_args(sc, cam, cfg, cap=1 << 16):
        stream, feats, n_pairs = prepare_pair_stream(sc, cam, cfg, cap)
        dirs_t = tile_rays(cameras.generate_rays(cam, cfg)[1], cfg.tile_w, cfg.tile_h)
        return (stream.starts, feats, dirs_t, cfg, chunk_for(cfg)), n_pairs

    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    cam720 = cameras.Camera.create(eye=GOLDEN_EYE, lookat=(0.0, 0.0, 0.0), width=1280,
                                   height=720, device=dev)
    sh3 = RenderConfig(hit_multiplicity=1, order="merge", march_chunk=128, sh_degree=3)
    merge_err = max(merge_err, k1_check("K1merge", "fitted_20k 720p sh3 c=128",
                                        stream_args(ply, cam720, sh3)[0]))

    # the main path: merge frames through GaussianRayTracer
    cfg = RenderConfig(hit_multiplicity=1, order="merge", march_chunk=128)
    tracer = GaussianRayTracer(scene=scene, config=cfg)
    tracer.set_size(1280, 720)
    tracer.update_camera(pose)
    frames = 3
    kmarch.march.launches = kmarch.march.merge_launches = kscan.multi_cumsum_i32.launches = 0
    for i in range(frames):
        rgb = tracer.render()["rgb"]
        torch.cuda.synchronize()
        check(tuple(rgb.shape) == (720, 1280, 3) and bool(torch.isfinite(rgb).all())
              and float(rgb.max()) > 0.1, f"merge frame {i}: bad or black output")
    main = {"march_merge": kmarch.march.merge_launches, "march": kmarch.march.launches,
            "scan": kscan.multi_cumsum_i32.launches}
    check(main["march_merge"] == frames and main["march"] == frames and main["scan"] > 0,
          f"merge frames: K1 merge must launch once a frame, K2 at all: {main}")
    gpu = render(scene, pose, cfg, method="gpu", return_aux=True)
    plain = render(scene, pose, cfg, method="plain", return_aux=True)
    p = psnr(gpu["rgb"].cpu().numpy(), plain["rgb"].cpu().numpy())
    check(gpu["aux"]["n_dropped"] == 0, "merge frame: pairs dropped")
    check(p >= PSNR_FRAME, f"merge frame gpu vs plain PSNR {p:.2f} < {PSNR_FRAME}")
    tracer.render()  # warm-up
    frame_ms = statistics.median(cuda_ms(tracer.render, 10))
    frame_plain = statistics.median(cuda_ms(lambda: tracer.render(method="plain"), 2))
    log("merge", f"1280x720 100k order=merge c=128: {frames} frames through "
                 f"GaussianRayTracer, launches {main} ({main['march_merge'] / frames:.0f} K1 "
                 f"merge per frame), {gpu['aux']['n_pairs']} pairs, n_dropped 0, gpu vs plain "
                 f"{p:.2f} dB; frame median of 10/2: gpu {frame_ms:.3f} ms, plain "
                 f"{frame_plain:.3f} ms ({card})")
    args, n_pairs = stream_args(scene, pose, cfg, tracer._pair_capacity)
    merge_err = max(merge_err, k1_check("K1merge", "100k 720p c=128", args))
    t_merge = (statistics.median(cuda_ms(lambda: kmarch.march(*args), 20)),
               statistics.median(cuda_ms(lambda: kmarch.march_plain(*args), 3)),
               march_bound(args, {}, kmarch.march_plain), design("march", cfg, 128))
    win = (*args[:3], cfg.replace(order="window"), 128)
    win_ms = statistics.median(cuda_ms(lambda: kmarch.march(*win), 20))
    log("kernel", f"K1 merge 100k 720p ({n_pairs} pairs, c=128): {t_merge[0]:.3f} ms, plain "
                  f"{t_merge[1]:.3f} ms, bound {t_merge[2][0]:.4f} ms ({t_merge[2][1]}); K1 "
                  f"window on the same stream {win_ms:.3f} ms ({card})")

    # mesh frames with order and bounce_order "merge"
    mcfg = cfg.replace(bounce_order="merge")
    mtracer = GaussianRayTracer(scene=scene, config=mcfg)
    mtracer.set_size(1280, 720)
    mtracer.update_camera(mcam)
    counters = {"march_merge": (kmarch.march, "merge_launches"),
                "march_merge_block": (kmarch.march, "merge_block_launches"),
                "march_segment": (kmarch.march, "segment_launches"),
                "closest_hit": (ktri.closest_hit_blocks, "launches")}
    count = lambda: {k: getattr(fn, a) for k, (fn, a) in counters.items()}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    # the mirror and glass at phase 7's probe, and the glass sphere in front
    # of the shell (glass_front), whose bounced rays live: there the block
    # march has work (at the probe every bounced ray is transmittance-dead
    # and the loop may stop after bounce 0)
    at_front = at_probe.copy()
    at_front[:3, 3] = (0.0, 0.0, 1.6)
    mesh_launches, meshes = {}, {}
    for kind, place in (("mirror", at_probe), ("glass", at_probe), ("glass_front", at_front)):
        before = count()
        idx = (mtracer.create_plane(mesh_type=kind) if kind == "mirror"
               else mtracer.create_sphere(mesh_type="glass"))
        mtracer.update_instance_transform(idx, place)
        rgb = mtracer.render()["rgb"]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(rgb).all()) and float(rgb.max()) > 0.1,
              f"merge {kind} frame: bad or black output")
        mesh_launches[kind] = {k: v - before[k] for k, v in count().items()}
        meshes[kind] = mtracer.primitives[idx]
        mtracer.remove_primitive(idx)
    mesh_counts = count()
    m, g, f = (mesh_launches[k] for k in ("mirror", "glass", "glass_front"))
    check(m["march_merge"] == 2 and m["march_segment"] == 2,
          f"merge mirror frame: the planar path runs two K1 merge segments ({m})")
    check(g["march_merge"] >= 1 and g["closest_hit"] >= 1,
          f"merge glass frame: K4 and K1 merge must launch ({g})")
    check(f["march_merge_block"] >= 1 and f["closest_hit"] >= 2,
          f"merge glass_front frame: K4 and K1's merge block mode must launch ({f})")
    log("merge", f"mirror, glass and glass_front frames, order/bounce_order merge, launches "
                 f"{mesh_launches}")
    for kind, mesh in meshes.items():
        gpu = render(scene, mcam, mcfg, mesh=mesh, method="gpu", return_aux=True)
        plain = render(scene, mcam, mcfg, mesh=mesh, method="plain", return_aux=True)
        p = psnr(gpu["rgb"].cpu().numpy(), plain["rgb"].cpu().numpy())
        check(gpu["aux"] == plain["aux"] and gpu["aux"]["pair_dropped"] == 0,
              f"merge {kind}: aux {gpu['aux']} vs plain {plain['aux']}")
        check(p >= PSNR_MESH_FRAME, f"merge {kind} gpu vs plain PSNR {p:.2f}")
        run = lambda: render(scene, mcam, mcfg, mesh=mesh, method="gpu")
        run()  # warm-up
        log("frame", f"merge {kind} 1280x720 100k: gpu {statistics.median(cuda_ms(run, 5)):.3f} "
                     f"ms (median of 5), gpu vs plain {p:.2f} dB, aux {gpu['aux']} ({card})")
    record = []
    kmesh.render_with_mesh_fast(scene, front, mcam, mcfg, record=record)
    torch.cuda.synchronize()
    check(len(record) >= 2, f"merge glass_front ran {len(record)} bounces")
    block_err = 0.0
    for b, rec in enumerate(record):
        a, kw = rec["k1"]
        mode = "block" if kw.get("blocks") is not None else "segment"
        err = k1_check("K1merge", f"glass_front bounce {b} ({mode}, {int(a[0][-1])} slots)",
                       a, kw)
        if mode == "block":
            block_err = max(block_err, err)
        else:
            merge_err = max(merge_err, err)
    blk_args, blk_kw = record[1]["k1"]
    t_block = (statistics.median(cuda_ms(lambda: kmarch.march(*blk_args, **blk_kw), 20)),
               statistics.median(cuda_ms(lambda: kmarch.march_plain(*blk_args, **blk_kw), 3)),
               march_bound(blk_args, blk_kw, kmarch.march_plain),
               design("march", blk_args[3], blk_args[4], scalar=True))
    log("kernel", f"K1 merge block glass_front bounce 1: {t_block[0]:.3f} ms, plain "
                  f"{t_block[1]:.3f} ms, bound {t_block[2][0]:.4f} ms ({t_block[2][1]}) "
                  f"({card})")
    # the merge kernel's design rests on two resident 256-ray blocks per SM
    # (blocks_per_sm: four measured slower, its buffers spill out of L1)
    for what, t in (("100k 720p", t_merge), ("block glass_front bounce 1", t_block)):
        check(t[3]["blocks_per_sm"] == 2,
              f"K1 merge {what}: {t[3]['blocks_per_sm']} resident blocks per SM, not 2")

    src = f"{PKG}/csrc/march.cuh"
    row = lambda name, launches, err, t: {
        "name": name, "route": "cuda", "source": src,
        "replaces": "gaussian_ray_tracing_tpu/ops/pallas_march.py:195", "launches": launches,
        "max_abs_err": err, "ms": t[0], "plain_ms": t[1], "bound_ms": t[2][0],
        "bound_by": t[2][1], "library_ms": None, **t[3]}
    return [row("march_merge", main["march_merge"], merge_err, t_merge),
            row("march_merge_block", mesh_counts["march_merge_block"], block_err, t_block)]


def any_chunk_phase(dev, card: str, scene, pose, views, init, mcam, front) -> list:
    """Key and oddeven order at march chunks other than 32, 64, 128 and 256,
    at full width. The main path, each count zeroed just before and read
    just after: the 1280x720 headline (`scene` = random_scene(100k, seed 0)
    at `pose`, hm 1) through render(method="gpu") in key order at chunk 96
    and in oddeven at chunk 100 (K1's key kernel on its 128-candidate
    build); Trainer(method="gpu").fit, 3 key-order steps at 512x512 on
    `init` (random_scene(50k, seed 1)) at chunk 96 (K1 saved carries, K3's
    key replay); the glass_front mesh frame (`front` before `mcam`) under
    order and bounce_order "key" at chunk 256 x bounce_blocks_per_chunk 2
    (K1's block mode over 512 rows, staged in two pieces). Then every
    launch of those kernels on the main path's own inputs against its plain
    version (the K1 and K3 bars, no caught failure, no fallback), and each
    timed in turns with the same call at chunk 128 (block mode: glass_front
    at 128 x 1). Returns the kernel rows."""
    import math

    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig
    from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as kmesh
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        prepare_pair_stream, prepare_train_stream, snug_pair_capacity,
    )
    from gaussian_ray_tracing_tpu_torch.models.renderer import render
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri
    from gaussian_ray_tracing_tpu_torch.ops.tiles import count_pairs
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    t_phase = time.perf_counter()
    base = RenderConfig(hit_multiplicity=1, order="key")
    key96, odd100 = base.replace(march_chunk=96), base.replace(order="oddeven", march_chunk=100)
    train96 = RenderConfig(**{**TRAIN_KW, "march_chunk": 96})
    mesh_cfg = base.replace(bounce_order="key", march_chunk=256, bounce_blocks_per_chunk=2)

    # --- the main path, each count zeroed just before ---
    frames, launches = {}, {}
    for name, cfg, attr in (("key 96", key96, "launches"), ("oddeven 100", odd100,
                                                             "oddeven_launches")):
        kmarch.march.launches = kmarch.march.oddeven_launches = 0
        out = render(scene, pose, cfg, method="gpu", return_aux=True)
        torch.cuda.synchronize()
        launches[name] = getattr(kmarch.march, attr)
        check(launches[name] == 1 and kmarch.march.launches == 1,
              f"{name}: K1 launches {kmarch.march.launches}")
        rgb = out["rgb"]
        check(tuple(rgb.shape) == (720, 1280, 3) and bool(torch.isfinite(rgb).all())
              and float(rgb.max()) > 0.1, f"{name}: bad frame")
        check(out["aux"]["n_dropped"] == 0, f"{name}: pairs dropped")
        frames[name] = rgb
    kmarch.march.save_tin_launches = kbwd.march_bwd.key_launches = 0
    trainer = ktrain.Trainer(GaussianModel.from_scene(init), config=train96, lr=2e-3,
                             method="gpu")
    losses = trainer.fit([views[0]], steps=3)
    torch.cuda.synchronize()
    launches["train 96"] = (kmarch.march.save_tin_launches, kbwd.march_bwd.key_launches)
    check(launches["train 96"] == (3, 3), f"training at chunk 96: K1 save_tin / K3 launches "
                                          f"{launches['train 96']}")
    check(all(math.isfinite(x) for x in losses), f"training at chunk 96: losses {losses}")
    kmarch.march.block_launches = ktri.closest_hit_blocks.launches = 0
    mesh_out = render(scene, mcam, mesh_cfg, mesh=front, method="gpu", return_aux=True)
    torch.cuda.synchronize()
    launches["block 256x2"] = (kmarch.march.block_launches, ktri.closest_hit_blocks.launches)
    check(launches["block 256x2"][0] >= 1 and launches["block 256x2"][1] >= 2,
          f"glass_front at 256 x 2: K1 block / K4 launches {launches['block 256x2']}")
    check(bool(torch.isfinite(mesh_out["rgb"]).all()) and float(mesh_out["rgb"].max()) > 0.1,
          "glass_front at 256 x 2: bad frame")
    ref128 = render(scene, pose, base.replace(march_chunk=128), method="gpu")["rgb"]
    db = {k: psnr(v.cpu().numpy(), ref128.cpu().numpy()) for k, v in frames.items()}
    log("anychunk", f"main path: 1280x720 100k frames key c=96 and oddeven c=100 ({db} dB "
                    f"against key c=128), 3 key training steps 512x512 50k c=96 losses "
                    f"{[losses[0], losses[-1]]}, glass_front key 256 x 2; launches "
                    f"{json.dumps({k: v for k, v in launches.items()})}")

    # --- every launch against its plain version, timed in turns with c=128 ---
    dirs_t = tile_rays(cameras.generate_rays(pose, base)[1], 16, 16)
    cap = snug_pair_capacity(int(count_pairs(scene, pose, base)))

    def args_at(cfg, chunk):
        stream, feats, _ = prepare_pair_stream(scene, pose, cfg, cap)
        return stream.starts, feats, dirs_t, cfg, chunk

    rows_out = {}
    for name, cfg, c in (("key", key96, 96), ("oddeven", odd100, 100)):
        args = args_at(cfg, c)
        ref = args_at(cfg.replace(march_chunk=128), 128)
        err = k1_check("K1anychunk", f"{name} 720p c={c}", args)
        again = kmarch.march(*args), kmarch.march(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(*again)), f"K1 {name} c={c}: two launches "
                                                              f"differ")
        t = turns({f"c{c}": lambda a=args: kmarch.march(*a),
                   "c128": lambda a=ref: kmarch.march(*a)})
        t0 = time.perf_counter()
        kmarch.march_plain(*args)
        plain_ms = (time.perf_counter() - t0) * 1e3
        b = march_bound(args, {}, kmarch.march_plain)
        d = design("march", cfg, c)
        rows_out[name] = (err, t[f"c{c}"], t["c128"], plain_ms, b, d)
        log("anychunk", f"K1 {name} 720p c={c}: {t[f'c{c}'][0]:.3f} ms event, "
                        f"{fms(t[f'c{c}'][1])} device (c=128 {t['c128'][0]:.3f} / "
                        f"{fms(t['c128'][1])}), bound {b[0]:.4f} ({b[1]}), plain {plain_ms:.1f} "
                        f"({card})")

    cam0 = views[0][0]
    dirs0 = tile_rays(cameras.generate_rays(cam0, train96)[1], 16, 16)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_rgb = torch.randn(dirs0.shape, generator=gen, device=dev)
    d_t = torch.randn(dirs0.shape[:2], generator=gen, device=dev)
    train = {}
    for c in (96, 128):
        cfg = train96.replace(march_chunk=c)
        with torch.no_grad():
            stream, trows, n_t = prepare_train_stream(trainer.model.activate(), cam0, cfg)
        train[c] = (stream.starts, trows.detach().contiguous(), n_t, cfg)
    starts, trows, n_t, cfg = train[96]
    fwd = lambda f, c=96: f(train[c][0], train[c][1], dirs0, train[c][3], c, save_tin=True)
    got = fwd(kmarch.march)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fwd(kmarch.march_plain)
    k1_plain = (time.perf_counter() - t0) * 1e3
    e1 = k1_train_check(f"key save_tin 512x512 c=96 ({n_t} pairs)", got, want)
    b1 = march_bound((starts, trows, dirs0, cfg, 96), {}, kmarch.march_plain, tin=got[2])
    d1 = design("march", cfg, 96, train=True)
    bargs = (starts, trows, dirs0, cam0.eye, got[2], got[3], d_rgb, d_t, cfg, 96)
    e3 = k3_check("key 512x512 c=96", bargs)
    t0 = time.perf_counter()
    kbwd.march_bwd_plain(*bargs)
    k3_plain = (time.perf_counter() - t0) * 1e3
    b3 = bwd_bound(bargs, kbwd.march_bwd_plain)
    d3 = design("march_bwd", cfg, 96)
    got128 = fwd(kmarch.march, 128)
    bargs128 = (*train[128][:2], dirs0, cam0.eye, got128[2], got128[3], d_rgb, d_t,
                train[128][3], 128)
    t1 = turns({"c96": lambda: fwd(kmarch.march), "c128": lambda: fwd(kmarch.march, 128)})
    t3 = turns({"c96": lambda: kbwd.march_bwd(*bargs), "c128": lambda: kbwd.march_bwd(*bargs128)})
    log("anychunk", f"key training 512x512 c=96 ({n_t} pairs): K1 save_tin {t1['c96'][0]:.3f} ms "
                    f"event, {fms(t1['c96'][1])} device (c=128 {t1['c128'][0]:.3f} / "
                    f"{fms(t1['c128'][1])}), bound {b1[0]:.4f} ({b1[1]}), plain {k1_plain:.1f}; "
                    f"K3 {t3['c96'][0]:.3f} / {fms(t3['c96'][1])} (c=128 {t3['c128'][0]:.3f} / "
                    f"{fms(t3['c128'][1])}), bound {b3[0]:.4f} ({b3[1]}), plain {k3_plain:.1f} "
                    f"({card})")

    records = {}
    for name, cfg in (("256x2", mesh_cfg), ("128x1", mesh_cfg.replace(
            march_chunk=128, bounce_blocks_per_chunk=1))):
        records[name] = []
        kmesh.render_with_mesh_fast(scene, front, mcam, cfg, record=records[name])
        torch.cuda.synchronize()
        check(len(records[name]) >= 2, f"glass_front key {name} ran {len(records[name])} bounces")
    block_err, blk = 0.0, None
    for b_i, rec in enumerate(records["256x2"]):
        a, kw = rec["k1"]
        if kw.get("blocks") is None:
            continue
        check(a[4] == 512 and kw["block_sub"] == 2, f"glass_front bounce {b_i}: block chunk "
                                                    f"{a[4]} / {kw['block_sub']}")
        block_err = max(block_err, k1_check("K1anychunk", f"glass_front key block 256 x 2 "
                                                          f"bounce {b_i} ({int(a[0][-1])} slots)",
                                            a, kw))
        blk = blk or (a, kw)
    check(blk is not None, "glass_front at 256 x 2: no block-mode launch recorded")
    blk128 = records["128x1"][1]["k1"]
    tb = turns({"c512": lambda: kmarch.march(*blk[0], **blk[1]),
                "c128": lambda: kmarch.march(*blk128[0], **blk128[1])})
    t0 = time.perf_counter()
    kmarch.march_plain(*blk[0], **blk[1])
    blk_plain = (time.perf_counter() - t0) * 1e3
    bb = march_bound(blk[0], blk[1], kmarch.march_plain)
    db_ = design("march", blk[0][3], 512, scalar=True)
    log("anychunk", f"K1 key block glass_front bounce 1, 256 x 2 = 512 rows: {tb['c512'][0]:.3f} "
                    f"ms event, {fms(tb['c512'][1])} device (128 x 1 {tb['c128'][0]:.3f} / "
                    f"{fms(tb['c128'][1])}), bound {bb[0]:.4f} ({bb[1]}), plain {blk_plain:.1f} "
                    f"({card})")
    log("phase", f"any chunk in {time.perf_counter() - t_phase:.1f} s")

    src = f"{PKG}/csrc"
    k1 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    k3 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189"
    row = lambda name, source, replaces, n, err, t, t128, plain_ms, b, more: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": n, "max_abs_err": err, "ms": t[0], "plain_ms": plain_ms, "bound_ms": b[0],
        "bound_by": b[1], "library_ms": None, "device_ms": t[1], "c128_ms": t128[0],
        "c128_device_ms": t128[1], **more}
    out = []
    for name, n in (("key", launches["key 96"]), ("oddeven", launches["oddeven 100"])):
        err, t, t128, plain_ms, b, d = rows_out[name]
        out.append(row(f"march_{name}_c{96 if name == 'key' else 100}", "march.cuh", k1, n, err,
                       t, t128, plain_ms, b, d))
    out.append(row("march_key_save_tin_c96", "march.cuh", k1, launches["train 96"][0], e1,
                   t1["c96"], t1["c128"], k1_plain, b1, d1))
    out.append(row("march_bwd_key_c96", "march_bwd.cuh", k3, launches["train 96"][1], e3,
                   t3["c96"], t3["c128"], k3_plain, b3, d3))
    out.append(row("march_key_block_c512", "march.cuh", k1, launches["block 256x2"][0],
                   block_err, tb["c512"], tb["c128"], blk_plain, bb, db_))
    return out


def camera_phase(dev, card: str, scene) -> list:
    """The camera slice at full size (bench.py:178-245): fisheye 768x768 on
    `scene` (random_scene(100k, seed 0)); data/fitted_20k.ply at 1280x720 at
    SH 0 and 3 (window order, and SH 3 in key order); OpenCV distortion
    (-0.25, 0.05, 0, 0) on `scene` at 1280x720; a rolling-shutter 1280x720
    frame of `scene` whose eye moves +0.05 in x during readout. All from
    the bench's eye (0, 0.3, 2.8), bench config. Drives each frame once
    through GaussianRayTracer (render_rolling for the rolling shutter) with
    the launch counts zeroed just before, checks K1's SH and per-ray-origin
    modes against their plain versions (SH 1-3 x window/key x c=128/256 on
    the trained scene), times every frame against the plain path, and
    profiles the fisheye and SH 3 frames. Returns the kernel rows."""
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_pair_stream
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
    from gaussian_ray_tracing_tpu_torch.models.rolling import (
        prepare_rolling_stream, render_rolling,
    )
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    cam = lambda w, h, eye=GOLDEN_EYE: cameras.Camera.create(
        eye=eye, lookat=(0.0, 0.0, 0.0), width=w, height=h, device=dev)
    cam720, cam768 = cam(1280, 720), cam(768, 768)
    cam720_moved = cam(1280, 720, eye=(GOLDEN_EYE[0] + 0.05, GOLDEN_EYE[1], GOLDEN_EYE[2]))
    bench = RenderConfig(**BENCH_KW)
    sh3_key = RenderConfig(hit_multiplicity=1, order="key", march_chunk=256, sh_degree=3)
    # name: (scene, camera, config, the rolling shutter's second camera)
    frames = {
        "fisheye_768": (scene, cam768, bench.replace(camera_model=CameraModel.FISHEYE), None),
        "trained_720p": (ply, cam720, bench, None),
        "trained_720p_sh3": (ply, cam720, bench.replace(sh_degree=3), None),
        "trained_720p_sh3_key": (ply, cam720, sh3_key, None),
        "opencv_720p": (scene, cam720, bench.replace(camera_model=CameraModel.OPENCV,
                                                     distortion=(-0.25, 0.05, 0.0, 0.0)), None),
        "rolling_720p": (scene, cam720, bench, cam720_moved),
    }
    tracers = {}
    for name, (sc, c0, cfg, c1) in frames.items():
        if c1 is None:
            tr = GaussianRayTracer(scene=sc, config=cfg.replace(camera_model=CameraModel.PINHOLE))
            tr.set_camera_model(cfg.camera_model.value)
            tr.set_size(c0.width, c0.height)
            tr.update_camera(c0)
            tracers[name] = tr

    def run(name, method="gpu"):
        sc, c0, cfg, c1 = frames[name]
        if c1 is not None:
            return render_rolling(sc, c0, c1, cfg, use_kernels=method == "gpu")
        return tracers[name].render(method=method)

    def run_aux(name, method):
        sc, c0, cfg, c1 = frames[name]
        if c1 is not None:
            return render_rolling(sc, c0, c1, cfg, return_aux=True, use_kernels=method == "gpu")
        return render(sc, c0, cfg, method=method, return_aux=True)

    # the main path: every frame once, counts zeroed just before
    counters = ("launches", "sh_launches", "sh_key_launches", "origin_launches")
    for attr in counters:
        setattr(kmarch.march, attr, 0)
    kscan.multi_cumsum_i32.launches = 0
    for name, (_, c0, _, _) in frames.items():
        k1, k2 = kmarch.march.launches, kscan.multi_cumsum_i32.launches
        rgb = run(name)["rgb"]
        torch.cuda.synchronize()
        check(kmarch.march.launches > k1 and kscan.multi_cumsum_i32.launches > k2,
              f"{name}: a kernel was not launched")
        check(tuple(rgb.shape) == (c0.height, c0.width, 3) and bool(torch.isfinite(rgb).all()),
              f"{name}: bad output {tuple(rgb.shape)}")
        check(float(rgb.max()) > 0.1, f"{name} is black")
    main = {attr: getattr(kmarch.march, attr) for attr in counters}
    main["scan"] = kscan.multi_cumsum_i32.launches
    log("camera", f"{len(frames)} frames through GaussianRayTracer / render_rolling, "
                  f"launches {main}")
    check(main["sh_launches"] > 0 and main["sh_key_launches"] > 0
          and main["origin_launches"] > 0, f"an SH or per-ray-origin mode did not launch: {main}")
    fish = frames["fisheye_768"]
    check(not bool(run("fisheye_768")["rgb"][0, 0].any()), "fisheye corner not blanked")

    # every frame: drop-free, kernel path vs plain path, frame times
    frame_ms = {}
    for name, (_, c0, _, _) in frames.items():
        gpu, plain = run_aux(name, "gpu"), run_aux(name, "plain")
        p = psnr(gpu["rgb"].cpu().numpy(), plain["rgb"].cpu().numpy())
        check(gpu["aux"]["n_dropped"] == 0, f"{name}: pairs dropped")
        check(gpu["aux"]["n_pairs"] == plain["aux"]["n_pairs"], f"{name}: pair counts differ")
        check(p >= PSNR_FRAME, f"{name} gpu vs plain PSNR {p:.2f} < {PSNR_FRAME}")
        run(name)  # warm-up
        t_gpu = statistics.median(cuda_ms(lambda: run(name), 10))
        t_plain = statistics.median(cuda_ms(lambda: run(name, "plain"), 3))
        frame_ms[name] = t_gpu
        log("frame", f"{name} {c0.width}x{c0.height}, median of 10/3: gpu {t_gpu:.3f} ms, "
                     f"plain {t_plain:.3f} ms; gpu vs plain {p:.2f} dB; "
                     f"{gpu['aux']['n_pairs']} pairs, n_dropped 0 ({card})")

    # K1's SH modes vs plain on the trained scene's 720p streams
    def stream_args(sc, c0, cfg):
        stream, feats, _ = prepare_pair_stream(sc, c0, cfg, 1 << 16)
        dirs_t = tile_rays(cameras.generate_rays(c0, cfg)[1], cfg.tile_w, cfg.tile_h)
        return stream.starts, feats, dirs_t, cfg, chunk_for(cfg)

    sh_err = {"window": 0.0, "key": 0.0}
    for degree in (1, 2, 3):
        for order in ("window", "key"):
            for chunk in (128, 256):
                cfg = RenderConfig(hit_multiplicity=1, order=order, march_chunk=chunk,
                                   sh_degree=degree)
                sh_err[order] = max(sh_err[order], k1_check(
                    "K1cam", f"fitted_20k 720p sh{degree} {order} c={chunk}",
                    stream_args(ply, cam720, cfg)))
    origin_err = 0.0
    for what, sc, cfg in (("100k", scene, bench), ("fitted_20k sh3", ply, bench.replace(sh_degree=3)),
                          ("100k key", scene, bench.replace(order="key"))):
        starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(sc, cam720, cam720_moved, cfg)
        origin_err = max(origin_err, k1_check("K1cam", f"rolling {what} (per-ray origins)",
                                              (starts, rows, dirs_t, cfg, 128),
                                              {"origins_t": origins_t}))

    # the kernels alone at the main path's shapes
    def k1_time(args, kw=None):
        kw = kw or {}
        ms = statistics.median(cuda_ms(lambda: kmarch.march(*args, **kw), 20))
        plain_ms = statistics.median(cuda_ms(lambda: kmarch.march_plain(*args, **kw), 3))
        return ms, plain_ms, march_bound(args, kw, kmarch.march_plain), \
            design("march", args[3], args[4], scalar="origins_t" in kw)

    sh_args = stream_args(ply, cam720, frames["trained_720p_sh3"][2])
    shkey_args = stream_args(ply, cam720, sh3_key)
    fish_args = stream_args(fish[0], fish[1], fish[2])
    starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(scene, cam720, cam720_moved,
                                                                   bench)
    roll_args, roll_kw = (starts, rows, dirs_t, bench, 128), {"origins_t": origins_t}
    # SH 0 on the same stream, to read the SH 3 colour's cost against
    sh0_args = stream_args(ply, cam720, bench)
    sh0key_args = stream_args(ply, cam720, sh3_key.replace(sh_degree=0))
    times = {"sh": k1_time(sh_args), "sh_key": k1_time(shkey_args),
             "sh0": k1_time(sh0_args), "sh0_key": k1_time(sh0key_args),
             "fisheye": k1_time(fish_args), "origin": k1_time(roll_args, roll_kw)}
    for what, args in (("sh", sh_args), ("sh0", sh0_args), ("sh_key", shkey_args),
                       ("sh0_key", sh0key_args), ("fisheye", fish_args), ("origin", roll_args)):
        ms, plain_ms, (b_ms, b_by), _ = times[what]
        log("kernel", f"K1 {what} ({int(args[0][-1])} pairs, row {args[1].shape[1]} floats, "
                      f"c={args[4]}): {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}) ({card})")

    # where the time goes in the fisheye and SH 3 frames
    for name in ("fisheye_768", "trained_720p_sh3"):
        prof = profile_frames(lambda: run(name))
        idle = 1.0 - prof["device_ms"] / frame_ms[name]
        log("profile", f"{name}: device busy {prof['device_ms']:.3f} ms of a "
                       f"{frame_ms[name]:.3f} ms frame (idle share {idle:.3f}), "
                       f"{prof['device_ops']:.0f} device ops per frame, top {prof['top']} ({card})")

    src = f"{PKG}/csrc"
    row = lambda name, source, launches, err, t: {
        "name": name, "route": "cuda", "source": f"{src}/{source}",
        "replaces": "gaussian_ray_tracing_tpu/ops/pallas_march.py:195", "launches": launches,
        "max_abs_err": err, "ms": t[0], "plain_ms": t[1], "bound_ms": t[2][0],
        "bound_by": t[2][1], "library_ms": None, **t[3]}
    return [row("march_sh", "march_sh3.cu", main["sh_launches"], sh_err["window"], times["sh"]),
            row("march_sh_key", "march_sh3.cu", main["sh_key_launches"], sh_err["key"],
                times["sh_key"]),
            row("march_origin", "march.cuh", main["origin_launches"], origin_err,
                times["origin"])]


def per_ray_origin_phase(dev, card: str, scene, init) -> list:
    """JAX's march_stream_diff with per-ray origins, windows and carry-in,
    and the per-ray-origin quad response, at full width. The main path,
    with the launch counts zeroed just before and read just after:
    march_stream_diff (K1 with saved carries, K3) through a rolling shutter
    (models/rolling.prepare_rolling_stream on the training rows; the eye
    moves +0.05 in x during readout, as the camera phase's pair) of `init`
    (random_scene(50k, seed 1), the training scene of phase 6) at 512x512
    from the bench's eye, with per-ray windows t_lo = 0.05 + 0.05 U, t_hi =
    3 + U and carry-in 0.6 + 0.4 U from a seeded generator
    (tests/test_pallas.py:364-368), gradients to the model's parameters:
    key order on the scalar response and on the per-ray-origin quad one and
    window order at SH 0, and key and window order on data/fitted_20k.ply
    at SH 3; then the rolling-shutter 1280x720 frame of `scene`
    (random_scene(100k, seed 0)) on the per-ray-origin quad response (K1,
    window order, bench config). Each K1 and K3 launch held against its
    plain version on the same inputs (K3 also against the float64 witness
    and across two launches), the quad frame also in key and merge order,
    and in key order against the scalar response of the same rays (window
    and merge order logged); the kernels timed against their plain
    versions. Returns the kernel rows."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_pair_stream
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    cam = lambda w, h, dx=0.0: cameras.Camera.create(
        eye=(GOLDEN_EYE[0] + dx, GOLDEN_EYE[1], GOLDEN_EYE[2]), lookat=(0.0, 0.0, 0.0),
        width=w, height=h, device=dev)
    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    key0 = RenderConfig(**TRAIN_KW)  # key order, chunk 256
    win0 = RenderConfig(hit_multiplicity=1, order="window", march_chunk=128)
    # name: (scene, config, quad)
    runs = {"key_sh0": (init, key0, False), "key_sh0_quad": (init, key0, True),
            "window_sh0": (init, win0, False),
            "key_sh3": (ply, key0.replace(sh_degree=3), False),
            "window_sh3": (ply, win0.replace(sh_degree=3), False)}
    gen = torch.Generator(device=dev).manual_seed(15)
    inputs = {}
    for name, (sc, cfg, quad) in runs.items():
        model = GaussianModel.from_scene(sc).requires_grad_(True)
        starts, rows, dirs_t, origins_t, _, n_pairs = prepare_rolling_stream(
            model.activate(), cam(512, 512), cam(512, 512, 0.05), cfg, train=True)
        shape = dirs_t.shape[:2]
        seg = dict(origins_t=origins_t,
                   t_lo=0.05 + 0.05 * torch.rand(shape, generator=gen, device=dev),
                   t_hi=3.0 + torch.rand(shape, generator=gen, device=dev),
                   t0=0.6 + 0.4 * torch.rand(shape, generator=gen, device=dev))
        w = torch.randn(dirs_t.shape, generator=gen, device=dev)
        inputs[name] = (model, starts, rows, dirs_t, seg, w, n_pairs)
    bench = RenderConfig(**BENCH_KW)
    frame = prepare_rolling_stream(scene, cam(1280, 720), cam(1280, 720, 0.05), bench, train=True)

    # --- the main path, every count zeroed just before ---
    k1_counts = ("launches", "key_scalar_save_tin_launches", "window_save_tin_launches",
                 "sh_save_tin_launches", "origin_quad_save_tin_launches", "origin_quad_launches")
    for attr in k1_counts:
        setattr(kmarch.march, attr, 0)
    kbwd.march_bwd.launches = kbwd.march_bwd.origin_launches = 0
    losses = {}
    for name, (sc, cfg, quad) in runs.items():
        model, starts, rows, dirs_t, seg, w, _ = inputs[name]
        rgb, t_final = kbwd.march_stream_diff(rows, starts, dirs_t, torch.zeros(3, device=dev),
                                              cfg, cfg.march_chunk, quad=quad, **seg)
        loss = torch.sum(rgb * w) + torch.sum(t_final)
        loss.backward()
        torch.cuda.synchronize()
        grads = [p.grad for p in model.parameters()]
        check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads),
              f"per-ray origins {name}: missing or non-finite gradients")
        check(all(bool(g.any()) for g in grads), f"per-ray origins {name}: a zero gradient")
        check(float(t_final.detach().min()) < 0.5, f"per-ray origins {name}: nothing composited")
        losses[name] = float(loss.detach())
    starts_f, rows_f, dirs_f, origins_f, valid_f, n_pairs_f = frame
    rgb_f, t_f = kmarch.march(starts_f, rows_f, dirs_f, bench, 128, origins_t=origins_f, quad=True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rgb_f).all()) and float(rgb_f.max()) > 0.1,
          "per-ray-origin quad frame: black or not finite")
    main = {attr: getattr(kmarch.march, attr) for attr in k1_counts}
    main.update(march_bwd=kbwd.march_bwd.launches, march_bwd_origin=kbwd.march_bwd.origin_launches)
    log("origin", f"march_stream_diff through a 512x512 rolling shutter ({', '.join(runs)}) and "
                  f"a 1280x720 / 100k per-ray-origin quad frame ({n_pairs_f} pairs); losses "
                  f"{json.dumps(losses)}; launches {main}")
    check(all(main[k] > 0 for k in main), f"a per-ray-origin kernel was not launched: {main}")

    # --- each kernel against its plain version on the main path's inputs ---
    t1_err, t3_err = {}, {}
    bargs = {}
    for name, (sc, cfg, quad) in runs.items():
        _, starts, rows, dirs_t, seg, w, _ = inputs[name]
        rows = rows.detach()
        fwd = lambda f: f(starts, rows, dirs_t, cfg, cfg.march_chunk, save_tin=True, quad=quad,
                          **seg)
        got = fwd(kmarch.march)
        torch.cuda.synchronize()
        t1_err[name] = k1_train_check(f"per-ray origins {name}", got, fwd(kmarch.march_plain))
        d_t = torch.ones(dirs_t.shape[:2], device=dev)
        args = (starts, rows, dirs_t, torch.zeros(3, device=dev), got[2], got[3], w, d_t, cfg,
                cfg.march_chunk)
        kw = {k: seg[k] for k in ("origins_t", "t_lo", "t_hi")}
        t3_err[name] = k3_check(f"per-ray origins {name}", args, kw)
        bargs[name] = (args, kw, got[2])
    frame_err = {}
    for order in ("window", "key", "merge"):
        cfg = bench.replace(order=order)
        frame_err[order] = k1_check("K1origin", f"rolling 720p 100k per-ray-origin quad {order}",
                                    (starts_f, rows_f, dirs_f, cfg, 128),
                                    {"origins_t": origins_f, "quad": True})
    # against the scalar response of the same rays: the same function,
    # other rounding. Held in key order, which composites in stream order;
    # window and merge order sort by quantized event t and may order a
    # near-tie either way, which the shared-origin quad and scalar
    # responses of the unmoved camera's frame show as well (logged beside)
    vs_scalar = {}
    shared = {}
    c0 = cam(1280, 720)
    dirs_0 = tile_rays(cameras.generate_rays(c0, bench)[1], 16, 16)
    eye_0 = c0.eye.to(torch.float32).expand(dirs_0.shape).contiguous()
    for order in ("key", "window", "merge"):
        cfg = bench.replace(order=order)
        rgb = [kmarch.march(starts_f, rows_f, dirs_f, cfg, 128, origins_t=origins_f, quad=quad)[0]
               for quad in (True, False)]
        st_q, f_q, _ = prepare_pair_stream(scene, c0, cfg, 1 << 22)
        st_s, f_s, _ = prepare_pair_stream(scene, c0, cfg, 1 << 22, quad=False)
        rgb0 = [kmarch.march(st_q.starts, f_q, dirs_0, cfg, 128)[0],
                kmarch.march(st_s.starts, f_s, dirs_0, cfg, 128, origins_t=eye_0)[0]]
        torch.cuda.synchronize()
        for out, (a, b) in ((vs_scalar, rgb), (shared, rgb0)):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            out[order] = (psnr(a, b), float(np.abs(a - b).max()))
        log("K1origin", f"rolling 720p 100k {order}: per-ray-origin quad vs scalar PSNR "
                        f"{vs_scalar[order][0]:.2f} dB max abs {vs_scalar[order][1]:.3g}; the "
                        f"unmoved camera's shared-origin quad vs scalar {shared[order][0]:.2f} dB "
                        f"max abs {shared[order][1]:.3g}")
    check(vs_scalar["key"][0] >= PSNR_KERNEL, "per-ray-origin quad frame vs the scalar response")

    # --- the kernels alone at the main path's shapes: event ms (the
    # wrapper's host work included) and profiler device ms ---
    def k1_time(args, kw, tin=None):
        fn = lambda: kmarch.march(*args, **kw)
        ms = statistics.median(cuda_ms(fn, 10))
        plain_ms = statistics.median(cuda_ms(lambda: kmarch.march_plain(*args, **kw), 2))
        return (ms, plain_ms, march_bound(args, kw, kmarch.march_plain, tin=tin),
                profile_frames(fn, 10, host=False)["device_ms"])

    def k3_time(name):
        args, kw, _ = bargs[name]
        fn = lambda: kbwd.march_bwd(*args, **kw)
        ms = statistics.median(cuda_ms(fn, 10))
        plain_ms = statistics.median(cuda_ms(lambda: kbwd.march_bwd_plain(*args, **kw), 2))
        return (ms, plain_ms, bwd_bound(args, kbwd.march_bwd_plain, kw),
                profile_frames(fn, 10, host=False)["device_ms"])

    def train_kw(name):
        _, starts, rows, dirs_t, seg, _, _ = inputs[name]
        cfg, quad = runs[name][1], runs[name][2]
        return (starts, rows.detach(), dirs_t, cfg, cfg.march_chunk), \
            {"save_tin": True, "quad": quad, **seg}

    times = {"quad_frame": k1_time((starts_f, rows_f, dirs_f, bench, 128),
                                   {"origins_t": origins_f, "quad": True})}
    quad_design = design("march", bench, 128, quad=True)
    for name in runs:
        times[name] = k1_time(*train_kw(name), tin=bargs[name][2])
        times["bwd_" + name] = k3_time(name)
        k1t, k3t = times[name], times["bwd_" + name]
        log("kernel", f"per-ray origins {name}: K1 save_tin {k1t[0]:.3f} ms (device "
                      f"{k1t[3]:.3f}), plain {k1t[1]:.3f} ms, bound {k1t[2][0]:.4f} ms "
                      f"({k1t[2][1]}); K3 {k3t[0]:.3f} ms (device {k3t[3]:.3f}), plain "
                      f"{k3t[1]:.3f} ms, bound {k3t[2][0]:.4f} ms ({k3t[2][1]}) ({card})")
    ms, plain_ms, (b_ms, b_by), dev_ms = times["quad_frame"]
    log("kernel", f"K1 per-ray-origin quad, rolling 720p 100k window c=128 ({n_pairs_f} pairs): "
                  f"{ms:.3f} ms (device {dev_ms:.3f}), plain {plain_ms:.3f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}) ({card})")
    quad_train_design = design("march", key0, 256, train=True, quad=True)
    scalar_train_design = design("march", key0, 256, train=True, scalar=True)
    bwd_design = design("march_bwd", key0, 256, scalar=True)

    src = f"{PKG}/csrc"
    k1 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    row = lambda name, source, replaces, launches, err, t, more: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
        "bound_ms": t[2][0], "bound_by": t[2][1], "library_ms": None, "device_ms": t[3], **more}
    extra = lambda names, prefix="": {n: {"ms": times[prefix + n][0], "device_ms": times[prefix + n][3],
                                          "plain_ms": times[prefix + n][1],
                                          "bound_ms": times[prefix + n][2][0]} for n in names}
    return [
        row("march_origin_quad", "march.cuh", k1, main["origin_quad_launches"],
            max(frame_err.values()), times["quad_frame"],
            {**quad_design, "vs_scalar": vs_scalar, "shared_origin_quad_vs_scalar": shared}),
        row("march_origin_quad_save_tin", "march.cuh", k1, main["origin_quad_save_tin_launches"],
            t1_err["key_sh0_quad"], times["key_sh0_quad"], quad_train_design),
        row("march_origin_save_tin", "march.cuh", k1,
            main["key_scalar_save_tin_launches"] + main["window_save_tin_launches"]
            + main["sh_save_tin_launches"],
            max(v for k, v in t1_err.items() if k != "key_sh0_quad"), times["key_sh0"],
            {**scalar_train_design, **extra(("window_sh0", "key_sh3", "window_sh3"))}),
        row("march_bwd_origin", "march_bwd.cuh", "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189",
            main["march_bwd_origin"], max(t3_err.values()), times["bwd_key_sh0"],
            {**bwd_design, **extra(("key_sh0_quad", "window_sh0", "key_sh3", "window_sh3"),
                                   "bwd_")}),
    ]


def tiled_phase(dev, card: str, views, init) -> tuple:
    """The tiled march (models/tiled.py, plain torch and autograd; its
    binning's scan is K2) at full width, and K1 and K3 held against it.
    data/golden/pinhole_720p.npz's scene and camera through it at >= 40
    dB. The main path: render(method="tiled") of random_scene(100k, seed
    0) at 1280x720 from the golden's eye in the bench config, max_per_tile
    doubled from 4096 until no pair drops, with K2's count zeroed just
    before and read just after, >= 40 dB against the kernel path's frame;
    Trainer(method="tiled") three steps on phase 6's 512x512 views of 50k
    from `init`. Against it: K1 on the scalar response from the eye
    (render_gpu(quad=False), key order, chunk_skip 1e-3, the same scene
    and camera) within 2e-5 on rgb and alpha, K1 on the quad response >=
    70 dB (tests/test_pallas.py:36-57; its max abs and the rays above
    1e-2 logged); K3's gradients (render_diff, key order, phase 6's first
    view and a model of `init`) against the tiled march's autograd per
    field: the distance in units of the largest entry logged against
    test_pallas.py:239-273's 1e-3, and K3 held no further from the tiled
    march in float64 than WITNESS_RATIO times the float32 autograd. Then
    `cli grad-check` (at the JAX CLI's eps 1e-3, logged, and at eps 1e-4,
    held at rtol 0.05, atol 1e-4) and `cli info` (native_core true) in the
    process. Times the tiled frame and step with CUDA events and profiles
    the frame. Returns the row of K1's scalar key mode and K2's launches on
    the tiled frame."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        prepare_pair_stream, render_gpu,
    )
    from gaussian_ray_tracing_tpu_torch.models.renderer import render, render_diff
    from gaussian_ray_tracing_tpu_torch.models.tiled import TILE_CHUNK_CUDA, tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    t_phase = time.perf_counter()

    # 1. the 720p golden's scene through the tiled march, >= 40 dB
    z = np.load(ROOT / "data" / "golden" / "pinhole_720p.npz")
    n, seed, width, height, hm, _ = (int(v) for v in z["meta"])
    cam = cameras.Camera.create(eye=GOLDEN_EYE, lookat=(0.0, 0.0, 0.0), width=width,
                                height=height, device=dev)
    bench = RenderConfig(hit_multiplicity=hm, order="window", march_chunk=128)
    golden_scene = random_scene(n, seed=seed, device=dev)
    with torch.no_grad():
        out, gcfg = drop_free(lambda c: render(golden_scene, cam, c, method="tiled",
                                               return_aux=True), bench)
    p = psnr(out["rgb"].cpu().numpy(), z["rgb"].astype(np.float32))
    log("tiled", f"golden pinhole_720p ({n} gaussians, seed {seed}): {out['aux']['n_pairs']} "
                 f"pairs, n_dropped 0 at max_per_tile {gcfg.max_per_tile}, PSNR {p:.2f} dB")
    check(p >= PSNR_GOLDEN, f"tiled golden PSNR {p:.2f} < {PSNR_GOLDEN}")

    # the main path: 1280x720 on random_scene(100k, seed 0), bench config
    scene = random_scene(100_000, seed=0, device=dev)
    kscan.multi_cumsum_i32.launches = 0
    with torch.no_grad():
        out, bench = drop_free(lambda c: render(scene, cam, c, method="tiled",
                                                return_aux=True), bench)
        torch.cuda.synchronize()
        tiled_launches = kscan.multi_cumsum_i32.launches
        gpu = render(scene, cam, bench, method="gpu")["rgb"]
    check(tiled_launches > 0, "the tiled frame did not launch K2")
    rgb = out["rgb"]
    check(tuple(rgb.shape) == (height, width, 3) and bool(torch.isfinite(rgb).all()),
          "tiled frame: bad output")
    p = psnr(rgb.cpu().numpy(), gpu.cpu().numpy())
    log("tiled", f"1280x720 100k bench config: {out['aux']['n_pairs']} pairs, n_dropped 0 at "
                 f"max_per_tile {bench.max_per_tile}, K2 launches {tiled_launches}, tile chunk "
                 f"{TILE_CHUNK_CUDA}; PSNR {p:.2f} dB against the kernel path's frame")
    check(p >= PSNR_GOLDEN, f"tiled vs kernel frame PSNR {p:.2f} < {PSNR_GOLDEN}")
    frame = lambda: render(scene, cam, bench, method="tiled")
    with torch.no_grad():
        frame_ms = statistics.median(cuda_ms(frame, 3))
        prof = profile_frames(frame, frames=1, host=False)
    log("tiled", f"frame 1280x720 100k, median of 3: {frame_ms:.1f} ms, device busy "
                 f"{prof['device_ms']:.1f} ms (idle share {1.0 - prof['device_ms'] / frame_ms:.3f}), "
                 f"{prof['device_ops']:.0f} device ops, top {prof['top']} ({card})")

    # 2. K1 against the tiled march: the same scene and camera, key order
    key = RenderConfig(hit_multiplicity=hm, order="key", march_chunk=128,
                       chunk_skip_transmittance=1e-3)
    with torch.no_grad():
        tiled, key = drop_free(lambda c: render(scene, cam, c, method="tiled",
                                                return_aux=True), key)
        kmarch.march.launches = kmarch.march.origin_launches = 0
        scalar = render_gpu(scene, cam, key, quad=False)
        torch.cuda.synchronize()
        scalar_launches = kmarch.march.origin_launches
        quad = render_gpu(scene, cam, key)
    check(scalar_launches == 1, f"render_gpu(quad=False) launched K1's per-ray-origin mode "
                                f"{scalar_launches} times")
    err = {k: float((scalar[k] - tiled[k]).abs().max()) for k in ("rgb", "alpha")}
    a, b = quad["rgb"].cpu().numpy(), tiled["rgb"].cpu().numpy()
    p_quad, m_quad = psnr(a, b), float(np.abs(a - b).max())
    flips = int(((quad["rgb"] - tiled["rgb"]).abs().amax(-1) > MAXABS_KERNEL).sum())
    log("tiled", f"K1 key vs the tiled march: scalar max abs rgb {err['rgb']:.3g} alpha "
                 f"{err['alpha']:.3g} (bar 2e-5); quad PSNR {p_quad:.2f} dB (bar "
                 f"{PSNR_KERNEL}), max abs {m_quad:.3g} ({flips} rays above {MAXABS_KERNEL}: "
                 f"alpha_min gate flips of the quad form, ROADMAP Queue 3)")
    check(max(err.values()) <= 2e-5, f"K1 scalar key vs the tiled march: {err}")
    check(p_quad >= PSNR_KERNEL, f"K1 quad vs the tiled march: PSNR {p_quad:.2f}")

    # the scalar key mode alone: against its plain version, times, bound
    stream, rows, _ = prepare_pair_stream(scene, cam, key, 1 << 16, quad=False)
    dirs_t = tile_rays(cameras.generate_rays(cam, key)[1], 16, 16)
    kw = {"origins_t": cam.eye.expand(dirs_t.shape).contiguous()}
    args = (stream.starts, rows, dirs_t, key, chunk_for(key))
    k1_err = k1_check("tiled", "K1 key scalar from the eye", args, kw)
    k1_ms = statistics.median(cuda_ms(lambda: kmarch.march(*args, **kw), 20))
    k1_plain = statistics.median(cuda_ms(lambda: kmarch.march_plain(*args, **kw), 3))
    k1_bound = march_bound(args, kw, kmarch.march_plain)
    k1_design = design("march", key, args[4], scalar=True)

    # 3. K3 against the tiled march's autograd (and both against float64)
    cam0, target = views[0]
    tkey = RenderConfig(**{**TRAIN_KW, "chunk_skip_transmittance": 1e-3})
    with torch.no_grad():
        _, tkey = drop_free(lambda c: render(init, cam0, c, method="tiled",
                                             return_aux=True), tkey)

    def grads(method, cfg):
        model = GaussianModel.from_scene(init).requires_grad_(True)
        out = render_diff(model.activate(), cam0, cfg, method=method)
        torch.mean((out["rgb"] - target) ** 2).backward()
        return {f: getattr(model, f).grad.double() for f in FIELDS}

    # K3 and the tiled march's float32 autograd both stand about 1e-3 of the
    # largest entry from the float64 march at this size (ROADMAP Queue 3):
    # K3 is held no further from it than WITNESS_RATIO times autograd's own
    # distance, as against its plain version; the 1e-3 bar is logged
    g_k3, g_tiled = grads("gpu", tkey), grads("tiled", tkey)
    g64 = grads("tiled", tkey.replace(compute_dtype="float64"))
    rel, wit = {}, {}
    for f in FIELDS:
        check(bool(torch.isfinite(g_k3[f]).all() and torch.isfinite(g_tiled[f]).all()),
              f"K3 or tiled gradient of {f} not finite")
        rel[f] = float((g_k3[f] - g_tiled[f]).abs().max() / g_tiled[f].abs().max())
        w = g64[f].abs().max()
        wit[f] = (float((g_k3[f] - g64[f]).abs().max() / w),
                  float((g_tiled[f] - g64[f]).abs().max() / w))
        log("tiled", f"K3 vs tiled autograd, 512x512 50k key, {f}: {rel[f]:.3g} of the largest "
                     f"entry (bar 1e-3{', not met' if rel[f] > 1e-3 else ''}); from float64: "
                     f"K3 {wit[f][0]:.3g}, tiled {wit[f][1]:.3g}")
        check(wit[f][0] <= WITNESS_RATIO * wit[f][1],
              f"K3 {f}: {wit[f][0]:.3g} from the float64 tiled march, its float32 autograd "
              f"{wit[f][1]:.3g}")

    # 4. the tiled trainer: three steps at 512x512 / 50k
    trainer = ktrain.Trainer(GaussianModel.from_scene(init), config=tkey, lr=2e-3,
                             method="tiled")
    kscan.multi_cumsum_i32.launches = 0
    losses = trainer.fit(views, steps=3)
    torch.cuda.synchronize()
    check(len(losses) == 3 and all(np.isfinite(losses)), f"tiled trainer: bad losses {losses}")
    check(kscan.multi_cumsum_i32.launches > 0, "the tiled trainer did not launch K2")
    step = ktrain.make_train_step(tkey, trainer.optimizer, method="tiled",
                                  pair_capacity=trainer._pair_capacity)
    step_ms = statistics.median(cuda_ms(lambda: step(trainer.model, *views[0]), 3))
    prof = profile_frames(lambda: step(trainer.model, *views[0]), frames=1, host=False)
    log("tiled", f"Trainer(method='tiled') 3 steps 512x512 50k: losses {losses}; step, median "
                 f"of 3: {step_ms:.1f} ms, device busy {prof['device_ms']:.1f} ms (idle share "
                 f"{1.0 - prof['device_ms'] / step_ms:.3f}), {prof['device_ops']:.0f} device ops, "
                 f"top {prof['top']} ({card})")

    # 5. cli grad-check and cli info in the process
    report = json.loads(run_cli("grad-check"))
    log("tiled", f"grad-check eps 1e-3 (the JAX CLI's): {json.dumps(report['grads'])}")
    report = json.loads(run_cli("grad-check", "--eps", "1e-4"))
    for f, g in report["grads"].items():
        check(abs(g["finite_diff"] - g["autodiff"]) <= 1e-4 + 0.05 * abs(g["autodiff"]),
              f"grad-check --eps 1e-4 {f}: {g}")
    log("tiled", f"grad-check eps 1e-4: {json.dumps(report['grads'])}")
    info = json.loads(run_cli("info", "--synthetic", "1000").splitlines()[-1])
    check(info["native_core"] is True and info["num_gaussians"] == 1000, f"cli info: {info}")
    log("phase", f"tiled march in {time.perf_counter() - t_phase:.1f} s")

    return [{"name": "march_key_scalar", "route": "cuda", "source": f"{PKG}/csrc/march.cuh",
             "replaces": "gaussian_ray_tracing_tpu/ops/pallas_march.py:195",
             "launches": scalar_launches, "max_abs_err": k1_err, "ms": k1_ms,
             "plain_ms": k1_plain, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
             "library_ms": None, "vs_tiled_max_abs": max(err.values()), **k1_design}], \
        tiled_launches


def training_phase(dev, card: str, views, init) -> list:
    """The window-order and SH 1-3 training slice at full size. The main
    path: Trainer.fit, 20 steps each, with the launch counts zeroed just
    before and read just after, in window order at SH 0 on the 512x512 /
    50k views of phase 6 from `init`, and in window and key order at SH 3
    from data/fitted_20k.ply with its higher SH bands zeroed, to the PLY's
    own 512x512 SH 3 renders from 8 orbit views (radius 2.8, elevation 15).
    Then the step times kernel vs plain, profiles of the window and key SH
    3 steps and the two timed in turns,
    K1's window and SH 3 save_tin modes and K3's window and SH 3 modes
    against their plain versions at those shapes, with their times, the SH
    3 modes also on the PLY's own coefficients, and the row gather at SH 3
    (320 B rows) against SH 0. Returns the kernel rows."""
    import dataclasses

    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_train_stream
    from gaussian_ray_tracing_tpu_torch.models.renderer import render
    from gaussian_ray_tracing_tpu_torch.models.tiled import feature_table, tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain

    win0 = RenderConfig(hit_multiplicity=1, order="window", march_chunk=128)
    win3 = win0.replace(sh_degree=3)
    key3 = RenderConfig(hit_multiplicity=1, order="key", march_chunk=256, sh_degree=3)
    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    center = ply.center().cpu().numpy()
    with torch.no_grad():
        sh3_views = []
        for i in range(8):
            cam = cameras.orbit_camera(center, 2.8, 360.0 * i / 8, 15.0, width=512, height=512,
                                       device=dev)
            sh3_views.append((cam, render(ply, cam, win3, method="gpu")["rgb"]))
    flat = dataclasses.replace(ply, sh=torch.cat([ply.sh[:, :1], 0.0 * ply.sh[:, 1:]], 1))
    runs = {"window_sh0": (win0, views, init), "window_sh3": (win3, sh3_views, flat),
            "key_sh3": (key3, sh3_views, flat)}
    k1_modes = ("window_save_tin_launches", "sh_save_tin_launches", "sh_key_save_tin_launches")
    k3_modes = ("window_launches", "sh_launches", "sh_key_launches")
    expect = {"window_sh0": ("window_save_tin_launches", "window_launches"),
              "window_sh3": ("sh_save_tin_launches", "sh_launches"),
              "key_sh3": ("sh_key_save_tin_launches", "sh_key_launches")}
    launches, trainers, step_ms, prof, sh3_steps = {}, {}, {}, None, {}
    for name, (cfg, vs, scene0) in runs.items():
        trainer = ktrain.Trainer(GaussianModel.from_scene(scene0), config=cfg, lr=2e-3)
        for attr in k1_modes:
            setattr(kmarch.march, attr, 0)
        for attr in k3_modes:
            setattr(kbwd.march_bwd, attr, 0)
        losses = trainer.fit(vs, steps=20)
        torch.cuda.synchronize()
        counts = {a: getattr(kmarch.march, a) for a in k1_modes}
        counts.update({f"march_bwd.{a}": getattr(kbwd.march_bwd, a) for a in k3_modes})
        k1_attr, k3_attr = expect[name]
        check(counts[k1_attr] == 20 and counts[f"march_bwd.{k3_attr}"] == 20,
              f"train {name}: K1 {k1_attr} or K3 {k3_attr} did not launch once a step: {counts}")
        check(len(losses) == 20 and all(np.isfinite(losses)), f"train {name}: bad losses {losses}")
        check(losses[16] < losses[0], f"train {name}: loss on view 0 did not fall: "
                                      f"{losses[0]} -> {losses[16]}")
        launches[name] = counts
        trainers[name] = trainer
        log("train", f"{name} 20 steps 512x512: loss {losses[0]:.6f} -> {losses[-1]:.6f}, same "
                     f"view (0) {losses[0]:.6f} -> {losses[16]:.6f}, launches {counts}")

        # step times, kernel vs plain (kernel, plain, kernel, plain)
        model = trainer.model
        steppers = {m: ktrain.make_train_step(cfg, trainer.optimizer, method=m,
                                              pair_capacity=trainer._pair_capacity)
                    for m in ("gpu", "plain")}
        times = {"gpu": [], "plain": []}
        for _ in range(2):
            for method, n in (("gpu", 6), ("plain", 3)):
                for i in range(n):
                    cam, target = vs[i % 8]
                    times[method] += cuda_ms(lambda: steppers[method](model, cam, target), 1)
        step_ms[name] = {m: statistics.median(v) for m, v in times.items()}
        log("train", f"train step {name} 512x512, median of 12/6: gpu "
                     f"{step_ms[name]['gpu']:.3f} ms, plain {step_ms[name]['plain']:.3f} ms "
                     f"({card})")
        if name in ("window_sh3", "key_sh3"):
            cam, target = vs[0]
            sh3_steps[name] = lambda st=steppers["gpu"], m=model, c=cam, t=target: st(m, c, t)
            prof = profile_frames(sh3_steps[name], top=12)
            idle = 1.0 - prof["device_ms"] / step_ms[name]["gpu"]
            log("profile", f"train step {name}: device busy {prof['device_ms']:.3f} ms of a "
                           f"{step_ms[name]['gpu']:.3f} ms step (idle share {idle:.3f}), "
                           f"{prof['device_ops']:.0f} device ops per step, top {prof['top']}; "
                           f"host self {prof['host_ms']:.3f} ms per step, top (ms, calls) "
                           f"{prof['host_top']} ({card})")
    # the two SH 3 steps in turns on one view, so the host's state is shared
    turns = {name: [] for name in sh3_steps}
    for _ in range(3):
        for name, step in sh3_steps.items():
            turns[name] += cuda_ms(step, 4)
    log("train", "SH 3 steps in turns (3 x 4 each, view 0): " + ", ".join(
        f"{name} {statistics.median(v):.3f} ms" for name, v in turns.items()) + f" ({card})")

    # the kernels alone at the trained models' first-view streams, timed;
    # the SH 3 modes also on fitted_20k.ply's own coefficients (the trained
    # models start from its bands 1-3 zeroed), held against plain only
    errs, times = {}, {}
    cases = [(name, name, trainers[name].model.activate(), vs[0][0])
             for name, (_, vs, _) in runs.items()]
    cases += [(name, f"{name} fitted_20k.ply", ply, sh3_views[0][0])
              for name in ("window_sh3", "key_sh3")]
    for name, what, scene, cam0 in cases:
        cfg = runs[name][0]
        with torch.no_grad():
            stream, trows, n_pairs = prepare_train_stream(scene, cam0, cfg)
        starts, trows = stream.starts, trows.detach().contiguous()
        dirs_t = tile_rays(cameras.generate_rays(cam0, cfg)[1], 16, 16)
        chunk = chunk_for(cfg)
        # window order: the scalar response from per-ray origins, each the eye
        kw = ({"origins_t": cam0.eye.expand(dirs_t.shape).contiguous()}
              if cfg.order == "window" else {})
        fwd = lambda f: f(starts, trows, dirs_t, cfg, chunk, save_tin=True, **kw)
        got = fwd(kmarch.march)
        torch.cuda.synchronize()
        k1_err = k1_train_check(f"{what} 512x512 c={chunk} ({n_pairs} pairs)", got,
                                fwd(kmarch.march_plain))
        tin, base = got[2], got[3]
        gen = torch.Generator(device=dev).manual_seed(0)
        d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dev)
        d_t = torch.randn(dirs_t.shape[:2], generator=gen, device=dev)
        bargs = (starts, trows, dirs_t, cam0.eye, tin, base, d_rgb, d_t, cfg, chunk)
        k3_err = k3_check(f"{what} 512x512 c={chunk}", bargs)
        prev = errs.get(name, (0.0, 0.0))
        errs[name] = (max(prev[0], k1_err), max(prev[1], k3_err))
        if name in times:
            continue
        k1_t = (statistics.median(cuda_ms(lambda: fwd(kmarch.march), 20)),
                statistics.median(cuda_ms(lambda: fwd(kmarch.march_plain), 3)),
                march_bound((starts, trows, dirs_t, cfg, chunk), kw, kmarch.march_plain,
                            tin=tin),
                design("march", cfg, chunk, scalar=bool(kw), train=True))
        k3_t = (statistics.median(cuda_ms(lambda: kbwd.march_bwd(*bargs), 20)),
                statistics.median(cuda_ms(lambda: kbwd.march_bwd_plain(*bargs), 3)),
                bwd_bound(bargs, kbwd.march_bwd_plain), design("march_bwd", cfg, chunk))
        if cfg.sh_degree == 3:
            check(k3_t[3]["blocks_per_sm"] >= 2,
                  f"K3 {name}: {k3_t[3]['blocks_per_sm']} resident blocks per SM, not 2")
        times[name] = (k1_t, k3_t)
        log("kernel", f"{name} {n_pairs} pairs, rows {trows.shape[1]} floats, c={chunk}: K1 "
                      f"save_tin {k1_t[0]:.3f} ms, plain {k1_t[1]:.3f} ms, bound "
                      f"{k1_t[2][0]:.4f} ms ({k1_t[2][1]}); K3 {k3_t[0]:.3f} ms, plain "
                      f"{k3_t[1]:.3f} ms, bound {k3_t[2][0]:.4f} ms ({k3_t[2][1]}); "
                      f"{kmarch.march_plain.significant} / {kbwd.march_bwd_plain.significant} "
                      f"pairs through the gate ({card})")

    # the training row gather at SH 3 (80-float rows) against SH 0 (32 floats)
    cam0 = sh3_views[0][0]
    scene = trainers["window_sh3"].model.activate()
    with torch.no_grad():
        stream, _, n_pairs = prepare_train_stream(scene, cam0, win3)
        ids = stream.order[stream.gid[:n_pairs].long()]
        gather = {}
        for degree in (0, 3):
            table, _, _ = feature_table(scene, win3.replace(sh_degree=degree), eye=cam0.eye)
            gather[degree] = statistics.median(cuda_ms(
                lambda: kmarch.train_features(table, degree)[ids], 20))
    log("gather", f"training rows for {n_pairs} pairs: SH 3 (320 B) {gather[3]:.3f} ms, SH 0 "
                  f"(128 B) {gather[0]:.3f} ms ({card})")

    src = f"{PKG}/csrc"
    k1 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    k3 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189"
    row = lambda name, source, replaces, launches_, err, t: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": launches_, "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
        "bound_ms": t[2][0], "bound_by": t[2][1], "library_ms": None, **t[3]}
    out = []
    for name, k1_name, k3_name, k1_src, k3_src in (
            ("window_sh0", "march_window_save_tin", "march_bwd_window", "march.cuh",
             "march_bwd.cuh"),
            ("window_sh3", "march_sh_save_tin", "march_bwd_sh", "march_sh3.cu", "march_bwd_sh3.cu"),
            ("key_sh3", "march_sh_key_save_tin", "march_bwd_sh_key", "march_sh3.cu",
             "march_bwd_sh3.cu")):
        k1_attr, k3_attr = expect[name]
        out.append(row(k1_name, k1_src, k1, launches[name][k1_attr], errs[name][0],
                       times[name][0]))
        out.append(row(k3_name, k3_src, k3, launches[name][f"march_bwd.{k3_attr}"],
                       errs[name][1], times[name][1]))
    return out


def dataset_phase(dev, card: str) -> None:
    """The slice at full width through the CLI: writes build/nerf_fitted/
    from the committed data/nerf_fitted/transforms_*.json (every pose of
    data/fitted_20k.ply rendered at 400x400, fov 45 degrees, by the port's
    kernels, as scripts/make_dataset.py renders them), then `cli fit
    --dataset` in window order at SH 3 with density control, the 3DGS
    optimizer and dssim_l1 to 200 steps, resumed from its checkpoint to
    300, and `cli eval` of the fit and of the initial scene (cli's own
    dataset_init, written here) on the held-out test split."""
    import shutil

    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.cli import dataset_init
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.renderer import render
    from gaussian_ray_tracing_tpu_torch.scene.dataset import load_nerf_synthetic
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.utils.image import quantize_rgb8, write_png

    build = ROOT / "build"
    data = build / "nerf_fitted"
    for d in (data, build / "ck"):
        shutil.rmtree(d, ignore_errors=True)
    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    cfg = RenderConfig(hit_multiplicity=1)
    t0 = time.perf_counter()
    n_frames = 0
    for split in ("train", "test", "val"):
        src = ROOT / "data" / "nerf_fitted" / f"transforms_{split}.json"
        (data / split).mkdir(parents=True)
        shutil.copy(src, data / src.name)
        for frame in json.loads(src.read_text())["frames"]:
            c2w = np.asarray(frame["transform_matrix"], np.float32)
            eye = c2w[:3, 3]
            cam = cameras.Camera.create(eye=eye, lookat=eye - c2w[:3, 2], fov_y_deg=45.0,
                                        width=400, height=400, device=dev)
            with torch.no_grad():
                rgb = render(ply, cam, cfg, method="gpu")["rgb"].cpu().numpy()
            write_png(str(data / f"{frame['file_path']}.png"), quantize_rgb8(rgb))
            n_frames += 1
    log("dataset", f"{n_frames} frames 400x400 of fitted_20k.ply written to {data} in "
                   f"{time.perf_counter() - t0:.1f} s")

    def cli(*argv):
        t = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", f"{PKG}.cli", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        check(res.returncode == 0, f"cli {argv[0]} failed:\n{res.stderr[-4000:]}")
        return json.loads(res.stdout.strip().splitlines()[-1]), res.stderr, \
            time.perf_counter() - t

    fit = ["fit", "--dataset", str(data), "--order", "window", "--sh-degree", "3", "--densify",
           "--optimizer", "3dgs", "--loss", "dssim_l1", "--fit-gaussians", "20000",
           "--capacity", "60000"]  # --seed 0
    # the fits' initial scene, as cli fit builds it from the train split
    _, meta = load_nerf_synthetic(str(data), "train", device=dev)
    GaussianModel.from_scene(dataset_init(meta, 20_000, 0, 60_000, dev)).to_ply(
        str(build / "init.ply"))
    first, _, s1 = cli(*fit, "--steps", "200", "--checkpoint-dir", str(build / "ck"),
                       "-o", str(build / "fit.ply"))
    second, err, s2 = cli(*fit, "--steps", "300", "--checkpoint-dir", str(build / "ck"),
                          "-o", str(build / "fit.ply"))
    for what, res in (("200 steps", first), ("200 -> 300", second)):
        log("dataset", f"cli fit {what}: {json.dumps(res)}")
    check(first["steps_run"] == 200 and first["loss_last"] < first["loss_first"],
          f"cli fit: loss did not fall over 200 steps: {first}")
    check(first["alive"] > 20_000, f"cli fit: density control did not grow the scene: {first}")
    check(first["kernel_launches"]["march"] > 0 and first["kernel_launches"]["march_bwd"] > 0,
          f"cli fit did not launch K1 and K3: {first}")
    check("resumed from" in err and "at step 200" in err and second["steps_run"] == 100,
          f"cli fit did not resume at step 200: {err[-2000:]}")
    for what, res, s in (("200 steps", first, s1), ("100 resumed steps", second, s2)):
        log("dataset", f"cli fit {what}: {res['fit_seconds'] / res['steps_run'] * 1e3:.3f} ms "
                       f"per step over Trainer.fit (density rounds and checkpoints included), "
                       f"{s:.1f} s for the whole command ({card})")
    ev = {}
    for what, ply_path in (("fit", build / "fit.ply"), ("init", build / "init.ply")):
        ev[what], _, s = cli("eval", "--dataset", str(data), "--split", "test", "--sh-degree",
                             "3", "--against", str(ply_path))
        log("dataset", f"cli eval {what}: {json.dumps(ev[what])} ({s:.1f} s)")
    check(ev["fit"]["psnr_mean"] > ev["init"]["psnr_mean"],
          f"cli eval: the fit ({ev['fit']['psnr_mean']} dB) does not beat the initial scene "
          f"({ev['init']['psnr_mean']} dB)")


def wide_tile_phase(dev, card: str, scene, pose, views, init) -> list:
    """Training at every tile size JAX trains, and the binning's three pair
    culls, at full width. The main path, with the launch counts zeroed just
    before and read just after: Trainer(method="gpu").fit on the training
    row's view 0 (512x512, `init` = random_scene(50k, seed 1)) on 32x32
    tiles (R = 1024; 5 steps in key order, whose loss must fall, 3 in
    window order) and on 32x16 tiles (R = 512; 2 steps each order); 2 steps
    each in key and window order at R = 1024 on data/fitted_20k.ply at SH 3
    (its bands 1-3 zeroed) against its own SH 3 render; march_stream_diff
    with per-ray origins, windows and carry-in through a 512x512 rolling
    shutter of `init` at R = 1024 (the per-ray-origin quad response, key
    order); the 1280x720 rolling frame of `scene` (random_scene(100k, seed
    0)) on the per-ray-origin quad response at R = 1024 (window order,
    bench config); and the culled frames through GaussianRayTracer: the
    720p / 100k headline (`pose`) with conic_cull, with row_span and with
    both, fisheye_768 / 100k with fisheye_cull, and the fisheye glass_front
    mesh frame with fisheye_cull. Then every new K1 and K3 launch held
    against its plain version (k1_train_check, k3_check, k1_check; K3's
    crafted calls at R = 1024 also to commit 1d2f322's bits, k3_wide_crafted), timed
    against it with its bound and build (`design` at its R); each culled
    stream drop-free and a subset of the uncut one, its key-order image
    within 5e-4 of the uncut one (JAX tests/test_conic_cull.py:131-154,
    tests/test_footprints.py:87-105), its window-order image on the
    goldens >= 40 dB and >= the uncut one's - 1 dB
    (tests/test_conic_cull.py:156-174); K2 at each culled binning's channel
    count against torch.cumsum; K1's marched slots, significant share and
    device ms on and off. Returns the kernel rows."""
    import dataclasses

    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import CameraModel, MeshType, RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as kmesh
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        prepare_pair_stream, prepare_train_stream,
    )
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.ops import tiles as ktiles
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_sphere
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    t_phase = time.perf_counter()
    cam = lambda w, h, dx=0.0: cameras.Camera.create(
        eye=(GOLDEN_EYE[0] + dx, GOLDEN_EYE[1], GOLDEN_EYE[2]), lookat=(0.0, 0.0, 0.0),
        width=w, height=h, device=dev)
    tiles = lambda cfg, h: cfg.replace(tile_w=32, tile_h=h)
    key0 = RenderConfig(**TRAIN_KW)  # key order, chunk 256
    win0 = RenderConfig(hit_multiplicity=1, order="window", march_chunk=128)
    bench = RenderConfig(**BENCH_KW)
    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    flat = dataclasses.replace(ply, sh=torch.cat([ply.sh[:, :1], 0.0 * ply.sh[:, 1:]], 1))
    ply_cam = cameras.orbit_camera(ply.center().cpu().numpy(), 2.8, 0.0, 15.0, width=512,
                                   height=512, device=dev)
    with torch.no_grad():
        ply_target = render(ply, ply_cam, win0.replace(sh_degree=3), method="gpu")["rgb"]
    cam0, target0 = views[0]
    # name: (config, R, scene, view) of the training runs and kernel checks
    runs = {"key_sh0_1024": (tiles(key0, 32), init, (cam0, target0)),
            "window_sh0_1024": (tiles(win0, 32), init, (cam0, target0)),
            "key_sh0_512": (tiles(key0, 16), init, (cam0, target0)),
            "window_sh0_512": (tiles(win0, 16), init, (cam0, target0)),
            "key_sh3_1024": (tiles(key0, 32).replace(sh_degree=3), flat, (ply_cam, ply_target)),
            "window_sh3_1024": (tiles(win0, 32).replace(sh_degree=3), flat,
                                (ply_cam, ply_target))}
    steps = {"key_sh0_1024": 5, "window_sh0_1024": 3}

    # per-ray origins at R = 1024: the rolling 512x512 training stream and
    # the rolling 720p frame
    key_w = tiles(key0, 32)
    gen = torch.Generator(device=dev).manual_seed(16)
    omodel = GaussianModel.from_scene(init).requires_grad_(True)
    ostarts, orows, odirs, oorigins, _, _ = prepare_rolling_stream(
        omodel.activate(), cam(512, 512), cam(512, 512, 0.05), key_w, train=True)
    oshape = odirs.shape[:2]
    check(odirs.shape[1] == 1024, f"rolling stream: {odirs.shape[1]} rays a tile, not 1024")
    oseg = dict(origins_t=oorigins,
                t_lo=0.05 + 0.05 * torch.rand(oshape, generator=gen, device=dev),
                t_hi=3.0 + torch.rand(oshape, generator=gen, device=dev),
                t0=0.6 + 0.4 * torch.rand(oshape, generator=gen, device=dev))
    ow = torch.randn(odirs.shape, generator=gen, device=dev)
    bench_w = tiles(bench, 32)
    frame = prepare_rolling_stream(scene, cam(1280, 720), cam(1280, 720, 0.05), bench_w, train=True)

    # the culled frames: name -> (scene, camera, config with the cull, mesh)
    fish = bench.replace(camera_model=CameraModel.FISHEYE)
    front = make_sphere((0.0, 0.0, 1.6), device=dev).with_type(MeshType.GLASS)
    at_front = np.eye(4, dtype=np.float32)
    at_front[:3, 3] = (0.0, 0.0, 1.6)
    culls = {"conic_720p": (scene, pose, bench.replace(conic_cull=True), None),
             "row_span_720p": (scene, pose, bench.replace(row_span=True), None),
             "both_720p": (scene, pose, bench.replace(conic_cull=True, row_span=True), None),
             "fisheye_768": (scene, cam(768, 768), fish.replace(fisheye_cull=True), None),
             "fisheye_glass_front": (scene, cam(1280, 720), fish.replace(fisheye_cull=True),
                                     front)}
    tracers = {}
    for name, (sc, c, cfg, mesh) in culls.items():
        tr = GaussianRayTracer(scene=sc, config=cfg.replace(camera_model=CameraModel.PINHOLE))
        tr.set_camera_model(cfg.camera_model.value)
        tr.set_size(c.width, c.height)
        tr.update_camera(c)
        if mesh is not None:
            tr.update_instance_transform(tr.create_sphere(mesh_type="glass"), at_front)
        tracers[name] = tr
    # the head fill's channel counts of the culled binnings
    channels = {}
    head_fill = ktiles.multi_head_fill

    def counted_fill(first, values, cap, use_kernel=True):
        channels.setdefault(len(values), cap)
        return head_fill(first, values, cap, use_kernel=use_kernel)

    # --- the main path, every count zeroed just before ---
    k1_counts = ("launches", "save_tin_launches", "window_save_tin_launches",
                 "sh_key_save_tin_launches", "sh_save_tin_launches",
                 "origin_quad_save_tin_launches", "origin_quad_launches", "segment_launches")
    for attr in k1_counts:
        setattr(kmarch.march, attr, 0)
    kbwd.march_bwd.launches = kbwd.march_bwd.origin_launches = 0
    kscan.multi_cumsum_i32.launches = 0
    train_losses = {}
    for name, (cfg, sc, view) in runs.items():
        trainer = ktrain.Trainer(GaussianModel.from_scene(sc), config=cfg, lr=2e-3, method="gpu")
        losses = trainer.fit([view], steps=steps.get(name, 2))
        check(all(np.isfinite(losses)), f"wide tiles {name}: bad losses {losses}")
        train_losses[name] = losses
    check(train_losses["key_sh0_1024"][-1] < train_losses["key_sh0_1024"][0],
          f"1024-ray key training: the loss did not fall {train_losses['key_sh0_1024']}")
    rgb, t_final = kbwd.march_stream_diff(orows, ostarts, odirs, torch.zeros(3, device=dev),
                                          key_w, 256, quad=True, **oseg)
    (torch.sum(rgb * ow) + torch.sum(t_final)).backward()
    torch.cuda.synchronize()
    ograds = [p.grad for p in omodel.parameters()]
    check(all(g is not None and bool(torch.isfinite(g).all()) and bool(g.any()) for g in ograds),
          "1024-ray march_stream_diff: a missing, zero or non-finite gradient")
    starts_f, rows_f, dirs_f, origins_f, _, n_pairs_f = frame
    rgb_f, _ = kmarch.march(starts_f, rows_f, dirs_f, bench_w, 128, origins_t=origins_f, quad=True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rgb_f).all()) and float(rgb_f.max()) > 0.1,
          "1024-ray per-ray-origin quad frame: black or not finite")
    k2_culls = kscan.multi_cumsum_i32.launches
    ktiles.multi_head_fill = counted_fill
    try:
        for name, tr in tracers.items():
            out = tr.render()["rgb"]
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()) and float(out.max()) > 0.1,
                  f"culled frame {name}: black or not finite")
    finally:
        ktiles.multi_head_fill = head_fill
    k2_culls = kscan.multi_cumsum_i32.launches - k2_culls
    main = {attr: getattr(kmarch.march, attr) for attr in k1_counts}
    main.update(march_bwd=kbwd.march_bwd.launches, march_bwd_origin=kbwd.march_bwd.origin_launches,
                scan=kscan.multi_cumsum_i32.launches, scan_culled_frames=k2_culls)
    log("wide", f"training at R = 1024 and 512 ({', '.join(runs)}), losses "
                f"{json.dumps({k: [round(x, 6) for x in v] for k, v in train_losses.items()})}; "
                f"march_stream_diff at R = 1024; the rolling 720p quad frame at R = 1024 "
                f"({n_pairs_f} pairs); culled frames {', '.join(culls)}; head-fill channels "
                f"{sorted(channels)}; launches {main}")
    for attr in ("save_tin_launches", "window_save_tin_launches", "sh_key_save_tin_launches",
                 "sh_save_tin_launches", "origin_quad_save_tin_launches", "origin_quad_launches",
                 "march_bwd", "march_bwd_origin", "scan_culled_frames"):
        check(main[attr] > 0, f"wide tiles: {attr} was not launched on the main path: {main}")

    # --- each new K1 and K3 build against its plain version, timed ---
    def k1_time(args, kw, tin=None):
        fn = lambda: kmarch.march(*args, **kw)
        return (statistics.median(cuda_ms(fn, 10)),
                statistics.median(cuda_ms(lambda: kmarch.march_plain(*args, **kw), 2)),
                march_bound(args, kw, kmarch.march_plain, tin=tin),
                profile_frames(fn, 5)["device_ms"])

    def k3_time(args, kw):
        fn = lambda: kbwd.march_bwd(*args, **kw)
        return (statistics.median(cuda_ms(fn, 10)),
                statistics.median(cuda_ms(lambda: kbwd.march_bwd_plain(*args, **kw), 2)),
                bwd_bound(args, kbwd.march_bwd_plain, kw),
                profile_frames(fn, 5)["device_ms"])

    errs, times = {}, {}
    for name, (cfg, sc, (c0, _)) in runs.items():
        with torch.no_grad():
            stream, trows, n_pairs = prepare_train_stream(sc, c0, cfg)
        starts, trows = stream.starts, trows.detach().contiguous()
        R = cfg.rays_per_tile
        dirs_t = tile_rays(cameras.generate_rays(c0, cfg)[1], 32, cfg.tile_h)
        check(dirs_t.shape[1] == R, f"{name}: {dirs_t.shape[1]} rays a tile")
        chunk = chunk_for(cfg)
        kw = ({"origins_t": c0.eye.expand(dirs_t.shape).contiguous()}
              if cfg.order == "window" else {})
        fwd = lambda f: f(starts, trows, dirs_t, cfg, chunk, save_tin=True, **kw)
        got = fwd(kmarch.march)
        torch.cuda.synchronize()
        e1 = k1_train_check(f"{name} 512x512 c={chunk} ({n_pairs} pairs)", got,
                            fwd(kmarch.march_plain))
        gen = torch.Generator(device=dev).manual_seed(0)
        d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dev)
        d_t = torch.randn(dirs_t.shape[:2], generator=gen, device=dev)
        bargs = (starts, trows, dirs_t, c0.eye, got[2], got[3], d_rgb, d_t, cfg, chunk)
        e3 = k3_check(f"{name} 512x512 c={chunk}", bargs)
        errs[name] = (e1, e3)
        k1t = k1_time((starts, trows, dirs_t, cfg, chunk), {"save_tin": True, **kw}, tin=got[2])
        k1d = design("march", cfg, chunk, scalar=bool(kw), train=True, rays=R)
        k3t = k3_time(bargs, {})
        k3d = design("march_bwd", cfg, chunk, rays=R)
        times[name] = (k1t, k1d, k3t, k3d)
        log("kernel", f"wide {name} {n_pairs} pairs c={chunk}: K1 save_tin {k1t[0]:.3f} ms "
                      f"(device {k1t[3]:.3f}), plain {k1t[1]:.3f} ms, bound {k1t[2][0]:.4f} ms "
                      f"({k1t[2][1]}); K3 {k3t[0]:.3f} ms (device {k3t[3]:.3f}), plain "
                      f"{k3t[1]:.3f} ms, bound {k3t[2][0]:.4f} ms ({k3t[2][1]}) ({card})")

    # per-ray origins at R = 1024
    orows = orows.detach()
    ofwd = lambda f: f(ostarts, orows, odirs, key_w, 256, save_tin=True, quad=True, **oseg)
    got = ofwd(kmarch.march)
    torch.cuda.synchronize()
    oe1 = k1_train_check("rolling 512x512 R=1024 per-ray-origin quad key", got,
                         ofwd(kmarch.march_plain))
    obargs = (ostarts, orows, odirs, torch.zeros(3, device=dev), got[2], got[3], ow,
              torch.ones(oshape, device=dev), key_w, 256)
    okw = {k: oseg[k] for k in ("origins_t", "t_lo", "t_hi")}
    oe3 = k3_check("rolling 512x512 R=1024 per-ray origins key", obargs, okw)
    times["origin_quad_save_tin"] = (
        k1_time((ostarts, orows, odirs, key_w, 256), {"save_tin": True, "quad": True, **oseg},
                tin=got[2]),
        design("march", key_w, 256, train=True, quad=True, rays=1024))
    times["bwd_origin"] = (k3_time(obargs, okw),
                           design("march_bwd", key_w, 256, scalar=True, rays=1024))
    frame_err = {}
    for order in ("window", "key", "merge"):
        frame_err[order] = k1_check("K1wide", f"rolling 720p 100k R=1024 per-ray-origin quad "
                                    f"{order}", (starts_f, rows_f, dirs_f,
                                                 bench_w.replace(order=order), 128),
                                    {"origins_t": origins_f, "quad": True})
    times["origin_quad"] = (k1_time((starts_f, rows_f, dirs_f, bench_w, 128),
                                    {"origins_t": origins_f, "quad": True}),
                            design("march", bench_w, 128, quad=True, rays=1024))
    for name in ("origin_quad_save_tin", "bwd_origin", "origin_quad"):
        t = times[name][0]
        log("kernel", f"wide {name} R=1024: {t[0]:.3f} ms (device {t[3]:.3f}), plain "
                      f"{t[1]:.3f} ms, bound {t[2][0]:.4f} ms ({t[2][1]}) ({card})")

    # --- the culls: drop-free subsets of the uncut streams, the images,
    # K1 on and off, K2 at each channel count ---
    def pair_keys(stream, n_gauss):
        kept = int(stream.starts[-1])
        return stream.key[:kept].long() * n_gauss + stream.order[stream.gid[:kept].long()].long()

    cull_stats, cull_err = {}, 0.0
    for name, (sc, c, cfg, mesh) in culls.items():
        off_cfg = cfg.replace(conic_cull=False, row_span=False, fisheye_cull=False)
        if mesh is None:
            st = {}
            for tag, cf in (("on", cfg), ("off", off_cfg)):
                stream, feats, n_pairs = prepare_pair_stream(sc, c, cf, 1 << 22)
                check(int(stream.n_dropped) == 0, f"{name} {tag}: pairs dropped")
                st[tag] = (stream, feats, n_pairs)
            on_keys, off_keys = (pair_keys(st[t][0], sc.num_gaussians) for t in ("on", "off"))
            check(bool(torch.isin(on_keys, off_keys).all()),
                  f"{name}: the culled pairs are not a subset of the uncut ones")
            dirs_t = tile_rays(cameras.generate_rays(c, cfg)[1], 16, 16)
            k1 = {}
            for tag in ("on", "off"):
                args = (st[tag][0].starts, st[tag][1], dirs_t, cfg, 128)
                cull_err = max(cull_err, k1_check("K1cull", f"{name} {tag}", args))
                k1[tag] = {"n_pairs": st[tag][2], "kept_pairs": int(st[tag][0].starts[-1]),
                           "marched_slots": kmarch.march_plain.candidates,
                           "significant_share": kmarch.march_plain.significant
                           / max(1, kmarch.march_plain.candidates * dirs_t.shape[1]),
                           "device_ms": profile_frames(lambda a=args: kmarch.march(*a),
                                                       5)["device_ms"]}
            if name == "both_720p":  # the culled headline's K1, timed
                args = (st["on"][0].starts, st["on"][1], dirs_t, cfg, 128)
                times["culled"] = (k1_time(args, {}), design("march", cfg, 128))
            key = lambda cf: render(sc, c, cf.replace(order="key", chunk_skip_transmittance=1e-3),
                                    method="gpu")["rgb"]
            win = lambda cf: render(sc, c, cf, method="gpu")["rgb"]
        else:
            k1 = {}
            for tag, cf in (("on", cfg), ("off", off_cfg)):
                rec = []
                kmesh.render_with_mesh_fast(sc, mesh, c, cf, record=rec)
                args, kw = rec[0]["k1"]
                cull_err = max(cull_err, k1_check("K1cull", f"{name} {tag} segment", args, kw))
                k1[tag] = {"kept_pairs": int(args[0][-1]),
                           "segment_slots": kmarch.march_plain.candidates,
                           "significant_share": kmarch.march_plain.significant
                           / max(1, kmarch.march_plain.candidates * args[2].shape[1]),
                           "device_ms": profile_frames(lambda a=args, k=kw: kmarch.march(*a, **k),
                                                       5)["device_ms"]}
            check(k1["on"]["kept_pairs"] <= k1["off"]["kept_pairs"],
                  f"{name}: the cull added pairs")
            key = lambda cf: render(sc, c, cf.replace(order="key", bounce_order="key",
                                                      chunk_skip_transmittance=1e-3),
                                    mesh=mesh, method="gpu")["rgb"]
            win = lambda cf: render(sc, c, cf, mesh=mesh, method="gpu")["rgb"]
        key_diff = float((key(cfg) - key(off_cfg)).abs().max())
        win_psnr = psnr(win(cfg).cpu().numpy(), win(off_cfg).cpu().numpy())
        log("cull", f"{name}: {json.dumps(k1)}; key order max abs on vs off {key_diff:.3g}, "
                    f"window order on vs off {win_psnr:.2f} dB ({card})")
        check(key_diff <= 5e-4, f"{name}: key-order image moved {key_diff:.3g} under the cull")
        cull_stats[name] = {**k1, "key_max_abs": key_diff, "window_psnr_on_vs_off": win_psnr}
    # window order on the goldens with the culls, against the exact oracle
    golden_psnr = {}
    for gname, cull_kw in (("pinhole_720p", dict(conic_cull=True)),
                           ("pinhole_720p", dict(row_span=True)),
                           ("pinhole_720p", dict(conic_cull=True, row_span=True)),
                           ("fisheye_720", dict(fisheye_cull=True))):
        z = np.load(ROOT / "data" / "golden" / f"{gname}.npz")
        n, seed, width, height, hm, fisheye = (int(v) for v in z["meta"])
        gcfg = RenderConfig(hit_multiplicity=hm, order="window", march_chunk=128,
                            camera_model=CameraModel.FISHEYE if fisheye else CameraModel.PINHOLE)
        gsc = random_scene(n, seed=seed, device=dev)
        gcam = cameras.Camera.create(eye=GOLDEN_EYE, lookat=(0.0, 0.0, 0.0), width=width,
                                     height=height, device=dev)
        on, off = (psnr(render(gsc, gcam, cf, method="gpu")["rgb"].cpu().numpy(),
                        z["rgb"].astype(np.float32)) for cf in (gcfg.replace(**cull_kw), gcfg))
        tag = f"{gname} " + "+".join(cull_kw)
        golden_psnr[tag] = (on, off)
        log("cull", f"{tag} window order vs exact oracle: {on:.2f} dB on, {off:.2f} dB off")
        check(on >= PSNR_GOLDEN and on >= off - 1.0, f"{tag}: culled window PSNR {on:.2f}")

    # K2 at each culled binning's channel count, at its capacity
    g = torch.Generator(device=dev).manual_seed(2)
    k2 = {}
    scan_err = 0
    for C, cap in sorted(channels.items()):
        x = torch.randint(-2**31, 2**31 - 1, (C, cap), dtype=torch.int32, device=dev,
                          generator=g)
        got = kscan.multi_cumsum_i32(x)
        want = torch.cumsum(x, dim=1).to(torch.int32)
        check(torch.equal(got, want), f"K2 at {C} channels differs from torch.cumsum")
        k2[C] = {"cap": cap,
                 "ms": statistics.median(cuda_ms(lambda: kscan.multi_cumsum_i32(x), 20)),
                 "device_ms": profile_frames(lambda: kscan.multi_cumsum_i32(x), 20)["device_ms"],
                 "plain_ms": statistics.median(cuda_ms(
                     lambda: kscan.multi_cumsum_i32_plain(x), 20)),
                 "library_ms": statistics.median(cuda_ms(lambda: torch.cumsum(x, dim=1), 20)),
                 **dict(zip(("bound_ms", "bound_by"), bound(2 * x.numel() * 4, x.numel()))),
                 **scan_design(x)}
        log("K2", f"{C} channels x {cap}: exact; {json.dumps(k2[C])} ({card})")
    k3_crafted = k3_wide_crafted((1024,))
    log("phase", f"wide tiles and culls in {time.perf_counter() - t_phase:.1f} s")

    src = f"{PKG}/csrc"
    k1_src = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    k3_src = "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189"
    sub = lambda t, d: {"ms": t[0], "device_ms": t[3], "plain_ms": t[1], "bound_ms": t[2][0],
                        "bound_by": t[2][1], "blocks_per_sm": d["blocks_per_sm"],
                        "registers": d["registers"], "spill_store_bytes": d["spill_store_bytes"],
                        "spill_load_bytes": d["spill_load_bytes"]}
    row = lambda name, source, replaces, launches, err, t, d, more=None: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
        "bound_ms": t[2][0], "bound_by": t[2][1], "library_ms": None, "device_ms": t[3],
        **d, **(more or {})}
    k1_sub = lambda names: {n: sub(times[n][0], times[n][1]) for n in names}
    k3_sub = lambda names: {n: sub(times[n][2], times[n][3]) for n in names}
    k2_first = k2[min(k2)]
    rows = [
        row("march_wide_save_tin", "march.cuh", k1_src,
            main["save_tin_launches"] + main["sh_key_save_tin_launches"],
            max(errs[n][0] for n in runs if n.startswith("key")), times["key_sh0_1024"][0],
            times["key_sh0_1024"][1], {"rays": 1024, **k1_sub(("key_sh0_512", "key_sh3_1024"))}),
        row("march_wide_window_save_tin", "march.cuh", k1_src,
            main["window_save_tin_launches"] + main["sh_save_tin_launches"],
            max(errs[n][0] for n in runs if n.startswith("window")), times["window_sh0_1024"][0],
            times["window_sh0_1024"][1],
            {"rays": 1024, **k1_sub(("window_sh0_512", "window_sh3_1024"))}),
        row("march_bwd_wide", "march_bwd.cuh", k3_src, main["march_bwd"],
            max(max(e[1] for e in errs.values()), oe3), times["key_sh0_1024"][2],
            times["key_sh0_1024"][3],
            {"rays": 1024, **k3_sub(("window_sh0_1024", "key_sh3_1024", "window_sh3_1024",
                                     "key_sh0_512", "window_sh0_512")),
             "origins_1024": sub(*times["bwd_origin"]), "crafted_max_abs_err": k3_crafted}),
        row("march_wide_origin_quad", "march.cuh", k1_src, main["origin_quad_launches"],
            max(frame_err.values()), *times["origin_quad"], {"rays": 1024}),
        row("march_wide_origin_quad_save_tin", "march.cuh", k1_src,
            main["origin_quad_save_tin_launches"], oe1, *times["origin_quad_save_tin"],
            {"rays": 1024}),
        row("march_culled", "march.cuh", k1_src, main["launches"], cull_err, *times["culled"],
            {"culls": cull_stats, "goldens_window_psnr_on_off": golden_psnr}),
        {"name": "multi_cumsum_i32_culled", "route": "cuda", "source": f"{src}/scan.cu",
         "replaces": "gaussian_ray_tracing_tpu/ops/scan.py:81",
         "launches": main["scan_culled_frames"], "max_abs_err": scan_err, "ms": k2_first["ms"],
         "plain_ms": k2_first["plain_ms"], "bound_ms": k2_first["bound_ms"],
         "bound_by": k2_first["bound_by"], "library_ms": k2_first["library_ms"],
         "channels": k2},
    ]
    return rows + wider_tile_phase(dev, card, scene, pose, views, init)


def wider_tile_phase(dev, card: str, scene, pose, views, init) -> list:
    """Tiles of 1152 to 8192 rays (a multiple of 128, one ray a thread): K1 and K3
    as thread-block clusters, K4 split over blocks. The main path, every
    count zeroed just before and read just after: the 1280x720 headline of
    `scene` (random_scene(100k, seed 0), bench config) through
    GaussianRayTracer on 64x32 and 64x64 tiles in window, key and merge
    order; Trainer(method="gpu").fit on the training row's view 0 (512x512,
    `init` = random_scene(50k, seed 1)) on 64x32 tiles (5 steps in key
    order, whose loss must fall, 3 in window order); render_rolling's
    1280x720 frame on 64x32 tiles (per-ray origins, the scalar response);
    the rolling 720p frame on the per-ray-origin quad response at R = 2048
    (window order, the centroid's tree across the cluster); and the fisheye
    glass_front mesh frame on 64x32 tiles through GaussianRayTracer (K4 split
    in two blocks a tile, K1's segments and block mode as clusters). Then
    each launch of the new builds held against its plain version (K1 at the
    K1 bars, K3 at the K3 bars with two launches bit-identical, K4 bit for
    bit with its counts those of pretest_stats), timed against it with its
    bound and `design` at its R (cluster size, registers, spills, resident
    clusters), the training streams and the glass_front bounces at R = 4096
    too; the frames against the plain path's; the crafted calls of K1 merge
    order and of K3 at R = 2048 and 8192 bit for bit as their parent
    commits' (merge_cluster_crafted, k3_wide_crafted). Returns the kernel
    rows."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import CameraModel, MeshType, RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as kmesh
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        prepare_pair_stream, prepare_train_stream,
    )
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
    from gaussian_ray_tracing_tpu_torch.models.rolling import (
        prepare_rolling_stream, render_rolling,
    )
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_sphere
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    t_phase = time.perf_counter()
    cam = lambda w, h, dx=0.0: cameras.Camera.create(
        eye=(GOLDEN_EYE[0] + dx, GOLDEN_EYE[1], GOLDEN_EYE[2]), lookat=(0.0, 0.0, 0.0),
        width=w, height=h, device=dev)
    tiles = {2048: (64, 32), 4096: (64, 64)}
    sized = lambda cfg, R: cfg.replace(tile_w=tiles[R][0], tile_h=tiles[R][1])
    bench = RenderConfig(**BENCH_KW)
    heads = {(order, R): sized(bench, R).replace(order=order)
             for R in tiles for order in ("window", "key", "merge")}
    cam0, target0 = views[0]
    runs = {"key": sized(RenderConfig(**TRAIN_KW), 2048),
            "window": sized(RenderConfig(hit_multiplicity=1, order="window", march_chunk=128),
                            2048)}
    steps = {"key": 5, "window": 3}
    roll_cfg = sized(bench, 2048)
    cam_a, cam_b = cam(1280, 720), cam(1280, 720, 0.05)
    fish = roll_cfg.replace(camera_model=CameraModel.FISHEYE)
    front = make_sphere((0.0, 0.0, 1.6), device=dev).with_type(MeshType.GLASS)
    at_front = np.eye(4, dtype=np.float32)
    at_front[:3, 3] = (0.0, 0.0, 1.6)

    def tracer(cfg, c, mesh=False):
        tr = GaussianRayTracer(scene=scene, config=cfg.replace(camera_model=CameraModel.PINHOLE))
        tr.set_camera_model(cfg.camera_model.value)
        tr.set_size(c.width, c.height)
        tr.update_camera(c)
        if mesh:
            tr.update_instance_transform(tr.create_sphere(mesh_type="glass"), at_front)
        return tr

    head_tr = {k: tracer(cfg, pose) for k, cfg in heads.items()}
    fish_tr = tracer(fish, cam(1280, 720), mesh=True)

    # --- the main path, every count zeroed just before ---
    counts = {"march": ("launches", "cluster_launches", "merge_launches", "save_tin_launches",
                        "window_save_tin_launches", "origin_launches", "origin_quad_launches",
                        "segment_launches", "block_launches"),
              "march_bwd": ("launches", "cluster_launches"),
              "closest_hit": ("launches", "split_launches")}
    fns = {"march": kmarch.march, "march_bwd": kbwd.march_bwd,
           "closest_hit": ktri.closest_hit_blocks}

    def read():
        return {f"{k}.{a}": getattr(fns[k], a) for k, attrs in counts.items() for a in attrs}

    for k, attrs in counts.items():
        for a in attrs:
            setattr(fns[k], a, 0)
    main, frames = {}, {}
    for key, tr in head_tr.items():
        before = kmarch.march.cluster_launches
        frames[key] = tr.render()["rgb"]
        torch.cuda.synchronize()
        main[key] = kmarch.march.cluster_launches - before
    losses = {}
    for name, cfg in runs.items():
        trainer = ktrain.Trainer(GaussianModel.from_scene(init), config=cfg, lr=2e-3, method="gpu")
        losses[name] = trainer.fit([views[0]], steps=steps[name])
        check(all(np.isfinite(losses[name])), f"wider tiles {name}: bad losses {losses[name]}")
    check(losses["key"][-1] < losses["key"][0],
          f"2048-ray key training: the loss did not fall {losses['key']}")
    rolled = render_rolling(scene, cam_a, cam_b, roll_cfg)["rgb"]
    frame = prepare_rolling_stream(scene, cam_a, cam_b, roll_cfg, train=True)
    starts_f, rows_f, dirs_f, origins_f, _, n_pairs_f = frame
    rgb_f, _ = kmarch.march(starts_f, rows_f, dirs_f, roll_cfg, 128, origins_t=origins_f,
                            quad=True)
    glass = fish_tr.render()["rgb"]
    torch.cuda.synchronize()
    counted = read()
    log("wider", f"headline frames {sorted(main.items())}, training losses "
                 f"{json.dumps({k: [round(x, 6) for x in v] for k, v in losses.items()})}, "
                 f"rolling frames, fisheye glass_front; launches {counted}")
    for k in ("march.cluster_launches", "march.merge_launches", "march.save_tin_launches",
              "march.window_save_tin_launches", "march.origin_launches",
              "march.origin_quad_launches", "march.segment_launches", "march.block_launches",
              "march_bwd.cluster_launches", "closest_hit.split_launches"):
        check(counted[k] > 0, f"wider tiles: {k} was not launched on the main path: {counted}")
    check(all(v > 0 for v in main.values()), f"a headline frame ran no cluster build: {main}")
    for name, img in (("rolling", rolled), ("origin quad rolling", rgb_f),
                      ("fisheye glass_front", glass), *((f"headline {k}", v)
                                                        for k, v in frames.items())):
        check(bool(torch.isfinite(img).all()) and float(img.max()) > 0.1,
              f"wider tiles {name}: black or not finite")

    # --- frames against the plain path, and each launch against its plain
    # version, timed ---
    def timed(fn, plain, bound_of):
        return (statistics.median(cuda_ms(fn, 10)), statistics.median(cuda_ms(plain, 2)),
                bound_of(), profile_frames(fn, 5)["device_ms"])

    frame_psnr = {}
    for (order, R), cfg in heads.items():
        frame_psnr[f"{order}_{R}"] = psnr(frames[order, R].cpu().numpy(),
                                          render(scene, pose, cfg, method="plain")["rgb"]
                                          .cpu().numpy())
    frame_psnr["rolling_2048"] = psnr(
        rolled.cpu().numpy(), render_rolling(scene, cam_a, cam_b, roll_cfg,
                                             use_kernels=False)["rgb"].cpu().numpy())
    log("wider", f"frames vs the plain path (dB): {json.dumps(frame_psnr)}")
    for name, p in frame_psnr.items():
        check(p >= PSNR_FRAME, f"wider tiles: frame {name} {p:.2f} dB against the plain path")

    times, errs = {}, {}
    for (order, R), cfg in heads.items():
        stream, feats, n_pairs = prepare_pair_stream(scene, pose, cfg, 1 << 22)
        check(int(stream.n_dropped) == 0, f"headline {order} R={R}: pairs dropped")
        dirs_t = tile_rays(cameras.generate_rays(pose, cfg)[1], *tiles[R])
        args = (stream.starts, feats, dirs_t, cfg, 128)
        name = f"{order}_{R}"
        errs[name] = k1_check("K1cluster", f"headline 720p 100k {name} ({n_pairs} pairs)", args)
        a = kmarch.march(*args)
        check(all(torch.equal(x, y) for x, y in zip(a, kmarch.march(*args))),
              f"K1 {name}: two launches differ")
        times[name] = (timed(lambda: kmarch.march(*args), lambda: kmarch.march_plain(*args),
                             lambda: march_bound(args, {}, kmarch.march_plain)),
                       design("march", cfg, 128, rays=R))
    # the training streams of the main path's runs, and at R = 4096
    for name, R in ((n, R) for R in tiles for n in runs):
        cfg = sized(runs[name], R)
        with torch.no_grad():
            stream, trows, n_pairs = prepare_train_stream(init, cam0, cfg)
        starts, trows = stream.starts, trows.detach().contiguous()
        dirs_t = tile_rays(cameras.generate_rays(cam0, cfg)[1], *tiles[R])
        chunk = chunk_for(cfg)
        kw = {"origins_t": cam0.eye.expand(dirs_t.shape).contiguous()} if name == "window" else {}
        fwd = lambda f: f(starts, trows, dirs_t, cfg, chunk, save_tin=True, **kw)
        got = fwd(kmarch.march)
        torch.cuda.synchronize()
        e1 = k1_train_check(f"{name} 512x512 R={R} c={chunk} ({n_pairs} pairs)", got,
                            fwd(kmarch.march_plain))
        gen = torch.Generator(device=dev).manual_seed(0)
        d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dev)
        d_t = torch.randn(dirs_t.shape[:2], generator=gen, device=dev)
        bargs = (starts, trows, dirs_t, cam0.eye, got[2], got[3], d_rgb, d_t, cfg, chunk)
        e3 = k3_check(f"{name} 512x512 R={R} c={chunk}", bargs)
        errs[f"train_{name}_{R}"] = e1
        errs[f"bwd_{name}_{R}"] = e3
        times[f"train_{name}_{R}"] = (
            timed(lambda: fwd(kmarch.march), lambda: fwd(kmarch.march_plain),
                  lambda: march_bound((starts, trows, dirs_t, cfg, chunk),
                                      {"save_tin": True, **kw}, kmarch.march_plain,
                                      tin=got[2])),
            design("march", cfg, chunk, scalar=bool(kw), train=True, rays=R))
        times[f"bwd_{name}_{R}"] = (
            timed(lambda: kbwd.march_bwd(*bargs), lambda: kbwd.march_bwd_plain(*bargs),
                  lambda: bwd_bound(bargs, kbwd.march_bwd_plain)),
            design("march_bwd", cfg, chunk, rays=R))
    for order in ("window", "key", "merge"):
        args = (starts_f, rows_f, dirs_f, roll_cfg.replace(order=order), 128)
        kw = {"origins_t": origins_f, "quad": True}
        errs[f"origin_quad_{order}"] = k1_check(
            "K1cluster", f"rolling 720p 100k R=2048 per-ray-origin quad {order} ({n_pairs_f} "
                         f"pairs)", args, kw)
        if order == "window":
            times["origin_quad"] = (
                timed(lambda: kmarch.march(*args, **kw), lambda: kmarch.march_plain(*args, **kw),
                      lambda: march_bound(args, kw, kmarch.march_plain)),
                design("march", roll_cfg, 128, quad=True, rays=2048))
    # every bounce of the fisheye glass_front frame (the main path's at R =
    # 2048, and at R = 4096); K4 timed on bounce 1 (per-ray origins)
    k4_err, k1_mesh = 0.0, 0.0
    for R in tiles:
        rec = []
        kmesh.render_with_mesh_fast(scene, front, cam(1280, 720), sized(fish, R), record=rec)
        for b, r in enumerate(rec):
            args, kw = r["k4"]
            check(args[3].shape[1] == R, f"glass_front bounce {b}: {args[3].shape[1]} rays")
            k4_err = max(k4_err, k4_check("K4split", f"fisheye glass_front R={R} bounce {b}",
                                          args, kw)[0])
            a1, kw1 = r["k1"]
            k1_mesh = max(k1_mesh, k1_check("K1cluster", f"fisheye glass_front R={R} bounce "
                                                         f"{b}", a1, kw1))
        k4_args, k4_kw = rec[1]["k4"] if len(rec) > 1 else rec[0]["k4"]
        times[f"k4_{R}"] = (timed(lambda: ktri.closest_hit_blocks(*k4_args, **k4_kw),
                                  lambda: ktri.closest_hit_blocks_plain(*k4_args, **k4_kw),
                                  lambda: tri_bound(k4_args, k4_kw)),
                            tri_design(k4_args, k4_kw))
    crafted = merge_cluster_crafted("K1cluster", (2048, 8192))
    k3_crafted = k3_wide_crafted((2048, 8192))
    for name, (t, d) in times.items():
        log("kernel", f"wider {name}: {t[0]:.3f} ms (device {t[3]:.3f}), plain {t[1]:.3f} ms, "
                      f"bound {t[2][0]:.4f} ms ({t[2][1]}); cluster {d.get('cluster_blocks')} "
                      f"blocks, {d.get('resident_clusters')} resident, {d['registers']} "
                      f"registers, spills {d['spill_store_bytes']} B ({card})")
    log("phase", f"wider tiles in {time.perf_counter() - t_phase:.1f} s")

    src = f"{PKG}/csrc"
    k1_src = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    k3_src = "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189"
    sub = lambda t, d: {"ms": t[0], "device_ms": t[3], "plain_ms": t[1], "bound_ms": t[2][0],
                        "bound_by": t[2][1], **d}
    row = lambda name, source, replaces, launches, err, key, more=None: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times[key][0][0],
        "plain_ms": times[key][0][1], "bound_ms": times[key][0][2][0],
        "bound_by": times[key][0][2][1], "library_ms": None, "device_ms": times[key][0][3],
        **times[key][1], **(more or {})}
    return [
        row(f"march_cluster_{order}", "march.cuh", k1_src,
            main[order, 2048] + main[order, 4096],
            max(errs[f"{order}_2048"], errs[f"{order}_4096"]),
            f"{order}_2048", {"rays": 2048, "rays_4096": sub(*times[f"{order}_4096"]),
                              "frame_psnr_vs_plain": {R: frame_psnr[f"{order}_{R}"]
                                                      for R in tiles},
                              **({"crafted_max_abs_err": crafted} if order == "merge" else {})})
        for order in ("window", "key", "merge")
    ] + [
        row("march_cluster_save_tin", "march.cuh", k1_src, counted["march.save_tin_launches"],
            max(errs["train_key_2048"], errs["train_key_4096"]), "train_key_2048",
            {"rays": 2048, "rays_4096": sub(*times["train_key_4096"])}),
        row("march_cluster_window_save_tin", "march.cuh", k1_src,
            counted["march.window_save_tin_launches"],
            max(errs["train_window_2048"], errs["train_window_4096"]), "train_window_2048",
            {"rays": 2048, "rays_4096": sub(*times["train_window_4096"])}),
        row("march_bwd_cluster", "march_bwd.cuh", k3_src, counted["march_bwd.cluster_launches"],
            max(v for k, v in errs.items() if k.startswith("bwd_")), "bwd_key_2048",
            {"rays": 2048, "key_4096": sub(*times["bwd_key_4096"]),
             "window_2048": sub(*times["bwd_window_2048"]),
             "window_4096": sub(*times["bwd_window_4096"]), "crafted_max_abs_err": k3_crafted}),
        row("march_cluster_origin_quad", "march.cuh", k1_src,
            counted["march.origin_quad_launches"],
            max(errs[f"origin_quad_{o}"] for o in ("window", "key", "merge")), "origin_quad",
            {"rays": 2048, "mesh_segments_blocks_max_abs_err": k1_mesh}),
        row("closest_hit_split", "tri.cu", "gaussian_ray_tracing_tpu/ops/pallas_tri.py:77",
            counted["closest_hit.split_launches"], k4_err, "k4_2048",
            {"rays": 2048, "rays_4096": sub(*times["k4_4096"])}),
    ]


def huge_tile_phase(dev, card: str, scene, pose, views, init) -> list:
    """Tiles of more than 8192 rays (any multiple of 128): K1 and K3 march
    ceil(R / 8192) rays a thread in a cluster of 8 blocks of 1024 threads,
    K4 splits a tile over ceil(R / 1024) blocks. The main path, every count
    zeroed just before and read just after: the 1280x720 headline of
    `scene` (random_scene(100k, seed 0), bench config) through
    GaussianRayTracer on 128x128 tiles (R = 16,384) in window, key, merge
    and oddeven order, on 130x64 (8320: one slot of 128 rays past a
    cluster's 8192), 192x128 (24,576) and 256x256 (65,536: the centroid's
    tree past a block's shared memory) in window order;
    Trainer(method="gpu").fit on the training row's view 0 (512x512, `init`
    = random_scene(50k, seed 1)) on 128x128 tiles (5 key steps, whose loss
    must fall, 3 window steps); render_rolling's 1280x720 frame on 128x128
    tiles (per-ray origins, the scalar response) and the rolling 720p frame
    on the per-ray-origin quad response at 128x128 and 256x256; the fisheye
    glass_front mesh frame on 128x128 tiles through GaussianRayTracer (K4
    over 16 blocks a tile, K1's segments and block mode); one sharded
    frame (render_pallas_sharded, 4 shards of the card) on 128x128 tiles;
    and one key-order render of the 512x512 view as a single tile (R =
    262,144, 32 rays a thread). Then each launch held against its plain
    version (K1 at the K1 bars, K3 at the K3 bars with two launches
    bit-identical, K4 bit for bit with its counts those of pretest_stats),
    timed against it with its bound and `design`, and beside the same frame
    at 64x64 tiles (R = 4096) and 16x16 in turns; the crafted calls of K1
    merge order and of K3 at R = 8320 and 16,384 bit for bit as their
    parent commits' (merge_cluster_crafted, k3_wide_crafted). Returns the
    kernel rows."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import CameraModel, MeshType, RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as kmesh
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        prepare_pair_stream, prepare_train_stream, render_gpu,
    )
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
    from gaussian_ray_tracing_tpu_torch.models.rolling import (
        prepare_rolling_stream, render_rolling,
    )
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri
    from gaussian_ray_tracing_tpu_torch.parallel import mesh as pmesh
    from gaussian_ray_tracing_tpu_torch.parallel import sharded as S
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_sphere
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    t_phase = time.perf_counter()
    cam = lambda w, h, dx=0.0: cameras.Camera.create(
        eye=(GOLDEN_EYE[0] + dx, GOLDEN_EYE[1], GOLDEN_EYE[2]), lookat=(0.0, 0.0, 0.0),
        width=w, height=h, device=dev)
    tiles = {8320: (130, 64), 16384: (128, 128), 24576: (192, 128), 65536: (256, 256),
             4096: (64, 64), 256: (16, 16)}
    sized = lambda cfg, R: cfg.replace(tile_w=tiles[R][0], tile_h=tiles[R][1])
    bench = RenderConfig(**BENCH_KW)
    heads = {(order, 16384): sized(bench, 16384).replace(order=order)
             for order in ("window", "key", "merge", "oddeven")}
    heads.update({("window", R): sized(bench, R) for R in (8320, 24576, 65536)})
    cam0, target0 = views[0]
    runs = {"key": sized(RenderConfig(**TRAIN_KW), 16384),
            "window": sized(RenderConfig(hit_multiplicity=1, order="window", march_chunk=128),
                            16384)}
    steps = {"key": 5, "window": 3}
    roll_cfg = sized(bench, 16384)
    cam_a, cam_b = cam(1280, 720), cam(1280, 720, 0.05)
    fish = roll_cfg.replace(camera_model=CameraModel.FISHEYE)
    at_front = np.eye(4, dtype=np.float32)
    at_front[:3, 3] = (0.0, 0.0, 1.6)
    front = make_sphere((0.0, 0.0, 1.6), device=dev).with_type(MeshType.GLASS)
    single = RenderConfig(**TRAIN_KW).replace(tile_w=512, tile_h=512, march_chunk=128)
    shard_mesh = pmesh.make_mesh(4, devices=[dev] * 4)

    def tracer(cfg, c, mesh=False):
        tr = GaussianRayTracer(scene=scene, config=cfg.replace(camera_model=CameraModel.PINHOLE))
        tr.set_camera_model(cfg.camera_model.value)
        tr.set_size(c.width, c.height)
        tr.update_camera(c)
        if mesh:
            tr.update_instance_transform(tr.create_sphere(mesh_type="glass"), at_front)
        return tr

    head_tr = {k: tracer(cfg, pose) for k, cfg in heads.items()}
    fish_tr = tracer(fish, cam(1280, 720), mesh=True)

    # --- the main path, every count zeroed just before ---
    counts = {"march": ("launches", "slot_launches", "merge_launches", "oddeven_launches",
                        "save_tin_launches", "window_save_tin_launches", "origin_launches",
                        "origin_quad_launches", "segment_launches", "block_launches"),
              "march_bwd": ("launches", "slot_launches"),
              "closest_hit": ("launches", "split_launches")}
    fns = {"march": kmarch.march, "march_bwd": kbwd.march_bwd,
           "closest_hit": ktri.closest_hit_blocks}

    def read():
        return {f"{k}.{a}": getattr(fns[k], a) for k, attrs in counts.items() for a in attrs}

    for k, attrs in counts.items():
        for a in attrs:
            setattr(fns[k], a, 0)
    main, frames = {}, {}
    for key, tr in head_tr.items():
        before = kmarch.march.slot_launches
        frames[key] = tr.render()["rgb"]
        torch.cuda.synchronize()
        main[key] = kmarch.march.slot_launches - before
    losses = {}
    for name, cfg in runs.items():
        trainer = ktrain.Trainer(GaussianModel.from_scene(init), config=cfg, lr=2e-3, method="gpu")
        losses[name] = trainer.fit([views[0]], steps=steps[name])
        check(all(np.isfinite(losses[name])), f"huge tiles {name}: bad losses {losses[name]}")
    check(losses["key"][-1] < losses["key"][0],
          f"16,384-ray key training: the loss did not fall {losses['key']}")
    rolled = render_rolling(scene, cam_a, cam_b, roll_cfg)["rgb"]
    quad_frames = {}
    for R in (16384, 65536):
        frame = prepare_rolling_stream(scene, cam_a, cam_b, sized(bench, R), train=True)
        quad_frames[R] = frame
        starts_f, rows_f, dirs_f, origins_f, _, _ = frame
        rgb_q, _ = kmarch.march(starts_f, rows_f, dirs_f, sized(bench, R), 128,
                                origins_t=origins_f, quad=True)
        check(bool(torch.isfinite(rgb_q).all()) and float(rgb_q.max()) > 0.1,
              f"huge tiles: the per-ray-origin quad frame at R={R} is black or not finite")
    glass = fish_tr.render()["rgb"]
    sharded = S.render_pallas_sharded(scene, pose, heads["window", 16384], shard_mesh)
    before = kmarch.march.slot_launches
    one_tile = render(init, cam0, single, method="gpu")["rgb"]
    torch.cuda.synchronize()
    single_launches = kmarch.march.slot_launches - before
    counted = read()
    log("huge", f"headline frames {sorted(main.items())}, training losses "
                f"{json.dumps({k: [round(x, 6) for x in v] for k, v in losses.items()})}, "
                f"rolling frames, fisheye glass_front, sharded frame, one 512x512 tile; "
                f"launches {counted}")
    for k in ("march.slot_launches", "march.merge_launches", "march.oddeven_launches",
              "march.save_tin_launches", "march.window_save_tin_launches",
              "march.origin_launches", "march.origin_quad_launches", "march.segment_launches",
              "march.block_launches", "march_bwd.slot_launches", "closest_hit.split_launches"):
        check(counted[k] > 0, f"huge tiles: {k} was not launched on the main path: {counted}")
    check(all(v > 0 for v in main.values()), f"a headline frame ran no slot launch: {main}")
    check(sharded["n_dropped"] == 0 and torch.equal(sharded["rgb"], frames["window", 16384]),
          "huge tiles: the sharded frame is not the GaussianRayTracer frame bit for bit")
    for name, img in (("rolling", rolled), ("fisheye glass_front", glass),
                      ("one 512x512 tile", one_tile),
                      *((f"headline {k}", v) for k, v in frames.items())):
        check(bool(torch.isfinite(img).all()) and float(img.max()) > 0.1,
              f"huge tiles {name}: black or not finite")

    # --- frames against the plain path, and each launch against its plain
    # version, timed ---
    def timed(fn, plain, bound_of, what):
        ev = statistics.median(cuda_ms(fn, 10))
        return (ev, statistics.median(cuda_ms(plain, 2)), bound_of(),
                device_reading(fn, ev, what))

    frame_psnr = {}
    for (order, R), cfg in heads.items():
        frame_psnr[f"{order}_{R}"] = psnr(frames[order, R].cpu().numpy(),
                                          render(scene, pose, cfg, method="plain")["rgb"]
                                          .cpu().numpy())
    frame_psnr["rolling_16384"] = psnr(
        rolled.cpu().numpy(), render_rolling(scene, cam_a, cam_b, roll_cfg,
                                             use_kernels=False)["rgb"].cpu().numpy())
    frame_psnr["single_tile_262144"] = psnr(one_tile.cpu().numpy(),
                                            render(init, cam0, single, method="plain")["rgb"]
                                            .cpu().numpy())
    log("huge", f"frames vs the plain path (dB): {json.dumps(frame_psnr)}")
    for name, p in frame_psnr.items():
        check(p >= PSNR_FRAME, f"huge tiles: frame {name} {p:.2f} dB against the plain path")

    times, errs, beside = {}, {}, {}

    def head_args(sc, cfg, c):
        stream, feats, n_pairs = prepare_pair_stream(sc, c, cfg, 1 << 22)
        check(int(stream.n_dropped) == 0, f"{cfg.order} {cfg.tile_w}x{cfg.tile_h}: pairs dropped")
        dirs_t = tile_rays(cameras.generate_rays(c, cfg)[1], cfg.tile_w, cfg.tile_h)
        return (stream.starts, feats, dirs_t, cfg, chunk_for(cfg)), n_pairs

    for (order, R), cfg in heads.items():
        args, n_pairs = head_args(scene, cfg, pose)
        name = f"{order}_{R}"
        errs[name] = k1_check("K1huge", f"headline 720p 100k {name} ({n_pairs} pairs)", args)
        a = kmarch.march(*args)
        check(all(torch.equal(x, y) for x, y in zip(a, kmarch.march(*args))),
              f"K1 {name}: two launches differ")
        times[name] = (timed(lambda: kmarch.march(*args), lambda: kmarch.march_plain(*args),
                             lambda: march_bound(args, {}, kmarch.march_plain), name),
                       design("march", cfg, 128, rays=R))
        if R == 16384:  # beside the same frame at R = 4096 and 256, in turns
            other = {r: head_args(scene, sized(cfg, r), pose)[0] for r in (4096, 256)}
            fns_t = {"16384": lambda: kmarch.march(*args),
                     **{str(r): (lambda x=x: kmarch.march(*x)) for r, x in other.items()}}
            beside[name] = turns(fns_t, reps=10, device=False)
    # the single 512x512 tile, key order
    args, n_pairs = head_args(init, single, cam0)
    errs["single"] = k1_check("K1huge", f"512x512 50k one tile R=262144 ({n_pairs} pairs)", args)
    times["single"] = (timed(lambda: kmarch.march(*args), lambda: kmarch.march_plain(*args),
                             lambda: march_bound(args, {}, kmarch.march_plain), "single"),
                       design("march", single, 128, rays=262144))
    other = {r: head_args(init, sized(single, r), cam0)[0] for r in (16384, 4096, 256)}
    beside["single"] = turns({"262144": lambda: kmarch.march(*args),
                              **{str(r): (lambda x=x: kmarch.march(*x)) for r, x in other.items()}},
                             reps=5, device=False)
    # the training streams of the main path's runs
    for name, cfg in runs.items():
        R = 16384
        with torch.no_grad():
            stream, trows, n_pairs = prepare_train_stream(init, cam0, cfg)
        starts, trows = stream.starts, trows.detach().contiguous()
        dirs_t = tile_rays(cameras.generate_rays(cam0, cfg)[1], *tiles[R])
        chunk = chunk_for(cfg)
        kw = {"origins_t": cam0.eye.expand(dirs_t.shape).contiguous()} if name == "window" else {}
        fwd = lambda f: f(starts, trows, dirs_t, cfg, chunk, save_tin=True, **kw)
        got = fwd(kmarch.march)
        torch.cuda.synchronize()
        e1 = k1_train_check(f"{name} 512x512 R={R} c={chunk} ({n_pairs} pairs)", got,
                            fwd(kmarch.march_plain))
        gen = torch.Generator(device=dev).manual_seed(0)
        d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dev)
        d_t = torch.randn(dirs_t.shape[:2], generator=gen, device=dev)
        bargs = (starts, trows, dirs_t, cam0.eye, got[2], got[3], d_rgb, d_t, cfg, chunk)
        e3 = k3_check(f"{name} 512x512 R={R} c={chunk}", bargs)
        errs[f"train_{name}"] = e1
        errs[f"bwd_{name}"] = e3
        times[f"train_{name}"] = (
            timed(lambda: fwd(kmarch.march), lambda: fwd(kmarch.march_plain),
                  lambda: march_bound((starts, trows, dirs_t, cfg, chunk),
                                      {"save_tin": True, **kw}, kmarch.march_plain,
                                      tin=got[2]), f"train_{name}"),
            design("march", cfg, chunk, scalar=bool(kw), train=True, rays=R))
        times[f"bwd_{name}"] = (
            timed(lambda: kbwd.march_bwd(*bargs), lambda: kbwd.march_bwd_plain(*bargs),
                  lambda: bwd_bound(bargs, kbwd.march_bwd_plain), f"bwd_{name}"),
            design("march_bwd", cfg, chunk, rays=R))
    # the per-ray-origin quad response (every order at 16,384; window at 65,536)
    for R, frame in quad_frames.items():
        starts_f, rows_f, dirs_f, origins_f, _, n_pairs_f = frame
        for order in ("window", "key", "merge") if R == 16384 else ("window",):
            cfg = sized(bench, R).replace(order=order)
            args = (starts_f, rows_f, dirs_f, cfg, 128)
            kw = {"origins_t": origins_f, "quad": True}
            errs[f"origin_quad_{order}_{R}"] = k1_check(
                "K1huge", f"rolling 720p 100k R={R} per-ray-origin quad {order} ({n_pairs_f} "
                          f"pairs)", args, kw)
            if order == "window":
                times[f"origin_quad_{R}"] = (
                    timed(lambda: kmarch.march(*args, **kw),
                          lambda: kmarch.march_plain(*args, **kw),
                          lambda: march_bound(args, kw, kmarch.march_plain),
                          f"origin_quad_{R}"),
                    design("march", cfg, 128, quad=True, rays=R))
    # every bounce of the fisheye glass_front frame on 128x128 tiles; K4
    # timed on bounce 1 (per-ray origins)
    rec = []
    kmesh.render_with_mesh_fast(scene, front, cam(1280, 720), fish, record=rec)
    k4_err, k1_mesh = 0.0, 0.0
    for b, r in enumerate(rec):
        args, kw = r["k4"]
        check(args[3].shape[1] == 16384, f"glass_front bounce {b}: {args[3].shape[1]} rays")
        k4_err = max(k4_err, k4_check("K4huge", f"fisheye glass_front R=16384 bounce {b}",
                                      args, kw)[0])
        a1, kw1 = r["k1"]
        k1_mesh = max(k1_mesh, k1_check("K1huge", f"fisheye glass_front R=16384 bounce {b}",
                                        a1, kw1))
    k4_args, k4_kw = rec[1]["k4"] if len(rec) > 1 else rec[0]["k4"]
    times["k4"] = (timed(lambda: ktri.closest_hit_blocks(*k4_args, **k4_kw),
                         lambda: ktri.closest_hit_blocks_plain(*k4_args, **k4_kw),
                         lambda: tri_bound(k4_args, k4_kw), "k4"),
                   tri_design(k4_args, k4_kw))
    crafted = merge_cluster_crafted("K1huge", (8320, 16384))
    k3_crafted = k3_wide_crafted((8320, 16384))
    for name, (t, d) in times.items():
        log("kernel", f"huge {name}: {t[0]:.3f} ms (device {fms(t[3])}), plain {t[1]:.3f} ms, "
                      f"bound {t[2][0]:.4f} ms ({t[2][1]}); cluster {d.get('cluster_blocks')} "
                      f"blocks, {d.get('resident_clusters')} resident, {d['registers']} "
                      f"registers, spills {d['spill_store_bytes']} B, local "
                      f"{d.get('stack_bytes')} B ({card})")
    for name, t in beside.items():
        log("kernel", f"huge {name} in turns (median event ms): "
                      + ", ".join(f"R={k} {v[0]:.3f}" for k, v in t.items()) + f" ({card})")
    log("phase", f"huge tiles in {time.perf_counter() - t_phase:.1f} s")

    src = f"{PKG}/csrc"
    k1_src = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    k3_src = "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189"
    sub = lambda t, d: {"ms": t[0], "device_ms": t[3], "plain_ms": t[1], "bound_ms": t[2][0],
                        "bound_by": t[2][1], **d}
    row = lambda name, source, replaces, launches, err, key, more=None: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times[key][0][0],
        "plain_ms": times[key][0][1], "bound_ms": times[key][0][2][0],
        "bound_by": times[key][0][2][1], "library_ms": None, "device_ms": times[key][0][3],
        **times[key][1], **(more or {})}
    turns_of = lambda name: {R: v[0] for R, v in beside[name].items()}
    return [
        row(f"march_huge_{order}", "march.cuh", k1_src, main[order, 16384],
            errs[f"{order}_16384"], f"{order}_16384",
            {"rays": 16384, "turns_ms": turns_of(f"{order}_16384"),
             "frame_psnr_vs_plain": frame_psnr[f"{order}_16384"],
             **({f"rays_{R}": {**sub(*times[f"window_{R}"]),
                               "max_abs_err": errs[f"window_{R}"], "launches": main["window", R],
                               "frame_psnr_vs_plain": frame_psnr[f"window_{R}"]}
                 for R in (8320, 24576, 65536)} if order == "window" else {}),
             **({"crafted_max_abs_err": crafted} if order == "merge" else {})})
        for order in ("window", "key", "merge", "oddeven")
    ] + [
        row("march_huge_single_tile_key", "march.cuh", k1_src, single_launches, errs["single"],
            "single",
            {"rays": 262144, "turns_ms": turns_of("single"),
             "frame_psnr_vs_plain": frame_psnr["single_tile_262144"]}),
        row("march_huge_save_tin", "march.cuh", k1_src, counted["march.save_tin_launches"],
            errs["train_key"], "train_key", {"rays": 16384}),
        row("march_huge_window_save_tin", "march.cuh", k1_src,
            counted["march.window_save_tin_launches"], errs["train_window"], "train_window",
            {"rays": 16384}),
        row("march_bwd_huge", "march_bwd.cuh", k3_src, counted["march_bwd.slot_launches"],
            max(errs["bwd_key"], errs["bwd_window"]), "bwd_key",
            {"rays": 16384, "window": sub(*times["bwd_window"]),
             "crafted_max_abs_err": k3_crafted}),
        row("march_huge_origin_quad", "march.cuh", k1_src,
            counted["march.origin_quad_launches"],
            max(v for k, v in errs.items() if k.startswith("origin_quad")), "origin_quad_16384",
            {"rays": 16384, "rays_65536": sub(*times["origin_quad_65536"]),
             "mesh_segments_blocks_max_abs_err": k1_mesh}),
        row("closest_hit_huge", "tri.cu", "gaussian_ray_tracing_tpu/ops/pallas_tri.py:77",
            counted["closest_hit.split_launches"], k4_err, "k4", {"rays": 16384}),
    ]


def window_options_phase(dev, card: str, scene, pose, golden, views, init) -> list:
    """K1's window-order render options and the peak key, and K3's peak-key
    replay, at full width. The main path, each case's launch count zeroed
    just before and read just after: one 1280x720 frame of `scene`
    (random_scene(100k, seed 0)) at `pose` through render(method="gpu") in
    the bench config with composite_scan (window, key and merge order),
    sort_lane_groups (16x16 and 32x32 tiles), sort_alpha_min = 0.05 (with
    sort_repair 64, with 0, and with sort_lane_groups) and window_key
    "peak" (window and merge order); then Trainer(method="gpu").fit, 3
    steps in window order under the peak key, on the training row's view 0
    (512x512, `init` = random_scene(50k, seed 1)). Then every case's K1
    against march_plain on the frame's stream (the K1 bars, and its per-tile
    fired and repaired chunk counts equal to the plain version's), timed in
    turns with the default config's K1 on its own stream (default, option,
    option, default: event ms and profiler device ms), with its bound and
    plain ms, and the 720p golden read through render(method="gpu") in each
    option (for composite_scan and sort_lane_groups, which only change
    rounding and colour packing, >= PSNR_GOLDEN, or in key order, which
    reads ~30 dB without them, within 0.5 dB of the default; logged for the
    others); K1's
    saved carries and K3 under the peak key against their plain versions
    (k1_train_check, k3_check) and timed in turns with the event key's.
    Returns the kernel rows."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        prepare_pair_stream, prepare_train_stream,
    )
    from gaussian_ray_tracing_tpu_torch.models.renderer import render
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    t_phase = time.perf_counter()
    bench = RenderConfig(**BENCH_KW)
    wide = dict(tile_w=32, tile_h=32)
    # name: (config, the launch count that shows it, must it hold the golden)
    cases = {
        "scan_window": (bench.replace(composite_scan=True), "scan_launches", True),
        "scan_key": (bench.replace(order="key", composite_scan=True), "scan_launches", True),
        "scan_merge": (bench.replace(order="merge", composite_scan=True), "scan_launches", True),
        "groups_16x16": (bench.replace(sort_lane_groups=True), "group_launches", True),
        "groups_32x32": (bench.replace(sort_lane_groups=True, **wide), "group_launches", True),
        "alpha_repair64": (bench.replace(sort_alpha_min=0.05), "fire_alpha_launches", False),
        "alpha_repair0": (bench.replace(sort_alpha_min=0.05, sort_repair=0),
                          "fire_alpha_launches", False),
        "alpha_groups": (bench.replace(sort_alpha_min=0.05, sort_lane_groups=True),
                         "fire_alpha_launches", False),
        "peak_window": (bench.replace(window_key="peak"), "peak_launches", False),
        "peak_merge": (bench.replace(order="merge", window_key="peak"), "peak_launches", False),
    }
    # the same frame without the options (order and tiles kept)
    plain_cfg = lambda cfg: RenderConfig(**{**BENCH_KW, "order": cfg.order,
                                            "tile_w": cfg.tile_w, "tile_h": cfg.tile_h})

    # --- the main path, each count zeroed just before ---
    launches = {}
    for name, (cfg, attr, _) in cases.items():
        setattr(kmarch.march, attr, 0)
        out = render(scene, pose, cfg, method="gpu", return_aux=True)
        torch.cuda.synchronize()
        launches[name] = getattr(kmarch.march, attr)
        rgb = out["rgb"]
        check(launches[name] >= 1, f"options {name}: K1 ({attr}) was not launched")
        check(tuple(rgb.shape) == (720, 1280, 3) and bool(torch.isfinite(rgb).all())
              and float(rgb.max()) > 0.1, f"options {name}: bad frame")
        check(out["aux"]["n_dropped"] == 0, f"options {name}: pairs dropped")
    win_peak = RenderConfig(hit_multiplicity=1, order="window", march_chunk=128,
                            window_key="peak")
    kmarch.march.peak_launches = kbwd.march_bwd.peak_launches = 0
    trainer = ktrain.Trainer(GaussianModel.from_scene(init), config=win_peak, lr=2e-3,
                             method="gpu")
    losses = trainer.fit([views[0]], steps=3)
    torch.cuda.synchronize()
    train_launches = {"march": kmarch.march.peak_launches,
                      "march_bwd": kbwd.march_bwd.peak_launches}
    check(train_launches["march"] == 3 and train_launches["march_bwd"] == 3,
          f"peak training: K1 save_tin or K3 did not launch once a step {train_launches}")
    check(all(np.isfinite(losses)), f"peak training: bad losses {losses}")
    log("options", f"main path: {len(cases)} frames 1280x720 100k, launches {launches}; peak "
                   f"training 3 steps 512x512 50k, loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
                   f"launches {train_launches}")

    # --- each case's K1 against its plain version, timed beside the default ---
    ref, gscene, gcam, ghm, _ = golden("pinhole_720p")
    streams, rows, golden_db = {}, [], {}
    k1 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"

    def stream_for(cfg):
        key = (cfg.tile_w, cfg.tile_h)
        if key not in streams:
            stream, feats, n_pairs = prepare_pair_stream(scene, pose, cfg, 1 << 22)
            dirs_t = tile_rays(cameras.generate_rays(pose, cfg)[1], cfg.tile_w, cfg.tile_h)
            streams[key] = (stream.starts, feats, dirs_t, n_pairs)
        return streams[key]

    for name, (cfg, attr, bar) in cases.items():
        starts, feats, dirs_t, n_pairs = stream_for(cfg)
        chunk = chunk_for(cfg)
        args = (starts, feats, dirs_t, cfg, chunk)
        base = plain_cfg(cfg)
        got = kmarch.march(*args, stats=True)
        base_stats = kmarch.march(starts, feats, dirs_t, base, chunk, stats=True)[2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = kmarch.march_plain(*args, stats=True)
        plain_ms = (time.perf_counter() - t0) * 1e3
        b = march_bound(args, {}, kmarch.march_plain)
        err = 0.0
        for part, x, y in (("rgb", got[0], want[0]), ("T_final", got[1], want[1])):
            x, y = x.cpu().numpy(), y.cpu().numpy()
            p, m = psnr(x, y), float(np.abs(x - y).max())
            err = max(err, m)
            check(p >= PSNR_KERNEL and m <= MAXABS_KERNEL,
                  f"K1 {name} vs plain {part}: PSNR {p:.2f} max abs {m:.3g}")
        check(all(torch.equal(x, y) for x, y in zip(got[2], want[2])),
              f"K1 {name}: the kernel's fired or repaired counts differ from the plain version's")
        counts = [int(x.sum()) for x in got[2]]
        base_counts = [int(x.sum()) for x in base_stats]
        t = turns({"default": lambda: kmarch.march(starts, feats, dirs_t, base, chunk),
                   "option": lambda: kmarch.march(*args)})
        with torch.no_grad():
            golden_db[name] = psnr(render(gscene, gcam, cfg.replace(hit_multiplicity=ghm),
                                          method="gpu")["rgb"].cpu().numpy(), ref)
            base_db = psnr(render(gscene, gcam, base.replace(hit_multiplicity=ghm),
                                  method="gpu")["rgb"].cpu().numpy(), ref)
        if bar:  # key order reads ~30 dB on the golden without any option: its own bar
            need = min(PSNR_GOLDEN, base_db - 0.5)
            check(golden_db[name] >= need,
                  f"{name}: PSNR {golden_db[name]:.2f} vs the 720p golden < {need:.2f}")
        more = design("march", cfg, chunk, rays=cfg.rays_per_tile)
        log("options", f"{name} ({n_pairs} pairs, R = {cfg.rays_per_tile}): K1 vs plain max abs "
                       f"{err:.3g}, fired / repaired chunks {counts} (kernel = plain; default "
                       f"{base_counts}); {t['option'][0]:.3f} ms event, {fms(t['option'][1])} "
                       f"device (default {t['default'][0]:.3f} / {fms(t['default'][1])}), "
                       f"bound {b[0]:.4f} ({b[1]}), plain {plain_ms:.1f} ms; 720p golden "
                       f"{golden_db[name]:.2f} dB (default {base_db:.2f}) ({card})")
        rows.append({"name": f"march_{name}", "route": "cuda",
                     "source": f"{PKG}/csrc/march.cuh", "replaces": k1,
                     "launches": launches[name], "max_abs_err": err, "ms": t["option"][0],
                     "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                     "library_ms": None, "device_ms": t["option"][1],
                     "default_ms": t["default"][0], "default_device_ms": t["default"][1],
                     "fired_repaired": counts, "default_fired_repaired": base_counts,
                     "golden_psnr": golden_db[name], "default_golden_psnr": base_db, **more})

    # --- K1's saved carries and K3 under the peak key, beside the event key ---
    cam0 = views[0][0]
    win_event = win_peak.replace(window_key="event")
    with torch.no_grad():
        stream, trows, n_pairs_t = prepare_train_stream(trainer.model.activate(), cam0, win_peak)
    starts, trows = stream.starts, trows.detach().contiguous()
    dirs_t = tile_rays(cameras.generate_rays(cam0, win_peak)[1], 16, 16)
    kw = {"origins_t": cam0.eye.expand(dirs_t.shape).contiguous()}
    fwd = lambda f, cfg: f(starts, trows, dirs_t, cfg, 128, save_tin=True, **kw)
    got = fwd(kmarch.march, win_peak)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fwd(kmarch.march_plain, win_peak)
    k1t_plain = (time.perf_counter() - t0) * 1e3
    k1t_err = k1_train_check(f"peak window save_tin 512x512 c=128 ({n_pairs_t} pairs)", got,
                             want)
    k1t_bound = march_bound((starts, trows, dirs_t, win_peak, 128), kw, kmarch.march_plain,
                            tin=got[2])
    k1t_design = design("march", win_peak, 128, scalar=True, train=True)
    event = fwd(kmarch.march, win_event)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dev)
    d_t = torch.randn(dirs_t.shape[:2], generator=gen, device=dev)
    bargs = (starts, trows, dirs_t, cam0.eye, got[2], got[3], d_rgb, d_t, win_peak, 128)
    eargs = (starts, trows, dirs_t, cam0.eye, event[2], event[3], d_rgb, d_t, win_event, 128)
    k3_err = k3_check("peak window replay 512x512 c=128", bargs)
    t0 = time.perf_counter()
    kbwd.march_bwd_plain(*bargs)
    k3_plain = (time.perf_counter() - t0) * 1e3
    k3_bound = bwd_bound(bargs, kbwd.march_bwd_plain)
    k3_design = design("march_bwd", win_peak, 128)
    check(not torch.equal(got[2], event[2]), "the peak key changed no saved carry")
    t1 = turns({"event": lambda: fwd(kmarch.march, win_event),
                "peak": lambda: fwd(kmarch.march, win_peak)})
    t3 = turns({"event": lambda: kbwd.march_bwd(*eargs), "peak": lambda: kbwd.march_bwd(*bargs)})
    log("options", f"peak training 512x512 ({n_pairs_t} pairs): K1 save_tin {t1['peak'][0]:.3f} "
                   f"ms event, {fms(t1['peak'][1])} device (event key {t1['event'][0]:.3f} / "
                   f"{fms(t1['event'][1])}), bound {k1t_bound[0]:.4f} ({k1t_bound[1]}), plain "
                   f"{k1t_plain:.1f}; K3 {t3['peak'][0]:.3f} / {fms(t3['peak'][1])} (event key "
                   f"{t3['event'][0]:.3f} / {fms(t3['event'][1])}), bound {k3_bound[0]:.4f} "
                   f"({k3_bound[1]}), plain {k3_plain:.1f} ({card})")
    rows.append({"name": "march_peak_window_save_tin", "route": "cuda",
                 "source": f"{PKG}/csrc/march.cuh", "replaces": k1,
                 "launches": train_launches["march"], "max_abs_err": k1t_err,
                 "ms": t1["peak"][0], "plain_ms": k1t_plain, "bound_ms": k1t_bound[0],
                 "bound_by": k1t_bound[1], "library_ms": None, "device_ms": t1["peak"][1],
                 "default_ms": t1["event"][0], "default_device_ms": t1["event"][1],
                 **k1t_design})
    rows.append({"name": "march_bwd_peak_window", "route": "cuda",
                 "source": f"{PKG}/csrc/march_bwd.cuh",
                 "replaces": "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189",
                 "launches": train_launches["march_bwd"], "max_abs_err": k3_err,
                 "ms": t3["peak"][0], "plain_ms": k3_plain, "bound_ms": k3_bound[0],
                 "bound_by": k3_bound[1], "library_ms": None, "device_ms": t3["peak"][1],
                 "default_ms": t3["event"][0], "default_device_ms": t3["event"][1],
                 **k3_design})
    log("phase", f"window-order options and the peak key in "
                 f"{time.perf_counter() - t_phase:.1f} s")
    return rows


def pair_keys_phase(dev, card: str, scene, pose, golden, views, init) -> list:
    """The per-pair sort keys, order="oddeven" and compute_dtype="bfloat16"
    at full width. The main path, each count zeroed just before and read
    just after: the 1280x720 headline (`scene` = random_scene(100k, seed 0)
    at `pose`, bench config) through render(method="gpu") under pair_keys
    "tile", "tile_peak" and "affine", each in window, key and merge order
    (K1; the affine binning's head fills are one K2 launch a frame), and
    under order="oddeven" (K1's key kernel on the exact event gate); then
    Trainer(method="gpu").fit, 3 steps at 512x512 on `init` (random_scene
    (50k, seed 1)) under pair_keys="tile" in window and key order (K1 saved
    carries, K3); the tiled march at 256x256 under oddeven and bfloat16.
    Then each key's stream against the default's (the same n_pairs and
    starts, no drop, each tile's set of gaussian ids equal: the footprints
    are the same and nothing is culled, only the order differs), K1 against
    march_plain on each key's stream in each order and on the oddeven
    headline (the K1 bars; the rays where oddeven's frame differs from key
    order's counted), the affine fills' K2 launch bit for bit against the
    plain scan on its own input, K1 event and device ms and the binning's
    host ms in turns with the default's, the 720p golden under each key,
    and the tile-key training's K1 saved carries and K3 against their plain
    versions. Returns the kernel rows."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        prepare_pair_stream, prepare_train_stream, snug_pair_capacity,
    )
    from gaussian_ray_tracing_tpu_torch.models.renderer import render
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.ops.tiles import count_pairs
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    t_phase = time.perf_counter()
    bench = RenderConfig(**BENCH_KW)
    keys, orders = ("tile", "tile_peak", "affine"), ("window", "key", "merge")

    # --- the main path, each count zeroed just before ---
    launches, frames = {}, {}
    for key in keys:
        for order in orders:
            cfg = bench.replace(pair_keys=key, order=order)
            kmarch.march.launches = kscan.multi_cumsum_i32.launches = 0
            out = render(scene, pose, cfg, method="gpu", return_aux=True)
            torch.cuda.synchronize()
            launches[key, order] = (kmarch.march.launches, kscan.multi_cumsum_i32.launches)
            check(launches[key, order][0] == 1, f"pair keys {key} {order}: K1 launches "
                                                f"{launches[key, order][0]}")
            check(launches[key, order][1] == (key == "affine"),
                  f"pair keys {key} {order}: K2 launches {launches[key, order][1]}")
            rgb = out["rgb"]
            check(tuple(rgb.shape) == (720, 1280, 3) and bool(torch.isfinite(rgb).all())
                  and float(rgb.max()) > 0.1, f"pair keys {key} {order}: bad frame")
            check(out["aux"]["n_dropped"] == 0, f"pair keys {key} {order}: pairs dropped")
            frames[key, order] = rgb
    odd_cfg = bench.replace(order="oddeven")
    kmarch.march.oddeven_launches = 0
    odd_frame = render(scene, pose, odd_cfg, method="gpu")["rgb"]
    torch.cuda.synchronize()
    odd_launches = kmarch.march.oddeven_launches
    check(odd_launches == 1 and bool(torch.isfinite(odd_frame).all()),
          f"oddeven: K1 launches {odd_launches}")
    train_launches, train_losses, trainers = {}, {}, {}
    for order, attr in (("window", "window_save_tin_launches"), ("key", "save_tin_launches")):
        cfg = RenderConfig(hit_multiplicity=1, order=order, pair_keys="tile",
                           march_chunk=128 if order == "window" else 256)
        setattr(kmarch.march, attr, 0)
        kbwd.march_bwd.launches = 0
        trainers[order] = ktrain.Trainer(GaussianModel.from_scene(init), config=cfg, lr=2e-3,
                                         method="gpu")
        train_losses[order] = trainers[order].fit([views[0]], steps=3)
        torch.cuda.synchronize()
        train_launches[order] = (getattr(kmarch.march, attr), kbwd.march_bwd.launches)
        check(train_launches[order] == (3, 3),
              f"tile-key training {order}: K1 save_tin / K3 launches {train_launches[order]}")
        check(all(np.isfinite(train_losses[order])), f"tile-key training {order}: bad losses")
    cam256 = cameras.Camera.create(eye=GOLDEN_EYE, lookat=(0.0, 0.0, 0.0), width=256,
                                   height=256, device=dev)
    tiled = {name: render(scene, cam256, bench.replace(**kw), method="tiled")["rgb"]
             for name, kw in (("window", {}), ("oddeven", dict(order="oddeven")),
                              ("bfloat16", dict(compute_dtype="bfloat16")))}
    for name, rgb in tiled.items():
        check(tuple(rgb.shape) == (256, 256, 3) and bool(torch.isfinite(rgb).all()),
              f"tiled {name}: bad frame")
    tiled_db = {n: psnr(tiled[n].cpu().numpy(), tiled["window"].cpu().numpy())
                for n in ("oddeven", "bfloat16")}
    log("pairkeys", f"main path: 9 pair-key frames and an oddeven frame 1280x720 100k, "
                    f"launches (K1, K2) {json.dumps({f'{k} {o}': v for (k, o), v in launches.items()})}, "
                    f"oddeven K1 {odd_launches}; tile-key training 3 steps 512x512 50k "
                    f"{json.dumps({o: [l[0], l[-1]] for o, l in train_losses.items()})} launches "
                    f"{train_launches}; tiled 256x256 vs window: oddeven {tiled_db['oddeven']:.2f} "
                    f"dB, bfloat16 {tiled_db['bfloat16']:.2f} dB")

    # --- each key's stream against the default's; K1 against plain ---
    dirs_t = tile_rays(cameras.generate_rays(pose, bench)[1], 16, 16)
    N = scene.num_gaussians

    def pairs_of(stream, n_pairs):
        """Sorted (tile, gaussian id) codes of the stream's pairs."""
        slot = torch.arange(n_pairs, device=dev)
        tile = torch.searchsorted(stream.starts, slot.to(torch.int32), right=True) - 1
        gid = stream.gid[:n_pairs].long()
        ids = gid if stream.order is None else stream.order[gid].long()
        return torch.sort(tile.long() * N + ids).values

    cap = snug_pair_capacity(int(count_pairs(scene, pose, bench)))  # the main path's

    def binning(cfg):
        return prepare_pair_stream(scene, pose, cfg, cap)

    base_stream, base_feats, base_pairs = binning(bench)
    base_codes = pairs_of(base_stream, base_pairs)
    streams, k1_err, k1_args = {}, {}, {}
    for key in keys:
        stream, feats, n_pairs = binning(bench.replace(pair_keys=key))
        check(n_pairs == base_pairs and int(stream.n_dropped) == 0,
              f"{key}: {n_pairs} pairs ({int(stream.n_dropped)} dropped), the default "
              f"{base_pairs}")
        check(torch.equal(stream.starts, base_stream.starts), f"{key}: starts differ")
        check(torch.equal(pairs_of(stream, n_pairs), base_codes),
              f"{key}: a tile's set of gaussians differs from the default's")
        streams[key] = (stream, feats)
        for order in orders:
            cfg = bench.replace(pair_keys=key, order=order)
            k1_args[key, order] = (stream.starts, feats, dirs_t, cfg, chunk_for(cfg))
            k1_err[key, order] = k1_check("K1pairkeys", f"{key} {order} 720p", k1_args[key, order])
    odd_args = (base_stream.starts, base_feats, dirs_t, odd_cfg, 128)
    odd_err = k1_check("K1pairkeys", "oddeven 720p", odd_args)
    odd_out = kmarch.march(*odd_args)
    key_out = kmarch.march(base_stream.starts, base_feats, dirs_t, bench.replace(order="key"), 128)
    moved = ((odd_out[0] - key_out[0]).abs().amax(-1) > 0) | (odd_out[1] != key_out[1])
    odd_moved = int(moved.sum())
    log("pairkeys", f"streams: each key's {base_pairs} pairs, starts and per-tile gaussian "
                    f"sets equal the default's; oddeven differs from key order on {odd_moved} "
                    f"of {moved.numel()} rays (the exact event gate against the sqrt-free one)")

    # --- the affine fills' K2 launch on its own input ---
    recorded = []
    scan_cuda = kscan._scan_cuda  # the wrapper's launch, which it looks up at each call

    def recorder(x):
        recorded.append(x.clone())
        return scan_cuda(x)

    kscan._scan_cuda = recorder
    try:
        binning(bench.replace(pair_keys="affine"))
    finally:
        kscan._scan_cuda = scan_cuda
    check(len(recorded) == 1 and recorded[0].shape[0] == 4,
          f"affine binning: {len(recorded)} scans, expected one of 4 channels")
    x = recorded[0]
    k2_got = [kscan.multi_cumsum_i32(x) for _ in range(2)]
    check(all(torch.equal(g, kscan.multi_cumsum_i32_plain(x)) for g in k2_got),
          "K2 on the affine fills differs from the plain scan")
    k2 = {"shape": list(x.shape),
          "ms": statistics.median(cuda_ms(lambda: kscan.multi_cumsum_i32(x), 20)),
          "device_ms": profile_frames(lambda: kscan.multi_cumsum_i32(x), 20)["device_ms"],
          "plain_ms": statistics.median(cuda_ms(lambda: kscan.multi_cumsum_i32_plain(x), 20)),
          "library_ms": statistics.median(cuda_ms(lambda: torch.cumsum(x, dim=1), 20)),
          **dict(zip(("bound_ms", "bound_by"), bound(2 * x.numel() * 4, x.numel()))),
          **scan_design(x)}
    log("K2", f"affine fills {tuple(x.shape)}: bit for bit the plain scan, twice; "
              f"{json.dumps(k2)} ({card})")

    # --- timings in turns against the default, the golden under each key ---
    ref, gscene, gcam, ghm, _ = golden("pinhole_720p")
    with torch.no_grad():
        gold = lambda cfg: psnr(render(gscene, gcam, cfg.replace(hit_multiplicity=ghm),
                                       method="gpu")["rgb"].cpu().numpy(), ref)
        golden_db = {"gaussian": gold(bench), **{k: gold(bench.replace(pair_keys=k))
                                                 for k in keys}}
    base_args = (base_stream.starts, base_feats, dirs_t, bench, 128)
    subs = {}
    for key in keys:
        args = k1_args[key, "window"]
        t = turns({"default": lambda: kmarch.march(*base_args),
                   "key": lambda a=args: kmarch.march(*a)})
        tb = turns({"default": lambda: binning(bench),
                    "key": lambda k=key: binning(bench.replace(pair_keys=k))}, reps=3,
                   device=False)
        t0 = time.perf_counter()
        kmarch.march_plain(*args)
        plain_ms = (time.perf_counter() - t0) * 1e3
        b = march_bound(args, {}, kmarch.march_plain)
        subs[key] = {"ms": t["key"][0], "device_ms": t["key"][1], "default_ms": t["default"][0],
                     "default_device_ms": t["default"][1], "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1], "binning_ms": tb["key"][0],
                     "default_binning_ms": tb["default"][0],
                     "golden_psnr": golden_db[key], "default_golden_psnr": golden_db["gaussian"],
                     "max_abs_err": {o: k1_err[key, o] for o in orders},
                     **design("march", args[3], 128)}
        log("pairkeys", f"{key} window: K1 {t['key'][0]:.3f} ms event, {fms(t['key'][1])} device "
                        f"(default {t['default'][0]:.3f} / {fms(t['default'][1])}), bound "
                        f"{b[0]:.4f} ({b[1]}), plain {plain_ms:.1f}; binning {tb['key'][0]:.2f} "
                        f"ms (default {tb['default'][0]:.2f}); 720p golden {golden_db[key]:.2f} "
                        f"dB (default {golden_db['gaussian']:.2f}) ({card})")
    t_odd = turns({"key": lambda: kmarch.march(base_stream.starts, base_feats, dirs_t,
                                               bench.replace(order="key"), 128),
                   "oddeven": lambda: kmarch.march(*odd_args)})
    t0 = time.perf_counter()
    kmarch.march_plain(*odd_args)
    odd_plain = (time.perf_counter() - t0) * 1e3
    odd_bound = march_bound(odd_args, {}, kmarch.march_plain)
    odd_design = design("march", odd_cfg, 128)
    log("pairkeys", f"oddeven: K1 {t_odd['oddeven'][0]:.3f} ms event, {fms(t_odd['oddeven'][1])} "
                    f"device (key order {t_odd['key'][0]:.3f} / {fms(t_odd['key'][1])}), bound "
                    f"{odd_bound[0]:.4f} ({odd_bound[1]}), plain {odd_plain:.1f} ({card})")

    # --- the tile-key training's K1 saved carries and K3 ---
    cam0 = views[0][0]
    dirs0 = tile_rays(cameras.generate_rays(cam0, bench)[1], 16, 16)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_rgb = torch.randn(dirs0.shape, generator=gen, device=dev)
    d_t = torch.randn(dirs0.shape[:2], generator=gen, device=dev)
    train = {}
    for order in ("window", "key"):
        cfg = trainers[order].config
        with torch.no_grad():
            stream, trows, n_t = prepare_train_stream(trainers[order].model.activate(), cam0, cfg)
        starts, trows, c = stream.starts, trows.detach().contiguous(), chunk_for(cfg)
        kw = {"origins_t": cam0.eye.expand(dirs0.shape).contiguous()} if order == "window" \
            else {}
        fwd = lambda f: f(starts, trows, dirs0, cfg, c, save_tin=True, **kw)
        got = fwd(kmarch.march)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fwd(kmarch.march_plain)
        k1_plain = (time.perf_counter() - t0) * 1e3
        e1 = k1_train_check(f"tile key {order} save_tin 512x512 ({n_t} pairs)", got, want)
        b1 = march_bound((starts, trows, dirs0, cfg, c), kw, kmarch.march_plain, tin=got[2])
        d1 = design("march", cfg, c, scalar=order == "window", train=True)
        bargs = (starts, trows, dirs0, cam0.eye, got[2], got[3], d_rgb, d_t, cfg, c)
        e3 = k3_check(f"tile key {order} 512x512", bargs)
        t0 = time.perf_counter()
        kbwd.march_bwd_plain(*bargs)
        k3_plain = (time.perf_counter() - t0) * 1e3
        b3 = bwd_bound(bargs, kbwd.march_bwd_plain)
        d3 = design("march_bwd", cfg, c)
        t1 = turns({"k1": lambda: fwd(kmarch.march)})["k1"]
        t3 = turns({"k3": lambda: kbwd.march_bwd(*bargs)})["k3"]
        train[order] = (e1, t1, k1_plain, b1, d1, e3, t3, k3_plain, b3, d3)
        log("pairkeys", f"tile key {order} training 512x512 ({n_t} pairs): K1 save_tin "
                        f"{t1[0]:.3f} ms event, {fms(t1[1])} device, bound {b1[0]:.4f} ({b1[1]}), "
                        f"plain {k1_plain:.1f}; K3 {t3[0]:.3f} / {fms(t3[1])}, bound {b3[0]:.4f} "
                        f"({b3[1]}), plain {k3_plain:.1f} ({card})")
    log("phase", f"pair keys, oddeven and bfloat16 in {time.perf_counter() - t_phase:.1f} s")

    src = f"{PKG}/csrc"
    k1 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    k3 = "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189"
    tile = subs["tile"]
    row = lambda name, source, replaces, launches, err, ms, plain_ms, b, more: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b[0], "bound_by": b[1], "library_ms": None, **more}
    rows = [
        row("march_pair_keys", "march.cuh", k1, sum(v[0] for v in launches.values()),
            max(k1_err.values()), tile["ms"], tile["plain_ms"],
            (tile["bound_ms"], tile["bound_by"]),
            {"device_ms": tile["device_ms"], "default_ms": tile["default_ms"],
             "default_device_ms": tile["default_device_ms"], "keys": subs,
             "n_pairs": base_pairs}),
        row("march_oddeven", "march.cuh", k1, odd_launches, odd_err, t_odd["oddeven"][0],
            odd_plain, odd_bound,
            {"device_ms": t_odd["oddeven"][1], "key_ms": t_odd["key"][0],
             "key_device_ms": t_odd["key"][1], "rays_unlike_key_order": odd_moved,
             "tiled_256_psnr_vs_window": tiled_db, **odd_design}),
        {"name": "multi_cumsum_i32_affine", "route": "cuda", "source": f"{src}/scan.cu",
         "replaces": "gaussian_ray_tracing_tpu/ops/scan.py:81",
         "launches": sum(v[1] for v in launches.values()), "max_abs_err": 0,
         **{k: k2[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         **{k: v for k, v in k2.items() if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")}},
    ]
    for order in ("window", "key"):
        e1, t1, p1, b1, d1, e3, t3, p3, b3, d3 = train[order]
        rows.append(row(f"march_tile_key_{order}_save_tin", "march.cuh", k1,
                        train_launches[order][0], e1, t1[0], p1, b1,
                        {"device_ms": t1[1], **d1}))
        rows.append(row(f"march_bwd_tile_key_{order}", "march_bwd.cuh", k3,
                        train_launches[order][1], e3, t3[0], p3, b3, {"device_ms": t3[1], **d3}))
    return rows


def drop_free(render_fn, cfg):
    """render_fn(cfg) -> out with aux, max_per_tile doubled from 4096 until
    no pair drops. Returns (out, the config)."""
    cfg = cfg.replace(max_per_tile=4096)
    while True:
        out = render_fn(cfg)
        if out["aux"]["n_dropped"] == 0:
            return out, cfg
        check(cfg.max_per_tile < 65536, f"tiled: pairs still dropped at {cfg.max_per_tile}")
        cfg = cfg.replace(max_per_tile=2 * cfg.max_per_tile)


def witness_phase(dev, card: str, views, init) -> None:
    """ROADMAP Queue 3's two open items, each with a witness. (a) K1's quad
    response against the tiled march at 1280x720 / 100k (the 720p
    golden's camera, key order, chunk skip 1e-3): on the rays where K1 and
    the tiled march differ by more than 1e-2, the distance of K1's plain
    version (which the CPU tests hold to JAX's interpreted kernel) from the
    tiled march and from K1. (b) K3 at 512x512 / 50k (phase 6's first
    view, a model of `init`, key order, skip 1e-3) given the true upstream
    gradients of the L2 loss: per written column, K3 and its plain version
    against the plain version in float64 on the same float32 forward
    carries, which isolates the backward's sums from the forward's."""
    import numpy as np
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        frame_image, prepare_train_stream, render_gpu,
    )
    from gaussian_ray_tracing_tpu_torch.models.renderer import render
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    t_phase = time.perf_counter()
    scene = random_scene(100_000, seed=0, device=dev)
    cam = cameras.Camera.create(eye=GOLDEN_EYE, lookat=(0.0, 0.0, 0.0), width=1280,
                                height=720, device=dev)
    key = RenderConfig(hit_multiplicity=1, order="key", march_chunk=128,
                       chunk_skip_transmittance=1e-3)
    with torch.no_grad():
        tiled, key = drop_free(lambda c: render(scene, cam, c, method="tiled",
                                                return_aux=True), key)
        quad = render_gpu(scene, cam, key)["rgb"]
        plain = render_gpu(scene, cam, key, use_kernels=False)["rgb"]
    tiled = tiled["rgb"]
    d = lambda a, b: (a - b).abs().amax(-1)
    bad = d(quad, tiled) > MAXABS_KERNEL
    n_bad = int(bad.sum())
    on = lambda x: float(x[bad].max()) if n_bad else 0.0
    log("witness", f"K1 quad vs the tiled march, 1280x720 100k key: {n_bad} rays above "
                   f"{MAXABS_KERNEL} (max {float(d(quad, tiled).max()):.3g}); on them the plain "
                   f"quad version vs the tiled march max {on(d(plain, tiled)):.3g} "
                   f"({int((d(plain, tiled)[bad] > MAXABS_KERNEL).sum())} above "
                   f"{MAXABS_KERNEL}), K1 vs plain max {on(d(quad, plain)):.3g}; the whole "
                   f"frame: plain vs tiled max {float(d(plain, tiled).max()):.3g} "
                   f"({int((d(plain, tiled) > MAXABS_KERNEL).sum())} rays above), K1 vs plain "
                   f"max {float(d(quad, plain).max()):.3g}")
    check(float(d(quad, plain).max()) <= MAXABS_KERNEL, "K1 quad vs its plain version")

    cam0, target = views[0]
    tkey = RenderConfig(**{**TRAIN_KW, "chunk_skip_transmittance": 1e-3})
    with torch.no_grad():
        stream, rows, _ = prepare_train_stream(GaussianModel.from_scene(init).activate(), cam0,
                                               tkey)
    rows = rows.contiguous()
    _, dirs, valid = cameras.generate_rays(cam0, tkey)
    dirs_t = tile_rays(dirs, 16, 16)
    fwd = kmarch.march(stream.starts, rows, dirs_t, tkey, 256, save_tin=True)
    rgb_t, t_t = fwd[0].requires_grad_(True), fwd[1].requires_grad_(True)
    out = frame_image(rgb_t, 1.0 - t_t, valid, cam0, tkey)
    d_rgb, d_t = torch.autograd.grad(torch.mean((out["rgb"] - target) ** 2), [rgb_t, t_t],
                                     allow_unused=True, materialize_grads=True)
    args = (stream.starts, rows, dirs_t, cam0.eye, fwd[2], fwd[3], d_rgb, d_t, tkey, 256)
    g1 = kbwd.march_bwd(*args)
    torch.cuda.synchronize()
    gp = kbwd.march_bwd_plain(*args)
    g64 = kbwd.march_bwd_plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point()
                                 else a for a in args))
    diff = kmarch.diff_columns(0)
    cols = [i for i, c in enumerate(kmarch.train_columns(0)) if c in diff]
    per = {}
    for i in cols:
        w = float(g64[:, i].abs().max())
        per[i] = (float((g1[:, i] - g64[:, i]).abs().max()) / w,
                  float((gp[:, i] - g64[:, i]).abs().max()) / w)
    worst = max(cols, key=lambda i: per[i][0])
    log("witness", "K3 512x512 50k key, the loss's upstream gradients, per written column "
                   "(K3, plain) from the float64 plain backward on the same carries: "
                   + json.dumps({kmarch.train_columns(0)[i]: [float(f"{a:.3g}"), float(f"{b:.3g}")]
                                 for i, (a, b) in per.items()})
                   + f"; worst K3 {per[worst][0]:.3g} (column {kmarch.train_columns(0)[worst]})")
    for i in cols:
        check(per[i][0] <= WITNESS_RATIO * per[i][1] or per[i][0] <= 1e-5,
              f"K3 column {kmarch.train_columns(0)[i]}: {per[i][0]:.3g} from the float64 "
              f"backward, plain {per[i][1]:.3g}")
    log("phase", f"Queue 3 witnesses in {time.perf_counter() - t_phase:.1f} s")


def parallel_phase(dev, card: str, scene, cam, golden, views, init) -> list:
    """The multi-device layer (parallel/) on the card: a mesh of 4 shards on
    `dev` (and, where the machine has more GPUs, one shard per GPU), each
    sharded path against its single-device counterpart. The main paths,
    each with its kernels' counts zeroed just before and read just after:
    render_pallas_sharded at the headline (`scene`, random_scene(100k,
    seed 0), `cam`, 1280x720, bench config; 45 tile rows in 4 bands, the
    last one padded) in window and key order, bit-identical to render_gpu
    with n_dropped 0, and the 720p golden through it at >= 40 dB; the
    sharded Trainer (ZeRO-1 moments of N/4 rows on their shards) 5 steps
    at phase 6's 512x512 / 50k row from `init`, its loss within rtol 1e-4
    of the single-device Trainer at every step. Also: the sharded
    gradients (render_pallas_sharded_diff, key and window order) against
    render_gpu_diff per field within rtol 3e-5 plus 5e-5 of the field's
    largest entry; render_pallas_slabs at the headline, 4 slabs, gather
    and ring (ring vs gather 2e-5, n_dropped 0, the largest slab's pairs
    below half the frame's; PSNR against render_gpu and the 720p golden
    logged); the tiled, oracle and gaussian-sharded reference renderers on
    the small goldens' 5k scene at 256x256 at the CPU tests' bars; a world
    of one over NCCL (initialize_distributed) whose process-spanning mesh
    gives the headline bit for bit as the local mesh, and a train step at
    the sharded-step bars (loss rtol 1e-4, means atol 1e-4).
    Frames and steps are timed sharded and single in turns, and one of
    each profiled. Returns the kernel rows of the sharded paths, timed on
    the densest band or shard."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models import tiled as mtiled
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        bin_footprints, prepare_train_stream, render_gpu, render_gpu_diff, snug_pair_capacity,
    )
    from gaussian_ray_tracing_tpu_torch.models.oracle import render_oracle, render_rays_oracle
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.ops.tiles import (
        footprint_pair_count, num_tiles, project_footprints_conic,
    )
    from gaussian_ray_tracing_tpu_torch.parallel import mesh as pmesh
    from gaussian_ray_tracing_tpu_torch.parallel import sharded as S
    from gaussian_ray_tracing_tpu_torch.parallel.distributed import initialize_distributed
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
    from gaussian_ray_tracing_tpu_torch.train import trainer as ktrain
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    t_phase = time.perf_counter()
    n = 4
    mesh = pmesh.make_mesh(n, devices=[dev] * n)
    gmesh = pmesh.make_mesh(n, axis=pmesh.GAUSS_AXIS, devices=[dev] * n)
    meshes = [(f"{n} shards on {dev}", mesh)]
    if torch.cuda.device_count() > 1:
        meshes.append((f"one shard per GPU ({torch.cuda.device_count()})", pmesh.make_mesh()))
    counts = lambda: {"march": kmarch.march.launches, "scan": kscan.multi_cumsum_i32.launches,
                      "march_save_tin": kmarch.march.save_tin_launches
                      + kmarch.march.window_save_tin_launches,
                      "march_bwd": kbwd.march_bwd.launches}

    def zero():
        kmarch.march.launches = kscan.multi_cumsum_i32.launches = 0
        kmarch.march.save_tin_launches = kmarch.march.window_save_tin_launches = 0
        kbwd.march_bwd.launches = 0

    # 1. the forward at the headline, bit for bit as render_gpu
    bench = RenderConfig(**BENCH_KW)
    fwd_launches = None
    for order in ("window", "key"):
        cfg = bench.replace(order=order)
        single = render_gpu(scene, cam, cfg, return_aux=True)
        check(single["aux"]["n_dropped"] == 0, "render_gpu dropped pairs")
        for label, m in meshes:
            zero()
            out = S.render_pallas_sharded(scene, cam, cfg, m)
            torch.cuda.synchronize()
            c = counts()
            check(c["march"] == m.size and c["scan"] >= m.size,
                  f"sharded forward on {label}: launches {c}")
            check(out["n_dropped"] == 0, f"sharded forward {order} on {label}: pairs dropped")
            same = torch.equal(out["rgb"], single["rgb"]) and torch.equal(out["alpha"],
                                                                          single["alpha"])
            log("parallel", f"render_pallas_sharded 1280x720 100k {order} on {label}: "
                            f"n_dropped 0, bit-identical to render_gpu: {same}, launches {c}")
            check(same, f"render_pallas_sharded {order} on {label} differs from render_gpu")
            if order == "window" and m is mesh:
                fwd_launches = c
    ref, gscene, gcam, hm, _ = golden("pinhole_720p")
    gcfg = RenderConfig(hit_multiplicity=hm, order="window", march_chunk=128)
    p = psnr(S.render_pallas_sharded(gscene, gcam, gcfg, mesh)["rgb"].cpu().numpy(), ref)
    log("parallel", f"golden pinhole_720p through render_pallas_sharded: PSNR {p:.2f} dB")
    check(p >= PSNR_GOLDEN, f"sharded golden PSNR {p:.2f} < {PSNR_GOLDEN}")
    frame = {"single": lambda: render_gpu(scene, cam, bench),
             "sharded": lambda: S.render_pallas_sharded(scene, cam, bench, mesh)}
    ms = {k: [] for k in frame}
    for _ in range(2):  # single, sharded, single, sharded
        for k, fn in frame.items():
            fn()
            ms[k] += cuda_ms(fn, 6)
    fmed = {k: statistics.median(v) for k, v in ms.items()}
    prof = profile_frames(frame["sharded"], frames=3)
    log("parallel", f"frame 1280x720 100k window, median of 12 in turns: single "
                    f"{fmed['single']:.3f} ms, {n} shards {fmed['sharded']:.3f} ms (ratio "
                    f"{fmed['sharded'] / fmed['single']:.2f}); sharded device busy "
                    f"{prof['device_ms']:.3f} ms (idle share "
                    f"{1.0 - prof['device_ms'] / fmed['sharded']:.3f}), "
                    f"{prof['device_ops']:.0f} device ops, top {prof['top']} ({card})")

    # 2. the sharded training gradients at 512x512 / 50k
    cam0, target = views[0]
    for order in ("key", "window"):
        tcfg = RenderConfig(**{**TRAIN_KW, "order": order})
        grads = {}
        for label, fn in (("sharded", lambda s: S.render_pallas_sharded_diff(s, cam0, tcfg,
                                                                             mesh)),
                          ("single", lambda s: render_gpu_diff(s, cam0, tcfg))):
            model = GaussianModel.from_scene(init).requires_grad_(True)
            zero()
            torch.mean((fn(model.activate())["rgb"] - target) ** 2).backward()
            torch.cuda.synchronize()
            if label == "sharded":
                c = counts()
                check(c["march_save_tin"] == n and c["march_bwd"] == n,
                      f"sharded diff {order}: launches {c}")
            grads[label] = {f: getattr(model, f).grad for f in FIELDS}
        dist_ = {}
        for f in FIELDS:
            a, b = grads["sharded"][f], grads["single"][f]
            top = float(b.abs().max())
            dist_[f] = float((a - b).abs().max()) / max(top, 1e-30)
            excess = float(((a - b).abs() - 3e-5 * b.abs()).max())
            check(excess <= 5e-5 * top, f"sharded gradient {order} {f}: {dist_[f]:.3g} of the "
                                        f"largest entry")
        log("parallel", f"render_pallas_sharded_diff vs render_gpu_diff 512x512 50k {order}, "
                        f"max|a-b| / max|b| per field: "
                        + json.dumps({f: float(f"{v:.3g}") for f, v in dist_.items()}))

    # 3. the sharded Trainer: 5 steps against the single-device Trainer
    tcfg = RenderConfig(**TRAIN_KW)
    single = ktrain.Trainer(GaussianModel.from_scene(init), config=tcfg, lr=2e-3)
    sharded = ktrain.Trainer(GaussianModel.from_scene(init), config=tcfg, lr=2e-3, mesh=mesh)
    l_single = single.fit(views, steps=5)
    zero()
    l_sharded = sharded.fit(views, steps=5)
    torch.cuda.synchronize()
    train_launches = counts()
    check(train_launches["march_save_tin"] == 5 * n and train_launches["march_bwd"] == 5 * n
          and train_launches["scan"] >= 5, f"sharded trainer launches {train_launches}")
    log("parallel", f"Trainer 5 steps 512x512 50k key: single {l_single}, {n} shards "
                    f"{l_sharded}, launches {train_launches}")
    for i, (a, b) in enumerate(zip(l_sharded, l_single)):
        check(abs(a - b) <= 1e-4 * abs(b), f"sharded step {i + 1}: loss {a} vs {b}")
    opt = sharded.optimizer
    N = init.num_gaussians
    check(isinstance(opt, ktrain.ZeroOptimizer) and len(opt.shards) == n, "not ZeRO-1")
    for s, shard_opt, _ in opt.shards:
        moments = [v for st in shard_opt.state.values() for v in st.values() if v.dim() >= 1]
        check(len(moments) == 2 * len(FIELDS) and all(
            v.shape[0] == N // n and v.device == mesh.device(s) for v in moments),
            f"shard {s}: moments {[tuple(v.shape) for v in moments]}")
    steps = {"single": ktrain.make_train_step(tcfg, single.optimizer,
                                              pair_capacity=single._pair_capacity),
             "sharded": ktrain.make_train_step(tcfg, sharded.optimizer, mesh=mesh,
                                               pair_capacity=sharded._pair_capacity)}
    models = {"single": single.model, "sharded": sharded.model}
    step_ms = {k: [] for k in steps}
    for _ in range(2):
        for k in steps:
            for i in range(5):
                step_ms[k] += cuda_ms(lambda: steps[k](models[k], *views[i % 8]), 1)
    smed = {k: statistics.median(v) for k, v in step_ms.items()}
    prof = profile_frames(lambda: steps["sharded"](models["sharded"], *views[0]), frames=3)
    log("parallel", f"train step 512x512 50k key, median of 10 in turns: single "
                    f"{smed['single']:.3f} ms, {n} shards {smed['sharded']:.3f} ms (ratio "
                    f"{smed['sharded'] / smed['single']:.2f}); sharded device busy "
                    f"{prof['device_ms']:.3f} ms (idle share "
                    f"{1.0 - prof['device_ms'] / smed['sharded']:.3f}), "
                    f"{prof['device_ops']:.0f} device ops, top {prof['top']} ({card})")

    # 4. depth slabs on K1 at the headline, gather and ring
    slabs = {}
    for comm in ("gather", "ring"):
        zero()
        slabs[comm] = S.render_pallas_slabs(scene, cam, bench, gmesh, comm=comm)
        torch.cuda.synchronize()
        log("parallel", f"render_pallas_slabs {comm}: n_dropped {slabs[comm]['n_dropped']}, "
                        f"pairs_max_shard {slabs[comm]['pairs_max_shard']}, n_pairs "
                        f"{slabs[comm]['n_pairs']}, launches {counts()}")
    g, r = slabs["gather"], slabs["ring"]
    err = max(float((r[k] - g[k]).abs().max()) for k in ("rgb", "alpha"))
    p_single = psnr(r["rgb"].cpu().numpy(), render_gpu(scene, cam, bench)["rgb"].cpu().numpy())
    p_golden = psnr(S.render_pallas_slabs(gscene, gcam, gcfg, gmesh)["rgb"].cpu().numpy(), ref)
    log("parallel", f"slabs ring vs gather max abs {err:.3g} (bar 2e-5); ring vs render_gpu "
                    f"PSNR {p_single:.2f} dB; the 720p golden's scene through the ring "
                    f"{p_golden:.2f} dB against the golden")
    check(err <= 2e-5, f"slabs ring vs gather: {err:.3g}")
    check(g["n_dropped"] == 0 and r["n_dropped"] == 0, "slabs dropped pairs")
    check(r["pairs_max_shard"] * 2 < r["n_pairs"], f"slab binning does not scale: {r}")

    # 5. the reference renderers at 256x256: on the small goldens' scene,
    # and the gaussian-sharded ones also on the CPU tests' scenes (the slab
    # decomposition composites straddlers in slab order, which a dense
    # scene pays for: tests/test_parallel.py picks a sparse scene for the
    # 40 dB bar and a dense one for the exact straddlers)
    ref_s, sscene, scam, hm, _ = golden("small_pinhole_256")
    scfg = RenderConfig(hit_multiplicity=hm, max_per_tile=4096)
    with torch.no_grad():
        a = mtiled.render_tiled(sscene, scam, scfg)
        b = S.render_tiled_sharded(sscene, scam, scfg, mesh)
        p = psnr(a["rgb"].cpu().numpy(), b["rgb"].cpu().numpy())
        m = float((a["rgb"] - b["rgb"]).abs().max())
        log("parallel", f"render_tiled_sharded vs render_tiled 256x256 5k: {p:.2f} dB, max abs "
                        f"{m:.3g}")
        check(p > 55.0 and m <= 2e-2, "render_tiled_sharded vs render_tiled")
        o, dd, _ = cameras.generate_rays(scam, scfg)
        o, dd = o.reshape(-1, 3), dd.reshape(-1, 3)
        a = render_rays_oracle(sscene, o, dd, scfg)
        b = S.render_rays_sharded_oracle(sscene, o, dd, scfg, mesh)
        p = psnr(a[0].cpu().numpy(), b[0].cpu().numpy())
        m = max(float((x - y).abs().max()) for x, y in zip(a[:2], b[:2]))
        log("parallel", f"render_rays_sharded_oracle vs render_rays_oracle: {p:.2f} dB, max "
                        f"abs {m:.3g}")
        check(p > 55.0 and m <= 2e-2, "render_rays_sharded_oracle")
        sparse = random_scene(600, seed=21, mean_scale=0.03, density_scaling=False, device=dev)
        for name, sc in (("golden 5k", sscene), ("sparse 600", sparse)):
            oracle = render_oracle(sc, scam, scfg)["rgb"].cpu().numpy()
            for label, m2 in (("1-D", gmesh), ("2x2", pmesh.make_mesh_2d(2, 2, devices=[dev] * 4))):
                p = psnr(oracle, S.render_gaussian_sharded(sc, scam, scfg, m2)["rgb"].cpu().numpy())
                log("parallel", f"render_gaussian_sharded {label}, {name} vs the oracle: {p:.2f} dB")
                check(p >= 40.0 or sc is sscene, f"render_gaussian_sharded {label}: {p:.2f} dB")
        wcfg = scfg.replace(order="window")
        fast = S.render_gaussian_sharded_fast(sscene, scam, wcfg, gmesh)
        ring = S.render_gaussian_ring(sscene, scam, wcfg, gmesh)
        p_fast = psnr(S.render_gaussian_sharded(sscene, scam, wcfg, gmesh)["rgb"].cpu().numpy(),
                      fast["rgb"].cpu().numpy())
        e_ring = max(float((ring[k] - fast[k]).abs().max()) for k in ("rgb", "alpha"))
        log("parallel", f"golden 5k: render_gaussian_sharded_fast vs the slab oracle "
                        f"{p_fast:.2f} dB; ring vs fold max abs {e_ring:.3g}")
        check(p_fast > 45.0 and e_ring <= 2e-5, "gaussian-sharded fast or ring")
        dense = random_scene(800, seed=7, mean_scale=0.12, density_scaling=False, device=dev)
        dcfg = RenderConfig(hit_multiplicity=1, order="window", max_per_tile=2048,
                            march_chunk=2048)
        oracle = render_oracle(dense, scam, dcfg)["rgb"].cpu().numpy()
        ex = S.render_gaussian_sharded_fast(dense, scam, dcfg, gmesh, straddle="exact",
                                            overlap_capacity=448)
        p_ex = psnr(oracle, ex["rgb"].cpu().numpy())
        p_sl = psnr(oracle, S.render_gaussian_sharded_fast(dense, scam, dcfg,
                                                           gmesh)["rgb"].cpu().numpy())
        log("parallel", f"dense 800: straddle exact vs the oracle {p_ex:.2f} dB "
                        f"(n_straddle_dropped {ex['n_straddle_dropped']}), slab order {p_sl:.2f} dB")
        check(ex["n_straddle_dropped"] == 0 and p_ex >= 40.0 and p_ex > p_sl, "straddle exact")

    # 6. a world of one over NCCL: the process-spanning mesh equals the local one
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        dmesh = pmesh.make_mesh(n, devices=[dev] * n)
        check(dmesh.distributed and dist.get_backend() == "nccl", "no NCCL process group")
        a = S.render_pallas_sharded(scene, cam, bench, mesh)
        b = S.render_pallas_sharded(scene, cam, bench, dmesh)
        same = torch.equal(a["rgb"], b["rgb"]) and torch.equal(a["alpha"], b["alpha"])
        losses = []
        for m in (mesh, dmesh):
            tr = ktrain.Trainer(GaussianModel.from_scene(init), config=tcfg, lr=2e-3, mesh=m)
            losses.append(tr.fit(views[:1], steps=1) + [tr.model.means.detach()])
        means_err = float((losses[0][1] - losses[1][1]).abs().max())
        log("parallel", f"NCCL world of one: headline bit-identical to the local mesh: {same}; "
                        f"a train step (all_reduce of the gradients, ZeRO-1 gather): losses "
                        f"{losses[0][0]}, {losses[1][0]}, means max abs {means_err:.3g}")
        check(same, "the NCCL mesh's headline differs from the local mesh's")
        check(abs(losses[1][0] - losses[0][0]) <= 1e-4 * abs(losses[0][0]) and means_err <= 1e-4,
              "the NCCL mesh's train step is off the sharded-step bars")
    finally:
        dist.destroy_process_group()

    # the kernels alone at the sharded paths' shapes: the densest band, shard
    table, M, radius = mtiled.feature_table(scene, bench, eye=cam.eye)
    fp = project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                  radius * torch.amax(scene.scales, dim=-1), cam, bench)
    fp = fp._replace(depth=mtiled.depth_key(scene, M, radius, cam.eye, bench))
    tx_n, ty_n = num_tiles(cam, bench)
    rows_l = -(-ty_n // n)
    bands = [(i * rows_l, rows_l) for i in range(n)]
    band_pairs = [int(footprint_pair_count(fp, cam, bench, b)) for b in bands]
    i = int(np.argmax(band_pairs))
    stream, ids, _ = bin_footprints(fp, cam, bench, snug_pair_capacity(band_pairs[i]),
                                    tile_rows=bands[i])
    dirs_t = S._pad_leading(mtiled.tile_rays(cameras.generate_rays(cam, bench)[1], 16, 16),
                            n * rows_l * tx_n)
    chunk = chunk_for(bench)
    args = (stream.starts, kmarch.compact_features(table, 0)[ids],
            dirs_t[i * rows_l * tx_n:(i + 1) * rows_l * tx_n], bench, chunk)
    k1_err = k1_check("parallel", f"K1 window band {i} ({band_pairs[i]} of {sum(band_pairs)} "
                                  "pairs)", args)
    k1_ms = statistics.median(cuda_ms(lambda: kmarch.march(*args), 20))
    k1_plain = statistics.median(cuda_ms(lambda: kmarch.march_plain(*args), 3))
    k1_bound = march_bound(args, {}, kmarch.march_plain)
    x = torch.randint(-1000, 1000, (2, snug_pair_capacity(band_pairs[i])), dtype=torch.int32,
                      device=dev)
    check(torch.equal(kscan.multi_cumsum_i32(x), kscan.multi_cumsum_i32_plain(x)),
          "K2 at the band's shape differs from plain")
    k2_ms = statistics.median(cuda_ms(lambda: kscan.multi_cumsum_i32(x), 50))
    k2_plain = statistics.median(cuda_ms(lambda: kscan.multi_cumsum_i32_plain(x), 50))
    k2_lib = statistics.median(cuda_ms(lambda: torch.cumsum(x, dim=1), 50))
    k2_bound = bound(2 * x.numel() * 4, x.numel())

    with torch.no_grad():
        tstream, trows, _ = prepare_train_stream(sharded.model.activate(), cam0, tcfg)
    trows = trows.contiguous()
    tdirs = mtiled.tile_rays(cameras.generate_rays(cam0, tcfg)[1], 16, 16)
    T, T_l = tdirs.shape[0], -(-tdirs.shape[0] // n)
    starts = S._pad_leading(tstream.starts, n * T_l + 1, tstream.starts[T])
    tdirs = S._pad_leading(tdirs, n * T_l)
    per = [int(starts[(j + 1) * T_l] - starts[j * T_l]) for j in range(n)]
    j = int(np.argmax(per))
    targs = (starts[j * T_l:(j + 1) * T_l + 1].contiguous(), trows,
             tdirs[j * T_l:(j + 1) * T_l].contiguous(), tcfg, 256)
    fwd = lambda f: f(*targs, save_tin=True)
    got = fwd(kmarch.march)
    torch.cuda.synchronize()
    key_err = k1_train_check(f"key shard {j} of 512x512 50k ({per[j]} of {sum(per)} rows)",
                             got, fwd(kmarch.march_plain))
    gen = torch.Generator(device=dev).manual_seed(0)
    d_rgb = torch.randn(targs[2].shape, generator=gen, device=dev)
    d_t = torch.randn(targs[2].shape[:2], generator=gen, device=dev)
    bargs = (targs[0], trows, targs[2], cam0.eye, got[2], got[3], d_rgb, d_t, tcfg, 256)
    bwd_err = k3_check(f"shard {j} of 512x512 50k", bargs)
    k1k_ms = statistics.median(cuda_ms(lambda: fwd(kmarch.march), 20))
    k1k_plain = statistics.median(cuda_ms(lambda: fwd(kmarch.march_plain), 3))
    k1k_bound = march_bound(targs, {}, kmarch.march_plain, tin=got[2])
    k3_ms = statistics.median(cuda_ms(lambda: kbwd.march_bwd(*bargs), 20))
    k3_plain = statistics.median(cuda_ms(lambda: kbwd.march_bwd_plain(*bargs), 3))
    k3_bound = bwd_bound(bargs, kbwd.march_bwd_plain)
    log("kernel", f"sharded paths: K1 window band {k1_ms:.3f} ms (plain {k1_plain:.3f}, bound "
                  f"{k1_bound[0]:.4f}); K2 (2, {x.shape[1]}) {k2_ms:.4f} ms (plain "
                  f"{k2_plain:.4f}, torch.cumsum {k2_lib:.4f}, bound {k2_bound[0]:.4f}); K1 key "
                  f"save_tin shard {k1k_ms:.3f} ms (plain {k1k_plain:.3f}, bound "
                  f"{k1k_bound[0]:.4f}); K3 shard {k3_ms:.3f} ms (plain {k3_plain:.3f}, bound "
                  f"{k3_bound[0]:.4f}) ({card})")
    log("phase", f"parallel in {time.perf_counter() - t_phase:.1f} s")

    src, k1 = f"{PKG}/csrc", "gaussian_ray_tracing_tpu/ops/pallas_march.py:195"
    row = lambda name, source, replaces, launches, err, ms, plain_ms, b, lib=None: {
        "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b[0], "bound_by": b[1], "library_ms": lib}
    return [
        row("march_sharded_band", "march.cuh", k1, fwd_launches["march"], k1_err, k1_ms,
            k1_plain, k1_bound),
        row("multi_cumsum_i32_sharded_band", "scan.cu", "gaussian_ray_tracing_tpu/ops/scan.py:81",
            fwd_launches["scan"], 0, k2_ms, k2_plain, k2_bound, k2_lib),
        row("march_key_save_tin_sharded", "march.cuh", k1, train_launches["march_save_tin"],
            key_err, k1k_ms, k1k_plain, k1k_bound),
        row("march_bwd_sharded", "march_bwd.cuh",
            "gaussian_ray_tracing_tpu/ops/pallas_march.py:1189", train_launches["march_bwd"],
            bwd_err, k3_ms, k3_plain, k3_bound),
    ]


def _png_pixels(png):
    """Decode an 8-bit RGB PNG written by utils/image.encode_png (a path or
    the bytes) into (H, 3 W) uint8 rows."""
    import struct
    import zlib

    import numpy as np

    data = png.read_bytes() if isinstance(png, Path) else png
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:]  # filter type 0 (none) on every row


if __name__ == "__main__":
    main()
