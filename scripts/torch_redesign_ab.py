#!/usr/bin/env python3
"""The port's K1 (window, key and merge order), K2, K3 and K4 against the
kernels of another copy of gaussian_ray_tracing_tpu_torch/csrc/ (an earlier
commit's), on one NVIDIA GPU, timed in turns: other, this, this, other.
K1's outputs (rgb, final transmittance, saved carries) and K2's must be
bit-identical between the two builds and within chip_smoke.py's bars of
the plain version; K3 is held against its plain version at chip_smoke.py's
bars (per written column, the float64 witness, two launches bit-identical)
and its difference from the other build is reported. Each build's time
is the median of CUDA events around each call (the wrapper's host work
included: the ms columns) and, beside it, the device time of each call's
device operations from torch.profiler (dev_ms). Beside each row: the
bound (chip_smoke.py's march_bound / bwd_bound), the plain version's time,
this build's resident blocks per SM, registers, stack and spills, the
marched slots and the significant, fire (window order) and slow (merge
order) shares of the stream, and, on every K1 row, where pass 1 stops and
what window order's pass 2 sorts (chip_smoke.k1_stops: the shares of
(ray, slot) pairs of dead rays, sure misses, alpha <= alpha_min, past
t_hi, other gate misses and significant ones, per-warp shares, the
live-ray share, the tiles marched and the most chunks one marched, and
ns and the insertion sort's inversions per ray of a fired chunk; on merge
rows merge_counts, the work of the merge design of commit 309918a: the
slow and fresh-slow chunks, evaluations, the insertion's shifts, the
walk's steps and significant moves, the carried state's bytes and the
cluster barriers).

    git archive <commit> gaussian_ray_tracing_tpu_torch/csrc | tar -x -C build/parent
    python3 scripts/torch_redesign_ab.py build/parent/gaussian_ray_tracing_tpu_torch/csrc \
        [out.json] [--only render|modes|merge|train|mesh|key|scan|cluster|bwd] \
        [--this <csrc dir>] \
        [--pairs N]

The groups: render (window order on the 720p/100k headline and on
fitted_20k.ply at SH 3), modes (window order on the glass
frame's bounce 0, every bounce of the glass_front and glass_cli frames
(segments, then block mode), bounces 0 and 1 of glass_front under a
fisheye camera and at SH 3 on fitted_20k.ply, and a rolling shutter), merge (merge order on the
headline, fitted_20k.ply at SH 3, the 256x256 golden stream at c=64 and
128, a mesh segment, a rolling shutter and block mode), train (the
training forwards and K3) and mesh (K4 on the glass and glass_front
frames' bounce 0, shared origin, and glass_front's bounce 1 and glass_cli's
bounces 1-3, per-ray origins; K1's block mode on glass_front's bounce 1 in
window, key and merge order at block_sub 1 and 2; the whole glass_front
and glass_cli frames), key (every mode of the key-order kernel: the
headline at c=256, fitted_20k.ply at SH 3, a rolling shutter, a mesh
segment, glass_front's block mode at block_sub 1 and 2, the headline on
32x32 and 64x32 tiles (the 1024-ray and cluster builds) at c=128, and the
two training forwards with saved carries), cluster (the cluster builds at one
ray a thread: the headline on 64x32, 64x64 and 128x64 tiles, R = 2048, 4096
and 8192, at c=128, and on 64x64 at c=64 and 32, in window, key and merge
order; at two rays a thread, merge order on 130x64 and 128x128 tiles, R =
8320 (the second slot 128 rays) and 16,384; and the key and window
training forwards and K3 on 64x64 tiles), bwd (K3 alone, bit for bit
against the other build: first the crafted calls of
tests/test_torch_gpu.py's K3_WIDE_CASES, each build's SHA-256 digest and
whether it holds chip_smoke's K3 bars, taken apart, so that no failure
hides the rest; then the 512x512 training views: 50k gaussians at
SH 0 and fitted_20k.ply at SH 3 in key and window order on tiles of 256,
512, 1024, 2048, 4096, 8192, 8320 and 16,384 rays, and from per-ray
origins with windows, a rolling shutter, at 1024 and 2048 rays; each row
with k3_shares, modelled in torch on the same rows: idle, dead,
sure-miss and gated shares of the (lane, candidate) pairs, the empty warp
slots and block and tile groups; a failed check is reported after the
group) and
scan (K2 at (2, 2,097,152), the
headline's pair capacity, and (16, 1,000,003), exact, with its bound, the
plain version's and torch.cumsum's times, tiles, blocks per SM,
registers and stack); all of them without --only. K4's outputs must be
bit-identical between the builds and to its plain version; K4 rows also
carry the share of (ray, block) pairs and of (ray, face) tests that its
pretests skip (the kernel's own counts) and a modelled load balance. A
build without K4's pretests (no grt_closest_hit_info) is called without
the bounds and stats, which it does not take; a build from before the
single-pass K2 with its own scratch size. K3 rows check torch.equal
against the other build (bwd) or report it (bit_identical) with their
difference from it (max_rel_vs_other: train, key, cluster). --this takes another
copy of csrc/ in place of the package's own. --pairs N times each case in
N rounds of those turns (default 1) and adds, per case, each round's
device time of this build over the other's (dev_ratios), their median and
the rounds this build was the faster in (this_faster_rounds). Run from the repository root.
Writes the rows and the ptxas table to out.json (build/redesign_ab.json by
default; the rows so far where a check fails) and prints one line per case;
exits non-zero if a check fails or there is no GPU.
"""

from __future__ import annotations

import argparse
import atexit
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (its helpers; it imports torch lazily)

REPS = 10  # launches per timed turn
GROUPS = ("render", "modes", "merge", "train", "mesh", "key", "scan", "cluster", "bwd")


class _WithoutPretests:
    """A build from before K4's pretests, called with this tree's argument
    list: grt_closest_hit without `bounds` and `stats` (arguments 3 and
    11)."""

    def __init__(self, lib):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.grt_closest_hit.argtypes = [vp] * 10 + [ci, ci, cf, cf, vp]
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def grt_closest_hit(self, *a):
        return self._lib.grt_closest_hit(*a[:3], *a[4:11], *a[12:])


class _ThreePassScan:
    """A build from before the single-pass scan (no grt_scan_scratch_bytes):
    its scratch is one int32 per 1,024-element block (grt_scan_block) and
    channel, and it has no launch query grt_scan_info (here one that
    returns cudaErrorInvalidValue)."""

    def __init__(self, lib):
        self._lib = lib
        block = lib.grt_scan_block()
        self.grt_scan_scratch_bytes = lambda C, P: 4 * C * max(1, -(-P // block))
        self.grt_scan_info = lambda out: 1

    def __getattr__(self, name):
        return getattr(self._lib, name)


def k3_shares(args, kw=None) -> dict:
    """Modelled in torch (float32, K3's `evaluate` in its operations' order)
    over the chunks K3 replays (those its skip replay keeps): what the
    replay's lanes evaluate and what its group sums add. Per (lane,
    candidate) pair, a lane of each slot of each block of the tile's launch
    (idle lanes past R included): the shares of idle lanes, dead rays,
    pairs K1's sure-miss test stops (sure_miss and miss_threshold, where dd
    >= 1e-6), pairs with dd below 1e-6 and pairs through the gate; per
    (slot, warp, candidate) slot the share with no lane through the gate
    (empty_warp_slot_share); per (slot, block, group of 16 candidates) the
    share no warp of the block gated (empty_block_group_share); per (tile,
    chunk, group) the share no lane of any slot or block gated
    (empty_tile_group_share); and the replayed (tile, chunk) pairs."""
    import torch

    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch

    kw = kw or {}
    starts, rows, dirs_t, eye, tin, chunk_base, _, _, cfg, c = args
    T, R = dirs_t.shape[:2]
    dev = dirs_t.device
    blocks = 1 if R <= 1024 else -(-R // 1024) if R <= 8192 else 8
    width = R if R <= 1024 else 1024 if R > 8192 else -(-R // (128 * blocks)) * 128
    span = blocks * width
    slots = -(-R // span)
    lanes = slots * span
    origins, t_lo_a, t_hi_a = kw.get("origins_t"), kw.get("t_lo"), kw.get("t_hi")
    dx, dy, dz = dirs_t[..., 0], dirs_t[..., 1], dirs_t[..., 2]
    live = dx * dx + dy * dy + dz * dz > 0.01
    counts = (starts[1:] - starts[:-1]).long()
    n_chunks = -(-counts // c)
    acc = {k: 0 for k in ("pairs", "idle", "dead", "sure_miss", "small_dd", "gated", "wslots",
                          "wslots_empty", "bgroups", "bgroups_empty", "tgroups",
                          "tgroups_empty", "chunks")}
    batch = max(1, (1 << 23) // (c * R))
    for j in range(int(n_chunks.max()) if T else 0):
        has = (n_chunks > j).nonzero().squeeze(1)
        t_max = tin[chunk_base[has].long() + j].amax(dim=1)
        for tb in has[t_max > cfg.min_transmittance].split(batch):
            B = tb.numel()
            acc["chunks"] += B
            idx = starts[tb].long()[:, None] + j * c + torch.arange(c, device=dev)[None, :]
            present = idx < starts[tb + 1].long()[:, None]  # (B, c)
            f = rows[torch.clamp(idx, max=rows.shape[0] - 1)]
            col = lambda k: f[:, :, k:k + 1]
            m = [col(kmarch.T_M0 + k) for k in range(9)]
            if origins is None:
                ox, oy, oz = (eye[k] - col(kmarch.T_MX + k) for k in range(3))
            else:
                o = origins[tb][:, None]
                ox, oy, oz = (o[..., k] - col(kmarch.T_MX + k) for k in range(3))
            d = [x[tb][:, None] for x in (dx, dy, dz)]
            ogx, ogy, ogz = (m[3 * i] * ox + m[3 * i + 1] * oy + m[3 * i + 2] * oz
                             for i in range(3))
            dgx, dgy, dgz = (m[3 * i] * d[0] + m[3 * i + 1] * d[1] + m[3 * i + 2] * d[2]
                             for i in range(3))
            dd = dgx * dgx + dgy * dgy + dgz * dgz
            od = ogx * dgx + ogy * dgy + ogz * dgz
            oo = ogx * ogx + ogy * ogy + ogz * ogz
            dd_s = torch.clamp(dd, min=1e-6)
            t_star = -od / dd_s
            pp = oo + t_star * (2.0 * od + t_star * dd)
            op = col(0)
            alpha = torch.clamp(torch.exp(-0.5 * torch.clamp(pp, min=0.0)) * op,
                                max=cfg.alpha_clamp)
            cq = oo - col(kmarch.T_RAD) * col(kmarch.T_RAD)
            disc = od * od - dd * cq
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            inv_dd = 1.0 / torch.clamp(dd, min=1e-12)
            t_entry, t_exit = (-od - sq) * inv_dd, (-od + sq) * inv_dd
            lo = cfg.t_min if t_lo_a is None else t_lo_a[tb][:, None]
            hi = cfg.t_max if t_hi_a is None else t_hi_a[tb][:, None]
            t_ev = torch.where(t_entry < lo, t_exit, t_entry)
            lv = live[tb][:, None] & present[..., None]
            gate = lv & (alpha > cfg.alpha_min) & (disc >= 0.0) & (t_ev >= lo) & (t_ev <= hi)
            thr = 2.0 * torch.log(op / cfg.alpha_min) + 1e-4
            sm = lv & (dd >= 1e-6) & (oo * dd_s - od * od > (thr + 2e-6 * oo.abs()) * dd_s)
            pres = present[..., None].expand(-1, -1, R)
            acc["pairs"] += int(present.sum()) * lanes
            acc["idle"] += int(present.sum()) * (lanes - R)
            acc["dead"] += int((pres & ~live[tb][:, None]).sum())
            acc["sure_miss"] += int(sm.sum())
            acc["small_dd"] += int((lv & (dd < 1e-6)).sum())
            acc["gated"] += int(gate.sum())
            g = torch.zeros((B, c, lanes), dtype=torch.bool, device=dev)
            g[..., :R] = gate
            g = g.view(B, c, slots, blocks, width // 32, 32).any(-1)  # (B, c, s, b, warps)
            pw = present[:, :, None, None, None].expand_as(g)
            acc["wslots"] += int(pw.sum())
            acc["wslots_empty"] += int((pw & ~g).sum())
            ng = -(-c // 16)
            gp = torch.zeros((B, ng * 16, slots, blocks), dtype=torch.bool, device=dev)
            gp[:, :c] = g.any(-1)
            gp = gp.view(B, ng, 16, slots, blocks).any(2)  # (B, groups, s, b)
            has_g = torch.zeros((B, ng * 16), dtype=torch.bool, device=dev)
            has_g[:, :c] = present
            has_g = has_g.view(B, ng, 16).any(-1)  # (B, groups)
            acc["bgroups"] += int(has_g.sum()) * slots * blocks
            acc["bgroups_empty"] += int((has_g[..., None, None] & ~gp).sum())
            acc["tgroups"] += int(has_g.sum())
            acc["tgroups_empty"] += int((has_g & ~gp.any(-1).any(-1)).sum())
    pairs = max(1, acc["pairs"])
    return {"replayed_chunks": acc["chunks"], "lane_pairs": acc["pairs"],
            **{f"{k}_share": acc[k] / pairs for k in ("idle", "dead", "sure_miss", "small_dd",
                                                       "gated")},
            "empty_warp_slot_share": acc["wslots_empty"] / max(1, acc["wslots"]),
            "empty_block_group_share": acc["bgroups_empty"] / max(1, acc["bgroups"]),
            "empty_tile_group_share": acc["tgroups_empty"] / max(1, acc["tgroups"]),
            "counts": acc}


def k3_train_args(sc, cam, cfg, gen):
    """(args, kw) of K3 on a training view: the training rows of `sc` seen by
    `cam` under `cfg`, K1's saved carries from the package's kernels (the
    scalar response from the eye as per-ray origins in window order, the
    quad response in key order) and d_rgb, d_tfinal drawn from `gen`."""
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import chunk_for
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_train_stream
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch

    with torch.no_grad():
        stream, trows, _ = prepare_train_stream(sc, cam, cfg)
    starts, trows = stream.starts, trows.detach().contiguous()
    dirs_t = tile_rays(cameras.generate_rays(cam, cfg)[1], cfg.tile_w, cfg.tile_h)
    chunk = chunk_for(cfg)
    kw = {"origins_t": cam.eye.expand(dirs_t.shape).contiguous()} if cfg.order == "window" else {}
    got = kmarch.march(starts, trows, dirs_t, cfg, chunk, save_tin=True, **kw)
    d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dirs_t.device)
    d_t = torch.randn(dirs_t.shape[:2], generator=gen, device=dirs_t.device)
    return (starts, trows, dirs_t, cam.eye, got[2], got[3], d_rgb, d_t, cfg, chunk), {}


def k3_origin_args(sc, cfg, gen):
    """(args, kw) of K3 from per-ray origins and windows: a 512x512 rolling
    shutter of `sc` (the eye moving 0.05 along x), K1's saved carries from
    the package's kernels (the per-ray-origin quad response in key order,
    the scalar one in window order), d_rgb from `gen`, d_tfinal 1."""
    import torch

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import chunk_for
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch

    dev = gen.device
    cam = lambda dx: cameras.Camera.create(eye=(cs.GOLDEN_EYE[0] + dx, *cs.GOLDEN_EYE[1:]),
                                           lookat=(0.0, 0.0, 0.0), width=512, height=512,
                                           device=dev)
    starts, trows, dirs_t, origins_t, _, _ = prepare_rolling_stream(sc, cam(0.0), cam(0.05), cfg,
                                                                     train=True)
    trows = trows.detach().contiguous()
    shape = dirs_t.shape[:2]
    seg = dict(origins_t=origins_t,
               t_lo=0.05 + 0.05 * torch.rand(shape, generator=gen, device=dev),
               t_hi=3.0 + torch.rand(shape, generator=gen, device=dev))
    chunk = chunk_for(cfg)
    got = kmarch.march(starts, trows, dirs_t, cfg, chunk, save_tin=True,
                       quad=cfg.order == "key", **seg)
    d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dev)
    return (starts, trows, dirs_t, torch.zeros(3, device=dev), got[2], got[3], d_rgb,
            torch.ones(shape, device=dev), cfg, chunk), seg


def _load(path: Path):
    """ctypes.CDLL of a kernel library, behind _ThreePassScan where it
    predates the single-pass scan."""
    lib = ctypes.CDLL(str(path))
    return lib if hasattr(lib, "grt_scan_scratch_bytes") else _ThreePassScan(lib)


def main() -> None:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("out_json", type=Path, nargs="?", default=ROOT / "build" / "redesign_ab.json")
    ap.add_argument("--only", choices=GROUPS)
    ap.add_argument("--this", type=Path, dest="this_csrc")
    ap.add_argument("--pairs", type=int, default=1)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch_redesign_ab.py needs a machine with a GPU")
    groups = (opt.only,) if opt.only else GROUPS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import (
        CameraModel, MeshType, RenderConfig, chunk_for,
    )
    from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as kmesh
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
        prepare_pair_stream, prepare_train_stream,
    )
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.ops import tri as ktri
    from gaussian_ray_tracing_tpu_torch.models.renderer import render
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_sphere
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    if opt.this_csrc:
        this = cuda_build.build(opt.this_csrc.resolve(), ROOT / "build" / "kernels_this")
        cuda_build._lib = cuda_build.declare(_load(this))
    libs = {"this": cuda_build.load_library()}
    ptxas = cuda_build.ptxas_table(cuda_build.build_log)
    cs.PTXAS.update(ptxas)  # for cs.tri_design
    other = cuda_build.build(opt.other_csrc.resolve(), ROOT / "build" / "kernels_other")
    libs["other"] = cuda_build.declare(_load(other), info=False)
    if not hasattr(libs["other"], "grt_closest_hit_info"):
        libs["other"] = _WithoutPretests(libs["other"])
    ptxas_other = cuda_build.ptxas_table(cuda_build.build_log)
    cs.log("build", f"this and {opt.other_csrc} built")

    def use(name):
        cuda_build._lib = libs[name]

    def turns(fn) -> dict:
        """Median ms of fn under each build, in opt.pairs rounds of turns
        other, this, this, other: "other" and "this" from CUDA events around
        each call (the wrapper's host work included), "dev_other" and
        "dev_this" the device time of each call's device operations
        (torch.profiler); "ratios" each round's device time of this build
        over the other's (None where a trace read 0)."""
        ms = {"other": [], "this": [], "dev_other": [], "dev_this": []}
        ratios = []
        for _ in range(opt.pairs):
            dev = {"other": [], "this": []}
            for name in ("other", "this", "this", "other"):
                use(name)
                fn()  # warm-up
                ms[name] += cs.cuda_ms(fn, REPS)
                dev[name].append(cs.profile_frames(fn, frames=REPS, top=1)["device_ms"])
                ms["dev_" + name].append(dev[name][-1])
            ok = min(dev["other"] + dev["this"]) > 0
            ratios.append(sum(dev["this"]) / sum(dev["other"]) if ok else None)
        use("this")
        return {**{k: statistics.median(v) for k, v in ms.items()}, "ratios": ratios}

    def dev_times(t) -> dict:
        out = dict(dev_ms_other=t["dev_other"], dev_ms_this=t["dev_this"])
        r = [x for x in t["ratios"] if x is not None]
        if opt.pairs > 1 and r:
            out.update(dev_ratios=t["ratios"], dev_ratio_median=statistics.median(r),
                       this_faster_rounds=sum(x < 1.0 for x in r))
        return out

    def ptx(name: str):
        return next((v for k, v in ptxas.items() if name in k), None)

    def shares(plain, R, order) -> dict:
        chunks = max(1, plain.chunks)
        return dict(marched_slots=plain.candidates,
                    significant_share=plain.significant / max(1, plain.candidates * R),
                    fire_share=plain.fired / chunks if order == "window" else None,
                    slow_share=plain.slow / chunks if order == "merge" else None)

    rows = []

    def write_rows():  # at exit: where a check fails (cs.fail exits) too
        opt.out_json.parent.mkdir(parents=True, exist_ok=True)
        opt.out_json.write_text(json.dumps({"card": card, "rows": rows, "ptxas": ptxas}, indent=1))

    atexit.register(write_rows)

    def k1_case(what, args, kw=None):
        """A K1 render call: bit for bit against the other build, against
        the plain version at the K1 bars, timed in turns."""
        kw = kw or {}
        outs = {}
        for name in ("other", "this"):
            use(name)
            outs[name] = kmarch.march(*args, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
        cs.check(same, f"K1 {what}: outputs differ between the builds")
        cs.k1_check("K1", what, args, kw)
        t = turns(lambda: kmarch.march(*args, **kw))
        plain_ms = statistics.median(cs.cuda_ms(lambda: kmarch.march_plain(*args, **kw), 3))
        b = cs.march_bound(args, kw, kmarch.march_plain)
        cfg, chunk, R = args[3], args[4], args[2].shape[1]
        scalar = kw.get("origins_t") is not None
        info = cuda_build.launch_info("march", chunk, cfg.sh_degree, R, order=cfg.order,
                                      scalar=scalar)
        rows.append(dict(
            case=what, kernel="K1", slots=int(args[0][-1]), chunk=chunk, ms_other=t["other"],
            ms_this=t["this"], plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            bit_identical=same, **dev_times(t), **info,
            ptxas=ptx(cs.kernel_name("march", cfg.order, info["build_chunk"], cfg.sh_degree, R,
                                     scalar=scalar)),
            **{**shares(kmarch.march_plain, R, cfg.order), **cs.k1_stops(args, kw)}))
        cs.log("ab", json.dumps(rows[-1]) + f" ({card})")

    def imbalance(tile_work, slots: int) -> float:
        """Modelled: the busiest of `slots` processors over the mean when the
        tiles, in launch order, each go to the least loaded one (a dynamic
        scheduler once every slot is busy), a tile's cost the (warp, block)
        pairs the kernel counted for it; 1.0 is an even load."""
        import heapq

        work = tile_work.tolist()
        load = [0] * slots
        heapq.heapify(load)
        for w in work:
            heapq.heappush(load, heapq.heappop(load) + w)
        return max(load) / max(1e-9, sum(work) / slots)

    def k4_case(what, args, kw):
        """A K4 call: bit for bit against the other build and against the
        plain version, timed in turns, with the pretests' skip shares."""
        outs = {}
        for name in ("other", "this"):
            use(name)
            outs[name] = ktri.closest_hit_blocks(*args, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
        cs.check(same, f"K4 {what}: outputs differ between the builds")
        want = ktri.closest_hit_blocks_plain(*args, **kw)
        cs.check(all(torch.equal(a, b) for a, b in zip(outs["this"], want)),
                 f"K4 {what}: outputs differ from the plain version")
        t = turns(lambda: ktri.closest_hit_blocks(*args, **kw))
        plain_ms = statistics.median(cs.cuda_ms(
            lambda: ktri.closest_hit_blocks_plain(*args, **kw), 3))
        b = cs.tri_bound(args, kw)
        design = cs.tri_design(args, kw)
        stats = torch.zeros((args[3].shape[0], len(ktri.STATS)), dtype=torch.int32, device=dev)
        ktri.closest_hit_blocks(*args, **kw, stats=stats)
        rows.append(dict(
            case=what, kernel="K4", listed_blocks=int(args[0][-1]) // 256,
            hits=int((want[1] >= 0).sum()), ms_other=t["other"], ms_this=t["this"],
            plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], bit_identical=same,
            **dev_times(t), **design,
            imbalance_per_sm=imbalance(stats[:, 2], 132)))
        cs.log("ab", json.dumps(rows[-1]) + f" ({card})")

    def stream_args(sc, cam, cfg, cap=1 << 21):
        stream, feats, _ = prepare_pair_stream(sc, cam, cfg, cap)
        dirs_t = tile_rays(cameras.generate_rays(cam, cfg)[1], cfg.tile_w, cfg.tile_h)
        return stream.starts, feats, dirs_t, cfg, chunk_for(cfg)

    # the streams: the 720p/100k headline, fitted_20k.ply at 720p, the
    # 256x256 golden scene, the mesh frames' bounces and a rolling shutter
    radius = float(np.linalg.norm(cs.GOLDEN_EYE))
    pose = cameras.orbit_camera((0.0, 0.0, 0.0), radius, 0, 6.0, width=1280, height=720,
                                device=dev)
    camera = lambda w, h, eye=cs.GOLDEN_EYE: cameras.Camera.create(
        eye=eye, lookat=(0.0, 0.0, 0.0), width=w, height=h, device=dev)
    cam720 = camera(1280, 720)
    cam720_moved = camera(1280, 720, eye=(cs.GOLDEN_EYE[0] + 0.05, *cs.GOLDEN_EYE[1:]))
    scene = random_scene(100_000, seed=0, device=dev)
    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    bench = RenderConfig(**cs.BENCH_KW)

    def mesh_bounces(cfg, center, sc=None, tess=(180, 90)):
        """K1's (args, kw) of every bounce of a 1280x720 frame of `sc`
        (`scene` by default) with a glass sphere of tess_u x tess_v faces at
        `center` (chip_smoke.py's mesh frames: glass, glass_front and, at
        36x18, glass_cli)."""
        record = []
        sphere = make_sphere(center, tess_u=tess[0], tess_v=tess[1],
                             device=dev).with_type(MeshType.GLASS)
        kmesh.render_with_mesh_fast(scene if sc is None else sc, sphere, cam720, cfg,
                                    record=record)
        torch.cuda.synchronize()
        return [rec["k1"] for rec in record]

    def rolling(cfg):
        starts, rows_, dirs_t, origins_t, _, _ = prepare_rolling_stream(scene, cam720,
                                                                        cam720_moved, cfg)
        return (starts, rows_, dirs_t, cfg, 128), {"origins_t": origins_t}

    if "render" in groups:
        for what, args in (
                ("window headline 720p/100k", stream_args(scene, pose, bench)),
                ("window sh3 fitted_20k 720p",
                 stream_args(ply, cam720, bench.replace(sh_degree=3)))):
            k1_case(what, args)

    if "modes" in groups:  # the window kernel's other modes
        k1_case("window segment glass bounce 0", *mesh_bounces(bench, (0.0, 0.0, 0.5))[0])
        # every bounce of the glass_front and glass_cli frames, and of
        # glass_front under a fisheye camera and at SH 3 (fitted_20k.ply)
        fish = bench.replace(camera_model=CameraModel.FISHEYE)
        for name, frame in (
                ("glass_front", mesh_bounces(bench, (0.0, 0.0, 1.6))),
                ("glass_cli", mesh_bounces(bench, (0.0, 0.0, 1.6), tess=(36, 18))),
                ("fisheye_glass_front", mesh_bounces(fish, (0.0, 0.0, 1.6))),
                ("sh3_glass_front", mesh_bounces(bench.replace(sh_degree=3), (0.0, 0.0, 1.6),
                                                 sc=ply))):
            for b, (args, kw) in enumerate(frame):
                if name == "glass_cli" and b == 0 or name.startswith(("fish", "sh3")) and b > 1:
                    continue
                mode = "block" if "blocks" in kw else "segment"
                k1_case(f"window {mode} {name} bounce {b}", args, kw)
        k1_case("window rolling 720p/100k", *rolling(bench))

    if "merge" in groups:
        merge = bench.replace(order="merge", bounce_order="merge")
        z = np.load(ROOT / "data" / "golden" / "small_pinhole_256.npz")
        n, seed, width, height, hm, _ = (int(v) for v in z["meta"])
        golden = random_scene(n, seed=seed, device=dev)
        front = mesh_bounces(merge, (0.0, 0.0, 1.6))
        for what, args, kw in (
                ("merge headline 720p/100k c=128", stream_args(scene, pose, merge), {}),
                ("merge sh3 fitted_20k 720p c=128",
                 stream_args(ply, cam720, merge.replace(sh_degree=3)), {}),
                ("merge golden small_pinhole_256 c=64",
                 stream_args(golden, camera(width, height), merge.replace(
                     hit_multiplicity=hm, march_chunk=64)), {}),
                ("merge golden small_pinhole_256 c=128",
                 stream_args(golden, camera(width, height),
                             merge.replace(hit_multiplicity=hm)), {}),
                ("merge segment glass_front bounce 0", *front[0]),
                ("merge rolling 720p/100k", *rolling(merge)),
                ("merge block glass_front bounce 1", *front[1])):
            k1_case(what, args, kw)

    def train_case(what, sc, cam, cfg, with_k3=True):
        """The training forward (K1 with saved carries) on one view, bit
        for bit against the other build and at the bars of the plain
        version, timed in turns; then (with_k3) K3 on its carries."""
        with torch.no_grad():
            stream, trows, n_pairs = prepare_train_stream(sc, cam, cfg)
        starts, trows = stream.starts, trows.detach().contiguous()
        dirs_t = tile_rays(cameras.generate_rays(cam, cfg)[1], cfg.tile_w, cfg.tile_h)
        chunk, R = chunk_for(cfg), dirs_t.shape[1]
        window = cfg.order == "window"
        kw = {"origins_t": cam.eye.expand(dirs_t.shape).contiguous()} if window else {}
        fwd = lambda: kmarch.march(starts, trows, dirs_t, cfg, chunk, save_tin=True, **kw)
        outs = {}
        for name in ("other", "this"):
            use(name)
            outs[name] = fwd()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
        cs.check(same, f"K1 {what}: outputs differ between the builds")
        got = outs["this"]
        cs.k1_train_check(what, got, kmarch.march_plain(starts, trows, dirs_t, cfg, chunk,
                                                        save_tin=True, **kw))
        t1 = turns(fwd)
        plain1 = statistics.median(cs.cuda_ms(lambda: kmarch.march_plain(
            starts, trows, dirs_t, cfg, chunk, save_tin=True, **kw), 3))
        b1 = cs.march_bound((starts, trows, dirs_t, cfg, chunk), kw, kmarch.march_plain,
                            tin=got[2])
        sig1 = kmarch.march_plain.significant / max(1, kmarch.march_plain.candidates
                                                    * dirs_t.shape[1])
        fire1 = kmarch.march_plain.fired / max(1, kmarch.march_plain.chunks)
        info1 = cuda_build.launch_info("march", chunk, cfg.sh_degree, R, order=cfg.order,
                                       scalar=window, train=True)
        rows.append(dict(
            case=what, kernel="K1 save_tin", pairs=n_pairs, chunk=chunk, ms_other=t1["other"],
            ms_this=t1["this"], plain_ms=plain1, bound_ms=b1[0], bound_by=b1[1],
            bit_identical=same, **dev_times(t1), **info1,
            ptxas=ptx(cs.kernel_name("march", cfg.order, info1["build_chunk"], cfg.sh_degree,
                                     R, scalar=window, train=True)),
            significant_share=sig1, fire_share=fire1 if window else None))
        cs.log("ab", json.dumps(rows[-1]) + f" ({card})")
        if not with_k3:
            return

        gen = torch.Generator(device=dev).manual_seed(0)
        d_rgb = torch.randn(dirs_t.shape, generator=gen, device=dev)
        d_t = torch.randn(dirs_t.shape[:2], generator=gen, device=dev)
        bargs = (starts, trows, dirs_t, cam.eye, got[2], got[3], d_rgb, d_t, cfg, chunk)
        use("other")
        g_other = kbwd.march_bwd(*bargs)
        use("this")
        cs.k3_check(what, bargs)
        g_this = kbwd.march_bwd(*bargs)
        rel = float((g_this - g_other).abs().max() / g_other.abs().max())
        t3 = turns(lambda: kbwd.march_bwd(*bargs))
        plain3 = statistics.median(cs.cuda_ms(lambda: kbwd.march_bwd_plain(*bargs), 3))
        b3 = cs.bwd_bound(bargs, kbwd.march_bwd_plain)
        info3 = cuda_build.launch_info("march_bwd", chunk, cfg.sh_degree, R, order=cfg.order)
        rows.append(dict(
            case=what, kernel="K3", pairs=n_pairs, chunk=chunk, ms_other=t3["other"],
            ms_this=t3["this"], plain_ms=plain3, bound_ms=b3[0], bound_by=b3[1],
            max_rel_vs_other=rel, bit_identical=torch.equal(g_this, g_other), **dev_times(t3),
            **info3,
            ptxas=ptx(cs.kernel_name("march_bwd", cfg.order, info3["build_chunk"],
                                     cfg.sh_degree, R)),
            significant_share=kbwd.march_bwd_plain.significant
            / max(1, kbwd.march_bwd_plain.candidates * dirs_t.shape[1]),
            fire_share=kbwd.march_bwd_plain.fired / max(1, kbwd.march_bwd_plain.chunks)))
        cs.log("ab", json.dumps(rows[-1]) + f" ({card})")

    if any(g in groups for g in ("train", "key", "cluster", "bwd")):
        # --- training views, 512x512: the JAX bench's row and fitted_20k.ply
        init = random_scene(50_000, seed=1, device=dev)
        center = ply.center().cpu().numpy()
        cam512 = cameras.orbit_camera(center, 2.8, 0.0, 15.0, width=512, height=512, device=dev)
        center0 = random_scene(50_000, seed=0, device=dev).center().cpu().numpy()
        cam512s = cameras.orbit_camera(center0, 2.8, 0.0, 15.0, width=512, height=512,
                                       device=dev)
        win = RenderConfig(hit_multiplicity=1, order="window", march_chunk=128)
        key = RenderConfig(hit_multiplicity=1, order="key", march_chunk=256)
        train_cases = [("train window sh0 50k", init, cam512s, win),
                       ("train window sh3 fitted_20k", ply, cam512, win.replace(sh_degree=3)),
                       ("train key sh0 50k", init, cam512s, key),
                       ("train key sh3 fitted_20k", ply, cam512, key.replace(sh_degree=3))]

    if "train" in groups:
        for case in train_cases:
            train_case(*case)

    if "key" in groups:  # every mode of the key-order kernel
        keyc = bench.replace(order="key", march_chunk=256)
        as_key = lambda args, kw: ((*args[:3], args[3].replace(order="key"), *args[4:]), kw)
        seg = as_key(*mesh_bounces(bench, (0.0, 0.0, 0.5))[0])
        blk_args, blk_kw = as_key(*mesh_bounces(bench, (0.0, 0.0, 1.6))[1])
        for what, args, kw in (
                ("key headline 720p/100k c=256", stream_args(scene, pose, keyc), {}),
                ("key sh3 fitted_20k 720p c=256",
                 stream_args(ply, cam720, keyc.replace(sh_degree=3)), {}),
                ("key rolling 720p/100k c=128", *rolling(bench.replace(order="key"))),
                ("key segment glass bounce 0", *seg),
                ("key headline 720p/100k 32x32 tiles c=128",
                 stream_args(scene, pose, bench.replace(order="key", tile_w=32, tile_h=32)), {}),
                ("key headline 720p/100k 64x32 tiles c=128",
                 stream_args(scene, pose, bench.replace(order="key", tile_w=64, tile_h=32)), {}),
                ("key block glass_front bounce 1 block_sub=1", blk_args, blk_kw),
                ("key block glass_front bounce 1 block_sub=2",
                 (*blk_args[:4], 2 * blk_args[4]), {**blk_kw, "block_sub": 2})):
            k1_case(what, args, kw)
        for case in train_cases:
            if case[3].order == "key":
                train_case(*case, with_k3=False)

    if "cluster" in groups:  # the cluster builds at one ray a thread
        for (tw, th, c) in ((64, 32, 128), (64, 64, 128), (128, 64, 128), (64, 64, 64),
                           (64, 64, 32)):
            for order in ("window", "key", "merge"):
                cfg = bench.replace(order=order, tile_w=tw, tile_h=th, march_chunk=c)
                k1_case(f"{order} headline 720p/100k {tw}x{th} tiles c={c}",
                        stream_args(scene, pose, cfg), {})
        for (tw, th) in ((130, 64), (128, 128)):  # two rays a thread (8320: the second 128)
            cfg = bench.replace(order="merge", tile_w=tw, tile_h=th)
            k1_case(f"merge headline 720p/100k {tw}x{th} tiles c=128",
                    stream_args(scene, pose, cfg), {})
        for case in train_cases:
            if case[1] is init:
                train_case(f"{case[0]} 64x64 tiles", *case[1:3],
                           case[3].replace(tile_w=64, tile_h=64))

    k3_failed = []  # the bwd group's failed checks, reported after it

    def k3_bars(what, args, kw) -> bool:
        """Whether K3 under the current build holds chip_smoke's K3 bars
        (cs.k3_check, which prints why where it does not)."""
        try:
            cs.k3_check(what, args, kw)
        except SystemExit:
            return False
        return True

    def bwd_case(what, args, kw):
        """K3 alone: bit for bit against the other build, at chip_smoke's K3
        bars of the plain version, timed in turns, with the shares of
        k3_shares (modelled in torch on the same rows)."""
        outs = {}
        for name in ("other", "this"):
            use(name)
            outs[name] = kbwd.march_bwd(*args, **kw)
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        bars = k3_bars(what, args, kw)
        if not (same and bars):
            k3_failed.append(f"{what}: bit_identical {same}, bars {bars}")
        t = turns(lambda: kbwd.march_bwd(*args, **kw))
        plain_ms = cs.cuda_ms(lambda: kbwd.march_bwd_plain(*args, **kw), 1)[0]
        b = cs.bwd_bound(args, kbwd.march_bwd_plain, kw)
        cfg, chunk, R = args[8], args[9], args[2].shape[1]
        info = cuda_build.launch_info("march_bwd", chunk, cfg.sh_degree, R, order=cfg.order,
                                      scalar=bool(kw))
        name = cs.kernel_name("march_bwd", cfg.order, info["build_chunk"], cfg.sh_degree, R,
                              scalar=bool(kw))
        rows.append(dict(
            case=what, kernel="K3", rays=R, chunk=chunk, ms_other=t["other"],
            ms_this=t["this"], plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            bit_identical=same, bars=bars, **dev_times(t), **info, ptxas=ptx(name),
            ptxas_other=next((v for k, v in ptxas_other.items() if name in k), None),
            modelled=k3_shares(args, kw)))
        cs.log("ab", json.dumps(rows[-1]) + f" ({card})")

    if "bwd" in groups:  # K3 alone on every build: crafted calls, training views, origins
        # the crafted calls (tests/bwd_wide_streams.py): each build's digest
        # and its bars apart, and the digests K3_WIDE_DIGESTS records
        sys.path.insert(0, str(ROOT / "tests"))
        import hashlib

        import test_torch_gpu as gpu_tests

        crafted = {}
        for case in gpu_tests.K3_WIDE_CASES:
            name = gpu_tests._k3_case_name(case)
            args, kw = gpu_tests._k3_wide_call(case)
            res = {}
            for build in ("other", "this"):
                use(build)
                out = kbwd.march_bwd(*args, **kw).contiguous().cpu().numpy()
                res[f"{build}_digest"] = hashlib.sha256(out.tobytes()).hexdigest()
                res[f"{build}_bars"] = k3_bars(f"crafted {name} ({build})", args, kw)
            use("this")
            res["bit_identical"] = res["other_digest"] == res["this_digest"]
            res["recorded"] = gpu_tests.K3_WIDE_DIGESTS.get(name)
            crafted[name] = res
            if not (res["bit_identical"] and res["this_bars"]
                    and res["recorded"] in (None, res["this_digest"])):
                k3_failed.append(f"crafted {name}: {json.dumps(res)}")
        rows.append({"case": "K3 crafted calls", "kernel": "K3", "calls": crafted})
        cs.log("ab", json.dumps(rows[-1]) + f" ({card})")
        gen = torch.Generator(device=dev).manual_seed(0)
        for tw, th in ((16, 16), (32, 16), (32, 32), (64, 32), (64, 64), (128, 64), (130, 64),
                       (128, 128)):
            for what, sc, cam, cfg in train_cases:
                bwd_case(f"K3 {what[6:]} {tw}x{th} tiles",
                         *k3_train_args(sc, cam, cfg.replace(tile_w=tw, tile_h=th), gen))
        for tw, th in ((32, 32), (64, 32)):
            for cfg in (key, win):
                bwd_case(f"K3 {cfg.order} per-ray origins 50k sh0 {tw}x{th} tiles",
                         *k3_origin_args(init, cfg.replace(tile_w=tw, tile_h=th), gen))
        cs.check(not k3_failed, "K3 checks failed: " + "; ".join(k3_failed))

    if "scan" in groups:  # K2 on the headline's pair capacity, exact
        gen = torch.Generator(device=dev).manual_seed(0)
        for shape in ((2, 2_097_152), (16, 1_000_003)):
            x = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device=dev,
                              generator=gen)
            outs = {}
            for name in ("other", "this"):
                use(name)
                outs[name] = kscan.multi_cumsum_i32(x)
            torch.cuda.synchronize()
            want = kscan.multi_cumsum_i32_plain(x)
            same = torch.equal(outs["other"], outs["this"])
            cs.check(same and torch.equal(outs["this"], want),
                     f"K2 {shape}: differs between the builds or from the plain version")
            t = turns(lambda: kscan.multi_cumsum_i32(x))
            plain_ms = statistics.median(cs.cuda_ms(lambda: kscan.multi_cumsum_i32_plain(x), 10))
            lib_ms = statistics.median(cs.cuda_ms(lambda: torch.cumsum(x, dim=1), 10))
            b = cs.bound(2 * x.numel() * 4, x.numel())
            rows.append(dict(case=f"K2 scan {shape}", kernel="K2", ms_other=t["other"],
                             ms_this=t["this"], plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b[0], bound_by=b[1], bit_identical=same, **dev_times(t),
                             **cs.scan_design(x)))
            cs.log("ab", json.dumps(rows[-1]) + f" ({card})")

    if "mesh" in groups:
        spheres = {"glass": make_sphere((0.0, 0.0, 0.5), device=dev),
                   "glass_front": make_sphere((0.0, 0.0, 1.6), device=dev),
                   "glass_cli": make_sphere((0.0, 0.0, 1.6), tess_u=36, tess_v=18, device=dev)}
        spheres = {k: v.with_type(MeshType.GLASS) for k, v in spheres.items()}
        recs = {}
        for name, sphere in spheres.items():
            recs[name] = []
            kmesh.render_with_mesh_fast(scene, sphere, cam720, bench, record=recs[name])
            torch.cuda.synchronize()
        for name, b in (("glass", 0), ("glass_front", 0), ("glass_front", 1), ("glass_cli", 1),
                        ("glass_cli", 2), ("glass_cli", 3)):
            if b < len(recs[name]):
                origin = "shared origin" if b == 0 else "per-ray origins"
                k4_case(f"K4 {name} bounce {b} ({origin})", *recs[name][b]["k4"])
        blk_args, blk_kw = recs["glass_front"][1]["k1"]
        for order in ("window", "key", "merge"):
            for bsub in (1, 2):
                args = (*blk_args[:3], blk_args[3].replace(order=order), blk_args[4] * bsub)
                k1_case(f"{order} block glass_front bounce 1 block_sub={bsub}", args,
                        {**blk_kw, "block_sub": bsub})
        for name in ("glass_front", "glass_cli"):  # the whole frames, in turns
            frame = lambda: render(scene, cam720, bench, mesh=spheres[name], method="gpu")
            outs = {}
            for build in ("other", "this"):
                use(build)
                outs[build] = frame()["rgb"]
            torch.cuda.synchronize()
            same = torch.equal(outs["other"], outs["this"])
            cs.check(same, f"{name} frame differs between the builds")
            k4n, blkn = ktri.closest_hit_blocks.launches, kmarch.march.block_launches
            frame()
            launches = dict(closest_hit=ktri.closest_hit_blocks.launches - k4n,
                            march_block=kmarch.march.block_launches - blkn)
            t = turns(frame)
            rows.append(dict(case=f"{name} frame 1280x720 100k", kernel="frame",
                             ms_other=t["other"], ms_this=t["this"], bit_identical=same,
                             **dev_times(t), launches_per_frame=launches))
            cs.log("ab", json.dumps(rows[-1]) + f" ({card})")

    print(json.dumps({"ok": True, "card": card}), flush=True)


if __name__ == "__main__":
    main()
