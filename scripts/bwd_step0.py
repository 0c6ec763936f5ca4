#!/usr/bin/env python3
"""Where K3 (csrc/march_bwd.cuh) as it was at commit 1d2f322 spends its
time on wide tiles, on one NVIDIA GPU: a copy of that commit's K3 sources
instrumented, built beside the package's own kernels, on the 512x512
training views (50k gaussians at SH 0, fitted_20k.ply at SH 3) in key and
window order on tiles of 16x16 to 128x128 rays, and from per-ray origins (a
rolling shutter) on 32x32 and 64x32 tiles.

The instrumented copy sums, per thread, clock64 cycles in each part of the
kernel: the skip replay (a block barrier, or a cluster barrier), staging,
window order's listing (K1's fire test: every candidate evaluated) and its
exchange, several rays a thread's second listing, pass A (key order: every
candidate evaluated and the prefix; window order: the sort and the two
sweeps over the list), pass B's second evaluation, the butterfly (and a
warp's zero partials), the wait at each block barrier of a group, the block
sum, the cluster barrier and the exchange through distributed shared
memory, `finish`, the device-memory sums of several rays a thread (acc)
and their barrier, and the kernel's end (a cluster barrier). With counting
on it also counts, per (ray, candidate) pair of the replayed chunks, idle
lanes, dead rays, the pairs K1's sure-miss test (march.cuh sure_miss with
miss_threshold, where dd >= 1e-6) would stop and those it would stop but
that gate (must be 0), pairs with dd below 1e-6 and gated pairs; per
(warp, candidate) slot of pass B the slots with no bit set; per group the
groups that no warp of the block gated. The counts go to an int64 buffer
that grt_bwd_prof (added to the copy's march_bwd.cu) hands to every later
launch. The share of groups that no warp of the whole cluster gated is
modelled in torch (torch_redesign_ab.k3_shares), and the model's block
counts are printed beside the kernel's.

    git archive 1d2f322 gaussian_ray_tracing_tpu_torch/csrc | tar -x -C build/parent
    python3 scripts/bwd_step0.py build/parent/gaussian_ray_tracing_tpu_torch/csrc [out.json]

Each case is timed in turns (the parent's K3, then the instrumented copy
with no counters on), CUDA events around each call, median of REPS calls a
turn, ROUNDS rounds. Writes the rows and the ptxas table to out.json (build/bwd_step0.json by default); exits non-zero where there is
no GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402  (its helpers; it imports torch lazily)

REPS = 5
ROUNDS = 3
SLOTS = 64  # copies of the sums, by block, against atomic contention
CYCLES = ("total", "skip", "stage", "listing", "vote", "relist", "pass_a", "eval2", "butterfly",
          "bar_part", "block_sum", "cl_bar", "exchange", "bar_sum", "finish", "bar_fin", "acc",
          "bar_acc", "end")
COUNTS = ("pairs", "idle", "dead", "sure_miss", "violations", "small_dd", "gated", "wslots",
          "wslots_empty", "groups", "groups_empty")

_DEFS = """\
// step 0 (scripts/bwd_step0.py): the instrumented K3's sums
constexpr int kProf = %d;
enum ProfIdx { %s };
#define PB() (pts = clock64())
#define PE(q) (pc[q] += (unsigned long long)(clock64() - pts))
#define COUNT_PAIR(e, cd, gated)                                                          \\
  do {                                                                                    \\
    pc[kP_pairs]++;                                                                       \\
    if (!ok) {                                                                            \\
      pc[kP_idle]++;                                                                      \\
    } else if (!rb.live) {                                                                \\
      pc[kP_dead]++;                                                                      \\
    } else {                                                                              \\
      const float oo_ = (e).ogx * (e).ogx + (e).ogy * (e).ogy + (e).ogz * (e).ogz;         \\
      const float dd_ = (e).dgx * (e).dgx + (e).dgy * (e).dgy + (e).dgz * (e).dgz;         \\
      const bool sm_ = dd_ >= 1e-6f && k1::sure_miss(oo_, (e).od, fmaxf(dd_, 1e-6f),       \\
                                                      k1::miss_threshold((cd).op, p.alpha_min)); \\
      if (sm_) pc[kP_sure_miss]++;                                                        \\
      if (sm_ && (gated)) pc[kP_violations]++;                                            \\
      if (dd_ < 1e-6f) pc[kP_small_dd]++;                                                 \\
    }                                                                                     \\
    if (gated) pc[kP_gated]++;                                                            \\
  } while (0)

""" % (len(CYCLES) + len(COUNTS), ", ".join(f"kP_{n}" for n in (*CYCLES, *COUNTS)))

# (anchor, replacement, occurrences): text edits of march_bwd.cuh
PATCHES = [
    ("struct Params {\n", _DEFS + "struct Params {\n", 1),
    ("  int scratch_tiles, tile0;  // as k1::Params'\n};\n",
     "  int scratch_tiles, tile0;  // as k1::Params'\n"
     "  unsigned long long* prof;  // step 0's sums, or null\n  int variant;  // 1: count\n};\n", 1),
    ("  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;\n",
     "  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;\n"
     "  unsigned long long pc[kProf] = {};\n"
     "  const bool cnt = (p.variant & 1) != 0;\n"
     "  bool first_listing = true;\n"
     "  long long pts = clock64();\n"
     "  const long long pstart = pts;\n", 1),
    ("    if (k1::tile_reduce1<kCl>(t_max, true, red, par) <= p.min_t) {\n",
     "    PB();\n"
     "    const bool skip_ = k1::tile_reduce1<kCl>(t_max, true, red, par) <= p.min_t;\n"
     "    PE(kP_skip);\n"
     "    if (skip_) {\n", 1),
    ("    float* sf = smem + (kStages == 2 ? (j & 1) * C * kS : 0);\n",
     "    PB();\n    float* sf = smem + (kStages == 2 ? (j & 1) * C * kS : 0);\n", 1),
    ("    __syncthreads();\n\n    // window order: the current ray's",
     "    __syncthreads();\n    PE(kP_stage);\n\n    // window order: the current ray's", 1),
    ("          const Eval e = evaluate<kOrig>(p, cd, rb);\n"
     "          if (!(e.a > 0.f)) continue;\n",
     "          const Eval e = evaluate<kOrig>(p, cd, rb);\n"
     "          if (cnt && first_listing) COUNT_PAIR(e, cd, e.a > 0.f);\n"
     "          if (!(e.a > 0.f)) continue;\n", 1),
    ("      bool t_inv = false;\n      for (int s = 0; s < slots; ++s) {\n",
     "      PB();\n      bool t_inv = false;\n      for (int s = 0; s < slots; ++s) {\n", 1),
    ("      if constexpr (kCl) {  // the vote and the key range in one exchange\n",
     "      PE(kP_listing);\n      PB();\n"
     "      if constexpr (kCl) {  // the vote and the key range in one exchange\n", 1),
    ("          ghi = k1::block_reduce(ghi, true, red);\n        }\n      }\n    }\n",
     "          ghi = k1::block_reduce(ghi, true, red);\n        }\n      }\n"
     "      PE(kP_vote);\n    }\n", 1),
    ("        t_in = ok ? tin[(size_t)j * R + at.ray] : 0.f;\n        if (kWindow) listing();\n",
     "        PB();\n        t_in = ok ? tin[(size_t)j * R + at.ray] : 0.f;\n"
     "        first_listing = false;\n        if (kWindow) listing();\n"
     "        first_listing = true;\n        PE(kP_relist);\n", 1),
    ("      float base = 0.f, D = 0.f;\n",
     "      PB();\n      float base = 0.f, D = 0.f;\n", 1),
    ("            const Eval e = evaluate<kOrig>(p, cd, rb);\n"
     "            if (!e.gate) continue;  // a = 0: no term of the sums moves\n",
     "            const Eval e = evaluate<kOrig>(p, cd, rb);\n"
     "            if (cnt) COUNT_PAIR(e, cd, e.gate);\n"
     "            if (!e.gate) continue;  // a = 0: no term of the sums moves\n", 1),
    ("      if (multi && ok) k1::carried(p, at, 1, 0) = dT;\n",
     "      if (multi && ok) k1::carried(p, at, 1, 0) = dT;\n      PE(kP_pass_a);\n", 1),
    ("        const int gn = min(kGroup, m - g0);\n        for (int gi = 0; gi < gn; ++gi) {\n",
     "        const int gn = min(kGroup, m - g0);\n        bool grp_any_ = false;\n"
     "        for (int gi = 0; gi < gn; ++gi) {\n", 1),
    ("          if (!__any_sync(0xffffffffu, bit)) {  // every term of this warp is zero\n"
     "#pragma unroll\n"
     "            for (int rr = 0; rr < NR; ++rr) dst[32 * rr + lane] = 0.f;\n"
     "            continue;\n"
     "          }\n"
     "          float g[14], dcm[3];\n",
     "          const bool wany_ = __any_sync(0xffffffffu, bit);\n"
     "          if (cnt && lane == 0) {\n"
     "            pc[kP_wslots]++;\n"
     "            if (!wany_) pc[kP_wslots_empty]++;\n"
     "          }\n"
     "          grp_any_ |= wany_;\n"
     "          if (!wany_) {  // every term of this warp is zero\n"
     "            PB();\n"
     "#pragma unroll\n"
     "            for (int rr = 0; rr < NR; ++rr) dst[32 * rr + lane] = 0.f;\n"
     "            PE(kP_butterfly);\n"
     "            continue;\n"
     "          }\n"
     "          PB();\n"
     "          float g[14], dcm[3];\n", 1),
    ("          }\n#pragma unroll\n          for (int rr = 0; rr < NR; ++rr) {\n            float v[32];\n",
     "          }\n          PE(kP_eval2);\n          PB();\n"
     "#pragma unroll\n          for (int rr = 0; rr < NR; ++rr) {\n            float v[32];\n", 1),
    ("            dst[32 * rr + lane] = warp_transpose_sum(v);\n          }\n        }\n"
     "        __syncthreads();  // every warp's partials of this group are in\n",
     "            dst[32 * rr + lane] = warp_transpose_sum(v);\n          }\n"
     "          PE(kP_butterfly);\n        }\n"
     "        PB();\n"
     "        __syncthreads();  // every warp's partials of this group are in\n"
     "        PE(kP_bar_part);\n"
     "        if (cnt) {\n"
     "          const bool bany_ = __syncthreads_or(grp_any_);\n"
     "          if (tid == 0) {\n"
     "            pc[kP_groups]++;\n"
     "            if (!bany_) pc[kP_groups_empty]++;\n"
     "          }\n"
     "        }\n"
     "        PB();\n", 1),
    ("          __syncthreads();  // the partials are consumed\n          continue;\n",
     "          PE(kP_acc);\n          PB();\n"
     "          __syncthreads();  // the partials are consumed\n"
     "          PE(kP_bar_acc);\n          continue;\n", 1),
    ("            x[q] = s;\n          }\n          k1::cg::cluster_group cl = k1::cg::this_cluster();\n"
     "          cl.sync();\n",
     "            x[q] = s;\n          }\n          PE(kP_block_sum);\n          PB();\n"
     "          k1::cg::cluster_group cl = k1::cg::this_cluster();\n"
     "          cl.sync();\n          PE(kP_cl_bar);\n          PB();\n", 1),
    ("          xpar ^= 1;\n", "          PE(kP_exchange);\n          xpar ^= 1;\n", 1),
    ("            part[q] = s;\n          }\n        }\n        __syncthreads();\n",
     "            part[q] = s;\n          }\n          PE(kP_block_sum);\n        }\n"
     "        PB();\n        __syncthreads();\n        PE(kP_bar_sum);\n        PB();\n", 1),
    ("          finish<K, kOrig>(p, sf + (g0 + gi) * kS, part + (size_t)gi * TP, row0 + g0 + gi);\n"
     "        __syncthreads();  // the group's sums are consumed\n",
     "          finish<K, kOrig>(p, sf + (g0 + gi) * kS, part + (size_t)gi * TP, row0 + g0 + gi);\n"
     "        PE(kP_finish);\n        PB();\n"
     "        __syncthreads();  // the group's sums are consumed\n        PE(kP_bar_fin);\n", 1),
    ("    __threadfence();\n    k1::cg::cluster_group cl = k1::cg::this_cluster();\n    cl.sync();\n",
     "    PB();\n    __threadfence();\n    k1::cg::cluster_group cl = k1::cg::this_cluster();\n"
     "    cl.sync();\n    PE(kP_cl_bar);\n", 1),
    ("      const int gn = min(kGroup, m - g0);\n      for (int q = tid; q < gn * TP; q += blockDim.x) {\n",
     "      const int gn = min(kGroup, m - g0);\n      PB();\n"
     "      for (int q = tid; q < gn * TP; q += blockDim.x) {\n", 1),
    ("        part[q] = (float)s;\n      }\n      __syncthreads();\n",
     "        part[q] = (float)s;\n      }\n      PE(kP_acc);\n      PB();\n      __syncthreads();\n"
     "      PE(kP_bar_sum);\n      PB();\n", 1),
    ("          finish<K, kOrig>(p, sf + (g0 + gi) * kS, part + (size_t)gi * TP, row0 + g0 + gi);\n"
     "      __syncthreads();  // the group's sums are consumed\n",
     "          finish<K, kOrig>(p, sf + (g0 + gi) * kS, part + (size_t)gi * TP, row0 + g0 + gi);\n"
     "      PE(kP_finish);\n      PB();\n"
     "      __syncthreads();  // the group's sums are consumed\n      PE(kP_bar_fin);\n", 1),
    ("  k1::cp_async_wait<0>();\n  k1::tile_end<kCl>();\n}\n",
     "  k1::cp_async_wait<0>();\n  PB();\n  k1::tile_end<kCl>();\n  PE(kP_end);\n"
     "  pc[kP_total] += (unsigned long long)(clock64() - pstart);\n"
     "  if (p.prof) {\n"
     "    unsigned long long* out = p.prof + (size_t)(blockIdx.x & %d) * kProf;\n"
     "    for (int q = 0; q < kProf; ++q) {\n"
     "      unsigned long long v = pc[q];\n"
     "      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);\n"
     "      if (lane == 0) atomicAdd(out + q, v);\n"
     "    }\n"
     "  }\n}\n" % (SLOTS - 1), 1),
]
CU_PATCHES = [
    ('#include "march_bwd.cuh"\n',
     '#include "march_bwd.cuh"\n\n'
     "static unsigned long long* g_prof = nullptr;\nstatic int g_variant = 0;\n"
     '// step 0: the sums buffer (SLOTS x kProf int64, or null) and variant of\n'
     '// every later grt_march_bwd launch\n'
     'extern "C" void grt_bwd_prof(void* prof, int variant) {\n'
     "  g_prof = (unsigned long long*)prof;\n  g_variant = variant;\n}\n", 1),
    ("           scratch ? (float*)((char*)scratch + acc_bytes) : nullptr, held, 0};\n",
     "           scratch ? (float*)((char*)scratch + acc_bytes) : nullptr, held, 0};\n"
     "  p.prof = g_prof;\n  p.variant = g_variant;\n", 1),
]


def instrument(src: Path, dst: Path) -> None:
    """Copy csrc/ `src` to `dst` with K3 instrumented."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    for name, patches in (("march_bwd.cuh", PATCHES), ("march_bwd.cu", CU_PATCHES)):
        text = (dst / name).read_text()
        for anchor, new, times in patches:
            found = text.count(anchor)
            if found != times:
                raise RuntimeError(f"{name}: {found} of {times} expected: {anchor[:70]!r}")
            text = text.replace(anchor, new)
        (dst / name).write_text(text)


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("csrc", type=Path)
    ap.add_argument("out_json", type=Path, nargs="?", default=ROOT / "build" / "bwd_step0.json")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("bwd_step0.py needs a machine with a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    from torch_redesign_ab import k3_origin_args, k3_shares, k3_train_args

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as kbwd
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    src = opt.csrc.resolve()
    work = ROOT / "build" / "bwd_step0"
    instrument(src, work / "csrc")
    own = cuda_build.load_library()
    cs.PTXAS.update(cuda_build.ptxas_table(cuda_build.build_log))

    def library(csrc: Path, build_dir: Path):
        return cuda_build.declare(ctypes.CDLL(str(cuda_build.build(csrc, build_dir))))

    parent = library(src, work / "kernels_parent")
    ptxas_parent = cuda_build.ptxas_table(cuda_build.build_log)
    instr = library(work / "csrc", work / "kernels")
    ptxas_instr = cuda_build.ptxas_table(cuda_build.build_log)
    instr.grt_bwd_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    instr.grt_bwd_prof.restype = None
    cs.log("build", f"{src}'s kernels and their instrumented copy built")

    init = random_scene(50_000, seed=1, device=dev)
    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    center = ply.center().cpu().numpy()
    cam512 = cameras.orbit_camera(center, 2.8, 0.0, 15.0, width=512, height=512, device=dev)
    center0 = random_scene(50_000, seed=0, device=dev).center().cpu().numpy()
    cam512s = cameras.orbit_camera(center0, 2.8, 0.0, 15.0, width=512, height=512, device=dev)
    win = RenderConfig(hit_multiplicity=1, order="window", march_chunk=128)
    key = RenderConfig(hit_multiplicity=1, order="key", march_chunk=256)
    gen = torch.Generator(device=dev).manual_seed(0)

    def train_args(sc, cam, cfg):
        cuda_build._lib = own  # the forward's carries from the package's K1
        return k3_train_args(sc, cam, cfg, gen)

    def origin_args(cfg):
        cuda_build._lib = own
        return k3_origin_args(init, cfg, gen)

    cases = []
    for tw, th in ((16, 16), (32, 32), (64, 32), (64, 64), (128, 64), (130, 64), (128, 128)):
        for order, cfg in (("key", key), ("window", win)):
            for what, sc, cam, c in (("50k sh0", init, cam512s, cfg),
                                     ("fitted_20k sh3", ply, cam512, cfg.replace(sh_degree=3))):
                cases.append((f"{order} {what} {tw}x{th}",
                              lambda sc=sc, cam=cam, c=c, tw=tw, th=th:
                              train_args(sc, cam, c.replace(tile_w=tw, tile_h=th))))
    for tw, th in ((32, 32), (64, 32)):
        for order, cfg in (("key", key), ("window", win)):
            cases.append((f"{order} per-ray origins 50k sh0 {tw}x{th}",
                          lambda cfg=cfg, tw=tw, th=th: origin_args(cfg.replace(tile_w=tw,
                                                                                tile_h=th))))
    rows = []
    for name, make in cases:
        args, kw = make()
        R = args[2].shape[1]
        call = lambda: kbwd.march_bwd(*args, **kw)
        cuda_build._lib = parent
        want = call()
        cuda_build._lib = instr
        prof = torch.zeros((SLOTS, len(CYCLES) + len(COUNTS)), dtype=torch.int64, device=dev)
        instr.grt_bwd_prof(prof.data_ptr(), 0)
        got = call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, want), f"{name}: the instrumented copy's output differs")
        cyc = dict(zip(CYCLES, prof.sum(0).tolist()[:len(CYCLES)]))
        prof.zero_()
        instr.grt_bwd_prof(prof.data_ptr(), 1)
        got = call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, want), f"{name}: the counting copy's output differs")
        cnt = dict(zip(COUNTS, prof.sum(0).tolist()[len(CYCLES):]))
        instr.grt_bwd_prof(None, 0)
        cs.check(cnt["violations"] == 0, f"{name}: a sure miss gated")
        model = k3_shares(args, kw)
        ms = {"parent": [], "instrumented": []}
        for _ in range(ROUNDS):
            for who in ms:
                cuda_build._lib = parent if who == "parent" else instr
                call()
                ms[who] += cs.cuda_ms(call, REPS)
        cuda_build._lib = own
        med = {k: statistics.median(v) for k, v in ms.items()}
        dev_ms = cs.profile_frames(lambda: (setattr(cuda_build, "_lib", parent), call()),
                                   frames=REPS, top=1)["device_ms"]
        cuda_build._lib = own
        total = max(1, cyc["total"])
        pairs = max(1, cnt["pairs"])
        info = cuda_build.launch_info("march_bwd", args[9], args[8].sh_degree, R,
                                      order=args[8].order, scalar=bool(kw))
        kname = cs.kernel_name("march_bwd", args[8].order, info["build_chunk"],
                               args[8].sh_degree, R, scalar=bool(kw))
        row = dict(
            case=name, rays=R, chunk=args[9], rays_per_thread=info["rays_per_thread"],
            cluster_blocks=info["cluster_blocks"], ms=med, dev_ms_parent=dev_ms,
            instrumented_over_parent=med["instrumented"] / med["parent"],
            cycle_share={k: v / total for k, v in cyc.items() if k != "total"},
            counts=cnt,
            per_pair={k: cnt[k] / pairs for k in ("idle", "dead", "sure_miss", "small_dd",
                                                  "gated")},
            empty_warp_slot_share=cnt["wslots_empty"] / max(1, cnt["wslots"]),
            empty_block_group_share=cnt["groups_empty"] / max(1, cnt["groups"]),
            modelled=model,
            ptxas={k: next((v for n, v in t.items() if kname in n), None)
                   for k, t in (("parent", ptxas_parent), ("instrumented", ptxas_instr))},
        )
        rows.append(row)
        cs.log("step0", json.dumps(row) + f" ({card})")
    opt.out_json.parent.mkdir(parents=True, exist_ok=True)
    opt.out_json.write_text(json.dumps({"card": card, "rows": rows,
                                        "ptxas_parent": ptxas_parent}, indent=1))
    print(json.dumps({"ok": True, "card": card}), flush=True)


if __name__ == "__main__":
    main()
