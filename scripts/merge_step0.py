#!/usr/bin/env python3
"""Where the cluster build of K1's merge-order kernel as it was at commit
309918a (csrc/march.cuh `march_merge_kernel` with kMaxR = 8192, before
`march_merge_cluster_kernel` replaced it) spends its time on wide tiles, on
one NVIDIA GPU: a copy of that commit's csrc/ with the merge kernel
instrumented, built beside the package's own kernels, on the 720p/100k
headline in merge order on tiles of 2048 to 16,384 rays.

The instrumented copy sums, per thread, clock64 cycles in each phase of
the kernel (the chunk-skip test, staging, the fast-test inputs that a
thread of several rays evaluates first, the copies of a ray's pending
buffer in and out of Params::carry, pass 1, the fast test, the slow
chunk's walk, the fast chunk's composite, the flush) and counts (marched
(ray, chunk) pairs, slow ones and those on a fresh buffer, pass 1's and the
first pass's evaluations, the insertion's shifts, the walk's steps, the
significant slots it moves and composites, the bytes the copies move and
the cluster barriers, one a block), into an int64 buffer passed as the
window-order `stats` pointer, which merge order never reads. Its
`a_fire`, which merge order never reads either, selects a variant with a
part removed: 1 no walk (a slow chunk composites nothing and keeps its
pending buffer), 2 no insertion (each key stored at its stream place), 4
no first pass (several rays a thread: every chunk slow), 8 no copies of
the pending buffer (several rays a thread). The variants' outputs are
wrong; they are timed only. Each case is timed in turns (the package's
own kernels, then the instrumented copy with no counters read at variant
0 and each variant), CUDA events around each call, median of REPS calls a
turn, in ROUNDS rounds.

    git archive 309918a gaussian_ray_tracing_tpu_torch/csrc | tar -x -C build/parent
    python3 scripts/merge_step0.py build/parent/gaussian_ray_tracing_tpu_torch/csrc [out.json]

Writes the rows to out.json (build/merge_step0.json by default) and prints
one line per case; exits non-zero where there is no GPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (its helpers; it imports torch lazily)

REPS = 5
ROUNDS = 3
# the per-thread sums of the instrumented kernel, in its buffer's order
CYCLES = ("total", "skip", "stage", "first_pass", "copies", "pass1", "fast_test", "walk",
          "fast_composite", "flush")
COUNTS = ("marched", "slow", "fresh_slow", "evals", "evals_first", "shifts", "walk_steps",
          "sig_moves", "sig_composited", "copy_bytes", "barriers")
SLOTS = 64  # copies of the sums, by block, against atomic contention
VARIANTS = {"no_walk": 1, "no_insertion": 2, "no_first_pass": 4, "no_copies": 8}

_DEFS = """\
// step 0 (scripts/merge_step0.py): the instrumented merge kernel's sums
constexpr int kProf = %d;
enum ProfIdx { %s };
#define PB() (pts = clock64())
#define PE(q) (pc[q] += (unsigned long long)(clock64() - pts))

""" % (len(CYCLES) + len(COUNTS),
       ", ".join(f"kP_{n}" for n in (*CYCLES, *COUNTS)))

# (anchor, replacement, occurrences): text edits of march.cuh, each anchor
# found exactly `occurrences` times
PATCHES = [
    ("constexpr int kMergeMinBlocks = 2;\n",
     "constexpr int kMergeMinBlocks = 2;\n\n" + _DEFS, 1),
    ("  const int tile = ti.tile, R = blockDim.x, tid = threadIdx.x;  // R: the block's rays "
     "(masks)\n",
     "  const int tile = ti.tile, R = blockDim.x, tid = threadIdx.x;  // R: the block's rays "
     "(masks)\n"
     "  unsigned long long pc[kProf] = {};\n"
     "  unsigned long long* const prof_out = reinterpret_cast<unsigned long long*>(p.stats);\n"
     "  const int variant = (int)p.a_fire;\n"
     "  long long pts = clock64();\n"
     "  const long long pstart = pts;\n", 1),
    ("    if (fresh) return;\n#pragma unroll 1\n",
     "    if (fresh || (variant & 8)) return;\n#pragma unroll 1\n", 2),
    ("  for (int j = 0; j * C < n; ++j) {\n",
     "  for (int j = 0; j * C < n; ++j) {\n    PB();\n", 1),
    ("    if (tile_reduce1<kCl>(t_max, true, red, par) <= p.t_skip) break;\n"
     "    const int m = min(C, n - j * C);\n"
     "    stage_chunk<C, kR, K, false, 1>(sf, thr, p, start, j, n, ob);\n",
     "    const bool stop_ = tile_reduce1<kCl>(t_max, true, red, par) <= p.t_skip;\n"
     "    PE(kP_skip);\n"
     "    if (threadIdx.x == 0) pc[kP_barriers]++;\n"
     "    if (stop_) break;\n"
     "    const int m = min(C, n - j * C);\n"
     "    PB();\n"
     "    stage_chunk<C, kR, K, false, 1>(sf, thr, p, start, j, n, ob);\n"
     "    PE(kP_stage);\n"
     "    PB();\n", 1),
    ("    if (multi)\n      for (int s = 0; s < slots; ++s) {\n        take(s, false);\n",
     "    if (multi && (variant & 4)) ok_all = false;\n"
     "    if (multi && !(variant & 4))\n      for (int s = 0; s < slots; ++s) {\n"
     "        take(s, false);\n        pc[kP_evals_first] += at.valid ? m : 0;\n", 1),
    ("        ok_all &= !inv && new_min >= pend_max;\n      }\n",
     "        ok_all &= !inv && new_min >= pend_max;\n      }\n    PE(kP_first_pass);\n", 1),
    ("      if (multi) take(sl, true);\n",
     "      if (multi) {\n        PB();\n        take(sl, true);\n        PE(kP_copies);\n"
     "        pc[kP_copy_bytes] += at.valid ? 4ull * (fresh ? 5 : kF) : 0ull;\n      }\n"
     "      PB();\n      unsigned shifts_ = 0, moves_ = 0, comps_ = 0;\n", 1),
    ("        if (k > last) {  // keys are unique within the chunk\n",
     "        if (k > last || (variant & 2)) {  // keys are unique within the chunk\n", 1),
    ("          for (; pos > 0 && ck[pos - 1] > k; --pos) ck[pos] = ck[pos - 1];\n",
     "          for (; pos > 0 && ck[pos - 1] > k; --pos) ck[pos] = ck[pos - 1];\n"
     "          shifts_ += i - pos;\n", 1),
    ("          bits(nx, i >> 5) = word;\n          word = 0;\n        }\n      }\n",
     "          bits(nx, i >> 5) = word;\n          word = 0;\n        }\n      }\n"
     "      PE(kP_pass1);\n"
     "      pc[kP_shifts] += shifts_;\n"
     "      pc[kP_evals] += at.valid ? m : 0;\n"
     "      pc[kP_marched] += at.valid;\n"
     "      PB();\n", 1),
    ("          fast = __syncthreads_and(ok);\n      }\n",
     "          fast = __syncthreads_and(ok);\n      }\n"
     "      PE(kP_fast_test);\n"
     "      if (threadIdx.x == 0 && kCl && (!multi || sl == 0)) pc[kP_barriers]++;\n"
     "      PB();\n", 1),
    ("        for (int k = fresh ? C : 0; k < 2 * C; ++k) {\n",
     "        pc[kP_slow] += at.valid;\n"
     "        pc[kP_fresh_slow] += at.valid && fresh;\n"
     "        pc[kP_walk_steps] += at.valid ? (fresh ? C : 2 * C) : 0;\n"
     "        for (int k = fresh ? C : 0; k < ((variant & 1) ? 0 : 2 * C); ++k) {\n", 1),
    ("            if (sig) add_packed(comp, a, cp, p.min_t);\n",
     "            if (sig) add_packed(comp, a, cp, p.min_t);\n            comps_ += sig;\n", 1),
    ("            if (sig) {\n              al[cur][s] = a;\n",
     "            if (sig) {\n              ++moves_;\n              al[cur][s] = a;\n", 1),
    ("        pend_max = new_max;\n      }\n",
     "        pend_max = new_max;\n      }\n"
     "      if (fast) {\n        PE(kP_fast_composite);\n      } else {\n        PE(kP_walk);\n"
     "      }\n"
     "      pc[kP_sig_moves] += moves_;\n"
     "      pc[kP_sig_composited] += comps_;\n", 1),
    ("      if (multi) {\n        const bool was_fresh = fresh;\n",
     "      if (multi) {\n        PB();\n        pc[kP_copy_bytes] += at.valid ? 4ull * kF : 0ull;\n"
     "        const bool was_fresh = fresh;\n", 1),
    ("        fresh = was_fresh;\n      }\n",
     "        fresh = was_fresh;\n        PE(kP_copies);\n      }\n", 1),
    ("  // flush the pending buffer\n",
     "  // flush the pending buffer\n  PB();\n", 1),
    ("    store_ray(p, multi ? at : ti, acc_r + comp.r, acc_g + comp.g, acc_b + comp.b, T);\n"
     "  }\n",
     "    store_ray(p, multi ? at : ti, acc_r + comp.r, acc_g + comp.g, acc_b + comp.b, T);\n"
     "  }\n"
     "  PE(kP_flush);\n"
     "  if (threadIdx.x == 0 && kCl) pc[kP_barriers]++;\n"
     "  pc[kP_total] += (unsigned long long)(clock64() - pstart);\n"
     "  if (prof_out) {\n"
     "    unsigned long long* out = prof_out + (size_t)(blockIdx.x & %d) * kProf;\n"
     "    for (int q = 0; q < kProf; ++q) {\n"
     "      unsigned long long v = pc[q];\n"
     "      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);\n"
     "      if ((threadIdx.x & 31) == 0) atomicAdd(out + q, v);\n"
     "    }\n"
     "  }\n" % (SLOTS - 1), 1),
]


def instrument(src: Path, dst: Path) -> None:
    """Copy csrc/ `src` to `dst` with the merge kernel instrumented."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    text = (dst / "march.cuh").read_text()
    for anchor, new, times in PATCHES:
        found = text.count(anchor)
        if found != times:
            raise RuntimeError(f"march.cuh: {found} of {times} expected: {anchor[:60]!r}")
        text = text.replace(anchor, new)
    (dst / "march.cuh").write_text(text)


class _Steered:
    """A kernel library whose grt_march passes `prof` (an int64 tensor, or
    None) as its stats pointer and `variant` as its a_fire."""

    def __init__(self, lib):
        self._lib = lib
        self.prof = None
        self.variant = 0

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def grt_march(self, *a):
        a = list(a)
        a[31] = float(self.variant)
        a[33] = None if self.prof is None else self.prof.data_ptr()
        return self._lib.grt_march(*a)


def main() -> None:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("csrc", type=Path)
    ap.add_argument("out_json", type=Path, nargs="?", default=ROOT / "build" / "merge_step0.json")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("merge_step0.py needs a machine with a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig, chunk_for
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_pair_stream
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    src = opt.csrc.resolve()
    work = ROOT / "build" / "merge_step0"
    instrument(src, work / "csrc")
    own = cuda_build.load_library()
    ptxas_own = cuda_build.ptxas_table(cuda_build.build_log)
    built = cuda_build.build(work / "csrc", work / "kernels")
    ptxas_instr = cuda_build.ptxas_table(cuda_build.build_log)
    steered = _Steered(cuda_build.declare(__import__("ctypes").CDLL(str(built))))
    cs.log("build", f"{src} instrumented and built")

    radius = float(np.linalg.norm(cs.GOLDEN_EYE))
    pose = cameras.orbit_camera((0.0, 0.0, 0.0), radius, 0, 6.0, width=1280, height=720,
                                device=dev)
    scene = random_scene(100_000, seed=0, device=dev)
    bench = RenderConfig(**cs.BENCH_KW).replace(order="merge", bounce_order="merge")
    rows = []
    for tw, th, c in ((64, 32, 128), (64, 64, 128), (128, 64, 128), (64, 64, 64), (64, 64, 32),
                      (130, 64, 128), (128, 128, 128)):
        cfg = bench.replace(tile_w=tw, tile_h=th, march_chunk=c)
        stream, feats, _ = prepare_pair_stream(scene, pose, cfg, 1 << 21)
        dirs_t = tile_rays(cameras.generate_rays(pose, cfg)[1], tw, th)
        args = (stream.starts, feats, dirs_t, cfg, chunk_for(cfg))
        R = dirs_t.shape[1]
        multi = R > 8192
        call = lambda: kmarch.march(*args)

        # the sums, from one call of the instrumented copy (variant 0),
        # whose outputs must be the package's own kernels' bit for bit
        cuda_build._lib = own
        want = call()
        cuda_build._lib = steered
        steered.prof = torch.zeros((SLOTS, len(CYCLES) + len(COUNTS)), dtype=torch.int64,
                                   device=dev)
        steered.variant = 0
        got = call()
        torch.cuda.synchronize()
        cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"merge {tw}x{th} c={c}: the instrumented copy's outputs differ")
        sums = steered.prof.sum(0).tolist()
        steered.prof = None
        cyc = dict(zip(CYCLES, sums[:len(CYCLES)]))
        cnt = dict(zip(COUNTS, sums[len(CYCLES):]))

        # timings in turns: own, instrumented (variant 0), each variant
        names = ["own", "instrumented"] + [v for v in VARIANTS
                                             if multi or v in ("no_walk", "no_insertion")]
        ms = {k: [] for k in names}
        for _ in range(ROUNDS):
            for name in names:
                cuda_build._lib = own if name == "own" else steered
                steered.variant = VARIANTS.get(name, 0)
                call()
                ms[name] += cs.cuda_ms(call, REPS)
        cuda_build._lib = own
        steered.variant = 0
        med = {k: statistics.median(v) for k, v in ms.items()}
        total = max(1, cyc["total"])
        marched = max(1, cnt["marched"])
        row = dict(
            case=f"merge headline 720p/100k {tw}x{th} tiles c={c}", rays=R, chunk=c,
            rays_per_thread=-(-R // 8192), ms=med,
            removed_share={k: 1.0 - med[k] / med["instrumented"] for k in med
                           if k not in ("own", "instrumented")},
            instrumented_over_own=med["instrumented"] / med["own"],
            cycle_share={k: v / total for k, v in cyc.items() if k != "total"},
            counts=cnt,
            per_marched={k: cnt[k] / marched for k in ("evals", "evals_first", "shifts",
                                                        "walk_steps", "sig_moves",
                                                        "sig_composited", "copy_bytes")},
            slow_share=cnt["slow"] / marched,
            # (registers, stack, spill stores, spill loads) of the own build's
            # and the instrumented copy's kernel
            ptxas={k: next((v for n, v in t.items()
                            if f"18march_merge_kernelILi{c}ELi0ELi1ELi8192E" in n), None)
                   for k, t in (("own", ptxas_own), ("instrumented", ptxas_instr))},
        )
        rows.append(row)
        cs.log("step0", json.dumps(row) + f" ({card})")
    opt.out_json.parent.mkdir(parents=True, exist_ok=True)
    opt.out_json.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(json.dumps({"ok": True, "card": card}), flush=True)


if __name__ == "__main__":
    main()
