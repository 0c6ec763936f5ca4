// Kernel K3: hand-written backward of the fused march, key and window order
// (device code, shared by march_bwd.cu, the SH degree 0 entry point, and
// march_bwd_sh{1,2,3}.cu, the SH degree 1-3 instantiations).
//
// Replaces the Pallas kernel `_march_bwd_kernel` (wrapper `pallas_march_bwd`)
// of gaussian_ray_tracing_tpu/ops/pallas_march.py: key order (after K1's
// quad or scalar forward) and window order (after K1's scalar forward with
// the training sort key), a shared ray origin (the camera eye) or per-ray
// origins (kOrig), full [t_min, t_max] rays or per-ray windows, SH degree
// 0 to 3, any hit_multiplicity. The semantics are those of
// ops/march_bwd.py, whose plain torch version `march_bwd_plain` is the
// reference this kernel is tested against.
//
// Design: one block per tile, one thread per ray (R = blockDim.x: a 256-ray
// build, two blocks per SM, and a 1024-ray one, one block per SM at most 64
// registers a thread, for tiles of 288 to 1024 rays; kMaxR).
// Each tile's chunks of c candidates run last to first (c the forward's
// chunk, at most the build's capacity C: key order any c up to 256 on the
// smallest build that holds it, window order c = C), carrying dT per ray
// (initially d t_final). Per chunk:
//   1. skip replay: the block max of the saved carry-in t_in; at or below
//      min_transmittance the chunk's rows stay zero and dT is unchanged;
//   2. the chunk's rows are staged in shared memory as K1's scalar rows
//      (k1::Layout: op, mean, M, radius, the 3K SH coefficients), by
//      16-byte cp.async copies; where two buffers still leave room for two
//      blocks per SM (the 1024-ray build: for its one block; stages()),
//      chunk j-1's rows are copied while chunk j replays (the skips are
//      known from the saved carries);
//   3. key order, pass A: each ray evaluates every candidate once with the
//      operations of K1's eval_scalar; a miss (alpha at or below alpha_min)
//      stops at alpha, and a dead ray (an idle lane of a cluster too)
//      evaluates nothing. Its gate sets a bit of a register mask (C / 32
//      words, ceil(c / 32) of them used; a tail group of kGroup past c is
//      cut to the chunk); for a gated candidate the exclusive prefix of log1p(-a)
//      (summed sequentially, in the order the forward K1 summed it), P =
//      t_in exp(prefix), d_w, d_P, sum(d_P E) and the total D = sum(d_P P)
//      advance; the chunk's new dT follows;
//   3'. window order (the replay, pallas_march.py:1343-1425): pass A
//      evaluates every candidate once, with the operations K1 used (event
//      t, alpha, gate; a dead ray none), sets the mask bit of a
//      significant (a > 0) one and keeps its a, colour pack and order key
//      (the event t, or t* under window_key "peak", :1343-1360) in compact
//      local lists, in stream order (12 bytes per significant candidate,
//      none for a miss),
//      and repeats K1's tile-wide fire test; a fired chunk sorts its
//      significant candidates by the unique key (tq16 << 8) | k, the compact
//      index k in place of src (the same order: both ascend with the
//      stream), tq16 from the same true division, in a per-thread insertion
//      list (the TPU's bitonic network is layout and is not ported: a
//      unique key makes any correct sort the same permutation), an unfired
//      one keeps stream order. Two sweeps over that list, with the 10-bit
//      colours in d_w (straight-through, as the reference does even in
//      unfired chunks), give the chunk's dT and then each entry's d_a and w,
//      written back to its compact slot (the reference's inverse
//      permutation, :1419-1425);
//   4. per-candidate sums over the tile's rays of 14 + 3K terms per (ray,
//      candidate): opacity, d_oo, 3 d_od d_g, 9 d_dg d and the colour terms
//      (per-ray origins, where o_g and oo are per (ray, candidate) and d_og
//      per ray: opacity, an unused slot, the 3 terms M^T d_og of the mean
//      and the 9 terms d_dg d + d_og (o - mu) of M, pallas_march.py
//      :1481-1501, and the colour terms). The colour terms: (SH 0: 3 dR w, times C0 and the colour mask after the sum; SH 1-3:
//      3K dR w [colour > 0] basis_k, the mask from the exact colours,
//      pallas_march.py:1448-1461), kGroup = 16 candidates at a time. A warp
//      in which no lane's mask bit is set writes zero partials without
//      evaluating; otherwise the lanes with the bit evaluate the candidate a
//      second time (key order: with pass B's running prefix and d_a; window
//      order: d_a and w from the compact slot) and the warp's 32 x
//      ceil((14 + 3K) / 32) terms go through a transposed ray reduction, a
//      reduce-scatter butterfly (31 shuffles per 32 terms; lane l ends with
//      term l), stored by all lanes at once. All threads of the block then
//      add the warps in order, one (candidate, term) each, and one thread
//      per candidate finishes the shared-origin d_og / d_m / d_mean algebra
//      (per-ray origins: writes the sums, the means' negated).
//      Every sum runs in a fixed order (the butterfly's pairs are a
//      shuffle-down tree's), so two launches give bit-identical gradients.
//      The partials take 8 warps x 16 x 64 floats (32 KB at SH 3) beside
//      the staged rows: at SH 3 key order (c = 256) takes 100 KB and window
//      order (c = 128, two buffers) 100 KB, two blocks per SM. The 1024-ray
//      build keeps the same sums in the same order over 32 warps: 128 KB
//      of partials at SH 3, with one staging buffer at c = 256 (196 KB of
//      the 227 KB a block may take). A tile of more than 1024 rays (a
//      multiple of 128) is a thread-block cluster of blocks of
//      up to 1024 rays (k1::cluster_blocks, k1::cluster_width; the cluster
//      build): each block sums its warps in warp order, in double, into one
//      of two exchange slots (16 KB at SH 3), and after one cluster barrier
//      the block that writes candidate gi (gi % n) adds the n blocks'
//      slots in rank order through distributed shared memory, in double,
//      and rounds once to float; no atomics, so launches stay bit-identical. The skip replay and the window fire
//      test and key range are tile-wide (k1::tile_reduce). Above 8192 rays
//      (the same cluster build, `multi` at run time) each thread replays
//      k1::cluster_slots(R) rays in turn, one ray's
//      lists at a time (window order: each slot's list built once for the
//      tile's fire test and once more past it), its dT in device memory
//      between its turns (Params::carry): each block sums its warps of each
//      slot in double and adds them in slot order to its sums in device
//      memory (Params::acc), and once every slot is in, after one cluster
//      barrier, the block that writes candidate i (i % n) adds the n
//      blocks' sums in rank order, in double, and rounds once to float.
// Each stream row belongs to one (tile, chunk): a block writes only rows
// [starts[t], starts[t+1]) of its own tile (the TPU kernel's write-then-
// overwrite of a tail chunk's overshoot rows relies on sequential grid
// steps, a race between concurrent CUDA blocks). The wrapper zero-fills
// the output, so skipped chunks, the quad and radius columns and rows no
// tile owns are zero. No global float atomics.
//
// What bounds it on an H100: per-(ray, candidate) float32 math, not
// memory (each row is read once per tile): one evaluation of every
// candidate, a second one of the gated candidates (of every candidate of a
// warp with one gated lane), with one exp, one log1p, one sqrt and three
// divides each and at SH 1-3 the colour, plus the reduction (31 shuffles
// per 32 terms and warp, for the candidates a warp has gated); window order
// adds its compact lists in local memory (12 bytes per significant
// candidate) and the insertion sort in fired chunks. Registers and
// occupancy are in PERF.md. The float rules are K1's: IEEE float32, no FMA
// contraction (-fmad=false), true divisions where JAX divides, no tensor
// cores, no TF32.

#pragma once

#include "march.cuh"

namespace k3 {

using k1::kC0;
constexpr int kGroup = 16;    // candidates per reduction group
constexpr int kBwdMaxSmem = 227 * 1024 - 128;  // a block's, less the static red[32]
// the staged rows are K1's scalar rows (k1::Layout): op 0, mean kMean,
// M kMat, radius kRad, SH coefficients from Layout::col
using k1::kMat;
using k1::kMean;
using k1::kRad;
// training-row columns K3 writes
enum { kGOp = 0, kGMx = 16, kGM0 = 19, kGSh = 29 };

template <int K>
using Staged = k1::Layout<true, K, true>;
// reduced terms per (ray, candidate): opacity, d_oo, 3 d_od d_g, 9 d_dg d
// and the colour terms (3 at SH 0, 3K above), in rounds of 32 (one per lane)
template <int K>
__host__ __device__ constexpr int terms() {
  return 14 + 3 * K;
}
template <int K>
__host__ __device__ constexpr int rounds() {
  return (terms<K>() + 31) / 32;
}
// Staging buffers: two (chunk j-1's rows copied while chunk j replays)
// where two blocks of 8 warps still fit on an SM (the 256-ray build) or
// one block of 32 warps fits (the 1024-ray build), else one.
// A cluster build (kMaxR = k1::kClusterR, blocks of up to 1024 rays)
// stages as the 1024-ray build, beside its two exchange slots of a group's
// sums in double (xs_floats: floats of room).
template <int K, int kMaxR>
__host__ __device__ constexpr int xs_floats() {
  return kMaxR >= k1::kClusterR ? 2 * 2 * kGroup * 32 * rounds<K>() : 0;
}
template <int C, int K, int kMaxR>
__host__ __device__ constexpr int stages() {
  return (2 * C * Staged<K>::w + (kMaxR < 1024 ? kMaxR : 1024) / 32 * kGroup * 32 * rounds<K>() +
          xs_floats<K, kMaxR>()) * 4 <=
                 (kMaxR == 256 ? 113 * 1024 : kBwdMaxSmem)
             ? 2
             : 1;
}
template <int C, int K, int kMaxR>
__host__ __device__ constexpr int smem_floats(int n_warps) {
  return stages<C, K, kMaxR>() * C * Staged<K>::w + n_warps * kGroup * 32 * rounds<K>() +
         xs_floats<K, kMaxR>();
}

struct Params {
  const int* starts;      // (T+1,)
  const int* chunk_base;  // (T+1,)
  const float* rows;      // (P, stride) training rows
  const float* dirs;      // (T, R, 3)
  const float* eye;       // (3,)
  const float* tin;       // (sum of chunks, R)
  const float* d_rgb;     // (T, R, 3)
  const float* d_tfinal;  // (T, R)
  float* d_rows;          // (P, stride), zero-filled by the wrapper
  const float* origins;   // (T, R, 3) per-ray origins, or null: the eye
  const float* t_lo_arr;  // (T, R) per-ray window start, or null: t_lo
  const float* t_hi_arr;  // (T, R) per-ray window end, or null: t_hi
  int stride;
  float t_lo, t_hi, min_t, alpha_min, alpha_clamp;
  int hm;
  int peak;               // window_key "peak": the window replay's order key is t*
  int R;                  // rays per tile (the cluster builds' tile; blockDim.x up to 1024)
  int chunk;              // candidates a chunk, c <= C (window order: C)
  // several rays a thread (k1::cluster_slots(R) > 1), else null: each
  // block's sums over its slots' rays, (scratch_tiles, blocks, C, TP)
  // doubles, and each ray's dT between its turns, (scratch_tiles, 1, R)
  // floats (scratch_bytes), from the launch's first tile
  double* acc;
  float* carry;
  int scratch_tiles, tile0;  // as k1::Params'
};

// Bytes of grt_march_bwd's scratch (Params::acc, then Params::carry) at
// capacity C and SH coefficient count K for n_tiles tiles of R rays: none
// where each thread replays one ray.
template <int K>
inline size_t scratch_bytes(int C, int R, int n_tiles) {
  if (k1::cluster_slots(R) < 2) return 0;
  return (size_t)n_tiles * (k1::cluster_blocks(R) * (size_t)C * 32 * rounds<K>() * sizeof(double) +
                            (size_t)R * sizeof(float));
}


__device__ __forceinline__ float ipow(float x, int k) {
  float r = x;
  for (int i = 1; i < k; ++i) r *= x;
  return r;
}

// Candidate-level (per row, not per ray) values; with a shared origin
// also o - mu, o_g and oo.
struct Cand {
  float mx, my, mz, ox, oy, oz, ogx, ogy, ogz, oo, m[9], op, rad;
  const float* sh;  // sh_r[K], sh_g[K], sh_b[K] in shared memory
};

template <int K, bool kOrig>
__device__ __forceinline__ Cand load_cand(const float* f, const float* eye) {
  Cand c;
  c.mx = f[kMean];
  c.my = f[kMean + 1];
  c.mz = f[kMean + 2];
  for (int k = 0; k < 9; ++k) c.m[k] = f[kMat + k];
  if (!kOrig) {
    c.ox = eye[0] - c.mx;
    c.oy = eye[1] - c.my;
    c.oz = eye[2] - c.mz;
    c.ogx = c.m[0] * c.ox + c.m[1] * c.oy + c.m[2] * c.oz;
    c.ogy = c.m[3] * c.ox + c.m[4] * c.oy + c.m[5] * c.oz;
    c.ogz = c.m[6] * c.ox + c.m[7] * c.oy + c.m[8] * c.oz;
    c.oo = c.ogx * c.ogx + c.ogy * c.ogy + c.ogz * c.ogz;
  }
  c.op = f[0];
  c.rad = f[kRad];
  c.sh = f + Staged<K>::col;
  return c;
}

// Unclamped colour of channel ch for the ray whose SH basis is `basis`:
// 0.5 + C0 sh0 at SH 0, else 0.5 + sum_k basis_k sh_k added in turn (the
// forward's colour before its max(., 0)).
template <int K>
__device__ __forceinline__ float raw_color(const Cand& c, int ch, const float* basis) {
  if (K == 1) return 0.5f + kC0 * c.sh[ch];
  const float* co = c.sh + ch * K;
  float acc = 0.5f + basis[0] * co[0];
#pragma unroll
  for (int k = 1; k < K; ++k) acc = acc + basis[k] * co[k];
  return acc;
}

template <int K>
__device__ __forceinline__ uint32_t color_pack(const Cand& c, const float* basis) {
  return k1::pack_color(fmaxf(raw_color<K>(c, 0, basis), 0.f),
                        fmaxf(raw_color<K>(c, 1, basis), 0.f),
                        fmaxf(raw_color<K>(c, 2, basis), 0.f));
}

__device__ __forceinline__ float packed_dot(const float* dR, uint32_t cp) {
  return dR[0] * ((float)((cp >> 20) & 1023u) * k1::kInvCol) +
         dR[1] * ((float)((cp >> 10) & 1023u) * k1::kInvCol) +
         dR[2] * ((float)(cp & 1023u) * k1::kInvCol);
}

// The ray of a thread: direction, liveness, window and (kOrig) origin.
struct RayB {
  float dx, dy, dz, ox, oy, oz, t_lo, t_hi;
  bool live;
};

// Per-(ray, candidate) forward recompute, scalar form (pallas_march.py:1291-1331),
// with the operations of K1's eval_scalar (csrc/march.cuh), so that the
// window replay sees K1's event t, t* and alpha bit for bit. As there, alpha
// comes first and a miss (alpha at or below alpha_min, or a dead ray) stops
// with the gate closed, a = 0 and t_ev 0, which nothing reads. The gate is
// the event gate under either order key (JAX's backward has no fast gate,
// pallas_march.py:1290-1340). kOrig: o - mu, o_g and oo from the ray's own
// origin (per pair), else the candidate's.
struct Eval {
  float ox, oy, oz, ogx, ogy, ogz, dgx, dgy, dgz, od, dd_s, pp, resp, alpha, a, t_ev, t_star;
  bool gate;
};

template <bool kOrig>
__device__ __forceinline__ Eval evaluate(const Params& p, const Cand& c, const RayB& r) {
  Eval e;
  float oo;
  if (kOrig) {
    e.ox = r.ox - c.mx;
    e.oy = r.oy - c.my;
    e.oz = r.oz - c.mz;
    e.ogx = c.m[0] * e.ox + c.m[1] * e.oy + c.m[2] * e.oz;
    e.ogy = c.m[3] * e.ox + c.m[4] * e.oy + c.m[5] * e.oz;
    e.ogz = c.m[6] * e.ox + c.m[7] * e.oy + c.m[8] * e.oz;
    oo = e.ogx * e.ogx + e.ogy * e.ogy + e.ogz * e.ogz;
  } else {
    e.ox = c.ox;
    e.oy = c.oy;
    e.oz = c.oz;
    e.ogx = c.ogx;
    e.ogy = c.ogy;
    e.ogz = c.ogz;
    oo = c.oo;
  }
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  e.dgx = c.m[0] * dx + c.m[1] * dy + c.m[2] * dz;
  e.dgy = c.m[3] * dx + c.m[4] * dy + c.m[5] * dz;
  e.dgz = c.m[6] * dx + c.m[7] * dy + c.m[8] * dz;
  const float dd = e.dgx * e.dgx + e.dgy * e.dgy + e.dgz * e.dgz;
  e.od = e.ogx * e.dgx + e.ogy * e.dgy + e.ogz * e.dgz;
  e.dd_s = fmaxf(dd, 1e-6f);
  const float t_star = -e.od / e.dd_s;
  e.t_star = t_star;
  e.pp = oo + t_star * (2.f * e.od + t_star * dd);
  e.resp = expf(-0.5f * fmaxf(e.pp, 0.f));
  e.alpha = fminf(p.alpha_clamp, e.resp * c.op);
  e.gate = false;
  e.a = 0.f;
  e.t_ev = 0.f;
  if (!(r.live && e.alpha > p.alpha_min)) return e;
  const float cq = oo - c.rad * c.rad;
  const float disc = e.od * e.od - dd * cq;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float inv_dd = 1.f / fmaxf(dd, 1e-12f);
  const float t_entry = (-e.od - sq) * inv_dd;
  const float t_exit = (-e.od + sq) * inv_dd;
  e.t_ev = t_entry < r.t_lo ? t_exit : t_entry;
  e.gate = disc >= 0.f && e.t_ev >= r.t_lo && e.t_ev <= r.t_hi;
  const float a_eff = p.hm == 1 ? e.alpha : 1.f - ipow(1.f - e.alpha, p.hm);
  e.a = e.gate ? a_eff : 0.f;
  return e;
}

// Reduce-scatter across the warp: lane l returns the sum over the 32
// lanes of v[l]. Each step trades half of the values a lane still holds
// with the lane H away, 16 + 8 + 4 + 2 + 1 = 31 shuffles for 32 terms;
// every sum runs in a fixed order (the pairs of a shuffle-down tree).
// A template per step, so that every index into v is a constant and v
// stays in registers.
template <int H>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? v[k] : v[k + H];
    const float keep = up ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) transpose_step<H / 2>(v, lane);
}

__device__ __forceinline__ float warp_transpose_sum(float (&v)[32]) {
  transpose_step<16>(v, threadIdx.x & 31);
  return v[0];
}

// A chunk's gate mask (bit b of word w: candidate 32 w + b) lives in
// registers: the loops index it with constants only, shifting word 0 out
// as they go.
template <int NW>
__device__ __forceinline__ void push_word(uint32_t (&mask)[NW], uint32_t bits) {
#pragma unroll
  for (int k = 0; k < NW - 1; ++k) mask[k] = mask[k + 1];
  mask[NW - 1] = bits;
}

// Start the copy of rows [row0, row0 + m) into sf (K1's scalar staging
// runs, 16-byte cp.async copies) and commit it as one group.
template <int K>
__device__ __forceinline__ void stage_async(float* sf, const Params& p, size_t row0, int m) {
  using L = Staged<K>;
  constexpr int G = L::w / 4, GA = L::a / 4;
  for (int k = threadIdx.x; k < m * G; k += blockDim.x) {
    const int r = k / G, q = k - r * G;
    const float* g = p.rows + (row0 + r) * p.stride;
    k1::cp_async16(sf + r * L::w + 4 * q, g + (q < GA ? 4 * q : L::b + 4 * (q - GA)));
  }
  k1::cp_async_commit();
}

// C is the build's chunk capacity: the chunk is p.chunk = c <= C (key
// order: any c up to 256, on the smallest build with C >= c; window order
// c = C), so a chunk's mask fits in C / 32 words and its rows in a buffer.
// The gradient row of candidate f (its staged row) from its sums over the
// tile's rays r[terms]: opacity, the M columns through the shared-origin
// d_og / d_m / d_mean algebra (per-ray origins: the sums, the means'
// negated) and the SH coefficients, into d_rows' row `row`.
template <int K, bool kOrig>
__device__ __forceinline__ void finish(const Params& p, const float* f, const float* r,
                                       size_t row) {
  const Cand c = load_cand<K, kOrig>(f, p.eye);
  float* out = p.d_rows + row * p.stride;
  out[kGOp] = r[0];
  if (kOrig) {  // the sums over the rays are the gradients; means: o - mu
    for (int k = 0; k < 9; ++k) out[kGM0 + k] = r[5 + k];
    for (int k = 0; k < 3; ++k) out[kGMx + k] = -r[2 + k];
  } else {
    const float d_oo = r[1];
    const float d_ogx = r[2] + 2.f * c.ogx * d_oo;
    const float d_ogy = r[3] + 2.f * c.ogy * d_oo;
    const float d_ogz = r[4] + 2.f * c.ogz * d_oo;
    out[kGM0 + 0] = r[5] + d_ogx * c.ox;
    out[kGM0 + 1] = r[6] + d_ogx * c.oy;
    out[kGM0 + 2] = r[7] + d_ogx * c.oz;
    out[kGM0 + 3] = r[8] + d_ogy * c.ox;
    out[kGM0 + 4] = r[9] + d_ogy * c.oy;
    out[kGM0 + 5] = r[10] + d_ogy * c.oz;
    out[kGM0 + 6] = r[11] + d_ogz * c.ox;
    out[kGM0 + 7] = r[12] + d_ogz * c.oy;
    out[kGM0 + 8] = r[13] + d_ogz * c.oz;
    // means: ox = eye_x - mx
    out[kGMx + 0] = -(c.m[0] * d_ogx + c.m[3] * d_ogy + c.m[6] * d_ogz);
    out[kGMx + 1] = -(c.m[1] * d_ogx + c.m[4] * d_ogy + c.m[7] * d_ogz);
    out[kGMx + 2] = -(c.m[2] * d_ogx + c.m[5] * d_ogy + c.m[8] * d_ogz);
  }
  if (K == 1) {
    for (int ch = 0; ch < 3; ++ch)
      out[kGSh + ch] = kC0 * (r[14 + ch] * (raw_color<1>(c, ch, nullptr) > 0.f ? 1.f : 0.f));
  } else {
    for (int k = 0; k < 3 * K; ++k) out[kGSh + k] = r[14 + k];
  }
}

template <int C, int K, bool kWindow, bool kOrig, int kMaxR>
__global__ void __launch_bounds__(kMaxR == 256 ? 256 : 1024, kMaxR == 256 ? 2 : 1)
    march_bwd_kernel(Params p) {
  constexpr int kS = Staged<K>::w;  // staged floats per candidate
  constexpr int NR = rounds<K>(), TP = 32 * NR, NW = C / 32;
  constexpr int kStages = stages<C, K, kMaxR>();
  constexpr bool kCl = kMaxR >= k1::kClusterR;
  extern __shared__ __align__(16) float smem[];
  float* part = smem + kStages * C * kS;  // n_warps x kGroup x TP partial sums
  __shared__ float red[kCl ? k1::kClusterRed : 32];

  const k1::TileIdx ti = k1::tile_index<kCl>(p);
  const int tile = ti.tile, R = ti.R, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  // several rays a thread (more than 8192 rays a tile, cluster builds):
  // each slot's ray in turn, its dT in p.carry between its turns; the
  // block's sums over its slots' rays in double in p.acc (this block's C x
  // TP of its tile)
  const bool multi = kCl && ti.slots > 1;
  const int slots = multi ? ti.slots : 1;
  // a cluster's two exchange slots of a group's sums (double), after the
  // partials (an offset of whole groups of 512 floats: 8-byte aligned)
  double* xs = reinterpret_cast<double*>(part + (size_t)n_warps * kGroup * TP);
  int par = 0, xpar = 0;  // the cluster builds' exchange slots (red's, xs's)
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;
  const int c = p.chunk;
  const int n_chunks = (n + c - 1) / c;

  // the current ray (an idle lane of a cluster: a dead ray with no gradient
  // and no carry): direction, window, origin, d_rgb, SH basis and, carried
  // between chunks, dT; take() makes slot s's ray current
  k1::TileIdx at = ti;
  bool ok;
  float dx, dy, dz, dR[3], dT;
  RayB rb;
  float basis[K];
  auto take = [&](int s, bool grad) {
    at = ti.slot(s);
    ok = at.valid;
    const size_t ray = at.idx();
    dx = ok ? p.dirs[ray * 3 + 0] : 0.f;
    dy = ok ? p.dirs[ray * 3 + 1] : 0.f;
    dz = ok ? p.dirs[ray * 3 + 2] : 0.f;
    const bool live = dx * dx + dy * dy + dz * dz > 0.01f;
    rb = RayB{dx, dy, dz, 0.f, 0.f, 0.f, p.t_lo_arr && ok ? p.t_lo_arr[ray] : p.t_lo,
              p.t_hi_arr && ok ? p.t_hi_arr[ray] : p.t_hi, live};
    if (kOrig && ok) {
      rb.ox = p.origins[ray * 3 + 0];
      rb.oy = p.origins[ray * 3 + 1];
      rb.oz = p.origins[ray * 3 + 2];
    }
    if (K > 1) k1::sh_basis<K>(dx, dy, dz, basis);
    if (!grad) return;
    for (int ch = 0; ch < 3; ++ch) dR[ch] = ok ? p.d_rgb[ray * 3 + ch] : 0.f;
    dT = ok ? (multi ? k1::carried(p, at, 1, 0) : p.d_tfinal[ray]) : 0.f;
  };
  if (multi)
    for (int s = 0; s < slots; ++s) {
      const k1::TileIdx t = ti.slot(s);
      if (t.valid) k1::carried(p, t, 1, 0) = p.d_tfinal[t.idx()];
    }
  take(0, true);
  const float* tin = p.tin + (size_t)p.chunk_base[tile] * R;  // + j R + ray
  // several slots: this block's C x TP sums of its tile in p.acc
  // ((scratch_tiles, blocks, C, TP) doubles from the launch's first tile)
  double* acc = nullptr;
  if constexpr (kCl)
    if (multi) {
      const k1::cg::cluster_group cl = k1::cg::this_cluster();
      acc = p.acc + ((size_t)(tile - p.tile0) * cl.num_blocks() + cl.block_rank()) * C * TP;
    }
  // window replay, per SIGNIFICANT candidate in stream order (compact
  // index): a then d_a, the colour pack then w, and the listed order
  // (event t bits, then the sort keys); local memory, touched only by the
  // significant candidates (one ray's at a time)
  float ca[kWindow ? C : 1];
  uint32_t cc[kWindow ? C : 1], keys[kWindow ? C : 1];
  int ns = 0;
  bool inv = false;
  float lo = INFINITY, hi = -INFINITY;
  uint32_t mask[NW];

  int staged = -1;  // the chunk whose rows are in flight to its buffer
  for (int j = n_chunks - 1; j >= 0; --j) {
    float t_in = ok ? tin[(size_t)j * R + at.ray] : 0.f, t_max = t_in;
    if (multi) {
      t_max = 0.f;
      for (int s = 0; s < slots; ++s) {
        const k1::TileIdx t = ti.slot(s);
        if (t.valid) t_max = fmaxf(t_max, tin[(size_t)j * R + t.ray]);
      }
    }
    // skip replay (its barrier also ends the previous chunk's reads)
    if (k1::tile_reduce1<kCl>(t_max, true, red, par) <= p.min_t) {
      if (staged == j) {  // T never rises, so this does not happen; but never
        k1::cp_async_wait<0>();  // leave a copy in flight to a buffer in use
        staged = -1;
      }
      continue;
    }
    const int m = min(c, n - j * c);
    const size_t row0 = (size_t)start + (size_t)j * c;
    float* sf = smem + (kStages == 2 ? (j & 1) * C * kS : 0);
    if (staged != j) stage_async<K>(sf, p, row0, m);
    if (kStages == 2 && j > 0) {  // chunk j-1 into the other buffer
      stage_async<K>(smem + ((j - 1) & 1) * C * kS, p, row0 - c, c);
      staged = j - 1;
      k1::cp_async_wait<1>();
    } else {
      k1::cp_async_wait<0>();
    }
    __syncthreads();

    // window order: the current ray's significant candidates of the chunk
    // in its compact lists, its inversion test and key range, and its gate
    // mask (a > 0); a dead ray (an idle lane) has none, so it evaluates
    // nothing (its evaluations would stop at alpha)
    auto listing = [&]() {
      inv = false;
      float rmax = -INFINITY;
      lo = INFINITY;
      hi = -INFINITY;
      ns = 0;
      if (!rb.live) {
#pragma unroll
        for (int w = 0; w < NW; ++w) mask[w] = 0u;
        return;
      }
#pragma unroll 1
      for (int w = 0; w < NW; ++w) {
        uint32_t bits = 0u;
        const int i0 = w * 32, e_end = min(32, m - i0);
        for (int b = 0; b < e_end; ++b) {
          const Cand cd = load_cand<K, kOrig>(sf + (i0 + b) * kS, p.eye);
          const Eval e = evaluate<kOrig>(p, cd, rb);
          if (!(e.a > 0.f)) continue;
          const float t_key = p.peak ? e.t_star : e.t_ev;  // the forward's order key
          bits |= 1u << b;
          inv |= t_key < rmax;
          rmax = fmaxf(rmax, t_key);
          lo = fminf(lo, t_key);
          hi = fmaxf(hi, t_key);
          ca[ns] = e.a;
          cc[ns] = color_pack<K>(cd, basis);
          keys[ns++] = __float_as_uint(t_key);
        }
        push_word(mask, bits);
      }
    };
    // ---- window order: K1's fire test over the tile, every slot's list
    // folded (several slots: the lists built again past the vote) ----
    bool fired = false;
    float glo = INFINITY, ghi = -INFINITY;
    if (kWindow) {
      bool t_inv = false;
      for (int s = 0; s < slots; ++s) {
        if (multi) take(s, false);
        listing();
        t_inv |= inv;
        glo = fminf(glo, lo);
        ghi = fmaxf(ghi, hi);
      }
      if constexpr (kCl) {  // the vote and the key range in one exchange
        float v[3] = {t_inv ? 1.f : 0.f, glo, ghi};
        const bool mx[3] = {true, false, true};
        k1::tile_reduce<kCl>(v, mx, red, par);
        fired = v[0] != 0.f;
        glo = v[1];
        ghi = v[2];
      } else {
        fired = __syncthreads_or(t_inv);
        if (fired) {
          glo = k1::block_reduce(glo, false, red);
          ghi = k1::block_reduce(ghi, true, red);
        }
      }
    }

    for (int sl = 0; sl < slots; ++sl) {
      if (multi) {
        take(sl, true);
        t_in = ok ? tin[(size_t)j * R + at.ray] : 0.f;
        if (kWindow) listing();
      }
      // ---- pass A: every candidate once (a miss stops at alpha; a dead
      // ray or an idle lane evaluates none); the gate mask (window: a > 0),
      // and in key order the prefix, P, d_P and the chunk's dT ----
      float base = 0.f, D = 0.f;
      if (kWindow) {
        // ---- the listed order: a fired chunk sorts by the unique key
        // (tq16 << 8) | src, here with the compact index in place of src
        // (the same order: both ascend with the stream) ----
        if (fired) {
          const float scale = 65534.f / fmaxf(ghi - glo, 1e-20f);
          for (int k = 0; k < ns; ++k) {
            const float t_ev = __uint_as_float(keys[k]);  // read before the list grows to k
            const uint32_t tq = (uint32_t)fminf(fmaxf((t_ev - glo) * scale, 0.f), 65534.f);
            const uint32_t key = (tq << 8) | (uint32_t)k;
            int pos = k;
            while (pos > 0 && keys[pos - 1] > key) {
              keys[pos] = keys[pos - 1];
              --pos;
            }
            keys[pos] = key;
          }
        }
        // ---- pass A over the list: prefix, P, d_P; the chunk's dT ----
        float S = 0.f, sum_dpe = 0.f;
        for (int k = 0; k < ns; ++k) {
          const int r = fired ? (int)(keys[k] & 255u) : k;
          const float a = ca[r];
          const float d_w = packed_dot(dR, cc[r]);
          const float E = expf(S);
          const float P = t_in * E;
          const float gw = P > p.min_t ? 1.f : 0.f;
          const float d_P = d_w * a * gw;
          sum_dpe += d_P * E;
          D += d_P * P;
          S += log1pf(-a);
        }
        const float prod = expf(S);
        base = dT * t_in * prod;  // d_lp's carry term, from the OLD dT
        dT = dT * prod + sum_dpe;
        // ---- pass B over the list: d_a and w, back to the compact slot ----
        S = 0.f;
        float incl = 0.f;
        for (int k = 0; k < ns; ++k) {
          const int r = fired ? (int)(keys[k] & 255u) : k;
          const float a = ca[r];
          const float d_w = packed_dot(dR, cc[r]);
          const float E = expf(S);
          const float P = t_in * E;
          const float gw = P > p.min_t ? 1.f : 0.f;
          const float d_P = d_w * a * gw;
          incl += d_P * P;
          const float d_lp = base + (D - incl);  // strict suffix sum of d_P P
          ca[r] = d_w * P * gw - d_lp / (1.f - a);
          cc[r] = __float_as_uint(a * P * gw);
          S += log1pf(-a);
        }
      } else {
        float S = 0.f, sum_dpe = 0.f;
        if (rb.live) {
#pragma unroll 1
          for (int w = 0; w < NW; ++w) {
            uint32_t bits = 0u;
            const int i0 = w * 32, e_end = min(32, m - i0);
            for (int b = 0; b < e_end; ++b) {
              const Cand cd = load_cand<K, kOrig>(sf + (i0 + b) * kS, p.eye);
              const Eval e = evaluate<kOrig>(p, cd, rb);
              if (!e.gate) continue;  // a = 0: no term of the sums moves
              bits |= 1u << b;
              const float E = expf(S);
              const float P = t_in * E;
              const float gw = P > p.min_t ? 1.f : 0.f;
              float d_w = 0.f;
              for (int ch = 0; ch < 3; ++ch)
                d_w = d_w + dR[ch] * fmaxf(raw_color<K>(cd, ch, basis), 0.f);
              const float d_P = d_w * e.a * gw;
              sum_dpe += d_P * E;
              D += d_P * P;
              S += log1pf(-e.a);
            }
            push_word(mask, bits);
          }
        } else {
#pragma unroll
          for (int w = 0; w < NW; ++w) mask[w] = 0u;
        }
        const float prod = expf(S);
        base = dT * t_in * prod;
        dT = dT * prod + sum_dpe;
      }
      if (multi && ok) k1::carried(p, at, 1, 0) = dT;

      // ---- pass B (key) / C (window): the per-candidate sums over the
      // rays, kGroup candidates at a time; a warp where no lane's bit is set
      // writes zeros without evaluating ----
      float S = 0.f, incl = 0.f;
      int r_next = 0;  // window: compact index of this ray's next significant candidate
      uint32_t cur = 0u;
      for (int g0 = 0; g0 < m; g0 += kGroup) {
        const int gn = min(kGroup, m - g0);
        for (int gi = 0; gi < gn; ++gi) {
          const int i = g0 + gi;
          if ((i & 31) == 0) {
            cur = mask[0];
            push_word(mask, 0u);
          }
          const bool bit = (cur >> (i & 31)) & 1u;
          float* dst = part + ((size_t)warp * kGroup + gi) * TP;
          if (!__any_sync(0xffffffffu, bit)) {  // every term of this warp is zero
#pragma unroll
            for (int rr = 0; rr < NR; ++rr) dst[32 * rr + lane] = 0.f;
            continue;
          }
          float g[14], dcm[3];
#pragma unroll
          for (int k = 0; k < 14; ++k) g[k] = 0.f;
          dcm[0] = dcm[1] = dcm[2] = 0.f;
          if (bit) {
            const Cand cd = load_cand<K, kOrig>(sf + i * kS, p.eye);
            const Eval e = evaluate<kOrig>(p, cd, rb);
            float d_a, w;
            if (kWindow) {
              d_a = ca[r_next];
              w = __uint_as_float(cc[r_next]);
              ++r_next;
            } else {
              const float E = expf(S);
              const float P = t_in * E;
              const float gw = P > p.min_t ? 1.f : 0.f;
              float d_w = 0.f;
              for (int ch = 0; ch < 3; ++ch)
                d_w = d_w + dR[ch] * fmaxf(raw_color<K>(cd, ch, basis), 0.f);
              const float d_P = d_w * e.a * gw;
              incl += d_P * P;
              S += log1pf(-e.a);
              w = e.a * P * gw;
              const float d_lp = base + (D - incl);  // strict suffix sum of d_P P
              d_a = d_w * P * gw - d_lp / (1.f - e.a);
            }
            const float d_alpha = p.hm == 1 ? d_a : d_a * p.hm * ipow(1.f - e.alpha, p.hm - 1);
            const float notclamp = e.resp * cd.op < p.alpha_clamp ? 1.f : 0.f;
            const float d_resp = d_alpha * cd.op * notclamp;
            const float d_pp = -0.5f * e.resp * d_resp * (e.pp > 0.f ? 1.f : 0.f);
            const float d_od = d_pp * (-2.f * e.od / e.dd_s);
            const float d_dd = d_pp * (e.od * e.od / (e.dd_s * e.dd_s));
            const float d_dgx = d_od * e.ogx + 2.f * e.dgx * d_dd;
            const float d_dgy = d_od * e.ogy + 2.f * e.dgy * d_dd;
            const float d_dgz = d_od * e.ogz + 2.f * e.dgz * d_dd;
            g[0] = d_alpha * e.resp * notclamp;
            if (kOrig) {
              // o_g and oo are per ray: d_og stays per ray and every term of
              // the M and mean gradients is summed over the rays
              // (pallas_march.py:1481-1501); slot 1 is unused
              const float d_ogx = d_od * e.dgx + 2.f * e.ogx * d_pp;
              const float d_ogy = d_od * e.dgy + 2.f * e.ogy * d_pp;
              const float d_ogz = d_od * e.dgz + 2.f * e.ogz * d_pp;
              g[1] = 0.f;
              g[2] = cd.m[0] * d_ogx + cd.m[3] * d_ogy + cd.m[6] * d_ogz;
              g[3] = cd.m[1] * d_ogx + cd.m[4] * d_ogy + cd.m[7] * d_ogz;
              g[4] = cd.m[2] * d_ogx + cd.m[5] * d_ogy + cd.m[8] * d_ogz;
              g[5] = d_dgx * dx + d_ogx * e.ox;
              g[6] = d_dgx * dy + d_ogx * e.oy;
              g[7] = d_dgx * dz + d_ogx * e.oz;
              g[8] = d_dgy * dx + d_ogy * e.ox;
              g[9] = d_dgy * dy + d_ogy * e.oy;
              g[10] = d_dgy * dz + d_ogy * e.oz;
              g[11] = d_dgz * dx + d_ogz * e.ox;
              g[12] = d_dgz * dy + d_ogz * e.oy;
              g[13] = d_dgz * dz + d_ogz * e.oz;
            } else {
              g[1] = d_pp;
              g[2] = d_od * e.dgx;
              g[3] = d_od * e.dgy;
              g[4] = d_od * e.dgz;
              g[5] = d_dgx * dx;
              g[6] = d_dgx * dy;
              g[7] = d_dgx * dz;
              g[8] = d_dgy * dx;
              g[9] = d_dgy * dy;
              g[10] = d_dgy * dz;
              g[11] = d_dgz * dx;
              g[12] = d_dgz * dy;
              g[13] = d_dgz * dz;
            }
            for (int ch = 0; ch < 3; ++ch) {
              const float d_col = dR[ch] * w;
              // SH 0: the colour mask is per candidate, applied after the sum
              dcm[ch] = K == 1 ? d_col
                               : d_col * (raw_color<K>(cd, ch, basis) > 0.f ? 1.f : 0.f);
            }
          }
#pragma unroll
          for (int rr = 0; rr < NR; ++rr) {
            float v[32];
#pragma unroll
            for (int t = 0; t < 32; ++t) {
              const int q = 32 * rr + t;  // a constant once unrolled
              const int cq = q < 14 ? 0 : q < terms<K>() ? q - 14 : 0;  // colour term
              v[t] = q < 14            ? g[q < 14 ? q : 0]
                     : q < terms<K>() ? (K == 1 ? dcm[cq] : dcm[cq / K] * basis[cq % K])
                                      : 0.f;
            }
            dst[32 * rr + lane] = warp_transpose_sum(v);
          }
        }
        __syncthreads();  // every warp's partials of this group are in

        if (multi) {
          // several slots: the block's warps in order, in double, added to
          // its sum of the slots before (slot order) in p.acc; the blocks'
          // sums are added once every slot is in (below)
          double* x = acc + (size_t)g0 * TP;
          for (int q = tid; q < gn * TP; q += blockDim.x) {
            double s = part[q];
            for (int w = 1; w < n_warps; ++w) s += part[(size_t)w * kGroup * TP + q];
            x[q] = sl == 0 ? s : x[q] + s;
          }
          __syncthreads();  // the partials are consumed
          continue;
        }
        // the warps in order, one (candidate, term) per thread, into warp 0's
        // slot; a cluster: in double, into this block's exchange slot, then
        // the blocks' sums in rank order into warp 0's slot of the block that
        // finishes the candidate (candidate gi: block gi % n), no atomics. The
        // double sums keep the 64-256 warps' partials of a tile from rounding
        // at every add, where the M columns cancel (the 1024-ray build adds its
        // 32 in float32, as it did)
        int g_first = 0, g_step = 1;  // the candidates this block finishes
        if constexpr (kCl) {
          double* x = xs + (size_t)xpar * kGroup * TP;
          for (int q = tid; q < gn * TP; q += blockDim.x) {
            double s = part[q];
            for (int w = 1; w < n_warps; ++w) s += part[(size_t)w * kGroup * TP + q];
            x[q] = s;
          }
          k1::cg::cluster_group cl = k1::cg::this_cluster();
          cl.sync();
          g_first = (int)cl.block_rank();
          g_step = (int)cl.num_blocks();
          for (int q = tid; q < gn * TP; q += blockDim.x) {
            if ((q / TP) % g_step != g_first) continue;
            double s = cl.map_shared_rank(x, 0)[q];
            for (int r = 1; r < g_step; ++r) s += cl.map_shared_rank(x, r)[q];
            part[q] = (float)s;
          }
          xpar ^= 1;
        } else {
          for (int q = tid; q < gn * TP; q += R) {
            float s = part[q];
            for (int w = 1; w < n_warps; ++w) s += part[(size_t)w * kGroup * TP + q];
            part[q] = s;
          }
        }
        __syncthreads();
        for (int gi = g_first + g_step * tid; gi < gn; gi += g_step * (int)blockDim.x)
          finish<K, kOrig>(p, sf + (g0 + gi) * kS, part + (size_t)gi * TP, row0 + g0 + gi);
        __syncthreads();  // the group's sums are consumed
      }
    }
    if (!kCl || !multi) continue;
    // several slots: every block's sums in, the blocks' added in rank order
    // (double, through device memory) by the block that finishes each
    // candidate (candidate i: block i % n), in groups of kGroup through the
    // partials' memory. The next write to p.acc comes after the next
    // chunk's skip replay, a cluster barrier, when every block has read it.
    __threadfence();
    k1::cg::cluster_group cl = k1::cg::this_cluster();
    cl.sync();
    const int rank = (int)cl.block_rank(), nb = (int)cl.num_blocks();
    const double* acc0 = acc - (size_t)rank * C * TP;  // block 0's sums of this tile
    for (int g0 = 0; g0 < m; g0 += kGroup) {
      const int gn = min(kGroup, m - g0);
      for (int q = tid; q < gn * TP; q += blockDim.x) {
        if ((g0 + q / TP) % nb != rank) continue;
        double s = acc0[(size_t)g0 * TP + q];
        for (int r = 1; r < nb; ++r) s += acc0[(size_t)r * C * TP + (size_t)g0 * TP + q];
        part[q] = (float)s;
      }
      __syncthreads();
      for (int gi = tid; gi < gn; gi += blockDim.x)
        if ((g0 + gi) % nb == rank)
          finish<K, kOrig>(p, sf + (g0 + gi) * kS, part + (size_t)gi * TP, row0 + g0 + gi);
      __syncthreads();  // the group's sums are consumed
    }
  }
  k1::cp_async_wait<0>();
  k1::tile_end<kCl>();
}

// One launch of the 256-ray build (R <= 256) or the 1024-ray one, or with
// `info` non-null the kernel's resident blocks per SM at R rays, dynamic
// shared memory, registers and local memory per thread.
template <int C, int K, bool kWindow, bool kOrig, int kMaxR>
cudaError_t launch_r(const Params& p, int n_tiles, int R, cudaStream_t stream, int* info) {
  constexpr bool kCl = kMaxR >= k1::kClusterR;
  const int width = kCl ? k1::cluster_width(R) : R;  // threads a block
  const int smem = (int)sizeof(float) * smem_floats<C, K, kMaxR>(width / 32);
  void (*kernel)(Params) = march_bwd_kernel<C, K, kWindow, kOrig, kMaxR>;
  if (kCl) return k1::cluster_launch(kernel, p, n_tiles, R, smem, stream, info);
  // the static red[32] counts against the 48 KB that needs no opt-in
  if (smem + 1024 > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (info) {
    cudaFuncAttributes attr{};
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, R, smem);
    info[1] = smem;
    info[2] = attr.numRegs;
    info[3] = (int)attr.localSizeBytes;
    return err;
  }
  kernel<<<n_tiles, R, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int C, int K, bool kWindow, bool kOrig>
cudaError_t launch(const Params& p, int n_tiles, int R, cudaStream_t stream, int* info) {
  return R <= 256    ? launch_r<C, K, kWindow, kOrig, 256>(p, n_tiles, R, stream, info)
         : R <= 1024 ? launch_r<C, K, kWindow, kOrig, 1024>(p, n_tiles, R, stream, info)
                     : launch_r<C, K, kWindow, kOrig, k1::kClusterR>(p, n_tiles, R, stream, info);
}

// The build of p.chunk: the smallest capacity C in 32, 64, 128, 256 that
// holds it (k1::staging_chunk; window order only at c = C).
template <int K, bool kWindow, bool kOrig>
cudaError_t launch_chunk(const Params& p, int n_tiles, int R, cudaStream_t stream, int* info) {
  switch (k1::staging_chunk(p.chunk)) {
    case 32: return launch<32, K, kWindow, kOrig>(p, n_tiles, R, stream, info);
    case 64: return launch<64, K, kWindow, kOrig>(p, n_tiles, R, stream, info);
    case 128: return launch<128, K, kWindow, kOrig>(p, n_tiles, R, stream, info);
    default: return launch<256, K, kWindow, kOrig>(p, n_tiles, R, stream, info);
  }
}

// Both orders, shared eye or per-ray origins (p.origins), at SH coefficient
// count K: explicitly instantiated for K = 1 in march_bwd.cu and for K = 4,
// 9, 16 in march_bwd_sh1.cu, march_bwd_sh2.cu and march_bwd_sh3.cu, so that
// nvcc builds them in parallel.
template <int K>
cudaError_t launch_k(const Params& p, bool window, int n_tiles, int R, cudaStream_t stream,
                     int* info) {
  if (p.origins)
    return window ? launch_chunk<K, true, true>(p, n_tiles, R, stream, info)
                  : launch_chunk<K, false, true>(p, n_tiles, R, stream, info);
  return window ? launch_chunk<K, true, false>(p, n_tiles, R, stream, info)
                : launch_chunk<K, false, false>(p, n_tiles, R, stream, info);
}

}  // namespace k3
