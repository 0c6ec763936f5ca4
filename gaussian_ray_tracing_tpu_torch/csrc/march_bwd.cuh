// Kernel K3: hand-written backward of the fused march, key and window order
// (device code, shared by march_bwd.cu, the SH degree 0 entry point, and
// march_bwd_sh{1,2,3}.cu, the SH degree 1-3 instantiations).
//
// Replaces the Pallas kernel `_march_bwd_kernel` (wrapper `pallas_march_bwd`)
// of gaussian_ray_tracing_tpu/ops/pallas_march.py in the modes training
// uses: key order (after K1's quad forward) and window order (after K1's
// scalar forward with the training sort key), a shared ray origin (the
// camera eye), SH degree 0 to 3, full [t_min, t_max] rays, any
// hit_multiplicity. The semantics are those of ops/march_bwd.py, whose plain
// torch version `march_bwd_plain` is the reference this kernel is tested
// against. (The TPU kernel's per-ray-origin variant is on no training path
// and is not ported.)
//
// Design: one block per tile, one thread per ray (R = blockDim.x <= 256).
// Each tile's chunks of C candidates run last to first, carrying dT per ray
// (initially d t_final). Per chunk:
//   1. skip replay: the block max of the saved carry-in t_in; at or below
//      min_transmittance the chunk's rows stay zero and dT is unchanged;
//   2. the chunk's scalar columns (mean, M, opacity, radius and the 3K SH
//      coefficients: 14 + 3K floats of each training row) are staged in
//      shared memory;
//   3. key order, pass A: each ray recomputes, candidate by candidate, the
//      scalar-form response with the exact gate, the exclusive prefix of
//      log1p(-a) (summed sequentially, in the order the forward K1 summed
//      it), P = t_in exp(prefix), d_w, d_P, and accumulates sum(d_P E) and
//      the total D = sum(d_P P); the chunk's new dT follows. Pass B repeats
//      the recompute (bit-identical: same operations in the same order),
//      now with the strict suffix sum of d_P P taken as D minus the running
//      inclusive prefix, giving d_a;
//   3'. window order (the replay, pallas_march.py:1343-1425): pass 1
//      evaluates every candidate with the operations K1 used (event t,
//      alpha, gate), keeps a and the 3x10-bit colour pack per candidate in
//      local memory, and repeats K1's tile-wide fire test; a fired chunk
//      lists its significant candidates by the unique key (tq16 << 8) | src,
//      tq16 from the same true division, in a per-thread insertion list
//      (the TPU's bitonic network is layout and is not ported: a unique key
//      makes any correct sort the same permutation), an unfired one in
//      stream order. Passes A and B then sweep that list as in key order,
//      with the 10-bit colours in d_w (straight-through, as the reference
//      does even in unfired chunks), and the inverse permutation is a
//      scatter: entry k's d_a and w go to local slot src[k] (replacing the
//      reference's second sort, :1419-1425). Only significant candidates
//      are listed; the rest have a = w = 0 and a closed gate;
//   4. per-candidate sums over the tile's rays of 14 + 3K terms per (ray,
//      candidate): opacity, d_oo, 3 d_od d_g, 9 d_dg d and the colour terms
//      (SH 0: 3 dR w, times C0 and the colour mask after the sum; SH 1-3:
//      3K dR w [colour > 0] basis_k, the mask from the exact colours,
//      pallas_march.py:1448-1461). The sums run in a fixed order, so two
//      launches give bit-identical gradients: a warp shuffle tree (lane 0
//      keeps the warp's sum; a warp where no ray passes the gate has every
//      term zero and skips the tree), per-warp partials in shared memory,
//      then one thread per candidate adds the warps in order and finishes
//      the shared-origin d_og / d_m / d_mean algebra. Candidates go through
//      in groups of kGroup = 32: with R <= 256 the partials take at most
//      8 x 32 x 62 floats (63.5 KB at SH 3) beside the staged rows.
// Each stream row belongs to one (tile, chunk): a block writes only rows
// [starts[t], starts[t+1]) of its own tile (the TPU kernel's write-then-
// overwrite of a tail chunk's overshoot rows relies on sequential grid
// steps, a race between concurrent CUDA blocks). The wrapper zero-fills
// the output, so skipped chunks, the quad and radius columns and rows no
// tile owns are zero. No global float atomics.
//
// What bounds it on an H100: per-(ray, candidate) float32 math: two
// recomputes per candidate (key) or three (window) with one exp, one
// log1p, one sqrt and three divides each, plus (14 + 3K) x 5 warp
// shuffles per candidate and warp; window order adds the local-memory list
// (12 C bytes per thread) and the insertion sort in fired chunks. The float
// rules are K1's: IEEE float32, no FMA contraction (-fmad=false), true
// divisions where JAX divides, no tensor cores, no TF32.

#pragma once

#include "march.cuh"

namespace k3 {

constexpr int kGroup = 32;  // candidates per reduction group
using k1::kC0;
// staged floats per candidate: mean 0..2, M 3..11, op 12, radius 13, SH
// coefficients 14.. (training-row columns 16..27, 0, 28, 29..)
enum { kMx = 0, kM0 = 3, kOp = 12, kRad = 13, kSh = 14 };
// training-row columns K3 writes
enum { kGOp = 0, kGMx = 16, kGM0 = 19, kGSh = 29 };

template <int K>
__host__ __device__ constexpr int staged() {
  return 14 + 3 * K;
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
  int stride;
  float t_lo, t_hi, min_t, alpha_min, alpha_clamp;
  int hm;
};

__device__ __forceinline__ float ipow(float x, int k) {
  float r = x;
  for (int i = 1; i < k; ++i) r *= x;
  return r;
}

// Candidate-level (per row, not per ray) values.
struct Cand {
  float ox, oy, oz, ogx, ogy, ogz, oo, m[9], op, rad;
  const float* sh;  // sh_r[K], sh_g[K], sh_b[K] in shared memory
};

__device__ __forceinline__ Cand load_cand(const float* f, const float* eye) {
  Cand c;
  c.ox = eye[0] - f[kMx];
  c.oy = eye[1] - f[kMx + 1];
  c.oz = eye[2] - f[kMx + 2];
  for (int k = 0; k < 9; ++k) c.m[k] = f[kM0 + k];
  c.ogx = c.m[0] * c.ox + c.m[1] * c.oy + c.m[2] * c.oz;
  c.ogy = c.m[3] * c.ox + c.m[4] * c.oy + c.m[5] * c.oz;
  c.ogz = c.m[6] * c.ox + c.m[7] * c.oy + c.m[8] * c.oz;
  c.oo = c.ogx * c.ogx + c.ogy * c.ogy + c.ogz * c.ogz;
  c.op = f[kOp];
  c.rad = f[kRad];
  c.sh = f + kSh;
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

// Per-(ray, candidate) forward recompute, scalar form (pallas_march.py:1301-1331),
// with the operations of K1's eval_scalar (csrc/march.cuh), so that the
// window replay sees K1's event t and alpha bit for bit.
struct Eval {
  float dgx, dgy, dgz, od, dd_s, pp, resp, alpha, a, t_ev;
  bool gate;
};

__device__ __forceinline__ Eval evaluate(const Params& p, const Cand& c, float dx, float dy,
                                         float dz, bool live) {
  Eval e;
  e.dgx = c.m[0] * dx + c.m[1] * dy + c.m[2] * dz;
  e.dgy = c.m[3] * dx + c.m[4] * dy + c.m[5] * dz;
  e.dgz = c.m[6] * dx + c.m[7] * dy + c.m[8] * dz;
  const float dd = e.dgx * e.dgx + e.dgy * e.dgy + e.dgz * e.dgz;
  e.od = c.ogx * e.dgx + c.ogy * e.dgy + c.ogz * e.dgz;
  e.dd_s = fmaxf(dd, 1e-6f);
  const float t_star = -e.od / e.dd_s;
  e.pp = c.oo + t_star * (2.f * e.od + t_star * dd);
  e.resp = expf(-0.5f * fmaxf(e.pp, 0.f));
  e.alpha = fminf(p.alpha_clamp, e.resp * c.op);
  const float cq = c.oo - c.rad * c.rad;
  const float disc = e.od * e.od - dd * cq;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float inv_dd = 1.f / fmaxf(dd, 1e-12f);
  const float t_entry = (-e.od - sq) * inv_dd;
  const float t_exit = (-e.od + sq) * inv_dd;
  e.t_ev = t_entry < p.t_lo ? t_exit : t_entry;
  e.gate = disc >= 0.f && e.t_ev >= p.t_lo && e.t_ev <= p.t_hi && live &&
           e.alpha > p.alpha_min;
  const float a_eff = p.hm == 1 ? e.alpha : 1.f - ipow(1.f - e.alpha, p.hm);
  e.a = e.gate ? a_eff : 0.f;
  return e;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

template <int C, int K, bool kWindow>
__global__ void __launch_bounds__(256) march_bwd_kernel(Params p) {
  constexpr int kS = staged<K>();  // staged floats per candidate
  constexpr int kNV = 14 + 3 * K;  // reduced terms per (ray, candidate)
  extern __shared__ float smem[];
  float* sf = smem;             // C * kS staged scalar columns
  float* part = smem + C * kS;  // n_warps * kGroup * kNV per-warp partial sums
  __shared__ float red[32];

  const int tile = blockIdx.x, R = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = R >> 5;
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;
  const int n_chunks = (n + C - 1) / C;
  const size_t ray = (size_t)tile * R + tid;

  const float dx = p.dirs[ray * 3 + 0], dy = p.dirs[ray * 3 + 1], dz = p.dirs[ray * 3 + 2];
  const bool live = dx * dx + dy * dy + dz * dz > 0.01f;
  const float dR[3] = {p.d_rgb[ray * 3 + 0], p.d_rgb[ray * 3 + 1], p.d_rgb[ray * 3 + 2]};
  float basis[K];
  if (K > 1) k1::sh_basis<K>(dx, dy, dz, basis);
  float dT = p.d_tfinal[ray];
  const float* tin = p.tin + (size_t)p.chunk_base[tile] * R + tid;
  // window replay, per candidate: keys (the listed order), a then d_a, the
  // colour pack then w (local memory)
  uint32_t keys[kWindow ? C : 1];
  float va[kWindow ? C : 1], vw[kWindow ? C : 1];

  for (int j = n_chunks - 1; j >= 0; --j) {
    const float t_in = tin[(size_t)j * R];
    if (k1::block_reduce(t_in, true, red) <= p.min_t) continue;  // skip replay
    const int m = min(C, n - j * C);
    const size_t row0 = (size_t)start + (size_t)j * C;
    __syncthreads();  // the previous chunk is done with sf / part
    for (int k = tid; k < m * kS; k += R) {
      const int c = k % kS;
      const int col = c < 12 ? 16 + c : c == kOp ? 0 : c == kRad ? 28 : 15 + c;
      sf[k] = p.rows[(row0 + k / kS) * p.stride + col];
    }
    __syncthreads();

    float base = 0.f, D = 0.f;
    if (kWindow) {
      // ---- pass 1: K1's fire test; a and the colour pack per candidate ----
      bool inv = false;
      float rmax = -INFINITY, lo = INFINITY, hi = -INFINITY;
      for (int i = 0; i < m; ++i) {
        const Cand c = load_cand(sf + i * kS, p.eye);
        const Eval e = evaluate(p, c, dx, dy, dz, live);
        va[i] = e.a;
        vw[i] = 0.f;
        keys[i] = __float_as_uint(e.t_ev);
        if (e.a > 0.f) {
          inv |= e.t_ev < rmax;
          rmax = fmaxf(rmax, e.t_ev);
          lo = fminf(lo, e.t_ev);
          hi = fmaxf(hi, e.t_ev);
          vw[i] = __uint_as_float(k1::pack_color(fmaxf(raw_color<K>(c, 0, basis), 0.f),
                                                 fmaxf(raw_color<K>(c, 1, basis), 0.f),
                                                 fmaxf(raw_color<K>(c, 2, basis), 0.f)));
        }
      }
      const bool fired = __syncthreads_or(inv);
      // ---- the listed order: significant candidates, sorted if fired ----
      int ns = 0;
      if (fired) {
        lo = k1::block_reduce(lo, false, red);
        hi = k1::block_reduce(hi, true, red);
        const float scale = 65534.f / fmaxf(hi - lo, 1e-20f);
        for (int i = 0; i < m; ++i) {
          if (!(va[i] > 0.f)) continue;
          const float t_ev = __uint_as_float(keys[i]);  // read before the list grows to i
          const uint32_t tq = (uint32_t)fminf(fmaxf((t_ev - lo) * scale, 0.f), 65534.f);
          const uint32_t key = (tq << 8) | (uint32_t)i;
          int pos = ns++;
          while (pos > 0 && keys[pos - 1] > key) {
            keys[pos] = keys[pos - 1];
            --pos;
          }
          keys[pos] = key;
        }
      } else {
        for (int i = 0; i < m; ++i)
          if (va[i] > 0.f) keys[ns++] = (uint32_t)i;
      }
      // ---- pass A over the list: prefix, P, d_P; the chunk's dT ----
      float S = 0.f, sum_dpe = 0.f;
      for (int k = 0; k < ns; ++k) {
        const int i = (int)(keys[k] & 255u);
        const float a = va[i];
        const uint32_t cp = __float_as_uint(vw[i]);
        const float d_w = dR[0] * ((float)((cp >> 20) & 1023u) * k1::kInvCol) +
                          dR[1] * ((float)((cp >> 10) & 1023u) * k1::kInvCol) +
                          dR[2] * ((float)(cp & 1023u) * k1::kInvCol);
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
      // ---- pass B over the list: d_a and w, scattered to the source slot ----
      S = 0.f;
      float incl = 0.f;
      for (int k = 0; k < ns; ++k) {
        const int i = (int)(keys[k] & 255u);
        const float a = va[i];
        const uint32_t cp = __float_as_uint(vw[i]);
        const float d_w = dR[0] * ((float)((cp >> 20) & 1023u) * k1::kInvCol) +
                          dR[1] * ((float)((cp >> 10) & 1023u) * k1::kInvCol) +
                          dR[2] * ((float)(cp & 1023u) * k1::kInvCol);
        const float E = expf(S);
        const float P = t_in * E;
        const float gw = P > p.min_t ? 1.f : 0.f;
        const float d_P = d_w * a * gw;
        incl += d_P * P;
        const float d_lp = base + (D - incl);  // strict suffix sum of d_P P
        va[i] = d_w * P * gw - d_lp / (1.f - a);
        vw[i] = a * P * gw;
        S += log1pf(-a);
      }
    } else {
      // ---- key order, pass A: prefix, P, d_P; the chunk's dT ----
      float S = 0.f, sum_dpe = 0.f;
      for (int i = 0; i < m; ++i) {
        const Cand c = load_cand(sf + i * kS, p.eye);
        const Eval e = evaluate(p, c, dx, dy, dz, live);
        const float E = expf(S);
        const float P = t_in * E;
        const float gw = P > p.min_t ? 1.f : 0.f;
        float d_w = 0.f;
        for (int ch = 0; ch < 3; ++ch) d_w = d_w + dR[ch] * fmaxf(raw_color<K>(c, ch, basis), 0.f);
        const float d_P = d_w * e.a * gw;
        sum_dpe += d_P * E;
        D += d_P * P;
        S += log1pf(-e.a);
      }
      const float prod = expf(S);
      base = dT * t_in * prod;
      dT = dT * prod + sum_dpe;
    }

    // ---- pass B (key) / C (window): the per-candidate sums over the rays ----
    float S = 0.f, incl = 0.f;
    for (int g0 = 0; g0 < m; g0 += kGroup) {
      const int gn = min(kGroup, m - g0);
      for (int gi = 0; gi < gn; ++gi) {
        const int i = g0 + gi;
        const Cand c = load_cand(sf + i * kS, p.eye);
        const Eval e = evaluate(p, c, dx, dy, dz, live);
        float d_a, w;
        if (kWindow) {
          d_a = va[i];
          w = vw[i];
        } else {
          const float E = expf(S);
          const float P = t_in * E;
          const float gw = P > p.min_t ? 1.f : 0.f;
          float d_w = 0.f;
          for (int ch = 0; ch < 3; ++ch)
            d_w = d_w + dR[ch] * fmaxf(raw_color<K>(c, ch, basis), 0.f);
          const float d_P = d_w * e.a * gw;
          incl += d_P * P;
          S += log1pf(-e.a);
          w = e.a * P * gw;
          const float d_lp = base + (D - incl);  // strict suffix sum of d_P P
          d_a = d_w * P * gw - d_lp / (1.f - e.a);
        }
        float* dst = part + ((size_t)warp * kGroup + gi) * kNV;
        if (!__any_sync(0xffffffffu, e.gate)) {  // every term of this warp is zero
          if (lane == 0)
            for (int v = 0; v < kNV; ++v) dst[v] = 0.f;
          continue;
        }
        float d_alpha = p.hm == 1 ? d_a : d_a * p.hm * ipow(1.f - e.alpha, p.hm - 1);
        d_alpha = e.gate ? d_alpha : 0.f;
        const float notclamp = e.resp * c.op < p.alpha_clamp ? 1.f : 0.f;
        const float d_resp = d_alpha * c.op * notclamp;
        const float d_pp = -0.5f * e.resp * d_resp * (e.pp > 0.f ? 1.f : 0.f);
        const float d_od = d_pp * (-2.f * e.od / e.dd_s);
        const float d_dd = d_pp * (e.od * e.od / (e.dd_s * e.dd_s));
        const float d_dgx = d_od * c.ogx + 2.f * e.dgx * d_dd;
        const float d_dgy = d_od * c.ogy + 2.f * e.dgy * d_dd;
        const float d_dgz = d_od * c.ogz + 2.f * e.dgz * d_dd;
        const float v[14] = {d_alpha * e.resp * notclamp, d_pp, d_od * e.dgx, d_od * e.dgy,
                             d_od * e.dgz, d_dgx * dx, d_dgx * dy, d_dgx * dz, d_dgy * dx,
                             d_dgy * dy, d_dgy * dz, d_dgz * dx, d_dgz * dy, d_dgz * dz};
#pragma unroll
        for (int k = 0; k < 14; ++k) {
          const float x = warp_sum(v[k]);
          if (lane == 0) dst[k] = x;
        }
        for (int ch = 0; ch < 3; ++ch) {
          const float d_col = dR[ch] * w;
          if (K == 1) {  // the colour mask is per candidate: applied after the sum
            const float x = warp_sum(d_col);
            if (lane == 0) dst[14 + ch] = x;
          } else {
            const float dcm = d_col * (raw_color<K>(c, ch, basis) > 0.f ? 1.f : 0.f);
            for (int k = 0; k < K; ++k) {
              const float x = warp_sum(dcm * basis[k]);
              if (lane == 0) dst[14 + ch * K + k] = x;
            }
          }
        }
      }
      __syncthreads();  // every warp's partials of this group are in

      for (int gi = tid; gi < gn; gi += R) {
        float r[kNV];
        for (int k = 0; k < kNV; ++k) r[k] = part[(size_t)gi * kNV + k];
        for (int w = 1; w < n_warps; ++w)
          for (int k = 0; k < kNV; ++k) r[k] += part[((size_t)w * kGroup + gi) * kNV + k];
        const Cand c = load_cand(sf + (g0 + gi) * kS, p.eye);
        const float d_oo = r[1];
        const float d_ogx = r[2] + 2.f * c.ogx * d_oo;
        const float d_ogy = r[3] + 2.f * c.ogy * d_oo;
        const float d_ogz = r[4] + 2.f * c.ogz * d_oo;
        float* out = p.d_rows + (row0 + g0 + gi) * p.stride;
        out[kGOp] = r[0];
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
        if (K == 1) {
          for (int ch = 0; ch < 3; ++ch)
            out[kGSh + ch] = kC0 * (r[14 + ch] * (raw_color<1>(c, ch, nullptr) > 0.f ? 1.f : 0.f));
        } else {
          for (int k = 0; k < 3 * K; ++k) out[kGSh + k] = r[14 + k];
        }
      }
      __syncthreads();  // the group's partials are consumed
    }
  }
}

template <int C, int K, bool kWindow>
cudaError_t launch(const Params& p, int n_tiles, int R, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)C * staged<K>() + (size_t)(R / 32) * kGroup * (14 + 3 * K));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        march_bwd_kernel<C, K, kWindow>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  march_bwd_kernel<C, K, kWindow><<<n_tiles, R, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int K, bool kWindow>
cudaError_t launch_chunk(const Params& p, int chunk, int n_tiles, int R, cudaStream_t stream) {
  switch (chunk) {
    case 32: return launch<32, K, kWindow>(p, n_tiles, R, stream);
    case 64: return launch<64, K, kWindow>(p, n_tiles, R, stream);
    case 128: return launch<128, K, kWindow>(p, n_tiles, R, stream);
    case 256: return launch<256, K, kWindow>(p, n_tiles, R, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Both orders at SH coefficient count K: explicitly instantiated for K = 1 in
// march_bwd.cu and for K = 4, 9, 16 in march_bwd_sh1.cu, march_bwd_sh2.cu and
// march_bwd_sh3.cu, so that nvcc builds them in parallel.
template <int K>
cudaError_t launch_k(const Params& p, bool window, int chunk, int n_tiles, int R,
                     cudaStream_t stream) {
  return window ? launch_chunk<K, true>(p, chunk, n_tiles, R, stream)
                : launch_chunk<K, false>(p, chunk, n_tiles, R, stream);
}

}  // namespace k3
