// Kernel K3: hand-written backward of the key-order fused march.
//
// Replaces the Pallas kernel `_march_bwd_kernel` (wrapper `pallas_march_bwd`)
// of gaussian_ray_tracing_tpu/ops/pallas_march.py in the mode training uses:
// key order, shared ray origin (the camera eye), SH degree 0, full
// [t_min, t_max] rays, any hit_multiplicity. The semantics are those of
// ops/march_bwd.py, whose plain torch version `march_bwd_plain` is the
// reference this kernel is tested against.
//
// Design: one block per tile, one thread per ray (R = blockDim.x). Each
// tile's chunks of C candidates run last to first, carrying dT per ray
// (initially d t_final). Per chunk:
//   1. skip replay: the block max of the saved carry-in t_in; at or below
//      min_transmittance the chunk's rows stay zero and dT is unchanged;
//   2. the chunk's scalar columns (mean, M, opacity, radius, sh0: 17 floats
//      of each 32-float training row) are staged in shared memory;
//   3. pass A: each ray recomputes, candidate by candidate, the scalar-form
//      response with the exact gate, the exclusive prefix of log1p(-a)
//      (summed sequentially, in the order the forward K1 summed it),
//      P = t_in exp(prefix), d_w, d_P, and accumulates sum(d_P E) and the
//      total D = sum(d_P P); the chunk's new dT follows;
//   4. pass B: the same recompute again (bit-identical: same operations in
//      the same order), now with the strict suffix sum of d_P P taken as
//      D minus the running inclusive prefix, giving d_a and the 17
//      per-(ray, candidate) terms whose sums over the tile's rays make the
//      candidate's gradient: opacity, d_oo, 3 d_od d_g, 9 d_dg d, 3 dR w.
//      The sums run in a fixed order, so two launches give bit-identical
//      gradients: a warp shuffle tree (lane 0 keeps the warp's sum; a warp
//      where no ray passes the gate has all 17 terms zero and skips the
//      tree), per-warp partials in shared memory, then one thread per
//      candidate adds the warps in order and finishes the shared-origin
//      d_og / d_m / d_mean algebra. Candidates go through pass B in groups
//      of kGroup, which bounds the partials' shared memory.
// Each stream row belongs to one (tile, chunk): a block writes only rows
// [starts[t], starts[t+1]) of its own tile (the TPU kernel's write-then-
// overwrite of a tail chunk's overshoot rows relies on sequential grid
// steps, a race between concurrent CUDA blocks). The wrapper zero-fills
// the output, so skipped chunks, the quad and radius columns and rows no
// tile owns are zero. No global float atomics.
//
// What bounds it on an H100: per-(ray, candidate) float32 math, two
// recomputes per candidate with one exp, one log1p, one sqrt and three
// divides each, plus up to 17 x 5 warp shuffles per candidate and warp.
// The float rules are K1's: IEEE float32, no FMA contraction (-fmad=false),
// true divisions where JAX divides, no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kS = 17;      // staged floats per candidate (see kStageCol)
constexpr int kNV = 17;     // reduced terms per (ray, candidate)
constexpr int kGroup = 32;  // candidates per reduction group of pass B
constexpr float kC0 = 0.28209479177387814f;
// training-row column of each staged float: mean 16..18, M 19..27, op 0,
// radius 28, sh0 29..31 (ops/march.py TRAIN_COLUMNS)
__constant__ int kStageCol[kS] = {16, 17, 18, 19, 20, 21, 22, 23, 24,
                                  25, 26, 27, 0,  28, 29, 30, 31};
enum { kMx = 0, kM0 = 3, kOp = 12, kRad = 13, kSh0 = 14 };
// training-row columns K3 writes
enum { kGOp = 0, kGMx = 16, kGM0 = 19, kGSh0 = 29 };

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

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red[] may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, red[w]);
  return v;
}

__device__ __forceinline__ float ipow(float x, int k) {
  float r = x;
  for (int i = 1; i < k; ++i) r *= x;
  return r;
}

// Candidate-level (per row, not per ray) values.
struct Cand {
  float ox, oy, oz, ogx, ogy, ogz, oo, m[9], op, rad, col[3];
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
  for (int ch = 0; ch < 3; ++ch) c.col[ch] = 0.5f + kC0 * f[kSh0 + ch];
  return c;
}

// Per-(ray, candidate) forward recompute, scalar form (pallas_march.py:1301-1331).
struct Eval {
  float dgx, dgy, dgz, od, dd_s, pp, resp, alpha, a;
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
  const float t_event = t_entry < p.t_lo ? t_exit : t_entry;
  e.gate = disc >= 0.f && t_event >= p.t_lo && t_event <= p.t_hi && live &&
           e.alpha > p.alpha_min;
  const float a_eff = p.hm == 1 ? e.alpha : 1.f - ipow(1.f - e.alpha, p.hm);
  e.a = e.gate ? a_eff : 0.f;
  return e;
}

template <int C>
__global__ void __launch_bounds__(1024) march_bwd_kernel(Params p) {
  extern __shared__ float smem[];
  float* sf = smem;              // C * kS staged scalar columns
  float* part = smem + C * kS;   // n_warps * kGroup * kNV per-warp partial sums
  __shared__ float red[32];

  const int tile = blockIdx.x, R = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = R >> 5;
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;
  const int n_chunks = (n + C - 1) / C;
  const size_t ray = (size_t)tile * R + tid;

  const float dx = p.dirs[ray * 3 + 0], dy = p.dirs[ray * 3 + 1], dz = p.dirs[ray * 3 + 2];
  const bool live = dx * dx + dy * dy + dz * dz > 0.01f;
  const float dR0 = p.d_rgb[ray * 3 + 0], dR1 = p.d_rgb[ray * 3 + 1],
              dR2 = p.d_rgb[ray * 3 + 2];
  float dT = p.d_tfinal[ray];
  const float* tin = p.tin + (size_t)p.chunk_base[tile] * R + tid;

  for (int j = n_chunks - 1; j >= 0; --j) {
    const float t_in = tin[(size_t)j * R];
    if (block_max(t_in, red) <= p.min_t) continue;  // skip replay: zero rows, dT passes
    const int m = min(C, n - j * C);
    const size_t row0 = (size_t)start + (size_t)j * C;
    __syncthreads();  // the previous chunk is done with sf / part
    for (int k = tid; k < m * kS; k += R)
      sf[k] = p.rows[(row0 + k / kS) * p.stride + kStageCol[k % kS]];
    __syncthreads();

    // ---- pass A: prefix, P, d_P; the chunk's dT ----
    float S = 0.f, sum_dpe = 0.f, D = 0.f;
    for (int i = 0; i < m; ++i) {
      const Cand c = load_cand(sf + i * kS, p.eye);
      const Eval e = evaluate(p, c, dx, dy, dz, live);
      const float E = expf(S);
      const float P = t_in * E;
      const float gw = P > p.min_t ? 1.f : 0.f;
      const float d_w = dR0 * fmaxf(c.col[0], 0.f) + dR1 * fmaxf(c.col[1], 0.f) +
                        dR2 * fmaxf(c.col[2], 0.f);
      const float d_P = d_w * e.a * gw;
      sum_dpe += d_P * E;
      D += d_P * P;
      S += log1pf(-e.a);
    }
    const float prod = expf(S);
    const float base = dT * t_in * prod;  // d_lp's carry term, from the OLD dT
    dT = dT * prod + sum_dpe;

    // ---- pass B: d_a and the per-candidate sums over the tile's rays ----
    S = 0.f;
    float incl = 0.f;
    for (int g0 = 0; g0 < m; g0 += kGroup) {
      const int gn = min(kGroup, m - g0);
      for (int gi = 0; gi < gn; ++gi) {
        const Cand c = load_cand(sf + (g0 + gi) * kS, p.eye);
        const Eval e = evaluate(p, c, dx, dy, dz, live);
        const float E = expf(S);
        const float P = t_in * E;
        const float gw = P > p.min_t ? 1.f : 0.f;
        const float d_w = dR0 * fmaxf(c.col[0], 0.f) + dR1 * fmaxf(c.col[1], 0.f) +
                          dR2 * fmaxf(c.col[2], 0.f);
        const float d_P = d_w * e.a * gw;
        incl += d_P * P;
        S += log1pf(-e.a);
        float* dst = part + ((size_t)warp * kGroup + gi) * kNV;
        if (!__any_sync(0xffffffffu, e.gate)) {  // every term of this warp is zero
          if (lane == 0)
            for (int v = 0; v < kNV; ++v) dst[v] = 0.f;
          continue;
        }
        const float w = e.a * P * gw;
        const float d_lp = base + (D - incl);  // strict suffix sum of d_P P
        const float d_a = d_w * P * gw - d_lp / (1.f - e.a);
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
        float v[kNV] = {d_alpha * e.resp * notclamp, d_pp, d_od * e.dgx, d_od * e.dgy,
                        d_od * e.dgz, d_dgx * dx, d_dgx * dy, d_dgx * dz, d_dgy * dx,
                        d_dgy * dy, d_dgy * dz, d_dgz * dx, d_dgz * dy, d_dgz * dz,
                        dR0 * w, dR1 * w, dR2 * w};
#pragma unroll
        for (int k = 0; k < kNV; ++k) {
          float x = v[k];
          for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
          if (lane == 0) dst[k] = x;
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
        for (int ch = 0; ch < 3; ++ch)
          out[kGSh0 + ch] = kC0 * (r[14 + ch] * (c.col[ch] > 0.f ? 1.f : 0.f));
      }
      __syncthreads();  // the group's partials are consumed
    }
  }
}

template <int C>
cudaError_t launch(const Params& p, int n_tiles, int R, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)C * kS + (size_t)(R / 32) * kGroup * kNV);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        march_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  march_bwd_kernel<C><<<n_tiles, R, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int grt_march_bwd(const void* starts, const void* chunk_base, const void* rows,
                             const void* dirs, const void* eye, const void* tin,
                             const void* d_rgb, const void* d_tfinal, void* d_rows, int n_tiles,
                             int rays_per_tile, int chunk, int stride, float t_lo, float t_hi,
                             float min_t, float alpha_min, float alpha_clamp,
                             int hit_multiplicity, void* stream) {
  if (rays_per_tile % 32 != 0 || rays_per_tile < 32 || rays_per_tile > 1024 || n_tiles < 0 ||
      stride < 32 || hit_multiplicity < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  Params p{(const int*)starts, (const int*)chunk_base, (const float*)rows,
           (const float*)dirs, (const float*)eye, (const float*)tin, (const float*)d_rgb,
           (const float*)d_tfinal, (float*)d_rows, stride, t_lo, t_hi, min_t, alpha_min,
           alpha_clamp, hit_multiplicity};
  cudaStream_t s = (cudaStream_t)stream;
  switch (chunk) {
    case 32: return (int)launch<32>(p, n_tiles, rays_per_tile, s);
    case 64: return (int)launch<64>(p, n_tiles, rays_per_tile, s);
    case 128: return (int)launch<128>(p, n_tiles, rays_per_tile, s);
    case 256: return (int)launch<256>(p, n_tiles, rays_per_tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
