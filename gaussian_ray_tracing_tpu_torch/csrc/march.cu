// Kernel K1: fused forward march of the sorted pair stream.
//
// Replaces the Pallas kernel `_march_kernel` (wrapper `pallas_march_stream`)
// of gaussian_ray_tracing_tpu/ops/pallas_march.py in the mode the primary
// render uses: window order on the exact event t, quad response with a
// shared ray origin, SH degree 0, full [t_min, t_max] rays. The semantics,
// per-tile decisions included, are those of ops/march.py, whose plain torch
// version `march_plain` is the reference this kernel is tested against.
//
// Design: one block per 16x16 tile, one thread per ray (R = blockDim.x).
// The tile's chunks of C candidates are staged in shared memory as compact
// 16-float rows (64 B; coalesced, each row read by every ray of the tile).
// Per chunk:
//   1. tile-wide chunk skip: block max of T against the skip threshold;
//   2. pass 1: each ray evaluates its C candidates (response, event t, gate)
//      and records whether it sees an inversion among significant ones,
//      plus its significant event-t range; __syncthreads_or decides the
//      window-sort fire for the whole tile, block min/max the t range;
//   3. pass 2: each ray re-evaluates its candidates and composites them in
//      stream order (no fire) or inserts the significant ones, keyed
//      tq16 << 15 | a15, into a per-thread insertion-sorted list (fire;
//      the depth-presorted stream is nearly ordered, so few shifts) and
//      composites that list with decoded alphas and 3x10-bit colours.
//   Recomputing in pass 2 instead of storing per-candidate state keeps the
//   unfired path free of local memory; only fired chunks touch the sorted
//   list, which lives in local memory (C * 5 bytes per thread).
//
// What bounds it on an H100: not memory (each 64 B feature row is read
// once per tile and reused by 256 rays) but per-(ray, candidate) float32
// math, two evaluations per candidate with one exp, one sqrt and two
// divides each, plus the local-memory insertion sort in fired chunks.
// The float math stays IEEE float32 with no FMA contraction (the wrapper
// builds with -fmad=false): pp = oo - od^2/dd cancels by orders of
// magnitude, and matching the plain version's per-operation rounding keeps
// kernel and reference comparable. No tensor cores and no TF32 anywhere.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRow = 16;  // op, q00 q11 q22 q01 q02 q12, vx vy vz, cq, oo, r g b, pad
constexpr float kInvA = (float)(1.0 / 32767.0);
constexpr float kInvCol = (float)(1.0 / 255.75);

struct Params {
  const int* starts;   // (T+1,) pair-segment starts
  const float* feats;  // (P, kRow) compact rows in stream order
  const float* dirs;   // (T, R, 3) ray directions
  float* rgb;          // (T, R, 3)
  float* t_final;      // (T, R)
  float t_lo, t_hi, min_t, t_skip, alpha_min, alpha_clamp;
  int hm;
};

__device__ __forceinline__ float block_reduce(float v, bool take_max, float* red) {
  // All threads of the block must call this; returns the reduction to all.
  for (int o = 16; o > 0; o >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = take_max ? fmaxf(v, u) : fminf(v, u);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // red[] may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < n_warps; ++w) v = take_max ? fmaxf(v, red[w]) : fminf(v, red[w]);
  return v;
}

__device__ __forceinline__ uint32_t pack_color(float r, float g, float b) {
  auto q = [](float x) { return (uint32_t)fminf(fmaxf(x * 255.75f, 0.f), 1023.f); };
  return (q(r) << 20) | (q(g) << 10) | q(b);
}

struct Ray {
  float dx, dy, dz;
  float m0, m1, m2, m3, m4, m5;  // dx^2, dy^2, dz^2, 2dxdy, 2dxdz, 2dydz
  bool live;
};

// Event t and gated effective alpha of one (ray, candidate) pair.
__device__ __forceinline__ void evaluate(const Params& p, const Ray& ray,
                                         const float* f, float& t_ev, float& a) {
  const float dd = f[1] * ray.m0 + f[2] * ray.m1 + f[3] * ray.m2 + f[4] * ray.m3 +
                   f[5] * ray.m4 + f[6] * ray.m5;
  const float od = f[7] * ray.dx + f[8] * ray.dy + f[9] * ray.dz;
  const float cq = f[10], oo = f[11];
  const float rcp6 = 1.f / fmaxf(dd, 1e-6f);
  const float t_star = -od * rcp6;
  const float pp = oo + od * t_star;
  const float resp = expf(-0.5f * fmaxf(pp, 0.f));
  const float alpha = fminf(p.alpha_clamp, resp * f[0]);
  const float disc = od * od - dd * cq;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float inv_dd = 1.f / fmaxf(dd, 1e-12f);
  const float t_entry = (-od - sq) * inv_dd;
  const float t_exit = (-od + sq) * inv_dd;
  t_ev = t_entry < p.t_lo ? t_exit : t_entry;
  const bool gate = ray.live && t_ev >= p.t_lo && t_ev <= p.t_hi && alpha > p.alpha_min;
  float a_eff = alpha;
  if (p.hm != 1) {
    const float om = 1.f - alpha;
    float pw = om;
    for (int k = 1; k < p.hm; ++k) pw *= om;
    a_eff = 1.f - pw;
  }
  a = gate ? a_eff : 0.f;
}

// Front-to-back composite of one chunk's ordered candidates.
struct Composite {
  float t0, s, frozen, r, g, b;
  bool below;
  __device__ explicit Composite(float t_carry)
      : t0(t_carry), s(0.f), frozen(0.f), r(0.f), g(0.f), b(0.f), below(false) {}
  __device__ __forceinline__ void add(float a, float cr, float cg, float cb, float min_t) {
    const float p_excl = t0 * expf(s);
    const float w = p_excl > min_t ? a * p_excl : 0.f;
    r += w * cr;
    g += w * cg;
    b += w * cb;
    const float p_incl = p_excl * (1.f - a);
    if (p_incl <= min_t) {  // first crossing freezes T: max of the below set
      frozen = below ? fmaxf(frozen, p_incl) : p_incl;
      below = true;
    }
    s += log1pf(-a);
  }
  __device__ __forceinline__ float t_next() const { return below ? frozen : t0 * expf(s); }
};

template <int C>
__global__ void __launch_bounds__(1024) march_kernel(Params p) {
  __shared__ float sf[C * kRow];
  __shared__ uint32_t scol[C];
  __shared__ float red[32];

  const int tile = blockIdx.x, R = blockDim.x, tid = threadIdx.x;
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;

  Ray ray;
  const float* d = p.dirs + ((size_t)tile * R + tid) * 3;
  ray.dx = d[0];
  ray.dy = d[1];
  ray.dz = d[2];
  ray.live = ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz > 0.01f;
  ray.m0 = ray.dx * ray.dx;
  ray.m1 = ray.dy * ray.dy;
  ray.m2 = ray.dz * ray.dz;
  ray.m3 = 2.f * ray.dx * ray.dy;
  ray.m4 = 2.f * ray.dx * ray.dz;
  ray.m5 = 2.f * ray.dy * ray.dz;

  float T = 1.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  uint32_t keys[C];
  uint8_t src[C];

  for (int j = 0; j * C < n; ++j) {
    // tile-wide chunk skip (T never changes once every ray is below it)
    if (block_reduce(T, true, red) <= p.t_skip) break;

    const int m = min(C, n - j * C);
    const float* g = p.feats + ((size_t)start + (size_t)j * C) * kRow;
    __syncthreads();  // the previous chunk is done with sf/scol
    for (int k = tid; k < m * kRow; k += R) sf[k] = g[k];
    __syncthreads();
    for (int k = tid; k < m; k += R)
      scol[k] = pack_color(sf[k * kRow + 12], sf[k * kRow + 13], sf[k * kRow + 14]);

    // pass 1: inversion test and significant event-t range of this ray
    bool inv = false;
    float rmax = -INFINITY, lo = INFINITY, hi = -INFINITY;
    for (int i = 0; i < m; ++i) {
      float t_ev, a;
      evaluate(p, ray, sf + i * kRow, t_ev, a);
      if (a > 0.f) {
        inv |= t_ev < rmax;
        rmax = fmaxf(rmax, t_ev);
        lo = fminf(lo, t_ev);
        hi = fmaxf(hi, t_ev);
      }
    }
    const bool fired = __syncthreads_or(inv);  // also publishes scol

    Composite comp(T);
    if (!fired) {
      for (int i = 0; i < m; ++i) {
        float t_ev, a;
        evaluate(p, ray, sf + i * kRow, t_ev, a);
        if (a > 0.f) {
          const float* f = sf + i * kRow;
          comp.add(a, f[12], f[13], f[14], p.min_t);
        }
      }
    } else {
      lo = block_reduce(lo, false, red);
      hi = block_reduce(hi, true, red);
      const float scale = 65534.f / fmaxf(hi - lo, 1e-20f);
      int ns = 0;
      for (int i = 0; i < m; ++i) {
        float t_ev, a;
        evaluate(p, ray, sf + i * kRow, t_ev, a);
        if (!(a > 0.f)) continue;
        const uint32_t tq = (uint32_t)fminf(fmaxf((t_ev - lo) * scale, 0.f), 65534.f);
        const uint32_t aq = (uint32_t)fminf(fmaxf(a * 32767.f, 0.f), 32767.f);
        const uint32_t key = (tq << 15) | aq;
        int pos = ns++;
        while (pos > 0 && keys[pos - 1] > key) {  // stable: ties keep stream order
          keys[pos] = keys[pos - 1];
          src[pos] = src[pos - 1];
          --pos;
        }
        keys[pos] = key;
        src[pos] = (uint8_t)i;
      }
      for (int k = 0; k < ns; ++k) {
        const uint32_t cp = scol[src[k]];
        comp.add((float)(keys[k] & 32767u) * kInvA, (float)((cp >> 20) & 1023u) * kInvCol,
                 (float)((cp >> 10) & 1023u) * kInvCol, (float)(cp & 1023u) * kInvCol,
                 p.min_t);
      }
    }
    const float t_next = comp.t_next();
    T = T > p.min_t ? t_next : T;
    acc_r += comp.r;
    acc_g += comp.g;
    acc_b += comp.b;
  }

  const size_t ray_idx = (size_t)tile * R + tid;
  p.rgb[ray_idx * 3 + 0] = acc_r;
  p.rgb[ray_idx * 3 + 1] = acc_g;
  p.rgb[ray_idx * 3 + 2] = acc_b;
  p.t_final[ray_idx] = T;
}

template <int C>
cudaError_t launch(const Params& p, int n_tiles, int R, cudaStream_t stream) {
  march_kernel<C><<<n_tiles, R, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int grt_march(const void* starts, const void* feats, const void* dirs, void* rgb,
                         void* t_final, int n_tiles, int rays_per_tile, int chunk, float t_lo,
                         float t_hi, float min_t, float t_skip, float alpha_min,
                         float alpha_clamp, int hit_multiplicity, void* stream) {
  if (rays_per_tile % 32 != 0 || rays_per_tile < 32 || rays_per_tile > 1024 || n_tiles < 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  Params p{(const int*)starts, (const float*)feats, (const float*)dirs, (float*)rgb,
           (float*)t_final, t_lo, t_hi, min_t, t_skip, alpha_min, alpha_clamp,
           hit_multiplicity};
  cudaStream_t s = (cudaStream_t)stream;
  switch (chunk) {
    case 32: return (int)launch<32>(p, n_tiles, rays_per_tile, s);
    case 64: return (int)launch<64>(p, n_tiles, rays_per_tile, s);
    case 128: return (int)launch<128>(p, n_tiles, rays_per_tile, s);
    case 256: return (int)launch<256>(p, n_tiles, rays_per_tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
