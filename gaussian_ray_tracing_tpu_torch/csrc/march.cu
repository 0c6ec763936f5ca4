// Kernel K1: fused forward march of the sorted pair stream.
//
// Replaces the Pallas kernel `_march_kernel` (wrapper `pallas_march_stream`)
// of gaussian_ray_tracing_tpu/ops/pallas_march.py in the modes the primary
// render, the training forward and the mesh tracer use: SH degree 0, in
// window order or in key order, with either the quad response and a shared
// ray origin (full [t_min, t_max] rays, or segments with per-ray windows
// and a carry-in) or the scalar response with per-ray origins over the
// Morton-block table (bounced rays; see "Segments" below). The semantics, per-tile decisions included, are those of
// ops/march.py, whose plain torch version `march_plain` is the reference
// this kernel is tested against. The two orders are two __global__
// functions: `march_kernel` (window) and `march_key_kernel` (key, with the
// optional saved carries of the training forward), each instantiated for
// the quad and the scalar response.
//
// Window order. One block per 16x16 tile, one thread per ray (R =
// blockDim.x). The tile's chunks of C candidates are staged in shared
// memory as compact 16-float rows (64 B; coalesced, each row read by every
// ray of the tile). Per chunk:
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
// Key order (pallas_march.py:552-569, 963-968). The same block layout and
// staging; one evaluation per candidate with, on full-range rays, the
// sqrt-free gate alpha > alpha_min & (t* >= t_lo | q(t_lo) < 0), composited in stream
// order, no fire test and no sort. With saved carries (`tin` non-null, the
// training forward) each chunk's carry-in T is stored BEFORE its skip
// test at row chunk_base[tile] + j, so skipped chunks are saved too and
// the backward (csrc/march_bwd.cu) can replay every chunk; the skip
// threshold is then min_transmittance. The prefix of log1p(-a) is summed
// sequentially per ray, in the order the backward sums it.
//
// Rows may be the 16-float compact rows or the 32-float training rows
// (`stride` floats apart); the quad response reads the first 16 floats.
//
// Segments and bounced rays (the mesh tracer, pallas_march.py:236-241,
// 407-442, 586-633). Optional per-ray arrays, each null for the primary
// render: a window [t_lo, t_hi] and a carry-in transmittance t0 (T, R),
// per-ray origins (T, R, 3), and a block list. With per-ray origins the
// kernel evaluates the scalar (non-quad) response from the training rows:
// o_g = M (o - mu), d_g = M d, t* = -od / max(dd, 1e-6) as a true
// division, pp = oo + t* (2 od + t* dd), the gate with disc >= 0, and the
// colour max(0.5 + C0 sh0, 0) from the row's sh0; a staged row is then 17
// floats [op, mu, M, radius, colour]. Whenever a window, origin or block
// array is given the ray is not a full-range ray, and key order uses the
// exact entry/exit event gate instead of the sqrt-free one. Block mode
// (bounced rays over the Morton-sorted table): with bs = C / block_sub,
// chunk j of tile t stages rows [blocks[start/bs + j*block_sub + s] * bs,
// + bs) for s < block_sub, so a chunk reads block_sub whole blocks.
//
// What bounds it on an H100: not memory (each 64 B feature row is read
// once per tile and reused by 256 rays) but per-(ray, candidate) float32
// math: in window order two evaluations per candidate with one exp, one
// sqrt and two divides each, plus the local-memory insertion sort in
// fired chunks; in key order one evaluation with one exp and one divide.
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

constexpr int kSRow = 17;  // scalar staged row: op, mu xyz, M (9), radius, r g b
constexpr float kC0 = 0.28209479177387814f;  // SH degree-0 basis constant
// training-row columns (ops/march.py): opacity 0, mean 16..18, M 19..27,
// radius 28, sh0 29..31; staged column c >= 1 reads training column 15 + c
constexpr int kTrainRow = 32;

struct Params {
  const int* starts;      // (T+1,) pair-segment starts
  const float* feats;     // (P, stride) rows (stream order, or Morton order in block mode)
  const float* dirs;      // (T, R, 3) ray directions
  float* rgb;             // (T, R, 3)
  float* t_final;         // (T, R)
  float* tin;             // (sum of chunks, R) saved carry-in T, or null
  const int* chunk_base;  // (T+1,) first saved row of each tile, or null
  const float* origins;   // (T, R, 3) per-ray origins (scalar response), or null
  const float* t_lo_arr;  // (T, R) per-ray window start, or null: t_lo
  const float* t_hi_arr;  // (T, R) per-ray window end, or null: t_hi
  const float* t0;        // (T, R) carry-in transmittance, or null: 1
  const int* blocks;      // block mode: block id of each listed slot group, or null
  int block_sub;          // blocks per chunk in block mode
  int stride;
  int full_range;         // no window, origin or block array: key order's fast gate
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
  float ox, oy, oz;              // per-ray origin (scalar response)
  float t_lo, t_hi;              // segment window
  bool live;
};

__device__ __forceinline__ float effective_alpha(float alpha, int hm) {
  if (hm == 1) return alpha;
  const float om = 1.f - alpha;
  float pw = om;
  for (int k = 1; k < hm; ++k) pw *= om;
  return 1.f - pw;
}

// Global row of candidate r of chunk j of the tile whose segment starts at
// `start`: the stream slot, or in block mode the row of the listed block.
template <int C>
__device__ __forceinline__ size_t row_index(const Params& p, int start, int j, int r) {
  if (!p.blocks) return (size_t)start + (size_t)j * C + r;
  const int bs = C / p.block_sub;
  return (size_t)p.blocks[start / bs + j * p.block_sub + r / bs] * bs + r % bs;
}

// Stage the chunk's rows [0, m) in sf: the first kRow floats of each row
// (quad), or the 17 scalar columns with sh0 turned into the colour.
template <int C, bool kScalar>
__device__ __forceinline__ void stage(float* sf, const Params& p, int start, int j, int m) {
  constexpr int W = kScalar ? kSRow : kRow;
  for (int k = threadIdx.x; k < m * W; k += blockDim.x) {
    const int r = k / W, c = k % W;
    const float* g = p.feats + row_index<C>(p, start, j, r) * p.stride;
    if (!kScalar) {
      sf[k] = g[c];
    } else {
      const float x = g[c == 0 ? 0 : 15 + c];
      sf[k] = c >= 14 ? fmaxf(0.5f + kC0 * x, 0.f) : x;
    }
  }
}

// Quad response (shared origin): event t and gated effective alpha.
// fast_gate: key order on a full-range ray, the sqrt-free gate
// alpha > alpha_min & (t* >= t_lo | q(t_lo) < 0); else the exact
// entry/exit event gate t_lo <= t_event <= t_hi.
__device__ __forceinline__ void eval_quad(const Params& p, const Ray& ray, const float* f,
                                          bool fast_gate, float& t_ev, float& a) {
  const float dd = f[1] * ray.m0 + f[2] * ray.m1 + f[3] * ray.m2 + f[4] * ray.m3 +
                   f[5] * ray.m4 + f[6] * ray.m5;
  const float od = f[7] * ray.dx + f[8] * ray.dy + f[9] * ray.dz;
  const float cq = f[10], oo = f[11];
  const float rcp6 = 1.f / fmaxf(dd, 1e-6f);
  const float t_star = -od * rcp6;
  const float pp = oo + od * t_star;
  const float resp = expf(-0.5f * fmaxf(pp, 0.f));
  const float alpha = fminf(p.alpha_clamp, resp * f[0]);
  bool gate;
  if (fast_gate) {
    const float q_lo = cq + ray.t_lo * (2.f * od + ray.t_lo * dd);
    gate = ray.live && alpha > p.alpha_min && (t_star >= ray.t_lo || q_lo < 0.f);
    t_ev = t_star;
  } else {
    const float disc = od * od - dd * cq;
    const float sq = sqrtf(fmaxf(disc, 0.f));
    const float inv_dd = 1.f / fmaxf(dd, 1e-12f);
    const float t_entry = (-od - sq) * inv_dd;
    const float t_exit = (-od + sq) * inv_dd;
    t_ev = t_entry < ray.t_lo ? t_exit : t_entry;
    // disc >= 0 is implied by alpha > alpha_min (the radius is the
    // alpha_min iso-surface), so this gate drops it, as on the TPU
    gate = ray.live && t_ev >= ray.t_lo && t_ev <= ray.t_hi && alpha > p.alpha_min;
  }
  a = gate ? effective_alpha(alpha, p.hm) : 0.f;
}

// Scalar response in the canonical frame from a staged 17-float row, per
// ray origin; always the exact event gate, with disc >= 0.
__device__ __forceinline__ void eval_scalar(const Params& p, const Ray& ray, const float* f,
                                            float& t_ev, float& a) {
  const float* m = f + 4;
  const float ox = ray.ox - f[1], oy = ray.oy - f[2], oz = ray.oz - f[3];
  const float ogx = m[0] * ox + m[1] * oy + m[2] * oz;
  const float ogy = m[3] * ox + m[4] * oy + m[5] * oz;
  const float ogz = m[6] * ox + m[7] * oy + m[8] * oz;
  const float dgx = m[0] * ray.dx + m[1] * ray.dy + m[2] * ray.dz;
  const float dgy = m[3] * ray.dx + m[4] * ray.dy + m[5] * ray.dz;
  const float dgz = m[6] * ray.dx + m[7] * ray.dy + m[8] * ray.dz;
  const float dd = dgx * dgx + dgy * dgy + dgz * dgz;
  const float od = ogx * dgx + ogy * dgy + ogz * dgz;
  const float oo = ogx * ogx + ogy * ogy + ogz * ogz;
  const float t_star = -od / fmaxf(dd, 1e-6f);
  const float pp = oo + t_star * (2.f * od + t_star * dd);
  const float resp = expf(-0.5f * fmaxf(pp, 0.f));
  const float alpha = fminf(p.alpha_clamp, resp * f[0]);
  const float cq = oo - f[13] * f[13];
  const float disc = od * od - dd * cq;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float inv_dd = 1.f / fmaxf(dd, 1e-12f);
  const float t_entry = (-od - sq) * inv_dd;
  const float t_exit = (-od + sq) * inv_dd;
  t_ev = t_entry < ray.t_lo ? t_exit : t_entry;
  const bool gate = disc >= 0.f && t_ev >= ray.t_lo && t_ev <= ray.t_hi && ray.live &&
                    alpha > p.alpha_min;
  a = gate ? effective_alpha(alpha, p.hm) : 0.f;
}

template <bool kScalar>
__device__ __forceinline__ void evaluate(const Params& p, const Ray& ray, const float* f,
                                         bool fast_gate, float& t_ev, float& a) {
  if (kScalar)
    eval_scalar(p, ray, f, t_ev, a);
  else
    eval_quad(p, ray, f, fast_gate, t_ev, a);
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

__device__ __forceinline__ Ray load_ray(const Params& p) {
  Ray ray;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float* d = p.dirs + idx * 3;
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
  const float* o = p.origins ? p.origins + idx * 3 : nullptr;
  ray.ox = o ? o[0] : 0.f;
  ray.oy = o ? o[1] : 0.f;
  ray.oz = o ? o[2] : 0.f;
  ray.t_lo = p.t_lo_arr ? p.t_lo_arr[idx] : p.t_lo;
  ray.t_hi = p.t_hi_arr ? p.t_hi_arr[idx] : p.t_hi;
  return ray;
}

__device__ __forceinline__ float carry_in(const Params& p) {
  return p.t0 ? p.t0[(size_t)blockIdx.x * blockDim.x + threadIdx.x] : 1.f;
}

__device__ __forceinline__ void store_ray(const Params& p, float r, float g, float b, float T) {
  const size_t ray_idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  p.rgb[ray_idx * 3 + 0] = r;
  p.rgb[ray_idx * 3 + 1] = g;
  p.rgb[ray_idx * 3 + 2] = b;
  p.t_final[ray_idx] = T;
}

template <int C, bool kScalar>
__global__ void __launch_bounds__(1024) march_kernel(Params p) {
  constexpr int W = kScalar ? kSRow : kRow;  // staged row width
  constexpr int kCol = kScalar ? 14 : 12;    // staged colour columns
  __shared__ float sf[C * W];
  __shared__ uint32_t scol[C];
  __shared__ float red[32];

  const int tile = blockIdx.x, R = blockDim.x, tid = threadIdx.x;
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;
  const Ray ray = load_ray(p);

  float T = carry_in(p), acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  uint32_t keys[C];
  uint8_t src[C];

  for (int j = 0; j * C < n; ++j) {
    // tile-wide chunk skip (T never changes once every ray is below it)
    if (block_reduce(T, true, red) <= p.t_skip) break;

    const int m = min(C, n - j * C);
    __syncthreads();  // the previous chunk is done with sf/scol
    stage<C, kScalar>(sf, p, start, j, m);
    __syncthreads();
    for (int k = tid; k < m; k += R)
      scol[k] = pack_color(sf[k * W + kCol], sf[k * W + kCol + 1], sf[k * W + kCol + 2]);

    // pass 1: inversion test and significant event-t range of this ray
    bool inv = false;
    float rmax = -INFINITY, lo = INFINITY, hi = -INFINITY;
    for (int i = 0; i < m; ++i) {
      float t_ev, a;
      evaluate<kScalar>(p, ray, sf + i * W, false, t_ev, a);
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
        const float* f = sf + i * W;
        evaluate<kScalar>(p, ray, f, false, t_ev, a);
        if (a > 0.f) comp.add(a, f[kCol], f[kCol + 1], f[kCol + 2], p.min_t);
      }
    } else {
      lo = block_reduce(lo, false, red);
      hi = block_reduce(hi, true, red);
      const float scale = 65534.f / fmaxf(hi - lo, 1e-20f);
      int ns = 0;
      for (int i = 0; i < m; ++i) {
        float t_ev, a;
        evaluate<kScalar>(p, ray, sf + i * W, false, t_ev, a);
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

  store_ray(p, acc_r, acc_g, acc_b, T);
}

template <int C, bool kScalar>
__global__ void __launch_bounds__(1024) march_key_kernel(Params p) {
  constexpr int W = kScalar ? kSRow : kRow;
  constexpr int kCol = kScalar ? 14 : 12;
  __shared__ float sf[C * W];
  __shared__ float red[32];

  const int tile = blockIdx.x, R = blockDim.x, tid = threadIdx.x;
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;
  const int n_chunks = (n + C - 1) / C;
  const Ray ray = load_ray(p);
  const bool fast_gate = p.full_range != 0;
  float* tin = p.tin ? p.tin + (size_t)p.chunk_base[tile] * R + tid : nullptr;

  float T = carry_in(p), acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  bool skipped = false;  // block-uniform; T never changes once skipped
  for (int j = 0; j < n_chunks; ++j) {
    if (tin) tin[(size_t)j * R] = T;
    if (!skipped) skipped = block_reduce(T, true, red) <= p.t_skip;
    if (skipped) {
      if (!tin) break;
      continue;  // the remaining chunks' carries are still saved
    }
    const int m = min(C, n - j * C);
    __syncthreads();  // the previous chunk is done with sf
    stage<C, kScalar>(sf, p, start, j, m);
    __syncthreads();

    Composite comp(T);
    for (int i = 0; i < m; ++i) {
      const float* f = sf + i * W;
      float t_ev, a;
      evaluate<kScalar>(p, ray, f, fast_gate, t_ev, a);
      if (a > 0.f) comp.add(a, f[kCol], f[kCol + 1], f[kCol + 2], p.min_t);
    }
    const float t_next = comp.t_next();
    T = T > p.min_t ? t_next : T;
    acc_r += comp.r;
    acc_g += comp.g;
    acc_b += comp.b;
  }
  store_ray(p, acc_r, acc_g, acc_b, T);
}

template <int C, bool kScalar>
cudaError_t launch_mode(const Params& p, bool key_order, int n_tiles, int R, cudaStream_t stream) {
  if (key_order)
    march_key_kernel<C, kScalar><<<n_tiles, R, 0, stream>>>(p);
  else
    march_kernel<C, kScalar><<<n_tiles, R, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const Params& p, bool key_order, int n_tiles, int R, cudaStream_t stream) {
  return p.origins ? launch_mode<C, true>(p, key_order, n_tiles, R, stream)
                   : launch_mode<C, false>(p, key_order, n_tiles, R, stream);
}

}  // namespace

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// key_order 0: window order (tin must be null); 1: key order, with saved
// carries when tin and chunk_base are non-null. stride: floats per row
// (>= 16; >= 32 with origins, whose scalar response reads the training
// rows). origins, t_lo_arr, t_hi_arr, t0 and blocks may each be null
// (see Params); saved carries take none of them. full_range: no window,
// origin or block array is given.
extern "C" int grt_march(const void* starts, const void* feats, const void* dirs, void* rgb,
                         void* t_final, void* tin, const void* chunk_base, const void* origins,
                         const void* t_lo_arr, const void* t_hi_arr, const void* t0,
                         const void* blocks, int block_sub, int n_tiles, int rays_per_tile,
                         int chunk, int stride, int key_order, int full_range, float t_lo,
                         float t_hi, float min_t, float t_skip, float alpha_min,
                         float alpha_clamp, int hit_multiplicity, void* stream) {
  const bool segment = origins || t_lo_arr || t_hi_arr || t0 || blocks;
  if (rays_per_tile % 32 != 0 || rays_per_tile < 32 || rays_per_tile > 1024 || n_tiles < 0 ||
      stride < (origins ? kTrainRow : kRow) || (tin != nullptr) != (chunk_base != nullptr) ||
      (tin && (!key_order || segment)) || block_sub < 1 || chunk % block_sub != 0 ||
      (block_sub > 1 && !blocks) || (full_range != 0) != !(origins || t_lo_arr || t_hi_arr || blocks))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  Params p{(const int*)starts, (const float*)feats, (const float*)dirs, (float*)rgb,
           (float*)t_final, (float*)tin, (const int*)chunk_base, (const float*)origins,
           (const float*)t_lo_arr, (const float*)t_hi_arr, (const float*)t0,
           (const int*)blocks, block_sub, stride, full_range, t_lo, t_hi, min_t, t_skip,
           alpha_min, alpha_clamp, hit_multiplicity};
  cudaStream_t s = (cudaStream_t)stream;
  const bool key = key_order != 0;
  switch (chunk) {
    case 32: return (int)launch<32>(p, key, n_tiles, rays_per_tile, s);
    case 64: return (int)launch<64>(p, key, n_tiles, rays_per_tile, s);
    case 128: return (int)launch<128>(p, key, n_tiles, rays_per_tile, s);
    case 256: return (int)launch<256>(p, key, n_tiles, rays_per_tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
