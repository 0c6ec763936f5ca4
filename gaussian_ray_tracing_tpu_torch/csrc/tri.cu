// Kernel K4: per-tile closest hit of rays against culled triangle blocks.
//
// Replaces the Pallas kernel `_tri_kernel` (wrapper `pallas_closest_hit`)
// of gaussian_ray_tracing_tpu/ops/pallas_tri.py. Semantics are those of
// ops/tri.py, whose plain torch version `closest_hit_blocks_plain` is the
// reference this kernel is tested against.
//
// One block per tile, one thread per ray (R = blockDim.x), up to 1024
// rays a tile; a tile of more (any multiple of 128) is split into
// S = ceil(R / 1024) blocks, each over a slice of its rays (a multiple of 32
// wide; the last slice's lanes past R are idle: a zero direction, no output),
// each walking the tile's whole block list on its own. Nothing in this
// kernel spans the tile: a ray's hit depends on its own tests alone, and
// every pretest below only skips work that no ray of the block needs (a
// block that no ray of the slice may hit holds no face that any ray of the
// slice accepts before its best hit), so each slice skips a subset of what
// it may and its rays' outputs are the whole tile's bit for bit. Only the
// counts (Params::stats) are per slice: a block that two slices stage
// counts twice. The tile's
// listed 256-face blocks hold 256 rows of 9 floats [v0, e1, e2] (9 KB);
// every ray of the tile tests the faces of the blocks it may hit:
// double-sided Moller-Trumbore, determinant guard 1e-12, barycentric
// tolerance 1e-6, t in (t_min, t_max). Faces are visited in the TPU
// kernel's order (slot s = 0..7 outer, row 0..31 inner, face row * 8 + s of
// the block) and the best hit is replaced only on a strictly smaller t,
// which reproduces the TPU kernel's tie rule exactly: first listed block,
// then lower slot, then lower row.
//
// What bounds it on an H100: per-(ray, face) float32 math, about 40 flops
// and one IEEE divide, while each face row is read from device memory once
// per tile and from shared memory by every ray of it (a broadcast: all
// threads of a warp read the same face). No tensor cores. The float math
// rounds each operation (the wrapper builds with -fmad=false) in the plain
// version's order, so kernel and plain version agree bit for bit. Most of
// that work is on faces a ray cannot hit, so the kernel skips it where a
// cheap test proves there is no hit (block_may_hit and row_may_hit, with
// the bounds of ops/tri.face_bounds: a bounding sphere and a normal cone
// of each block and of each of its 32 rows of 8 faces):
//   1. block pretest: a ray needs a listed block only if its segment
//      (t_min, min(t_max, best_t)) may meet the block's sphere, or if it
//      may graze one of its faces. Listed blocks come near to far, so after
//      a ray's first hit most later blocks fall away. The tile skips
//      staging a block that no ray needs (__syncthreads_or);
//   2. row pretest: the same test against the bounds of the block's rows
//      (staged beside the faces) gives each ray a mask of the rows it may
//      hit; a warp tests only the faces of the rows some lane needs
//      (__reduce_or_sync), none of a block no lane needs;
//   3. face pretest: the determinant and the numerator of u come first; a
//      face they prove missed (|det| at or below the guard, or u certainly
//      below -1e-6 or above 1.000002) costs neither the divide nor v or t;
//   4. the next needed block is staged by 16-byte cp.async copies into the
//      second of two 10 KB buffers while the current one is tested.
// Skipping changes no value that is used: a skipped block or row holds no
// face the full test accepts at t < best_t, and a hit at t == best_t in a
// later block loses anyway (proof above ball_may_hit; the faces that survive
// the face pretest compute u, v and t exactly as before). Each tile also
// counts what it ran (Params::stats), so that what the pretests skip is
// read from the kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFaces = 256;  // faces per block
constexpr int kSlots = 8, kRows = 32;
constexpr int kFRow = 9;     // v0 xyz, e1 xyz, e2 xyz
constexpr int kBlockFloats = kFaces * kFRow;  // 2304: 576 16-byte groups
constexpr int kGroup = 2;  // float4s per group of faces: sphere [c, rho], cone [a, g]
constexpr int kBounds = kGroup * (1 + kRows);  // per block: its group, then its rows'
constexpr float kMiss = 3.0e38f;
// sphere pretest margins (ops/tri.BLOCK_GROW, ops/tri.BLOCK_SLACK): the
// sphere's radius times kGrow, plus kSlack of |c - o| + radius
constexpr float kGrow = 1.0001f, kSlack = 4e-3f;
constexpr int kStats = 5;  // per tile, see Params::stats

struct Params {
  const int* starts;      // (T+1,) face-slot segment starts, multiples of 256
  const int* blocks;      // (cap_b,) block id of each listed chunk
  const float* faces;     // (F_pad, 9) rows, 16-byte aligned
  const float4* bounds;   // (n_blocks, kBounds) by block id (ops/tri.face_bounds)
  const float* dirs;      // (T, R, 3)
  const float* origins;   // (T, R, 3) or null: rays start at eye
  const float* eye;       // (3,)
  float* t_out;           // (T, R), +inf on a miss
  int* face_out;          // (T, R), -1 on a miss
  float* u_out;           // (T, R)
  float* v_out;           // (T, R)
  // (T, kStats) what each tile ran: blocks staged, (ray, block) pairs that
  // passed the block pretest, (warp, block) pairs that tested a row,
  // (warp, row) pairs tested, (ray, face) pairs that reached the divide
  int* stats;             // (T * splits, kStats): each slice's counts
  float t_min, t_max;
  int R;       // rays per tile
  int splits;  // blocks per tile, S = ceil(R / 1024)
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The pretests. Each group of faces (a block, a row of 8) has a bounding
// sphere s (centre c, radius rho) and a normal cone k (unit axis a, and
// k.w = g) from ops/tri.face_bounds. For the ray o + t d (dl2 = |d|^2,
// dlen = sqrt(dl2)) and the segment t in (t_lo, t_hi) (in the kernel
// t_lo = t_min and t_hi = min(t_max, best_t)):
//   - ball_may_hit(s, X) false proves that Moller-Trumbore accepts at no t
//     in the segment any face held by s that the ray does not graze,
//     given X >= |o - v0| of each such face (a block's sphere holds every
//     v0 of its faces, so X = |c - o| + rho of the block's sphere,
//     slack_bound, serves the block's and its rows' tests);
//   - grazes(k) false proves that the ray grazes no face of the group;
//   - so a row is empty where it does not graze and either its sphere or
//     its block's misses (row_may_hit), and a block where its sphere
//     misses and it does not graze or none of its rows does
//     (block_may_hit).
// ops/tri.py computes the same, operation for operation.
//
// Why. "The ray grazes a face" is |det| < A |d| |e1| |e2| with A =
// ops/tri.GRAZE_ANGLE = 1e-3: the ray meets the face at less than about
// 0.06 degrees to its plane (for an equilateral face). ops/tri.face_bounds
// makes g (raised by 1e-5 for rounding) at least |n_f -+ a| + A |e1| |e2| /
// |e1 x e2| for every face f of the group with |e1| |e2| > 1e-12 /
// (1.00001 kMaxDir) (n_f its unit normal, the sign nearer a; a group
// without one gets g = -1). The other faces are never accepted by a ray
// with |d| <= kMaxDir: |det| <= 1.00001 |d| |e1| |e2| <= 1e-12, the guard
// (det = 0 where e1 or e2 is zero); a longer ray grazes every group (glen
// = inf). So where |d.a| >= g |d|, |d.n_f| >= (g - |n_f -+ a|) |d| and
// |det| = |d.(e1 x e2)| >= A |d| |e1| |e2| for each face that may be
// accepted. The sphere: with x = c - o,
// the ray's points within rr = rho kGrow + kSlack X of c have ray
// parameters in [(x.d - rr dlen) / dl2, (x.d + rr dlen) / dl2], and none
// exist when |x cross d|^2 > rr^2 dl2. Let Moller-Trumbore accept a face
// the ray does not graze, with computed (t, u, v). Its accepted point P =
// v0 + u e1 + v e2 (u, v >= -1e-6, u + v <= 1.000001) lies within 6e-6 rho
// of the face, so within rho kGrow of c (plus an ulp of the coordinates,
// inside the slack): the sphere holds the vertices of the faces it serves
// (a block's, the tail block's repeated last face included; a row's, v0,
// v0 + e1 and v0 + e2 of its nonzero faces), and its radius rounds by a
// few ulp. Each of the four products the test forms (det, and the
// numerators of u, v and t) lies within 12 ulp-units (u = 2^-24) of the
// product of the norms of its factors from its exact value, and Cramer's
// rule then puts the ray's point o + t d within 4 * 12u |o - v0| |d| |e1|
// |e2| / |det| (+ 2 ulp of the divisions) of P: within 2.9e-3 |o - v0| <
// kSlack X, as |det| >= A |d| |e1| |e2|. So o + t d lies within rr of c,
// and a false answer's three tests (rounded far inside the slack, which is
// at least 4e-3 of |x.d| / dlen as |x| <= X) exclude such a t: the line
// misses, the sphere ends at or before t_lo (an accepted t > t_min), or
// begins at or beyond t_hi (a hit there never beats best_t). On a face the
// ray grazes, |det| may be rounding alone and so may t, u and v: the
// accepted point need not lie near the ray, and only the cone test keeps
// such a face. A zero (padding) face has det = 0 and is never accepted. A
// dead ray (d = 0) has det = 0 on every face, and the sphere's second test
// rejects it (0 <= 0). NaNs fail every comparison and keep the group.
constexpr float kMaxDir = 1e4f;  // ops/tri.MAX_DIR
struct Ray {
  float ox, oy, oz, dx, dy, dz, dl2, dlen;
  float glen;  // dlen, or +inf where dlen > kMaxDir
};

__device__ __forceinline__ bool ball_may_hit(const Ray& r, float4 s, float X, float t_lo,
                                             float t_hi) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const float dl2 = r.dl2, dlen = r.dlen;
  const float xx = s.x - ox, xy = s.y - oy, xz = s.z - oz;
  const float rr = s.w * kGrow + kSlack * X;
  const float cx = xy * dz - xz * dy, cy = xz * dx - xx * dz, cz = xx * dy - xy * dx;
  if (cx * cx + cy * cy + cz * cz > rr * rr * dl2) return false;
  const float proj = xx * dx + xy * dy + xz * dz;
  if (proj + rr * dlen <= t_lo * dl2) return false;
  if (proj - rr * dlen >= t_hi * dl2) return false;
  return true;
}

// May the ray meet a face of the group with the normal cone k at less than
// the cone's angle (|d.a| < g |d|, or NaN; every group where |d| > kMaxDir)?
__device__ __forceinline__ bool grazes(const Ray& r, float4 k) {
  return !(fabsf(r.dx * k.x + r.dy * k.y + r.dz * k.z) >= k.w * r.glen);
}

// X = |c - o| + rho of a block's sphere s: the slack bound of its tests.
__device__ __forceinline__ float slack_bound(const Ray& r, float4 s) {
  const float xx = s.x - r.ox, xy = s.y - r.oy, xz = s.z - r.oz;
  return sqrtf(xx * xx + xy * xy + xz * xz) + s.w;
}

// Row `row` of a block (its bounds rb), given the block's sphere test.
__device__ __forceinline__ bool row_may_hit(const Ray& r, const float4* rb, bool block_ball,
                                            float X, float t_lo, float t_hi) {
  return (block_ball && ball_may_hit(r, rb[0], X, t_lo, t_hi)) || grazes(r, rb[1]);
}

// A block (its bounds g: its own, then its rows'), given its sphere test.
__device__ __forceinline__ bool block_may_hit(const Ray& r, const float4* g, bool block_ball) {
  if (block_ball) return true;
  if (!grazes(r, g[1])) return false;
  for (int row = 0; row < kRows; ++row)
    if (grazes(r, g[kGroup * (1 + row) + 1])) return true;
  return false;
}

// Start the 16-byte copies of one block's 2304 floats and its rows' 32
// bounds, and commit them.
__device__ __forceinline__ void stage_async(float* dst, const float* src, float4* rdst,
                                            const float4* rsrc) {
  constexpr int kFaceCopies = kBlockFloats / 4;
  for (int k = threadIdx.x; k < kFaceCopies + kGroup * kRows; k += blockDim.x) {
    if (k < kFaceCopies)
      cp_async16(dst + 4 * k, src + 4 * k);
    else
      cp_async16(reinterpret_cast<float*>(rdst + (k - kFaceCopies)),
                 reinterpret_cast<const float*>(rsrc + (k - kFaceCopies)));
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(1024) tri_kernel(Params p) {
  __shared__ __align__(16) float sf[2][kBlockFloats];
  __shared__ float4 rs[2][kGroup * kRows];  // the staged blocks' row bounds
  __shared__ int counts[kStats - 1];

  const int tile = blockIdx.x / p.splits, tid = threadIdx.x;
  const int r_in = (blockIdx.x % p.splits) * blockDim.x + tid;  // the ray in its tile
  const bool valid = r_in < p.R;  // an idle lane: a dead ray, no output
  if (tid < kStats - 1) counts[tid] = 0;
  const size_t ray = (size_t)tile * p.R + r_in;
  const int start = p.starts[tile];
  const int* listed = p.blocks + start / kFaces;
  const int n_chunks = (p.starts[tile + 1] - start + kFaces - 1) / kFaces;
  const float dx = valid ? p.dirs[ray * 3 + 0] : 0.f, dy = valid ? p.dirs[ray * 3 + 1] : 0.f,
              dz = valid ? p.dirs[ray * 3 + 2] : 0.f;
  const float* o = p.origins && valid ? p.origins + ray * 3 : p.eye;
  const float ox = o[0], oy = o[1], oz = o[2];
  const float dl2 = dx * dx + dy * dy + dz * dz, dlen = sqrtf(dl2);
  const Ray r{ox, oy, oz, dx, dy, dz, dl2, dlen, dlen <= kMaxDir ? dlen : INFINITY};

  float best_t = kMiss, best_u = 0.f, best_v = 0.f;
  int best_f = -1;
  // what this thread, its warp and the tile ran (Params::stats)
  int staged = 0, needed = 0, warp_blocks = 0, warp_rows = 0, divided = 0;
  auto bounds_of = [&](int j) { return p.bounds + (size_t)listed[j] * kBounds; };
  // does this ray need listed block j, given its best hit so far?
  auto may_hit = [&](int j) {
    const float4* g = bounds_of(j);
    const float X = slack_bound(r, g[0]);
    return block_may_hit(r, g, ball_may_hit(r, g[0], X, p.t_min, fminf(p.t_max, best_t)));
  };
  // the first listed block from j on that some ray of the tile needs
  // (block-uniform; every call passes a barrier once per block it looks at)
  auto next_needed = [&](int j) {
    while (j < n_chunks && !__syncthreads_or(may_hit(j))) ++j;
    return j;
  };
  auto stage = [&](int j, int b) {
    stage_async(sf[b], p.faces + (size_t)listed[j] * kBlockFloats, rs[b], bounds_of(j) + kGroup);
    ++staged;
  };

  int j = next_needed(0), buf = 0;
  if (j < n_chunks) stage(j, 0);
  while (j < n_chunks) {
    // the next needed block, judged with the best hits before block j (a
    // later block's need only falls as best_t falls), goes to the other
    // buffer, which every thread left before next_needed's barrier
    const int jn = next_needed(j + 1);
    if (jn < n_chunks) {
      stage(jn, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block j's rows are visible to every thread
    // the rows of 8 faces this ray may hit, and those of its warp
    uint32_t rows = 0u;
    const float4* g = bounds_of(j);
    const float X = slack_bound(r, g[0]), t_hi = fminf(p.t_max, best_t);
    const bool ball = ball_may_hit(r, g[0], X, p.t_min, t_hi);
    if (ball || grazes(r, g[1]))
      for (int row = 0; row < kRows; ++row)
        if (row_may_hit(r, rs[buf] + kGroup * row, ball, X, p.t_min, t_hi)) rows |= 1u << row;
    needed += ball || rows;  // block_may_hit
    const uint32_t wrows = __reduce_or_sync(0xffffffffu, rows);
    if (wrows) {
      ++warp_blocks;
      warp_rows += __popc(wrows);
      const int blk = listed[j];
      const float* q0 = sf[buf];
      for (int s = 0; s < kSlots; ++s) {
        for (int row = 0; row < kRows; ++row) {
          if (!((wrows >> row) & 1u)) continue;  // no lane may hit a face of the row
          const int f = row * kSlots + s;
          const float* q = q0 + f * kFRow;
          const float v0x = q[0], v0y = q[1], v0z = q[2];
          const float e1x = q[3], e1y = q[4], e1z = q[5];
          const float e2x = q[6], e2y = q[7], e2z = q[8];
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
          const float nu = tx * px + ty * py + tz * pz;
          // face pretest: u = nu * (1 / det) rounds twice (2 ulp), so with
          // |det| > 1e-12, u < -1e-6 where sign(det) nu < -4e-6 |det| and
          // u > 1.000002 (so u + v > 1.000001 for any v >= -1e-6) where it
          // exceeds 2 |det|; NaNs fail both and go on
          const float ad = fabsf(det), un = det < 0.f ? -nu : nu;
          if (!(ad > 1e-12f) || un < -4e-6f * ad || un > 2.f * ad) continue;
          ++divided;
          const float inv = 1.f / det;
          const float u = nu * inv;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float v = (dx * qx + dy * qy + dz * qz) * inv;
          const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
          const bool hit = u >= -1e-6f && v >= -1e-6f && u + v <= 1.000001f &&
                           tt > p.t_min && tt < p.t_max;
          if (hit && tt < best_t) {
            best_t = tt;
            best_f = blk * kFaces + f;
            best_u = u;
            best_v = v;
          }
        }
      }
    }
    j = jn;
    buf ^= 1;
  }
  if (valid) {
    p.t_out[ray] = best_t >= kMiss ? INFINITY : best_t;
    p.face_out[ray] = best_f;
    p.u_out[ray] = best_u;
    p.v_out[ray] = best_v;
  }

  __syncthreads();  // counts[] zeroed
  needed = __reduce_add_sync(0xffffffffu, needed);
  divided = __reduce_add_sync(0xffffffffu, divided);
  if ((tid & 31) == 0) {
    atomicAdd(&counts[0], needed);
    atomicAdd(&counts[1], warp_blocks);
    atomicAdd(&counts[2], warp_rows);
    atomicAdd(&counts[3], divided);
  }
  __syncthreads();
  if (tid < kStats) p.stats[(size_t)blockIdx.x * kStats + tid] = tid == 0 ? staged : counts[tid - 1];
}

}  // namespace

// Rays per tile the kernel takes: a multiple of 32 up to 1024 (one block),
// or any multiple of 128 above (split into blocks of up to 1024).
static bool rays_ok(int R) {
  return R >= 32 && (R <= 1024 ? R % 32 == 0 : R % 128 == 0);
}
// Blocks a tile of R rays is split into, and the rays of each (a multiple
// of 32, so that every warp of a slice lies in it).
static int tile_splits(int R) { return (R + 1023) / 1024; }
static int split_width(int R) {
  const int s = tile_splits(R);
  return (R + 32 * s - 1) / (32 * s) * 32;
}

// origins may be null (every ray starts at eye). stats: (n_tiles *
// ceil(rays_per_tile / 1024), 5) int32, each slice's counts, slice s of
// tile t at row t * ceil(rays_per_tile / 1024) + s. Returns a cudaError_t.
extern "C" int grt_closest_hit(const void* starts, const void* blocks, const void* faces,
                               const void* bounds, const void* dirs, const void* origins,
                               const void* eye, void* t_out, void* face_out, void* u_out,
                               void* v_out, void* stats, int n_tiles, int rays_per_tile,
                               float t_min, float t_max, void* stream) {
  if (!rays_ok(rays_per_tile) || n_tiles < 0 || ((size_t)faces & 15) != 0 ||
      ((size_t)bounds & 15) != 0 || !bounds || !stats)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const int splits = tile_splits(rays_per_tile);
  Params p{(const int*)starts, (const int*)blocks, (const float*)faces, (const float4*)bounds,
           (const float*)dirs, (const float*)origins, (const float*)eye, (float*)t_out,
           (int*)face_out, (float*)u_out, (float*)v_out, (int*)stats, t_min, t_max,
           rays_per_tile, splits};
  tri_kernel<<<n_tiles * splits, split_width(rays_per_tile), 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// What a launch of grt_closest_hit at rays_per_tile rays would run, without
// launching: out[0] resident blocks per SM, out[1] static shared memory
// bytes, out[2] registers per thread, out[3] local memory bytes per thread.
extern "C" int grt_closest_hit_info(int rays_per_tile, int* out) {
  if (!rays_ok(rays_per_tile)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, tri_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], tri_kernel,
                                                        split_width(rays_per_tile), 0);
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return (int)err;
}
