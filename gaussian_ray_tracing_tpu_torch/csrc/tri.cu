// Kernel K4: per-tile closest hit of rays against culled triangle blocks.
//
// Replaces the Pallas kernel `_tri_kernel` (wrapper `pallas_closest_hit`)
// of gaussian_ray_tracing_tpu/ops/pallas_tri.py. Semantics are those of
// ops/tri.py, whose plain torch version `closest_hit_blocks_plain` is the
// reference this kernel is tested against.
//
// One block per tile, one thread per ray (R = blockDim.x). The tile's
// listed 256-face blocks are staged one at a time in shared memory as
// 256 rows of 9 floats [v0, e1, e2] (9 KB, a contiguous coalesced copy);
// every ray of the tile then tests all 256 faces against it: double-sided
// Moller-Trumbore, determinant guard 1e-12, barycentric tolerance 1e-6,
// t in (t_min, t_max). Faces are visited in the TPU kernel's order (slot
// s = 0..7 outer, row 0..31 inner, face row * 8 + s of the block) and the
// best hit is replaced only on a strictly smaller t, which reproduces the
// TPU kernel's tie rule exactly: first listed block, then lower slot, then
// lower row.
//
// What bounds it on an H100: per-(ray, face) float32 math, about 30 flops
// and one divide, while each face row is read from device memory once per
// tile and from shared memory by every ray of it (a broadcast: all threads
// of a warp read the same face). No tensor cores. The float math rounds
// each operation (the wrapper builds with -fmad=false) in the plain
// version's order, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFaces = 256;  // faces per block
constexpr int kSlots = 8, kRows = 32;
constexpr int kFRow = 9;     // v0 xyz, e1 xyz, e2 xyz
constexpr float kMiss = 3.0e38f;

struct Params {
  const int* starts;      // (T+1,) face-slot segment starts, multiples of 256
  const int* blocks;      // (cap_b,) block id of each listed chunk
  const float* faces;     // (F_pad, 9) rows
  const float* dirs;      // (T, R, 3)
  const float* origins;   // (T, R, 3) or null: rays start at eye
  const float* eye;       // (3,)
  float* t_out;           // (T, R), +inf on a miss
  int* face_out;          // (T, R), -1 on a miss
  float* u_out;           // (T, R)
  float* v_out;           // (T, R)
  float t_min, t_max;
};

__global__ void __launch_bounds__(1024) tri_kernel(Params p) {
  __shared__ float sf[kFaces * kFRow];

  const int tile = blockIdx.x, R = blockDim.x, tid = threadIdx.x;
  const size_t ray = (size_t)tile * R + tid;
  const int start = p.starts[tile];
  const int n_chunks = (p.starts[tile + 1] - start + kFaces - 1) / kFaces;
  const float dx = p.dirs[ray * 3 + 0], dy = p.dirs[ray * 3 + 1], dz = p.dirs[ray * 3 + 2];
  const float* o = p.origins ? p.origins + ray * 3 : p.eye;
  const float ox = o[0], oy = o[1], oz = o[2];

  float best_t = kMiss, best_u = 0.f, best_v = 0.f;
  int best_f = -1;
  for (int j = 0; j < n_chunks; ++j) {
    const int blk = p.blocks[start / kFaces + j];
    const float* g = p.faces + (size_t)blk * kFaces * kFRow;
    __syncthreads();  // every ray is done with the previous block
    for (int k = tid; k < kFaces * kFRow; k += R) sf[k] = g[k];
    __syncthreads();
    for (int s = 0; s < kSlots; ++s) {
      for (int row = 0; row < kRows; ++row) {
        const int f = row * kSlots + s;
        const float* q = sf + f * kFRow;
        const float v0x = q[0], v0y = q[1], v0z = q[2];
        const float e1x = q[3], e1y = q[4], e1z = q[5];
        const float e2x = q[6], e2y = q[7], e2z = q[8];
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok = fabsf(det) > 1e-12f;
        const float inv = 1.f / (ok ? det : 1.f);
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
        const bool hit = ok && u >= -1e-6f && v >= -1e-6f && u + v <= 1.000001f &&
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
  p.t_out[ray] = best_t >= kMiss ? INFINITY : best_t;
  p.face_out[ray] = best_f;
  p.u_out[ray] = best_u;
  p.v_out[ray] = best_v;
}

}  // namespace

// origins may be null (every ray starts at eye). Returns a cudaError_t.
extern "C" int grt_closest_hit(const void* starts, const void* blocks, const void* faces,
                               const void* dirs, const void* origins, const void* eye,
                               void* t_out, void* face_out, void* u_out, void* v_out,
                               int n_tiles, int rays_per_tile, float t_min, float t_max,
                               void* stream) {
  if (rays_per_tile % 32 != 0 || rays_per_tile < 32 || rays_per_tile > 1024 || n_tiles < 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  Params p{(const int*)starts, (const int*)blocks, (const float*)faces, (const float*)dirs,
           (const float*)origins, (const float*)eye, (float*)t_out, (int*)face_out,
           (float*)u_out, (float*)v_out, t_min, t_max};
  tri_kernel<<<n_tiles, rays_per_tile, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
