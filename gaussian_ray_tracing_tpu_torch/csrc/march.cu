// Kernel K1: fused forward march of the sorted pair stream -- the C entry
// point and the SH degree 0 instantiations. The device code, what it
// replaces and what bounds it are in march.cuh; SH degrees 1-3 are
// instantiated in march_sh1.cu, march_sh2.cu and march_sh3.cu.

#include "march.cuh"

namespace k1 {
template cudaError_t launch_k<1>(const Params&, int, int, int, cudaStream_t, int*);
extern template cudaError_t launch_k<4>(const Params&, int, int, int, cudaStream_t, int*);
extern template cudaError_t launch_k<9>(const Params&, int, int, int, cudaStream_t, int*);
extern template cudaError_t launch_k<16>(const Params&, int, int, int, cudaStream_t, int*);
}  // namespace k1

static cudaError_t dispatch(const k1::Params& p, int sh_k, int order, int n_tiles, int R,
                            cudaStream_t s, int* info) {
  using namespace k1;
  switch (sh_k) {
    case 1: return launch_k<1>(p, order, n_tiles, R, s, info);
    case 4: return launch_k<4>(p, order, n_tiles, R, s, info);
    case 9: return launch_k<9>(p, order, n_tiles, R, s, info);
    case 16: return launch_k<16>(p, order, n_tiles, R, s, info);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Rays per tile the kernels take: a multiple of 32 up to 1024 (one block),
// or any multiple of 128 above (a cluster of up to 8 blocks, each thread
// marching ceil(R / 8192) rays).
static bool rays_ok(int R) {
  return R >= 32 && (R <= 1024 ? R % 32 == 0 : R % 128 == 0);
}

// Chunks an order takes: key order (1) and oddeven (3) any c >= 1 (the
// key kernel stages a chunk above 256 in pieces); window (0) and merge (2)
// order 32, 64, 128 or 256, where their sorts and 8-bit source indices
// hold (JAX's bitonic network sorts only a power of two,
// pallas_march.py:132-183, and caps them at 256, :1106-1110).
static bool chunk_ok(int chunk, int order) {
  if (order == 1 || order == 3) return chunk >= 1;
  return chunk == 32 || chunk == 64 || chunk == 128 || chunk == 256;
}

// chunk: candidates a chunk (chunk_ok). order 0: window order; 1: key
// order; 2: merge order; 3: oddeven, which
// the key kernel runs (stream order) with the exact event gate unless
// `peak` (JAX's kernel has no odd-even network and takes the sqrt-free gate
// only in key order or under the peak key, pallas_march.py:560-562, 966).
// origins non-null:
// per-ray origins, with the scalar response, or with quad != 0 the
// per-ray-origin quad response (on the training rows and the pair stream).
// tin and chunk_base non-null: saved carries (the training forward, on the
// training rows, no block array), in key order on any response and in window order on the
// scalar response from per-ray `origins`; never in merge order. stride:
// floats per row, at least the staged quad columns, or 29 + 3K with origins
// or saved carries, whose rows are the scalar (or training) rows. origins,
// t_lo_arr, t_hi_arr, t0 and blocks may each be null (see Params).
// full_range: no window, origin or block array is given (with order 1, or
// order 3 and peak, the sqrt-free gate). sh_k: SH
// coefficients per channel, K = 1, 4, 9 or 16. peak: window_key "peak"
// (window and merge order). The render options (ops/march.window_options;
// with saved carries scan 0, group rays_per_tile, a_fire 0, repair 0 and
// stats null): scan, composite_scan (every order); group, the rays of a
// fire group, a multiple of 32 dividing rays_per_tile; a_fire,
// sort_alpha_min; repair, the band width (0, or below chunk); stats (T, 2)
// int32, each tile's most fired and repaired chunks of a fire group, or null
// (window order). carry: grt_march_carry_floats(chunk, order,
// rays_per_tile) * carry_tiles * rays_per_tile floats of scratch, each
// ray's state between its turns where a thread marches several (above 8192
// rays a tile), else null; carry_tiles >= 1 the tiles it holds (fewer than
// n_tiles: the tiles run as launches of that many).
extern "C" int grt_march(const void* starts, const void* feats, const void* dirs, void* rgb,
                         void* t_final, void* tin, const void* chunk_base, const void* origins,
                         const void* t_lo_arr, const void* t_hi_arr, const void* t0,
                         const void* blocks, int block_sub, int n_tiles, int rays_per_tile,
                         int chunk, int stride, int order, int full_range, float t_lo,
                         float t_hi, float min_t, float t_skip, float alpha_min,
                         float alpha_clamp, int hit_multiplicity, int sh_k, int quad, int peak,
                         int scan, int group, float a_fire, int repair, void* stats,
                         void* carry, int carry_tiles, void* stream) {
  using namespace k1;
  const bool sh_ok = sh_k == 1 || sh_k == 4 || sh_k == 9 || sh_k == 16;
  // a cluster's fire groups smaller than the tile lie in one block each
  const bool groups_ok = rays_per_tile <= 1024 || group == rays_per_tile ||
                         cluster_width(rays_per_tile) % group == 0;
  const bool options_ok = group >= 32 && group % 32 == 0 && rays_per_tile % group == 0 &&
                          groups_ok &&
                          a_fire >= 0.f && repair >= 0 && repair < chunk &&
                          (!tin || (!scan && group == rays_per_tile && a_fire == 0.f &&
                                    repair == 0 && !stats));
  if (!rays_ok(rays_per_tile) || n_tiles < 0 || !sh_ok || !options_ok || order < 0 || order > 3 ||
      !chunk_ok(chunk, order) || stride < min_stride(origins || tin, sh_k) ||
      (tin != nullptr) != (chunk_base != nullptr) ||
      (quad && (!origins || blocks)) ||
      (tin && (blocks || order == 2 || (order == 0 && (!origins || quad)))) ||
      block_sub < 1 || chunk % block_sub != 0 || (block_sub > 1 && !blocks) ||
      (full_range != 0) != !(origins || t_lo_arr || t_hi_arr || blocks) ||
      stride % 4 != 0 || ((uintptr_t)feats & 15) != 0 ||  // rows are staged in 16-byte copies
      (!carry && carry_fields(order % 2 == 1 ? 1 : order, staging_chunk(chunk), rays_per_tile)) ||
      (carry && carry_tiles < 1))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  Params p{(const int*)starts, (const float*)feats, (const float*)dirs, (float*)rgb,
           (float*)t_final, (float*)tin, (const int*)chunk_base, (const float*)origins,
           (const float*)t_lo_arr, (const float*)t_hi_arr, (const float*)t0,
           (const int*)blocks, block_sub, stride, full_range && (order != 3 || peak), t_lo,
           t_hi, min_t, t_skip, alpha_min, alpha_clamp, hit_multiplicity, quad != 0, peak != 0,
           scan != 0, group, a_fire, repair, (int*)stats, rays_per_tile, chunk, (float*)carry,
           carry ? carry_tiles : 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch(p, sh_k, order == 3 ? 1 : order, n_tiles, rays_per_tile, s, nullptr);
}

// What a launch of grt_march with these settings would run, without
// launching: out[0] resident blocks per SM at rays_per_tile rays, out[1]
// dynamic shared memory bytes, out[2] registers per thread, out[3] local
// memory bytes per thread (stack frame and spills); above 1024 rays also
// out[4] the blocks of a tile's cluster and out[5] the clusters that can be
// resident at once (an error where none can); out[6] the build's staging
// capacity C (staging_chunk: the chunk's build); out[7] the rays each
// thread marches (cluster_slots). resp: 0 the quad
// response from the eye, 1 the scalar one from per-ray origins, 2 the
// per-ray-origin quad one; train: saved carries.
extern "C" int grt_march_info(int chunk, int order, int sh_k, int resp, int train,
                              int rays_per_tile, int* out) {
  using namespace k1;
  static float dummy[4];
  Params p{};
  p.group = rays_per_tile;
  p.origins = resp ? dummy : nullptr;
  p.quad = resp == 2;
  p.tin = train ? dummy : nullptr;
  p.R = rays_per_tile;
  p.chunk = chunk;
  if (!rays_ok(rays_per_tile) || order < 0 || order > 3 || !chunk_ok(chunk, order))
    return (int)cudaErrorInvalidValue;
  out[6] = staging_chunk(chunk);
  out[7] = cluster_slots(rays_per_tile);
  return (int)dispatch(p, sh_k, order == 3 ? 1 : order, 0, rays_per_tile, nullptr, out);
}

// Floats of grt_march's `carry` a ray needs at this chunk, order and tile
// (k1::carry_fields; 0 where each thread marches one ray), or -1 for a
// chunk, order or tile grt_march refuses.
extern "C" int grt_march_carry_floats(int chunk, int order, int rays_per_tile) {
  using namespace k1;
  if (!rays_ok(rays_per_tile) || order < 0 || order > 3 || !chunk_ok(chunk, order)) return -1;
  return carry_fields(order % 2 == 1 ? 1 : order, staging_chunk(chunk), rays_per_tile);
}
