// Kernel K3: hand-written backward of the fused march -- the C entry point
// and the SH degree 0 instantiations. The device code, what it replaces and
// what bounds it are in march_bwd.cuh; SH degrees 1-3 are instantiated in
// march_bwd_sh1.cu, march_bwd_sh2.cu and march_bwd_sh3.cu.

#include "march_bwd.cuh"

namespace k3 {
template cudaError_t launch_k<1>(const Params&, bool, int, int, cudaStream_t, int*);
extern template cudaError_t launch_k<4>(const Params&, bool, int, int, cudaStream_t, int*);
extern template cudaError_t launch_k<9>(const Params&, bool, int, int, cudaStream_t, int*);
extern template cudaError_t launch_k<16>(const Params&, bool, int, int, cudaStream_t, int*);
}  // namespace k3

static cudaError_t dispatch(const k3::Params& p, int sh_k, bool window, int n_tiles, int R,
                            cudaStream_t s, int* info) {
  using namespace k3;
  switch (sh_k) {
    case 1: return launch_k<1>(p, window, n_tiles, R, s, info);
    case 4: return launch_k<4>(p, window, n_tiles, R, s, info);
    case 9: return launch_k<9>(p, window, n_tiles, R, s, info);
    case 16: return launch_k<16>(p, window, n_tiles, R, s, info);
    default: return cudaErrorInvalidValue;
  }
}

// Rays per tile the kernels take: a multiple of 32 up to 1024 (one block),
// or a multiple of 128 up to 8192 (a cluster of up to 8 blocks).
static bool rays_ok(int R) {
  return R >= 32 && (R <= 1024 ? R % 32 == 0 : R <= 8192 && R % 128 == 0);
}

// Chunks the replay takes: key order any c in [1, 256] (the training
// forward's chunks: chunk_for caps them at 256), window order 32, 64, 128
// or 256 (its sort, as K1's).
static bool chunk_ok(int chunk, int window) {
  if (!window) return chunk >= 1 && chunk <= 256;
  return chunk == 32 || chunk == 64 || chunk == 128 || chunk == 256;
}

// chunk: candidates a chunk (chunk_ok). window: 0 key order, 1 window
// order (the training sort replay). sh_k:
// SH coefficients per channel, K = 1, 4, 9 or 16. stride: floats per
// training row, at least 29 + 3K (32 at SH 0). origins (T, R, 3), t_lo_arr
// and t_hi_arr (T, R) may each be null: the eye, t_lo and t_hi. peak:
// window_key "peak", the window replay's order key t*.
extern "C" int grt_march_bwd(const void* starts, const void* chunk_base, const void* rows,
                             const void* dirs, const void* eye, const void* tin,
                             const void* d_rgb, const void* d_tfinal, void* d_rows,
                             const void* origins, const void* t_lo_arr, const void* t_hi_arr,
                             int n_tiles, int rays_per_tile, int chunk, int stride, int window,
                             int sh_k, float t_lo, float t_hi, float min_t, float alpha_min,
                             float alpha_clamp, int hit_multiplicity, int peak,
                             void* stream) {
  if (!rays_ok(rays_per_tile) || n_tiles < 0 || stride < (sh_k == 1 ? 32 : 29 + 3 * sh_k) ||
      hit_multiplicity < 1 || !chunk_ok(chunk, window) ||
      stride % 4 != 0 || ((uintptr_t)rows & 15) != 0)  // rows are staged in 16-byte copies
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  using namespace k3;
  Params p{(const int*)starts, (const int*)chunk_base, (const float*)rows, (const float*)dirs,
           (const float*)eye, (const float*)tin, (const float*)d_rgb, (const float*)d_tfinal,
           (float*)d_rows, (const float*)origins, (const float*)t_lo_arr,
           (const float*)t_hi_arr, stride, t_lo, t_hi, min_t, alpha_min, alpha_clamp,
           hit_multiplicity, peak != 0, rays_per_tile, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch(p, sh_k, window != 0, n_tiles, rays_per_tile, s, nullptr);
}

// What grt_march_bwd would launch, without launching: out[0] resident
// blocks per SM at rays_per_tile rays, out[1] dynamic shared memory bytes,
// out[2] registers per thread, out[3] local memory bytes per thread; above
// 1024 rays out[4] and out[5], and out[6], as grt_march_info's. origins:
// per-ray origins.
extern "C" int grt_march_bwd_info(int chunk, int window, int sh_k, int origins,
                                  int rays_per_tile, int* out) {
  if (!rays_ok(rays_per_tile) || !chunk_ok(chunk, window)) return (int)cudaErrorInvalidValue;
  static float dummy[4];
  k3::Params p{};
  p.origins = origins ? dummy : nullptr;
  p.R = rays_per_tile;
  p.chunk = chunk;
  out[6] = k1::staging_chunk(chunk);
  return (int)dispatch(p, sh_k, window != 0, 0, rays_per_tile, nullptr, out);
}

// Version of the C interface: 5 since grt_march takes any chunk c >= 1 in
// key order and oddeven and grt_march_bwd any c in [1, 256] in key order
// (a version 4 library refuses a chunk other than 32, 64, 128 and 256 with
// cudaErrorInvalidValue and runs everything else alike, with the same
// argument lists; its info queries write out[0..5] only); 4 since grt_march takes order 3 (oddeven: key
// order with the exact event gate; a version 3 library refuses it with
// cudaErrorInvalidValue and runs everything else alike); 3 since grt_march
// takes the peak key, the
// window-order render options and stats, and grt_march_bwd the peak key; 2
// since grt_march took `quad` (the per-ray-origin quad response) and
// grt_march_bwd per-ray origins and windows; a library without this
// function is version 1.
extern "C" int grt_interface_version() { return 5; }
