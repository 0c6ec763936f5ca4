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
// or any multiple of 128 above (a cluster of up to 8 blocks, each thread
// replaying ceil(R / 8192) rays).
static bool rays_ok(int R) {
  return R >= 32 && (R <= 1024 ? R % 32 == 0 : R % 128 == 0);
}

static size_t scratch_of(int chunk, int sh_k, int R, int n_tiles) {
  const int C = k1::staging_chunk(chunk);
  switch (sh_k) {
    case 1: return k3::scratch_bytes<1>(C, R, n_tiles);
    case 4: return k3::scratch_bytes<4>(C, R, n_tiles);
    case 9: return k3::scratch_bytes<9>(C, R, n_tiles);
    default: return k3::scratch_bytes<16>(C, R, n_tiles);
  }
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
// window_key "peak", the window replay's order key t*. scratch:
// grt_march_bwd_scratch_bytes(chunk, window, sh_k, rays_per_tile,
// scratch_tiles) bytes, 8-byte aligned, where each thread replays several
// rays (above 8192 rays a tile), else null; scratch_tiles >= 1 the tiles it
// holds (fewer than n_tiles: the tiles run as launches of that many).
extern "C" int grt_march_bwd(const void* starts, const void* chunk_base, const void* rows,
                             const void* dirs, const void* eye, const void* tin,
                             const void* d_rgb, const void* d_tfinal, void* d_rows,
                             const void* origins, const void* t_lo_arr, const void* t_hi_arr,
                             int n_tiles, int rays_per_tile, int chunk, int stride, int window,
                             int sh_k, float t_lo, float t_hi, float min_t, float alpha_min,
                             float alpha_clamp, int hit_multiplicity, int peak, void* scratch,
                             int scratch_tiles, void* stream) {
  if (!rays_ok(rays_per_tile) || n_tiles < 0 || stride < (sh_k == 1 ? 32 : 29 + 3 * sh_k) ||
      hit_multiplicity < 1 || !chunk_ok(chunk, window) ||
      stride % 4 != 0 || ((uintptr_t)rows & 15) != 0 ||  // rows are staged in 16-byte copies
      (!scratch && scratch_of(chunk, sh_k, rays_per_tile, 1)) || ((uintptr_t)scratch & 7) != 0 ||
      (scratch && scratch_tiles < 1))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  using namespace k3;
  const int held = scratch ? scratch_tiles : 0;
  const size_t acc_bytes = scratch_of(chunk, sh_k, rays_per_tile, held) -
                           (size_t)held * rays_per_tile * sizeof(float);
  Params p{(const int*)starts, (const int*)chunk_base, (const float*)rows, (const float*)dirs,
           (const float*)eye, (const float*)tin, (const float*)d_rgb, (const float*)d_tfinal,
           (float*)d_rows, (const float*)origins, (const float*)t_lo_arr,
           (const float*)t_hi_arr, stride, t_lo, t_hi, min_t, alpha_min, alpha_clamp,
           hit_multiplicity, peak != 0, rays_per_tile, chunk, (double*)scratch,
           scratch ? (float*)((char*)scratch + acc_bytes) : nullptr, held, 0};
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
  out[7] = k1::cluster_slots(rays_per_tile);
  return (int)dispatch(p, sh_k, window != 0, 0, rays_per_tile, nullptr, out);
}

// Bytes of grt_march_bwd's scratch at this chunk, SH coefficient count,
// tile and tile count (0 where each thread replays one ray), or -1 for
// values grt_march_bwd refuses.
extern "C" long long grt_march_bwd_scratch_bytes(int chunk, int window, int sh_k,
                                                 int rays_per_tile, int n_tiles) {
  if (!rays_ok(rays_per_tile) || !chunk_ok(chunk, window) || n_tiles < 0 ||
      !(sh_k == 1 || sh_k == 4 || sh_k == 9 || sh_k == 16))
    return -1;
  return (long long)scratch_of(chunk, sh_k, rays_per_tile, n_tiles);
}

// Version of the C interface: 6 since grt_march takes `carry` and
// `carry_tiles`, and grt_march_bwd `scratch` and `scratch_tiles` (each
// before the stream), and both any multiple of
// 128 rays above 1024 (a version 5 library takes neither argument and
// refuses tiles above 8192 rays with cudaErrorInvalidValue; its info
// queries write out[0..6] only); 5 since grt_march takes any chunk c >= 1 in
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
extern "C" int grt_interface_version() { return 6; }
