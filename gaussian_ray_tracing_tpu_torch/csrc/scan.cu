// Kernel K2: inclusive prefix sums of C <= 16 int32 channels over the pair
// stream, exact mod 2^32.
//
// Replaces the Pallas kernel `_scan_kernel` (wrapper `multi_cumsum_i32`) of
// gaussian_ray_tracing_tpu/ops/scan.py, the fused head-fill scan of the
// binning. The TPU version splits int32 into bytes to run the scan as exact
// bf16 matmuls on the MXU; Hopper has integer adders, so this is a plain
// three-phase scan in uint32 arithmetic (wraps exactly like the head fills
// need):
//   1. scan_blocks: each block scans kBlock elements of one channel
//      (warp shuffles, then a scan of the warp totals) and writes its total;
//   2. scan_totals: one block per channel turns the block totals into
//      exclusive offsets, in tiles of kBlock with a running carry;
//   3. scan_add: adds each block's offset to its elements.
// What bounds it on an H100: device-memory bandwidth (read x, write y,
// read and write y again: 16 bytes per element and channel); arithmetic is
// negligible. At the bench size (2 channels x ~2M slots) that is ~64 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;  // threads per block = elements per block

// Inclusive block-wide scan of one value per thread; *total gets the sum.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* warp_sums,
                                               uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int n_warps = kBlock / 32;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < n_warps ? warp_sums[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const uint32_t out = v + (warp > 0 ? warp_sums[warp - 1] : 0u);
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

__global__ void __launch_bounds__(kBlock)
scan_blocks(const uint32_t* x, uint32_t* y, uint32_t* totals, long long P, int n_blocks) {
  __shared__ uint32_t warp_sums[32];
  const int c = blockIdx.y;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const uint32_t v = i < P ? x[c * P + i] : 0u;
  uint32_t total;
  const uint32_t s = block_scan(v, warp_sums, &total);
  if (i < P) y[c * P + i] = s;
  if (threadIdx.x == 0) totals[(long long)c * n_blocks + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kBlock) scan_totals(uint32_t* totals, int n_blocks) {
  __shared__ uint32_t warp_sums[32];
  uint32_t* t = totals + (long long)blockIdx.x * n_blocks;
  uint32_t carry = 0u;
  for (int base = 0; base < n_blocks; base += kBlock) {
    const int i = base + threadIdx.x;
    const uint32_t v = i < n_blocks ? t[i] : 0u;
    uint32_t total;
    const uint32_t s = block_scan(v, warp_sums, &total);
    if (i < n_blocks) t[i] = carry + s - v;  // exclusive offset
    carry += total;
  }
}

__global__ void __launch_bounds__(kBlock)
scan_add(uint32_t* y, const uint32_t* offsets, long long P, int n_blocks) {
  const int c = blockIdx.y;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i < P) y[c * P + i] += offsets[(long long)c * n_blocks + blockIdx.x];
}

}  // namespace

extern "C" int grt_scan_block() { return kBlock; }

// x, y: (C, P) int32 row-major; scratch: C * ceil(P / kBlock) int32.
extern "C" int grt_multi_cumsum_i32(const void* x, void* y, void* scratch, int C, long long P,
                                    void* stream) {
  if (C < 0 || C > 65535 || P < 0) return (int)cudaErrorInvalidValue;
  if (C == 0 || P == 0) return 0;
  const long long n_blocks = (P + kBlock - 1) / kBlock;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)n_blocks, (unsigned)C);
  uint32_t* out = (uint32_t*)y;
  uint32_t* totals = (uint32_t*)scratch;
  scan_blocks<<<grid, kBlock, 0, s>>>((const uint32_t*)x, out, totals, P, (int)n_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_blocks == 1) return 0;
  scan_totals<<<C, kBlock, 0, s>>>(totals, (int)n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_add<<<grid, kBlock, 0, s>>>(out, totals, P, (int)n_blocks);
  return (int)cudaGetLastError();
}
