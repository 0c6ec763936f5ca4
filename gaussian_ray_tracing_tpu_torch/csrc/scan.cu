// Kernel K2: inclusive prefix sums of C <= 16 int32 channels over the pair
// stream, exact mod 2^32.
//
// Replaces the Pallas kernel `_scan_kernel` (wrapper `multi_cumsum_i32`) of
// gaussian_ray_tracing_tpu/ops/scan.py, the fused head-fill scan of the
// binning. The TPU version splits int32 into bytes to run the scan as exact
// bf16 matmuls on the MXU; Hopper has integer adders, so this is a
// single-pass scan with decoupled look-back (Merrill and Garland, 2016) in
// uint32 arithmetic, which wraps exactly as the head fills need (any
// grouping of the sums gives the same bits):
//   - each block takes one tile of kTile elements of one channel; its tile
//     comes from a global atomic counter, never from blockIdx, so that a
//     block only ever waits on tiles that blocks already running hold;
//   - it loads its tile once (16-byte loads, a thread's kGroups groups of
//     4 consecutive elements kThreads groups apart, so a warp reads 512
//     contiguous bytes a load), scans it (each group in the thread, the
//     groups' totals by warp shuffles and the warps' totals in shared
//     memory), and publishes its aggregate as one 64-bit status word
//     (flag << 32 | value) after a fence; tile 0 of a channel publishes its
//     inclusive prefix instead;
//   - warp 0 looks back 32 predecessors at a time: it waits until all 32
//     have published, adds the aggregates up to the nearest inclusive
//     prefix, and stops there (else it adds all 32 and goes on); then it
//     publishes its own inclusive prefix;
//   - every element is written once, with the tile's exclusive prefix.
// The status words and the counter are zeroed by a cudaMemsetAsync at the
// start of every call (two device operations a call). Rows whose start is
// not 16-byte aligned ((c * P) % 4 != 0) and the ragged end of the last
// tile use 4-byte loads and stores.
// What bounds it on an H100: device-memory bandwidth: x read once and y
// written once, 8 bytes per element and channel (the status words are 8
// bytes per 8,192 elements); arithmetic is negligible. At the bench size (2
// channels x ~2M slots) that is ~32 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 4 blocks per SM (64 registers) hold 528 tiles, all of the headline's
// 512 (2 channels of 2,097,152 slots) at once
constexpr int kMinBlocks = 4;
constexpr int kVec = 4;                            // int32 per 16-byte group
constexpr int kGroups = 8;                         // groups per thread
constexpr int kTile = kThreads * kVec * kGroups;  // 8,192 elements of one channel
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* s) {
  return *reinterpret_cast<const volatile unsigned long long*>(s);
}

__device__ __forceinline__ void store_status(unsigned long long* s, unsigned long long w) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(s) = w;
}

// status: (C, tiles) words, then the tile counter; all zero at launch.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_kernel(const uint32_t* x, uint32_t* y, unsigned long long* status, long long P, int tiles) {
  __shared__ uint32_t warp_tot[kGroups][kWarps];
  __shared__ uint32_t s_prefix;
  __shared__ int s_id;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    unsigned int* counter = reinterpret_cast<unsigned int*>(status + (long long)gridDim.x);
    s_id = (int)atomicAdd(counter, 1u);
  }
  __syncthreads();
  const int c = s_id / tiles, t = s_id - c * tiles;
  const uint32_t* xr = x + (long long)c * P;
  uint32_t* yr = y + (long long)c * P;
  const bool vec = ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
  const long long base = (long long)t * kTile;

  // load; each group's inclusive scan in the thread
  uint32_t v[kGroups][kVec], inc[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long i0 = base + ((long long)g * kThreads + tid) * kVec;
    if (vec && i0 + kVec <= P) {
      const uint4 q = *reinterpret_cast<const uint4*>(xr + i0);
      v[g][0] = q.x;
      v[g][1] = q.y;
      v[g][2] = q.z;
      v[g][3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[g][e] = i0 + e < P ? xr[i0 + e] : 0u;
    }
#pragma unroll
    for (int e = 1; e < kVec; ++e) v[g][e] += v[g][e - 1];
    inc[g] = v[g][kVec - 1];
  }
  // the groups' totals, scanned across the warp and then the warps
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const uint32_t u = __shfl_up_sync(0xffffffffu, inc[g], o);
      if (lane >= o) inc[g] += u;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) warp_tot[g][warp] = inc[g];
  }
  __syncthreads();
  uint32_t off[kGroups], run = 0u;  // run: the tile's sum so far
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    uint32_t before = 0u, all = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t s = warp_tot[g][w];
      before += w < warp ? s : 0u;
      all += s;
    }
    // exclusive offset of the group in the tile (v[g][kVec - 1]: its total)
    off[g] = run + before + inc[g] - v[g][kVec - 1];
    run += all;
  }

  // publish, look back, publish the inclusive prefix
  if (warp == 0) {
    unsigned long long* st = status + (long long)c * tiles;
    if (lane == 0) store_status(st + t, (t == 0 ? kPrefix : kAggregate) | run);
    uint32_t excl = 0u;
    for (int look = t - 1; look >= 0; look -= 32) {
      const int k = look - lane;
      // lanes past tile 0 stand for an empty prefix; tile 0's comes first
      unsigned long long w = k >= 0 ? load_status(st + k) : kPrefix;
      while (__any_sync(0xffffffffu, (w >> 32) == 0))
        if ((w >> 32) == 0) w = load_status(st + k);
      const unsigned int prefix = __ballot_sync(0xffffffffu, (w >> 32) == 2);
      const int stop = prefix ? __ffs(prefix) - 1 : 31;  // the nearest inclusive prefix
      uint32_t val = lane <= stop ? (uint32_t)w : 0u;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) val += __shfl_xor_sync(0xffffffffu, val, o);
      excl += val;
      if (prefix) break;
    }
    if (lane == 0) {
      if (t > 0) store_status(st + t, kPrefix | (excl + run));
      s_prefix = excl;
    }
  }
  __syncthreads();
  const uint32_t pre = s_prefix;

#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long i0 = base + ((long long)g * kThreads + tid) * kVec;
    const uint32_t add = pre + off[g];
    if (vec && i0 + kVec <= P) {
      *reinterpret_cast<uint4*>(yr + i0) =
          make_uint4(v[g][0] + add, v[g][1] + add, v[g][2] + add, v[g][3] + add);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (i0 + e < P) yr[i0 + e] = v[g][e] + add;
    }
  }
}

long long tiles_of(long long P) { return (P + kTile - 1) / kTile; }

}  // namespace

// Bytes of scratch grt_multi_cumsum_i32 needs for (C, P): a status word per
// tile and channel, and the tile counter.
extern "C" long long grt_scan_scratch_bytes(int C, long long P) {
  return 8 * ((long long)C * tiles_of(P) + 1);
}

// x, y: (C, P) int32 row-major; scratch: grt_scan_scratch_bytes(C, P) bytes,
// 8-byte aligned (zeroed here, on the stream, before the scan).
extern "C" int grt_multi_cumsum_i32(const void* x, void* y, void* scratch, int C, long long P,
                                    void* stream) {
  if (C < 0 || C > 65535 || P < 0) return (int)cudaErrorInvalidValue;
  if (C == 0 || P == 0) return 0;
  const long long tiles = tiles_of(P);
  if ((long long)C * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, grt_scan_scratch_bytes(C, P), s);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<(unsigned)(C * tiles), kThreads, 0, s>>>(
      (const uint32_t*)x, (uint32_t*)y, (unsigned long long*)scratch, P, (int)tiles);
  return (int)cudaGetLastError();
}

// What a launch of the scan runs, without launching: out[0] resident blocks
// per SM, out[1] static shared memory bytes, out[2] registers per thread,
// out[3] local memory bytes per thread.
extern "C" int grt_scan_info(int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, scan_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], scan_kernel, kThreads, 0);
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return (int)err;
}
