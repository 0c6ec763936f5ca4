// Kernel K1: fused forward march of the sorted pair stream (device code,
// shared by march.cu, the SH degree 0 entry point, and march_sh{1,2,3}.cu,
// the SH degree 1-3 instantiations, so that nvcc builds them in parallel).
//
// Replaces the Pallas kernel `_march_kernel` (wrapper `pallas_march_stream`)
// of gaussian_ray_tracing_tpu/ops/pallas_march.py: SH degree 0 to 3, in
// window, key or merge order, with one of three responses (Resp): the quad
// response from a shared ray origin (full [t_min, t_max] rays, or segments
// with per-ray windows and a carry-in), the scalar response from per-ray
// origins (rolling shutter on the pair stream; bounced rays over the
// Morton-block table; see "Segments" below; training, every ray's origin
// the eye or its own) or the quad response from per-ray origins, expanded
// around the tile's origin centroid (rolling-shutter renders and training;
// see "Per-ray-origin quad" below). The semantics, per-tile decisions
// included, are those of ops/march.py, whose plain torch version
// `march_plain` is the reference this kernel is tested against. The three
// orders are three __global__ functions: `march_kernel` (window),
// `march_key_kernel` (key) and `march_merge_kernel` (merge, render only; see
// "Merge order" below), each instantiated per staging capacity C in {32,
// 64, 128, 256} (window and merge order march chunks of C; key order any
// chunk c, on the smallest C >= c: staging_chunk), response, SH
// coefficient count K = (degree + 1)^2 in {1, 4, 9, 16} and kTrain, the
// saved carries of the training forward on the training rows (built for
// the key kernel on every response and the window kernel on the scalar
// one), each in a 256-ray, a 1024-ray and a cluster build (kMaxR).
//
// Tiles of more than 1024 rays (any multiple of 128), with the 1024-ray
// build's registers and local lists: the tile is a thread-block cluster of
// cluster_blocks(R) <= 8 blocks (the portable cluster size), each over a slice
// of cluster_width(R) rays (a multiple of 128, so that a 128-ray fire group of
// sort_lane_groups lies in one block; lanes past R are idle, dead rays with no
// output; the cluster builds, kMaxR = kClusterR). Up to 8192 rays one thread
// marches one ray. Above, each thread marches cluster_slots(R) = ceil(R /
// 8192) rays in turn (slot s: ray s * 8192 + rank * 1024 + thread; `multi`,
// a runtime value of the same builds), one ray's lists in local memory at a time:
// its T, colour and counts wait in device memory between its turns
// (Params::carry, (scratch_tiles, fields, R), sized by carry_fields), where
// local memory would be reserved for every resident thread of the card
// times the slots. Merge order's cluster build is a kernel of its own
// (march_merge_cluster_kernel), whose pending buffers stay in that scratch
// through the launch. Each block stages the chunk's rows in
// its own shared memory, once for all its slots. Every decision that spans the
// tile is made tile-wide through distributed shared memory (tile_reduce: the
// block's value, then the blocks' in rank order, exact as a min or max), each
// thread's slots folded first: the chunk skip, the window fire vote and key
// range and the band's ends where the fire group is the tile, the stats
// maxima, merge order's fast test. Where a vote must come before a ray's list
// is used (window order's fire test over the tile, merge order's fast test), a
// thread of several slots evaluates each slot's candidates once for the vote
// and once more past it (pass 1 again), rather than hold several lists;
// 128-ray fire groups vote within their block and slot as the slot comes. The
// per-ray-origin centroid sums the plain version's halving tree over all R
// origins in every block (origin_centroid_tile: its first levels as the
// origins are read, the rest in shared memory), so o_bar is the plain
// version's tree bit for bit though the tree's first levels cross blocks and
// slots (torch on the card divides the sum by R as a product with 1 / R, an
// ulp apart for some R). A cluster that the card cannot schedule fails at
// launch (and in the info query), never on a smaller build.
//
// Window order. One block per 16x16 tile, one thread per ray (R =
// blockDim.x; a 256-ray build, __launch_bounds__(256, 4), for the main
// path's tiles and a 1024-ray one). The tile's chunks of C candidates are
// staged in dynamic shared memory as rows of W floats (k1::Layout) by
// 16-byte cp.async copies (coalesced, each row read by every ray of the
// tile); where two buffers fit in 48 KB, chunk j+1's rows are copied while
// chunk j is marched (a tile that skips chunk j+1 never reads them). Per
// chunk:
//   1. tile-wide chunk skip: block max of T against the skip threshold;
//   2. pass 1: each ray evaluates its C candidates once: a sure miss
//      (sure_miss, against a per-row threshold computed once per chunk)
//      stops before the division and the exp, any other miss at alpha,
//      before the sqrt and the second division of the event t. A dead ray
//      (zero direction), whose a is 0 on every candidate, lists nothing and
//      skips the pass, so a warp of dead rays skips the chunk (in block
//      mode, where dd = 0 keeps a dead ray from the sure-miss test, a dead
//      lane used to hold its warp on the divide and the exp). It keeps the
//      significant (a > 0) ones, in stream order, in local memory: order
//      key (the event t, or t* under the peak key), alpha, source index (9
//      bytes each, none for a miss), and records whether it sees an
//      inversion among them, plus its significant key range;
//      __syncthreads_or decides the window-sort fire for the whole tile,
//      block min/max the key range;
//   3. pass 2 reads the significant candidates only: an unfired chunk
//      composites them in stream order with float32 colours; a fired chunk
//      insertion-sorts (key tq16 << 15 | a15, source index) in place of the
//      order keys (the depth-presorted stream is nearly ordered, so few
//      shifts), or in block mode, whose lists come in Morton order and so
//      in no depth order (about ns^2 / 4 inversions a ray), computes every
//      key and merge-sorts them (block_sort: a cost set by ns, not by the
//      order), and composites that list with decoded alphas and each
//      colour through the 3x10-bit pack, as the TPU kernel's sorted payload
//      does (pallas_march.py:832).
//   The render options (Params; pallas_march.py:775-796, 858-937):
//   sort_lane_groups makes the fire vote (group_or: a warp vote, then the
//   group's warps in shared memory) and the key range (group_reduce) per
//   group of 128 rays, 4 warps, where the TPU's lane groups are its
//   128-lane vregs; the chunk skip stays tile-wide. sort_alpha_min counts
//   only candidates with a > a_fire in the inversion test and its running
//   max. Its span repair: pass 1 also keeps i1, the last significant
//   candidate below that running max; a reverse walk of the list gives i0,
//   the first above the least key after it; both are reduced over the
//   group, and where i1 - i0 < w a fired chunk insertion-sorts only the run
//   of the list whose sources lie in [min(i0, C - w), + w), the rest in
//   stream order. With a_fire 0 the band covers every out-of-place
//   candidate, so the whole list is sorted (the same order) and the band is
//   only computed for `stats`: per tile, the most fired and repaired chunks
//   of any group, JAX's stats=True. All threads reach every barrier: the
//   group reductions run when any group of the block fired. The peak key
//   orders by t*, and on full-range rays of the quad response takes key
//   order's sqrt-free gate (window and merge order); composite_scan
//   (Composite) multiplies the running product in sequence, in every order.
//   The 256-ray build runs two blocks per SM (blocks_per_sm), so that
//   the stored candidates of their rays stay in L1.
// Window order with saved carries (the training forward, pallas_march.py:
// 803-842): the carry-in is saved before the skip test, the skip threshold
// is min_transmittance, and a fired chunk lists its significant candidates
// by the unique key (tq16 << 8) | src (with the compact index for src: the
// same order), with each candidate's EXACT alpha and the 10-bit colour
// pack; the render options are off (one fire group, every significant
// candidate in the test, no span repair, the log form), the peak key not.
// The backward
// (csrc/march_bwd.cuh) replays the same order from the same arithmetic.
//
// Colour (pallas_march.py:640-669). SH degree 0 reads the colour
// max(0.5 + C0 sh0, 0) precomputed per gaussian (quad rows) or computed
// where it is read (scalar rows). Degrees 1-3 evaluate, per (ray, candidate),
// max(0.5 + sum_k basis_k(d) sh_k, 0) per channel, k = 0..K-1 added in turn,
// from the K-term basis of the ray's direction computed once per ray in
// registers (ops/sh.sh_basis_list, term for term) and the row's raw
// coefficients sh_r[K], sh_g[K], sh_b[K]. The TPU kernel's `sh_mxu` bf16
// hi/lo MXU split of the same sum is TPU layout and not ported.
//
// Key order (pallas_march.py:552-569, 963-968). The window kernel's block
// layout, staging (double-buffered where two buffers fit in 48 KB) and
// sure-miss test against the per-row thresholds (on the scalar response
// also a dead ray's exit there), with a 256-ray build beside the 1024-ray
// one; one evaluation per candidate with, on
// full-range rays, the sqrt-free gate alpha > alpha_min & (t* >= t_lo |
// q(t_lo) < 0), composited in stream order with float32 colours, no fire
// test and no sort. The chunk c is a runtime value (Params::chunk; JAX takes
// any max(32, min(march_chunk, 256)), and in block mode chunk *
// bounce_blocks_per_chunk, e.g. 512): a chunk of more than C candidates is
// staged in pieces of at most C rows (stage_piece), one Composite over the
// whole chunk, so the chunk skip, the saved carry and the composite's
// restart follow c, never the staging size. With saved carries (`tin`
// non-null, the training forward) each chunk's carry-in T is stored BEFORE
// its skip test at row chunk_base[tile] + j, so skipped chunks are saved
// too and the backward (csrc/march_bwd.cuh) can replay every chunk; the
// skip threshold is then min_transmittance. The prefix of log1p(-a) is
// summed sequentially per ray, in the order the backward sums it.
//
// Merge order (pallas_march.py:352-363, 677-742, 974-982), the same block
// layout, staging, response, gate, sure-miss test and colour code, but the
// TPU kernel's bitonic sort and merge networks replaced by per-thread
// lists. Each ray keeps two buffers of C slots in local memory, swapped by
// index: the pending buffer, ascending by key, and the chunk's. A slot
// holds a key and, if significant (a > 0), the exact alpha and the 3x10-bit
// colour pack (the chunk's by source index, the pending buffer's by slot);
// which slots are significant is one bitmask per buffer in shared memory,
// word-major ([2][C / 32][R], so that lanes at different slots never
// conflict). Before the first marched chunk the pending buffer is C empties
// (INT32_MIN keys, alpha 0): a block-uniform flag stands for them and
// nothing is written. Per chunk, after the tile-wide skip:
//   1. pass 1 evaluates each candidate once (a sure miss stops before the
//      divide and the exp, any other miss at alpha): kb = bits(max(t_event,
//      0)) & ~0xFF for a significant candidate, else the running max of the
//      significant kb before it (INT32_MIN before the first; tail slots past
//      the segment too), OR the source index, inserted into the chunk's
//      sorted keys as it comes (a chunk without inversions: no shift); a
//      significant candidate's alpha and pack are stored and its bit set;
//   2. the fast test, TILE-WIDE (__syncthreads_and): no ray sees a
//      significant kb below the running max, and every ray's least
//      significant kb is at or above pend_max, the largest key of its
//      significant pending slots (a scalar: the buffer ascends). It decides
//      what composites before the next chunk's skip test, so a per-ray
//      choice would change skips, not only rounding;
//   3. fast: the pending buffer's significant slots composite (its mask's
//      set bits, in slot order) and the chunk, whose sorted order is then
//      its stream order, becomes the pending buffer by the swap;
//   4. slow: two pointers over the pending buffer and the sorted chunk
//      (pending first on equal keys): the C smallest of the union composite,
//      the C largest are written in place into pending slots already read.
//      Every slot, significant or not, counts toward the C smallest. A
//      fresh buffer's C empties are the C smallest, so its first slow chunk
//      only writes the sorted chunk.
// Every composited colour goes through the pack; alphas are exact. After
// the last chunk the pending buffer's significant slots composite (T only
// moves while T > min_t). The TPU's bitonic merge duplicates one payload on
// equal keys between pending and chunk (the same kb and source index in
// two chunks); this kernel and march_plain keep both, pending first. The
// 256-ray build runs two blocks per SM (blocks_per_sm). Above 1024 rays
// march_merge_cluster_kernel gives the same results from other lists: only
// the chunk's significant candidates listed (sorted among themselves), its
// insignificant keys generated in the walk, and above 8192 rays each
// slot's pending buffer in Params::carry (see there).
//
// Rows (`stride` floats apart). Quad: at SH 0 the 16-float compact rows
// [op, q00 q11 q22 q01 q02 q12, vx vy vz, cq, oo, r g b, pad] or the
// 32-float training rows, whose first 16 floats are those; at SH 1-3
// [op, q (6), v (3), cq, oo, sh_r[K], sh_g[K], sh_b[K]] (W = 12 + 3K).
// Scalar: [op, 15 unused, mean (3), M (9), radius, sh_r[K], sh_g[K],
// sh_b[K]], staged as [op, 3 unused, mean, M, radius, sh0 or coefficients]
// (W = 20 at SH 0, 4 + 13 + 3K padded to 4 above; Layout). The training
// rows, which the saved-carry kernels and the per-ray-origin quad response
// read (and only they), are the scalar rows with the quad columns in 1..11
// (and at SH 0 the colour in 12..14), so the quad kernels on them read the
// SH 1-3 coefficients from column 29 (kTrainSh), and the per-ray-origin
// quad response the mean from 16 and the radius from 28.
//
// Segments and per-ray origins (the mesh tracer and the rolling shutter,
// pallas_march.py:236-241, 407-442, 586-633). Optional per-ray arrays,
// each null for the primary render: a window [t_lo, t_hi] and a carry-in
// transmittance t0 (T, R), per-ray origins (T, R, 3), and a block list.
// With per-ray origins the kernel evaluates the scalar response unless
// Params::quad asks for the per-ray-origin quad one: o_g = M (o - mu), d_g
// = M d, t* = -od / max(dd, 1e-6) as a true division, pp = oo + t* (2 od +
// t* dd) and the gate with disc >= 0. Whenever a window, origin or block
// array is given the ray is not a full-range ray, and key order uses the
// exact entry/exit event gate instead of the sqrt-free one. Block mode
// (bounced rays over the Morton-sorted table): with bs = C / block_sub,
// chunk j of tile t stages rows [blocks[start/bs + j*block_sub + s] * bs, +
// bs) for s < block_sub, so a chunk reads block_sub whole blocks.
//
// Per-ray-origin quad (pallas_march.py:378-405, 525-548; on the training
// rows and the pair stream, 256- and 1024-ray builds). Q = M^T M is
// view-independent, so the response expands around the tile's origin
// centroid o_bar, where every product stays small: each block first sums
// its R origins as a halving tree in the staging memory and divides by R
// (origin_centroid, the order of ops/march.origin_centroid); each ray keeps
// a = o - o_bar, od6(a, d) and oo6(a) in registers (origin_quad_ray); each
// staged row gets Qb, radius^2 and b^T Q b with b = mu - o_bar, once per
// chunk, in place of the eye's columns (origin_quad_row); each (ray,
// candidate) pair then costs the quad form's dd plus two 6-term and two
// 3-term sums for od and oo, before the same sure-miss test, alpha and
// exact event gate as the shared-origin quad response.
//
// What bounds it on an H100: not memory (each row is read once per tile
// and reused by 256 rays) but per-(ray, candidate) work (the per-ray-origin
// quad response: ~20 more operations per pair than the shared-origin one,
// the scalar response ~30 more). In window order:
// one evaluation of every candidate of a live ray (a sure miss costs
// neither the divide nor the exp, another miss one of each, a candidate
// past alpha_min a sqrt and a second divide besides); for each significant
// candidate (30-47% of the pairs on the main path's streams, 2-16% on the
// mesh bounces, PERF.md) the composite's exp and log1p, in the fired
// chunks (83-99% of them; 26-57% in block mode) the 3x10-bit pack and the
// sort, and the local-memory traffic of the stored candidates and of the
// lists (kept in L1 by running two blocks per SM); at SH 1-3 a 3K-term
// colour per significant candidate. On the mesh bounces a few tiles march
// up to 16-51 chunks, one after the other: their chain sets much of a
// launch's time (PERF.md). In key order one evaluation (a sure miss
// without the divide and the exp, any other candidate with one of each),
// plus the colour; in merge order the window kernel's one
// evaluation, and in a slow chunk (87-97% of the marched chunks on the
// render streams, 27-45% on the mesh bounces) the walk of 2C steps, each
// a key read at a slot that differs from lane to lane, and the moves of
// the significant slots' alphas and packs: 24 C bytes of local memory per
// ray, more than L1 holds, so the walk's scattered reads decide the time
// (PERF.md). On wide tiles 85-96% of a ray's candidates are insignificant
// and the insertion shifted each out-of-order significant key past them
// (122-361 shifts a ray and chunk at c = 128): the cluster build lists the
// significant ones alone (PERF.md). The float math stays IEEE float32 with
// no FMA contraction (the
// wrapper builds with -fmad=false): pp = oo - od^2/dd cancels by orders of
// magnitude, and matching the plain version's per-operation rounding keeps
// kernel and reference comparable. No tensor cores and no TF32 anywhere.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace k1 {

namespace cg = cooperative_groups;

constexpr float kInvA = (float)(1.0 / 32767.0);
constexpr float kInvCol = (float)(1.0 / 255.75);

// SH band constants (ops/sh.py), each the float nearest its double
constexpr float kC0 = (float)0.28209479177387814;
constexpr float kC1 = (float)0.4886025119029199;
constexpr float kC2_0 = (float)1.0925484305920792;
constexpr float kC2_1 = (float)-1.0925484305920792;
constexpr float kC2_2 = (float)0.31539156525252005;
constexpr float kC2_3 = (float)-1.0925484305920792;
constexpr float kC2_4 = (float)0.5462742152960396;
constexpr float kC3_0 = (float)-0.5900435899266435;
constexpr float kC3_1 = (float)2.890611442640554;
constexpr float kC3_2 = (float)-0.4570457994644658;
constexpr float kC3_3 = (float)0.3731763325901154;
constexpr float kC3_4 = (float)-0.4570457994644658;
constexpr float kC3_5 = (float)1.445305721320277;
constexpr float kC3_6 = (float)-0.5900435899266435;

// first SH coefficient column of the training rows (ops/march.T_SH0)
constexpr int kTrainSh = 29;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// The response a kernel evaluates: the quad form from the shared eye's
// columns, the scalar form from per-ray origins, or the quad form from
// per-ray origins, expanded around the tile's origin centroid.
enum Resp { kQuad = 0, kScalar = 1, kOriginQuad = 2 };

// Staged row layout: each staged row is two runs of a source row's
// columns, [0, a) and then [b, b + w - a), each a whole number of 16-byte
// groups, so that a chunk is staged by 16-byte cp.async copies. Quad rows:
// their first a columns (12 + 3K padded, or the 16 compact columns); the
// quad training rows at SH 1-3 add the radius and coefficients from column
// 28 (the coefficients at staged column 13). Scalar (and training) rows:
// [op, 3 unused, mean (3), M (9), radius, sh0 or coefficients] from columns
// 0..3 and 16..; at SH 0 the colour max(0.5 + C0 sh0, 0) is taken where it
// is read (row_color), so the copy moves the raw floats. Per-ray-origin
// quad (training rows): columns 0..19 (op, q, the eye's v, cq, oo, the SH 0
// colour, mean at 16..18) and from 28 the radius (staged column 20) and the
// coefficients (21); stage_chunk overwrites the unused v, cq, oo with Qb,
// radius^2 and b^T Q b (origin_quad_row).
template <int kR, int K, bool kTrain>
struct Layout {
  static constexpr int a =
      kR == kScalar ? 4 : kR == kOriginQuad ? 20 : (K == 1 ? 16 : (kTrain ? 12 : pad4(12 + 3 * K)));
  static constexpr int b = kR == kScalar ? 16 : 28;
  static constexpr int w = kR == kScalar       ? 4 + pad4(13 + 3 * K)
                           : kR == kOriginQuad ? 20 + pad4(1 + 3 * K)
                                               : (K == 1 || !kTrain ? a : 12 + pad4(1 + 3 * K));
  static constexpr int col = kR == kScalar ? 17
                             : kR == kOriginQuad ? (K == 1 ? 12 : 21)
                                                 : (K > 1 && kTrain ? 13 : 12);  // colour column
};
// staged scalar columns: mean, M, radius
constexpr int kMean = 4, kMat = 7, kRad = 16;
// staged per-ray-origin quad columns: mean, radius
constexpr int kOqMean = 16, kOqRad = 20;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// least row stride (floats) the kernel reads, in whole 16-byte groups: the
// staged quad columns, or the scalar (or training) rows' 29 + 3K (the
// 32-float training rows at SH 0)
inline int min_stride(bool scalar_or_train, int K) {
  return scalar_or_train ? pad4(kTrainSh + 3 * K) : (K == 1 ? 16 : pad4(12 + 3 * K));
}

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
  int quad;               // with origins: the per-ray-origin quad response
  // window_key "peak": window and merge order key on t*, and on full-range
  // rays of the quad response take the sqrt-free gate (saved carries too)
  int peak;
  int scan;               // composite_scan: the product-form composite (render only)
  int group;              // rays per fire group, window order: R, or 128 (sort_lane_groups)
  float a_fire;           // sort_alpha_min: the fire test's candidates have a > a_fire
  int repair;             // sort_repair's band width w, 0 < w < C (render), else 0
  int* stats;             // (T, 2) fired and repaired chunks per tile, or null (render)
  int R;                  // rays per tile (the cluster builds' tile; blockDim.x up to 1024)
  int chunk;              // candidates a chunk: the key kernel's c; C in window and merge order
  // (scratch_tiles, fields, R) floats: each ray's carried state between its
  // turns where a thread marches several rays (cluster_slots(R) > 1;
  // carry_fields), else null
  float* carry;
  // tiles the scratch holds (carry; K3's acc and carry too): cluster_launch
  // runs more tiles as launches of at most this many, tile0 the first tile
  // of each (the scratch's tile 0)
  int scratch_tiles, tile0;
};

// A tile of more than 1024 rays (any multiple of 128) is a thread-block
// cluster of cluster_blocks(R) <= 8 blocks (the portable cluster size) of
// cluster_width(R) threads, each thread marching cluster_slots(R) rays in
// turn: slot s of the tile is its rays [s * span, + span), span = blocks *
// width, and block `rank` holds rays [s * span + rank * width, + width) of
// it, a multiple of 128 rays, so that sort_lane_groups' groups of 128 rays
// lie in one block and one slot. Up to kClusterR = 8192 rays one slot (one
// ray a thread); above, 8 blocks of 1024 threads and ceil(R / 8192) slots,
// the last one uneven. Lanes past R are idle (a ray of zero direction,
// which no candidate reaches, and no output).
constexpr int kClusterR = 8192;
__host__ __device__ constexpr int cluster_blocks(int R) {
  return R > kClusterR ? 8 : (R + 1023) / 1024;
}
__host__ __device__ constexpr int cluster_width(int R) {
  return R > kClusterR ? 1024
                       : (R + 128 * cluster_blocks(R) - 1) / (128 * cluster_blocks(R)) * 128;
}
__host__ __device__ constexpr int cluster_slots(int R) { return (R + kClusterR - 1) / kClusterR; }
// Floats of a cluster build's static red[]: four reductions of 32 warps, then
// the 2 x 4 exchange slots of tile_reduce.
constexpr int kClusterRed = 4 * 32 + 8;

// The tile of this block, its rays and this thread's ray in it (its slot
// 0): one block per tile up to 1024 rays; a cluster above (kCl, p.R rays a
// tile), whose threads march `slots` rays each, `span` rays apart. K1's and
// K3's Params alike.
struct TileIdx {
  int tile, R, ray;
  bool valid;  // a ray of the tile (false on a cluster's idle lanes)
  int span, slots;
  __device__ size_t idx() const { return (size_t)tile * R + ray; }
  // this thread's ray of slot s
  __device__ TileIdx slot(int s) const {
    TileIdx t = *this;
    t.ray = ray + s * span;
    t.valid = t.ray < R;
    return t;
  }
};

template <bool kCl, typename P>
__device__ __forceinline__ TileIdx tile_index(const P& p) {
  if constexpr (kCl) {
    const cg::cluster_group cl = cg::this_cluster();
    const int n = (int)cl.num_blocks();
    const int ray = (int)cl.block_rank() * blockDim.x + threadIdx.x;
    const int span = n * (int)blockDim.x;
    return {p.tile0 + (int)blockIdx.x / n, p.R, ray, ray < p.R, span, (p.R + span - 1) / span};
  } else {
    return {(int)blockIdx.x, (int)blockDim.x, (int)threadIdx.x, true, (int)blockDim.x, 1};
  }
}

// Field f of ray t's carried state between its turns, where a thread
// marches several rays (Params::carry, (scratch_tiles, fields, R) from the
// launch's first tile: field-major, so that a warp's rays are adjacent).
// Only valid rays have one.
template <typename P>
__device__ __forceinline__ float& carried(const P& p, const TileIdx& t, int fields, int f) {
  return p.carry[((size_t)(t.tile - p.tile0) * fields + f) * t.R + t.ray];
}

// The reduction of v over this thread's fire group, the gw warps from warp
// w0 = warp - warp % gw, in warp order (gw = blockDim.x / 32: the block,
// block_reduce). All threads of the block must call this.
__device__ __forceinline__ float group_reduce(float v, bool take_max, float* red, int gw) {
  for (int o = 16; o > 0; o >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = take_max ? fmaxf(v, u) : fminf(v, u);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red[] may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int w0 = warp - warp % gw;
  v = red[w0];
  for (int w = w0 + 1; w < w0 + gw; ++w) v = take_max ? fmaxf(v, red[w]) : fminf(v, red[w]);
  return v;
}

// All threads of the block must call this; returns the reduction to all.
__device__ __forceinline__ float block_reduce(float v, bool take_max, float* red) {
  return group_reduce(v, take_max, red, blockDim.x >> 5);
}

// The fire vote of fire groups of gw warps: whether any thread of this
// thread's group has `inv` (group), and, returned, whether any thread of
// the block has. All threads of the block must call this.
__device__ __forceinline__ bool group_or(bool inv, float* red, int gw, bool& group) {
  const bool warp_any = __any_sync(0xffffffffu, inv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = warp_any ? 1.f : 0.f;
  __syncthreads();
  const int w0 = warp - warp % gw;
  bool any = false;
  group = false;
  for (int w = 0; w < n_warps; ++w) {
    any |= red[w] != 0.f;
    if (w >= w0 && w < w0 + gw) group |= red[w] != 0.f;
  }
  return any;
}

// The tile-wide reduction of N <= 4 values, each a max (take_max[k]) or a
// min, into every thread of the tile. One block: block_reduce of each. A
// cluster: each block's warps in warp order (red[32 k + warp]), then the
// blocks' in rank order, read through distributed shared memory from each
// block's exchange slots (red + 128: two sets of 4, alternating with
// `par`, so that one cluster barrier per exchange keeps a slot from being
// rewritten while another block still reads it: the next write to a slot
// comes after the next exchange's barrier). Every thread of every block of
// the tile must call it; the kernel ends with a cluster barrier, so that no
// block leaves while another reads its slots. A min or max is exact in any
// order, so each block of a cluster holds the value one block would.
template <bool kCl, int N>
__device__ __forceinline__ void tile_reduce(float (&v)[N], const bool (&take_max)[N], float* red,
                                            int& par) {
  if constexpr (!kCl) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = block_reduce(v[k], take_max[k], red);
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k)
      for (int o = 16; o > 0; o >>= 1) {
        const float u = __shfl_xor_sync(0xffffffffu, v[k], o);
        v[k] = take_max[k] ? fmaxf(v[k], u) : fminf(v[k], u);
      }
    float* xch = red + 4 * 32 + 4 * par;
    __syncthreads();  // red[] may still be read by a previous reduction
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < N; ++k) red[32 * k + warp] = v[k];
    __syncthreads();
    if (threadIdx.x == 0)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float s = red[32 * k];
        for (int w = 1; w < n_warps; ++w)
          s = take_max[k] ? fmaxf(s, red[32 * k + w]) : fminf(s, red[32 * k + w]);
        xch[k] = s;
      }
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    const int n = (int)cl.num_blocks();
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = cl.map_shared_rank(xch, 0)[k];
      for (int r = 1; r < n; ++r) {
        const float u = cl.map_shared_rank(xch, r)[k];
        s = take_max[k] ? fmaxf(s, u) : fminf(s, u);
      }
      v[k] = s;
    }
    par ^= 1;
  }
}

// tile_reduce of one value.
template <bool kCl>
__device__ __forceinline__ float tile_reduce1(float v, bool take_max, float* red, int& par) {
  float x[1] = {v};
  const bool m[1] = {take_max};
  tile_reduce<kCl>(x, m, red, par);
  return x[0];
}

// The end of a cluster build: no block leaves while another may still read
// its exchange slots.
template <bool kCl>
__device__ __forceinline__ void tile_end() {
  if constexpr (kCl) cg::this_cluster().sync();
}

__device__ __forceinline__ uint32_t pack_color(float r, float g, float b) {
  auto q = [](float x) { return (uint32_t)fminf(fmaxf(x * 255.75f, 0.f), 1023.f); };
  return (q(r) << 20) | (q(g) << 10) | q(b);
}

// The K-term SH basis of direction (x, y, z) with the band constants and
// signs, in ops/sh.sh_basis_list's order and association.
template <int K>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = kC0;
  if (K >= 4) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if (K >= 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    b[4] = kC2_0 * xy;
    b[5] = kC2_1 * yz;
    b[6] = kC2_2 * (2.f * zz - xx - yy);
    b[7] = kC2_3 * xz;
    b[8] = kC2_4 * (xx - yy);
    if (K >= 16) {
      b[9] = kC3_0 * y * (3.f * xx - yy);
      b[10] = kC3_1 * xy * z;
      b[11] = kC3_2 * y * (4.f * zz - xx - yy);
      b[12] = kC3_3 * z * (2.f * zz - 3.f * xx - 3.f * yy);
      b[13] = kC3_4 * x * (4.f * zz - xx - yy);
      b[14] = kC3_5 * z * (xx - yy);
      b[15] = kC3_6 * x * (xx - 3.f * yy);
    }
  }
}

// max(0.5 + sum_k b_k c_k, 0), k added in turn
template <int K>
__device__ __forceinline__ float sh_channel(const float* c, const float* b) {
  float acc = 0.5f + b[0] * c[0];
#pragma unroll
  for (int k = 1; k < K; ++k) acc = acc + b[k] * c[k];
  return fmaxf(acc, 0.f);
}

// Colour of the staged row whose colour columns start at f, for the ray
// whose basis is `basis` (unused at SH 0, where a quad row holds the colour
// and a scalar row sh0).
template <bool kScalarRow, int K>
__device__ __forceinline__ void row_color(const float* f, const float* basis, float& r, float& g,
                                          float& b) {
  if (K == 1 && kScalarRow) {
    r = fmaxf(0.5f + kC0 * f[0], 0.f);
    g = fmaxf(0.5f + kC0 * f[1], 0.f);
    b = fmaxf(0.5f + kC0 * f[2], 0.f);
  } else if (K == 1) {
    r = f[0];
    g = f[1];
    b = f[2];
  } else {
    r = sh_channel<K>(f, basis);
    g = sh_channel<K>(f + K, basis);
    b = sh_channel<K>(f + 2 * K, basis);
  }
}

struct Ray {
  float dx, dy, dz;
  float m0, m1, m2, m3, m4, m5;  // dx^2, dy^2, dz^2, 2dxdy, 2dxdz, 2dydz
  float ox, oy, oz;              // per-ray origin (scalar response)
  float t_lo, t_hi;              // segment window
  bool live;
  // per-ray-origin quad: a = o - o_bar, od6(a, d) and oo6(a) (origin_quad_ray)
  float ax, ay, az, od6[6], oo6[6];
};

__device__ __forceinline__ float effective_alpha(float alpha, int hm) {
  if (hm == 1) return alpha;
  const float om = 1.f - alpha;
  float pw = om;
  for (int k = 1; k < hm; ++k) pw *= om;
  return 1.f - pw;
}

// Global row of candidate k of the tile whose segment starts at `start`,
// marched in chunks of c: the stream slot, or in block mode (bs = c /
// block_sub rows a block) row k % bs of the tile's listed block k / bs.
__device__ __forceinline__ size_t row_index(const Params& p, int start, int k, int c) {
  if (!p.blocks) return (size_t)start + k;
  const int bs = c / p.block_sub;
  return (size_t)p.blocks[start / bs + k / bs] * bs + k % bs;
}

// Start the copy of the tile's candidates [k0, k0 + m) (chunks of c) into
// sf (Layout's runs, one 16-byte cp.async per group, the row's global index
// computed per group of 4 floats) and commit it as one group; cp_async_wait
// and a __syncthreads make it visible.
template <int kR, int K, bool kTrain>
__device__ __forceinline__ void stage_async(float* sf, const Params& p, int start, int k0, int c,
                                            int m) {
  using L = Layout<kR, K, kTrain>;
  constexpr int G = L::w / 4, GA = L::a / 4;  // 16-byte groups per staged row, in run 1
  for (int k = threadIdx.x; k < m * G; k += blockDim.x) {
    const int r = k / G, q = k - r * G;
    const float* g = p.feats + row_index(p, start, k0 + r, c) * p.stride;
    cp_async16(sf + r * L::w + 4 * q, g + (q < GA ? 4 * q : L::b + 4 * (q - GA)));
  }
  cp_async_commit();
}

// A sure miss, before the division and the exp. With D = max(dd, 1e-6),
// the kernel's pp is oo - od^2 / D to within 6 ulp of |oo| (pp = oo - od^2
// / dd cancels; the scalar form only for dd >= 1e-6, where its pp is the
// same quotient), and a candidate whose pp reaches L = 2 ln(op /
// alpha_min) has alpha <= alpha_min (expf within 2 ulp). So oo D - od^2 >
// (thr + 2e-6 |oo|) D, with thr = L + 1e-4 (miss_threshold; the 2e-6 |oo|
// and the 1e-4 cover every rounding of both sides, of logf and expf, with
// room), proves a miss: a = 0 and t_ev 0 exactly as the full evaluation
// would give, so no result changes. NaNs fail the test.
__device__ __forceinline__ bool sure_miss(float oo, float od, float D, float thr) {
  return oo * D - od * od > (thr + 2e-6f * fabsf(oo)) * D;
}

// thr of a row of opacity op for sure_miss.
__device__ __forceinline__ float miss_threshold(float op, float alpha_min) {
  return 2.f * logf(op / alpha_min) + 1e-4f;
}

// Quad response (shared origin): order key and gated effective alpha.
// fast_gate: key order, or window and merge order under the peak key, on a
// full-range ray: the sqrt-free gate alpha > alpha_min & (t* >= t_lo |
// q(t_lo) < 0), key t* (pallas_march.py:561-569); else the exact entry/exit
// event gate t_lo <= t_event <= t_hi, key t_event, or t* with `peak`
// (pallas_march.py:672-675). kMiss: first the sure-miss
// test against the row's threshold thr (kDead: a dead ray too, whose a is 0
// whatever the row, so that it never holds its warp on the full path).
// Then alpha: a candidate at or below alpha_min (most of them) or a dead
// ray stops there, with t_ev 0, unread; the others take the sqrt and the
// second division, the same operations as ever, so every value that is
// used is unchanged.
//
// kOrig: the per-ray-origin quad response (pallas_march.py:378-405,
// 525-548) on a row that origin_quad_row prepared, from the ray's
// origin_quad_ray terms: od = q . od6(a, d) - (Qb) . d, oo = q . oo6(a) -
// 2 (Qb) . a + b^T Q b, cq = oo - radius^2, each summed left to right as
// ops/march._origin_quad sums it. Never on the fast gate (not full range).
template <bool kMiss, bool kDead, bool kOrig = false>
__device__ __forceinline__ void eval_quad(const Params& p, const Ray& ray, const float* f,
                                          bool fast_gate, bool peak, float thr, float& t_ev,
                                          float& a) {
  const float dd = f[1] * ray.m0 + f[2] * ray.m1 + f[3] * ray.m2 + f[4] * ray.m3 +
                   f[5] * ray.m4 + f[6] * ray.m5;
  float od, cq, oo;
  if (kOrig) {
    od = f[1] * ray.od6[0] + f[2] * ray.od6[1] + f[3] * ray.od6[2] + f[4] * ray.od6[3] +
         f[5] * ray.od6[4] + f[6] * ray.od6[5] - (f[7] * ray.dx + f[8] * ray.dy + f[9] * ray.dz);
    oo = f[1] * ray.oo6[0] + f[2] * ray.oo6[1] + f[3] * ray.oo6[2] + f[4] * ray.oo6[3] +
         f[5] * ray.oo6[4] + f[6] * ray.oo6[5] -
         2.f * (f[7] * ray.ax + f[8] * ray.ay + f[9] * ray.az) + f[11];
    cq = oo - f[10];
  } else {
    od = f[7] * ray.dx + f[8] * ray.dy + f[9] * ray.dz;
    cq = f[10];
    oo = f[11];
  }
  const float D = fmaxf(dd, 1e-6f);
  t_ev = 0.f;
  a = 0.f;
  if (kMiss && ((kDead && !ray.live) || sure_miss(oo, od, D, thr))) return;
  const float rcp6 = 1.f / D;
  const float t_star = -od * rcp6;
  const float pp = oo + od * t_star;
  const float resp = expf(-0.5f * fmaxf(pp, 0.f));
  const float alpha = fminf(p.alpha_clamp, resp * f[0]);
  if (!(ray.live && alpha > p.alpha_min)) return;
  bool gate;
  if (fast_gate) {
    const float q_lo = cq + ray.t_lo * (2.f * od + ray.t_lo * dd);
    gate = t_star >= ray.t_lo || q_lo < 0.f;
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
    gate = t_ev >= ray.t_lo && t_ev <= ray.t_hi;
    if (peak) t_ev = t_star;
  }
  if (gate) a = effective_alpha(alpha, p.hm);
}

// Scalar response in the canonical frame from a staged scalar row, per ray
// origin; always the exact event gate, with disc >= 0, on full-range rays
// too (pallas_march.py:586-633 has no fast gate); the order key t_event, or
// t* with `peak`; the sure-miss test (kMiss, where dd >= 1e-6; kDead as in
// eval_quad) and alpha first, as in eval_quad.
template <bool kMiss, bool kDead>
__device__ __forceinline__ void eval_scalar(const Params& p, const Ray& ray, const float* f,
                                            bool peak, float thr, float& t_ev, float& a) {
  const float* m = f + kMat;
  const float ox = ray.ox - f[kMean], oy = ray.oy - f[kMean + 1], oz = ray.oz - f[kMean + 2];
  const float ogx = m[0] * ox + m[1] * oy + m[2] * oz;
  const float ogy = m[3] * ox + m[4] * oy + m[5] * oz;
  const float ogz = m[6] * ox + m[7] * oy + m[8] * oz;
  const float dgx = m[0] * ray.dx + m[1] * ray.dy + m[2] * ray.dz;
  const float dgy = m[3] * ray.dx + m[4] * ray.dy + m[5] * ray.dz;
  const float dgz = m[6] * ray.dx + m[7] * ray.dy + m[8] * ray.dz;
  const float dd = dgx * dgx + dgy * dgy + dgz * dgz;
  const float od = ogx * dgx + ogy * dgy + ogz * dgz;
  const float oo = ogx * ogx + ogy * ogy + ogz * ogz;
  const float D = fmaxf(dd, 1e-6f);
  t_ev = 0.f;
  a = 0.f;
  if (kMiss && ((kDead && !ray.live) || (dd >= 1e-6f && sure_miss(oo, od, D, thr)))) return;
  const float t_star = -od / D;
  const float pp = oo + t_star * (2.f * od + t_star * dd);
  const float resp = expf(-0.5f * fmaxf(pp, 0.f));
  const float alpha = fminf(p.alpha_clamp, resp * f[0]);
  if (!(ray.live && alpha > p.alpha_min)) return;
  const float cq = oo - f[kRad] * f[kRad];
  const float disc = od * od - dd * cq;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float inv_dd = 1.f / fmaxf(dd, 1e-12f);
  const float t_entry = (-od - sq) * inv_dd;
  const float t_exit = (-od + sq) * inv_dd;
  t_ev = t_entry < ray.t_lo ? t_exit : t_entry;
  if (disc >= 0.f && t_ev >= ray.t_lo && t_ev <= ray.t_hi) a = effective_alpha(alpha, p.hm);
  if (peak) t_ev = t_star;
}

template <int kR, bool kMiss = false, bool kDead = false>
__device__ __forceinline__ void evaluate(const Params& p, const Ray& ray, const float* f,
                                         bool fast_gate, bool peak, float& t_ev, float& a,
                                         float thr = 0.f) {
  if (kR == kScalar)
    eval_scalar<kMiss, kDead>(p, ray, f, peak, thr, t_ev, a);
  else
    eval_quad<kMiss, kDead, kR == kOriginQuad>(p, ray, f, fast_gate, peak, thr, t_ev, a);
}

// Front-to-back composite of one chunk's ordered candidates: p_excl = t0
// exp(s), s the running sum of log1p(-a), or with `scan` (composite_scan,
// render only; pallas_march.py:276-290) p_excl = t0 s, s the running
// product of (1 - a). The TPU takes that product as a log2(c) doubling tree
// over the chunk (_prefix_prod_excl); here one thread per ray multiplies in
// sequence, so the two round differently by a few ulps.
struct Composite {
  float t0, s, frozen, r, g, b;
  bool below, scan;
  __device__ explicit Composite(float t_carry, bool product = false)
      : t0(t_carry), s(product ? 1.f : 0.f), frozen(0.f), r(0.f), g(0.f), b(0.f),
        below(false), scan(product) {}
  __device__ __forceinline__ void add(float a, float cr, float cg, float cb, float min_t) {
    const float p_excl = scan ? t0 * s : t0 * expf(s);
    const float w = p_excl > min_t ? a * p_excl : 0.f;
    r += w * cr;
    g += w * cg;
    b += w * cb;
    const float p_incl = p_excl * (1.f - a);
    if (p_incl <= min_t) {  // first crossing freezes T: max of the below set
      frozen = below ? fmaxf(frozen, p_incl) : p_incl;
      below = true;
    }
    if (scan)
      s = s * (1.f - a);
    else
      s += log1pf(-a);
  }
  __device__ __forceinline__ float t_next() const {
    return below ? frozen : scan ? t0 * s : t0 * expf(s);
  }
};

// Composite one candidate whose colour rides the 3x10-bit pack.
__device__ __forceinline__ void add_packed(Composite& comp, float a, uint32_t cp, float min_t) {
  comp.add(a, (float)((cp >> 20) & 1023u) * kInvCol, (float)((cp >> 10) & 1023u) * kInvCol,
           (float)(cp & 1023u) * kInvCol, min_t);
}

// The ray of thread `ti`; an idle lane of a cluster gets a zero direction
// (a dead ray, whose a is 0 on every candidate) and reads nothing.
__device__ __forceinline__ Ray load_ray(const Params& p, const TileIdx& ti) {
  Ray ray;
  const size_t idx = ti.idx();
  const float* d = p.dirs + idx * 3;
  ray.dx = ti.valid ? d[0] : 0.f;
  ray.dy = ti.valid ? d[1] : 0.f;
  ray.dz = ti.valid ? d[2] : 0.f;
  ray.live = ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz > 0.01f;
  ray.m0 = ray.dx * ray.dx;
  ray.m1 = ray.dy * ray.dy;
  ray.m2 = ray.dz * ray.dz;
  ray.m3 = 2.f * ray.dx * ray.dy;
  ray.m4 = 2.f * ray.dx * ray.dz;
  ray.m5 = 2.f * ray.dy * ray.dz;
  const float* o = p.origins && ti.valid ? p.origins + idx * 3 : nullptr;
  ray.ox = o ? o[0] : 0.f;
  ray.oy = o ? o[1] : 0.f;
  ray.oz = o ? o[2] : 0.f;
  ray.t_lo = p.t_lo_arr && ti.valid ? p.t_lo_arr[idx] : p.t_lo;
  ray.t_hi = p.t_hi_arr && ti.valid ? p.t_hi_arr[idx] : p.t_hi;
  return ray;
}

// The tile's origin centroid o_bar, the mean of its R rays' origins (all
// of them), into every thread: each coordinate summed as a halving tree in
// `s` (3R floats of the staging memory, which launch_mode sizes to hold
// them, before the first chunk is staged;
// with n values left and h = ceil(n / 2), value i < n - h takes value i +
// h), then divided by R, the order of ops/march.origin_centroid.
__device__ __forceinline__ float3 origin_centroid(float* s, const Ray& ray) {
  const int R = blockDim.x, tid = threadIdx.x;
  s[tid] = ray.ox;
  s[R + tid] = ray.oy;
  s[2 * R + tid] = ray.oz;
  __syncthreads();
  for (int n = R; n > 1;) {
    const int h = (n + 1) / 2;
    if (tid < n - h) {
      s[tid] = s[tid] + s[tid + h];
      s[R + tid] = s[R + tid] + s[R + tid + h];
      s[2 * R + tid] = s[2 * R + tid] + s[2 * R + tid + h];
    }
    __syncthreads();
    n = h;
  }
  const float3 ob = make_float3(s[0] / (float)R, s[R] / (float)R, s[2 * R] / (float)R);
  __syncthreads();  // s is staging memory next
  return ob;
}

// The halving tree of origin_centroid_tile: its values left after the
// levels it sums as it reads the origins from device memory (at least one
// level; more until at most kTreeValues are left, so that 3 of them a value
// fit in shared memory whatever R: 48 KB).
constexpr int kTreeValues = 4096;
__host__ __device__ constexpr int tree_values(int R) {
  int n = (R + 1) / 2;
  while (n > kTreeValues) n = (n + 1) / 2;
  return n;
}

// Value i of level L of the halving tree over v[0], v[3], ... (n[q]: the
// values left after q levels, n[0] = R; node (l, x) = node (l - 1, x) +
// node (l - 1, x + n[l]) where x < n[l - 1] - n[l], else node (l - 1, x)):
// the same additions, in the same order, as the levels summed one after
// the other. A walk of the node's tree, left child first, with a stack of
// one entry a level (no recursion: a kernel's stack is sized without it).
__device__ __forceinline__ float halving_value(const float* v, const int* n, int L, int i) {
  int xs[32];      // per level: the node being summed
  float left[32];  // per level: its left child's value, once its right one is being summed
  bool right[32];  // per level: whether its right child is being summed
  int l = L, x = i;
  for (;;) {
    for (; l > 0; --l) {  // down the left children to a value of v
      xs[l] = x;
      right[l] = false;
    }
    float val = v[3 * (size_t)x];
    for (;;) {  // up, adding each finished right child to its left sibling
      if (++l > L) return val;
      if (right[l]) {
        val = left[l] + val;
      } else if (xs[l] < n[l - 1] - n[l]) {
        left[l] = val;
        right[l] = true;
        x = xs[l] + n[l];
        --l;
        break;
      }
    }
  }
}

// origin_centroid of a cluster's tile: every block sums the same tree over
// the tile's R origins, its first levels as they are read from device
// memory (value i + h into value i across the blocks' ray slices and the
// slots: halving_value, down to tree_values(R) values), the later levels in
// its own `s` (3 tree_values(R) floats), so that each block holds the
// plain version's o_bar bit for bit.
__device__ __forceinline__ float3 origin_centroid_tile(float* s, const Params& p,
                                                       const TileIdx& ti) {
  const int R = ti.R;
  int lv[32] = {R};
  int levels = 0;
  do {
    lv[levels + 1] = (lv[levels] + 1) / 2;
    ++levels;
  } while (lv[levels] > kTreeValues);
  const int h0 = lv[levels];
  const float* o = p.origins + (size_t)ti.tile * R * 3;
  for (int i = threadIdx.x; i < h0; i += blockDim.x)
    for (int c = 0; c < 3; ++c)
      s[c * h0 + i] = levels > 1       ? halving_value(o + c, lv, levels, i)
                      : i < R - h0 ? o[3 * i + c] + o[3 * (i + h0) + c]
                                   : o[3 * i + c];
  __syncthreads();
  for (int n = h0; n > 1;) {
    const int h = (n + 1) / 2;
    for (int i = threadIdx.x; i < n - h; i += blockDim.x)
      for (int c = 0; c < 3; ++c) s[c * h0 + i] = s[c * h0 + i] + s[c * h0 + i + h];
    __syncthreads();
    n = h;
  }
  const float3 ob = make_float3(s[0] / (float)R, s[h0] / (float)R, s[2 * h0] / (float)R);
  __syncthreads();  // s is staging memory next
  return ob;
}

// The per-ray terms of the per-ray-origin quad response: a = o - o_bar,
// od6(a, d) and oo6(a) (pallas_march.py:397-405).
__device__ __forceinline__ void origin_quad_ray(Ray& r, float3 ob) {
  r.ax = r.ox - ob.x;
  r.ay = r.oy - ob.y;
  r.az = r.oz - ob.z;
  r.od6[0] = r.ax * r.dx;
  r.od6[1] = r.ay * r.dy;
  r.od6[2] = r.az * r.dz;
  r.od6[3] = r.ax * r.dy + r.ay * r.dx;
  r.od6[4] = r.ax * r.dz + r.az * r.dx;
  r.od6[5] = r.ay * r.dz + r.az * r.dy;
  r.oo6[0] = r.ax * r.ax;
  r.oo6[1] = r.ay * r.ay;
  r.oo6[2] = r.az * r.az;
  r.oo6[3] = 2.f * r.ax * r.ay;
  r.oo6[4] = 2.f * r.ax * r.az;
  r.oo6[5] = 2.f * r.ay * r.az;
}

// The per-candidate terms of the per-ray-origin quad response, once per
// staged row and chunk, in place of the eye's unused v, cq and oo: with b =
// mu - o_bar, Qb (columns 7..9), radius^2 (10) and b^T Q b (11)
// (pallas_march.py:526-532).
__device__ __forceinline__ void origin_quad_row(float* f, float3 ob) {
  const float bx = f[kOqMean] - ob.x, by = f[kOqMean + 1] - ob.y, bz = f[kOqMean + 2] - ob.z;
  const float vx = f[1] * bx + f[4] * by + f[5] * bz;
  const float vy = f[4] * bx + f[2] * by + f[6] * bz;
  const float vz = f[5] * bx + f[6] * by + f[3] * bz;
  const float mqm = vx * bx + vy * by + vz * bz;
  const float r2 = f[kOqRad] * f[kOqRad];
  f[7] = vx;
  f[8] = vy;
  f[9] = vz;
  f[10] = r2;
  f[11] = mqm;
}

// The ray of this thread, with the per-ray-origin quad terms where kR asks
// for them (o_bar from `s`, as origin_centroid says: every thread calls it).
template <int kR, bool kCl>
__device__ __forceinline__ Ray load_ray_for(const Params& p, const TileIdx& ti, float* s,
                                            float3& ob) {
  Ray ray = load_ray(p, ti);
  ob = make_float3(0.f, 0.f, 0.f);
  if constexpr (kR == kOriginQuad) {
    ob = kCl ? origin_centroid_tile(s, p, ti) : origin_centroid(s, ray);
    origin_quad_ray(ray, ob);
  }
  return ray;
}

// The carry-in T of the ray (0 on an idle lane: it never holds a chunk skip).
__device__ __forceinline__ float carry_in(const Params& p, const TileIdx& ti) {
  if (!ti.valid) return 0.f;
  return p.t0 ? p.t0[ti.idx()] : 1.f;
}

__device__ __forceinline__ void store_ray(const Params& p, const TileIdx& ti, float r, float g,
                                          float b, float T) {
  if (!ti.valid) return;
  const size_t ray_idx = ti.idx();
  p.rgb[ray_idx * 3 + 0] = r;
  p.rgb[ray_idx * 3 + 1] = g;
  p.rgb[ray_idx * 3 + 2] = b;
  p.t_final[ray_idx] = T;
}

// Staging buffers of the window kernel: two where they fit in 48 KB (chunk
// j+1's rows are copied while chunk j is marched), else one.
template <int C, int W>
__host__ __device__ constexpr int window_stages() {
  return 2 * C * W * 4 <= 48 * 1024 ? 2 : 1;
}
// Dynamic shared memory of the window and key kernels: their staging
// buffers and C sure-miss thresholds.
template <int C, int W>
__host__ __device__ constexpr int staged_smem_bytes() {
  return (int)sizeof(float) * (window_stages<C, W>() * C * W + C);
}
// A piece: the run [k0, k0 + m) of a tile's candidates staged at once
// (at most C, the build's staging capacity). The window and merge kernels
// stage one piece a chunk (stage_chunk); the key kernel stages chunk j of
// c in ceil(c / C) pieces.
struct Piece {
  int k0, m;
};

// Stage piece u of a tile (every thread of the block, past the tile-wide
// skip test): the candidates pc of a tile of n in chunks of c, its rows
// ready in sf (one stage), or in buffer u & 1 with piece nx's copy started
// into the other (two stages: the kernel started piece 0's before its
// loop; nx.k0 >= n: no next piece), their sure-miss thresholds in thr and,
// for the per-ray-origin quad response, their origin_quad_row terms about
// the tile's origin centroid ob. `first`: the piece starts a chunk. Returns
// the piece's rows.
template <int C, int kR, int K, bool kTrain, int kStages>
__device__ __forceinline__ const float* stage_piece(float* sf, float* thr, const Params& p,
                                                    int start, int u, int n, float3 ob, int c,
                                                    Piece pc, Piece nx, bool first) {
  constexpr int W = Layout<kR, K, kTrain>::w;
  float* buf = sf + (kStages == 2 ? (u & 1) * C * W : 0);
  if (kStages == 1) {
    __syncthreads();  // the previous piece is done with sf
    stage_async<kR, K, kTrain>(sf, p, start, pc.k0, c, pc.m);
    cp_async_wait<0>();
    __syncthreads();
  } else {
    // piece u+1 goes to the buffer piece u-1 used, which every thread left
    // before block_reduce's barrier (a chunk's first piece) or this one (a
    // later piece of the same chunk); a tile that skips chunk j+1 never
    // reads it
    if (!first) __syncthreads();
    if (nx.k0 < n) {
      stage_async<kR, K, kTrain>(sf + ((u + 1) & 1) * C * W, p, start, nx.k0, c, nx.m);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < pc.m; i += blockDim.x) {
    thr[i] = miss_threshold(buf[i * W], p.alpha_min);
    if constexpr (kR == kOriginQuad) origin_quad_row(buf + i * W, ob);
  }
  __syncthreads();
  return buf;
}

// stage_piece of chunk j of C candidates, one piece a chunk (piece j).
template <int C, int kR, int K, bool kTrain, int kStages>
__device__ __forceinline__ const float* stage_chunk(float* sf, float* thr, const Params& p,
                                                    int start, int j, int n, float3 ob) {
  const Piece pc{j * C, min(C, n - j * C)}, nx{(j + 1) * C, min(C, n - (j + 1) * C)};
  return stage_piece<C, kR, K, kTrain, kStages>(sf, thr, p, start, j, n, ob, C, pc, nx, true);
}

// Blocks per SM the 256-ray window kernel is built for (its register cap).
constexpr int kWindowMinBlocks = 4;

// Fields of a ray's carried state in the window kernel (Params::carry):
// T, the colour, and its fire group's fired and repaired chunks (stats).
constexpr int kWinFields = 6;

template <int C, int kR, int K, bool kTrain, int kMaxR>
__global__ void __launch_bounds__(kMaxR == 256 ? 256 : 1024, kMaxR == 256 ? kWindowMinBlocks : 1)
    march_kernel(Params p) {
  using L = Layout<kR, K, kTrain>;
  constexpr int W = L::w, kCol = L::col;
  constexpr int kStages = window_stages<C, W>();
  constexpr bool kCl = kMaxR >= kClusterR;
  // block mode (the scalar response, render) merge-sorts a fired chunk's list
  constexpr bool kBlockSort = kR == kScalar && !kTrain;
  extern __shared__ __align__(16) float sf[];  // kStages * C * W staged floats
  float* thr = sf + kStages * C * W;             // C sure-miss thresholds
  __shared__ float red[kCl ? kClusterRed : 32];

  const TileIdx ti = tile_index<kCl>(p);
  const int tile = ti.tile, R = ti.R;
  // several rays a thread (more than kClusterR rays a tile, cluster
  // builds): each slot's ray in turn, its state in p.carry between its turns
  const bool multi = kCl && ti.slots > 1;
  const int slots = multi ? ti.slots : 1;
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;
  const int n_chunks = (n + C - 1) / C;
  float3 ob;
  Ray ray = load_ray_for<kR, kCl>(p, ti, sf, ob);
  float basis[K];
  if (K > 1) sh_basis<K>(ray.dx, ray.dy, ray.dz, basis);
  float* tin = kTrain ? p.tin + (size_t)p.chunk_base[tile] * R : nullptr;  // + j R + ray
  int par = 0;  // tile_reduce's exchange slots (cluster builds)

  float T = carry_in(p, ti), acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  // the chunk's significant candidates in stream order, and a fired
  // chunk's sorted list (local memory, 9 C bytes; one ray's at a time):
  // lk[0] their order keys, then the sort keys; lk[1] their alphas' bits;
  // ls[0] their source indices. Block mode's merge sort (block_sort) takes
  // lk[1] (free once the sort keys hold the alphas) and ls[1], which only
  // its instantiations have, as its second buffer.
  uint32_t lk[2][C];
  uint8_t ls[kBlockSort ? 2 : 1][C];
  uint32_t(&keys)[C] = lk[0];
  uint8_t(&si)[C] = ls[0];
  // the render options (window_options; neutral with saved carries): fire
  // groups of gw warps, the fire test's alpha, the repair band's width and
  // whether it is computed (its sorted window taken only with a_fire > 0,
  // where it differs from the whole list; its count with stats)
  const int gw = (kTrain ? R : p.group) >> 5;
  const float a_fire = kTrain ? 0.f : p.a_fire;
  const int rw = kTrain ? 0 : p.repair;
  const bool band = rw > 0 && (a_fire > 0.f || p.stats);
  const bool peak = p.peak != 0, fast_gate = peak && p.full_range != 0;
  const bool whole = gw == (R >> 5);  // the fire group is the tile
  int n_fired = 0, n_repaired = 0;  // this thread's fire group's chunks (stats)

  // the current slot (its ray, T, colour and counts) when a thread marches
  // several: take() makes slot s current, keep() stores it back
  TileIdx cur = ti;
  auto take = [&](int s, bool state) {
    cur = ti.slot(s);
    ray = load_ray(p, cur);
    if constexpr (kR == kOriginQuad) origin_quad_ray(ray, ob);
    if (!state) return;
    if (K > 1) sh_basis<K>(ray.dx, ray.dy, ray.dz, basis);
    T = 0.f;
    acc_r = acc_g = acc_b = 0.f;
    n_fired = n_repaired = 0;
    if (!cur.valid) return;
    T = carried(p, cur, kWinFields, 0);
    acc_r = carried(p, cur, kWinFields, 1);
    acc_g = carried(p, cur, kWinFields, 2);
    acc_b = carried(p, cur, kWinFields, 3);
    n_fired = (int)carried(p, cur, kWinFields, 4);
    n_repaired = (int)carried(p, cur, kWinFields, 5);
  };
  auto keep = [&]() {
    if (!cur.valid) return;
    carried(p, cur, kWinFields, 0) = T;
    carried(p, cur, kWinFields, 1) = acc_r;
    carried(p, cur, kWinFields, 2) = acc_g;
    carried(p, cur, kWinFields, 3) = acc_b;
    carried(p, cur, kWinFields, 4) = (float)n_fired;
    carried(p, cur, kWinFields, 5) = (float)n_repaired;
  };
  if (multi)
    for (int s = 0; s < slots; ++s) {
      cur = ti.slot(s);
      T = carry_in(p, cur);
      keep();
    }

  // pass 1 of the current ray over the staged chunk: every candidate once
  // (a miss stops at alpha); the significant ones (a > 0) are kept in
  // stream order in local memory: order key (in keys[], which the sorted
  // list later overwrites from the front), alpha and source index; the
  // inversion test over the candidates with a > a_fire (every significant
  // one at a_fire 0), the last significant candidate below their running
  // max (i1, the band's right end) and the significant key range
  int ns = 0, i1 = -1;
  bool inv = false;
  float lo = INFINITY, hi = -INFINITY;
  auto pass1 = [&](const float* buf, int m) {
    inv = false;
    float rmax = -INFINITY;
    lo = INFINITY;
    hi = -INFINITY;
    ns = 0;
    i1 = -1;
    // a dead ray (zero direction: a retired bounced ray, a pixel outside a
    // fisheye's image circle, a cluster's idle lane) has a = 0 on every
    // candidate, so it lists none: it skips the chunk, and so does a warp
    // of dead rays
    if (!ray.live) return;
    for (int i = 0; i < m; ++i) {
      float t_ev, a;
      evaluate<kR, true>(p, ray, buf + i * W, fast_gate, peak, t_ev, a, thr[i]);
      if (a > 0.f) {
        const bool below = t_ev < rmax;
        inv |= below && a > a_fire;
        if (below) i1 = i;
        if (a > a_fire) rmax = fmaxf(rmax, t_ev);
        lo = fminf(lo, t_ev);
        hi = fmaxf(hi, t_ev);
        keys[ns] = __float_as_uint(t_ev);
        lk[1][ns] = __float_as_uint(a);
        si[ns++] = (uint8_t)i;
      }
    }
  };
  // i0: the first significant candidate whose key lies above the least
  // key after it (pallas_march.py:866-871)
  auto first_above = [&]() {
    int i0 = C;
    float smin = INFINITY;
    for (int k = ns - 1; k >= 0; --k) {
      const float t = __uint_as_float(keys[k]);
      if (t > smin) i0 = si[k];
      smin = fminf(smin, t);
    }
    return i0;
  };
  // Block mode's sort of the run [k0, k1) of a fired chunk's sort keys
  // (render; bounced rays over the Morton blocks, whose lists come in no
  // depth order, so that pass 2's insertion would shift up to n (n - 1) / 2
  // times): runs of 4 put in order by insertion (at most 6 shifts each),
  // then bottom-up merge passes between lk[0], ls[0] and lk[1], ls[1], the
  // left run first on equal keys (stable: stream order). Its cost is set
  // by n = k1 - k0, not by the order. Returns the buffer holding the run.
  auto block_sort = [&](int k0, int k1) {
    for (int r = k0; r < k1; r += 4)
      for (int k = r + 1; k < min(r + 4, k1); ++k) {
        const uint32_t key = keys[k];
        const uint8_t i = si[k];
        int pos = k;
        for (; pos > r && keys[pos - 1] > key; --pos) {
          keys[pos] = keys[pos - 1];
          si[pos] = si[pos - 1];
        }
        keys[pos] = key;
        si[pos] = i;
      }
    int b = 0;
    for (int w = 4; w < k1 - k0; w *= 2, b ^= 1)
      for (int r = k0; r < k1; r += 2 * w) {  // runs [r, mid) and [mid, end) into [r, end)
        const int mid = min(r + w, k1), end = min(r + 2 * w, k1);
        int i = r, j = mid;
        uint32_t ki = lk[b][i], kj = j < end ? lk[b][j] : 0u;
        for (int o = r; o < end; ++o) {
          if (j < end && (i >= mid || kj < ki)) {
            lk[b ^ 1][o] = kj;
            ls[b ^ 1][o] = ls[b][j];
            if (++j < end) kj = lk[b][j];
          } else {
            lk[b ^ 1][o] = ki;
            ls[b ^ 1][o] = ls[b][i];
            if (++i < mid) ki = lk[b][i];
          }
        }
      }
    return b;
  };

  if (kStages == 2 && n_chunks > 0) stage_async<kR, K, kTrain>(sf, p, start, 0, C, min(C, n));
  bool skipped = false;  // block-uniform; T never changes once skipped
  for (int j = 0; j < n_chunks; ++j) {
    // the carry-in saved, and the tile-wide chunk skip (T never changes
    // once every ray is below it)
    float t_max = T;
    if (!multi) {
      if (kTrain && ti.valid) tin[(size_t)j * R + ti.ray] = T;
    } else {
      t_max = 0.f;
      for (int s = 0; s < slots; ++s) {
        const TileIdx t = ti.slot(s);
        if (!t.valid) continue;
        const float Ts = carried(p, t, kWinFields, 0);
        if (kTrain) tin[(size_t)j * R + t.ray] = Ts;
        t_max = fmaxf(t_max, Ts);
      }
    }
    if (!skipped) skipped = tile_reduce1<kCl>(t_max, true, red, par) <= p.t_skip;
    if (skipped) {
      if (!kTrain) break;
      continue;  // the remaining chunks' carries are still saved
    }

    const int m = min(C, n - j * C);
    const float* buf = stage_chunk<C, kR, K, kTrain, kStages>(sf, thr, p, start, j, n, ob);

    // the fire decision of this thread's group, whether any group fired
    // (block-uniform: it decides who takes the group reductions below), the
    // group's key range, and whether the repair band fits (i1 - i0 < w over
    // the group) and its window [ws, ws + w)
    bool fired = false, any = false, fit = false;
    float glo = INFINITY, ghi = -INFINITY;
    int ws = 0;
    if (whole) {
      // one fire group, the tile: every slot's pass 1 folded, then one
      // vote (a cluster's vote and key range in one exchange)
      bool t_inv = false;
      int t_i0 = C, t_i1 = -1;
      for (int s = 0; s < slots; ++s) {
        if (multi) take(s, false);
        pass1(buf, m);
        t_inv |= inv;
        glo = fminf(glo, lo);
        ghi = fmaxf(ghi, hi);
        if (multi && band) {
          t_i0 = min(t_i0, first_above());
          t_i1 = max(t_i1, i1);
        }
      }
      if constexpr (kCl) {
        float v[3] = {t_inv ? 1.f : 0.f, glo, ghi};
        const bool mx[3] = {true, false, true};
        tile_reduce<kCl>(v, mx, red, par);
        fired = any = v[0] != 0.f;
        glo = v[1];
        ghi = v[2];
      } else {
        fired = any = __syncthreads_or(t_inv);
        if (any) {
          glo = block_reduce(glo, false, red);
          ghi = block_reduce(ghi, true, red);
        }
      }
      if (any && band) {
        if (!multi) {
          t_i0 = first_above();
          t_i1 = i1;
        }
        float v[2] = {(float)t_i0, (float)t_i1};
        const bool mx[2] = {false, true};
        tile_reduce<kCl>(v, mx, red, par);
        fit = (int)v[1] - (int)v[0] < rw;
        ws = min((int)v[0], C - rw);
      }
    }

    for (int s = 0; s < slots; ++s) {
      if (multi) {
        take(s, true);
        if (whole) pass1(buf, m);  // the list again, past the tile's vote
      }
      if (!whole) {
        // fire groups of 128 rays, each in one block and one slot: the
        // group's vote and reductions
        pass1(buf, m);
        any = group_or(inv, red, gw, fired);
        fit = false;
        ws = 0;
        if (any) {
          glo = group_reduce(lo, false, red, gw);
          ghi = group_reduce(hi, true, red, gw);
          if (band) {
            const int g0 = (int)group_reduce((float)first_above(), false, red, gw);
            const int g1 = (int)group_reduce((float)i1, true, red, gw);
            fit = g1 - g0 < rw;
            ws = min(g0, C - rw);
          }
        }
      }
      n_fired += fired;
      n_repaired += fired && fit;

      // pass 2, over the significant candidates only: composited in stream
      // order with float32 colours (no fire), or listed in sorted order
      Composite comp(T, !kTrain && p.scan);
      float cr, cg, cb;
      if (!fired) {
        for (int k = 0; k < ns; ++k) {
          row_color<kR == kScalar, K>(buf + si[k] * W + kCol, basis, cr, cg, cb);
          comp.add(__uint_as_float(lk[1][k]), cr, cg, cb, p.min_t);
        }
      } else {
        const float scale = 65534.f / fmaxf(ghi - glo, 1e-20f);
        // the sorted run [k0, k1) of the list: all of it, or with a_fire > 0
        // and a fitting band the candidates of the window [ws, ws + w), a
        // contiguous run of the list (pallas_march.py:876-893); the others
        // keep their stream places, keys and packs
        int k0 = 0, k1 = ns;
        if (a_fire > 0.f && fit) {
          while (k0 < ns && si[k0] < ws) ++k0;
          for (k1 = k0; k1 < ns && si[k1] < ws + rw;) ++k1;
        }
        // block mode (render): every key first, then the run [k0, k1)
        // merge-sorted (block_sort); the sorted run ends in buffer fb
        const bool msort = kBlockSort && p.blocks;
        int fb = 0;
        for (int k = 0; k < ns; ++k) {
          // entry k's order key, read before the list grows to k entries
          const float t_ev = __uint_as_float(keys[k]);
          const uint8_t i = si[k];
          const uint32_t tq = (uint32_t)fminf(fmaxf((t_ev - glo) * scale, 0.f), 65534.f);
          // training: the unique key tq16 << 8 | src (pallas_march.py:833-842),
          // here with the compact index k for src (the same order: both ascend
          // with the stream; alpha and source stay at k); render: tq16 << 15
          // | a15, alpha decoded from the key, the source moving with the key
          const uint32_t key =
              kTrain ? (tq << 8) | (uint32_t)k
                     : (tq << 15) |
                           (uint32_t)fminf(fmaxf(__uint_as_float(lk[1][k]) * 32767.f, 0.f),
                                           32767.f);
          int pos = k;
          if (k < k1 && !msort)
            while (pos > k0 && keys[pos - 1] > key) {  // stable: ties keep stream order
              keys[pos] = keys[pos - 1];
              if (!kTrain) si[pos] = si[pos - 1];
              --pos;
            }
          keys[pos] = key;
          if (!kTrain) si[pos] = i;
        }
        if constexpr (kBlockSort)
          if (msort) fb = block_sort(k0, k1);
        for (int k = 0; k < ns; ++k) {
          const int e = kTrain ? (int)(keys[k] & 255u) : k;
          const int b = k >= k0 && k < k1 ? fb : 0;  // the buffer entry k lies in
          // training: the exact alpha; render: alpha decoded from the key
          const float a = kTrain ? __uint_as_float(lk[1][e]) : (float)(lk[b][k] & 32767u) * kInvA;
          row_color<kR == kScalar, K>(buf + ls[b][e] * W + kCol, basis, cr, cg, cb);
          add_packed(comp, a, pack_color(cr, cg, cb), p.min_t);
        }
      }
      const float t_next = comp.t_next();
      T = T > p.min_t ? t_next : T;
      acc_r += comp.r;
      acc_g += comp.g;
      acc_b += comp.b;
      if (multi) keep();
    }
  }
  cp_async_wait<0>();  // a skipped tile's prefetch
  if (!kTrain && p.stats) {  // per tile, the most chunks any fire group sorted (JAX's max)
    float v[2] = {(float)n_fired, (float)n_repaired};
    if (multi)
      for (int s = 0; s < slots; ++s) {
        take(s, true);
        v[0] = fmaxf(v[0], (float)n_fired);
        v[1] = fmaxf(v[1], (float)n_repaired);
      }
    const bool mx[2] = {true, true};
    tile_reduce<kCl>(v, mx, red, par);
    if (ti.ray == 0) {
      p.stats[2 * tile] = (int)v[0];
      p.stats[2 * tile + 1] = (int)v[1];
    }
  }

  if (!multi)
    store_ray(p, ti, acc_r, acc_g, acc_b, T);
  else
    for (int s = 0; s < slots; ++s) {
      take(s, true);
      store_ray(p, cur, acc_r, acc_g, acc_b, T);
    }
  tile_end<kCl>();
}

// Blocks per SM the 256-ray key kernel is built for (its register cap). At
// SH 3 shared memory holds three; a cap for four spills, one for two lets
// the registers grow past three (PERF.md). kKeyBlocks: at most that many
// run (blocks_per_sm), where more would fit.
constexpr int kKeyMinBlocks = 3, kKeyBlocks = 4;

// Fields of a ray's carried state in the key kernel (Params::carry): T and
// the colour, then the chunk's Composite between the pieces of a chunk of
// more than C candidates (s, frozen, r, g, b, below).
constexpr int kKeyFields = 10;

// The key kernel, one tile a block (a cluster above 1024 rays). C is the
// build's staging capacity; the chunk is p.chunk = c, any c >= 1 (launch_k
// takes the smallest build with C >= c, up to 256). Chunk j is staged in
// ceil(c / C) pieces of at most C rows (stage_piece): one at c <= C,
// several for a chunk above 256 (block mode's c = chunk * block_sub). The
// skip test, the saved carry and the composite span the whole chunk: one
// Composite over its c candidates, in stream order across its pieces.
template <int C, int kR, int K, bool kTrain, int kMaxR>
__global__ void __launch_bounds__(kMaxR == 256 ? 256 : 1024, kMaxR == 256 ? kKeyMinBlocks : 1)
    march_key_kernel(Params p) {
  extern __shared__ __align__(16) float sf[];  // kStages * C * W staged floats, C thresholds
  __shared__ float red[kMaxR >= kClusterR ? kClusterRed : 32];
  using L = Layout<kR, K, kTrain>;
  constexpr int W = L::w, kCol = L::col;
  constexpr int kStages = window_stages<C, W>();
  constexpr bool kCl = kMaxR >= kClusterR;
  float* thr = sf + kStages * C * W;  // C sure-miss thresholds

  const TileIdx ti = tile_index<kCl>(p);
  const int tile = ti.tile, R = ti.R;
  // several rays a thread (more than kClusterR rays a tile, cluster
  // builds): each slot's ray in turn, its state in p.carry between its turns
  const bool multi = kCl && ti.slots > 1;
  const int slots = multi ? ti.slots : 1;
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;
  const int c = p.chunk;  // the chunk
  const int n_chunks = (n + c - 1) / c;
  int u = 0;  // pieces staged: u & 1 the next one's buffer
  float3 ob;
  Ray ray = load_ray_for<kR, kCl>(p, ti, sf, ob);
  float basis[K];
  if (K > 1) sh_basis<K>(ray.dx, ray.dy, ray.dz, basis);
  const bool fast_gate = p.full_range != 0;
  float* tin = kTrain ? p.tin + (size_t)p.chunk_base[tile] * R : nullptr;  // + j R + ray
  int par = 0;  // tile_reduce's exchange slots (cluster builds)

  float T = carry_in(p, ti), acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  if (multi)
    for (int s = 0; s < slots; ++s) {
      const TileIdx t = ti.slot(s);
      if (!t.valid) continue;
      carried(p, t, kKeyFields, 0) = carry_in(p, t);
      for (int f = 1; f < 4; ++f) carried(p, t, kKeyFields, f) = 0.f;
    }
  if (kStages == 2 && n_chunks > 0)
    stage_async<kR, K, kTrain>(sf, p, start, 0, c, min(C, min(c, n)));
  bool skipped = false;  // block-uniform; T never changes once skipped
  for (int j = 0; j < n_chunks; ++j) {
    float t_max = T;
    if (!multi) {
      if (kTrain && ti.valid) tin[(size_t)j * R + ti.ray] = T;
    } else {
      t_max = 0.f;
      for (int s = 0; s < slots; ++s) {
        const TileIdx t = ti.slot(s);
        if (!t.valid) continue;
        const float Ts = carried(p, t, kKeyFields, 0);
        if (kTrain) tin[(size_t)j * R + t.ray] = Ts;
        t_max = fmaxf(t_max, Ts);
      }
    }
    if (!skipped) skipped = tile_reduce1<kCl>(t_max, true, red, par) <= p.t_skip;
    if (skipped) {
      if (!kTrain) break;
      continue;  // the remaining chunks' carries are still saved
    }
    // one evaluation per candidate: a sure miss stops before the division
    // and the exp (a = 0, as the full evaluation would give; the fast gate
    // reads only what the full evaluation computes past that test); from
    // per-ray origins (bounced rays, of which most are retired, and the
    // rolling shutter) so does any candidate of a dead ray, which would
    // otherwise hold its warp on the full path
    Composite comp(T, !kTrain && p.scan);
    // pieces [k0, k0 + C) of [j c, end); the next piece the chunk's next,
    // or the next chunk's first
    const int j0 = j * c, end = min(n, j0 + c);
    for (int k0 = j0; k0 < end; k0 += C, ++u) {
      const Piece pc{k0, min(C, end - k0)};
      const Piece nx = k0 + C < end ? Piece{k0 + C, min(C, end - k0 - C)}
                                    : Piece{j0 + c, min(C, min(c, n - j0 - c))};
      const float* buf = stage_piece<C, kR, K, kTrain, kStages>(sf, thr, p, start, u, n, ob, c,
                                                                pc, nx, k0 == j0);
      // the piece over the current ray (ray, basis, comp); one ray a thread
      // calls it outside the slot loop, whose loop-carried ray and
      // Composite cost that path 2.4-2.9% in the same build
      auto march_piece = [&]() {
        for (int i = 0; i < pc.m; ++i) {
          const float* f = buf + i * W;
          float t_ev, a, cr, cg, cb;
          evaluate<kR, true, kR != kQuad>(p, ray, f, fast_gate, false, t_ev, a, thr[i]);
          if (!(a > 0.f)) continue;
          row_color<kR == kScalar, K>(f + kCol, basis, cr, cg, cb);
          comp.add(a, cr, cg, cb, p.min_t);
        }
      };
      if (!multi) {
        march_piece();
        continue;
      }
      for (int s = 0; s < slots; ++s) {
        // several rays a thread: slot s's ray, and its Composite of the
        // chunk (fresh at the chunk's first piece, else carried)
        const TileIdx t = ti.slot(s);
        ray = load_ray(p, t);
        if constexpr (kR == kOriginQuad) origin_quad_ray(ray, ob);
        if (K > 1) sh_basis<K>(ray.dx, ray.dy, ray.dz, basis);
        T = t.valid ? carried(p, t, kKeyFields, 0) : 0.f;
        comp = Composite(T, !kTrain && p.scan);
        if (k0 != j0 && t.valid) {
          comp.s = carried(p, t, kKeyFields, 4);
          comp.frozen = carried(p, t, kKeyFields, 5);
          comp.r = carried(p, t, kKeyFields, 6);
          comp.g = carried(p, t, kKeyFields, 7);
          comp.b = carried(p, t, kKeyFields, 8);
          comp.below = carried(p, t, kKeyFields, 9) != 0.f;
        }
        march_piece();
        if (!t.valid) continue;
        if (k0 + C < end) {  // the chunk goes on in the next piece
          carried(p, t, kKeyFields, 4) = comp.s;
          carried(p, t, kKeyFields, 5) = comp.frozen;
          carried(p, t, kKeyFields, 6) = comp.r;
          carried(p, t, kKeyFields, 7) = comp.g;
          carried(p, t, kKeyFields, 8) = comp.b;
          carried(p, t, kKeyFields, 9) = comp.below ? 1.f : 0.f;
        } else {
          const float t_next = comp.t_next();
          carried(p, t, kKeyFields, 0) = T > p.min_t ? t_next : T;
          carried(p, t, kKeyFields, 1) += comp.r;
          carried(p, t, kKeyFields, 2) += comp.g;
          carried(p, t, kKeyFields, 3) += comp.b;
        }
      }
    }
    if (multi) continue;
    const float t_next = comp.t_next();
    T = T > p.min_t ? t_next : T;
    acc_r += comp.r;
    acc_g += comp.g;
    acc_b += comp.b;
  }
  cp_async_wait<0>();  // a skipped tile's prefetch
  if (!multi)
    store_ray(p, ti, acc_r, acc_g, acc_b, T);
  else
    for (int s = 0; s < slots; ++s) {
      const TileIdx t = ti.slot(s);
      if (t.valid)
        store_ray(p, t, carried(p, t, kKeyFields, 1), carried(p, t, kKeyFields, 2),
                  carried(p, t, kKeyFields, 3), carried(p, t, kKeyFields, 0));
    }
  tile_end<kCl>();
}

// Shared memory of the merge kernel past its C * W staged floats: C
// sure-miss thresholds and two significance bitmasks of C bits per ray,
// word-major ([2][C / 32][R], so that a warp's lanes read their own words
// without bank conflicts whatever slot each lane is at).
template <int C, int W>
__host__ __device__ constexpr int merge_smem_bytes(int R) {
  return (int)sizeof(float) * (C * W + C) + 2 * (C / 32) * R * (int)sizeof(uint32_t);
}

// Blocks per SM the 256-ray merge kernel is built for (its register cap,
// and the occupancy launch_mode asks for: blocks_per_sm).
constexpr int kMergeMinBlocks = 2;

// Fields of a ray's carried state in the cluster merge kernel, several
// rays a thread (Params::carry): T, the colour, pend_max, then the pending
// buffer (C keys, C alphas, C colour packs, C / 32 mask words), bits as
// floats.
__host__ __device__ constexpr int merge_fields(int C) {
  return 5 + 3 * C + C / 32;
}

template <int C, int kR, int K, int kMaxR>
__global__ void __launch_bounds__(kMaxR == 256 ? 256 : 1024, kMaxR == 256 ? kMergeMinBlocks : 1)
    march_merge_kernel(Params p) {
  using L = Layout<kR, K, false>;
  constexpr int W = L::w, kCol = L::col, kWords = C / 32;
  extern __shared__ __align__(16) float sf[];  // merge_smem_bytes
  float* thr = sf + C * W;
  uint32_t* mask = reinterpret_cast<uint32_t*>(thr + C);
  __shared__ float red[32];

  const TileIdx ti = tile_index<false>(p);
  const int tile = ti.tile, R = blockDim.x, tid = threadIdx.x;  // R: the block's rays (masks)
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;
  float3 ob;
  Ray ray = load_ray_for<kR, false>(p, ti, sf, ob);
  float basis[K];
  if (K > 1) sh_basis<K>(ray.dx, ray.dy, ray.dz, basis);

  // Two buffers of C slots (local memory): the pending buffer (cur),
  // ascending by key, and the chunk (cur ^ 1), its keys ascending and its
  // alphas and colour packs by source index. A slot's significance (a > 0)
  // is its bit in the buffer's mask; only significant slots hold an alpha
  // and a colour. A fast chunk becomes the pending buffer by a swap.
  int32_t key[2][C];
  float al[2][C];
  uint32_t cpk[2][C];
  auto bits = [&](int b, int w) -> uint32_t& { return mask[(b * kWords + w) * R + tid]; };
  // composite the significant slots of the pending buffer, in slot order
  auto composite_pending = [&](Composite& comp, int b) {
    for (int w = 0; w < kWords; ++w)
      for (uint32_t m = bits(b, w); m; m &= m - 1) {
        const int s = w * 32 + __ffs(m) - 1;
        add_packed(comp, al[b][s], cpk[b][s], p.min_t);
      }
  };

  int cur = 0;
  bool fresh = true;  // block-uniform: no chunk marched yet, so the pending buffer is C empties
  int32_t pend_max = INT32_MIN;  // largest key of a significant pending slot
  const bool peak = p.peak != 0, fast_gate = peak && p.full_range != 0;
  int par = 0;
  float T = carry_in(p, ti), acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;

  for (int j = 0; j * C < n; ++j) {
    // tile-wide chunk skip (T never changes once every ray is below it)
    if (tile_reduce1<false>(T, true, red, par) <= p.t_skip) break;
    const int m = min(C, n - j * C);
    stage_chunk<C, kR, K, false, 1>(sf, thr, p, start, j, n, ob);

    // pass 1: every candidate once (a sure miss stops before the divide
    // and the exp, any other miss at alpha); its key inserted into the
    // sorted keys (a chunk without inversions is already sorted: no
    // shift), a significant one's alpha and colour pack stored by source
    // index
    const int nx = cur ^ 1;
    int32_t* ck = key[nx];
    int32_t rmax = INT32_MIN, new_min = INT32_MAX, sig_max = INT32_MIN, last = INT32_MIN;
    bool inv = false;
    uint32_t word = 0;
    for (int i = 0; i < C; ++i) {
      float t_ev, a = 0.f;
      if (i < m) evaluate<kR, true>(p, ray, sf + i * W, fast_gate, peak, t_ev, a, thr[i]);
      int32_t k;
      if (a > 0.f) {
        const int32_t kb = __float_as_int(fmaxf(t_ev, 0.f)) & ~0xFF;
        inv |= kb < rmax;
        rmax = max(rmax, kb);
        new_min = min(new_min, kb);
        k = kb | i;
        sig_max = max(sig_max, k);
        float cr, cg, cb;
        row_color<kR == kScalar, K>(sf + i * W + kCol, basis, cr, cg, cb);
        al[nx][i] = a;
        cpk[nx][i] = pack_color(cr, cg, cb);
        word |= 1u << (i & 31);
      } else {
        k = rmax | i;
      }
      if (k > last) {  // keys are unique within the chunk
        ck[i] = k;
        last = k;
      } else {
        int pos = i;
        for (; pos > 0 && ck[pos - 1] > k; --pos) ck[pos] = ck[pos - 1];
        ck[pos] = k;
      }
      if ((i & 31) == 31) {
        bits(nx, i >> 5) = word;
        word = 0;
      }
    }
    // the fast test, tile-wide: no ray sees an inversion, and every ray's
    // least significant key is at or above its pending buffer's largest
    const bool fast = __syncthreads_and(!inv && new_min >= pend_max);

    Composite comp(T, p.scan);
    if (fast) {  // the pending buffer composites; the chunk (sorted) replaces it
      if (!fresh) composite_pending(comp, cur);
      cur = nx;
      pend_max = sig_max;
    } else {
      // two pointers over the pending buffer and the sorted chunk (pending
      // first on equal keys): the C smallest composite, the C largest are
      // written in place into the pending slots already read (slot k - C <
      // ip). A fresh buffer's C empties are the C smallest: nothing
      // composites and the sorted chunk becomes the pending buffer. The
      // heads' keys and the pending mask's word stay in registers; the new
      // mask's word is stored when its 32 slots are written, after the
      // reader has left that word.
      int ip = fresh ? C : 0, ic = 0;
      int32_t pkey = fresh ? 0 : key[cur][0], ckey = ck[0];
      uint32_t pw = fresh ? 0u : bits(cur, 0), nw = 0;
      int32_t new_max = INT32_MIN;
      for (int k = fresh ? C : 0; k < 2 * C; ++k) {
        int32_t kk;
        bool sig;
        float a = 0.f;
        uint32_t cp = 0u;
        if (ic == C || (ip < C && pkey <= ckey)) {
          kk = pkey;
          sig = (pw >> (ip & 31)) & 1u;
          if (sig) {
            a = al[cur][ip];
            cp = cpk[cur][ip];
          }
          if (++ip < C) {
            pkey = key[cur][ip];
            if ((ip & 31) == 0) pw = bits(cur, ip >> 5);
          }
        } else {
          kk = ckey;
          const int i = kk & 255;
          sig = (bits(nx, i >> 5) >> (i & 31)) & 1u;
          if (sig) {
            a = al[nx][i];
            cp = cpk[nx][i];
          }
          if (++ic < C) ckey = ck[ic];
        }
        if (k < C) {
          if (sig) add_packed(comp, a, cp, p.min_t);
        } else {
          const int s = k - C;
          key[cur][s] = kk;
          if (sig) {
            al[cur][s] = a;
            cpk[cur][s] = cp;
            nw |= 1u << (s & 31);
            new_max = kk;  // the slots ascend
          }
          if ((s & 31) == 31) {
            bits(cur, s >> 5) = nw;
            nw = 0;
          }
        }
      }
      pend_max = new_max;
    }
    const float t_next = comp.t_next();
    T = T > p.min_t ? t_next : T;
    acc_r += comp.r;
    acc_g += comp.g;
    acc_b += comp.b;
    fresh = false;
  }

  // flush the pending buffer
  Composite comp(T, p.scan);
  if (!fresh) composite_pending(comp, cur);
  const float t_next = comp.t_next();
  T = T > p.min_t ? t_next : T;
  store_ray(p, ti, acc_r + comp.r, acc_g + comp.g, acc_b + comp.b, T);
}

// Merge order's cluster build (tiles of more than 1024 rays, launch_mode's
// kMaxR = kClusterR), the semantics of march_merge_kernel with lists laid
// out for 1024 threads on an SM. Pass 1 keeps only the chunk's significant
// candidates, in local memory: their keys in stream order, and the same
// keys with their alphas and packs sorted by insertion among themselves (3-
// 16 a ray and chunk on the headline's wide tiles, PERF.md), and the
// chunk's mask in shared memory ([C / 32][blockDim.x]). The chunk's
// insignificant keys are not stored: in stream order they ascend (each is
// the running max of the significant kb before it OR its source index), so
// the walk generates them from the mask and the stream-order keys. The walk
// merges three ascending sequences: the pending buffer, the generated
// insignificant keys and the sorted significant ones (pending first on
// equal keys; keys are unique within a chunk): the C smallest composite,
// the C largest are written in place into pending slots already read. A
// fast chunk composites the pending buffer and then writes the chunk, in
// its sorted order, into the buffer (the walk without the pending buffer),
// as a fresh buffer's first chunk does. Dead rays (zero direction: idle
// lanes past R, dead pixels), whose a is 0 on every candidate, skip pass 1
// and the walk: they list and composite nothing. One ray a thread (up to
// 8192 rays, kMulti false) keeps its pending buffer (C keys, alphas and
// colour packs) in local memory and its mask in shared memory, as
// march_merge_kernel does. Several (kMulti) keep each slot's pending buffer
// and mask words in the scratch Params::carry (merge_fields(C) floats a
// ray, field-major: a warp's rays adjacent), where it stays between a
// thread's turns: no copy in or out; their T, colour and pend_max wait in
// carry fields 0-4, and a thread evaluates each slot's candidates once for
// the tile-wide fast test's inputs and once in pass 1 (PERF.md: 3-4% of
// the launch).
template <int C, int kR, int K, bool kMulti>
__global__ void __launch_bounds__(1024, 1) march_merge_cluster_kernel(Params p) {
  using L = Layout<kR, K, false>;
  constexpr int W = L::w, kCol = L::col, kWords = C / 32, kF = merge_fields(C);
  // the pending buffer's fields in the carry (kMulti): keys, alphas, packs,
  // mask words
  constexpr int kPK = 5, kPA = 5 + C, kPC = 5 + 2 * C, kPM = 5 + 3 * C;
  extern __shared__ __align__(16) float sf[];  // merge_smem_bytes
  float* thr = sf + C * W;
  // the chunk's mask, then (one ray a thread) the pending buffer's, each
  // [C / 32][blockDim.x]
  uint32_t* qmask = reinterpret_cast<uint32_t*>(thr + C);
  __shared__ float red[kClusterRed];

  const TileIdx ti = tile_index<true>(p);
  const int tile = ti.tile, R = ti.R, tid = threadIdx.x, nt = blockDim.x;
  const int slots = kMulti ? ti.slots : 1;
  const int start = p.starts[tile];
  const int n = p.starts[tile + 1] - start;
  float3 ob;
  Ray ray = load_ray_for<kR, true>(p, ti, sf, ob);
  float basis[K];
  if (K > 1) sh_basis<K>(ray.dx, ray.dy, ray.dz, basis);

  // the chunk's significant candidates: keys in stream order (qkey), and
  // sorted (skey) with their alphas and packs
  int32_t qkey[C], skey[C];
  float sal[C];
  uint32_t spk[C];
  int ns = 0;
  // one ray a thread: the pending buffer
  int32_t lkey[kMulti ? 1 : C];
  float lal[kMulti ? 1 : C];
  uint32_t lpk[kMulti ? 1 : C];

  bool fresh = true;  // block-uniform: no chunk marched yet, the pending buffer is C empties
  int32_t pend_max = INT32_MIN;  // largest key of a significant pending slot
  const bool peak = p.peak != 0, fast_gate = peak && p.full_range != 0;
  int par = 0;  // tile_reduce's exchange slots
  float T = carry_in(p, ti), acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;

  // the current slot, its ray, and (kMulti) its field 0 in the carry:
  // take() makes slot s current, with T, the colour and pend_max; keep()
  // stores those back
  TileIdx at = ti;
  float* pb = nullptr;
  auto P = [&](int f) -> float& { return pb[(size_t)f * R]; };
  // slot k of the pending buffer: key, alpha, pack; word w of its mask
  auto pkey_at = [&](int k) -> int32_t& {
    if constexpr (kMulti) return reinterpret_cast<int32_t&>(P(kPK + k));
    else return lkey[k];
  };
  auto pal_at = [&](int k) -> float& {
    if constexpr (kMulti) return P(kPA + k);
    else return lal[k];
  };
  auto ppk_at = [&](int k) -> uint32_t& {
    if constexpr (kMulti) return reinterpret_cast<uint32_t&>(P(kPC + k));
    else return lpk[k];
  };
  auto pmask_at = [&](int w) -> uint32_t& {
    if constexpr (kMulti) return reinterpret_cast<uint32_t&>(P(kPM + w));
    else return qmask[(kWords + w) * nt + tid];
  };
  auto take = [&](int s, bool state) {
    at = ti.slot(s);
    ray = load_ray(p, at);
    if constexpr (kR == kOriginQuad) origin_quad_ray(ray, ob);
    pb = at.valid ? &carried(p, at, kF, 0) : nullptr;
    T = acc_r = acc_g = acc_b = 0.f;
    pend_max = INT32_MIN;
    if (!at.valid) return;
    pend_max = __float_as_int(P(4));
    if (!state) return;
    if (K > 1) sh_basis<K>(ray.dx, ray.dy, ray.dz, basis);
    T = P(0);
    acc_r = P(1);
    acc_g = P(2);
    acc_b = P(3);
  };
  auto keep = [&]() {
    if (!at.valid) return;
    P(0) = T;
    P(1) = acc_r;
    P(2) = acc_g;
    P(3) = acc_b;
    P(4) = __int_as_float(pend_max);
  };
  if constexpr (kMulti)
    for (int s = 0; s < slots; ++s) {
      at = ti.slot(s);
      pb = at.valid ? &carried(p, at, kF, 0) : nullptr;
      T = carry_in(p, at);
      keep();
    }

  // composite the pending buffer's significant slots, in slot order
  auto composite_pending = [&](Composite& comp) {
    for (int w = 0; w < kWords; ++w)
      for (uint32_t m = pmask_at(w); m; m &= m - 1) {
        const int s = w * 32 + __ffs(m) - 1;
        add_packed(comp, pal_at(s), ppk_at(s), p.min_t);
      }
  };

  // pass 1 of the current ray over the staged chunk of m candidates (a live
  // ray; a sure miss stops before the divide and the exp, any other miss at
  // alpha): the significant ones listed, the mask written, and the fast
  // test's inputs
  bool inv = false;
  int32_t new_min = INT32_MAX;
  auto pass1 = [&](int m) {
    int32_t rmax = INT32_MIN;
    uint32_t word = 0;
    for (int i = 0; i < C; ++i) {
      float t_ev, a = 0.f;
      if (i < m) evaluate<kR, true>(p, ray, sf + i * W, fast_gate, peak, t_ev, a, thr[i]);
      if (a > 0.f) {
        const int32_t kb = __float_as_int(fmaxf(t_ev, 0.f)) & ~0xFF;
        inv |= kb < rmax;
        rmax = max(rmax, kb);
        new_min = min(new_min, kb);
        const int32_t k = kb | i;
        float cr, cg, cb;
        row_color<kR == kScalar, K>(sf + i * W + kCol, basis, cr, cg, cb);
        const uint32_t cp = pack_color(cr, cg, cb);
        qkey[ns] = k;
        int pos = ns++;
        for (; pos > 0 && skey[pos - 1] > k; --pos) {
          skey[pos] = skey[pos - 1];
          sal[pos] = sal[pos - 1];
          spk[pos] = spk[pos - 1];
        }
        skey[pos] = k;
        sal[pos] = a;
        spk[pos] = cp;
        word |= 1u << (i & 31);
      }
      if ((i & 31) == 31) {
        qmask[(i >> 5) * nt + tid] = word;
        word = 0;
      }
    }
  };

  // The walk: a three-way merge of the pending buffer (from_p; else the
  // buffer takes no part: it is C empties or has composited), the chunk's
  // insignificant keys, generated in ascending order from the mask (the
  // running max of the significant kb before each, OR its index), and its
  // sorted significant keys. Pending first on equal keys. The C smallest
  // composite (several rays a thread: found by bisection and merged over
  // their significant slots alone); the C largest go in place into pending
  // slots already read, the mask 32 slots at a time once they are written.
  auto walk = [&](Composite& comp, bool from_p) {
    // the heads: the pending buffer's key at ip, the next insignificant
    // key and the next sorted significant one, INT32_MAX once a sequence
    // is used up (no key reaches it: kb | i <= 0x7F8000FF)
    int ip = from_p ? 0 : C;
    int32_t pkey = from_p ? pkey_at(0) : INT32_MAX;
    uint32_t pw = from_p ? pmask_at(0) : 0u;
    // the insignificant keys: ipos the next one's index, ikey its key,
    // gbits the insignificant bits of word gw left after it, gr the
    // significant candidates in stream order before it, grmax their
    // largest kb
    int gw = 0, gr = 0, ipos = 0, nsig = ns > 0 ? (qkey[0] & 255) : C;
    uint32_t gbits = ~qmask[tid];
    int32_t grmax = INT32_MIN, ikey = INT32_MAX;
    auto next_insig = [&]() {
      while (gbits == 0u && gw < kWords - 1) gbits = ~qmask[++gw * nt + tid];
      if (gbits == 0u) {
        ikey = INT32_MAX;
        return;
      }
      ipos = gw * 32 + __ffs(gbits) - 1;
      gbits &= gbits - 1u;
      while (nsig < ipos) {  // nsig: the next significant index, C past the last
        grmax = max(grmax, qkey[gr] & ~0xFF);
        nsig = ++gr < ns ? (qkey[gr] & 255) : C;
      }
      ikey = grmax | ipos;
    };
    // several rays a thread: the generator on the chunk's t-th
    // insignificant key (from 0)
    auto seek_insig = [&](int t) {
      gbits = ~qmask[tid];
      while (gw < kWords - 1 && __popc(gbits) <= t) {
        t -= __popc(gbits);
        gbits = ~qmask[++gw * nt + tid];
      }
      for (; t > 0 && gbits != 0u; --t) gbits &= gbits - 1u;
      next_insig();
    };
    // the chunk's insignificant keys below x: in each run of indices
    // between two significant candidates the keys are M | i = M + i, M the
    // running max before the run (nondecreasing), so those with i < x - M
    auto insig_below = [&](int32_t x) -> int {
      int cnt = 0, prev = -1;
      int32_t M = INT32_MIN;
      for (int r = 0; r <= ns && M < x; ++r) {
        const int pr = r < ns ? (qkey[r] & 255) : C;
        const long long end = min((long long)pr, (long long)x - (long long)M);
        if (end > prev + 1) cnt += (int)end - (prev + 1);
        if (r < ns) {
          M = max(M, qkey[r] & ~0xFF);
          prev = pr;
        }
      }
      return cnt;
    };
    if (!(kMulti && from_p)) next_insig();
    int js = 0;
    int32_t skk = ns > 0 ? skey[0] : INT32_MAX;
    // the next slot of the union: its key, and with its significance its
    // alpha and pack
    float a = 0.f;
    uint32_t cp = 0u;
    auto step = [&](int32_t& kk) -> bool {
      if (pkey <= min(skk, ikey)) {  // pending first on equal keys
        kk = pkey;
        const bool sig = (pw >> (ip & 31)) & 1u;
        if (sig) {
          a = pal_at(ip);
          cp = ppk_at(ip);
        }
        if (++ip < C) {
          pkey = pkey_at(ip);
          if ((ip & 31) == 0) pw = pmask_at(ip >> 5);
        } else {
          pkey = INT32_MAX;
        }
        return sig;
      }
      if (skk < ikey) {
        kk = skk;
        a = sal[js];
        cp = spk[js];
        skk = ++js < ns ? skey[js] : INT32_MAX;
        return true;
      }
      kk = ikey;
      next_insig();
      return false;
    };
    int32_t kk;
    if (kMulti && from_p) {
      // the C smallest composite: the pending buffer's first a_end slots
      // and the chunk's first C - a_end keys. a_end is the first pending
      // slot whose place in the union (its index plus the chunk's keys
      // below it) is C or more, found by bisection; the significant slots
      // of both parts then composite, merged by key (pending first on
      // equal keys), and the heads move past them. (One ray a thread
      // walks them: the bisection's reads cost more than it spares there.)
      int lo = 0, hi = C;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int32_t x = pkey_at(mid);
        int below = 0;
        while (below < ns && skey[below] < x) ++below;
        if (mid + below + insig_below(x) >= C)
          hi = mid;
        else
          lo = mid + 1;
      }
      const int a_end = lo, b_end = C - lo;
      int jb = 0;  // the chunk's significant keys among its first b_end
      while (jb < ns && jb + insig_below(skey[jb]) < b_end) ++jb;
      for (int w = 0; w * 32 < a_end; ++w) {
        uint32_t m = pmask_at(w);
        if (a_end - w * 32 < 32) m &= (1u << (a_end - w * 32)) - 1u;
        for (; m; m &= m - 1) {
          const int s = w * 32 + __ffs(m) - 1;
          const int32_t ks = pkey_at(s);
          for (; js < jb && skey[js] < ks; ++js) add_packed(comp, sal[js], spk[js], p.min_t);
          add_packed(comp, pal_at(s), ppk_at(s), p.min_t);
        }
      }
      for (; js < jb; ++js) add_packed(comp, sal[js], spk[js], p.min_t);
      ip = a_end;
      pkey = ip < C ? pkey_at(ip) : INT32_MAX;
      pw = ip < C ? pmask_at(ip >> 5) : 0u;
      skk = js < ns ? skey[js] : INT32_MAX;
      seek_insig(b_end - jb);
    } else if (from_p) {  // the C smallest composite
      for (int k = 0; k < C; ++k)
        if (step(kk)) add_packed(comp, a, cp, p.min_t);
    }
    // the C largest, in place into pending slots already read (slot s < ip)
    uint32_t nw = 0;
    int32_t new_max = INT32_MIN;
    for (int s = 0; s < C; ++s) {
      const bool sig = step(kk);
      pkey_at(s) = kk;
      if (sig) {
        pal_at(s) = a;
        ppk_at(s) = cp;
        nw |= 1u << (s & 31);
        new_max = kk;  // the slots ascend
      }
      if ((s & 31) == 31) {
        pmask_at(s >> 5) = nw;
        nw = 0;
      }
    }
    pend_max = new_max;
  };

  for (int j = 0; j * C < n; ++j) {
    // tile-wide chunk skip (T never changes once every ray is below it)
    float t_max = T;
    if constexpr (kMulti) {
      t_max = 0.f;
      for (int s = 0; s < slots; ++s) {
        const TileIdx t = ti.slot(s);
        if (t.valid) t_max = fmaxf(t_max, carried(p, t, kF, 0));
      }
    }
    if (tile_reduce1<true>(t_max, true, red, par) <= p.t_skip) break;
    const int m = min(C, n - j * C);
    stage_chunk<C, kR, K, false, 1>(sf, thr, p, start, j, n, ob);

    // several rays a thread: the fast test's inputs of every slot first
    // (each candidate's key, no lists), past it each slot's pass 1
    bool ok_all = true;
    if constexpr (kMulti)
      for (int s = 0; s < slots; ++s) {
        take(s, false);
        if (!ray.live) continue;
        int32_t rmax = INT32_MIN, nmin = INT32_MAX;
        bool qinv = false;
        for (int i = 0; i < m; ++i) {
          float t_ev, a;
          evaluate<kR, true>(p, ray, sf + i * W, fast_gate, peak, t_ev, a, thr[i]);
          if (!(a > 0.f)) continue;
          const int32_t kb = __float_as_int(fmaxf(t_ev, 0.f)) & ~0xFF;
          qinv |= kb < rmax;
          rmax = max(rmax, kb);
          nmin = min(nmin, kb);
        }
        ok_all &= !qinv && nmin >= pend_max;
      }

    for (int sl = 0; sl < slots; ++sl) {
      if constexpr (kMulti) take(sl, true);
      // a dead ray (zero direction) lists nothing and composites nothing
      const bool live = at.valid && ray.live;
      ns = 0;
      inv = false;
      new_min = INT32_MAX;
      if (live) pass1(m);
      // the fast test, tile-wide: no ray sees an inversion, and every ray's
      // least significant key is at or above its pending buffer's largest
      bool fast;
      if constexpr (kMulti) {
        if (sl == 0) ok_all = tile_reduce1<true>(ok_all ? 1.f : 0.f, false, red, par) != 0.f;
        fast = ok_all;
      } else {
        const bool ok = !inv && new_min >= pend_max;
        fast = tile_reduce1<true>(ok ? 1.f : 0.f, false, red, par) != 0.f;
      }
      if (!live) continue;
      Composite comp(T, p.scan);
      if (fast && !fresh) composite_pending(comp);
      walk(comp, !(fast || fresh));
      const float t_next = comp.t_next();
      T = T > p.min_t ? t_next : T;
      acc_r += comp.r;
      acc_g += comp.g;
      acc_b += comp.b;
      if constexpr (kMulti) keep();
    }
    fresh = false;
  }

  // flush the pending buffer
  for (int s = 0; s < slots; ++s) {
    if constexpr (kMulti) take(s, true);
    Composite comp(T, p.scan);
    if (!fresh && at.valid && ray.live) composite_pending(comp);
    const float t_next = comp.t_next();
    T = T > p.min_t ? t_next : T;
    store_ray(p, at, acc_r + comp.r, acc_g + comp.g, acc_b + comp.b, T);
  }
  tile_end<true>();
}

// Resident 256-ray blocks per SM: ask for the smallest shared-memory
// carveout that holds n blocks (percent of the 228 KB, which the CUDA
// runtime rounds up to a carveout the SM has) and pad the dynamic shared
// memory so that n + 1 do not fit (where n fit at all). The window kernel
// keeps each ray's significant candidates of a chunk in local memory (up
// to 9 C bytes a ray), the merge kernel its two buffers (24 C bytes): two
// blocks keep more of that in L1, where four spill it to L2. The key
// kernel keeps nothing there; at SH 0 four blocks measured faster than the
// five its registers allow (PERF.md).
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int& smem, int n) {
  static const int kCarveoutsKB[] = {64, 100, 132, 164, 196, 228};  // the SM's
  for (const int kb : kCarveoutsKB) {
    // per block: 1 KB the runtime's, 128 B the static red[32]
    if (n * (smem + 1024 + 128) > kb * 1024) continue;
    const int more = kb * 1024 / (n + 1) - 1024 + 16;  // block n + 1 does not fit
    smem = smem > more ? smem : more;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                kb * 100 / 228);
  }
  return cudaSuccess;
}

// One launch of the order's kernel (order 0 window, 1 key, 2 merge); the
// staged rows take C * W floats of dynamic shared memory (twice that where
// the window and key kernels double-buffer; C thresholds besides, and the
// merge kernel's masks), above 48 KB only after opting in. Each order and
// response has a 256-ray build (the main path's 16x16 tiles; the window and
// merge kernels run two blocks per SM, the key kernel at most four), a
// 1024-ray one (one block per SM, at most 64 registers a thread) for tiles
// of 288 to 1024 rays and a cluster build (cluster_launch) above, one ray
// a thread up to 8192 rays and several above. Saved carries (the training
// forward, any build) run the key kernel on any response and the window kernel on the scalar
// one (per-ray origins, each the eye on the primary render), as JAX's
// training forwards do (pallas_march.py:1659-1665); merge order never
// trains. With `info` non-null nothing is launched: info receives the
// kernel's resident blocks per SM at R rays, its dynamic shared memory,
// registers per thread and local memory per thread.
// One launch of a cluster build (kMaxR = kClusterR): n_tiles clusters of
// cluster_blocks(R) blocks of cluster_width(R) threads, by
// cudaLaunchKernelEx with a cluster-dimension attribute. With `info`
// non-null nothing is launched: info as launch_mode's, and info[4] the
// blocks of a cluster, info[5] the clusters that can be resident at once
// (cudaOccupancyMaxActiveClusters); none resident is an error, so that a
// cluster the card cannot schedule fails loudly, never on a smaller build.
// Where the scratch holds fewer tiles than n_tiles (p.scratch_tiles), the
// tiles run as launches of at most that many in stream order, each reusing
// the scratch from its first tile (p.tile0).
template <typename P>
cudaError_t cluster_launch(void (*kernel)(P), const P& p, int n_tiles, int R, int smem,
                           cudaStream_t stream, int* info) {
  if (smem + 1024 > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int n = cluster_blocks(R), width = cluster_width(R);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n_tiles > 0 ? n_tiles : 1) * n));
  cfg.blockDim = dim3((unsigned)width);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info) {
    cudaFuncAttributes fa{};
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, width, smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&info[5], kernel, &cfg);
    info[1] = smem;
    info[2] = fa.numRegs;
    info[3] = (int)fa.localSizeBytes;
    info[4] = n;
    if (err == cudaSuccess && info[5] < 1) err = cudaErrorLaunchOutOfResources;
    return err;
  }
  const int batch = p.scratch_tiles > 0 && p.scratch_tiles < n_tiles ? p.scratch_tiles : n_tiles;
  for (int t0 = 0; t0 < n_tiles; t0 += batch) {
    P q = p;
    q.tile0 = t0;
    cfg.gridDim = dim3((unsigned)((n_tiles - t0 < batch ? n_tiles - t0 : batch) * n));
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, q);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int C, int kR, int K>
cudaError_t launch_mode(const Params& p, int order, int n_tiles, int R, cudaStream_t stream,
                        int* info) {
  constexpr int W = Layout<kR, K, false>::w;
  const bool cl = R > 1024;   // the cluster builds
  const bool wide = R > 256;  // the 1024-ray builds
  constexpr int kCR = kClusterR;
  void (*kernel)(Params) =
      order == 2   ? (cl     ? (cluster_slots(R) > 1 ? march_merge_cluster_kernel<C, kR, K, true>
                                                    : march_merge_cluster_kernel<C, kR, K, false>)
                      : wide ? march_merge_kernel<C, kR, K, 1024>
                             : march_merge_kernel<C, kR, K, 256>)
      : order == 1 ? (cl     ? march_key_kernel<C, kR, K, false, kCR>
                      : wide ? march_key_kernel<C, kR, K, false, 1024>
                             : march_key_kernel<C, kR, K, false, 256>)
      : cl         ? march_kernel<C, kR, K, false, kCR>
      : wide       ? march_kernel<C, kR, K, false, 1024>
                   : march_kernel<C, kR, K, false, 256>;
  const int width = cl ? cluster_width(R) : R;  // threads a block
  int smem = order == 2 ? merge_smem_bytes<C, W>(width) : staged_smem_bytes<C, W>();
  if (p.tin) {
    if (order == 2 || (order == 0 && kR != kScalar)) return cudaErrorInvalidValue;
    if constexpr (kR == kScalar) {
      if (order == 0)
        kernel = cl     ? march_kernel<C, kR, K, true, kCR>
                 : wide ? march_kernel<C, kR, K, true, 1024>
                        : march_kernel<C, kR, K, true, 256>;
    }
    if (order == 1) {
      kernel = cl     ? march_key_kernel<C, kR, K, true, kCR>
               : wide ? march_key_kernel<C, kR, K, true, 1024>
                      : march_key_kernel<C, kR, K, true, 256>;
      smem = staged_smem_bytes<C, Layout<kR, K, true>::w>();
    }
  }
  // the origin centroid's halving tree takes 3R floats of the same memory
  // (more than the staging of a small chunk holds at 1024 rays; a cluster
  // build's, 3 tree_values(R): origin_centroid_tile)
  const int tree = (int)sizeof(float) * 3 * (cl ? tree_values(R) : R);
  if (kR == kOriginQuad && smem < tree) smem = tree;
  if (cl) return cluster_launch(kernel, p, n_tiles, R, smem, stream, info);
  // the static red[32] counts against the 48 KB that needs no opt-in
  if (R <= 256) {
    const cudaError_t err = blocks_per_sm(kernel, smem, order == 1 ? kKeyBlocks : 2);
    if (err != cudaSuccess) return err;
  }
  if (smem + 1024 > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (info) {
    cudaFuncAttributes attr{};
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, R, smem);
    info[1] = smem;
    info[2] = attr.numRegs;
    info[3] = (int)attr.localSizeBytes;
    return err;
  }
  kernel<<<n_tiles, R, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int C, int K>
cudaError_t launch(const Params& p, int order, int n_tiles, int R, cudaStream_t stream,
                   int* info) {
  if (!p.origins) return launch_mode<C, kQuad, K>(p, order, n_tiles, R, stream, info);
  return p.quad ? launch_mode<C, kOriginQuad, K>(p, order, n_tiles, R, stream, info)
                : launch_mode<C, kScalar, K>(p, order, n_tiles, R, stream, info);
}

// The build (its staging capacity C) that marches chunks of c: the
// smallest of 32, 64, 128 and 256 that holds c, and 256 above (key order's
// chunks of more than 256 are staged in pieces). Window and merge order
// march only c = C.
__host__ __device__ constexpr int staging_chunk(int c) {
  return c <= 32 ? 32 : c <= 64 ? 64 : c <= 128 ? 128 : 256;
}

// Every chunk of SH coefficient count K (p.chunk; window and merge order
// one of the four builds'); explicitly instantiated for K = 1 in march.cu
// and for K = 4, 9, 16 in march_sh1.cu, march_sh2.cu and march_sh3.cu.
template <int K>
cudaError_t launch_k(const Params& p, int order, int n_tiles, int R, cudaStream_t stream,
                     int* info) {
  switch (staging_chunk(p.chunk)) {
    case 32: return launch<32, K>(p, order, n_tiles, R, stream, info);
    case 64: return launch<64, K>(p, order, n_tiles, R, stream, info);
    case 128: return launch<128, K>(p, order, n_tiles, R, stream, info);
    default: return launch<256, K>(p, order, n_tiles, R, stream, info);
  }
}

// Floats of carried state (Params::carry) a ray of a tile of R rays needs
// in order `order` (0 window, 1 key, 2 merge) at staging capacity C: none
// where each thread marches one ray.
inline int carry_fields(int order, int C, int R) {
  if (cluster_slots(R) < 2) return 0;
  return order == 2 ? merge_fields(C) : order == 1 ? kKeyFields : kWinFields;
}

}  // namespace k1
