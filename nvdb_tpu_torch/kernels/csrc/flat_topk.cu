// Exact flat-scan top-k for Hopper (sm_90a): scores every valid store row
// against a batch of queries and returns each query's k best (score, id).
//
// Replaces the Pallas TPU kernel nvdb_tpu/kernels/flat_scan.py:pallas_flat_topk
// (body _make_kernel :133-364, scoring _scores :98-130, final sort
// _merge_topk_sorted :76-95). Same contract:
//   * score = dot(q, row), one code path per store type:
//       f32 store     both operands split into three bf16 parts, six passes
//                     of bf16 products with f32 sums (the TPU's HIGHEST; no
//                     TF32 in any form); the SIMT kernel of f32 FMA stays as
//                     the A/B (mode 0);
//       bf16 store    query rounded to bf16 first, exact products, f32 sums;
//       int8 store    query rounded to bf16, codes widened exactly, f32 sum,
//                     times the row's scale;
//       int8 x int8   exact int32 sum, times row scale, times query scale
//                     (in that order, as the reference does);
//   * rows with id >= n_valid are never returned (n_valid is a runtime int);
//   * output sorted by score descending, ties to the larger id; slots that
//     no valid row fills hold (-inf, -1); k <= 128.
//
// What bounds it on an H100 SXM (NVIDIA data sheet: 3.35 TB/s HBM, 989
// TFLOP/s dense bf16 and 1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s
// SIMT f32). A scan of N rows of Dp dims at batch B is 2 B N Dp operations
// over the store's bytes, B multiply-adds per element read. On the tensor
// cores the ridge is ~295 op/byte, so the bf16 scan is bound by bytes up to
// B ~ 295 and by the tensor cores above: 1M x 768 at B = 512 is 786 GFLOP,
// 0.80 ms, against 0.46 ms for its 1.54 GB. The SIMT kernel that this one
// replaces for bf16 and int8 stores was bound by the SIMT rate (30.6 ms at
// that shape). Measured on an NVIDIA H100 80GB HBM3, 700.00 W (1M x 768,
// k = 10; chip_smoke.py phase 5 and tools.flat_breakdown; more in PERF.md):
// bf16 B = 512 about 1.45 ms against 1.02-1.05 for the same ring with the
// filter compiled out, and 0.62 ms at B = 8. What remains above the ring is
// the handling of candidates at each tile's end, while the tensor cores
// wait: a warp that issues wgmma has only some 300 cycles of slack a chunk
// (the issue of a chunk's four products takes most of its time), so work
// put between them lengthens the chunk, and two warpgroups run out of phase
// spend the ring's prefetch depth. The handling is therefore made smaller,
// not moved: candidates come down from 14 to under 5 a warp and tile at
// bf16 B = 512. f32 on the tensor cores: 9.0-9.5 ms at B = 512 (the SIMT
// kernel 29.84, its ring alone 8.22) and 1.98 ms at B = 8.
//
// Design of the tensor-core path (scan_wgmma_kernel; every store type):
//   * Orientation: queries are M, store rows are N. A CTA holds TQ = 128
//     queries, 64 per consumer warpgroup, and walks its row slice in tiles
//     of TN = 256 rows; one tile is 4 x (Dp / 64) wgmma m64n256k16 per
//     warpgroup (k32 for int8 x int8), both operands K-major as they lie in
//     memory. In the accumulator a thread then holds 64 rows' scores for
//     each of two queries, so "does this score beat the query's k-th" is a
//     compare against a value the thread keeps in a register: no score goes
//     through shared memory, only the candidates do. The other orientation
//     (rows as M) would put a different query in every accumulator column
//     and the thresholds in shared memory.
//   * The filter. Sixteen scores at a time are held against the thread's
//     two thresholds, and a warp vote skips a group with no candidate. In
//     a group with one, the lanes mark which of their sixteen pass, the
//     warp walks the few marked in any lane, and the lanes with a candidate
//     there push (score, row, query) into the warp's queue in shared memory
//     at slots counted by a ballot; at the end of the tile the warp drains
//     the queue into the sorted lists of its own sixteen queries (a warp
//     owns exactly the queries whose scores it holds, so the lists need no
//     barrier) and reloads the thresholds. For
//     k <= 32 the lanes insert side by side, one lane per query with a
//     serial shift; longer lists take the warp-wide insert of
//     topk_common.cuh. A queue that overflows (a slice's first tile, while
//     the thresholds are low) is dropped and the tile scanned again in
//     order, in rounds of at most 128 candidates with a drain after each.
//     Every insert compares (score, id) pairs with the list, so the result
//     does not depend on the order in which candidates arrive.
//   * Bounds shared by the slices. A threshold only has to be a (score, id)
//     pair that at least k rows reach, whichever slice holds them, so the
//     slices tell each other theirs through global memory (`bounds`, zeroed
//     by the prologue): after a drain each list publishes its k-th pair
//     (64-bit atomic max on a key in better()'s order) and its top-1 score
//     into bucket s % k of its query (k <= 16 and at least k slices); the
//     least of a query's k buckets is reached by k rows of k distinct
//     slices, close to the k-th best of all the rows scanned so far. A
//     thread reads its two queries' bounds when a tile begins and raises its
//     thresholds to them at the tile's end. A slice's first tile, before any
//     bound exists, takes for k <= 16 the k-th largest of the c = ceil(k /
//     4) best scores that each of the four threads sharing a query holds,
//     so its queue holds about k candidates a query and not all 256. The
//     result is the same top-k: a row below a bound has k better rows.
//   * A ring of up to four stages fed by TMA. One producer thread starts,
//     per 128-byte-wide chunk of the dims, a [128 queries x 128 B] and a
//     [256 rows x 128 B] box (SWIZZLE_128B, the layout the wgmma descriptor
//     reads) into a stage and arms its mbarrier with the byte count; the
//     consumers wait on it, start their wgmma, and release the stage of the
//     chunk before once its products are done, so the loads of the next
//     chunks overlap the products and the filter of this tile. Queries are
//     streamed with the rows (they hit in L2): 48 KB a stage, and the lists
//     (TQ x k x 8 bytes) take what is left of the 227 KB, so the ring of a
//     bf16 store has 4 stages up to k = 25, 3 up to 73, 2 up to 121 and 1
//     above (with one stage the loads no longer overlap the products). The
//     producer warpgroup gives its registers to the consumers (setmaxnreg).
//   * The query is rounded to bf16 once, by a small prologue kernel.
//   * int8 store with f32 queries: the int8 chunk is staged as it is
//     (64 B a row), the consumer threads widen it (exactly) into one of two
//     swizzled bf16 tiles in shared memory, and the bf16 wgmma reads that;
//     the widening of chunk c overlaps the products of chunk c - 1. Two
//     named barriers a chunk keep the warpgroups in step around the tiles.
//   * int8 x int8: wgmma s8 x s8 -> s32, exact in any order, so the result
//     equals the plain version bit for bit.
//   * int8 stores: each thread asks for two of the tile's 256 row scales
//     before the tile's products and puts them into its warpgroup's copy in
//     shared memory after them, so the filter reads the scales from there
//     and never waits for memory.
//   * The ragged edge: TMA fills rows past the store and queries past B
//     with zeros. Rows at or past n_valid are masked by id in the filter;
//     the lists of queries past B start full of (+inf, INT_MAX), so nothing
//     enters them, and they are not written out.
//   * Reading the store fewer times: the grid is ordered query block
//     fastest, so the B / 128 CTAs that share a row slice run side by side
//     and walk it together: at B = 512 a row is read by 4 CTAs, from memory
//     once where L2 still holds it, and at B <= 128 by one. The wrapper
//     picks the slice count so that the whole grid is one wave of one CTA
//     per SM. Clusters of those CTAs with one multicast load per row tile
//     were tried and measured slower: the slowest warp of the cluster then
//     holds every stage.
//   * Small batches: with fewer than 65 queries in a block the second
//     warpgroup exits, and the kernel is bound by the ring's load rate.
//   pass 2 (nvdb::merge_kernel, topk_common.cuh): one warp per query folds
//     the S sorted partial lists into the final sorted top-k.
//
// f32 stores on the tensor cores (Cfg<kF32>). 1M x 768 at B = 512 is six
// times the bf16 scan's products, 4.77 ms on the tensor cores, against 0.92
// ms for its 3.07 GB: bound by operations above B ~ 98. Each operand is
// split as h = bf16(x), m = bf16(x - h), l = bf16(x - h - m) (exact: h + m
// + l == x for every |x| >= 2^-110), and the score is qm rm + ql rh + qh rl
// + qm rh + qh rm + qh rh; the dropped terms are ~2^-24 of the score.
//   * The queries are split once by the prologue kernel into three planes
//     [3][B][Dp]; one TMA box brings a chunk's three planes (3 x 128 queries
//     x 32 dims, the 64-byte swizzle).
//   * The rows are staged as they lie in memory (128 bytes of f32 a row and
//     chunk, 4 bytes read per element and nothing else); the consumer
//     threads split the chunk into three swizzled bf16 tiles in shared
//     memory, which the wgmma reads, while the products of the chunk before
//     run. Two split tiles while a ring of two stages fits beside the lists
//     (k <= 97), else one (the split then waits for the products).
//   * 128-row tiles (m64n128k16): each chunk's twelve products (six passes,
//     two k16 steps, the products of the high parts last) go into a fresh
//     accumulator, which is added to the tile's running sums in registers
//     (round to nearest) once the next chunk's products have been issued.
//     The tensor cores' own additions truncate; summed over a whole row in
//     one accumulator, the six passes came out several times further from
//     float64 than the SIMT kernel's f32 FMA; with a fresh sum per chunk
//     they come out closer (chip_smoke.py phase 3 prints both against
//     float64 and holds the tensor cores to at most twice the SIMT error).
//     The two arrays of 64 floats take the registers that one 256-row
//     accumulator would.
//
// The SIMT kernel (scan_f32_kernel, mode 0; flat_topk_cuda(f32_kernel=
// "simt")) scores a 64 x 64 tile with 4 x 4 register tiles of fmaf over
// chunks staged in shared memory: the A/B of the f32 instance, on no default
// path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"
#include "topk_common.cuh"

namespace {

using nvdb::acc_fence;
using nvdb::bar_sync;
using nvdb::better;
using nvdb::encode_tiled_fn;
using nvdb::EncodeTiledFn;
using nvdb::FULL_MASK;
using nvdb::mbar_arrive;
using nvdb::mbar_expect_tx;
using nvdb::mbar_init;
using nvdb::mbar_wait;
using nvdb::smem_u32;
using nvdb::sw128_desc;
using nvdb::tma_load_2d;
using nvdb::warp_insert;
using nvdb::warp_offer;
using nvdb::wgmma_commit;
using nvdb::wgmma_fence;
using nvdb::wgmma_wait;
using nvdb::widen_i8x16;

constexpr int MAX_K = nvdb::WARP_LIST_MAX_K;

// Measurement builds of tools.flat_breakdown, whose results are wrong by
// design; the library that the port loads is built without the definition.
//   1  no filter: the ring and the products alone;
//   2  compares only: every score is held against thresholds that never
//      rise, and the candidates are dropped;
//   3  counters: the kernel's results, with clock reads around each part of
//      a tile's handling and counts of tiles and candidates, summed over the
//      consumer warps into g_counters (nvdb_flat_counters reads them).
#ifndef NVDB_FLAT_ABLATE
#define NVDB_FLAT_ABLATE 0
#endif

#if NVDB_FLAT_ABLATE == 3
// The counters, each summed over the consumer warps of a call: warp-tiles,
// warp-tiles whose thresholds another slice's published bound raised,
// warp-tiles that took the overflow rescan, candidates drained, groups of
// sixteen walked; then SM clock cycles of the warp-tiles in all, and at the
// tiles' ends waiting for the last products, in the compares and votes, in
// the marks, walk and pushes, in the drains, threshold reloads and bounds'
// publication, and in the overflow rescans.
enum Counter {
  kTiles, kTightened, kOverflowTiles, kDrained, kWalkedGroups, kCycTile, kCycWait,
  kCycCompare, kCycWalk, kCycDrain, kCycRescan, kCounters
};
__device__ unsigned long long g_counters[kCounters];
__device__ __forceinline__ unsigned clock32() {
  unsigned c;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(c)::"memory");
  return c;
}
#define NVDB_TICK(x) const unsigned x = clock32()
#define NVDB_COUNT(i, v) (ctr[i] += (unsigned)(v))
#else
#define NVDB_TICK(x)
#define NVDB_COUNT(i, v)
#endif

// The C entry's modes: kF32Simt is the SIMT kernel of f32 stores (the A/B);
// the others are instances of the tensor-core kernel.
enum Mode { kF32Simt = 0, kBF16 = 1, kI8 = 2, kI8Q8 = 3, kF32 = 4 };

// ---------------------------------------------------------------------------
// The SIMT path: f32 stores.
// ---------------------------------------------------------------------------

constexpr int QB = 64;        // queries per CTA
constexpr int TR = 64;        // rows per tile
constexpr int DK = 64;        // dims per staged chunk
constexpr int LD = QB + 4;    // shared-memory row stride (floats), 16-byte aligned
constexpr int NT = 256;       // threads per CTA

static_assert(QB == TR, "the 16 x 16 thread grid covers a QB x TR tile");
static_assert(QB <= DK, "the [QB][LD] score tile reuses the [DK][LD] query chunk");

// Staging. A [64 x DK] f32 block (rows r0.., dims d0..) is read in 16-byte
// pieces: piece f is half (f & 1) of 32-byte sector (f >> 7) of row
// (f >> 1) & 63, so two neighbouring threads read one whole sector and a
// warp reads sixteen rows. The block is stored transposed, dst[d * LD + r]:
// with LD = 68 the two halves of a sector land 16 banks apart, so a warp's
// stores hit 32 distinct banks. Rows at or past r_lim are zero.
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, int r0,
                                          int r_lim, int Dp, int d0, float* dst,
                                          int tid) {
#pragma unroll
  for (int p = 0; p < (64 * DK / 4) / NT; ++p) {
    const int f = tid + NT * p;
    const int r = (f >> 1) & 63, c = (f >> 7) * 8 + (f & 1) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < r_lim)
      v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * Dp + d0 + c);
    dst[(c + 0) * LD + r] = v.x;
    dst[(c + 1) * LD + r] = v.y;
    dst[(c + 2) * LD + r] = v.z;
    dst[(c + 3) * LD + r] = v.w;
  }
}

__global__ void __launch_bounds__(NT, 2)
scan_f32_kernel(const float* __restrict__ qptr, const float* __restrict__ vptr,
                float* __restrict__ part_vals, int* __restrict__ part_ids, int B,
                int Dp, int n_eff, int k, int S, int rows_per_slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [DK][LD] queries, dim-major
  float* Bs = As + DK * LD;                    // [DK][LD] rows, dim-major
  float* Ss = As;                              // [QB][LD] tile scores (reuses As)
  float* lv = Bs + DK * LD;                    // [QB][k] list scores
  int* li = reinterpret_cast<int*>(lv + QB * k);  // [QB][k] list ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.y * QB;
  const int s = blockIdx.x;
  const int r_begin = s * rows_per_slice;
  const int r_end = min(n_eff, r_begin + rows_per_slice);

  for (int i = tid; i < QB * k; i += NT) {
    lv[i] = -INFINITY;
    li[i] = -1;
  }
  __syncthreads();

  const float* qf = qptr + (size_t)q0 * Dp;
  for (int r0 = r_begin; r0 < r_end; r0 += TR) {
    float acc[4][4] = {};
    for (int d0 = 0; d0 < Dp; d0 += DK) {
      stage_f32(qf, 0, B - q0, Dp, d0, As, tid);
      stage_f32(vptr, r0, r_end, Dp, d0, Bs, tid);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(As + kk * LD + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(Bs + kk * LD + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // the tile's scores to shared memory
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) Ss[(ty * 4 + i) * LD + tx * 4 + j] = acc[i][j];
    __syncthreads();

    // running top-k: warp w owns queries w, w + 8, ...; a score is tested
    // against the query's k-th entry first, only improvers are inserted
    for (int qi = warp; qi < QB && q0 + qi < B; qi += NT / 32) {
#pragma unroll
      for (int h = 0; h < TR; h += 32) {
        const int row = r0 + h + lane;
        warp_offer(lv + qi * k, li + qi * k, k, Ss[qi * LD + h + lane], row,
                   row < r_end, lane);
      }
    }
    __syncthreads();  // Ss aliases As, which the next tile overwrites
  }

  for (int i = tid; i < QB * k; i += NT) {
    const int qi = i / k, j = i - qi * k;
    const int b = q0 + qi;
    if (b < B) {
      const size_t o = ((size_t)b * S + s) * k + j;
      part_vals[o] = lv[i];
      part_ids[o] = li[i];
    }
  }
}

cudaError_t launch_f32(const float* q, const float* v, float* part_vals, int* part_ids,
                       int B, int Dp, int n_eff, int k, int S, cudaStream_t stream) {
  const int tiles = (n_eff + TR - 1) / TR;
  const int rows_per_slice = ((tiles + S - 1) / S) * TR;
  const size_t smem = (size_t)2 * DK * LD * sizeof(float) + (size_t)QB * k * 8;
  cudaError_t e = cudaFuncSetAttribute(
      scan_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(S, (B + QB - 1) / QB);
  scan_f32_kernel<<<grid, NT, smem, stream>>>(q, v, part_vals, part_ids, B, Dp, n_eff,
                                              k, S, rows_per_slice);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core path: bf16, int8 and int8 x int8 stores.
// ---------------------------------------------------------------------------

constexpr int TQ = 128;            // queries per CTA: 64 per consumer warpgroup
constexpr int CHUNK = 128;         // bytes of a row's dims per staged chunk (bf16, int8)
constexpr int MAX_STAGES = 4;
constexpr int NT_TC = 384;         // two consumer warpgroups and the producer's
constexpr int QCAP = 128;          // candidates a warp queues before it drains
constexpr int QUEUES_BYTES = 8 * QCAP * 8;   // eight warps' queues
constexpr int MAX_BUCKETS = 16;    // a query's published top-1 buckets (k <= 16)
constexpr int SPLIT_DIMS = 32;     // f32 stores: dims per chunk (128 bytes of f32 a row)
constexpr int SPLIT_ROW = 2 * SPLIT_DIMS;    // bytes of a row in one bf16 plane

// Per store type: rows per tile (the wgmma's N), the queries' box of a
// stage (A_BYTES; A_ROW bytes a query row), the rows' box (B_BYTES), one
// converted row tile (CVT_ONE: the widened int8 tile, or the f32 chunk's
// three bf16 planes), dims per chunk, bytes of the filter's own room (the
// candidate queues and, for int8 stores, each warpgroup's copy of the
// tile's row scales; with converted tiles both lie over the first of them).
template <int MODE> struct Cfg;
template <> struct Cfg<kBF16> {
  static constexpr int TN = 256, A_ROW = CHUNK, A_BYTES = TQ * CHUNK, B_BYTES = TN * CHUNK,
                       CVT_ONE = 0, Q_DIMS = 64, V_DIMS = 64, FILTER_BYTES = QUEUES_BYTES;
};
template <> struct Cfg<kI8Q8> {
  static constexpr int TN = 256, A_ROW = CHUNK, A_BYTES = TQ * CHUNK, B_BYTES = TN * CHUNK,
                       CVT_ONE = 0, Q_DIMS = 128, V_DIMS = 128,
                       FILTER_BYTES = QUEUES_BYTES + 2 * TN * 4;
};
template <> struct Cfg<kI8> {
  static constexpr int TN = 256, A_ROW = CHUNK, A_BYTES = TQ * CHUNK, B_BYTES = TN * 64,
                       CVT_ONE = TN * CHUNK, Q_DIMS = 64, V_DIMS = 64, FILTER_BYTES = 0;
};
template <> struct Cfg<kF32> {
  static constexpr int TN = 128, A_ROW = SPLIT_ROW, A_BYTES = 3 * TQ * SPLIT_ROW,
                       B_BYTES = TN * SPLIT_DIMS * 4, CVT_ONE = 3 * TN * SPLIT_ROW,
                       Q_DIMS = SPLIT_DIMS, V_DIMS = SPLIT_DIMS, FILTER_BYTES = 0;
};
template <int MODE>
__host__ __device__ constexpr bool has_scales() {
  return MODE == kI8 || MODE == kI8Q8;
}
template <int MODE>
__host__ __device__ constexpr bool converts() {   // the rows' chunk is converted in shared memory
  return MODE == kI8 || MODE == kF32;
}

// The same with a third coordinate (c2: the plane of the f32 queries' split).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same in the 64-byte swizzle (the bf16 planes of f32 stores): rows of
// 64 bytes, 8-row groups 512 bytes apart; the tile starts on a 512-byte
// boundary. A step of 32 bytes along K adds 2.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

#define NVDB_ACC8(c, a, o)                                                           \
  c(a[o]), c(a[o + 1]), c(a[o + 2]), c(a[o + 3]), c(a[o + 4]), c(a[o + 5]),          \
      c(a[o + 6]), c(a[o + 7])
#define NVDB_ACC128(c, a)                                                            \
  NVDB_ACC8(c, a, 0), NVDB_ACC8(c, a, 8), NVDB_ACC8(c, a, 16), NVDB_ACC8(c, a, 24),  \
      NVDB_ACC8(c, a, 32), NVDB_ACC8(c, a, 40), NVDB_ACC8(c, a, 48),                 \
      NVDB_ACC8(c, a, 56), NVDB_ACC8(c, a, 64), NVDB_ACC8(c, a, 72),                 \
      NVDB_ACC8(c, a, 80), NVDB_ACC8(c, a, 88), NVDB_ACC8(c, a, 96),                 \
      NVDB_ACC8(c, a, 104), NVDB_ACC8(c, a, 112), NVDB_ACC8(c, a, 120)
#define NVDB_ACC64(c, a)                                                             \
  NVDB_ACC8(c, a, 0), NVDB_ACC8(c, a, 8), NVDB_ACC8(c, a, 16), NVDB_ACC8(c, a, 24),  \
      NVDB_ACC8(c, a, 32), NVDB_ACC8(c, a, 40), NVDB_ACC8(c, a, 48), NVDB_ACC8(c, a, 56)
#define NVDB_REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define NVDB_REGS128                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "   \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "     \
  "%125, %126, %127}"
#define NVDB_F(x) "+f"(x)
#define NVDB_R(x) "+r"(x)

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], bf16 operands, f32 sums; the sums
// start from zero where accumulate == 0.
__device__ __forceinline__ void wgmma_tile(float (&d)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " NVDB_REGS128
      ", %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : NVDB_ACC128(NVDB_F, d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 operands, f32 sums.
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NVDB_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : NVDB_ACC64(NVDB_F, d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 256] (+)= A[64 x 32] B[32 x 256], int8 operands, int32 sums.
__device__ __forceinline__ void wgmma_tile(int (&d)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " NVDB_REGS128
      ", %128, %129, p;\n"
      "}\n"
      : NVDB_ACC128(NVDB_R, d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// nvdb::acc_fence for the int32 accumulators of int8 x int8.
template <int N>
__device__ __forceinline__ void acc_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The three-way bf16 split of two f32 values, round to nearest even at each
// step: h = bf16(x), m = bf16(x - h), l = bf16((x - h) - m). Both
// subtractions are exact in f32, and h + m + l == x wherever x's lowest set
// bit is at or above 2^-133 (bf16's least subnormal): every |x| >= 2^-110.
__device__ __forceinline__ void split_bf16x3_pair(float x0, float x1, uint32_t& h,
                                                  uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(hb), r1 = x1 - __high2float(hb);
  const __nv_bfloat162 mb = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 lb =
      __floats2bfloat162_rn(r0 - __low2float(mb), r1 - __high2float(mb));
  h = *reinterpret_cast<const uint32_t*>(&hb);
  m = *reinterpret_cast<const uint32_t*>(&mb);
  l = *reinterpret_cast<const uint32_t*>(&lb);
}

// Splits a [rows x 32] f32 chunk, rows of 128 bytes as TMA staged it, into
// three [rows x 32] bf16 planes (h, m, l; rows of 64 bytes, planes `plane`
// bytes apart) in the 64-byte swizzle that the wgmma descriptor reads: the
// 16-byte piece j of row r lies at piece j ^ ((r >> 1) & 3). Thread i of n
// takes the 16-byte f32 pieces i, i + n, ...: four f32 a piece, a warp reads
// 512 contiguous bytes and writes 256 contiguous bytes of each plane.
__device__ __forceinline__ void split_chunk(const unsigned char* src, unsigned char* dst,
                                           int rows, int plane, int tid, int n) {
  for (int p = tid; p < rows * 8; p += n) {
    const float4 x = *reinterpret_cast<const float4*>(src + p * 16);
    uint2 h, m, l;
    split_bf16x3_pair(x.x, x.y, h.x, m.x, l.x);
    split_bf16x3_pair(x.z, x.w, h.y, m.y, l.y);
    const int row = p >> 3, q = p & 7;
    const int off = row * SPLIT_ROW + ((((q >> 1) ^ (row >> 1)) & 3) << 4) + (q & 1) * 8;
    *reinterpret_cast<uint2*>(dst + off) = h;
    *reinterpret_cast<uint2*>(dst + plane + off) = m;
    *reinterpret_cast<uint2*>(dst + 2 * plane + off) = l;
  }
}

// Sixteen of a thread's accumulators as scores. Accumulator 4 j + e is the
// score of tile row 8 j + 2 (lane % 4) + (e & 1) for the warp's query
// lane / 4 (e < 2) or lane / 4 + 8 (e >= 2); group g holds j = 4 g .. 4 g + 3.
// col0 = 2 (lane % 4) is the thread's first column. int8 stores: times the
// row's scale (wg_scales: the tile's, in shared memory, zero past n_valid),
// then (int8 queries) the query's. Returns whether any score reaches its
// query's threshold value.
template <int MODE, int N, typename Acc>
__device__ __forceinline__ bool group_scores(const Acc (&acc)[N], int g, int col0,
                                             const float* wg_scales, float qs0, float qs1,
                                             float thv0, float thv1, float (&sc)[16]) {
  bool any = false;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = g * 4 + jj;
    float rs0 = 1.f, rs1 = 1.f;
    if constexpr (has_scales<MODE>()) {
      const float2 rs = *reinterpret_cast<const float2*>(wg_scales + j * 8 + col0);
      rs0 = rs.x;
      rs1 = rs.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = static_cast<float>(acc[4 * j + e]);
      if constexpr (has_scales<MODE>()) v = v * ((e & 1) ? rs1 : rs0);
      if constexpr (MODE == kI8Q8) v = v * ((e & 2) ? qs1 : qs0);
      sc[4 * jj + e] = v;
      any |= v >= ((e & 2) ? thv1 : thv0);
    }
  }
  return any;
}

// sc[x] for an x known only at run time (a chain of selects: the scores
// stay in registers).
__device__ __forceinline__ float pick(const float (&sc)[16], int x) {
  float v = sc[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) v = x == i ? sc[i] : v;
  return v;
}

// A queued candidate: (score, row of the tile | the warp's query << 8).
__device__ __forceinline__ uint2 queue_entry(float v, int col, int ql) {
  return make_uint2(__float_as_uint(v), (unsigned)(col | (ql << 8)));
}

// A (score, id) pair as one 64-bit key whose unsigned order is better()'s
// order: the score's bits mapped to an unsigned order (-0 taken as +0, as
// better() compares it), then id + 1 (ids from -1). Slices publish their
// k-th pair as such a key, and an atomic max keeps the best of them.
__device__ __forceinline__ unsigned long long bound_key(float v, int id) {
  const unsigned f = __float_as_uint(v + 0.f);
  const unsigned o = (f & 0x80000000u) ? ~f : (f | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned)(id + 1);
}

// The score part of bound_key alone: a bound with id -1 admits every row
// of that score, so a bucket's key need not carry its row.
__device__ __forceinline__ unsigned score_key(float v) {
  return (unsigned)(bound_key(v, -1) >> 32);
}

// Raises the threshold (thv, thi) to the pair of key where that is better.
__device__ __forceinline__ bool raise_to(unsigned long long key, float& thv, int& thi) {
  if (key <= bound_key(thv, thi)) return false;
  const unsigned o = (unsigned)(key >> 32);
  thv = __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
  thi = (int)((unsigned)key - 1u);
  return true;
}

// The k-th largest of the 4 c values that the four threads of a quad hold
// c each (own[0..c-1]; k <= 4 c <= 16): the largest value that at least k
// of them reach. Run once a slice, so kept short rather than unrolled.
__device__ __forceinline__ float quad_kth(const float (&own)[4], int c, int k) {
  float all[16];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = q == 0 ? own[i] : __shfl_xor_sync(FULL_MASK, own[i], q);
      all[q * 4 + i] = i < c ? v : -INFINITY;
    }
  float best = -INFINITY;
  for (int i = 0; i < 16; ++i) {
    const float v = pick(all, i);
    int n = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) n += all[j] >= v && (j & 3) < c;
    if ((i & 3) < c && n >= k) best = fmaxf(best, v);
  }
  return best;
}

// A slice's first tile, k <= 16: each thread keeps the c best (c = ceil(k /
// 4) <= 4) of its valid scores of each of its two queries, and the k-th
// largest of the 4 c that the four threads sharing a query hold is a bound
// with at least k rows of the tile at or above it: the tile's queue then
// takes about k candidates a query, not every score, and the overflow rescan
// most often is not needed. Returns the two bounds' keys (zero where the
// tile has fewer than k valid rows).
template <int MODE, int N, typename Acc>
__device__ __forceinline__ void first_tile_bounds(const Acc (&acc)[N], int col0, int tile_row,
                                                  int n_eff, int k, const float* wg_scales,
                                                  float qs0, float qs1, unsigned long long& key0,
                                                  unsigned long long& key1) {
  float t0[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float t1[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int g = 0; g < N / 16; ++g) {
    float sc[16];
    group_scores<MODE, N>(acc, g, col0, wg_scales, qs0, qs1, 0.f, 0.f, sc);
    for (int x = 0; x < 16; x += 4) {   // once a slice: short, not unrolled
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (g * 4 + (x >> 2)) * 8 + col0 + (e & 1);
        const float v = tile_row + col < n_eff ? pick(sc, x + e) : -INFINITY;
        float(&t)[4] = (e & 2) ? t1 : t0;
        t[3] = fmaxf(t[3], fminf(t[2], v));
        t[2] = fmaxf(t[2], fminf(t[1], v));
        t[1] = fmaxf(t[1], fminf(t[0], v));
        t[0] = fmaxf(t[0], v);
      }
    }
  }
  const int c = (k + 3) / 4;
  const float m0 = quad_kth(t0, c, k), m1 = quad_kth(t1, c, k);
  key0 = m0 == -INFINITY ? 0ull : bound_key(m0, -1);
  key1 = m1 == -INFINITY ? 0ull : bound_key(m1, -1);
}

// Inserts up to 32 candidates, one per lane (ok: the lane has one, for the
// warp's query ql), into the warp's lists. Short lists (k <=
// LANE_INSERT_MAX_K): the lanes insert on their own, each with a serial
// shift from the tail of its query's list, one lane per list in a round, so
// candidates of different queries go in side by side. Long lists: those that
// beat their list's tail are inserted one by one with the whole warp, the
// rest held against the new tail after each.
constexpr int LANE_INSERT_MAX_K = 32;

__device__ __forceinline__ void insert_batch(float v, int id, int ql, bool ok, float* wlv,
                                             int* wli, int k, int lane) {
  float* mv = wlv + ql * k;
  int* mi = wli + ql * k;
  ok = ok && better(v, id, mv[k - 1], mi[k - 1]);
  unsigned m = __ballot_sync(FULL_MASK, ok);
  if (k <= LANE_INSERT_MAX_K) {
    while (m) {
      if (ok) {
        const unsigned peers = __match_any_sync(m, ql);
        if (__ffs(peers) - 1 == lane) {
          // the tail may have risen since this candidate was tested
          if (better(v, id, mv[k - 1], mi[k - 1])) {
            int j = k - 1;
            while (j > 0 && better(v, id, mv[j - 1], mi[j - 1])) {
              mv[j] = mv[j - 1];
              mi[j] = mi[j - 1];
              --j;
            }
            mv[j] = v;
            mi[j] = id;
          }
          ok = false;
        }
      }
      __syncwarp();
      m = __ballot_sync(FULL_MASK, ok);
    }
  } else {
    while (m) {
      const int src = __ffs(m) - 1;
      const float bv = __shfl_sync(FULL_MASK, v, src);
      const int bid = __shfl_sync(FULL_MASK, id, src);
      const int bq = __shfl_sync(FULL_MASK, ql, src);
      warp_insert(wlv + bq * k, wli + bq * k, k, bv, bid, lane);
      ok = ok && better(v, id, mv[k - 1], mi[k - 1]);
      m = (m & (m - 1)) & __ballot_sync(FULL_MASK, ok);
    }
  }
}

// Drains the first cnt entries of a warp's queue into its lists.
__device__ __forceinline__ void drain_queue(const uint2* queue, int cnt, int tile_row,
                                            float* wlv, int* wli, int k, int lane) {
  for (int base = 0; base < cnt; base += 32) {
    const bool have = base + lane < cnt;
    const uint2 en = queue[have ? base + lane : 0];
    insert_batch(__uint_as_float(en.x), tile_row + (int)(en.y & 255u),
                 have ? (int)(en.y >> 8) : 0, have, wlv, wli, k, lane);
  }
  __syncwarp();
}

// The queries' prologue: the bf16-rounded query (planes = 1: bf16 and int8
// stores), or its three-way split (planes = 3: f32 stores) as planes
// [3][B][Dp] of n = B * Dp values each (planes = 0, int8 queries: none);
// and the B queries' published bounds (8 + 4 MAX_BUCKETS bytes a query)
// set to zero, below every pair.
__global__ void round_queries_kernel(const float* __restrict__ q,
                                     __nv_bfloat16* __restrict__ out, size_t n, int planes,
                                     unsigned* __restrict__ bounds, int B) {
  const size_t step = (size_t)gridDim.x * blockDim.x;
  const size_t words = (size_t)B * (2 + MAX_BUCKETS);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < words; i += step)
    bounds[i] = 0;
  if (planes == 0) return;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const float x = q[i];
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    out[i] = h;
    if (planes == 3) {
      const float r = x - __bfloat162float(h);
      const __nv_bfloat16 m = __float2bfloat16_rn(r);
      out[n + i] = m;
      out[2 * n + i] = __float2bfloat16_rn(r - __bfloat162float(m));
    }
  }
}

// The shared memory of scan_wgmma_kernel after its 1024-byte alignment:
// stages, converted tiles, lists, the warps' candidate queues, barriers, the
// queues' counters.
template <int MODE>
__host__ __device__ constexpr int stage_bytes() {
  return Cfg<MODE>::A_BYTES + Cfg<MODE>::B_BYTES;
}

template <int MODE>
__global__ void __launch_bounds__(NT_TC, 1)
scan_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ scales, const float* __restrict__ qscales,
                  float* __restrict__ part_vals, int* __restrict__ part_ids,
                  unsigned long long* __restrict__ bounds, int B, int n_eff, int k, int S,
                  int n_qblocks, int tiles_per_slice, int n_tiles, int n_chunks,
                  int n_stages, int n_cvt) {
  using C = Cfg<MODE>;
  using Acc = typename std::conditional<MODE == kI8Q8, int, float>::type;
  constexpr int STAGE = stage_bytes<MODE>();
  constexpr int TN = C::TN;
  constexpr int ACC = TN / 2;   // accumulator registers per thread

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* cvt = sm + (size_t)n_stages * STAGE;
  float* lv = reinterpret_cast<float*>(cvt + (size_t)n_cvt * C::CVT_ONE);   // [TQ][k]
  int* li = reinterpret_cast<int*>(lv + TQ * k);                            // [TQ][k]
  // The filter's room: [8 warps][QCAP] candidate queues and (int8 stores)
  // [2 warpgroups][TN] row scales. With converted tiles it lies over the
  // first of them: it is in use only between a tile's last product and the
  // next tile's first barrier, when no thread converts and no wgmma reads.
  unsigned char* filter_room =
      converts<MODE>() ? cvt : reinterpret_cast<unsigned char*>(li + TQ * k);
  uint2* queues = reinterpret_cast<uint2*>(filter_room);
  float* tile_scales = reinterpret_cast<float*>(filter_room + QUEUES_BYTES);   // [2][TN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(li + TQ * k) + C::FILTER_BYTES);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + MAX_STAGES);
  const uint32_t stage0 = smem_u32(sm);

  const int qblock = blockIdx.x % n_qblocks, s = blockIdx.x / n_qblocks;
  const int q0 = qblock * TQ;
  const int t_begin = min(n_tiles, s * tiles_per_slice);
  const int t_end = min(n_tiles, t_begin + tiles_per_slice);
  // warpgroups with queries: the second one leaves when the block has <= 64
  const int n_wg = B - q0 > 64 ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(full0 + 8 * i, 1);            // the producer's arrive + the bytes
      mbar_init(empty0 + 8 * i, 4 * n_wg);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer ----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t dst = stage0 + stage * STAGE;
          mbar_expect_tx(full, STAGE);
          if constexpr (MODE == kF32)   // the three planes of the chunk's queries
            tma_load_3d(dst, &qmap, full, c * C::Q_DIMS, q0, 0);
          else
            tma_load_2d(dst, &qmap, full, c * C::Q_DIMS, q0);
          tma_load_2d(dst + C::A_BYTES, &vmap, full, c * C::V_DIMS, t * TN);
          if (++stage == n_stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    if (wg < n_wg) {
      const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
      const int quad = lane >> 2;
      // the warp's sixteen queries and their lists; a thread's accumulators
      // belong to queries quad and quad + 8 of them
      const int wq0 = wg * 64 + w * 16;
      float* wlv = lv + wq0 * k;
      int* wli = li + wq0 * k;
      uint2* queue = queues + (wg * 4 + w) * QCAP;
      float* wg_scales = tile_scales + wg * TN;
      const int wt = threadIdx.x & 127;   // thread of the warpgroup
      for (int i = lane; i < 16 * k; i += 32) {
        const bool real = q0 + wq0 + i / k < B;
        wlv[i] = real ? -INFINITY : INFINITY;
        wli[i] = real ? -1 : INT_MAX;
      }
      __syncwarp();
      float thv0 = wlv[quad * k + k - 1], thv1 = wlv[(quad + 8) * k + k - 1];
      int thi0 = wli[quad * k + k - 1], thi1 = wli[(quad + 8) * k + k - 1];
      // The thread's two queries (b0, b1) and the best bounds of them that
      // the slices had published when this tile began; read then, used at its
      // end, after the products, so the reads' latency stays off the path.
      // Two kinds: the best k-th pair of any slice (pub), and the least of
      // the query's n_buckets buckets, bucket j the best top-1 score of the
      // slices s with s % n_buckets == j (k distinct rows at or above it once
      // every bucket holds one). Lanes 2 i and 2 i + 1 read the buckets of
      // the warp's query i, every other bucket each (bw).
      const int b0 = q0 + wq0 + quad, b1 = b0 + 8;
      unsigned long long pub0 = 0, pub1 = 0;
      const int n_buckets = k <= MAX_BUCKETS && S >= k ? k : 0;
      const int bq = q0 + wq0 + (lane >> 1);
      const unsigned* buckets = reinterpret_cast<const unsigned*>(bounds + B);
      unsigned bw[MAX_BUCKETS / 2];
      // the thresholds: the k-th (score, id) of the thread's two lists, or
      // the published bound where that is better
      auto reload = [&]() {
        __syncwarp();
        thv0 = wlv[quad * k + k - 1];
        thi0 = wli[quad * k + k - 1];
        thv1 = wlv[(quad + 8) * k + k - 1];
        thi1 = wli[(quad + 8) * k + k - 1];
        raise_to(pub0, thv0, thi0);
        raise_to(pub1, thv1, thi1);
      };
      float qs0 = 1.f, qs1 = 1.f;
      if constexpr (MODE == kI8Q8) {
        if (q0 + wq0 + quad < B) qs0 = qscales[q0 + wq0 + quad];
        if (q0 + wq0 + quad + 8 < B) qs1 = qscales[q0 + wq0 + quad + 8];
      }
      const int n_cons = 128 * n_wg;   // threads that convert the rows' chunk
#if NVDB_FLAT_ABLATE == 3
      unsigned ctr[kCounters] = {};
#endif

      Acc acc[ACC];
      // f32 stores: the tile's running sums; acc holds one chunk's
      float total[MODE == kF32 ? ACC : 1];
      int stage = 0, prev = -1, cb = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        NVDB_TICK(ck_tile);
        if (b0 < B) pub0 = __ldcg(bounds + b0);
        if (b1 < B) pub1 = __ldcg(bounds + b1);
#pragma unroll
        for (int j = 0; j < MAX_BUCKETS / 2; ++j) {
          const int bj = 2 * j + (lane & 1);
          bw[j] = bj < n_buckets && bq < B ? __ldcg(buckets + (size_t)bq * MAX_BUCKETS + bj)
                                           : ~0u;
        }
        // the tile's row scales, asked for now and needed after its products
        float rs_lo = 0.f, rs_hi = 0.f;
        if constexpr (MODE == kF32) {
#pragma unroll
          for (int i = 0; i < ACC; ++i) total[i] = 0.f;
        }
        if constexpr (has_scales<MODE>()) {
          if (t * TN + wt < n_eff) rs_lo = __ldg(scales + t * TN + wt);
          if (t * TN + 128 + wt < n_eff) rs_hi = __ldg(scales + t * TN + 128 + wt);
        }
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint32_t a_tile = stage0 + stage * STAGE + wg * 64 * C::A_ROW;
          uint32_t b_tile = stage0 + stage * STAGE + C::A_BYTES;
          if constexpr (converts<MODE>()) {
            // The products that read this converted tile n_cvt chunks ago
            // are done in this warpgroup (the release below waited for the
            // chunk before the last; with one tile, wait for the last); the
            // barrier says the same of the other one.
            if (n_cvt == 1) wgmma_wait<0>();
            bar_sync(1, n_cons);
            const unsigned char* src = sm + (size_t)stage * STAGE + C::A_BYTES;
            unsigned char* dstb = cvt + cb * C::CVT_ONE;
            if constexpr (MODE == kI8) {
              for (int p = threadIdx.x; p < TN * 4; p += n_cons) {
                const int row = p >> 2, piece = p & 3;
                const uint4 wv = *reinterpret_cast<const uint4*>(src + row * 64 + piece * 16);
                uint4 lo, hi;
                widen_i8x16(wv, lo, hi);
                const int sw = row & 7;
                unsigned char* drow = dstb + row * CHUNK;
                *reinterpret_cast<uint4*>(drow + (((2 * piece) ^ sw) << 4)) = lo;
                *reinterpret_cast<uint4*>(drow + (((2 * piece + 1) ^ sw) << 4)) = hi;
              }
            } else {
              split_chunk(src, dstb, TN, TN * SPLIT_ROW, threadIdx.x, n_cons);
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            bar_sync(2, n_cons);
            b_tile = smem_u32(dstb);
            if (++cb == n_cvt) cb = 0;
          }
          if constexpr (MODE == kF32) {
            if (c > 0) {
              // the chunk before is done: its sum joins the total, and its
              // stage is released
              wgmma_wait<0>();
              acc_fence(acc);
#pragma unroll
              for (int i = 0; i < ACC; ++i) total[i] += acc[i];
              if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
              prev = -1;
            }
          }
          acc_fence(acc);
          wgmma_fence();
          if constexpr (MODE == kF32) {
            // The six passes (query plane, row plane) into a fresh sum,
            // smallest terms first: qm rm, ql rh, qh rl, qm rh, qh rm, then
            // qh rh; two k16 steps each.
            constexpr int QA = TQ * SPLIT_ROW, RB = TN * SPLIT_ROW;
            constexpr int QP[6] = {1, 2, 0, 1, 0, 0}, RP[6] = {1, 0, 2, 0, 1, 0};
            const uint64_t da = sw64_desc(a_tile), db = sw64_desc(b_tile);
#pragma unroll
            for (int i = 0; i < 6; ++i)
#pragma unroll
              for (int kk = 0; kk < 2; ++kk)
                wgmma_tile(acc, da + (QP[i] * QA >> 4) + 2 * kk,
                           db + (RP[i] * RB >> 4) + 2 * kk, (i | kk) != 0);
          } else {
            const uint64_t da = sw128_desc(a_tile), db = sw128_desc(b_tile);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_tile(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
          }
          wgmma_commit();
          if (n_stages == 1) {
            // a ring of one (k = 128 with the widened tiles): no overlap
            wgmma_wait<0>();
            if (lane == 0) mbar_arrive(empty0 + 8 * stage);
          } else {
            if (prev >= 0) {
              wgmma_wait<1>();   // the chunk before is done: release its stage
              if (lane == 0) mbar_arrive(empty0 + 8 * prev);
            }
            prev = stage;
          }
          if (++stage == n_stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        NVDB_TICK(ck_wait);
        wgmma_wait<0>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = -1;
        acc_fence(acc);
        if constexpr (MODE == kF32) {
#pragma unroll
          for (int i = 0; i < ACC; ++i) acc[i] += total[i];
        }
        // the queues lie over a converted tile: wait for the other
        // warpgroup's last products too
        if constexpr (converts<MODE>()) bar_sync(1, n_cons);
        if constexpr (has_scales<MODE>()) {
          // every warp of the warpgroup is past the last tile's filter: its
          // products above needed all four
          wg_scales[wt] = rs_lo;
          wg_scales[128 + wt] = rs_hi;
          bar_sync(3 + wg, 128);
        }

        // The filter (see group_scores for the accumulator's layout). The
        // thresholds first take the best bounds that the slices had
        // published when the tile began, and in a slice's first tile the
        // bound from the tile's own scores (first_tile_bounds). Sixteen scores at a time are held
        // against the two thresholds in registers; a group with no candidate
        // costs the compares and one vote. In a group with one, the lanes
        // mark which of their sixteen reach the threshold, the warp walks the
        // few marked in any lane, and the lanes with a candidate there push
        // it into the warp's queue at slots counted by a ballot; the queue is
        // drained into the lists at the end of the tile, and each list's new
        // k-th pair published. If the queue overflows (the first tile of a
        // slice, while the thresholds are low), the tile is scanned again in
        // order, in rounds of at most QCAP candidates.
        const int tile_row = t * TN, col0 = (lane & 3) * 2;
        NVDB_TICK(ck_filter);
        NVDB_COUNT(kCycWait, ck_filter - ck_wait);
        if (n_buckets > 0) {
          // the least bucket of each query, then the thread's two queries'
          unsigned m = bw[0];
#pragma unroll
          for (int j = 1; j < MAX_BUCKETS / 2; ++j) m = min(m, bw[j]);
          m = min(m, __shfl_xor_sync(FULL_MASK, m, 1));
          const unsigned m0 = __shfl_sync(FULL_MASK, m, 2 * quad);
          const unsigned m1 = __shfl_sync(FULL_MASK, m, 2 * quad + 16);
          // zero: a bucket no slice has filled yet
          if (m0 != 0 && b0 < B) pub0 = max(pub0, (unsigned long long)m0 << 32);
          if (m1 != 0 && b1 < B) pub1 = max(pub1, (unsigned long long)m1 << 32);
        }
        if (t == t_begin && k <= 16) {
          // kept with the published bounds, so that the rescan's reloads
          // keep it while the lists fill
          unsigned long long s0, s1;
          first_tile_bounds<MODE, ACC>(acc, col0, tile_row, n_eff, k, wg_scales, qs0, qs1, s0,
                                       s1);
          pub0 = max(pub0, s0);
          pub1 = max(pub1, s1);
        }
        {
          const bool raised = raise_to(pub0, thv0, thi0) | raise_to(pub1, thv1, thi1);
          NVDB_COUNT(kTightened, __any_sync(FULL_MASK, raised) ? 1 : 0);
          (void)raised;
        }
        int qn = 0;
#if NVDB_FLAT_ABLATE == 3
        unsigned walk_cyc = 0;
#endif
#if NVDB_FLAT_ABLATE == 1
        if (n_eff < 0)   // never
#endif
#pragma unroll
        for (int g = 0; g < ACC / 16; ++g) {
          float sc[16];
          const bool any = group_scores<MODE, ACC>(acc, g, col0, wg_scales, qs0, qs1, thv0, thv1,
                                              sc);
          if (!__any_sync(FULL_MASK, any)) continue;
          NVDB_TICK(ck_walk);
          // which of the sixteen reach their threshold, in this lane and in
          // any lane: the warp then walks only those few, together
          unsigned mask = 0;
#pragma unroll
          for (int x = 0; x < 16; ++x)
            mask |= sc[x] >= ((x & 2) ? thv1 : thv0) ? 1u << x : 0u;
          unsigned todo = __reduce_or_sync(FULL_MASK, mask);
#if NVDB_FLAT_ABLATE == 2
          asm volatile("" ::"r"(todo));
          todo = 0;
#endif
          while (todo) {
            const int x = __ffs(todo) - 1;
            todo &= todo - 1;
            const float v = pick(sc, x);
            const int col = (g * 4 + (x >> 2)) * 8 + col0 + (x & 1);
            const bool ok = ((mask >> x) & 1u) && tile_row + col < n_eff &&
                            better(v, tile_row + col, (x & 2) ? thv1 : thv0,
                                   (x & 2) ? thi1 : thi0);
            const unsigned m = __ballot_sync(FULL_MASK, ok);
            const int pos = qn + __popc(m & ((1u << lane) - 1u));
            if (ok && pos < QCAP) queue[pos] = queue_entry(v, col, quad + ((x & 2) ? 8 : 0));
            qn += __popc(m);
          }
#if NVDB_FLAT_ABLATE == 3
          walk_cyc += clock32() - ck_walk;
          NVDB_COUNT(kWalkedGroups, 1);
#endif
        }
        __syncwarp();
        NVDB_TICK(ck_drain);
        NVDB_COUNT(kCycWalk, walk_cyc);
        NVDB_COUNT(kCycCompare, ck_drain - ck_filter - walk_cyc);
        NVDB_COUNT(kTiles, 1);
        if (qn <= QCAP) {
          if (qn > 0) {   // with nothing queued the thresholds stand
            drain_queue(queue, qn, tile_row, wlv, wli, k, lane);
            NVDB_COUNT(kDrained, qn);
            reload();
          }
        } else {
          NVDB_COUNT(kOverflowTiles, 1);
          int start = 0;
          while (true) {
            int cnt = 0;
            bool over = false;
#pragma unroll
            for (int g = 0; g < ACC / 16; ++g) {
              if (over || start >= (g + 1) * 16) continue;
              float sc[16];
              const bool any = group_scores<MODE, ACC>(acc, g, col0, wg_scales, qs0, qs1, thv0,
                                                  thv1, sc);
              if (!__any_sync(FULL_MASK, any)) continue;
              // a loop, not unrolled: the rescan runs in few tiles, and its
              // code is then fetched cold
              for (int x = max(start - g * 16, 0); x < 16 && !over; ++x) {
                const int e = x & 3;
                const int col = (g * 4 + (x >> 2)) * 8 + col0 + (e & 1);
                const float v = pick(sc, x);
                const bool ok = tile_row + col < n_eff &&
                                better(v, tile_row + col, (e & 2) ? thv1 : thv0,
                                       (e & 2) ? thi1 : thi0);
                const unsigned m = __ballot_sync(FULL_MASK, ok);
                if (m == 0) continue;
                const int n = __popc(m);
                if (cnt + n > QCAP) {
                  over = true;
                  start = g * 16 + x;
                } else {
                  if (ok)
                    queue[cnt + __popc(m & ((1u << lane) - 1u))] =
                        queue_entry(v, col, quad + ((e & 2) ? 8 : 0));
                  cnt += n;
                }
              }
            }
            __syncwarp();
            drain_queue(queue, cnt, tile_row, wlv, wli, k, lane);
            NVDB_COUNT(kDrained, cnt);
            reload();
            if (!over) break;
          }
#if NVDB_FLAT_ABLATE == 3
          NVDB_COUNT(kCycRescan, clock32() - ck_drain);
#endif
        }
        if (qn > 0 && lane < 16) {
          // each list's k-th pair, once the list is full, bounds its query
          // for every slice; its top-1 score joins the slice's bucket
          const int b = q0 + wq0 + lane;
          const float v = wlv[lane * k + k - 1];
          const int id = wli[lane * k + k - 1];
          if (b < B && id >= 0) atomicMax(bounds + b, bound_key(v, id));
          if (b < B && n_buckets > 0 && wli[lane * k] >= 0)
            atomicMax(const_cast<unsigned*>(buckets) + (size_t)b * MAX_BUCKETS + s % n_buckets,
                      score_key(wlv[lane * k]));
        }
#if NVDB_FLAT_ABLATE == 3
        {
          const unsigned ck_end = clock32();
          if (qn <= QCAP) NVDB_COUNT(kCycDrain, ck_end - ck_drain);
          NVDB_COUNT(kCycTile, ck_end - ck_tile);
        }
#endif
      }
#if NVDB_FLAT_ABLATE == 3
      if (lane == 0)
#pragma unroll
        for (int i = 0; i < kCounters; ++i) atomicAdd(&g_counters[i], (unsigned long long)ctr[i]);
#endif

      __syncwarp();
      for (int i = lane; i < 16 * k; i += 32) {
        const int ql = i / k, j = i - ql * k;
        const int b = q0 + wq0 + ql;
        if (b < B) {
          const size_t o = ((size_t)b * S + s) * k + j;
          part_vals[o] = wlv[i];
          part_ids[o] = wli[i];
        }
      }
    }
  }
}

// The map of `planes` row-major [rows, Dp] arrays of 1-, 2- or 4-byte
// elements, one after the other, read in boxes of box_rows x box_dims (x all
// the planes); rows and dims past the array read as zero.
bool encode_map(CUtensorMap* map, const void* base, int elem_bytes, int rows, int Dp,
                int box_dims, int box_rows, CUtensorMapSwizzle swizzle, int planes = 1) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Dp, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)Dp * elem_bytes,
                                 (cuuint64_t)rows * Dp * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_dims, (cuuint32_t)box_rows, (cuuint32_t)planes};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapDataType type = elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return fn(map, type, planes > 1 ? 3 : 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The ring's depth, the converted tiles and the kernel's dynamic shared
// memory at list length k: as many stages (up to MAX_STAGES) as fit beside
// the lists. The int8 store widens into two tiles; the f32 store splits into
// two while that leaves a ring of two stages, else into one (k > 121), so
// that its loads still overlap the products. Fails with
// cudaErrorInvalidConfiguration where not one stage fits.
template <int MODE>
cudaError_t plan_smem(int k, int* n_stages, int* n_cvt, size_t* smem) {
  using C = Cfg<MODE>;
  constexpr int STAGE = stage_bytes<MODE>();
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t base =
      1024 + (size_t)TQ * k * 8 + C::FILTER_BYTES + 2 * MAX_STAGES * 8 + 8 * 4;
  auto stages_with = [&](int cvt) -> size_t {
    const size_t fixed = base + (size_t)cvt * C::CVT_ONE;
    return (size_t)max_smem < fixed ? 0 : ((size_t)max_smem - fixed) / STAGE;
  };
  *n_cvt = MODE == kI8 ? 2 : MODE == kF32 ? (stages_with(2) >= 2 ? 2 : 1) : 0;
  const size_t fit = stages_with(*n_cvt);
  if (fit < 1) return cudaErrorInvalidConfiguration;
  *n_stages = fit < (size_t)MAX_STAGES ? (int)fit : MAX_STAGES;
  *smem = base + (size_t)*n_cvt * C::CVT_ONE + (size_t)*n_stages * STAGE;
  return cudaFuncSetAttribute(scan_wgmma_kernel<MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <int MODE>
cudaError_t launch_wgmma(const void* q, const void* v, const float* scales,
                         const float* qscales, float* part_vals, int* part_ids,
                         unsigned long long* bounds, int B, int Dp, int Np, int n_eff, int k,
                         int S, cudaStream_t stream) {
  using C = Cfg<MODE>;
  const int n_qblocks = (B + TQ - 1) / TQ;
  CUtensorMap qmap, vmap;
  bool ok;
  if constexpr (MODE == kF32) {
    // the queries' three bf16 planes [3][B][Dp] in one box; the f32 rows as
    // they lie in memory (128 bytes a row: no swizzle, the split reads them)
    ok = encode_map(&qmap, q, 2, B, Dp, C::Q_DIMS, TQ, CU_TENSOR_MAP_SWIZZLE_64B, 3) &&
         encode_map(&vmap, v, 4, Np, Dp, C::V_DIMS, C::TN, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    constexpr int QE = MODE == kI8Q8 ? 1 : 2, VE = MODE == kBF16 ? 2 : 1;
    ok = encode_map(&qmap, q, QE, B, Dp, C::Q_DIMS, TQ, CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_map(&vmap, v, VE, Np, Dp, C::V_DIMS, C::TN,
                    MODE == kI8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!ok) return cudaErrorInvalidValue;
  int n_stages = 0, n_cvt = 0;
  size_t smem = 0;
  cudaError_t e = plan_smem<MODE>(k, &n_stages, &n_cvt, &smem);
  if (e != cudaSuccess) return e;

  const int n_tiles = (n_eff + C::TN - 1) / C::TN;
  const int tiles_per_slice = (n_tiles + S - 1) / S;
  const int n_chunks = (Dp + C::V_DIMS - 1) / C::V_DIMS;
  scan_wgmma_kernel<MODE><<<n_qblocks * S, NT_TC, smem, stream>>>(
      qmap, vmap, scales, qscales, part_vals, part_ids, bounds, B, n_eff, k, S, n_qblocks,
      tiles_per_slice, n_tiles, n_chunks, n_stages, n_cvt);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). mode: 0 f32 store on the SIMT kernel
// (the A/B), 1 bf16 store, 2 int8 store with f32 queries, 3 int8 store with
// int8 queries (qscales given), 4 f32 store on the tensor cores (the
// three-way bf16 split); 1-4 run on the tensor cores. q16 is scratch for the
// queries' prologue: the bf16-rounded queries [B, Dp] of modes 1 and 2, the
// three split planes [3, B, Dp] of mode 4. Scratch part_vals / part_ids hold
// [B, S, k], and bounds (modes 1-4) B x (8 + 4 MAX_BUCKETS) bytes: each
// query's best k-th pair published by a slice, then its top-1 buckets (the
// prologue zeroes them); outputs are [B, k]. Every pointer starts on a
// 16-byte boundary. Returns a cudaError_t (0 on success); the launches are
// asynchronous on `stream`.
extern "C" int nvdb_flat_topk(const void* q, const void* v, const void* scales,
                              const void* qscales, void* q16, void* part_vals,
                              void* part_ids, void* bounds, void* out_vals, void* out_ids,
                              int B, int Dp, int Np, int n_eff, int k, int S, int mode,
                              void* stream) {
  if (B < 1 || k < 1 || k > MAX_K || S < 1 || Dp < 64 || Dp % 64 != 0 || n_eff < 0 ||
      n_eff > Np)
    return (int)cudaErrorInvalidValue;
  if ((mode == kI8 || mode == kI8Q8) && scales == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == kI8Q8 && qscales == nullptr) return (int)cudaErrorInvalidValue;
  const int planes = mode == kF32 ? 3 : mode == kBF16 || mode == kI8 ? 1 : 0;
  if (planes > 0 && q16 == nullptr) return (int)cudaErrorInvalidValue;
  if (mode != kF32Simt && bounds == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const float* qs = static_cast<const float*>(qscales);
  float* pv = static_cast<float*>(part_vals);
  int* pi = static_cast<int*>(part_ids);
  unsigned long long* bd = static_cast<unsigned long long*>(bounds);
  cudaError_t e;
  if (mode != kF32Simt) {
    const size_t n = planes > 0 ? (size_t)B * Dp : (size_t)B * (2 + MAX_BUCKETS);
    const int blocks = n < 256 * 1024 ? (int)((n + 255) / 256) : 1024;
    round_queries_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(q),
                                                 static_cast<__nv_bfloat16*>(q16), n, planes,
                                                 static_cast<unsigned*>(bounds), B);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  switch (mode) {
    case kF32Simt:
      e = launch_f32(static_cast<const float*>(q), static_cast<const float*>(v), pv, pi, B,
                     Dp, n_eff, k, S, st);
      break;
    case kBF16:
      e = launch_wgmma<kBF16>(q16, v, sc, qs, pv, pi, bd, B, Dp, Np, n_eff, k, S, st);
      break;
    case kI8:
      e = launch_wgmma<kI8>(q16, v, sc, qs, pv, pi, bd, B, Dp, Np, n_eff, k, S, st);
      break;
    case kI8Q8:
      e = launch_wgmma<kI8Q8>(q, v, sc, qs, pv, pi, bd, B, Dp, Np, n_eff, k, S, st);
      break;
    case kF32:
      e = launch_wgmma<kF32>(q16, v, sc, qs, pv, pi, bd, B, Dp, Np, n_eff, k, S, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)nvdb::launch_merge(pv, pi, static_cast<float*>(out_vals),
                                 static_cast<int*>(out_ids), B, S, k, st);
}

#if NVDB_FLAT_ABLATE == 3
// The counter build's sums (kCounters values of 64 bits, in the order of
// enum Counter) copied to out; reset != 0 zeroes them afterwards.
extern "C" int nvdb_flat_counters(void* out, int reset) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_counters, sizeof(g_counters));
  if (e == cudaSuccess && reset) {
    const unsigned long long zeros[kCounters] = {};
    e = cudaMemcpyToSymbol(g_counters, zeros, sizeof(zeros));
  }
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#endif
