// IVF probe top-k for Hopper (sm_90a): for each query, scores every live
// slot of its P probed inverted lists exactly and returns the k best
// (score, id), k <= 128.
//
// Replaces the Pallas TPU kernel nvdb_tpu/kernels/ivf_scan.py:
// pallas_ivf_probe_topk (body _make_kernel :32-107). Same contract:
//   * slot l of probed list p = probes[b, p] scores dot(q_b, packed[p, l]):
//       f32 slabs    full f32 FMA (no TF32), the query as given;
//       bf16 slabs   the query rounded to bf16 (RNE), the slab widened
//                    exactly, f32 products and sums;
//       int8 slabs   the same with the codes widened exactly, then the sum
//                    times the slot's scale;
//   * slots with slot_ids[list, l] < 0 never score; slots at or past
//     fills[list] (1 + the last live slot) are not scored; a probe id
//     outside [0, nlist) is an empty list; a list that a query probes twice
//     scores twice;
//   * output sorted by score descending, ties to the larger id; slots no
//     candidate fills hold (-inf, -1).
//
// What bounds it on an H100: bytes. A bf16 row costs one multiply-add a
// query per byte read, far under the tensor cores' ridge (~295 operations a
// byte), so the least time is the distinct bytes: each probed list's live
// prefix and its ids read once, whatever number of queries probes it. At
// IVF-Flat's flagship shape (1M x 768 bf16, nlist 4096, B = 256, P = 64)
// 16,384 (query, probe) pairs fall on ~4,100 lists: read once a pair, the
// live rows are ~7.2 GB a batch; read once a list, ~1.5 GB (0.46 ms at
// 3.35 TB/s).
//
// Design: list-major (nvdb_ivf_probe_topk_list).
//   Pass 0 (group_pairs_kernel, one CTA, the counts in shared memory where
//   nlist allows): the B x P pairs are counted by list (an invalid probe
//   or an empty list drops its pair, whose partial lists are filled with
//   (-inf, -1)), the counts scanned, and the pair
//   indices b * P + p scattered into list order. Work items are (list,
//   chunk of at most NQ pairs that probe it), the longest lists first, so
//   the grid's tail is short items. Nothing is read back to the host: pass
//   1's grid is sized from shapes (the most items there can be), and a CTA
//   past the real count exits at once.
//   Pass 1 (probe_list_kernel): grid = items x R row ranges (R > 1 only when
//   the batch has fewer pairs than two CTAs a SM: the ranges split each
//   list's live prefix). A CTA stages its chunk's queries in shared memory
//   once (bf16, in the 128-byte swizzle the wgmma descriptor reads, for
//   bf16 and int8 slabs; f32 as given for f32 slabs), then streams its
//   list's live rows in tiles of 64: a producer warp keeps a ring of stages
//   filled by TMA ([nlist * Lcap, Dp] viewed 2-D, boxes of 16 rows x 128
//   bytes, so a tile's rows past the range are skipped 16 at a time and the
//   rest masked by row), and the scoring warpgroup scores each tile against
//   every query of the chunk:
//     bf16 slabs   wgmma m64nNQk16, rows as M (64) and the queries as N, so
//                  the narrow side is the queries (IVF-Flat averages ~4 a
//                  list); bf16 x bf16 products are exact, sums in f32;
//     int8 slabs   the staged codes widened to bf16 in shared memory
//                  (exact for [-127, 127]), the same product, then the
//                  slot's scale;
//     f32 slabs    f32 FMA (no TF32), each 16-byte piece of a row read once
//                  from shared memory and applied to the chunk's queries.
//   The tile's scores go to one of two buffers in shared memory; the fold
//   warpgroup folds a buffer into the chunk's running top-k lists (a warp
//   a query) while the next tile is scored: a half-tile's candidates are
//   held against the list's k-th entry first, and where more than two beat
//   it they are sorted across the warp and merged into the list at once
//   (warp_offer_many), so the first tiles of a long list (k = 50: every
//   candidate an improver) cost a sort and a merge, not k inserts. At the
//   end each pair's sorted partial list goes to part[b, p * R + r].
//   Queries a chunk (NQ) and CTAs a SM are the wrapper's plan: measured on
//   the H100, 8 queries at three CTAs a SM keep the most bytes in flight
//   (the ring is what the query tile leaves of a third of the SM's shared
//   memory), and beat wider chunks that read a hot list fewer times.
//   Pass 2 (merge_batched_kernel) folds each query's P x R partial lists,
//   the next chunk of eight lists loaded at once (the wrapper keeps P x R
//   at 64 or under where it splits lists).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_pairs.cuh"
#include "hopper_common.cuh"
#include "topk_common.cuh"

// Measurement builds of chip_smoke.py's phase 12, whose results are wrong
// by design; the library that the port loads is built without the
// definition. 1: the list-major entry runs pass 0 alone; 2: passes 0 and 1,
// no merge.
#ifndef NVDB_PROBE_ABLATE
#define NVDB_PROBE_ABLATE 0
#endif

namespace {

enum Mode { kF32 = 0, kBF16 = 1, kI8 = 2 };

// ---------------------------------------------------------------------------
// The list-major kernel.
// ---------------------------------------------------------------------------

constexpr int MERGE_BATCH = 8;      // partial lists whose next chunk a merge warp loads at once
constexpr int LM_ROWS = 64;         // rows a tile: the wgmma's M
constexpr int LM_BOX_ROWS = 16;     // rows a TMA box
constexpr int LM_WG = 128;          // threads of a warpgroup
constexpr int LM_NT = 2 * LM_WG + 32;  // scoring and fold warpgroups, the producer warp
constexpr int LM_MAX_STAGES = 16;
constexpr int LM_BARS = 2 * LM_MAX_STAGES + 4;   // ring full / empty, scores full / empty
constexpr int TS_STRIDE = 68;       // floats a query's row of tile scores (bank spread)
constexpr int F32_NQ = 16;          // queries a chunk of f32 slabs
constexpr int CVT_BYTES = LM_ROWS * 128;   // one widened int8 tile (bf16, 64 columns)

// Per slab type: columns a chunk (one 128-byte box row; 64 bytes for int8),
// bytes a box of LM_BOX_ROWS rows, bytes a stage (a tile's box rows).
template <int MODE> struct LCfg;
template <> struct LCfg<kBF16> {
  static constexpr int COLS = 64, BOX = LM_BOX_ROWS * 128, STAGE = LM_ROWS * 128;
};
template <> struct LCfg<kI8> {
  static constexpr int COLS = 64, BOX = LM_BOX_ROWS * 64, STAGE = LM_ROWS * 64;
};
template <> struct LCfg<kF32> {
  static constexpr int COLS = 32, BOX = LM_BOX_ROWS * 128, STAGE = LM_ROWS * 128;
};

__host__ __device__ constexpr int list_cols(int mode) { return mode == kF32 ? 32 : 64; }

__host__ __device__ constexpr int list_stage_bytes(int mode) {
  return mode == kI8 ? LM_ROWS * 64 : LM_ROWS * 128;
}

// Bytes of the chunk's query tile: bf16 in the 128-byte swizzle, one
// [nq x 128 B] tile per 64 columns; f32 rows of n_chunks * 32 + 4 floats.
__host__ __device__ inline size_t list_qtile_bytes(int mode, int nq, int Dp) {
  const int n_chunks = (Dp + list_cols(mode) - 1) / list_cols(mode);
  return mode == kF32 ? (size_t)nq * (n_chunks * 32 + 4) * 4 : (size_t)n_chunks * nq * 128;
}

// pass 1's dynamic shared memory, in the kernel's order: the ring, the
// widened int8 tiles, the query tile, two buffers of tile scores, the
// barriers, the chunk's pair indices, the top-k lists; 1024 bytes of
// alignment slack.
__host__ __device__ inline size_t list_smem_bytes(int mode, int nq, int n_stages, int Dp,
                                                  int k) {
  return 1024 + (size_t)n_stages * list_stage_bytes(mode) + (mode == kI8 ? 2 * CVT_BYTES : 0) +
         list_qtile_bytes(mode, nq, Dp) + (size_t)2 * nq * TS_STRIDE * 4 + LM_BARS * 8 +
         (size_t)nq * 4 + (size_t)nq * k * 8;
}

// The warp's 32 candidates (one a lane) sorted by the top-k order, the
// best in lane 0: a bitonic sort over the lanes. Equal candidates stay
// where they are.
__device__ __forceinline__ void warp_sort32(float& v, int& id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(nvdb::FULL_MASK, v, stride);
      const int oid = __shfl_xor_sync(nvdb::FULL_MASK, id, stride);
      const bool lower = (lane & stride) == 0;   // the pair's first lane
      const bool desc = (lane & size) == 0;      // this run's direction
      // the first lane of a descending run keeps the better of the two
      const bool swap = (lower == desc) ? nvdb::better(ov, oid, v, id)
                                        : nvdb::better(v, id, ov, oid);
      if (swap) {
        v = ov;
        id = oid;
      }
    }
  }
}

constexpr int SERIAL_OFFER_MAX = 2;   // improvers a warp inserts one by one; more are merged

// nvdb::warp_offer's contract (each lane's candidate (s, id) where ok; true
// if any beat the list's k-th entry when the call began), and the same list
// after it: where more than SERIAL_OFFER_MAX candidates beat the k-th entry
// they are sorted across the warp and merged into the list at once (each
// list entry moves down by the candidates better than it, each candidate
// lands after the entries at least as good), instead of one warp-wide
// insert each.
__device__ __forceinline__ bool warp_offer_many(float* lv, int* li, int k, float s, int id,
                                                bool ok, int lane) {
  const bool beats = ok && nvdb::better(s, id, lv[k - 1], li[k - 1]);
  const unsigned m = __ballot_sync(nvdb::FULL_MASK, beats);
  if (m == 0) return false;
  if (__popc(m) <= SERIAL_OFFER_MAX) return nvdb::warp_offer(lv, li, k, s, id, ok, lane);
  float v = beats ? s : -INFINITY;   // the rest sort last and land past k
  int cid = beats ? id : -1;
  warp_sort32(v, cid, lane);
  // the candidate's place: lane + the list entries at least as good
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (nvdb::better(v, cid, lv[mid], li[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  const int cpos = lane + lo;
  float ev[nvdb::WARP_LIST_MAX_K / 32];
  int ei[nvdb::WARP_LIST_MAX_K / 32], epos[nvdb::WARP_LIST_MAX_K / 32];
#pragma unroll
  for (int r = 0; r < nvdb::WARP_LIST_MAX_K / 32; ++r) {
    const int j = lane + 32 * r;
    const bool in = j < k;
    ev[r] = in ? lv[j] : -INFINITY;
    ei[r] = in ? li[j] : -1;
    // candidates better than this entry: a prefix of the sorted lanes
    int cnt = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      const float pv = __shfl_sync(nvdb::FULL_MASK, v, cnt + step - 1);
      const int pi = __shfl_sync(nvdb::FULL_MASK, cid, cnt + step - 1);
      if (nvdb::better(pv, pi, ev[r], ei[r])) cnt += step;
    }
    const float pv = __shfl_sync(nvdb::FULL_MASK, v, cnt);
    const int pi = __shfl_sync(nvdb::FULL_MASK, cid, cnt);
    if (cnt == 31 && nvdb::better(pv, pi, ev[r], ei[r])) cnt = 32;
    epos[r] = in ? j + cnt : k;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < nvdb::WARP_LIST_MAX_K / 32; ++r)
    if (epos[r] < k) {
      lv[epos[r]] = ev[r];
      li[epos[r]] = ei[r];
    }
  if (cpos < k) {
    lv[cpos] = v;
    li[cpos] = cid;
  }
  __syncwarp();
  return true;
}

// Pass 2 of the list-major kernel: nvdb::merge_kernel's fold (one warp a
// query, each sorted partial list offered until a chunk of it has no
// improver), with the next chunk of MERGE_BATCH partial lists loaded at
// once, so a query's P x R partials cost P x R / MERGE_BATCH load latencies.
__global__ void __launch_bounds__(nvdb::MERGE_WARPS * 32)
merge_batched_kernel(const float* __restrict__ part_vals, const int* __restrict__ part_ids,
                     float* __restrict__ out_vals, int* __restrict__ out_ids, int B, int S,
                     int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * nvdb::MERGE_WARPS + warp;
  if (b >= B) return;   // whole warp; no block-wide barrier follows
  float* lv = reinterpret_cast<float*>(smem) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + nvdb::MERGE_WARPS * k) +
            warp * k;
  for (int j = lane; j < k; j += 32) {
    lv[j] = -INFINITY;
    li[j] = -1;
  }
  __syncwarp();
  for (int s0 = 0; s0 < S; s0 += MERGE_BATCH) {
    // the batch's lists that may still improve (warp-uniform)
    unsigned live = S - s0 >= MERGE_BATCH ? (1u << MERGE_BATCH) - 1 : (1u << (S - s0)) - 1;
    for (int j0 = 0; j0 < k && live != 0; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < k;
      float v[MERGE_BATCH];
      int id[MERGE_BATCH];
#pragma unroll
      for (int g = 0; g < MERGE_BATCH; ++g) {
        const bool rd = ok && ((live >> g) & 1u);
        const size_t o = ((size_t)b * S + s0 + g) * k + j;
        v[g] = rd ? part_vals[o] : -INFINITY;
        id[g] = rd ? part_ids[o] : -1;
      }
#pragma unroll
      for (int g = 0; g < MERGE_BATCH; ++g)
        if (((live >> g) & 1u) && !warp_offer_many(lv, li, k, v[g], id[g], ok, lane))
          live &= ~(1u << g);
    }
  }
  for (int j = lane; j < k; j += 32) {
    out_vals[(size_t)b * k + j] = lv[j];
    out_ids[(size_t)b * k + j] = li[j];
  }
}

// a . w over four f32 pieces, in element order
__device__ __forceinline__ float dot4(const float4& a, const float4& w, float acc) {
  acc = fmaf(a.x, w.x, acc);
  acc = fmaf(a.y, w.y, acc);
  acc = fmaf(a.z, w.z, acc);
  return fmaf(a.w, w.w, acc);
}

// Pass 1. NQ: queries a chunk (the wgmma's N; F32_NQ for f32 slabs).
// Warps 0-3 (the scoring warpgroup) score each tile into one of two score
// buffers; warps 4-7 (the fold warpgroup) fold a buffer into the chunk's
// top-k lists while the next tile is scored; warp 8 feeds the ring.
template <int MODE, int NQ>
__global__ void __launch_bounds__(LM_NT)
probe_list_kernel(const __grid_constant__ CUtensorMap vmap, const float* __restrict__ queries,
                  const int* __restrict__ order, const int4* __restrict__ items,
                  const int* __restrict__ n_items, const int* __restrict__ slot_ids,
                  const float* __restrict__ slot_scales, const int* __restrict__ fills,
                  float* __restrict__ part_vals, int* __restrict__ part_ids, int P, int Lcap,
                  int Dp, int k, int R, int n_stages) {
  using C = LCfg<MODE>;
  const int it = blockIdx.x / R, r = blockIdx.x - it * R;
  if (it >= *n_items) return;   // the grid holds the most items there can be
  const int4 item = items[it];
  const int lst = item.x, start = item.y, nq = item.z;
  const int fill = min(fills[lst], Lcap);
  // this CTA's rows of the list's live prefix, [r0, r1): a whole number of boxes
  const int per = ((fill + R - 1) / R + LM_BOX_ROWS - 1) / LM_BOX_ROWS * LM_BOX_ROWS;
  const int r0 = min(fill, r * per), r1 = min(fill, r0 + per);
  const int n_tiles = (r1 - r0 + LM_ROWS - 1) / LM_ROWS;
  const int n_chunks = (Dp + C::COLS - 1) / C::COLS;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = nvdb::smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* cvt = ring + (size_t)n_stages * C::STAGE;
  unsigned char* qtile = cvt + (MODE == kI8 ? 2 * CVT_BYTES : 0);
  float* tile_s = reinterpret_cast<float*>(qtile + list_qtile_bytes(MODE, NQ, Dp));  // [2][NQ][TS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(tile_s + 2 * NQ * TS_STRIDE);
  int* pairs = reinterpret_cast<int*>(bars + LM_BARS);
  float* lv = reinterpret_cast<float*>(pairs + NQ);   // [NQ][k]
  int* li = reinterpret_cast<int*>(lv + NQ * k);      // [NQ][k]
  // ring: full / empty per stage; scores: full / empty per buffer
  const uint32_t full0 = nvdb::smem_u32(bars), empty0 = full0 + 8 * LM_MAX_STAGES;
  const uint32_t sfull0 = empty0 + 8 * LM_MAX_STAGES, sempty0 = sfull0 + 16;
  const uint32_t ring0 = nvdb::smem_u32(ring);

  if (threadIdx.x == 0) {
    for (int i = 0; i < n_stages; ++i) {
      nvdb::mbar_init(full0 + 8 * i, 1);             // the producer's arrive + the bytes
      nvdb::mbar_init(empty0 + 8 * i, LM_WG / 32);   // one arrive a scoring warp
    }
    for (int i = 0; i < 2; ++i) {
      nvdb::mbar_init(sfull0 + 8 * i, LM_WG);        // every scoring thread's scores
      nvdb::mbar_init(sempty0 + 8 * i, LM_WG / 32);  // one arrive a fold warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * LM_WG) {
    // ---- producer: the range's rows, tile by tile, chunk by chunk --------
    if (threadIdx.x == 2 * LM_WG) {
      int stage = 0;
      uint32_t phase = 0;
      const int base_row = lst * Lcap;
      for (int t = 0; t < n_tiles; ++t) {
        const int row0 = r0 + t * LM_ROWS;
        const int n_box = (min(LM_ROWS, r1 - row0) + LM_BOX_ROWS - 1) / LM_BOX_ROWS;
        for (int c = 0; c < n_chunks; ++c) {
          nvdb::mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t dst = ring0 + stage * C::STAGE;
          nvdb::mbar_expect_tx(full, n_box * C::BOX);
          for (int bx = 0; bx < n_box; ++bx)
            nvdb::tma_load_2d(dst + bx * C::BOX, &vmap, full, c * C::COLS,
                              base_row + row0 + bx * LM_BOX_ROWS);
          if (++stage == n_stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- both warpgroups: the chunk's pairs, queries and lists ----------------
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < NQ; i += 2 * LM_WG) pairs[i] = i < nq ? order[start + i] : -1;
  for (int i = tid; i < NQ * k; i += 2 * LM_WG) {
    lv[i] = -INFINITY;
    li[i] = -1;
  }
  nvdb::bar_sync(1, 2 * LM_WG);
  // The chunk's queries, zero past Dp and past nq (the products read them).
  if constexpr (MODE == kF32) {
    const int qs = n_chunks * 32 + 4;
    float* qf = reinterpret_cast<float*>(qtile);
    for (int idx = tid; idx < NQ * n_chunks * 8; idx += 2 * LM_WG) {
      const int i = idx / (n_chunks * 8), col = (idx - i * n_chunks * 8) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nq && col < Dp)
        v = *reinterpret_cast<const float4*>(queries + (size_t)(pairs[i] / P) * Dp + col);
      *reinterpret_cast<float4*>(qf + i * qs + col) = v;
    }
  } else {
    // bf16 (RNE) in the 128-byte swizzle: the 16-byte piece j of query row
    // i of a chunk's [NQ x 128 B] tile lies at piece j ^ (i & 7)
    for (int idx = tid; idx < NQ * n_chunks * 8; idx += 2 * LM_WG) {
      const int i = idx / (n_chunks * 8), pc = idx - i * n_chunks * 8;
      const int col = pc * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (i < nq && col < Dp) {
        const float* src = queries + (size_t)(pairs[i] / P) * Dp + col;
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(a.x, a.y);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(a.z, a.w);
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(b.x, b.y);
        const __nv_bfloat162 h3 = __floats2bfloat162_rn(b.z, b.w);
        v = make_uint4(*reinterpret_cast<const uint32_t*>(&h0),
                       *reinterpret_cast<const uint32_t*>(&h1),
                       *reinterpret_cast<const uint32_t*>(&h2),
                       *reinterpret_cast<const uint32_t*>(&h3));
      }
      const int c = pc >> 3, j = pc & 7;
      *reinterpret_cast<uint4*>(qtile + (size_t)c * NQ * 128 + i * 128 + ((j ^ (i & 7)) << 4)) =
          v;
    }
    nvdb::fence_proxy_async();   // the wgmma reads the tile through the async proxy
  }
  nvdb::bar_sync(1, 2 * LM_WG);

  if (tid >= LM_WG) {
    // ---- the fold warpgroup: warp w keeps queries w, w + 4, ... -----------
    const int fw = (tid - LM_WG) >> 5;
    const int* sid = slot_ids + (size_t)lst * Lcap;
    const float* ssc = MODE == kI8 ? slot_scales + (size_t)lst * Lcap : nullptr;
    for (int t = 0; t < n_tiles; ++t) {
      const int row0 = r0 + t * LM_ROWS, buf = t & 1;
      // lane's rows of the tile: row0 + lane and row0 + 32 + lane
      const int id0 = row0 + lane < r1 ? __ldg(sid + row0 + lane) : -1;
      const int id1 = row0 + 32 + lane < r1 ? __ldg(sid + row0 + 32 + lane) : -1;
      float s0 = 1.f, s1 = 1.f;
      if constexpr (MODE == kI8) {
        if (id0 >= 0) s0 = __ldg(ssc + row0 + lane);
        if (id1 >= 0) s1 = __ldg(ssc + row0 + 32 + lane);
      }
      nvdb::mbar_wait(sfull0 + 8 * buf, (t >> 1) & 1);
      const float* ts = tile_s + buf * NQ * TS_STRIDE;
      for (int qi = fw; qi < nq; qi += LM_WG / 32) {
        const float v0 = ts[qi * TS_STRIDE + lane] * s0;
        const float v1 = ts[qi * TS_STRIDE + 32 + lane] * s1;
        warp_offer_many(lv + qi * k, li + qi * k, k, v0, id0, id0 >= 0, lane);
        warp_offer_many(lv + qi * k, li + qi * k, k, v1, id1, id1 >= 0, lane);
      }
      __syncwarp();
      if (lane == 0) nvdb::mbar_arrive(sempty0 + 8 * buf);
    }
    // the warp's queries' lists, as the pairs' partials [b, p * R + r]
    for (int qi = fw; qi < nq; qi += LM_WG / 32) {
      const size_t o = ((size_t)pairs[qi] * R + r) * k;
      for (int j = lane; j < k; j += 32) {
        part_vals[o + j] = lv[qi * k + j];
        part_ids[o + j] = li[qi * k + j];
      }
    }
    return;
  }

  // ---- the scoring warpgroup -------------------------------------------------
  const int warp = tid >> 5;
  int stage = 0, cb = 0;
  uint32_t phase = 0;
  float acc[MODE == kF32 ? 8 : NQ / 2];
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    float* ts = tile_s + buf * NQ * TS_STRIDE;
    if constexpr (MODE == kF32) {
      // thread: rows 4 rg .. 4 rg + 3 of the tile, queries 2 qg and 2 qg + 1
      const int qg = tid & 7, rg = tid >> 3;
      const int qs = n_chunks * 32 + 4;
      const float* qf = reinterpret_cast<const float*>(qtile);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      for (int c = 0; c < n_chunks; ++c) {
        nvdb::mbar_wait(full0 + 8 * stage, phase);
        const unsigned char* st = ring + (size_t)stage * C::STAGE;
        const float* qa = qf + (2 * qg) * qs + c * 32;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float4 xa = *reinterpret_cast<const float4*>(qa + 4 * p);
          const float4 xb = *reinterpret_cast<const float4*>(qa + qs + 4 * p);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int row = 4 * rg + u;   // the 128-byte swizzle of the TMA box
            const float4 w =
                *reinterpret_cast<const float4*>(st + row * 128 + ((p ^ (row & 7)) << 4));
            acc[2 * u] = dot4(xa, w, acc[2 * u]);
            acc[2 * u + 1] = dot4(xb, w, acc[2 * u + 1]);
          }
        }
        __syncwarp();
        if (lane == 0) nvdb::mbar_arrive(empty0 + 8 * stage);
        if (++stage == n_stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      nvdb::mbar_wait(sempty0 + 8 * buf, ((t >> 1) & 1) ^ 1);   // folded two tiles ago
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ts[(2 * qg) * TS_STRIDE + 4 * rg + u] = acc[2 * u];
        ts[(2 * qg + 1) * TS_STRIDE + 4 * rg + u] = acc[2 * u + 1];
      }
    } else {
      int prev = -1;
      const uint32_t q0 = nvdb::smem_u32(qtile);
      for (int c = 0; c < n_chunks; ++c) {
        nvdb::mbar_wait(full0 + 8 * stage, phase);
        uint32_t a_tile = ring0 + stage * C::STAGE;
        if constexpr (MODE == kI8) {
          // the products of two chunks ago, which read this widened tile,
          // are done (the wait below); the barrier says so of every warp
          nvdb::bar_sync(2, LM_WG);
          const unsigned char* src = ring + (size_t)stage * C::STAGE;
          unsigned char* dst = cvt + cb * CVT_BYTES;
          for (int p = tid; p < LM_ROWS * 4; p += LM_WG) {
            const int row = p >> 2, piece = p & 3;
            const uint4 w = *reinterpret_cast<const uint4*>(src + row * 64 + piece * 16);
            uint4 lo, hi;
            nvdb::widen_i8x16(w, lo, hi);
            unsigned char* drow = dst + row * 128;
            *reinterpret_cast<uint4*>(drow + (((2 * piece) ^ (row & 7)) << 4)) = lo;
            *reinterpret_cast<uint4*>(drow + (((2 * piece + 1) ^ (row & 7)) << 4)) = hi;
          }
          __syncwarp();
          if (lane == 0) nvdb::mbar_arrive(empty0 + 8 * stage);   // the codes are read
          nvdb::fence_proxy_async();
          nvdb::bar_sync(3, LM_WG);
          a_tile = nvdb::smem_u32(dst);
          cb ^= 1;
        }
        nvdb::acc_fence(acc);
        nvdb::wgmma_fence();
        const uint64_t da = nvdb::sw128_desc(a_tile);
        const uint64_t db = nvdb::sw128_desc(q0 + c * NQ * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          nvdb::wgmma_m64k16<NQ>(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
        nvdb::wgmma_commit();
        if constexpr (MODE == kI8) {
          nvdb::wgmma_wait<1>();
        } else {
          if (prev >= 0) {
            nvdb::wgmma_wait<1>();   // the chunk before is done: release its stage
            if (lane == 0) nvdb::mbar_arrive(empty0 + 8 * prev);
          }
          prev = stage;
        }
        if (++stage == n_stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      nvdb::wgmma_wait<0>();
      if (MODE != kI8 && prev >= 0 && lane == 0) nvdb::mbar_arrive(empty0 + 8 * prev);
      nvdb::acc_fence(acc);
      nvdb::mbar_wait(sempty0 + 8 * buf, ((t >> 1) & 1) ^ 1);   // folded two tiles ago
      // accumulator 4 j + e: row 16 warp + lane / 4 + 8 (e >> 1), query
      // 8 j + 2 (lane % 4) + (e & 1)
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ts[(8 * j + 2 * (lane & 3) + (e & 1)) * TS_STRIDE + 16 * warp + (lane >> 2) +
             8 * (e >> 1)] = acc[4 * j + e];
    }
    nvdb::mbar_arrive(sfull0 + 8 * buf);   // release: the fold warps read these scores
  }
}

constexpr int MAX_DEVICES = 64;   // the per-device caches below

template <int MODE, int NQ>
cudaError_t launch_list(const CUtensorMap& vmap, const float* q, const int* order,
                        const int4* items, const int* n_items, const int* sids,
                        const float* scales, const int* fills, float* pv, int* pi, int P,
                        int Lcap, int Dp, int k, int R, int n_stages, int grid, size_t smem,
                        int dev, cudaStream_t st) {
  // the instance's shared-memory allowance, raised on a device only when a
  // call needs more than it was last given there (host time per call)
  static size_t allowed[MAX_DEVICES] = {};
  if (dev >= MAX_DEVICES || smem > allowed[dev]) {
    cudaError_t e = cudaFuncSetAttribute(probe_list_kernel<MODE, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) allowed[dev] = smem;
  }
  probe_list_kernel<MODE, NQ><<<grid, LM_NT, smem, st>>>(vmap, q, order, items, n_items, sids,
                                                         scales, fills, pv, pi, P, Lcap, Dp, k,
                                                         R, n_stages);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_list_nq(int nq, const CUtensorMap& vmap, const float* q, const int* order,
                           const int4* items, const int* n_items, const int* sids,
                           const float* scales, const int* fills, float* pv, int* pi, int P,
                           int Lcap, int Dp, int k, int R, int n_stages, int grid, size_t smem,
                           int dev, cudaStream_t st) {
#define NVDB_LIST_ARGS vmap, q, order, items, n_items, sids, scales, fills, pv, pi, P, Lcap, \
                       Dp, k, R, n_stages, grid, smem, dev, st
  if constexpr (MODE == kF32) {
    if (nq == F32_NQ) return launch_list<MODE, F32_NQ>(NVDB_LIST_ARGS);
  } else {
    switch (nq) {
      case 8: return launch_list<MODE, 8>(NVDB_LIST_ARGS);
      case 16: return launch_list<MODE, 16>(NVDB_LIST_ARGS);
      case 32: return launch_list<MODE, 32>(NVDB_LIST_ARGS);
      case 64: return launch_list<MODE, 64>(NVDB_LIST_ARGS);
      default: break;
    }
  }
#undef NVDB_LIST_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace


// The list-major entry (see the design note above). queries
// [B, Dp] f32, probes [B, P] int32, packed [nlist, Lcap, Dp] (mode 0 f32, 1
// bf16, 2 int8), slot_ids [nlist, Lcap] int32, slot_scales [nlist, Lcap]
// f32 (int8 only, else null), fills [nlist] int32; iscratch the int32
// scratch of items_offset(nlist, B * P) + 4 U ints; part_vals / part_ids
// [B, P * R, k]; outputs [B, k]. nq: queries a chunk (8, 16, 32 or 64; 16
// for f32), n_stages: the ring's depth (1 .. 8), U: pass 1's grid in items
// (at least the most items B * P pairs can make). Returns a cudaError_t (0
// on success); the launches are asynchronous on `stream`.
extern "C" int nvdb_ivf_probe_topk_list(const void* queries, const void* probes,
                                        const void* packed, const void* slot_ids,
                                        const void* slot_scales, const void* fills,
                                        void* iscratch, void* part_vals, void* part_ids,
                                        void* out_vals, void* out_ids, int B, int P, int nlist,
                                        int Lcap, int Dp, int k, int R, int nq, int n_stages,
                                        int U, int mode, void* stream) {
  if (B < 1 || P < 1 || nlist < 1 || Lcap < 1 || k < 1 || k > nvdb::WARP_LIST_MAX_K ||
      R < 1 || U < 1 || Dp < 16 || Dp % 16 != 0 || n_stages < 1 ||
      n_stages > LM_MAX_STAGES || (long long)nlist * Lcap > INT32_MAX ||
      (long long)U * R > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (mode < kF32 || mode > kI8) return (int)cudaErrorInvalidValue;
  if ((mode == kI8) != (slot_scales != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = list_smem_bytes(mode, nq, n_stages, Dp, k);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static int max_smem[MAX_DEVICES] = {};   // the device's opt-in limit, read once
  int limit = dev < MAX_DEVICES ? max_smem[dev] : 0;
  if (limit == 0) {
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) max_smem[dev] = limit;
  }
  if (smem > (size_t)limit) return (int)cudaErrorInvalidConfiguration;

  const int elem = mode == kF32 ? 4 : mode == kBF16 ? 2 : 1;
  CUtensorMap vmap;
  if (!nvdb::encode_map_2d(&vmap, packed, elem, (long long)nlist * Lcap, Dp, list_cols(mode),
                           LM_BOX_ROWS,
                           mode == kI8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;

  const int BP = B * P;
  int* is = static_cast<int*>(iscratch);
  int* counts = is;
  int* order = is + nlist;
  int* n_items = order + BP;
  int4* items = reinterpret_cast<int4*>(is + nvdb::items_offset(nlist, BP));
  float* pv = static_cast<float*>(part_vals);
  int* pi = static_cast<int*>(part_ids);
  e = nvdb::launch_group(static_cast<const int*>(probes), static_cast<const int*>(fills),
                         counts, order, items, n_items, pv, pi, BP, nlist, Lcap, nq, R, k, st);
  if (e != cudaSuccess || NVDB_PROBE_ABLATE == 1) return (int)e;
  const float* q = static_cast<const float*>(queries);
  const int* si = static_cast<const int*>(slot_ids);
  const float* sc = static_cast<const float*>(slot_scales);
  const int* fl = static_cast<const int*>(fills);
  const int grid = U * R;
  switch (mode) {
    case kF32:
      e = launch_list_nq<kF32>(nq, vmap, q, order, items, n_items, si, sc, fl, pv, pi, P, Lcap,
                               Dp, k, R, n_stages, grid, smem, dev, st);
      break;
    case kBF16:
      e = launch_list_nq<kBF16>(nq, vmap, q, order, items, n_items, si, sc, fl, pv, pi, P,
                                Lcap, Dp, k, R, n_stages, grid, smem, dev, st);
      break;
    default:
      e = launch_list_nq<kI8>(nq, vmap, q, order, items, n_items, si, sc, fl, pv, pi, P, Lcap,
                              Dp, k, R, n_stages, grid, smem, dev, st);
      break;
  }
  if (e != cudaSuccess || NVDB_PROBE_ABLATE == 2) return (int)e;
  merge_batched_kernel<<<(B + nvdb::MERGE_WARPS - 1) / nvdb::MERGE_WARPS,
                         nvdb::MERGE_WARPS * 32, (size_t)nvdb::MERGE_WARPS * k * 8, st>>>(
      pv, pi, static_cast<float*>(out_vals), static_cast<int*>(out_ids), B, P * R, k);
  return (int)cudaGetLastError();
}

// Pass 0 alone, for its test: iscratch as above (U at least the most items
// B * P pairs can make); part lists are left alone.
extern "C" int nvdb_ivf_group_pairs(const void* probes, const void* fills, void* iscratch,
                                    int B, int P, int nlist, int Lcap, int nq, void* stream) {
  if (B < 1 || P < 1 || nlist < 1 || Lcap < 1 || nq < 1) return (int)cudaErrorInvalidValue;
  const int BP = B * P;
  int* is = static_cast<int*>(iscratch);
  return (int)nvdb::launch_group(
      static_cast<const int*>(probes), static_cast<const int*>(fills), is, is + nlist,
      reinterpret_cast<int4*>(is + nvdb::items_offset(nlist, BP)), is + nlist + BP, nullptr,
      nullptr, BP, nlist, Lcap, nq, 1, 1, static_cast<cudaStream_t>(stream));
}

// The list-major pass 1's chunk width and ring depth for a slab type, Dp
// and k: ctas_per_sm CTAs a SM (so one's query staging and epilogue overlap
// the others' loads) with the widest chunk (nq <= nq_max) that leaves a
// ring of three stages or more, at most max_stages; else one CTA a SM with
// two stages, then one. Returns a cudaError_t; cudaErrorInvalidConfiguration
// where nothing fits.
extern "C" int nvdb_ivf_probe_list_plan(int mode, int Dp, int k, int nq_max, int ctas_per_sm,
                                        int max_stages, int* nq, int* n_stages) {
  if (mode < kF32 || mode > kI8 || Dp < 16 || k < 1 || ctas_per_sm < 1 || max_stages < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, per_sm = 0, optin = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return (int)e;
  const int top = max_stages < LM_MAX_STAGES ? max_stages : LM_MAX_STAGES;
  const int cands[4] = {64, 32, 16, 8};
  const long long shared = (long long)per_sm / ctas_per_sm - reserved;
  const long long limits[2] = {shared < optin ? shared : (long long)optin, (long long)optin};
  const int min_stages[3] = {3, 2, 1};
  for (int pass = 0; pass < 3; ++pass) {
    const long long limit = limits[pass == 0 ? 0 : 1];
    for (int c = 0; c < 4; ++c) {
      const int w = mode == kF32 ? F32_NQ : cands[c];
      if (mode != kF32 && w > nq_max) continue;
      const long long room = limit - (long long)list_smem_bytes(mode, w, 0, Dp, k);
      const long long fit = room < 0 ? 0 : room / list_stage_bytes(mode);
      if (fit >= min_stages[pass]) {
        *nq = w;
        *n_stages = fit < top ? (int)fit : top;
        return 0;
      }
      if (mode == kF32) break;
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}
