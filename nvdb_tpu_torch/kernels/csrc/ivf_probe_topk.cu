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
//     fills[list] (1 + the last live slot) are not read; a probe id outside
//     [0, nlist) is an empty list;
//   * output sorted by score descending, ties to the larger id; slots no
//     candidate fills hold (-inf, -1).
//
// What bounds it on an H100: bytes. At the partition index's flagship shape
// (B = 64, P = 32, Lcap 992, Dp 768 bf16) a batch reads 64 x 32 slabs of
// 1.5 MB, 3.1 GB, ~0.93 ms at 3.35 TB/s before the dead tail slots are
// skipped (a list at pad 2.0 is about half live). A bf16 slab costs 1
// multiply-add per byte read, far under the SIMT ridge of ~20, so the
// kernel is bound by HBM, and its design is about keeping loads in flight.
// Queries that probe the same list each read it again; grouping them (and
// TMA) is a later step.
//
// Design. The TPU grid (B, P) runs in order on one core and would fill one
// SM here.
//   Pass 1 (probe_partial_kernel): grid = B queries x S probe groups. A CTA
//   holds its query in shared memory (f32; bf16-rounded where the path
//   rounds) and walks its probes' live rows in tiles of 256: warp w scores
//   rows 32 w .. 32 w + 31 of the tile, each row read by the whole warp
//   with 16-byte loads (neighbouring lanes on neighbouring addresses),
//   UNROLL rows in flight, reduced across the warp with shuffles. The
//   tile's scores go to shared memory, in two buffers: warp 0 folds a tile
//   into the CTA's sorted top-k (nvdb::warp_offer: threshold test first,
//   improvers inserted) while the other warps score the next tile. Each
//   CTA writes its sorted partial list [B, S, k].
//   Pass 2 (nvdb::merge_kernel) folds the S partial lists of each query.
// The wrapper picks S so there are a few CTAs per SM at any batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int NT = 256;         // threads per pass-1 CTA
constexpr int NW = NT / 32;
constexpr int TILE = NW * 32;   // rows per tile: 32 per warp
constexpr int UNROLL = 4;       // rows a warp has in flight

enum Mode { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int MODE>
struct Piece {  // elements per 16-byte piece of a row
  static constexpr int kElems = MODE == kF32 ? 4 : MODE == kBF16 ? 8 : 16;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc + dot(query piece q, row piece w), in element order
template <int MODE>
__device__ __forceinline__ float piece_dot(const uint4& w, const float* q, float acc) {
  if constexpr (MODE == kF32) {
    const float4 v = *reinterpret_cast<const float4*>(&w);
    const float4 a = *reinterpret_cast<const float4*>(q);
    acc = fmaf(a.x, v.x, acc);
    acc = fmaf(a.y, v.y, acc);
    acc = fmaf(a.z, v.z, acc);
    acc = fmaf(a.w, v.w, acc);
  } else if constexpr (MODE == kBF16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      acc = fmaf(q[2 * e], f.x, acc);
      acc = fmaf(q[2 * e + 1], f.y, acc);
    }
  } else {
    const int8_t* c = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc = fmaf(q[e], static_cast<float>(c[e]), acc);
  }
  return acc;
}

// The whole warp scores rows row0 .. row0 + nrows - 1 (nrows <= UNROLL,
// warp-uniform) of a slab of `pieces` 16-byte pieces per row; every lane
// gets every sum.
template <int MODE>
__device__ __forceinline__ void score_rows(const uint4* __restrict__ slab, int row0,
                                           int nrows, int pieces, const float* qs,
                                           int lane, float* out) {
  float acc[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) acc[u] = 0.f;
  for (int c = lane; c < pieces; c += 32) {
    uint4 w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      w[u] = u < nrows ? __ldg(slab + (size_t)(row0 + u) * pieces + c) : make_uint4(0, 0, 0, 0);
    const float* q = qs + c * Piece<MODE>::kElems;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = piece_dot<MODE>(w[u], q, acc[u]);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(nvdb::FULL_MASK, acc[u], o);
    out[u] = acc[u];
  }
}

template <int MODE>
__global__ void __launch_bounds__(NT)
probe_partial_kernel(const float* __restrict__ queries, const int* __restrict__ probes,
                     const void* __restrict__ packed, const int* __restrict__ slot_ids,
                     const float* __restrict__ slot_scales, const int* __restrict__ fills,
                     float* __restrict__ part_vals, int* __restrict__ part_ids, int P,
                     int nlist, int Lcap, int Dp, int k, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [Dp] the query
  float* tile_s = qs + Dp;                     // [2][TILE] tile scores
  float* lv = tile_s + 2 * TILE;               // [k] top-k scores
  int* li = reinterpret_cast<int*>(lv + k);    // [k] top-k ids

  const int b = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < Dp; i += NT) {
    const float x = queries[(size_t)b * Dp + i];
    qs[i] = MODE == kF32 ? x : bf16_round(x);
  }
  for (int j = tid; j < k; j += NT) {
    lv[j] = -INFINITY;
    li[j] = -1;
  }
  __syncthreads();

  const int pieces = Dp / Piece<MODE>::kElems;
  const int per = (P + S - 1) / S;
  const int p0 = s * per, p1 = min(P, p0 + per);
  int t = 0;  // tiles scored so far: picks the score buffer
  for (int p = p0; p < p1; ++p) {
    const int lst = probes[(size_t)b * P + p];  // the same for every thread
    if (lst < 0 || lst >= nlist) continue;
    const int fill = min(fills[lst], Lcap);
    const uint4* slab = static_cast<const uint4*>(packed) + (size_t)lst * Lcap * pieces;
    const int* sid = slot_ids + (size_t)lst * Lcap;
    for (int r0 = 0; r0 < fill; r0 += TILE, ++t) {
      float* buf = tile_s + (t & 1) * TILE;
      const int wr0 = r0 + warp * 32;  // this warp's 32 rows of the tile
      float mine = -INFINITY;          // lane j keeps row wr0 + j's dot
      for (int j = 0; j < 32 && wr0 + j < fill; j += UNROLL) {
        float d[UNROLL];
        score_rows<MODE>(slab, wr0 + j, min(UNROLL, fill - wr0 - j), pieces, qs, lane, d);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (lane == j + u) mine = d[u];
      }
      buf[warp * 32 + lane] = mine;
      // buf is complete; the fold of the tile before it finished before
      // warp 0 reached here, so the other buffer is free for the next tile
      __syncthreads();
      if (warp == 0) {
        for (int i = 0; i < TILE; i += 32) {
          const int row = r0 + i + lane;
          const bool in = row < fill;
          const int id = in ? sid[row] : -1;
          float v = buf[i + lane];
          if (MODE == kI8 && in) v = v * slot_scales[(size_t)lst * Lcap + row];
          nvdb::warp_offer(lv, li, k, v, id, in && id >= 0, lane);
        }
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < k; j += NT) {
    const size_t o = ((size_t)b * S + s) * k + j;
    part_vals[o] = lv[j];
    part_ids[o] = li[j];
  }
}

template <int MODE>
cudaError_t launch_probe(const float* q, const int* probes, const void* packed,
                         const int* sids, const float* scales, const int* fills, float* pv,
                         int* pi, int B, int P, int nlist, int Lcap, int Dp, int k, int S,
                         cudaStream_t st) {
  const size_t smem = (size_t)Dp * 4 + (size_t)2 * TILE * 4 + (size_t)k * 8;
  cudaError_t e = cudaFuncSetAttribute(probe_partial_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  probe_partial_kernel<MODE><<<dim3(B, S), NT, smem, st>>>(
      q, probes, packed, sids, scales, fills, pv, pi, P, nlist, Lcap, Dp, k, S);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). queries [B, Dp] f32, probes [B, P]
// int32, packed [nlist, Lcap, Dp] (mode 0 f32, 1 bf16, 2 int8), slot_ids
// [nlist, Lcap] int32, slot_scales [nlist, Lcap] f32 (int8 only, else
// null), fills [nlist] int32; scratch part_vals / part_ids [B, S, k];
// outputs [B, k]. Returns a cudaError_t (0 on success); the launches are
// asynchronous on `stream`.
extern "C" int nvdb_ivf_probe_topk(const void* queries, const void* probes, const void* packed,
                                   const void* slot_ids, const void* slot_scales,
                                   const void* fills, void* part_vals, void* part_ids,
                                   void* out_vals, void* out_ids, int B, int P, int nlist,
                                   int Lcap, int Dp, int k, int S, int mode, void* stream) {
  if (B < 1 || P < 1 || nlist < 1 || Lcap < 1 || k < 1 || k > nvdb::WARP_LIST_MAX_K ||
      S < 1 || S > P || S > 65535 || Dp < 16 || Dp % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((mode == kI8) != (slot_scales != nullptr)) return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(queries);
  const int* pr = static_cast<const int*>(probes);
  const int* si = static_cast<const int*>(slot_ids);
  const float* sc = static_cast<const float*>(slot_scales);
  const int* fl = static_cast<const int*>(fills);
  float* pv = static_cast<float*>(part_vals);
  int* pi = static_cast<int*>(part_ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case kF32:
      e = launch_probe<kF32>(q, pr, packed, si, sc, fl, pv, pi, B, P, nlist, Lcap, Dp, k, S, st);
      break;
    case kBF16:
      e = launch_probe<kBF16>(q, pr, packed, si, sc, fl, pv, pi, B, P, nlist, Lcap, Dp, k, S, st);
      break;
    case kI8:
      e = launch_probe<kI8>(q, pr, packed, si, sc, fl, pv, pi, B, P, nlist, Lcap, Dp, k, S, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)nvdb::launch_merge(pv, pi, static_cast<float*>(out_vals),
                                 static_cast<int*>(out_ids), B, S, k, st);
}
