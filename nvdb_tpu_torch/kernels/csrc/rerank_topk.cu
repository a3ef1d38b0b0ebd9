// Exact rerank top-k for Hopper (sm_90a): for each query, gathers its R
// candidate rows by id straight from the store, scores them exactly and
// returns the k best (score, id). One launch per call.
//
// Replaces the Pallas TPU kernel nvdb_tpu/kernels/rerank.py:pallas_rerank
// (body _make_kernel :71-182, coefficients folded at :245-281). Same
// contract:
//   * score = amul * dot(q_b, row) - boff, the product and the difference
//     each rounded. The metric, the int8 row scale s, the cached row norms
//     n2 and, for residual stores, q.cent of the row's centroid fold into
//     the two coefficients per candidate, computed here as
//     kernels/rerank.py:fold_coefficients computes them (the same products
//     in the same order, each rounded):
//       dot: amul = s (1 without scales), boff = -qcent (0 without);
//       l2 (2 q.row - ||row||^2): amul = 2 s, boff = (s s) n2, or n2 without
//       scales, or n2 - 2 qcent for a residual store;
//   * the dot is exact f32: FMA, no TF32; the query is NOT rounded to bf16
//     (unlike the flat scan); bf16 rows are widened exactly, int8 codes are
//     widened exactly;
//   * ids < 0 (padding) and ids >= n_rows never score; an id that repeats
//     within a query's row is taken once;
//   * output sorted by score descending, ties to the larger id; slots no
//     candidate fills hold (-inf, -1); k <= 128.
//
// What bounds it on an H100: the gather. At B = 256, R = 100 over a bf16
// 768-dim store it reads 39 MB of rows from random places, ~12 us at
// 3.35 TB/s if the loads kept the memory busy; each row is only 1.5 KB, so
// it is bound by load latency and the number of loads in flight, not by
// bytes or by the 2 B R Dp = 39 MFLOP of products.
//
// Design. The Pallas kernel DMAs aligned 8/16/32-row blocks because Mosaic
// cannot slice one row of a tiled HBM ref; that workaround is not carried
// over. One CTA of 16 warps per query, the query in shared memory in f32.
//   Rows in flight. A warp takes eight candidates at a time: lane i reads
//   candidate i's id and coefficients, the ids are shared by shuffle, and
//   every lane issues its 16-byte loads of all eight rows before any
//   product, neighbouring lanes on neighbouring addresses; then eight
//   shuffle reductions. At R = 100 each warp makes one such pass.
//   Selection by counting. The R scores and ids go to shared memory. A
//   candidate whose id an earlier slot holds is struck (its score is the
//   same: the same row and query give the same dot). Then each candidate's
//   rank is the number of candidates whose (score, id) beats it, every
//   thread counting at once; rank < k writes slot `rank`. Nothing is
//   inserted in sequence.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int NT = 512;  // threads per CTA
constexpr int NW = NT / 32;
constexpr int NR = 8;    // rows a warp has in flight

enum Mode { kF32 = 0, kBF16 = 1, kI8 = 2 };

// acc[i] = dot(q, row id[i]) for the NR rows with ok[i], every lane holding
// the full sums. Each row's products run in the order c = lane, lane + 32,
// ... and within a 16-byte piece left to right, then a butterfly reduction.
template <int MODE>
__device__ __forceinline__ void rows_dot(const void* __restrict__ vptr, const int (&id)[NR],
                                         const bool (&ok)[NR], int Dp, const float* qs,
                                         int lane, float (&acc)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  if constexpr (MODE == kF32) {
    const float* base = static_cast<const float*>(vptr);
    for (int c = lane; c < Dp / 4; c += 32) {
      float4 v[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i)
        v[i] = ok[i] ? reinterpret_cast<const float4*>(base + (size_t)id[i] * Dp)[c]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 q = q4[c];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        acc[i] = fmaf(q.x, v[i].x, acc[i]);
        acc[i] = fmaf(q.y, v[i].y, acc[i]);
        acc[i] = fmaf(q.z, v[i].z, acc[i]);
        acc[i] = fmaf(q.w, v[i].w, acc[i]);
      }
    }
  } else if constexpr (MODE == kBF16) {
    const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(vptr);
    for (int c = lane; c < Dp / 8; c += 32) {
      uint4 w[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i)
        w[i] = ok[i] ? reinterpret_cast<const uint4*>(base + (size_t)id[i] * Dp)[c]
                     : make_uint4(0u, 0u, 0u, 0u);
      const float4 qa = q4[2 * c], qb = q4[2 * c + 1];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        // a bf16 is the upper half of its f32; the lower address is the low half
        acc[i] = fmaf(qa.x, __uint_as_float(w[i].x << 16), acc[i]);
        acc[i] = fmaf(qa.y, __uint_as_float(w[i].x & 0xffff0000u), acc[i]);
        acc[i] = fmaf(qa.z, __uint_as_float(w[i].y << 16), acc[i]);
        acc[i] = fmaf(qa.w, __uint_as_float(w[i].y & 0xffff0000u), acc[i]);
        acc[i] = fmaf(qb.x, __uint_as_float(w[i].z << 16), acc[i]);
        acc[i] = fmaf(qb.y, __uint_as_float(w[i].z & 0xffff0000u), acc[i]);
        acc[i] = fmaf(qb.z, __uint_as_float(w[i].w << 16), acc[i]);
        acc[i] = fmaf(qb.w, __uint_as_float(w[i].w & 0xffff0000u), acc[i]);
      }
    }
  } else {
    const int8_t* base = static_cast<const int8_t*>(vptr);
    for (int c = lane; c < Dp / 16; c += 32) {
      uint4 w[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i)
        w[i] = ok[i] ? reinterpret_cast<const uint4*>(base + (size_t)id[i] * Dp)[c]
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 q = q4[4 * c + e];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const uint32_t x = e == 0 ? w[i].x : e == 1 ? w[i].y : e == 2 ? w[i].z : w[i].w;
          // the word's four bytes, lowest address first, sign-extended
          acc[i] = fmaf(q.x, static_cast<float>((int)(x << 24) >> 24), acc[i]);
          acc[i] = fmaf(q.y, static_cast<float>((int)(x << 16) >> 24), acc[i]);
          acc[i] = fmaf(q.z, static_cast<float>((int)(x << 8) >> 24), acc[i]);
          acc[i] = fmaf(q.w, static_cast<float>((int)x >> 24), acc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(nvdb::FULL_MASK, acc[i], o);
  }
}

template <int MODE>
__global__ void __launch_bounds__(NT)
rerank_kernel(const float* __restrict__ queries, const int* __restrict__ cand_ids,
              const void* __restrict__ vectors, const float* __restrict__ scales,
              const float* __restrict__ norms2, const float* __restrict__ qcent,
              float* __restrict__ out_vals, int* __restrict__ out_ids, int R, int Dp,
              int n_rows, int k, int l2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [Dp] the query, f32
  float* sv = qs + Dp;                         // [R] candidate scores
  int* si = reinterpret_cast<int*>(sv + R);    // [R] candidate ids
  float* lv = reinterpret_cast<float*>(si + R);  // [k] top-k scores
  int* li = reinterpret_cast<int*>(lv + k);      // [k] top-k ids

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* q4 = reinterpret_cast<const float4*>(queries + (size_t)b * Dp);
  for (int c = tid; c < Dp / 4; c += NT) reinterpret_cast<float4*>(qs)[c] = q4[c];
  for (int j = tid; j < k; j += NT) {
    lv[j] = -INFINITY;
    li[j] = -1;
  }
  __syncthreads();

  const size_t base = (size_t)b * R;
  for (int rb = warp; rb < R; rb += NW * NR) {
    // lane i < NR owns candidate rb + i * NW: its id, coefficients and score
    const int my_r = rb + lane * NW;
    const bool mine = lane < NR && my_r < R;
    const int my_id = mine ? cand_ids[base + my_r] : -1;
    const bool my_ok = my_id >= 0 && my_id < n_rows;
    float sc = 1.f, n2 = 0.f, qc = 0.f;
    if (my_ok) {
      if (scales != nullptr) sc = scales[my_id];
      if (l2) n2 = norms2[my_id];
      if (qcent != nullptr) qc = qcent[base + my_r];
    }
    int id[NR];
    bool ok[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      id[i] = __shfl_sync(nvdb::FULL_MASK, my_id, i);
      ok[i] = id[i] >= 0 && id[i] < n_rows;
    }
    float acc[NR];
    rows_dot<MODE>(vectors, id, ok, Dp, qs, lane, acc);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NR; ++i)
      if (lane == i) dot = acc[i];
    if (mine) {
      float s = -INFINITY;
      if (my_ok) {
        // fold_coefficients, each product and difference rounded (no
        // contraction into an FMA), as the plain version computes them
        float amul, boff;
        if (!l2) {
          amul = sc;
          boff = -qc;
        } else if (qcent != nullptr) {
          amul = __fmul_rn(2.0f, sc);
          boff = __fsub_rn(n2, __fmul_rn(2.0f, qc));
        } else if (scales != nullptr) {
          amul = __fmul_rn(2.0f, sc);
          boff = __fmul_rn(__fmul_rn(sc, sc), n2);
        } else {
          amul = 2.0f;
          boff = n2;
        }
        s = __fsub_rn(__fmul_rn(amul, dot), boff);
      }
      sv[my_r] = s;
      si[my_r] = my_ok ? my_id : -1;
    }
  }
  __syncthreads();

  // an id seen earlier in the row is struck. Reads si only, writes sv only.
  for (int r = tid; r < R; r += NT) {
    const int id = si[r];
    if (id < 0) continue;
    for (int r2 = 0; r2 < r; ++r2) {
      if (si[r2] == id) {
        sv[r] = -INFINITY;
        break;
      }
    }
  }
  __syncthreads();

  // rank by counting: the kept candidates have distinct ids, so (score desc,
  // id desc) orders them strictly and every rank is taken once
  for (int r = tid; r < R; r += NT) {
    const float s = sv[r];
    const int id = si[r];
    if (id < 0 || !(s > -INFINITY)) continue;
    int rank = 0;
    for (int r2 = 0; r2 < R; ++r2) rank += nvdb::better(sv[r2], si[r2], s, id) ? 1 : 0;
    if (rank < k) {
      lv[rank] = s;
      li[rank] = id;
    }
  }
  __syncthreads();
  for (int j = tid; j < k; j += NT) {
    out_vals[(size_t)b * k + j] = lv[j];
    out_ids[(size_t)b * k + j] = li[j];
  }
}

template <int MODE>
cudaError_t launch(const float* q, const int* ids, const void* v, const float* sc,
                   const float* n2, const float* qc, float* ov, int* oi, int B, int R,
                   int Dp, int n_rows, int k, int l2, cudaStream_t st) {
  const size_t smem = (size_t)Dp * 4 + (size_t)R * 8 + (size_t)k * 8;
  cudaError_t e = cudaFuncSetAttribute(rerank_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  rerank_kernel<MODE><<<B, NT, smem, st>>>(q, ids, v, sc, n2, qc, ov, oi, R, Dp, n_rows, k,
                                           l2);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). mode: 0 f32 store, 1 bf16, 2 int8.
// queries [B, Dp] f32, cand_ids [B, R] int32, outputs [B, k]; scales [Np]
// f32 (int8 row scales), norms2 [Np] f32 (needed when l2 != 0) and qcent
// [B, R] f32 (residual stores) may each be null. Returns a cudaError_t (0
// on success); the one launch is asynchronous on `stream`.
extern "C" int nvdb_rerank_topk(const void* q, const void* cand_ids, const void* vectors,
                                const void* scales, const void* norms2, const void* qcent,
                                void* out_vals, void* out_ids, int B, int R, int Dp,
                                int n_rows, int k, int mode, int l2, void* stream) {
  if (B < 1 || R < 1 || k < 1 || k > nvdb::WARP_LIST_MAX_K || Dp < 16 || Dp % 16 != 0 ||
      n_rows < 0 || (l2 && norms2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const int* ids = static_cast<const int*>(cand_ids);
  const float* sc = static_cast<const float*>(scales);
  const float* n2 = static_cast<const float*>(norms2);
  const float* qc = static_cast<const float*>(qcent);
  float* ov = static_cast<float*>(out_vals);
  int* oi = static_cast<int*>(out_ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return (int)launch<kF32>(qf, ids, vectors, sc, n2, qc, ov, oi, B, R, Dp, n_rows, k, l2,
                               st);
    case kBF16:
      return (int)launch<kBF16>(qf, ids, vectors, sc, n2, qc, ov, oi, B, R, Dp, n_rows, k,
                                l2, st);
    case kI8:
      return (int)launch<kI8>(qf, ids, vectors, sc, n2, qc, ov, oi, B, R, Dp, n_rows, k, l2,
                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
