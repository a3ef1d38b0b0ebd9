// Exact rerank top-k for Hopper (sm_90a): for each query, gathers its R
// candidate rows by id straight from the store, scores them exactly and
// returns the k best (score, id).
//
// Replaces the Pallas TPU kernel nvdb_tpu/kernels/rerank.py:pallas_rerank
// (body _make_kernel :71-182, coefficients folded at :245-281). Same
// contract:
//   * score = amul[b, r] * dot(q_b, row) - boff[b, r]. The wrapper folds
//     the metric, the int8 scale and the cached row norms into amul / boff
//     (l2: amul = 2 s, boff = s^2 ||codes||^2; dot: amul = s, boff = 0), so
//     the kernel is metric-oblivious;
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
// over. One CTA per query: the query sits in shared memory in f32, each
// warp takes candidates r = warp, warp + 8, ... and reads the row with
// 16-byte loads, neighbouring lanes on neighbouring addresses, then
// reduces the dot across the warp. The R scores go to shared memory;
// duplicates are masked; then one warp folds them into the sorted top-k
// list with the shared threshold-then-insert (topk_common.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA
constexpr int NW = NT / 32;

enum Mode { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int MODE>
__device__ __forceinline__ float row_dot(const void* __restrict__ vptr, size_t row,
                                         int Dp, const float* qs, int lane) {
  float acc = 0.f;
  if constexpr (MODE == kF32) {
    const float4* r4 = reinterpret_cast<const float4*>(
        static_cast<const float*>(vptr) + row * (size_t)Dp);
    for (int c = lane; c < Dp / 4; c += 32) {
      const float4 v = r4[c];
      const float* q = qs + 4 * c;
      acc = fmaf(q[0], v.x, acc);
      acc = fmaf(q[1], v.y, acc);
      acc = fmaf(q[2], v.z, acc);
      acc = fmaf(q[3], v.w, acc);
    }
  } else if constexpr (MODE == kBF16) {
    const uint4* r4 = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(vptr) + row * (size_t)Dp);
    for (int c = lane; c < Dp / 8; c += 32) {
      const uint4 w = r4[c];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
      const float* q = qs + 8 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        acc = fmaf(q[2 * e], f.x, acc);
        acc = fmaf(q[2 * e + 1], f.y, acc);
      }
    }
  } else {
    const uint4* r4 = reinterpret_cast<const uint4*>(
        static_cast<const int8_t*>(vptr) + row * (size_t)Dp);
    for (int c = lane; c < Dp / 16; c += 32) {
      const uint4 w = r4[c];
      const int8_t* b = reinterpret_cast<const int8_t*>(&w);
      const float* q = qs + 16 * c;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc = fmaf(q[e], static_cast<float>(b[e]), acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(nvdb::FULL_MASK, acc, o);
  return acc;
}

template <int MODE>
__global__ void __launch_bounds__(NT)
rerank_kernel(const float* __restrict__ queries, const int* __restrict__ cand_ids,
              const void* __restrict__ vectors, const float* __restrict__ amul,
              const float* __restrict__ boff, float* __restrict__ out_vals,
              int* __restrict__ out_ids, int R, int Dp, int n_rows, int k) {
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
  __syncthreads();

  const size_t base = (size_t)b * R;
  for (int r = warp; r < R; r += NW) {
    const int id = cand_ids[base + r];  // warp-uniform
    const bool ok = id >= 0 && id < n_rows;
    float s = -INFINITY;
    // multiply, then subtract, each rounded (no contraction to one FMA),
    // as the plain version and the Pallas kernel compute it
    if (ok)
      s = __fsub_rn(__fmul_rn(amul[base + r],
                              row_dot<MODE>(vectors, (size_t)id, Dp, qs, lane)),
                    boff[base + r]);
    if (lane == 0) {
      sv[r] = s;
      si[r] = ok ? id : -1;
    }
  }
  __syncthreads();

  // an id seen earlier in the row is masked (its score is the same: the
  // same row and query give the same dot). Reads si only, writes sv only.
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

  if (warp != 0) return;  // one warp folds the R scores into the list
  for (int j = lane; j < k; j += 32) {
    lv[j] = -INFINITY;
    li[j] = -1;
  }
  __syncwarp();
  for (int r0 = 0; r0 < R; r0 += 32) {
    const int r = r0 + lane;
    const bool in = r < R;
    const float s = in ? sv[r] : -INFINITY;
    const int id = in ? si[r] : -1;
    nvdb::warp_offer(lv, li, k, s, id, in && id >= 0 && s > -INFINITY, lane);
  }
  for (int j = lane; j < k; j += 32) {
    out_vals[(size_t)b * k + j] = lv[j];
    out_ids[(size_t)b * k + j] = li[j];
  }
}

template <int MODE>
cudaError_t launch(const float* q, const int* ids, const void* v, const float* am,
                   const float* bo, float* ov, int* oi, int B, int R, int Dp,
                   int n_rows, int k, cudaStream_t st) {
  const size_t smem = (size_t)Dp * 4 + (size_t)R * 8 + (size_t)k * 8;
  cudaError_t e = cudaFuncSetAttribute(rerank_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  rerank_kernel<MODE><<<B, NT, smem, st>>>(q, ids, v, am, bo, ov, oi, R, Dp, n_rows, k);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). mode: 0 f32 store, 1 bf16, 2 int8 (the
// row scale is folded into amul / boff by the caller). queries [B, Dp] f32,
// cand_ids / amul / boff [B, R], outputs [B, k]. Returns a cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int nvdb_rerank_topk(const void* q, const void* cand_ids, const void* vectors,
                                const void* amul, const void* boff, void* out_vals,
                                void* out_ids, int B, int R, int Dp, int n_rows, int k,
                                int mode, void* stream) {
  if (B < 1 || R < 1 || k < 1 || k > nvdb::WARP_LIST_MAX_K || Dp < 16 || Dp % 16 != 0 ||
      n_rows < 0)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const int* ids = static_cast<const int*>(cand_ids);
  const float* am = static_cast<const float*>(amul);
  const float* bo = static_cast<const float*>(boff);
  float* ov = static_cast<float*>(out_vals);
  int* oi = static_cast<int*>(out_ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case kF32:
      e = launch<kF32>(qf, ids, vectors, am, bo, ov, oi, B, R, Dp, n_rows, k, st);
      break;
    case kBF16:
      e = launch<kBF16>(qf, ids, vectors, am, bo, ov, oi, B, R, Dp, n_rows, k, st);
      break;
    case kI8:
      e = launch<kI8>(qf, ids, vectors, am, bo, ov, oi, B, R, Dp, n_rows, k, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
