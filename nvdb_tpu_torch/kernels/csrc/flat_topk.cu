// Exact flat-scan top-k for Hopper (sm_90a): scores every valid store row
// against a batch of queries and returns each query's k best (score, id).
//
// Replaces the Pallas TPU kernel nvdb_tpu/kernels/flat_scan.py:pallas_flat_topk
// (body _make_kernel :133-364, scoring _scores :98-130, final sort
// _merge_topk_sorted :76-95). Same contract:
//   * score = dot(q, row), one code path per store type:
//       f32 store     full f32 FMA (no TF32 or tensor-core shortcut);
//       bf16 store    query rounded to bf16 first, f32 products and sums;
//       int8 store    query rounded to bf16, codes widened exactly, f32 sum,
//                     times the row's scale;
//       int8 x int8   exact int32 sum (__dp4a), times row scale, times
//                     query scale (in that order, as the reference does);
//   * rows with id >= n_valid are never returned (n_valid is a runtime int);
//   * output sorted by score descending, ties to the larger id; slots that
//     no valid row fills hold (-inf, -1); k <= 128.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s SIMT f32, NVIDIA
// data sheet): at batch B the bf16 scan does about B multiply-adds per byte
// streamed, against a SIMT ridge of ~20 op/byte. So this kernel is
// compute-bound (SIMT FMA) at B = 512 and bandwidth-bound only at B <= ~8;
// with tensor cores (ridge ~295 op/byte) the scan would stay
// bandwidth-bound up to B ~ 295, which is the later wgmma rewrite.
// Measured on an H100 80GB HBM3 at its 700 W power limit (1M x 768 bf16,
// k = 10): 30.7 ms per scan at B = 512, 38% of the SIMT f32 peak, and
// 3.86 ms at B = 8, where the 64-query tile computes 8x the needed products.
//
// Design. The Pallas kernel is one sequential grid over row tiles carrying
// the top-k in VMEM; copied as is it would fill one SM of 132. Here:
//   pass 1 (scan_partial_kernel): grid = S row slices x query blocks of QB.
//     Each CTA walks its slice in TR-row tiles. A tile is scored as a small
//     SIMT GEMM: query and row chunks of DK dims are staged in shared memory
//     (16-byte global loads, neighbouring threads on neighbouring addresses)
//     and each thread keeps a 4 x 4 register tile of sums. The scores of the
//     tile go to shared memory, and one warp per query tests them against
//     the query's current k-th entry first; only the rare improvers are
//     inserted into the sorted per-query list in shared memory, so
//     insertion is not paid per row. Each CTA writes its [B, S, k] partial.
//   pass 2 (nvdb::merge_kernel, topk_common.cuh): one warp per query folds
//     the S sorted partial lists into the final sorted top-k, stopping early
//     in each list at the first entry that no longer beats the k-th.
// The wrapper picks S so there are at least two CTAs per SM at any batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using nvdb::warp_offer;

constexpr int QB = 64;        // queries per CTA
constexpr int TR = 64;        // rows per tile
constexpr int DK = 64;        // dims per staged chunk
constexpr int LD = QB + 4;    // shared-memory row stride (floats), 16-byte aligned
constexpr int NT = 256;       // threads per pass-1 CTA
constexpr int MAX_K = nvdb::WARP_LIST_MAX_K;

static_assert(QB == TR, "the 16 x 16 thread grid covers a QB x TR tile");
static_assert(QB <= DK, "the [QB][LD] score tile reuses the [DK][LD] query chunk");

enum Mode { kF32 = 0, kBF16 = 1, kI8 = 2, kI8Q8 = 3 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& w, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack_i8x16(const uint4& w, float* out) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = static_cast<float>(b[e]);
}

// Staging. A [64 x DK] block (rows r0.., dims d0..) is read in 16-byte
// pieces: piece f is half (f & 1) of 32-byte sector (f >> 7) of row
// (f >> 1) & 63, so two neighbouring threads read one whole sector and a
// warp reads sixteen rows. The block is stored transposed, dst[d * LD + r]:
// with LD = 68 the two halves of a sector land 16 banks apart, so a warp's
// stores hit 32 distinct banks (f32 and packed int8; 2-way for bf16 and
// int8 widened to f32). Rows at or past r_lim are zero.
__device__ __forceinline__ int piece_row(int f) { return (f >> 1) & 63; }
template <int ELEMS>  // elements per 16-byte piece
__device__ __forceinline__ int piece_col(int f) {
  return (f >> 7) * 2 * ELEMS + (f & 1) * ELEMS;
}

// round: bf16-round the values (queries of the bf16 and int8 paths).
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, int r0,
                                          int r_lim, int Dp, int d0, float* dst,
                                          int tid, bool round) {
#pragma unroll
  for (int p = 0; p < (64 * DK / 4) / NT; ++p) {
    const int f = tid + NT * p;
    const int r = piece_row(f), c = piece_col<4>(f);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < r_lim)
      v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * Dp + d0 + c);
    if (round) {
      v.x = bf16_round(v.x);
      v.y = bf16_round(v.y);
      v.z = bf16_round(v.z);
      v.w = bf16_round(v.w);
    }
    dst[(c + 0) * LD + r] = v.x;
    dst[(c + 1) * LD + r] = v.y;
    dst[(c + 2) * LD + r] = v.z;
    dst[(c + 3) * LD + r] = v.w;
  }
}

__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src,
                                           int r0, int r_lim, int Dp, int d0,
                                           float* dst, int tid) {
#pragma unroll
  for (int p = 0; p < (64 * DK / 8) / NT; ++p) {
    const int f = tid + NT * p;
    const int r = piece_row(f), c = piece_col<8>(f);
    float x[8];
    if (r0 + r < r_lim) {
      const uint4 w = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * Dp + d0 + c);
      unpack_bf16x8(w, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(c + e) * LD + r] = x[e];
  }
}

__device__ __forceinline__ void stage_i8(const int8_t* __restrict__ src, int r0,
                                         int r_lim, int Dp, int d0, float* dst,
                                         int tid) {
  static_assert(64 * DK / 16 == NT, "one 16-byte load per thread");
  const int r = piece_row(tid), c = piece_col<16>(tid);
  float x[16];
  if (r0 + r < r_lim) {
    const uint4 w = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * Dp + d0 + c);
    unpack_i8x16(w, x);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) x[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) dst[(c + e) * LD + r] = x[e];
}

// int8 block kept packed: dst[(d / 4) * LD + r] holds dims d..d+3 of row r.
__device__ __forceinline__ void stage_i8_packed(const int8_t* __restrict__ src,
                                                int r0, int r_lim, int Dp, int d0,
                                                int* dst, int tid) {
  const int r = piece_row(tid), c = piece_col<16>(tid);
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (r0 + r < r_lim)
    w = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * Dp + d0 + c);
  dst[(c / 4 + 0) * LD + r] = static_cast<int>(w.x);
  dst[(c / 4 + 1) * LD + r] = static_cast<int>(w.y);
  dst[(c / 4 + 2) * LD + r] = static_cast<int>(w.z);
  dst[(c / 4 + 3) * LD + r] = static_cast<int>(w.w);
}

template <int MODE>
__global__ void __launch_bounds__(NT, 2)
scan_partial_kernel(const void* __restrict__ qptr, const void* __restrict__ vptr,
                    const float* __restrict__ scales,
                    const float* __restrict__ qscales,
                    float* __restrict__ part_vals, int* __restrict__ part_ids,
                    int B, int Dp, int n_eff, int k, int S, int rows_per_slice) {
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

  for (int r0 = r_begin; r0 < r_end; r0 += TR) {
    float sc[4][4];
    if constexpr (MODE == kI8Q8) {
      const int8_t* q8 = static_cast<const int8_t*>(qptr) + (size_t)q0 * Dp;
      const int8_t* v8 = static_cast<const int8_t*>(vptr);
      int* Ai = reinterpret_cast<int*>(As);
      int* Bi = reinterpret_cast<int*>(Bs);
      int acc[4][4] = {};
      for (int d0 = 0; d0 < Dp; d0 += DK) {
        stage_i8_packed(q8, 0, B - q0, Dp, d0, Ai, tid);
        stage_i8_packed(v8, r0, r_end, Dp, d0, Bi, tid);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < DK / 4; ++kk) {
          const int4 a = *reinterpret_cast<const int4*>(Ai + kk * LD + ty * 4);
          const int4 b = *reinterpret_cast<const int4*>(Bi + kk * LD + tx * 4);
          const int av[4] = {a.x, a.y, a.z, a.w};
          const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = static_cast<float>(acc[i][j]);
    } else {
      const float* qf = static_cast<const float*>(qptr) + (size_t)q0 * Dp;
      float acc[4][4] = {};
      for (int d0 = 0; d0 < Dp; d0 += DK) {
        stage_f32(qf, 0, B - q0, Dp, d0, As, tid, MODE != kF32);
        if constexpr (MODE == kF32)
          stage_f32(static_cast<const float*>(vptr), r0, r_end, Dp, d0, Bs, tid, false);
        else if constexpr (MODE == kBF16)
          stage_bf16(static_cast<const __nv_bfloat16*>(vptr), r0, r_end, Dp, d0, Bs, tid);
        else
          stage_i8(static_cast<const int8_t*>(vptr), r0, r_end, Dp, d0, Bs, tid);
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
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = acc[i][j];
    }

    // epilogue: scales, then the tile's scores to shared memory
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + tx * 4 + j;
      const float rs = (MODE == kI8 || MODE == kI8Q8) && row < r_end ? scales[row] : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        float v = sc[i][j];
        if (MODE == kI8 || MODE == kI8Q8) v = v * rs;
        if (MODE == kI8Q8) v = v * (q < B ? qscales[q] : 1.f);
        Ss[(ty * 4 + i) * LD + tx * 4 + j] = v;
      }
    }
    __syncthreads();

    // running top-k: warp w owns queries w, w + 8, ...
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

template <int MODE>
cudaError_t launch_scan(const void* q, const void* v, const float* scales,
                        const float* qscales, float* part_vals, int* part_ids,
                        int B, int Dp, int n_eff, int k, int S, int rows_per_slice,
                        cudaStream_t stream) {
  const size_t smem = (size_t)2 * DK * LD * sizeof(float) + (size_t)QB * k * 8;
  cudaError_t e = cudaFuncSetAttribute(scan_partial_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(S, (B + QB - 1) / QB);
  scan_partial_kernel<MODE><<<grid, NT, smem, stream>>>(
      q, v, scales, qscales, part_vals, part_ids, B, Dp, n_eff, k, S, rows_per_slice);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). mode: 0 f32 store, 1 bf16 store, 2 int8
// store with f32 queries, 3 int8 store with int8 queries (qscales given).
// Scratch part_vals / part_ids hold [B, S, k]; outputs are [B, k].
// Returns a cudaError_t (0 on success); the launches are asynchronous on
// `stream`.
extern "C" int nvdb_flat_topk(const void* q, const void* v, const void* scales,
                              const void* qscales, void* part_vals, void* part_ids,
                              void* out_vals, void* out_ids, int B, int Dp, int n_eff,
                              int k, int S, int mode, void* stream) {
  if (B < 1 || k < 1 || k > MAX_K || S < 1 || Dp < DK || Dp % DK != 0 || n_eff < 0)
    return (int)cudaErrorInvalidValue;
  if ((mode == kI8 || mode == kI8Q8) && scales == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == kI8Q8 && qscales == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n_eff + TR - 1) / TR;
  const int rows_per_slice = ((tiles + S - 1) / S) * TR;
  const float* sc = static_cast<const float*>(scales);
  const float* qs = static_cast<const float*>(qscales);
  float* pv = static_cast<float*>(part_vals);
  int* pi = static_cast<int*>(part_ids);
  cudaError_t e;
  switch (mode) {
    case kF32:
      e = launch_scan<kF32>(q, v, sc, qs, pv, pi, B, Dp, n_eff, k, S, rows_per_slice, st);
      break;
    case kBF16:
      e = launch_scan<kBF16>(q, v, sc, qs, pv, pi, B, Dp, n_eff, k, S, rows_per_slice, st);
      break;
    case kI8:
      e = launch_scan<kI8>(q, v, sc, qs, pv, pi, B, Dp, n_eff, k, S, rows_per_slice, st);
      break;
    case kI8Q8:
      e = launch_scan<kI8Q8>(q, v, sc, qs, pv, pi, B, Dp, n_eff, k, S, rows_per_slice, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)nvdb::launch_merge(pv, pi, static_cast<float*>(out_vals),
                                 static_cast<int*>(out_ids), B, S, k, st);
}
