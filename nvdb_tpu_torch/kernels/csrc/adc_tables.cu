// IVF-PQ ADC lookup tables for Hopper (sm_90a): for every (query, probe)
// pair, the squared distance of the query's rotated residual against each
// of the 256 codewords of each of the M subspaces, rounded once to bf16:
//   lut[b, p, m, j] = bf16( (r2 - 2 dot) + c2 ),
//   res = q_rot[b] - centroids[probes[b, p]]   (one rounded f32 subtraction),
//   r2 = |res_m|^2, dot = res_m . cb[m, j], c2 = |cb[m, j]|^2,
// all in f32 with FMA (never TF32), the three terms combined in the order
// written, each step rounded (adc_table_math.cuh, which the fused key scan
// of adc_topk.cu shares, so the two give the same bits). That is nvdb_tpu/kernels/pq.py:89 adc_lut
// followed by the bf16 cast of nvdb_tpu/index/ivf_pq.py:73; the JAX package
// leaves both to XLA, so this kernel replaces no Pallas kernel. It replaces
// the port's plain route (pq.adc_lut, then .to(bfloat16)), which wrote a
// [B, P, M, 256] f32 tensor through several temporaries, read it back and
// wrote the bf16 copy. The sum of the dsub products runs d = 0, 1, ... in
// one FMA chain, another order than a library's product, so a rare entry
// lands on the neighbouring bf16 value.
//
// A probe of a list that is out of range or holds no live slot gets zeros:
// the scan reads nothing of it.
//
// What bounds it on an H100: bytes written. B = 256, P = 64, M = 96 is
// 0.805 GB of bf16 tables (0.24 ms at 3.35 TB/s) against 6.4 GFLOP of f32
// FMA (0.10 ms at 67 TFLOP/s) and a few MB read.
//
// Design. The codebooks (M x 256 x dsub f32, 786 KB at M = 96, dsub = 8)
// fit no CTA's shared memory, and a CTA that built whole tables would pull
// them through L2 once per pair. So a CTA owns 8 subspaces and walks many
// (b, p) pairs: thread (m, lane) keeps its 8 codewords of subspace m in
// registers for the whole walk (8 x dsub floats and their 8 norms). A warp
// works alone, with no shared memory and no barrier: 32 pairs at a time,
// lane t loads pair t's residual slice of subspace m (the only slice the
// warp needs) into registers, and the warp then takes the pairs in turn,
// broadcasting each slice by shuffle. Each thread writes its 8 entries as
// one 16-byte store, the 32 lanes of a warp covering one subspace's 512
// contiguous bytes. Register-resident instances exist for dsub 4, 8, 12
// and 16; any other dsub takes a plain kernel (one CTA per pair, codebooks
// through the cache).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_table_math.cuh"

namespace {

constexpr int NT = 256;     // threads per CTA
constexpr int G = NT / 32;  // subspaces per CTA, one warp each
constexpr int CW = 8;       // codewords per thread: one 16-byte store
constexpr int T = 32;       // (b, p) pairs a warp stages per round, one a lane
constexpr unsigned FULL_MASK = 0xffffffffu;
static_assert(CW == 8 && 32 * CW == 256, "a warp covers a subspace, 16 bytes a lane");

__device__ __forceinline__ int live_list(const int* __restrict__ probes,
                                         const int* __restrict__ fills, int pair,
                                         int nlist) {
  const int li = probes[pair];
  return (li >= 0 && li < nlist && fills[li] > 0) ? li : -1;
}

template <int DSUB>
__global__ void __launch_bounds__(NT)
adc_tables_kernel(const float* __restrict__ q_rot, const int* __restrict__ probes,
                  const float* __restrict__ cents, const float* __restrict__ cb,
                  const int* __restrict__ fills, __nv_bfloat16* __restrict__ lut,
                  int n_pairs, int P, int Dp, int M, int nlist) {
  static_assert(DSUB % 4 == 0, "residual slices are read as float4");
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * G + (threadIdx.x >> 5);
  if (m >= M) return;  // a whole warp; the warps of a CTA never meet at a barrier
  const int j0 = lane * CW;

  float cbr[CW][DSUB], c2[CW];
#pragma unroll
  for (int e = 0; e < CW; ++e) {
#pragma unroll
    for (int d = 0; d < DSUB; ++d) cbr[e][d] = cb[((size_t)m * 256 + j0 + e) * DSUB + d];
    c2[e] = nvdb::fma_chain<DSUB>(cbr[e], cbr[e]);
  }

  for (int base = blockIdx.y * T; base < n_pairs; base += gridDim.y * T) {
    // lane t stages pair base + t: its list and its residual slice of subspace m
    const int pair = base + lane;
    const int li = pair < n_pairs ? live_list(probes, fills, pair, nlist) : -1;
    float res[DSUB];
#pragma unroll
    for (int d = 0; d < DSUB; ++d) res[d] = 0.f;
    if (li >= 0) {
      const float4* qp =
          reinterpret_cast<const float4*>(q_rot + (size_t)(pair / P) * Dp + m * DSUB);
      const float4* cp = reinterpret_cast<const float4*>(cents + (size_t)li * Dp + m * DSUB);
#pragma unroll
      for (int d4 = 0; d4 < DSUB / 4; ++d4) {
        const float4 x = qp[d4], y = cp[d4];
        res[4 * d4] = __fsub_rn(x.x, y.x);
        res[4 * d4 + 1] = __fsub_rn(x.y, y.y);
        res[4 * d4 + 2] = __fsub_rn(x.z, y.z);
        res[4 * d4 + 3] = __fsub_rn(x.w, y.w);
      }
    }
    const int nt = min(T, n_pairs - base);
    for (int t = 0; t < nt; ++t) {
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (__shfl_sync(FULL_MASK, li, t) >= 0) {  // the same for the whole warp
        float r[DSUB];
#pragma unroll
        for (int d = 0; d < DSUB; ++d) r[d] = __shfl_sync(FULL_MASK, res[d], t);
        const float r2 = nvdb::fma_chain<DSUB>(r, r);
        float v[CW];
#pragma unroll
        for (int e = 0; e < CW; ++e)
          v[e] = nvdb::adc_entry(r2, nvdb::fma_chain<DSUB>(r, cbr[e]), c2[e]);
        out = make_uint4(nvdb::pack_bf16(v[0], v[1]), nvdb::pack_bf16(v[2], v[3]),
                         nvdb::pack_bf16(v[4], v[5]), nvdb::pack_bf16(v[6], v[7]));
      }
      *reinterpret_cast<uint4*>(lut + ((size_t)(base + t) * M + m) * 256 + j0) = out;
    }
  }
}

// Any dsub: one CTA per pair, thread j owns codeword j of every subspace;
// the residual sits in shared memory, the codebooks come through the cache.
__global__ void __launch_bounds__(NT)
adc_tables_any_kernel(const float* __restrict__ q_rot, const int* __restrict__ probes,
                      const float* __restrict__ cents, const float* __restrict__ cb,
                      const int* __restrict__ fills, __nv_bfloat16* __restrict__ lut,
                      int P, int Dp, int M, int dsub, int nlist) {
  extern __shared__ __align__(16) float res_any[];  // [M * dsub]
  const int pair = blockIdx.x, j = threadIdx.x;
  const int li = live_list(probes, fills, pair, nlist);
  __nv_bfloat16* out = lut + (size_t)pair * M * 256;
  if (li < 0) {
    for (int m = 0; m < M; ++m) out[m * 256 + j] = __float2bfloat16_rn(0.f);
    return;
  }
  const int b = pair / P;
  for (int c = j; c < M * dsub; c += NT)
    res_any[c] = __fsub_rn(q_rot[(size_t)b * Dp + c], cents[(size_t)li * Dp + c]);
  __syncthreads();
  for (int m = 0; m < M; ++m) {
    const float* r = res_any + m * dsub;
    const float* w = cb + ((size_t)m * 256 + j) * dsub;
    const float r2 = nvdb::fma_chain_n(r, r, dsub), c2 = nvdb::fma_chain_n(w, w, dsub);
    out[m * 256 + j] = __float2bfloat16_rn(nvdb::adc_entry(r2, nvdb::fma_chain_n(r, w, dsub), c2));
  }
}

template <int DSUB>
cudaError_t launch(const float* q, const int* pr, const float* ce, const float* cb,
                   const int* fi, __nv_bfloat16* lut, int n_pairs, int P, int Dp, int M,
                   int nlist, int ctas, cudaStream_t st) {
  const int gx = (M + G - 1) / G;
  const int rounds = (n_pairs + T - 1) / T;
  int gy = ctas / gx;
  gy = gy < 1 ? 1 : (gy > rounds ? rounds : gy);
  adc_tables_kernel<DSUB><<<dim3(gx, gy), NT, 0, st>>>(q, pr, ce, cb, fi, lut, n_pairs, P,
                                                        Dp, M, nlist);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). q_rot [B, Dp] f32, probes [B, P] int32,
// centroids [nlist, Dp] f32, codebooks [M, 256, dsub] f32 (M * dsub <= Dp),
// fills [nlist] int32; output lut [B, P, M, 256] bf16. `ctas`: the number of
// CTAs to aim for (a few per SM). Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int nvdb_adc_tables(const void* q_rot, const void* probes, const void* centroids,
                               const void* codebooks, const void* fills, void* lut, int B,
                               int P, int Dp, int M, int dsub, int nlist, int ctas,
                               void* stream) {
  if (B < 1 || P < 1 || M < 1 || dsub < 1 || nlist < 1 || ctas < 1 ||
      (long long)M * dsub > Dp || (long long)B * P > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(q_rot);
  const int* pr = static_cast<const int*>(probes);
  const float* ce = static_cast<const float*>(centroids);
  const float* cb = static_cast<const float*>(codebooks);
  const int* fi = static_cast<const int*>(fills);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(lut);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pairs = B * P;
  switch (dsub) {
    case 4:
      return (int)launch<4>(q, pr, ce, cb, fi, out, n_pairs, P, Dp, M, nlist, ctas, st);
    case 8:
      return (int)launch<8>(q, pr, ce, cb, fi, out, n_pairs, P, Dp, M, nlist, ctas, st);
    case 12:
      return (int)launch<12>(q, pr, ce, cb, fi, out, n_pairs, P, Dp, M, nlist, ctas, st);
    case 16:
      return (int)launch<16>(q, pr, ce, cb, fi, out, n_pairs, P, Dp, M, nlist, ctas, st);
    default:
      break;
  }
  const size_t smem = (size_t)M * dsub * 4;
  cudaError_t e = cudaFuncSetAttribute(adc_tables_any_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  adc_tables_any_kernel<<<n_pairs, NT, smem, st>>>(q, pr, ce, cb, fi, out, P, Dp, M, dsub,
                                                   nlist);
  return (int)cudaGetLastError();
}
