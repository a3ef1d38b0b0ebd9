// IVF-PQ ADC lookup tables for Hopper (sm_90a): for every (query, probe)
// pair, the squared distance of the query's rotated residual against each
// of the 256 codewords of each of the M subspaces, rounded once to bf16:
//   lut[b, p, m, j] = bf16( (r2 + 2 ldot) + qterm ),  qterm = c2 - 2 qdot,
//   q = q_rot[b], c = centroids[probes[b, p]], res = q - c (one rounded f32
//   subtraction), r2 = |res_m|^2, ldot = c_m . cb[m, j], qdot = q_m . cb[m, j],
//   c2 = |cb[m, j]|^2,
// all in f32 with FMA (never TF32), combined in the order written, each step
// rounded (adc_table_math.cuh, which the fused scans and the query-term pass
// of adc_topk.cu share, so they give the same bits). In exact arithmetic that
// is ||res_m - cb[m, j]||^2, nvdb_tpu/kernels/pq.py:89 adc_lut followed by the
// bf16 cast of nvdb_tpu/index/ivf_pq.py:73; the JAX package leaves both to
// XLA, so this kernel replaces no Pallas kernel. It replaces the port's
// plain route (pq.adc_lut, then .to(bfloat16)), which wrote a [B, P, M, 256]
// f32 tensor through several temporaries, read it back and wrote the bf16
// copy. Its plain version, adc_scan.adc_tables_reference, runs the same FMA
// chains and combinations, so the two agree bit for bit; against the
// library's product of the residuals a rare entry lands on the neighbouring
// bf16 value.
//
// It is the A/B of the fused scans, on no default path. It reads each
// entry's query share from the query-term pass (adc_topk.cu's
// adc_qterms_kernel, [B, M, 256] f32, which its wrapper launches first, as
// the fused scans' wrappers do) and computes the list's share itself, one
// dsub-long chain an entry.
//
// A probe of a list that is out of range or holds no live slot gets zeros:
// the scan reads nothing of it.
//
// What bounds it on an H100: bytes written. B = 256, P = 64, M = 96 is
// 0.805 GB of bf16 tables (0.24 ms at 3.35 TB/s) against 6.4 GFLOP of f32
// FMA (0.10 ms at 67 TFLOP/s) and a few MB read (a query's terms once for
// its P pairs).
//
// Design. The codebooks (M x 256 x dsub f32, 786 KB at M = 96, dsub = 8)
// fit no CTA's shared memory, and a CTA that built whole tables would pull
// them through L2 once per pair. So a CTA owns 8 subspaces and walks many
// (b, p) pairs: thread (m, lane) keeps its 8 codewords of subspace m in
// registers for the whole walk (8 x dsub floats). A warp works alone, with
// no shared memory and no barrier: 32 pairs at a time, lane t loads pair
// t's query and centroid slices of subspace m (the only slices the warp
// needs) into registers and computes the pair's r2, and the warp then takes
// the pairs in turn, broadcasting each pair's centroid slice and r2 by
// shuffle; a thread reloads its 8 query terms only where the pair's query
// changes (P pairs a query, in order). Each thread writes its 8 entries as
// one 16-byte store, the 32 lanes of a warp covering one subspace's 512
// contiguous bytes.
// Register-resident instances exist for dsub 4, 8, 12 and 16; any other
// dsub takes a plain kernel (one CTA per pair, codebooks through the cache).

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
adc_tables_kernel(const float* __restrict__ q_rot, const float* __restrict__ qterms,
                  const int* __restrict__ probes, const float* __restrict__ cents,
                  const float* __restrict__ cb, const int* __restrict__ fills,
                  __nv_bfloat16* __restrict__ lut,
                  int n_pairs, int P, int Dp, int M, int nlist) {
  static_assert(DSUB % 4 == 0, "residual slices are read as float4");
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * G + (threadIdx.x >> 5);
  if (m >= M) return;  // a whole warp; the warps of a CTA never meet at a barrier
  const int j0 = lane * CW;

  float cbr[CW][DSUB];
#pragma unroll
  for (int e = 0; e < CW; ++e)
#pragma unroll
    for (int d = 0; d < DSUB; ++d) cbr[e][d] = cb[((size_t)m * 256 + j0 + e) * DSUB + d];
  // the query terms of codewords j0 .. j0 + 7 of the query of the pair last
  // loaded for, and the first pair past that query
  float qt[CW];
  int qt_end = 0;
  auto load_qt = [&](int pair) {
    const int b = pair / P;
    const float4* src = reinterpret_cast<const float4*>(qterms + ((size_t)b * M + m) * 256 + j0);
    const float4 x = src[0], y = src[1];
    qt[0] = x.x;
    qt[1] = x.y;
    qt[2] = x.z;
    qt[3] = x.w;
    qt[4] = y.x;
    qt[5] = y.y;
    qt[6] = y.z;
    qt[7] = y.w;
    qt_end = (b + 1) * P;
  };

  for (int base = blockIdx.y * T; base < n_pairs; base += gridDim.y * T) {
    // the query terms of the round's first pair, loaded beside the slices
    if (base >= qt_end) load_qt(base);
    // lane t stages pair base + t: its list, its query and centroid slices of
    // subspace m and their residual's squared norm
    const int pair = base + lane;
    const int li = pair < n_pairs ? live_list(probes, fills, pair, nlist) : -1;
    float qs[DSUB], cs[DSUB];
#pragma unroll
    for (int d = 0; d < DSUB; ++d) qs[d] = cs[d] = 0.f;
    if (li >= 0) {
      const float4* qp =
          reinterpret_cast<const float4*>(q_rot + (size_t)(pair / P) * Dp + m * DSUB);
      const float4* cp = reinterpret_cast<const float4*>(cents + (size_t)li * Dp + m * DSUB);
#pragma unroll
      for (int d4 = 0; d4 < DSUB / 4; ++d4) {
        const float4 x = qp[d4], y = cp[d4];
        qs[4 * d4] = x.x;
        qs[4 * d4 + 1] = x.y;
        qs[4 * d4 + 2] = x.z;
        qs[4 * d4 + 3] = x.w;
        cs[4 * d4] = y.x;
        cs[4 * d4 + 1] = y.y;
        cs[4 * d4 + 2] = y.z;
        cs[4 * d4 + 3] = y.w;
      }
    }
    const float r2_lane = nvdb::residual_norm2<DSUB>(qs, cs);
    const int nt = min(T, n_pairs - base);
    for (int t = 0; t < nt; ++t) {
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (__shfl_sync(FULL_MASK, li, t) >= 0) {  // the same for the whole warp
        if (base + t >= qt_end) load_qt(base + t);
        float c[DSUB];
#pragma unroll
        for (int d = 0; d < DSUB; ++d) c[d] = __shfl_sync(FULL_MASK, cs[d], t);
        const float r2 = __shfl_sync(FULL_MASK, r2_lane, t);
        float v[CW];
#pragma unroll
        for (int e = 0; e < CW; ++e)
          v[e] = nvdb::adc_entry(r2, nvdb::fma_chain<DSUB>(c, cbr[e]), qt[e]);
        out = make_uint4(nvdb::pack_bf16(v[0], v[1]), nvdb::pack_bf16(v[2], v[3]),
                         nvdb::pack_bf16(v[4], v[5]), nvdb::pack_bf16(v[6], v[7]));
      }
      *reinterpret_cast<uint4*>(lut + ((size_t)(base + t) * M + m) * 256 + j0) = out;
    }
  }
}

// Any dsub: one CTA per pair, thread j owns codeword j of every subspace;
// the query and centroid slices (the same address in every thread), the
// query terms and the codebooks come through the cache.
__global__ void __launch_bounds__(NT)
adc_tables_any_kernel(const float* __restrict__ q_rot, const float* __restrict__ qterms,
                      const int* __restrict__ probes,
                      const float* __restrict__ cents, const float* __restrict__ cb,
                      const int* __restrict__ fills, __nv_bfloat16* __restrict__ lut,
                      int P, int Dp, int M, int dsub, int nlist) {
  const int pair = blockIdx.x, j = threadIdx.x;
  const int li = live_list(probes, fills, pair, nlist);
  __nv_bfloat16* out = lut + (size_t)pair * M * 256;
  if (li < 0) {
    for (int m = 0; m < M; ++m) out[m * 256 + j] = __float2bfloat16_rn(0.f);
    return;
  }
  const float* qb = q_rot + (size_t)(pair / P) * Dp;
  const float* qtb = qterms + (size_t)(pair / P) * M * 256;
  const float* cl = cents + (size_t)li * Dp;
  for (int m = 0; m < M; ++m) {
    const float* q = qb + m * dsub;
    const float* c = cl + m * dsub;
    const float* w = cb + ((size_t)m * 256 + j) * dsub;
    out[m * 256 + j] = __float2bfloat16_rn(nvdb::adc_entry(
        nvdb::residual_norm2_n(q, c, dsub), nvdb::fma_chain_n(c, w, dsub), qtb[m * 256 + j]));
  }
}

template <int DSUB>
cudaError_t launch(const float* q, const float* qt, const int* pr, const float* ce,
                   const float* cb, const int* fi, __nv_bfloat16* lut, int n_pairs, int P,
                   int Dp, int M, int nlist, int ctas, cudaStream_t st) {
  const int gx = (M + G - 1) / G;
  const int rounds = (n_pairs + T - 1) / T;
  int gy = ctas / gx;
  gy = gy < 1 ? 1 : (gy > rounds ? rounds : gy);
  adc_tables_kernel<DSUB><<<dim3(gx, gy), NT, 0, st>>>(q, qt, pr, ce, cb, fi, lut, n_pairs,
                                                        P, Dp, M, nlist);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). q_rot [B, Dp] f32, qterms [B, M, 256]
// f32 (the query-term pass's), probes [B, P] int32, centroids [nlist, Dp]
// f32, codebooks [M, 256, dsub] f32 (M * dsub <= Dp), fills [nlist] int32;
// output lut [B, P, M, 256] bf16. `ctas`: the number of
// CTAs to aim for (a few per SM). Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int nvdb_adc_tables(const void* q_rot, const void* qterms, const void* probes,
                               const void* centroids, const void* codebooks, const void* fills,
                               void* lut, int B, int P, int Dp, int M, int dsub, int nlist,
                               int ctas, void* stream) {
  if (B < 1 || P < 1 || M < 1 || dsub < 1 || nlist < 1 || ctas < 1 ||
      (long long)M * dsub > Dp || (long long)B * P > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(q_rot);
  const float* qt = static_cast<const float*>(qterms);
  const int* pr = static_cast<const int*>(probes);
  const float* ce = static_cast<const float*>(centroids);
  const float* cb = static_cast<const float*>(codebooks);
  const int* fi = static_cast<const int*>(fills);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(lut);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pairs = B * P;
  switch (dsub) {
    case 4:
      return (int)launch<4>(q, qt, pr, ce, cb, fi, out, n_pairs, P, Dp, M, nlist, ctas,
                                  st);
    case 8:
      return (int)launch<8>(q, qt, pr, ce, cb, fi, out, n_pairs, P, Dp, M, nlist, ctas,
                                  st);
    case 12:
      return (int)launch<12>(q, qt, pr, ce, cb, fi, out, n_pairs, P, Dp, M, nlist, ctas,
                                  st);
    case 16:
      return (int)launch<16>(q, qt, pr, ce, cb, fi, out, n_pairs, P, Dp, M, nlist, ctas,
                                  st);
    default:
      break;
  }
  adc_tables_any_kernel<<<n_pairs, NT, 0, st>>>(q, qt, pr, ce, cb, fi, out, P, Dp, M, dsub,
                                                 nlist);
  return (int)cudaGetLastError();
}
