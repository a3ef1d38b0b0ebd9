// The arithmetic of one bf16 ADC table entry, shared by the table kernel
// (adc_tables.cu), the query-term pass and the fused scans (adc_topk.cu), so
// that they give the same bits by construction. For L2 with residuals,
// ||res_m - cb_j||^2 = r2 - 2 (q_m . cb_j - c_m . cb_j) + c2, so an entry is
// built from three shares, each computed once where it varies:
//   qterm = c2 - 2 qdot       (the query's share: once a query, subspace and
//                              codeword; qdot = q_m . cb[m, j], c2 = |cb[m, j]|^2)
//   entry = bf16_rn( (r2 + 2 ldot) + qterm )
//                             (the list's share ldot = c_m . cb[m, j], once a
//                              list and subspace; r2 = |res_m|^2, once a pair)
// with q = q_rot[b], c = centroids[list], res = q - c (one rounded f32
// subtraction a coordinate). Each dot and squared norm is a chain of f32 FMAs
// over d = 0, 1, ..., dsub - 1 from 0 (never TF32); each combination is one
// FMA or one add, rounded once, in the order written (x - 2 y and x + 2 y
// round once: 2 y is exact). A pair's entry then costs a read of its query
// share, one FMA and one add, where it cost a dsub-long chain.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace nvdb {

// The query's share of an entry: c2 - 2 qdot, rounded once.
__device__ __forceinline__ float adc_qterm(float qdot, float c2) {
  return fmaf(-2.0f, qdot, c2);
}

// An entry before its bf16 rounding: (r2 + 2 ldot) + qterm, each step rounded.
__device__ __forceinline__ float adc_entry(float r2, float ldot, float qterm) {
  return __fadd_rn(fmaf(2.0f, ldot, r2), qterm);
}

// sum_d a[d] * b[d] as one FMA chain from 0, d in order (r2 and c2 with a == b)
template <int DSUB>
__device__ __forceinline__ float fma_chain(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DSUB; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// The same chain at a dsub known only at run time.
__device__ __forceinline__ float fma_chain_n(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// r2 = |q - c|^2 over DSUB coordinates: each residual coordinate one
// rounded subtraction, then the FMA chain of their squares.
template <int DSUB>
__device__ __forceinline__ float residual_norm2(const float* q, const float* c) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DSUB; ++d) {
    const float r = __fsub_rn(q[d], c[d]);
    s = fmaf(r, r, s);
  }
  return s;
}

// The same at a dsub known only at run time.
__device__ __forceinline__ float residual_norm2_n(const float* q, const float* c, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) {
    const float r = __fsub_rn(q[d], c[d]);
    s = fmaf(r, r, s);
  }
  return s;
}

// An f32 value rounded to bf16 (nearest even), as its 16 bits.
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Two f32 values rounded to bf16 (nearest even), the first at the lower address.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace nvdb
