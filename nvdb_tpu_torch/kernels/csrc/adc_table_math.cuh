// The arithmetic of one bf16 ADC table entry, shared by the table kernel
// (adc_tables.cu) and the fused key scan (adc_topk.cu), so that the two
// give the same bits by construction:
//   entry = bf16_rn( (r2 - 2 dot) + c2 ),
//   res = q_rot - centroid (one rounded f32 subtraction a coordinate),
//   r2 = |res_m|^2, dot = res_m . cb[m, j], c2 = |cb[m, j]|^2,
// each a chain of f32 FMAs over d = 0, 1, ..., dsub - 1 from 0 (never
// TF32), the three terms combined in the order written, each step rounded.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace nvdb {

__device__ __forceinline__ float adc_entry(float r2, float dot, float c2) {
  return __fadd_rn(__fsub_rn(r2, __fmul_rn(2.0f, dot)), c2);
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
