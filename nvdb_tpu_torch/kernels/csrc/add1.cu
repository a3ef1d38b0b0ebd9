// The GPU hello-world for Hopper (sm_90a): y = x + 1 over a float32
// array, the round trip that shows a kernel builds, launches and returns
// what it should.
//
// Replaces the Pallas TPU kernel nvdb_tpu/tools/tpu_sanity.py:add1 (:28),
// the nvdb_cuda_sanity analogue. Bound by nothing at its [8, 128] size but
// the launch itself, so the launch is as small as it can be: one CTA of 256
// threads for n <= 4096, each thread a 16-byte load and store per four
// elements and a scalar tail for n % 4 (the wrapper picks the grid,
// add1.launch_blocks). Larger arrays take a grid-stride loop over as many
// CTAs as the wrapper asks for.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

// Indices are 32-bit unsigned: n < 2^31, so i + step cannot wrap.
__global__ void __launch_bounds__(NT)
add1_kernel(const float* __restrict__ x, float* __restrict__ y, unsigned n) {
  const unsigned n4 = n >> 2, step = gridDim.x * NT;
  const unsigned first = blockIdx.x * NT + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (unsigned i = first; i < n4; i += step) {
    const float4 v = x4[i];
    y4[i] = make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
  }
  for (unsigned i = 4 * n4 + first; i < n; i += step) y[i] = x[i] + 1.0f;
}

}  // namespace

// C interface (loaded with ctypes): y[0, n) = x[0, n) + 1 on `blocks` CTAs
// of 256 threads; x and y start on 16-byte boundaries. Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int nvdb_add1(const void* x, void* y, int n, int blocks, void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  add1_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), (unsigned)n);
  return (int)cudaGetLastError();
}
