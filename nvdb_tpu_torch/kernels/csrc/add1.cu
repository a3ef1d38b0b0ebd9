// The GPU hello-world for Hopper (sm_90a): y = x + 1 over a float32
// array, the round trip that shows a kernel builds, launches and returns
// what it should.
//
// Replaces the Pallas TPU kernel nvdb_tpu/tools/tpu_sanity.py:add1 (:28),
// the nvdb_cuda_sanity analogue. One thread per element; bound by nothing
// at its [8, 128] size but the launch itself.

#include <cuda_runtime.h>

namespace {

__global__ void add1_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

}  // namespace

// C interface (loaded with ctypes): y[0, n) = x[0, n) + 1. Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int nvdb_add1(const void* x, void* y, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int nt = 256;
  add1_kernel<<<(n + nt - 1) / nt, nt, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}
