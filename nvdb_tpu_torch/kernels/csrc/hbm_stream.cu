// Zero-compute HBM read streams for Hopper (sm_90a): the maximum of a bf16
// array, read once from device memory. They measure how fast this card can
// stream bytes, the ceiling that every bandwidth-bound kernel of the port
// (the IVF probe, the ADC) is held against.
//
// Replaces the Pallas TPU kernels of scripts/hbm_probe.py:
//   * stream_max_kernel carries the meaning of `kern` (:62) and `kern_p`
//     (:93): stream speed with zero compute. A grid-stride loop of 16-byte
//     loads, VPT independent loads in flight per thread, neighbouring
//     threads on neighbouring addresses.
//   * ring_max_kernel carries the meaning of `kern_m` (:116), the manual
//     4-deep DMA ring: does deeper buffering lift the rate? Each thread
//     keeps STAGES tiles of its 16-byte pieces in flight through a ring in
//     shared memory with cp.async (bypassing L1), waiting only for the
//     oldest. A thread reads back only the pieces it copied itself, so the
//     ring needs no block barrier.
// Both write one partial maximum per CTA; max_reduce_kernel folds them.
// The maximum is exact (no rounding), so it equals torch.amax of the same
// array; inputs are taken to hold no NaN (fmaxf drops NaN).
//
// What bounds them: HBM bandwidth only (3.35 TB/s nameplate on an H100
// SXM); the 8 comparisons per 16 bytes are free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                    // threads per CTA
constexpr int VPT = 4;                     // stream: pieces in flight per thread
constexpr int STAGES = 4;                  // ring: tiles in flight per CTA
constexpr int RING_VPT = 4;                // ring: pieces per thread per tile
constexpr int TILE_VECS = RING_VPT * NT;   // 16-byte pieces per ring tile (16 KB)

__device__ __forceinline__ float max_bf16x8(const uint4& w, float m) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    m = fmaxf(m, fmaxf(f.x, f.y));
  }
  return m;
}

// Block-wide maximum; the result is valid in thread 0.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float wm[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) wm[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < NT / 32 ? wm[threadIdx.x] : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

__global__ void __launch_bounds__(NT)
stream_max_kernel(const uint4* __restrict__ x, long long nvec, float* __restrict__ partial) {
  const long long stride = (long long)gridDim.x * NT;
  long long i = (long long)blockIdx.x * NT + threadIdx.x;
  float m = -INFINITY;
  for (; i + (VPT - 1) * stride < nvec; i += VPT * stride) {
    uint4 w[VPT];
#pragma unroll
    for (int u = 0; u < VPT; ++u) w[u] = __ldcs(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < VPT; ++u) m = max_bf16x8(w[u], m);
  }
  for (; i < nvec; i += stride) m = max_bf16x8(__ldcs(x + i), m);
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(NT)
ring_max_kernel(const uint4* __restrict__ x, long long nvec, float* __restrict__ partial) {
  extern __shared__ __align__(16) uint4 ring[];  // [STAGES][TILE_VECS]
  const int tid = threadIdx.x;
  const long long ntiles = nvec / TILE_VECS;
  const long long mine = blockIdx.x < ntiles
                             ? (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  // local tile j of this CTA is tile blockIdx.x + j * gridDim.x; it lands
  // in ring slot j % STAGES. Every call commits one group (empty past the
  // end), so "all but the newest STAGES - 1 groups" is always tile j.
  auto issue = [&](long long j) {
    if (j < mine) {
      const uint4* src = x + (blockIdx.x + j * gridDim.x) * TILE_VECS;
      uint4* dst = ring + (j % STAGES) * TILE_VECS;
#pragma unroll
      for (int u = 0; u < RING_VPT; ++u) cp_async16(dst + u * NT + tid, src + u * NT + tid);
    }
    cp_async_commit();
  };
  for (int j = 0; j < STAGES - 1; ++j) issue(j);
  float m = -INFINITY;
  for (long long j = 0; j < mine; ++j) {
    issue(j + STAGES - 1);  // into the slot this thread read last iteration
    cp_async_wait<STAGES - 1>();
    const uint4* src = ring + (j % STAGES) * TILE_VECS;
#pragma unroll
    for (int u = 0; u < RING_VPT; ++u) m = max_bf16x8(src[u * NT + tid], m);
  }
  cp_async_wait<0>();
  // the ragged tail past the last whole tile: ordinary loads
  for (long long i = ntiles * TILE_VECS + (long long)blockIdx.x * NT + tid; i < nvec;
       i += (long long)gridDim.x * NT)
    m = max_bf16x8(__ldcs(x + i), m);
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__global__ void __launch_bounds__(NT)
max_reduce_kernel(const float* __restrict__ partial, int n, float* __restrict__ out) {
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += NT) m = fmaxf(m, partial[i]);
  m = block_max(m);
  if (threadIdx.x == 0) out[0] = m;
}

}  // namespace

// C interface (loaded with ctypes). x: nvec 16-byte pieces (8 bf16 each),
// 16-byte aligned; partial: `blocks` floats of scratch; out: one float.
// ring != 0 takes the cp.async ring. Returns a cudaError_t (0 on success);
// the launches are asynchronous on `stream`.
extern "C" int nvdb_stream_max(const void* x, long long nvec, void* partial, void* out,
                               int blocks, int ring, void* stream) {
  if (nvec < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  float* part = static_cast<float*>(partial);
  cudaError_t e;
  if (ring) {
    const int smem = STAGES * TILE_VECS * 16;
    e = cudaFuncSetAttribute(ring_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    ring_max_kernel<<<blocks, NT, smem, st>>>(xv, nvec, part);
  } else {
    stream_max_kernel<<<blocks, NT, 0, st>>>(xv, nvec, part);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  max_reduce_kernel<<<1, NT, 0, st>>>(part, blocks, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
