// The top-k order, the warp-cooperative sorted insert and the merge pass
// shared by the port's k <= 128 top-k kernels (flat_topk.cu,
// rerank_topk.cu, ivf_probe_topk.cu).
//
// One strict total order ranks every candidate: score descending, ties to
// the larger id. Empty slots hold (-inf, -1), which every real candidate
// beats. A sorted list of k entries lives in shared memory; a warp inserts
// into it only what beats the k-th entry, so a scan pays for its improvers,
// not for every row. A scan split over S CTAs per query writes S sorted
// partial lists, which merge_kernel folds into one.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nvdb {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP_LIST_MAX_K = 128;  // longest list warp_insert keeps

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai > bi);
}

// One warp inserts (v, id) into the sorted (descending) list lv/li of length
// k <= WARP_LIST_MAX_K in shared memory. The caller guarantees (v, id) beats
// the last entry.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k, float v,
                                            int id, int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += better(lv[j], li[j], v, id) ? 1 : 0;
  const int pos = __reduce_add_sync(FULL_MASK, cnt);
  float tv[WARP_LIST_MAX_K / 32];
  int ti[WARP_LIST_MAX_K / 32];
#pragma unroll
  for (int r = 0; r < WARP_LIST_MAX_K / 32; ++r) {
    const int j = lane + 32 * r;
    if (j >= pos && j < k - 1) {
      tv[r] = lv[j];
      ti[r] = li[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < WARP_LIST_MAX_K / 32; ++r) {
    const int j = lane + 32 * r;
    if (j >= pos && j < k - 1) {
      lv[j + 1] = tv[r];
      li[j + 1] = ti[r];
    }
  }
  if (lane == 0) {
    lv[pos] = v;
    li[pos] = id;
  }
  __syncwarp();
}

// Offers each lane's candidate (s, id) where ok. Returns whether any lane's
// candidate beat the list's k-th entry when the call began.
__device__ __forceinline__ bool warp_offer(float* lv, int* li, int k, float s,
                                           int id, bool ok, int lane) {
  float thv = lv[k - 1];
  int thi = li[k - 1];
  unsigned m = __ballot_sync(FULL_MASK, ok && better(s, id, thv, thi));
  const bool any = m != 0;
  while (m) {
    const int src = __ffs(m) - 1;
    const float v = __shfl_sync(FULL_MASK, s, src);
    const int vid = __shfl_sync(FULL_MASK, id, src);
    warp_insert(lv, li, k, v, vid, lane);
    thv = lv[k - 1];
    thi = li[k - 1];
    m &= m - 1;
    m &= __ballot_sync(FULL_MASK, ok && better(s, id, thv, thi));
  }
  return any;
}

constexpr int MERGE_WARPS = 4;  // queries per merge CTA, one warp each

// Pass 2 of a split top-k: one warp per query folds the S sorted partial
// lists part_*[b, s, 0:k] into the final sorted list out_*[b, 0:k].
__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_kernel(const float* __restrict__ part_vals, const int* __restrict__ part_ids,
             float* __restrict__ out_vals, int* __restrict__ out_ids, int B, int S,
             int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * MERGE_WARPS + warp;
  if (b >= B) return;  // whole warp; no block-wide barrier follows
  float* lv = reinterpret_cast<float*>(smem) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + MERGE_WARPS * k) + warp * k;
  for (int j = lane; j < k; j += 32) {
    lv[j] = -INFINITY;
    li[j] = -1;
  }
  __syncwarp();
  for (int s = 0; s < S; ++s) {
    const size_t base = ((size_t)b * S + s) * k;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < k;
      const float v = ok ? part_vals[base + j] : -INFINITY;
      const int id = ok ? part_ids[base + j] : -1;
      // each partial list is sorted: once a chunk has no improver, none follow
      if (!warp_offer(lv, li, k, v, id, ok, lane)) break;
    }
  }
  for (int j = lane; j < k; j += 32) {
    out_vals[(size_t)b * k + j] = lv[j];
    out_ids[(size_t)b * k + j] = li[j];
  }
}

inline cudaError_t launch_merge(const float* part_vals, const int* part_ids,
                                float* out_vals, int* out_ids, int B, int S, int k,
                                cudaStream_t stream) {
  const size_t smem = (size_t)MERGE_WARPS * k * 8;
  merge_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, smem, stream>>>(
      part_vals, part_ids, out_vals, out_ids, B, S, k);
  return cudaGetLastError();
}

}  // namespace nvdb
