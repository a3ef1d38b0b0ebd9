// The top-k order and the warp-cooperative sorted insert shared by the
// port's top-k kernels (flat_topk.cu, rerank_topk.cu, adc_topk.cu).
//
// One strict total order ranks every candidate: score descending, ties to
// the larger id. Empty slots hold (-inf, -1), which every real candidate
// beats. A sorted list of k entries lives in shared memory; a warp inserts
// into it only what beats the k-th entry, so a scan pays for its improvers,
// not for every row.

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

}  // namespace nvdb
