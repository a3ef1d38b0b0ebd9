// Pass 0 of the port's list-major kernels, shared by the IVF probe kernel
// (ivf_probe_topk.cu) and the fused ADC key scan (adc_topk.cu): one CTA
// groups a batch's (query, probe) pairs b * P + p by the list they probe and
// cuts each list's pairs into work items of at most nq pairs. Each library
// that includes this header holds its own instance; neither calls the other.
// The plain version is ivf_scan.group_pairs_reference.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nvdb {

constexpr int G_NT = 1024;          // threads of the grouping CTA
constexpr int G_BATCH = 8;          // pairs a grouping thread has in flight
constexpr int G_BUCKETS = 256;      // size classes of the items (a multiple of 32)
constexpr size_t G_SMEM_COUNTS_MAX = 160 * 1024;   // counts in shared memory up to this
constexpr int G_MAX_DEVICES = 64;   // launch_group's per-device cache

// Exclusive scan of v over the block's G_NT threads; the total in *total.
__device__ __forceinline__ int block_scan(int v, int* total, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int in = v;   // inclusive within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, in, o);
    if (lane >= o) in += x;
  }
  if (lane == 31) warp_sums[warp] = in;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];   // G_NT / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += x;
    }
    warp_sums[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  *total = warp_sums[31];
  return (warp > 0 ? warp_sums[warp - 1] : 0) + in - v;
}

__device__ __forceinline__ bool live_list(const int* fills, int l, int nlist, int Lcap) {
  return l >= 0 && l < nlist && min(fills[l], Lcap) > 0;
}

// Pass 0, one CTA of G_NT threads. counts_global [nlist] scratch (used
// unless counts_in_smem); order [BP] the
// valid pairs' indices b * P + p in list order (within a list in the order
// the atomics give); items [U] (list, first position in order, pairs, 0),
// at most nq pairs an item, the lists with the longest live prefix first
// (in G_BUCKETS classes of fill), so that pass 1's last CTAs are short
// ones; *n_items their number. Where part_vals is given, the R partial
// lists of each dropped pair are filled with (-inf, -1). A thread keeps
// G_BATCH pairs' loads and atomics in flight.
__global__ void __launch_bounds__(G_NT)
group_pairs_kernel(const int* __restrict__ probes, const int* __restrict__ fills,
                   int* __restrict__ counts_global, int* __restrict__ order,
                   int4* __restrict__ items, int* __restrict__ n_items,
                   float* __restrict__ part_vals, int* __restrict__ part_ids, int BP,
                   int nlist, int Lcap, int nq, int R, int k, int counts_in_smem) {
  __shared__ int warp_sums[32];
  __shared__ int bucket[G_BUCKETS];   // items of each size class, then their cursors
  // the counts, then the cursors: in shared memory where nlist allows
  // (atomics there cost no trip to L2), else in the scratch
  extern __shared__ int smem_counts[];
  int* counts = counts_in_smem ? smem_counts : counts_global;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int shift = 0;   // class of a list: its fill >> shift, longest first
  while (((Lcap - 1) >> shift) >= G_BUCKETS) ++shift;
  for (int l = tid; l < nlist; l += G_NT) counts[l] = 0;
  for (int c = tid; c < G_BUCKETS; c += G_NT) bucket[c] = 0;
  __syncthreads();
  for (int j0 = tid; j0 < BP; j0 += G_NT * G_BATCH) {
    int l[G_BATCH];
#pragma unroll
    for (int u = 0; u < G_BATCH; ++u) l[u] = j0 + u * G_NT < BP ? probes[j0 + u * G_NT] : -1;
#pragma unroll
    for (int u = 0; u < G_BATCH; ++u) {
      const int j = j0 + u * G_NT;
      if (j >= BP) continue;
      if (live_list(fills, l[u], nlist, Lcap)) {
        atomicAdd(&counts[l[u]], 1);
      } else if (part_vals != nullptr) {
        for (size_t o = (size_t)j * R * k; o < (size_t)(j + 1) * R * k; ++o) {
          part_vals[o] = -INFINITY;
          part_ids[o] = -1;
        }
      }
    }
  }
  __syncthreads();
  // each thread takes a contiguous run of lists: their pairs' offsets (a
  // scan) and their items' count in each size class
  const int per = (nlist + G_NT - 1) / G_NT;
  const int l0 = min(nlist, tid * per), l1 = min(nlist, l0 + per);
  auto size_class = [&](int l) {
    return G_BUCKETS - 1 - ((min(fills[l], Lcap) - 1) >> shift);
  };
  int off = 0;
  for (int l = l0; l < l1; ++l) {
    const int c = counts[l];
    off += c;
    if (c > 0) atomicAdd(&bucket[size_class(l)], (c + nq - 1) / nq);
  }
  int total = 0;
  off = block_scan(off, &total, warp_sums);   // its barriers also publish the classes' counts
  if (warp == 0) {
    constexpr int PER_LANE = G_BUCKETS / 32;
    int mine = 0;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) mine += bucket[lane * PER_LANE + i];
    int in = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, in, o);
      if (lane >= o) in += x;
    }
    int run = in - mine;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int c = bucket[lane * PER_LANE + i];
      bucket[lane * PER_LANE + i] = run;
      run += c;
    }
    if (lane == 31) *n_items = in;
  }
  __syncthreads();
  for (int l = l0; l < l1; ++l) {
    const int c = counts[l];
    counts[l] = off;   // from here on: the list's cursor into order
    if (c > 0) {
      int io = atomicAdd(&bucket[size_class(l)], (c + nq - 1) / nq);
      for (int s = 0; s < c; s += nq) items[io++] = make_int4(l, off + s, min(nq, c - s), 0);
    }
    off += c;
  }
  __syncthreads();
  for (int j0 = tid; j0 < BP; j0 += G_NT * G_BATCH) {
    int l[G_BATCH], pos[G_BATCH];
#pragma unroll
    for (int u = 0; u < G_BATCH; ++u) l[u] = j0 + u * G_NT < BP ? probes[j0 + u * G_NT] : -1;
#pragma unroll
    for (int u = 0; u < G_BATCH; ++u)
      pos[u] = live_list(fills, l[u], nlist, Lcap) ? atomicAdd(&counts[l[u]], 1) : -1;
#pragma unroll
    for (int u = 0; u < G_BATCH; ++u)
      if (pos[u] >= 0) order[pos[u]] = j0 + u * G_NT;
  }
}

// Pass 0 on `st`; part_vals null: the dropped pairs' partials are left alone.
inline cudaError_t launch_group(const int* probes, const int* fills, int* counts, int* order,
                                int4* items, int* n_items, float* pv, int* pi, int BP,
                                int nlist, int Lcap, int nq, int R, int k, cudaStream_t st) {
  const size_t bytes = (size_t)nlist * 4;
  const bool in_smem = bytes <= G_SMEM_COUNTS_MAX;
  const size_t dyn = in_smem ? bytes : 0;
  if (dyn > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    static size_t allowed[G_MAX_DEVICES] = {};
    if (dev >= G_MAX_DEVICES || dyn > allowed[dev]) {
      e = cudaFuncSetAttribute(group_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn);
      if (e != cudaSuccess) return e;
      if (dev < G_MAX_DEVICES) allowed[dev] = dyn;
    }
  }
  group_pairs_kernel<<<1, G_NT, dyn, st>>>(probes, fills, counts, order, items, n_items, pv, pi,
                                           BP, nlist, Lcap, nq, R, k, in_smem ? 1 : 0);
  return cudaGetLastError();
}

// The int32 scratch of a list-major entry: counts [nlist], order [B * P],
// n_items [1], then items [U] of 4 ints from a 16-byte boundary.
inline size_t items_offset(int nlist, int BP) { return ((size_t)nlist + BP + 1 + 3) / 4 * 4; }

}  // namespace nvdb
