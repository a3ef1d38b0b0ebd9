// IVF-PQ ADC candidate top-k for Hopper (sm_90a): for each query, scores
// every live slot of its probed inverted lists by asymmetric distance and
// returns the kk best (score, id), kk <= 1024.
//
// Replaces the Pallas TPU kernel nvdb_tpu/kernels/adc_scan.py:pallas_adc_topk
// in ids_mode="dma" (body _make_kernel :84-172, merge _fold_into_slots
// :175-235). Same contract:
//   * slot l of probed list p = probes[b, p] scores
//       -sum_m bf16(LUT[b, p, m, codes[list, m, l]]),
//     the table entries rounded to bf16 (the wrapper rounds the table),
//     summed in f32 over m = 0, 1, ... in order; slots with
//     slot_ids[list, l] < 0 never score, and lanes at or past fills[list]
//     (1 + the last live slot) are not read;
//   * a duplicate id keeps its best score and takes one slot (replicated
//     indexes hold a row in several lists);
//   * output sorted by score descending, ties to the larger id; slots no
//     candidate fills hold (-inf, -1).
// The TPU kernel builds a nibble one-hot and multiplies it on the MXU
// because a TPU has no fast gather (adc_scan.py:12-18). Here the lookup is
// what it is: the probe's table sits in shared memory (M x 256 bf16, 48 KB
// at M = 96) and each thread looks its slot's M code bytes up in it.
//
// What bounds it on an H100: bytes. A 256-query batch at nprobe 64, M 96,
// Lcap 640 reads 1.0 GB of codes and 0.8 GB of bf16 tables, ~0.55 ms at
// 3.35 TB/s before dead lanes are skipped; the lookups themselves are
// 1.0 G shared-memory reads, which at ~32 per SM per clock take a similar
// time, so this kernel is bandwidth- and lookup-bound, not compute-bound.
//
// Design.
//   Order keys. A candidate is one 64-bit key, (monotone bits of the score)
//   << 32 | (id + 2^31), so the top-k order (score desc, id desc) is the
//   unsigned key order and 0 is "empty". Rotating a key by 32 bits gives
//   the (id, score) order that groups an id's copies together.
//   Compaction. Candidates that beat the current kk-th key are appended to
//   a buffer of CAP keys in shared memory. When the next batch might not
//   fit, the block compacts it: a bitonic sort by the rotated key puts each
//   id's copies side by side, all but the best copy are dropped, a bitonic
//   sort by the key ranks the survivors, and the best kk stay, the kk-th
//   becoming the new threshold. So steady-state probes only append their
//   few improvers, and the result is sorted for every kk.
//   Pass 1 (adc_partial_kernel): grid = B queries x S probe groups; each
//   CTA scores its probes one after the other and writes its sorted,
//   duplicate-free top-kk keys. The wrapper picks S so there are about two
//   CTAs per SM at any batch.
//   Pass 2 (adc_merge_kernel): one CTA per query folds the S partial lists
//   with the same append-and-compact, which also removes duplicates found
//   by different CTAs, and writes (score, id).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per CTA, both passes
constexpr int MAX_KK = 1024;
constexpr int MAX_CAP = 8192;
static_assert(MAX_CAP / NT <= 32, "compact() keeps one drop bit per element a thread owns");

__device__ __forceinline__ unsigned long long make_key(float s, int id) {
  s = s + 0.0f;  // -0 -> +0: equal scores get equal keys
  const unsigned b = __float_as_uint(s);
  const unsigned m = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)m << 32) | (unsigned)(id ^ 0x80000000);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned m = (unsigned)(key >> 32);
  return __uint_as_float((m & 0x80000000u) ? (m ^ 0x80000000u) : ~m);
}

__device__ __forceinline__ int key_id(unsigned long long key) {
  return (int)((unsigned)key ^ 0x80000000u);
}

__device__ __forceinline__ unsigned long long rot32(unsigned long long x) {
  return (x << 32) | (x >> 32);
}

// Ascending bitonic sort of a[0, cap) (cap a power of two), by the key or
// by the key rotated 32 bits. Whole block; ends synchronised.
template <bool ROT>
__device__ void block_sort(unsigned long long* a, int cap) {
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < cap / 2; i += NT) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long x = a[lo], y = a[hi];
        const unsigned long long kx = ROT ? rot32(x) : x;
        const unsigned long long ky = ROT ? rot32(y) : y;
        const bool up = (lo & size) == 0;
        if ((kx > ky) == up) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The running top-kk of one query in shared memory: buf[0, *n) holds the
// appended keys, *theta the key a candidate must beat.
struct TopK {
  unsigned long long* buf;
  int* n;
  unsigned long long* theta;
  int cap;
  int kk;

  __device__ void append(unsigned long long key) {
    if (key > *theta) buf[atomicAdd(n, 1)] = key;
  }

  // Keeps the best kk distinct ids in buf[0, kk), sorted descending, and
  // resets *theta. Whole block; must be entered synchronised.
  __device__ void compact() {
    const int n0 = *n;
    for (int i = n0 + threadIdx.x; i < cap; i += NT) buf[i] = 0ull;
    __syncthreads();
    block_sort<true>(buf, cap);  // by (id, score): copies of an id adjacent
    unsigned drop = 0;           // bit j: element threadIdx.x + j * NT
    for (int j = 0, i = threadIdx.x; i < cap - 1; ++j, i += NT) {
      const unsigned long long x = buf[i], y = buf[i + 1];
      if (x != 0ull && y != 0ull && (unsigned)x == (unsigned)y) drop |= 1u << j;
    }
    __syncthreads();
    for (int j = 0, i = threadIdx.x; i < cap - 1; ++j, i += NT)
      if (drop & (1u << j)) buf[i] = 0ull;  // a better copy follows it
    __syncthreads();
    block_sort<false>(buf, cap);  // ascending: the best at the end
    unsigned long long top[MAX_KK / NT];
#pragma unroll
    for (int r = 0; r < MAX_KK / NT; ++r) {
      const int j = threadIdx.x + r * NT;
      top[r] = j < kk ? buf[cap - 1 - j] : 0ull;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_KK / NT; ++r) {
      const int j = threadIdx.x + r * NT;
      if (j < kk) buf[j] = top[r];
    }
    __syncthreads();
    // buf[0, kk) is descending with the empty keys last: the thread at the
    // last non-empty key sets the count and the threshold
    for (int j = threadIdx.x; j < kk; j += NT) {
      if (buf[j] != 0ull && (j + 1 == kk || buf[j + 1] == 0ull)) {
        *n = j + 1;
        *theta = j + 1 == kk ? buf[j] : 0ull;
      }
    }
    if (threadIdx.x == 0 && buf[0] == 0ull) {
      *n = 0;
      *theta = 0ull;
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(NT)
adc_partial_kernel(const __nv_bfloat16* __restrict__ lut, const int* __restrict__ probes,
                   const uint8_t* __restrict__ codes, const int* __restrict__ slot_ids,
                   const int* __restrict__ fills,
                   unsigned long long* __restrict__ part_keys, int P, int M, int Lcap,
                   int nlist, int kk, int S, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  __nv_bfloat16* lut_s = reinterpret_cast<__nv_bfloat16*>(buf + cap);  // [M][256]
  __shared__ int n_sh;
  __shared__ unsigned long long theta_sh;
  __shared__ int list_sh, fill_sh;

  const int b = blockIdx.x, s = blockIdx.y;
  const int per = (P + S - 1) / S;
  const int p0 = s * per, p1 = min(P, p0 + per);
  if (threadIdx.x == 0) {
    n_sh = 0;
    theta_sh = 0ull;
  }
  __syncthreads();
  TopK top{buf, &n_sh, &theta_sh, cap, kk};
  const int lut_vecs = M * 256 * 2 / 16;  // 16-byte pieces of one probe's table

  for (int p = p0; p < p1; ++p) {
    if (threadIdx.x == 0) {
      const int li = probes[(size_t)b * P + p];
      const bool ok = li >= 0 && li < nlist;
      list_sh = ok ? li : -1;
      fill_sh = ok ? min(fills[li], Lcap) : 0;
    }
    __syncthreads();
    const int li = list_sh, fill = fill_sh;
    if (fill == 0) {
      __syncthreads();  // list_sh is rewritten next probe
      continue;
    }
    if (n_sh + fill > cap) top.compact();
    const uint4* src = reinterpret_cast<const uint4*>(lut + ((size_t)b * P + p) * M * 256);
    for (int i = threadIdx.x; i < lut_vecs; i += NT)
      reinterpret_cast<uint4*>(lut_s)[i] = src[i];
    __syncthreads();
    const uint8_t* cl = codes + (size_t)li * M * Lcap;
    const int* sl = slot_ids + (size_t)li * Lcap;
    for (int l = threadIdx.x; l < fill; l += NT) {
      const int id = sl[l];
      if (id < 0) continue;
      float acc = 0.f;
      for (int m = 0; m < M; ++m)
        acc += __bfloat162float(lut_s[m * 256 + cl[(size_t)m * Lcap + l]]);
      top.append(make_key(-acc, id));
    }
    __syncthreads();  // lut_s and the buffer are reused by the next probe
  }
  top.compact();
  unsigned long long* out = part_keys + ((size_t)b * S + s) * kk;
  for (int j = threadIdx.x; j < kk; j += NT) out[j] = buf[j];
}

__global__ void __launch_bounds__(NT)
adc_merge_kernel(const unsigned long long* __restrict__ part_keys,
                 float* __restrict__ out_vals, int* __restrict__ out_ids, int kk, int S,
                 int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  __shared__ int n_sh;
  __shared__ unsigned long long theta_sh;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    n_sh = 0;
    theta_sh = 0ull;
  }
  __syncthreads();
  TopK top{buf, &n_sh, &theta_sh, cap, kk};
  for (int s = 0; s < S; ++s) {
    if (n_sh + kk > cap) top.compact();
    const unsigned long long* src = part_keys + ((size_t)b * S + s) * kk;
    for (int j = threadIdx.x; j < kk; j += NT) {
      const unsigned long long key = src[j];
      if (key != 0ull) top.append(key);
    }
    __syncthreads();
  }
  top.compact();
  for (int j = threadIdx.x; j < kk; j += NT) {
    const unsigned long long key = buf[j];
    out_vals[(size_t)b * kk + j] = key ? key_score(key) : -INFINITY;
    out_ids[(size_t)b * kk + j] = key ? key_id(key) : -1;
  }
}

int pow2_at_least(int x) {
  int c = 1;
  while (c < x) c <<= 1;
  return c;
}

}  // namespace

// C interface (loaded with ctypes). lut [B, P, M, 256] bf16, probes [B, P]
// int32, codes [nlist, M, Lcap] uint8, slot_ids [nlist, Lcap] int32, fills
// [nlist] int32; scratch part_keys [B, S, kk] uint64; outputs [B, kk].
// Returns a cudaError_t (0 on success); launches are asynchronous on
// `stream`.
extern "C" int nvdb_adc_topk(const void* lut, const void* probes, const void* codes,
                             const void* slot_ids, const void* fills, void* part_keys,
                             void* out_vals, void* out_ids, int B, int P, int M, int Lcap,
                             int nlist, int kk, int S, void* stream) {
  if (B < 1 || P < 1 || M < 1 || Lcap < 1 || nlist < 1 || kk < 1 || kk > MAX_KK ||
      S < 1 || S > P)
    return (int)cudaErrorInvalidValue;
  // buffer lengths (keys): room for kk kept keys plus one batch
  const int cap1 = pow2_at_least(kk + (Lcap > kk ? Lcap : kk));
  const int cap2 = pow2_at_least(2 * kk);
  if (cap1 > MAX_CAP) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = (size_t)cap1 * 8 + (size_t)M * 256 * 2;
  cudaError_t e = cudaFuncSetAttribute(adc_partial_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem1);
  if (e != cudaSuccess) return (int)e;
  auto* pk = static_cast<unsigned long long*>(part_keys);
  adc_partial_kernel<<<dim3(B, S), NT, smem1, st>>>(
      static_cast<const __nv_bfloat16*>(lut), static_cast<const int*>(probes),
      static_cast<const uint8_t*>(codes), static_cast<const int*>(slot_ids),
      static_cast<const int*>(fills), pk, P, M, Lcap, nlist, kk, S, cap1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem2 = (size_t)cap2 * 8;
  e = cudaFuncSetAttribute(adc_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem2);
  if (e != cudaSuccess) return (int)e;
  adc_merge_kernel<<<B, NT, smem2, st>>>(pk, static_cast<float*>(out_vals),
                                         static_cast<int*>(out_ids), kk, S, cap2);
  return (int)cudaGetLastError();
}
