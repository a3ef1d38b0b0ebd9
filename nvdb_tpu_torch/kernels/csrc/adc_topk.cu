// IVF-PQ ADC candidate top-k for Hopper (sm_90a): for each query, scores
// every live slot of its probed inverted lists by asymmetric distance and
// returns the kk best (score, id), kk <= 1024. Three id modes, as in the TPU
// kernel they replace, nvdb_tpu/kernels/adc_scan.py:pallas_adc_topk:
//
//   * "dma" (nvdb_adc_topk; the TPU body _make_kernel :84-172, merge
//     _fold_into_slots :175-235). Slot l of probed list p = probes[b, p]
//     scores -sum_m bf16(LUT[b, p, m, codes[list, m, l]]), the table
//     entries in bf16 (csrc/adc_tables.cu writes them so; the wrapper rounds
//     an f32 table), summed in f32 over m = 0, 1, ... in order; slots with
//     slot_ids[list, l] < 0 never score, and lanes at or past fills[list]
//     (1 + the last live slot) are not read; a duplicate id keeps its best
//     score and takes one slot (replicated indexes hold a row in several
//     lists); output sorted by score descending, ties to the larger id;
//     slots no candidate fills hold (-inf, -1).
//   * "key" (nvdb_adc_topk_keys, gathered = 0; the TPU body
//     _make_kernel_keys :310-444, fold _fold_keys_scr :265-307, _enc/_dec
//     :245-262, id remap :723-736). The same sums on a prefix-packed index
//     with unique ids (replicas == 1): lanes below fills[list] are live and
//     no slot id is read while scanning. Each score is truncated to bf16
//     (the low 16 bits of its f32 pattern cleared, toward zero), and the
//     candidates rank by (truncated score desc, coordinate desc), the
//     coordinate being p * Lcap + lane. The kk winners are remapped to row
//     ids through slot_ids[probes[b, p], lane] and returned beside their
//     truncated scores.
//   * "gather" (nvdb_adc_topk_keys, gathered = 1; the TPU body
//     _make_kernel_gather :447-526, the XLA gather :699). The key mode over
//     a slab [B * P, M, Lcap] of the probed lists' codes that the caller
//     gathered: step (b, p) reads slab row b * P + p instead of list
//     probes[b, p]. Bit for bit the key mode's result.
// The TPU kernel builds a nibble one-hot and multiplies it on the MXU
// because a TPU has no fast gather (adc_scan.py:12-18), and its key and
// gather modes exist to spare the TPU's scalar core one DMA a list and
// vector passes. Here the lookup is what it is, a read of shared memory; the
// key mode's gain is a 4-byte candidate key in place of an 8-byte one, no
// slot-id loads and no duplicate-id pass in the compaction.
//
// What bounds it on an H100: bytes. A 256-query batch at nprobe 64, M 96,
// Lcap 640 reads ~0.85 GB of live codes and ids and 0.8 GB of bf16 tables,
// 0.50 ms at 3.35 TB/s (the key mode reads no ids: ~0.03 GB less). Next come
// the lookups: ~0.8 G two-byte reads of shared memory at random banks (a
// warp's 32 reads hit ~3.4 of one bank), ~0.35 ms over 132 SMs.
//
// Design.
//   Pass 1 (adc_partial_kernel<MODE>): grid = B queries x S probe groups;
//   one CTA walks its probes as a sequence of steps, a step being one
//   probed list's table (M x 256 bf16) and a tile of its live codes (M rows
//   of up to `tile` slots; the whole list where shared memory allows).
//   Staging. A producer warp brings each step into a ring of 1 or 2 stages
//   with bulk asynchronous copies (TMA: one for the table, one per code
//   row), counted on the stage's `full` mbarrier; it writes the step's
//   list, offset, slot count and coordinate base beside it. A stage is
//   refilled when all eight consumer warps have arrived on its `empty`
//   mbarrier, so step t + 1 loads while step t is scored and no thread
//   spends an instruction on a load.
//   Scoring. A step's slots are cut into items of 128; item i of the CTA's
//   running count belongs to warp i mod 8, so warps pass from one step to
//   the next without a block-wide barrier and a list's ragged end costs
//   one warp, not the block. A lane reads four neighbouring slots' codes
//   as one 32-bit word per subspace from shared memory and looks the four
//   table entries up; in the dma mode the slot ids come by one 16-byte
//   load made first.
//   Order keys. dma: a candidate is one 64-bit key, (monotone bits of the
//   score) << 32 | (id + 2^31), so the top-k order (score desc, id desc) is
//   the unsigned key order and 0 is "empty"; rotating a key by 32 bits gives
//   the (id, score) order that groups an id's copies together. key and
//   gather: a candidate is one 32-bit key, mono16(truncated score) << 16 |
//   coordinate within the CTA's probe group, the group's probes chosen so
//   that their Lcap sum fits 16 bits (the TPU kernel's coord_base, :292,
//   :432); the group's base, p0 * Lcap, is implied by the CTA's group.
//   Coordinates are unique, so the key order is a strict total order.
//   Compaction. Candidates that beat the current kk-th key are appended to
//   a buffer of `cap` keys in shared memory: a warp counts its improvers
//   and reserves their places with one compare-and-swap. When a
//   reservation does not fit, the warp asks for a compaction and every
//   consumer warp joins it from the wait it is in or reaches next (each
//   wait polls the request). dma: a bitonic sort by the rotated key puts
//   each id's copies side by side and all but the best copy are dropped.
//   Then a bitonic sort by the key ranks the survivors, and the best kk
//   stay, the kk-th becoming the new threshold. So steady-state steps
//   append only their few improvers (about two compactions per CTA at kk =
//   100), and the result is sorted for every kk. Warps that run out of
//   steps wait for the others the same way; the compaction that all eight
//   enter finished is the last one.
//   Pass 2, one CTA per query, folds the S partial lists with the same
//   append-and-compact. dma (adc_merge_kernel): it also removes duplicates
//   found by different CTAs and writes (score, id). key and gather
//   (adc_merge_keys_kernel): each 32-bit key widens to mono16 << 32 |
//   (group base + coordinate), so the merge ranks by the same total order;
//   the winners' coordinates decode to (p, lane), and the CTA reads
//   slot_ids[probes[b, p], lane] for each of them.
//
// NVDB_ADC_ABLATE (measurement builds of tools.adc_breakdown, wrong by
// design): 1 stages every step and scores nothing; 2 also looks up and
// sums every slot but keeps no candidate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef NVDB_ADC_ABLATE
#define NVDB_ADC_ABLATE 0
#endif

namespace {

constexpr int NC = 256;        // consumer threads of pass 1; all threads of pass 2
constexpr int NCW = NC / 32;   // consumer warps
constexpr int NT1 = NC + 32;   // pass 1: the consumers and one producer warp (the last)
constexpr int ITEM = 128;      // slots per work item: four per lane
constexpr int MAX_KK = 1024;
constexpr int MAX_CAP = 8192;
constexpr int MAX_STAGES = 2;
constexpr int COORD_SPAN = 1 << 16;  // key modes: coordinates of one probe group
constexpr unsigned FULL_MASK = 0xffffffffu;
static_assert(MAX_CAP / NC <= 32, "compact() keeps one drop bit per element a thread owns");

enum Mode { DMA = 0, KEY = 1, GATHER = 2 };

// The candidate key of a mode: 64 bits (score, id) for dma, 32 bits
// (truncated score, coordinate) for key and gather.
template <int MODE>
struct KeyOf {
  using T = unsigned;
};
template <>
struct KeyOf<DMA> {
  using T = unsigned long long;
};

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

// Key modes: the score truncated to bf16 (its low 16 bits cleared), as 16
// monotone bits, above a 16-bit coordinate. A finite score never gives 0.
__device__ __forceinline__ unsigned make_key16(float s, int coord) {
  s = s + 0.0f;  // -0 -> +0
  const unsigned h = __float_as_uint(s) >> 16;
  const unsigned m = (h & 0x8000u) ? (~h & 0xffffu) : (h | 0x8000u);
  return (m << 16) | (unsigned)coord;
}

// The truncated score of 16 monotone bits.
__device__ __forceinline__ float mono16_score(unsigned m) {
  const unsigned h = (m & 0x8000u) ? (m & 0x7fffu) : (~m & 0xffffu);
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ unsigned long long rot32(unsigned long long x) {
  return (x << 32) | (x >> 32);
}

// The order a sort ranks by: the key, or (dma's duplicate pass) the key
// rotated 32 bits.
template <typename K, bool ROT>
__device__ __forceinline__ K sort_view(K x) {
  if constexpr (ROT) {
    return rot32(x);
  } else {
    return x;
  }
}

// Barrier of the NC threads that sort and compact (named barrier 1: the
// producer warp of pass 1 never joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Whether the barrier's phase of the given parity has completed (the
// hardware may suspend the thread for a short time first).
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One bulk asynchronous copy global -> shared; `bytes` (a multiple of 16,
// both addresses on 16-byte boundaries) are counted on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One compare-exchange stage of the bitonic network over a[0, n) in shared
// memory: pairs `stride` apart, ascending within blocks of `size`. The NC
// sorting threads; not synchronised.
template <typename K, bool ROT>
__device__ __forceinline__ void sort_stage_shared(K* a, int n, int size, int stride) {
  for (int i = threadIdx.x; i < n / 2; i += NC) {
    const int lo = 2 * i - (i & (stride - 1));
    const int hi = lo + stride;
    const K x = a[lo], y = a[hi];
    const bool up = (lo & size) == 0;
    if ((sort_view<K, ROT>(x) > sort_view<K, ROT>(y)) == up) {
      a[lo] = y;
      a[hi] = x;
    }
  }
}

// Ascending bitonic sort of a[0, NC * E) with the short strides in
// registers: warp w owns the chunk a[w * 32 E, (w + 1) * 32 E), lane l its
// elements l, l + 32, ..., so strides below 32 are shuffles, strides of 32
// to 16 E are exchanges between a lane's own registers, and only strides of
// a chunk or more go through shared memory with a barrier of the NC
// threads. The NC sorting threads; ends synchronised.
template <typename K, bool ROT, int E>
__device__ void block_sort_chunks(K* a) {
  constexpr int C = 32 * E;
  constexpr int n = NC * E;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  K* ch = a + warp * C;
  K v[E];

  // strides first, first / 2, ..., 1 (all below C) of the blocks of `size`
  auto local = [&](int size, int first) {
#pragma unroll
    for (int dj = E / 2; dj >= 1; dj >>= 1) {
      if (dj * 32 > first) continue;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if ((j & dj) != 0) continue;
        const bool up = ((warp * C + j * 32 + lane) & size) == 0;
        const K x = v[j], y = v[j | dj];
        if ((x > y) == up) {
          v[j] = y;
          v[j | dj] = x;
        }
      }
    }
    for (int stride = first < 16 ? first : 16; stride >= 1; stride >>= 1) {
      const bool lower = (lane & stride) == 0;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const K other = __shfl_xor_sync(FULL_MASK, v[j], stride);
        const bool up = ((warp * C + j * 32 + lane) & size) == 0;
        const bool keep_min = lower == up;
        v[j] = (v[j] < other) == keep_min ? v[j] : other;
      }
    }
  };
  auto load = [&]() {
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = sort_view<K, ROT>(ch[j * 32 + lane]);
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < E; ++j) ch[j * 32 + lane] = sort_view<K, ROT>(v[j]);
  };

  load();
  for (int size = 2; size <= C; size <<= 1) local(size, size >> 1);
  store();
  for (int size = 2 * C; size <= n; size <<= 1) {
    consumer_sync();  // the chunks are written
    for (int stride = size >> 1; stride >= C; stride >>= 1) {
      sort_stage_shared<K, ROT>(a, n, size, stride);
      consumer_sync();
    }
    load();
    local(size, C >> 1);
    store();
  }
  consumer_sync();
}

// Ascending bitonic sort of a[0, n) (n a power of two), by the key or by
// the key rotated 32 bits. The NC sorting threads; ends synchronised.
template <typename K, bool ROT>
__device__ void block_sort(K* a, int n) {
  switch (n) {
    case NC:
      return block_sort_chunks<K, ROT, 1>(a);
    case NC * 2:
      return block_sort_chunks<K, ROT, 2>(a);
    case NC * 4:
      return block_sort_chunks<K, ROT, 4>(a);
    case NC * 8:
      return block_sort_chunks<K, ROT, 8>(a);
    default:
      break;
  }
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      sort_stage_shared<K, ROT>(a, n, size, stride);
      consumer_sync();
    }
  }
}

// The running top-kk of one query in shared memory: buf[0, *n) holds the
// appended keys, *theta the key a candidate must beat. DEDUP (64-bit dma
// keys): an id's copies keep only the best.
template <typename K, bool DEDUP>
struct TopK {
  K* buf;
  int* n;
  K* theta;
  int cap;
  int kk;

  // One thread appends one key; the caller guarantees room.
  __device__ void append(K key) {
    if (key > *theta) buf[atomicAdd(n, 1)] = key;
  }

  // Reserves `count` places; returns the first, or -1 when they do not fit.
  __device__ int reserve(int count) {
    int old = *reinterpret_cast<volatile int*>(n);
    for (;;) {
      if (old + count > cap) return -1;
      const int prev = atomicCAS(n, old, old + count);
      if (prev == old) return old;
      old = prev;
    }
  }

  // Keeps the best kk (distinct ids, with DEDUP) keys in buf[0, kk), sorted
  // descending, and resets *theta. The NC sorting threads; must be entered
  // synchronised.
  __device__ void compact() {
    const int n0 = *n;
    int sz = 2;  // the sorts' length: the keys in the buffer, not its capacity
    while (sz < n0) sz <<= 1;
    for (int i = n0 + threadIdx.x; i < sz; i += NC) buf[i] = K(0);
    consumer_sync();
    if constexpr (DEDUP) {
      block_sort<K, true>(buf, sz);  // by (id, score): copies of an id adjacent
      unsigned drop = 0;             // bit j: element threadIdx.x + j * NC
      for (int j = 0, i = threadIdx.x; i < sz - 1; ++j, i += NC) {
        const K x = buf[i], y = buf[i + 1];
        if (x != K(0) && y != K(0) && (unsigned)x == (unsigned)y) drop |= 1u << j;
      }
      consumer_sync();
      for (int j = 0, i = threadIdx.x; i < sz - 1; ++j, i += NC)
        if (drop & (1u << j)) buf[i] = K(0);  // a better copy follows it
      consumer_sync();
    }
    block_sort<K, false>(buf, sz);  // ascending: the best at the end
    K top[MAX_KK / NC];
#pragma unroll
    for (int r = 0; r < MAX_KK / NC; ++r) {
      const int j = threadIdx.x + r * NC;
      top[r] = (j < kk && j < sz) ? buf[sz - 1 - j] : K(0);
    }
    consumer_sync();
#pragma unroll
    for (int r = 0; r < MAX_KK / NC; ++r) {
      const int j = threadIdx.x + r * NC;
      if (j < kk) buf[j] = top[r];
    }
    consumer_sync();
    // buf[0, kk) is descending with the empty keys last: the thread at the
    // last non-empty key sets the count and the threshold
    for (int j = threadIdx.x; j < kk; j += NC) {
      if (buf[j] != K(0) && (j + 1 == kk || buf[j + 1] == K(0))) {
        *n = j + 1;
        *theta = j + 1 == kk ? buf[j] : K(0);
      }
    }
    if (threadIdx.x == 0 && buf[0] == K(0)) {
      *n = 0;
      *theta = K(0);
    }
    consumer_sync();
  }
};

// What the warps of pass 1 share beside the key buffer and the stages.
template <typename K>
struct Shared {
  unsigned long long full[MAX_STAGES];   // mbarriers: a stage's bytes have landed
  unsigned long long empty[MAX_STAGES];  // mbarriers: the eight warps are done with it
  int4 meta[MAX_STAGES];  // (list, first slot, slots, coordinate base); slots < 0: no more steps
  K theta;
  int n;
  int want;  // a warp asks for a compaction
  int done;  // consumer warps that have run out of steps
};

// All consumer warps compact together. Returns whether every warp had run
// out of steps when it began, i.e. whether this compaction was the last.
template <typename T, typename S>
__device__ bool compaction_join(T& top, S& sh) {
  consumer_sync();  // every warp's appended keys are written
  // read between two barriers that all warps pass: all read the same value
  const bool last = *reinterpret_cast<volatile int*>(&sh.done) == NCW;
  if (threadIdx.x == 0) sh.want = 0;
  top.compact();
  return last;
}

// A consumer warp waits for a stage's bytes, joining any compaction asked
// for meanwhile (the warp that asked may hold the stage this one waits on).
template <typename T, typename S>
__device__ void wait_full(T& top, S& sh, int s, uint32_t parity, int lane) {
  const uint32_t bar = smem_u32(&sh.full[s]);
  for (;;) {
    int st = 0;
    if (lane == 0)
      st = *reinterpret_cast<volatile int*>(&sh.want) ? 2 : (mbar_try_wait(bar, parity) ? 1 : 0);
    st = __shfl_sync(FULL_MASK, st, 0);
    if (st == 1) break;
    if (st == 2) compaction_join(top, sh);
  }
  mbar_wait(bar, parity);  // every lane observes the completed phase itself
}

// Pass 1. dma and key: `codes` is the index's [nlist, M, Lcap]; gather: the
// slab [B * P, M, Lcap] of the probed lists. `slot_ids` is read by dma only.
template <int MODE>
__global__ void __launch_bounds__(NT1)
adc_partial_kernel(const __nv_bfloat16* __restrict__ lut, const int* __restrict__ probes,
                   const uint8_t* __restrict__ codes, const int* __restrict__ slot_ids,
                   const int* __restrict__ fills,
                   typename KeyOf<MODE>::T* __restrict__ part_keys, int P, int M, int Lcap,
                   int nlist, int kk, int S, int cap, int NS, int Lc) {
  using K = typename KeyOf<MODE>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  K* buf = reinterpret_cast<K*>(smem);
  unsigned char* stages = smem + (size_t)cap * sizeof(K);
  const int table_bytes = M * 512;
  const int stage_bytes = table_bytes + M * Lc;
  __shared__ Shared<K> sh;

  const int b = blockIdx.x, s_grp = blockIdx.y;
  const int per = (P + S - 1) / S;
  const int p0 = s_grp * per, p1 = min(P, p0 + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(smem_u32(&sh.full[s]), 1);
      mbar_init(smem_u32(&sh.empty[s]), NCW);
    }
    sh.theta = K(0);
    sh.n = 0;
    sh.want = 0;
    sh.done = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCW) {
    // ---- producer warp: one step per (probe, code tile), then the end mark ----
    int t = 0;
    for (int p = p0; p < p1; ++p) {
      const int li = probes[(size_t)b * P + p];
      const int fill = (li >= 0 && li < nlist) ? min(fills[li], Lcap) : 0;
      const size_t row = MODE == GATHER ? (size_t)b * P + p : (size_t)max(li, 0);
      const uint8_t* list = codes + row * M * Lcap;
      for (int l0 = 0; l0 < fill; l0 += Lc, ++t) {
        const int s = t % NS, use = t / NS;
        if (use > 0) mbar_wait(smem_u32(&sh.empty[s]), (uint32_t)((use - 1) & 1));
        const uint32_t bar = smem_u32(&sh.full[s]);
        const int count = min(Lc, fill - l0);
        const uint32_t row_bytes = (uint32_t)((count + 15) & ~15);
        const uint32_t dst = smem_u32(stages + (size_t)s * stage_bytes);
        if (lane == 0) {
          sh.meta[s] = make_int4(li, l0, count, (p - p0) * Lcap);
          mbar_expect_tx(bar, (uint32_t)table_bytes + (uint32_t)M * row_bytes);
          bulk_load(dst, lut + ((size_t)b * P + p) * M * 256, (uint32_t)table_bytes, bar);
        }
        __syncwarp();
        for (int m = lane; m < M; m += 32)
          bulk_load(dst + table_bytes + m * Lc, list + (size_t)m * Lcap + l0, row_bytes, bar);
      }
    }
    const int s = t % NS, use = t / NS;
    if (use > 0) mbar_wait(smem_u32(&sh.empty[s]), (uint32_t)((use - 1) & 1));
    if (lane == 0) {
      sh.meta[s] = make_int4(-1, 0, -1, 0);
      mbar_arrive(smem_u32(&sh.full[s]));
    }
    return;
  }

  // ---- consumer warps ----
  TopK<K, MODE == DMA> top{buf, &sh.n, &sh.theta, cap, kk};
  int it_base = 0;  // items of earlier steps, mod NCW
  for (int t = 0;; ++t) {
    const int s = t % NS;
    wait_full(top, sh, s, (uint32_t)((t / NS) & 1), lane);
    const int4 mt = sh.meta[s];
    const int li = mt.x, l0 = mt.y, count = mt.z, cbase = mt.w;
    if (count < 0) break;
    const int n_items = (count + ITEM - 1) / ITEM;
#if NVDB_ADC_ABLATE != 1
    const unsigned char* stage = stages + (size_t)s * stage_bytes;
    const unsigned short* lut_s = reinterpret_cast<const unsigned short*>(stage);
    const unsigned char* codes_s = stage + table_bytes;
    for (int i = (warp - it_base + NCW) % NCW; i < n_items; i += NCW) {
      const int ls = i * ITEM + lane * 4;  // this lane's first slot of the tile
      // dma: the slots' ids (-1: not live); key modes: live iff in the tile
      int id[4] = {-1, -1, -1, -1};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (ls < count) {
        if constexpr (MODE == DMA) {
          const int4 v = *reinterpret_cast<const int4*>(slot_ids + (size_t)li * Lcap + l0 + ls);
          id[0] = v.x;
          id[1] = ls + 1 < count ? v.y : -1;
          id[2] = ls + 2 < count ? v.z : -1;
          id[3] = ls + 3 < count ? v.w : -1;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) id[j] = ls + j < count ? 0 : -1;
        }
        const unsigned char* cp = codes_s + ls;
#pragma unroll 8
        for (int m = 0; m < M; ++m) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(cp + m * Lc);
          const unsigned short* row = lut_s + m * 256;
          acc[0] += __uint_as_float((uint32_t)row[w & 0xffu] << 16);
          acc[1] += __uint_as_float((uint32_t)row[(w >> 8) & 0xffu] << 16);
          acc[2] += __uint_as_float((uint32_t)row[(w >> 16) & 0xffu] << 16);
          acc[3] += __uint_as_float((uint32_t)row[w >> 24] << 16);
        }
      }
      K key[4];
      int c = 0;
#if NVDB_ADC_ABLATE == 2
      const bool keep_none = true;
#else
      const bool keep_none = false;
#endif
      const K theta = *reinterpret_cast<volatile K*>(&sh.theta);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (MODE == DMA) {
          key[j] = make_key(-acc[j], id[j]);
        } else {
          key[j] = make_key16(-acc[j], cbase + l0 + ls + j);
        }
        const bool keep = keep_none ? acc[j] == -1234.5f : key[j] > theta;
        if (!(id[j] >= 0 && keep)) key[j] = K(0);
        c += key[j] != K(0);
      }
      if (__ballot_sync(FULL_MASK, c > 0) == 0u) continue;
      int incl = c;  // inclusive prefix sum of the lanes' counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += v;
      }
      const int total = __shfl_sync(FULL_MASK, incl, 31);
      int base;
      for (;;) {
        base = lane == 0 ? top.reserve(total) : 0;
        base = __shfl_sync(FULL_MASK, base, 0);
        if (base >= 0) break;
        if (lane == 0) atomicExch(&sh.want, 1);
        compaction_join(top, sh);
      }
      int pos = base + incl - c;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (key[j] != K(0)) buf[pos++] = key[j];
    }
#endif
    it_base = (it_base + n_items) % NCW;
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&sh.empty[s]));
  }

  // out of steps: join the others' compactions until all are out of steps;
  // the compaction that all eight enter finished is the last
  __syncwarp();
  if (lane == 0) atomicAdd(&sh.done, 1);
  for (;;) {
    if (lane == 0) {
      while (*reinterpret_cast<volatile int*>(&sh.want) == 0 &&
             *reinterpret_cast<volatile int*>(&sh.done) < NCW)
        __nanosleep(64);
    }
    __syncwarp();
    if (compaction_join(top, sh)) break;
  }
  K* out = part_keys + ((size_t)b * S + s_grp) * kk;
  for (int j = threadIdx.x; j < kk; j += NC) out[j] = buf[j];
}

__global__ void __launch_bounds__(NC)
adc_merge_kernel(const unsigned long long* __restrict__ part_keys,
                 float* __restrict__ out_vals, int* __restrict__ out_ids, int kk, int S,
                 int cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  __shared__ int n_sh;
  __shared__ unsigned long long theta_sh;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    n_sh = 0;
    theta_sh = 0ull;
  }
  __syncthreads();
  TopK<unsigned long long, true> top{buf, &n_sh, &theta_sh, cap, kk};
  for (int s = 0; s < S; ++s) {
    if (n_sh + kk > cap) top.compact();
    const unsigned long long* src = part_keys + ((size_t)b * S + s) * kk;
    for (int j = threadIdx.x; j < kk; j += NC) {
      const unsigned long long key = src[j];
      if (key != 0ull) top.append(key);
    }
    __syncthreads();
  }
  top.compact();
  for (int j = threadIdx.x; j < kk; j += NC) {
    const unsigned long long key = buf[j];
    out_vals[(size_t)b * kk + j] = key ? key_score(key) : -INFINITY;
    out_ids[(size_t)b * kk + j] = key ? key_id(key) : -1;
  }
}

// Pass 2 of the key modes: group s's keys widen to mono16 << 32 | (s * per
// * Lcap + coordinate), the whole probe range's (score desc, coordinate
// desc) order; the kk winners decode to (p, lane) and their row ids are
// read from slot_ids[probes[b, p], lane].
__global__ void __launch_bounds__(NC)
adc_merge_keys_kernel(const unsigned* __restrict__ part_keys, const int* __restrict__ probes,
                      const int* __restrict__ slot_ids, float* __restrict__ out_vals,
                      int* __restrict__ out_ids, int P, int Lcap, int kk, int S, int per,
                      int cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  __shared__ int n_sh;
  __shared__ unsigned long long theta_sh;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    n_sh = 0;
    theta_sh = 0ull;
  }
  __syncthreads();
  TopK<unsigned long long, false> top{buf, &n_sh, &theta_sh, cap, kk};
  for (int s = 0; s < S; ++s) {
    if (n_sh + kk > cap) top.compact();
    const unsigned* src = part_keys + ((size_t)b * S + s) * kk;
    const unsigned base = (unsigned)(s * per * Lcap);
    for (int j = threadIdx.x; j < kk; j += NC) {
      const unsigned key = src[j];
      if (key != 0u)
        top.append(((unsigned long long)(key >> 16) << 32) | (base + (key & 0xffffu)));
    }
    __syncthreads();
  }
  top.compact();
  for (int j = threadIdx.x; j < kk; j += NC) {
    const unsigned long long key = buf[j];
    float v = -INFINITY;
    int id = -1;
    if (key != 0ull) {
      const unsigned coord = (unsigned)key;
      const int p = (int)(coord / (unsigned)Lcap), l = (int)(coord % (unsigned)Lcap);
      const int li = probes[(size_t)b * P + p];
      v = mono16_score((unsigned)(key >> 32));
      id = slot_ids[(size_t)li * Lcap + l];
    }
    out_vals[(size_t)b * kk + j] = v;
    out_ids[(size_t)b * kk + j] = id;
  }
}

int pow2_at_least(int x) {
  int c = 1;
  while (c < x) c <<= 1;
  return c;
}

// The checks and the pass-1 launch shared by the modes. Returns a
// cudaError_t; *cap2 is pass 2's buffer length.
template <int MODE>
int launch_partial(const void* lut, const void* probes, const void* codes, const void* slot_ids,
                   const void* fills, void* part_keys, int B, int P, int M, int Lcap, int nlist,
                   int kk, int S, int stages, int tile, cudaStream_t st, int* cap2) {
  using K = typename KeyOf<MODE>::T;
  if (B < 1 || P < 1 || M < 1 || Lcap < 16 || Lcap % 16 != 0 || nlist < 1 || kk < 1 ||
      kk > MAX_KK || S < 1 || S > P || stages < 1 || stages > MAX_STAGES || tile < 16 ||
      tile > Lcap || tile % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // buffer lengths (keys): the kk kept keys plus room for several items
  const int cap1 = pow2_at_least(kk + 512 > 1024 ? kk + 512 : 1024);
  *cap2 = pow2_at_least(2 * kk > 1024 ? 2 * kk : 1024);
  if (cap1 > MAX_CAP || cap1 < kk + ITEM) return (int)cudaErrorInvalidValue;
  const size_t smem1 =
      (size_t)cap1 * sizeof(K) + (size_t)stages * ((size_t)M * 512 + (size_t)M * tile);
  cudaError_t e = cudaFuncSetAttribute(adc_partial_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem1);
  if (e != cudaSuccess) return (int)e;
  adc_partial_kernel<MODE><<<dim3(B, S), NT1, smem1, st>>>(
      static_cast<const __nv_bfloat16*>(lut), static_cast<const int*>(probes),
      static_cast<const uint8_t*>(codes), static_cast<const int*>(slot_ids),
      static_cast<const int*>(fills), static_cast<K*>(part_keys), P, M, Lcap, nlist, kk, S,
      cap1, stages, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). lut [B, P, M, 256] bf16, probes [B, P]
// int32, codes [nlist, M, Lcap] uint8 (Lcap a multiple of 16), slot_ids
// [nlist, Lcap] int32, fills [nlist] int32; scratch part_keys [B, S, kk]
// uint64; outputs [B, kk]. `stages` (1 or 2) and `tile` (slots per code
// tile, a multiple of 16, at most Lcap) size pass 1's ring; its key buffer
// is pow2(max(1024, kk + 512)) keys. Returns a cudaError_t (0 on success);
// launches are asynchronous on `stream`.
extern "C" int nvdb_adc_topk(const void* lut, const void* probes, const void* codes,
                             const void* slot_ids, const void* fills, void* part_keys,
                             void* out_vals, void* out_ids, int B, int P, int M, int Lcap,
                             int nlist, int kk, int S, int stages, int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int cap2 = 0;
  int e = launch_partial<DMA>(lut, probes, codes, slot_ids, fills, part_keys, B, P, M, Lcap,
                              nlist, kk, S, stages, tile, st, &cap2);
  if (e != 0) return e;
  const size_t smem2 = (size_t)cap2 * 8;
  cudaError_t ce = cudaFuncSetAttribute(adc_merge_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (ce != cudaSuccess) return (int)ce;
  adc_merge_kernel<<<B, NC, smem2, st>>>(static_cast<const unsigned long long*>(part_keys),
                                         static_cast<float*>(out_vals),
                                         static_cast<int*>(out_ids), kk, S, cap2);
  return (int)cudaGetLastError();
}

// The key modes. As nvdb_adc_topk, but the index is prefix-packed with
// unique ids (replicas == 1), part_keys is [B, S, kk] uint32, and each
// probe group's Lcap sum fits 16 bits (ceil(P / S) * Lcap <= 65536).
// gathered = 0: `codes` is the index's [nlist, M, Lcap]; gathered = 1: the
// slab [B * P, M, Lcap] of the probed lists, row b * P + p.
extern "C" int nvdb_adc_topk_keys(const void* lut, const void* probes, const void* codes,
                                  const void* slot_ids, const void* fills, void* part_keys,
                                  void* out_vals, void* out_ids, int B, int P, int M, int Lcap,
                                  int nlist, int kk, int S, int stages, int tile, int gathered,
                                  void* stream) {
  if (S < 1 || Lcap < 1 || (long long)((P + S - 1) / S) * Lcap > COORD_SPAN ||
      (long long)P * Lcap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int cap2 = 0;
  int e = gathered
              ? launch_partial<GATHER>(lut, probes, codes, slot_ids, fills, part_keys, B, P, M,
                                       Lcap, nlist, kk, S, stages, tile, st, &cap2)
              : launch_partial<KEY>(lut, probes, codes, slot_ids, fills, part_keys, B, P, M,
                                    Lcap, nlist, kk, S, stages, tile, st, &cap2);
  if (e != 0) return e;
  const size_t smem2 = (size_t)cap2 * 8;
  cudaError_t ce = cudaFuncSetAttribute(adc_merge_keys_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (ce != cudaSuccess) return (int)ce;
  adc_merge_keys_kernel<<<B, NC, smem2, st>>>(
      static_cast<const unsigned*>(part_keys), static_cast<const int*>(probes),
      static_cast<const int*>(slot_ids), static_cast<float*>(out_vals),
      static_cast<int*>(out_ids), P, Lcap, kk, S, (P + S - 1) / S, cap2);
  return (int)cudaGetLastError();
}
