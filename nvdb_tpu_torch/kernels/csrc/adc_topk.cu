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
//   * fused key scan (nvdb_adc_fused_keys; the key mode of the IVF-PQ
//     path, replacing the TPU kernel's key mode above and the tables the
//     JAX package leaves to XLA, nvdb_tpu/kernels/pq.py:89 adc_lut and the
//     bf16 cast at nvdb_tpu/index/ivf_pq.py:73). It takes the rotated
//     queries, the probes, centroids and codebooks in place of the tables
//     and gives bit for bit the key mode's result on adc_tables.cu's
//     tables: it computes each entry with the same arithmetic
//     (adc_table_math.cuh), sums the entries in f32 over m in the same
//     order and keys them the same way. No [B, P, M, 256] table exists.
//   * fused dma scan (nvdb_adc_fused_topk; the dma mode of the IVF-PQ path,
//     replacing the TPU kernel's dma mode and the XLA tables as the fused
//     key scan replaces its key mode). The same fused pass 1 on 64-bit dma
//     keys, bit for bit nvdb_adc_topk on adc_tables.cu's tables.
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
//   (adc_merge_keys_kernel, 1024 keys loaded at once): each 32-bit key
//   widens to mono16 << 32 | (group base + coordinate), so the merge ranks
//   by the same total order; the winners' coordinates decode to (p, lane),
//   and the CTA reads slot_ids[probes[b, p], lane] for each of them.
//
// The fused key scan. Two kernels fed a batch of 256 queries at nprobe 64,
// M 96, dsub 8: the table kernel writes 0.805 GB of bf16 tables and the
// key scan reads them back, 0.48 ms of device memory at 3.35 TB/s whatever
// either does, and building a pair's tables inside a query-major scan
// would pull the 786 KB of codebooks through L2 once a pair (12.9 GB). So
// the fused scan is list-major, and the tables live in shared memory.
//   Pass 0 (nvdb::group_pairs_kernel, group_pairs.cuh, shared with
//   ivf_probe_topk.cu): the pairs are grouped by list into items of at
//   most nq pairs, the longest lists first; pass 1's grid is sized from
//   shapes and nothing is read back to the host.
//   Pass 1 (adc_fused_kernel<DSUB, NQ>): one CTA of 256 threads per (item,
//   tile of 1024 lanes of its list). It stages each pair's residual (one
//   rounded subtraction a coordinate) and its squared norm per subspace in
//   shared memory, a subspace's slices of the pairs side by side, then walks
//   the subspaces in order. At step m, thread j builds entry j of subspace
//   m + 2's table of each pair from codeword j (registers, loaded two steps
//   ahead) into one of four buffers [256][nq] bf16 (a codeword's entries of
//   the pairs side by side), while subspace m's are looked up: each lane's
//   code byte (a ring of code rows in shared memory, each copied 14
//   subspaces ahead by cp.async) is read once, and one 16-byte load fetches
//   its entries for eight pairs, added in f32 to per-(pair, lane)
//   accumulators in registers. A buffer is read two steps after it is
//   written, so one barrier serves two steps. A subspace's 8 KB codebook
//   slice is read once for the item's nq pairs, and a lane's code once for
//   them. A thread owns lanes t, t + 256, ..., which spreads a list's ragged
//   end over all warps. Then each pair keys its live lanes as the key mode
//   does (mono16 of the truncated score << 16 | lane). A tile with more live
//   lanes than kk selects each pair's kk best keys by a radix select, eight
//   bits a pass from the top (a histogram a pair in shared memory, then one
//   warp a pair walks the bins), never by a sort; the selected keys go to
//   the pair's partial list [b, p, tile] in any order (the wrapper's memset
//   leaves the rest 0), and the pair's kk-th key, a lower bound of the
//   query's kk-th, beside it.
//   Pass 2 (adc_merge_keys_kernel, with tiles partials a probe) merges each
//   query's P x T partial lists as the key mode's pass 2 merges its groups,
//   appending only keys at or above the largest of their lower bounds.
//   The fused dma scan (adc_fused_kernel<DMA, ...>) differs in four places:
//   a lane is live where its slot id is >= 0 (a repacked list has holes
//   below its fill), the score is not truncated, a candidate is the dma
//   key mono32(score) << 32 | (id + 2^31), its id read only where a key is
//   made, and the radix select walks the score word, and the id word only
//   for a pair whose kk-th score is tied. A tile's kk best keys must be kk
//   distinct ids, or an id ranked just below them could be lost: where a
//   list tile holds an id more than once (nothing in the packer keeps a
//   row's copies in distinct lists; adc_scan.tile_leads marks such slots),
//   each pair keeps that id's best copy only (of equal scores, the first
//   lane's), the group's best score and first lane found with shared-memory
//   atomics in the freed code ring. Pass 2 is the dma merge
//   (adc_merge_kernel) over each query's P x T partials, appending only
//   keys at or above the largest partial's kk-th key, and dropping the
//   copies of an id that several lists or tiles hold where the index may
//   hold an id twice.
//   What bounds it on an H100: operations. The tables are ~6.4 GFLOP of f32
//   FMA at the flagship (dsub products, the norms and the combination for
//   every entry of every live pair), 0.1 ms at 67 TFLOP/s, against ~30 MB
//   of distinct codes, queries, centroids and codebooks; beside them come
//   the ~0.8 G lookups into shared memory, which have no data-sheet rate.
//   The chunk width nq is the wrapper's plan (the widest that fits shared
//   memory, at most the chosen maximum; chip_smoke.py phase 9 sweeps it):
//   wider chunks read the codebooks fewer times but keep more accumulators,
//   and where few pairs share a list (small batches) one pair a chunk wins.
//
// NVDB_ADC_ABLATE (measurement builds of tools.adc_breakdown and
// chip_smoke.py phase 9, wrong by design): 1 stages every step and scores
// nothing; 2 also looks up and sums every slot but keeps no candidate; 3:
// the fused scans stage and build their tables and look nothing up; 4:
// they also look up and sum, but select and write no candidate; 5: they run
// passes 0 and 1 and no merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "adc_table_math.cuh"
#include "group_pairs.cuh"

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

// The 32 monotone bits of a score (the high word of its dma key).
__device__ __forceinline__ unsigned mono32(float s) {
  s = s + 0.0f;  // -0 -> +0: equal scores get equal keys
  const unsigned b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long make_key(float s, int id) {
  return ((unsigned long long)mono32(s) << 32) | (unsigned)(id ^ 0x80000000);
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

constexpr int MERGE_U = 4;   // keys a pass-2 thread loads at once

// Pass 2 of the dma modes. Query b's S partial lists of kk 64-bit keys (0
// empty, in any order; the staged scan's probe groups, or the fused scan's
// (probe, tile) partials) are read as one run, NC * MERGE_U keys at a time,
// and folded, with the duplicate pass where an id may be held twice (DEDUP);
// part_thr (the fused scan's, or null) holds each partial's kk-th key, a
// lower bound of the query's kk-th, so keys under the largest bound are not
// appended.
template <bool DEDUP>
__global__ void __launch_bounds__(NC)
adc_merge_kernel(const unsigned long long* __restrict__ part_keys,
                 const unsigned long long* __restrict__ part_thr,
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
  if (part_thr != nullptr) {
    unsigned long long lo = 0ull;
    for (int s = threadIdx.x; s < S; s += NC) lo = max(lo, part_thr[(size_t)b * S + s]);
    if (lo != 0ull) atomicMax(&theta_sh, lo - 1ull);
    __syncthreads();
  }
  TopK<unsigned long long, DEDUP> top{buf, &n_sh, &theta_sh, cap, kk};
  const int total = S * kk;
  const unsigned long long* src = part_keys + (size_t)b * total;
  for (int c0 = 0; c0 < total; c0 += NC * MERGE_U) {
    unsigned long long key[MERGE_U];
#pragma unroll
    for (int u = 0; u < MERGE_U; ++u) {
      const int i = c0 + u * NC + (int)threadIdx.x;
      key[u] = i < total ? src[i] : 0ull;
    }
    if (n_sh + NC * MERGE_U > cap) top.compact();
#pragma unroll
    for (int u = 0; u < MERGE_U; ++u)
      if (key[u] != 0ull) top.append(key[u]);
    __syncthreads();
  }
  top.compact();
  for (int j = threadIdx.x; j < kk; j += NC) {
    const unsigned long long key = buf[j];
    out_vals[(size_t)b * kk + j] = key ? key_score(key) : -INFINITY;
    out_ids[(size_t)b * kk + j] = key ? key_id(key) : -1;
  }
}

// Pass 2 of the key modes. Query b's S partial lists of kk 32-bit keys
// (mono16 << 16 | coordinate, 0 empty, in any order) are read as one run,
// NC * MERGE_U keys at a time; partial s holds the probes from (s / tiles)
// * per on (the key kernel: tiles 1, a probe group of `per` probes a
// partial; the fused scan: tiles partials a probe, per 1), so each key
// widens to mono16 << 32 | ((s / tiles) * per * Lcap + coordinate), the
// whole probe range's (score desc, coordinate desc) order; the kk winners
// decode to (p, lane) and their row ids are read from slot_ids[probes[b,
// p], lane].
__device__ __forceinline__ unsigned long long widen_key(unsigned key, int s, int per,
                                                        int tiles, int Lcap) {
  const unsigned base = (unsigned)((s / tiles) * per * Lcap);
  return ((unsigned long long)(key >> 16) << 32) | (base + (key & 0xffffu));
}

__global__ void __launch_bounds__(NC)
adc_merge_keys_kernel(const unsigned* __restrict__ part_keys,
                      const unsigned* __restrict__ part_thr, const int* __restrict__ probes,
                      const int* __restrict__ slot_ids, float* __restrict__ out_vals,
                      int* __restrict__ out_ids, int P, int Lcap, int kk, int S, int per,
                      int tiles, int cap) {
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
  if (part_thr != nullptr) {
    // a partial list's kk-th key bounds the query's kk-th from below: keys
    // under the largest bound never rank
    unsigned long long lo = 0ull;
    for (int s = threadIdx.x; s < S; s += NC) {
      const unsigned t = part_thr[(size_t)b * S + s];
      if (t != 0u) lo = max(lo, widen_key(t, s, per, tiles, Lcap));
    }
    if (lo != 0ull) atomicMax(&theta_sh, lo - 1ull);
    __syncthreads();
  }
  TopK<unsigned long long, false> top{buf, &n_sh, &theta_sh, cap, kk};
  const int total = S * kk;
  const unsigned* src = part_keys + (size_t)b * total;
  for (int c0 = 0; c0 < total; c0 += NC * MERGE_U) {
    unsigned key[MERGE_U];
#pragma unroll
    for (int u = 0; u < MERGE_U; ++u) {
      const int i = c0 + u * NC + (int)threadIdx.x;
      key[u] = i < total ? src[i] : 0u;
    }
    if (n_sh + NC * MERGE_U > cap) top.compact();
#pragma unroll
    for (int u = 0; u < MERGE_U; ++u)
      if (key[u] != 0u)
        top.append(widen_key(key[u], (c0 + u * NC + (int)threadIdx.x) / kk, per, tiles, Lcap));
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

// Pass 2 of the dma modes on `st`; its buffer holds the kk kept keys and a
// whole load of every thread. dedup: an id may be held twice.
template <bool DEDUP>
cudaError_t launch_merge(const void* part_keys, const unsigned long long* part_thr,
                         void* out_vals, void* out_ids, int B, int kk, int S, cudaStream_t st) {
  const size_t smem = (size_t)pow2_at_least(kk + NC * MERGE_U) * 8;
  cudaError_t e = cudaFuncSetAttribute(adc_merge_kernel<DEDUP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  adc_merge_kernel<DEDUP><<<B, NC, smem, st>>>(
      static_cast<const unsigned long long*>(part_keys), part_thr,
      static_cast<float*>(out_vals), static_cast<int*>(out_ids), kk, S, (int)(smem / 8));
  return cudaGetLastError();
}

// Pass 2 of the key modes on `st`; its buffer holds the kk kept keys and a
// whole load of every thread.
cudaError_t launch_merge_keys(const void* part_keys, const unsigned* part_thr, const void* probes,
                              const void* slot_ids, void* out_vals, void* out_ids, int B, int P,
                              int Lcap, int kk, int S, int per, int tiles, cudaStream_t st) {
  const size_t smem = (size_t)pow2_at_least(kk + NC * MERGE_U) * 8;
  cudaError_t e = cudaFuncSetAttribute(adc_merge_keys_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  adc_merge_keys_kernel<<<B, NC, smem, st>>>(
      static_cast<const unsigned*>(part_keys), part_thr, static_cast<const int*>(probes),
      static_cast<const int*>(slot_ids), static_cast<float*>(out_vals),
      static_cast<int*>(out_ids), P, Lcap, kk, S, per, tiles, (int)(smem / 8));
  return cudaGetLastError();
}

// The checks and the pass-1 launch shared by the modes. Returns a
// cudaError_t.
template <int MODE>
int launch_partial(const void* lut, const void* probes, const void* codes, const void* slot_ids,
                   const void* fills, void* part_keys, int B, int P, int M, int Lcap, int nlist,
                   int kk, int S, int stages, int tile, cudaStream_t st) {
  using K = typename KeyOf<MODE>::T;
  if (B < 1 || P < 1 || M < 1 || Lcap < 16 || Lcap % 16 != 0 || nlist < 1 || kk < 1 ||
      kk > MAX_KK || S < 1 || S > P || stages < 1 || stages > MAX_STAGES || tile < 16 ||
      tile > Lcap || tile % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // buffer lengths (keys): the kk kept keys plus room for several items
  const int cap1 = pow2_at_least(kk + 512 > 1024 ? kk + 512 : 1024);
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

// ---------------------------------------------------------------------------
// The fused key scan (nvdb_adc_fused_keys; see the note at the top).
// ---------------------------------------------------------------------------

constexpr int FT = 256;                  // threads of a fused CTA: thread j builds codeword j
constexpr int FW = FT / 32;
constexpr int F_LPT = 4;                 // lanes of a tile a thread owns: t, t + FT, ...
constexpr int F_TILE = FT * F_LPT;       // lanes a CTA takes: a list's tiles are CTAs
constexpr int F_RING = 16;               // code rows a CTA holds: a row's copy starts 14
                                         // subspaces before it is read
constexpr int F_CTAS = 3;                // CTAs a SM the instances of up to 8 pairs are built
                                         // for: 80 registers a thread, no spill at dsub 8
constexpr int F_MAX_DEVICES = 64;        // the per-device cache of launch_fused
constexpr int F_STATIC_SMEM = 1024;      // room the plan leaves for the static shared memory
static_assert(FT == 256, "one thread a codeword of a subspace");

// Dynamic shared memory of a fused CTA of nq pairs: the residuals [nq][M *
// dsub] f32, their squared norms r2 [nq][M] f32, four table buffers
// [4][256][nq] bf16 (which the selection reuses as histograms [nq][256]
// int) and a ring of code rows [F_RING][F_TILE] u8.
__host__ __device__ inline size_t fused_smem_bytes(int nq, int M, int dsub) {
  return (size_t)nq * ((size_t)M * dsub * 4 + (size_t)M * 4 + 4 * 256 * 2) +
         (size_t)F_RING * F_TILE;
}

// One asynchronous 4-byte copy global -> shared (cp.async); of `bytes` (0
// or 4) read, the rest zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// DSUB floats from p (16-byte aligned where DSUB % 4 == 0) into registers.
template <int DSUB>
__device__ __forceinline__ void load_slice(float (&x)[DSUB], const float* p) {
  if constexpr (DSUB % 4 == 0) {
#pragma unroll
    for (int d4 = 0; d4 < DSUB / 4; ++d4) {
      const float4 v = reinterpret_cast<const float4*>(p)[d4];
      x[4 * d4] = v.x;
      x[4 * d4 + 1] = v.y;
      x[4 * d4 + 2] = v.z;
      x[4 * d4 + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DSUB; ++d) x[d] = p[d];
  }
}

// Subspace m's table entries of the CTA's pairs i0 .. i0 + K - 1 into tab
// [256][NQ] (a codeword's entries of the pairs side by side): thread j
// writes them to row j, codeword j being w (registers for a fixed dsub, the
// codebook itself for DSUB 0) with squared norm c2; the K entries are
// independent chains, so they overlap. xs: the pairs' residual slices of
// subspace m, [NQ][dsub] from pair i0 on; r2: their squared norms, [NQ].
// The arithmetic of adc_tables.cu, from adc_table_math.cuh.
template <int DSUB, int NQ, int K>
__device__ __forceinline__ void fused_tables(unsigned short* tab, const float* xs,
                                             const float* r2, const float* w, float c2, int i0,
                                             int dsub) {
  float v[K];
  float r2v[K];
  if constexpr (K == 4) {
    const float4 t = *reinterpret_cast<const float4*>(r2);
    r2v[0] = t.x;
    r2v[1] = t.y;
    r2v[2] = t.z;
    r2v[3] = t.w;
  } else {
#pragma unroll
    for (int u = 0; u < K; ++u) r2v[u] = r2[u];
  }
  if constexpr (DSUB > 0) {
    float x[K][DSUB];
#pragma unroll
    for (int u = 0; u < K; ++u) load_slice<DSUB>(x[u], xs + u * DSUB);
#pragma unroll
    for (int u = 0; u < K; ++u) v[u] = nvdb::adc_entry(r2v[u], nvdb::fma_chain<DSUB>(x[u], w), c2);
  } else {
#pragma unroll
    for (int u = 0; u < K; ++u)
      v[u] = nvdb::adc_entry(r2v[u], nvdb::fma_chain_n(xs + u * dsub, w, dsub), c2);
  }
  unsigned short* row = tab + threadIdx.x * NQ + i0;
  if constexpr (K == 4) {
    *reinterpret_cast<uint2*>(row) =
        make_uint2(nvdb::pack_bf16(v[0], v[1]), nvdb::pack_bf16(v[2], v[3]));
  } else {
#pragma unroll
    for (int u = 0; u < K; ++u) row[u] = nvdb::bf16_bits(v[u]);
  }
}

// Adds the table entries of pairs i0 .. i0 + W - 1 at each live lane's
// code to the lane's sums: one shared-memory load of W bf16 a lane, for the
// n_slots lane slots the tile fills.
template <int NQ, int W>
__device__ __forceinline__ void fused_lookup(float (&acc)[NQ][F_LPT], const unsigned short* tab,
                                             const uint32_t (&code)[F_LPT],
                                             const bool (&live)[F_LPT], int i0, int n_slots) {
#pragma unroll
  for (int r = 0; r < F_LPT; ++r) {
    if (r >= n_slots) break;
    uint32_t e[(W + 1) / 2];
    const unsigned short* row = tab + code[r] * NQ + i0;
    if constexpr (W == 8) {
      const uint4 x = live[r] ? *reinterpret_cast<const uint4*>(row) : make_uint4(0, 0, 0, 0);
      e[0] = x.x;
      e[1] = x.y;
      e[2] = x.z;
      e[3] = x.w;
    } else if constexpr (W == 4) {
      const uint2 x = live[r] ? *reinterpret_cast<const uint2*>(row) : make_uint2(0, 0);
      e[0] = x.x;
      e[1] = x.y;
    } else if constexpr (W == 2) {
      e[0] = live[r] ? *reinterpret_cast<const uint32_t*>(row) : 0u;
    } else {
      e[0] = live[r] ? (uint32_t)*row : 0u;
    }
#pragma unroll
    for (int u = 0; u < W; ++u)
      acc[i0 + u][r] += __uint_as_float(u & 1 ? e[u / 2] & 0xffff0000u : e[u / 2] << 16);
  }
}

// Pass 1 of the fused scans: one CTA per (item, lane tile). MODE KEY (the
// fused key scan) or DMA (the fused dma scan); DSUB 0: any dsub. dma:
// slot_ids gives the live lanes and the candidates' ids; leads (or null) the
// first lane of the tile that holds a lane's id when the tile holds it more
// than once, else -1 (adc_scan.tile_leads).
template <int MODE, int DSUB, int NQ>
__global__ void __launch_bounds__(FT, NQ <= 8 ? F_CTAS : NQ <= 16 ? 2 : 1)
adc_fused_kernel(const float* __restrict__ q_rot, const float* __restrict__ cents,
                 const float* __restrict__ cb, const uint8_t* __restrict__ codes,
                 const int* __restrict__ slot_ids, const int* __restrict__ leads,
                 const int* __restrict__ fills, const int* __restrict__ order,
                 const int4* __restrict__ items, const int* __restrict__ n_items,
                 typename KeyOf<MODE>::T* __restrict__ part_keys,
                 typename KeyOf<MODE>::T* __restrict__ part_thr, int P, int Dp, int M,
                 int dsub_any, int Lcap, int kk) {
  using K = typename KeyOf<MODE>::T;
  static_assert(MODE != DMA || NQ * F_LPT <= 32, "one bit a (pair, lane) of a dma tile");
  constexpr int DS = DSUB > 0 ? DSUB : 1;   // the register codeword of a fixed dsub
  const int dsub = DSUB > 0 ? DSUB : dsub_any;
  if ((int)blockIdx.x >= *n_items) return;   // the grid holds the most items there can be
  const int4 item = items[blockIdx.x];
  const int lst = item.x, start = item.y, nq = item.z;
  const int l0 = blockIdx.y * F_TILE, l1 = min(min(fills[lst], Lcap), l0 + F_TILE);
  if (l0 >= l1) return;                      // the list ends before this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Md = M * dsub;

  extern __shared__ __align__(16) unsigned char smem[];
  float* res = reinterpret_cast<float*>(smem);                              // [M][NQ][dsub]
  float* r2s = res + (size_t)NQ * Md;                                       // [M][NQ]
  unsigned short* tabs = reinterpret_cast<unsigned short*>(r2s + NQ * M);  // [4][256][NQ]
  int* hist = reinterpret_cast<int*>(tabs);                                 // [NQ][256]
  unsigned char* crow = reinterpret_cast<unsigned char*>(tabs + 4 * NQ * 256);
  // code rows: thread t copies lanes l0 + 4 t .. l0 + 4 t + 3 of each (a
  // whole tile between the threads), one copy group a row; a row's copy
  // starts F_RING - 2 subspaces before it is read
  const bool copies = l0 + 4 * tid < Lcap;
  const uint8_t* csrc = codes + (size_t)lst * M * Lcap + l0 + 4 * tid;
  const uint32_t cdst = smem_u32(crow) + 4 * tid;
  auto copy_row = [&](int m) {
    if (m < M)
      cp_async4(cdst + (m % F_RING) * F_TILE, copies ? csrc + (size_t)m * Lcap : codes,
                copies ? 4 : 0);
    cp_async_commit();
  };
#pragma unroll
  for (int m = 0; m < F_RING - 2; ++m) copy_row(m);
  __shared__ int pair_of[NQ];
  __shared__ unsigned sel_prefix[NQ];   // the kk-th key's bits of the word walked, found so far
  __shared__ unsigned sel_hi[NQ];       // dma: the kk-th key's score word, once walked
  __shared__ int sel_need[NQ];          // keys still to take under that prefix
  __shared__ int sel_done[NQ];          // the prefix is the threshold
  __shared__ int sel_count[NQ];         // keys written

  if (tid < NQ) {
    pair_of[tid] = tid < nq ? order[start + tid] : 0;
    sel_prefix[tid] = 0u;
    sel_hi[tid] = 0u;
    sel_need[tid] = kk;
    sel_done[tid] = tid < nq ? 0 : 1;
    sel_count[tid] = 0;
  }
  __syncthreads();
  // each pair's residual, one rounded subtraction a coordinate, then its
  // squared norm per subspace; a subspace's slices of the pairs side by side
  const float* cl = cents + (size_t)lst * Dp;
  for (int i = 0; i < nq; ++i) {
    const float* qb = q_rot + (size_t)(pair_of[i] / P) * Dp;
    for (int c = tid; c < Md; c += FT)
      res[((size_t)(c / dsub) * NQ + i) * dsub + c % dsub] = __fsub_rn(qb[c], cl[c]);
  }
  __syncthreads();
  for (int x = tid; x < nq * M; x += FT) {
    const int m = x / nq, i = x - m * nq;
    const float* r = res + ((size_t)m * NQ + i) * dsub;
    if constexpr (DSUB > 0) {
      float v[DSUB];
      load_slice<DSUB>(v, r);
      r2s[m * NQ + i] = nvdb::fma_chain<DSUB>(v, v);
    } else {
      r2s[m * NQ + i] = nvdb::fma_chain_n(r, r, dsub);
    }
  }

  // this thread's lanes of the tile; the lane slots any thread fills
  const int n_slots = (l1 - l0 + FT - 1) / FT;
  int lane_of[F_LPT];
  bool live[F_LPT];
  const int* sid_row = slot_ids + (size_t)lst * Lcap;   // dma only
#pragma unroll
  for (int r = 0; r < F_LPT; ++r) {
    lane_of[r] = l0 + tid + FT * r;
    live[r] = lane_of[r] < l1;
    // dma: a lane below the fill is live if its slot holds a row (a warp's
    // 32 lanes are 128 contiguous bytes of slot ids)
    if constexpr (MODE == DMA) live[r] = live[r] && __ldg(sid_row + lane_of[r]) >= 0;
  }
  float acc[NQ][F_LPT];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int r = 0; r < F_LPT; ++r) acc[i][r] = 0.f;

  // codeword j of subspace m: registers (fixed dsub; two sets, for even and
  // odd subspaces, each loaded two subspaces before its build) or the
  // codebook row
  float w_even[DS], w_odd[DS];
  auto load_codeword = [&](int m, float (&w)[DS]) {
    if constexpr (DSUB > 0) {
      const float* src = cb + ((size_t)m * 256 + tid) * DSUB;
      if constexpr (DSUB % 4 == 0) {
#pragma unroll
        for (int d4 = 0; d4 < DSUB / 4; ++d4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(src) + d4);
          w[4 * d4] = v.x;
          w[4 * d4 + 1] = v.y;
          w[4 * d4 + 2] = v.z;
          w[4 * d4 + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int d = 0; d < DSUB; ++d) w[d] = __ldg(src + d);
      }
    }
  };
  auto build = [&](int m, const float (&w)[DS]) {
    unsigned short* tab = tabs + (m & 3) * NQ * 256;
    const float* wp = w;
    float c2;
    if constexpr (DSUB > 0) {
      c2 = nvdb::fma_chain<DSUB>(w, w);
    } else {
      wp = cb + ((size_t)m * 256 + tid) * dsub;
      c2 = nvdb::fma_chain_n(wp, wp, dsub);
    }
    const float* xs = res + (size_t)m * NQ * dsub;
    const float* r2 = r2s + m * NQ;
    int i = 0;
    if constexpr (NQ >= 4) {
      for (; i + 4 <= nq; i += 4)
        fused_tables<DSUB, NQ, 4>(tab, xs + i * dsub, r2 + i, wp, c2, i, dsub);
    }
    for (; i < nq; ++i) fused_tables<DSUB, NQ, 1>(tab, xs + i * dsub, r2 + i, wp, c2, i, dsub);
  };
  // step m: builds m + 2's tables while m's are looked up, each lane's code
  // read once for the nq pairs; a barrier every second step suffices (a
  // table buffer is read two steps after it is written and written two
  // steps after it is read; a code row's slot is refilled two steps after
  // it is read, and each thread's copies of the rows of the next two steps
  // have landed before the barrier)
  auto step = [&](int m, float (&w)[DS]) {
    copy_row(m + F_RING - 2);
    if (m + 2 < M) {
      build(m + 2, w);
      if (m + 4 < M) load_codeword(m + 4, w);
    }
#if NVDB_ADC_ABLATE != 3
    uint32_t cur[F_LPT] = {};
    const unsigned char* row = crow + (m % F_RING) * F_TILE + tid;
#pragma unroll
    for (int r = 0; r < F_LPT; ++r) {
      if (r >= n_slots) break;
      cur[r] = live[r] ? row[FT * r] : 0u;
    }
    // eight pairs' entries of a lane's code in one load (fewer for the last)
    const unsigned short* ta = tabs + (m & 3) * NQ * 256;
    constexpr int CW = NQ < 8 ? NQ : 8;
#pragma unroll
    for (int i0 = 0; i0 < NQ; i0 += CW) {
      const int rem = nq - i0;
      if (rem <= 0) break;
      if constexpr (CW == 8) {
        if (rem > 4) {
          fused_lookup<NQ, 8>(acc, ta, cur, live, i0, n_slots);
          continue;
        }
      }
      if constexpr (CW >= 4) {
        if (rem > 2) {
          fused_lookup<NQ, 4>(acc, ta, cur, live, i0, n_slots);
          continue;
        }
      }
      if constexpr (CW >= 2) {
        if (rem > 1) {
          fused_lookup<NQ, 2>(acc, ta, cur, live, i0, n_slots);
          continue;
        }
      }
      fused_lookup<NQ, 1>(acc, ta, cur, live, i0, n_slots);
    }
#endif
    if (m & 1) {
      cp_async_wait<F_RING - 4>();
      __syncthreads();
    }
  };
  load_codeword(0, w_even);
  if (M > 1) load_codeword(1, w_odd);
  __syncthreads();   // the residuals' norms are written
  build(0, w_even);
  if (M > 1) build(1, w_odd);
  if (M > 2) load_codeword(2, w_even);
  if (M > 3) load_codeword(3, w_odd);
  cp_async_wait<F_RING - 4>();   // this thread's copies of rows 0 and 1 have landed
  __syncthreads();
  // subspace by subspace, in order, through four table buffers
  for (int m = 0; m < M; m += 2) {
    step(m, w_even);
    if (m + 1 < M) step(m + 1, w_odd);
  }
  cp_async_wait<0>();
  __syncthreads();   // every lookup is done: the buffers become histograms

  // dma: bit i * F_LPT + r drops lane r for pair i (a worse copy of an id
  // the tile holds again)
  uint32_t dropped = 0u;
  // dma: the score word of pair i's key at lane slot r, mono32(score) (0:
  // none); a lane's slot id, read where a key is made (no register holds the
  // ids through the select)
  auto hi_at = [&](int i, int r) -> unsigned {
    return live[r] && !((dropped >> (i * F_LPT + r)) & 1u) ? mono32(-acc[i][r]) : 0u;
  };
  auto lo_at = [&](int r) -> unsigned {
    return (unsigned)__ldcg(sid_row + lane_of[r]) ^ 0x80000000u;
  };
  // the candidate key of pair i at lane slot r (0: none), lo = lo_at(r) for
  // dma. key: mono16(truncated score) << 16 | lane; dma: mono32(score) << 32
  // | (id + 2^31)
  auto key_at = [&](int i, int r, unsigned lo) -> K {
    if constexpr (MODE == DMA) {
      const unsigned hi = hi_at(i, r);
      return hi ? (K)((unsigned long long)hi << 32 | lo) : K(0);
    } else {
      return live[r] ? make_key16(-acc[i][r], lane_of[r]) : K(0);
    }
  };
#if NVDB_ADC_ABLATE == 3 || NVDB_ADC_ABLATE == 4
  // measurement builds: keep the sums alive, select nothing
  float sink = 0.f;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int r = 0; r < F_LPT; ++r) sink += acc[i][r];
  if (sink == -1234.5f) part_keys[0] = K(1);
  return;
#endif
  if constexpr (MODE == DMA) {
    // a tile that holds an id more than once keeps each pair's best copy of
    // it (of equal scores, the first lane's), so that its kk best keys are
    // kk distinct ids; the code ring is free and holds each group's best
    // score word and the first lane holding it, at the group's first lane
    // (an id's copies differ in their score word only)
    int lead[F_LPT];
    bool any = false;
#pragma unroll
    for (int r = 0; r < F_LPT; ++r) {
      lead[r] = -1;
      if (leads != nullptr && live[r]) {
        const int x = leads[(size_t)lst * Lcap + lane_of[r]] - l0;
        lead[r] = (unsigned)x < (unsigned)F_TILE ? x : -1;
      }
      any = any || lead[r] >= 0;
    }
    if (__syncthreads_or(any)) {
      static_assert(F_TILE * 8 <= F_RING * F_TILE, "a group's best score word and first lane");
      unsigned* best = reinterpret_cast<unsigned*>(crow);
      int* first = reinterpret_cast<int*>(best + F_TILE);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (i >= nq) break;
        for (int x = tid; x < F_TILE; x += FT) {
          best[x] = 0u;
          first[x] = 0x7fffffff;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < F_LPT; ++r)
          if (lead[r] >= 0) atomicMax(&best[lead[r]], hi_at(i, r));
        __syncthreads();
#pragma unroll
        for (int r = 0; r < F_LPT; ++r)
          if (lead[r] >= 0 && hi_at(i, r) == best[lead[r]]) atomicMin(&first[lead[r]], lane_of[r]);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < F_LPT; ++r)
          if (lead[r] >= 0 && first[lead[r]] != lane_of[r]) dropped |= 1u << (i * F_LPT + r);
        __syncthreads();
      }
    }
  }
  const int T = gridDim.y;
  const int n_live = l1 - l0;
  if (n_live <= kk) {
    // every live lane is a candidate (part_thr stays 0: no bound)
#pragma unroll
    for (int r = 0; r < F_LPT; ++r) {
      if (!live[r]) continue;
      const unsigned lo = MODE == DMA ? lo_at(r) : 0u;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (i >= nq) break;
        part_keys[((size_t)pair_of[i] * T + blockIdx.y) * kk + lane_of[r] - l0] =
            key_at(i, r, lo);
      }
    }
    return;
  }

  // Radix select of each pair's kk-th key, eight bits a pass from the top
  // of a 32-bit word: histogram the words of the keys that share the prefix
  // found so far, then one warp a pair walks the bins from the top. The key
  // mode's word is its key. The dma mode walks the score word (mono32), and
  // only for a pair whose kk-th score the tile holds more than once (a tie
  // at the threshold) the id word of the keys of that score. Keys are unique
  // (a tile's ids are, once its repeated ids are dropped), so exactly kk keys
  // are at or above the result; a pair with fewer keys than kk takes them all
  // (threshold 0).
  constexpr int WORDS = MODE == DMA ? 2 : 1;
  auto word_at = [&](int i, int r, int w) -> unsigned {
    if constexpr (MODE == DMA) {
      const unsigned hi = hi_at(i, r);
      if (w == 0) return hi;
      return hi != 0u && hi == sel_hi[i] ? lo_at(r) : 0u;
    } else {
      return live[r] ? make_key16(-acc[i][r], lane_of[r]) : 0u;
    }
  };
  bool all = false, ids_walked = false;
  for (int w = 0; w < WORDS && !all; ++w) {
    if (w > 0) {
      // the score word is walked: its bits become the high word of each
      // threshold, and the pairs not done walk the ids of their tied keys
      ids_walked = true;
      if (tid < NQ) {
        sel_hi[tid] = sel_prefix[tid];
        sel_prefix[tid] = 0u;
      }
      __syncthreads();
    }
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int x = tid; x < NQ * 256; x += FT) hist[x] = 0;
      __syncthreads();
      const unsigned hi = shift == 24 ? 0u : 0xffffffffu << (shift + 8);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (i >= nq) break;
        if (sel_done[i]) continue;
        const unsigned pre = sel_prefix[i] & hi;
#pragma unroll
        for (int r = 0; r < F_LPT; ++r) {
          const unsigned k = word_at(i, r, w);
          const bool ok = k != 0u && (k & hi) == pre;
          const unsigned bin = (k >> shift) & 255u;
          const unsigned okm = __ballot_sync(FULL_MASK, ok);
          if (okm == 0u) continue;
          // the lanes in the first one's bin (most, as keys cluster) add at once
          const int ldr = __ffs(okm) - 1;
          const unsigned lb = __shfl_sync(FULL_MASK, bin, ldr);
          const unsigned same = __ballot_sync(FULL_MASK, ok && bin == lb);
          if (lane == ldr) atomicAdd(&hist[i * 256 + lb], __popc(same));
          if (ok && bin != lb) atomicAdd(&hist[i * 256 + bin], 1);
        }
      }
      __syncthreads();
      for (int i = warp; i < nq; i += FW) {
        if (sel_done[i]) continue;
        // lane L holds bins 255 - 8 L .. 248 - 8 L, the top first
        const int* h = hist + i * 256;
        int c[8], sum = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          c[e] = h[255 - 8 * lane - e];
          sum += c[e];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(FULL_MASK, incl, o);
          if (lane >= o) incl += v;
        }
        const int need = sel_need[i];
        if (__shfl_sync(FULL_MASK, incl, 31) < need) {
          // fewer keys than kk (the first pass only): all of them, no bound
          if (lane == 0) sel_done[i] = 1;
          continue;
        }
        const unsigned who = __ballot_sync(FULL_MASK, incl - sum < need && need <= incl);
        if (lane == __ffs(who) - 1) {
          int run = incl - sum, bin = -1, cnt = 0;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (bin < 0 && run + c[e] >= need) {
              bin = 255 - 8 * lane - e;
              cnt = c[e];
            }
            if (bin < 0) run += c[e];
          }
          sel_prefix[i] |= (unsigned)bin << shift;
          sel_need[i] = need - run;
          sel_done[i] = (need - run == cnt || (shift == 0 && w == WORDS - 1)) ? 1 : 0;
        }
      }
      __syncthreads();
      all = true;   // the same shared values in every thread, between barriers
      for (int i = 0; i < nq; ++i) all = all && sel_done[i] != 0;
      if (all) break;
    }
  }
  // each pair's keys at or above its threshold, in any order, and the
  // threshold: the pair's kk-th key, a lower bound of the query's kk-th
  // (dma: the score word's prefix above the id word's, 0 where no pair
  // walked the ids)
  auto thr_of = [&](int i) -> K {
    if constexpr (MODE == DMA) {
      return ids_walked ? (K)((unsigned long long)sel_hi[i] << 32 | sel_prefix[i])
                        : (K)((unsigned long long)sel_prefix[i] << 32);
    } else {
      return (K)sel_prefix[i];
    }
  };
  if (tid < nq) part_thr[(size_t)pair_of[tid] * T + blockIdx.y] = thr_of(tid);
#pragma unroll
  for (int r = 0; r < F_LPT; ++r) {
    const unsigned lo = MODE == DMA && live[r] ? lo_at(r) : 0u;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i >= nq) break;
      const K k = key_at(i, r, lo);
      const bool take = k != K(0) && k >= thr_of(i);
      const unsigned bal = __ballot_sync(FULL_MASK, take);
      if (bal == 0u) continue;
      const int src = __ffs(bal) - 1;
      int base = lane == src ? atomicAdd(&sel_count[i], __popc(bal)) : 0;
      base = __shfl_sync(FULL_MASK, base, src);
      const int pos = base + __popc(bal & ((1u << lane) - 1u));
      if (take && pos < kk)   // kk at most, whatever the input
        part_keys[((size_t)pair_of[i] * T + blockIdx.y) * kk + pos] = k;
    }
  }
}

template <int MODE, int DSUB, int NQ>
cudaError_t launch_fused(const float* q, const float* ce, const float* cb, const uint8_t* codes,
                         const int* sids, const int* leads, const int* fills, const int* order,
                         const int4* items, const int* n_items, void* part, void* thr, int P,
                         int Dp, int M, int dsub, int Lcap, int kk, int U, int T, int dev,
                         cudaStream_t st) {
  using K = typename KeyOf<MODE>::T;
  // the instance's shared-memory allowance, raised on a device only when a
  // call needs more than it was last given there (host time per call)
  static size_t allowed[F_MAX_DEVICES] = {};
  const size_t smem = fused_smem_bytes(NQ, M, dsub);
  if (dev >= F_MAX_DEVICES || smem > allowed[dev]) {
    cudaError_t e = cudaFuncSetAttribute(adc_fused_kernel<MODE, DSUB, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < F_MAX_DEVICES) allowed[dev] = smem;
  }
  adc_fused_kernel<MODE, DSUB, NQ><<<dim3(U, T), FT, smem, st>>>(
      q, ce, cb, codes, sids, leads, fills, order, items, n_items, static_cast<K*>(part),
      static_cast<K*>(thr), P, Dp, M, dsub, Lcap, kk);
  return cudaGetLastError();
}

// The fused key scan is built for chunks of 1, 4, 8, 16 and 32 queries, the
// fused dma scan for 1, 4 and 8 (F_DMA_NQ_MAX; wider chunks are slower for
// the key scan already, and build time doubles with the instances).
constexpr int F_DMA_NQ_MAX = 8;

template <int MODE, int DSUB>
cudaError_t launch_fused_nq(int nq, const float* q, const float* ce, const float* cb,
                            const uint8_t* codes, const int* sids, const int* leads,
                            const int* fills, const int* order, const int4* items,
                            const int* n_items, void* part, void* thr, int P, int Dp, int M,
                            int dsub, int Lcap, int kk, int U, int T, int dev, cudaStream_t st) {
#define NVDB_FUSED_ARGS q, ce, cb, codes, sids, leads, fills, order, items, n_items, part, thr, P, \
                        Dp, M, dsub, Lcap, kk, U, T, dev, st
  switch (nq) {
    case 1: return launch_fused<MODE, DSUB, 1>(NVDB_FUSED_ARGS);
    case 4: return launch_fused<MODE, DSUB, 4>(NVDB_FUSED_ARGS);
    case 8: return launch_fused<MODE, DSUB, 8>(NVDB_FUSED_ARGS);
    default: break;
  }
  if constexpr (MODE == KEY) {
    switch (nq) {
      case 16: return launch_fused<MODE, DSUB, 16>(NVDB_FUSED_ARGS);
      case 32: return launch_fused<MODE, DSUB, 32>(NVDB_FUSED_ARGS);
      default: break;
    }
  }
#undef NVDB_FUSED_ARGS
  return cudaErrorInvalidValue;
}

// The chunk widths the fused scan is built for, the widest first.
constexpr int F_WIDTHS[5] = {32, 16, 8, 4, 1};

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
  int e = launch_partial<DMA>(lut, probes, codes, slot_ids, fills, part_keys, B, P, M, Lcap,
                              nlist, kk, S, stages, tile, st);
  if (e != 0) return e;
  return (int)launch_merge<true>(part_keys, nullptr, out_vals, out_ids, B, kk, S, st);
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
  int e = gathered
              ? launch_partial<GATHER>(lut, probes, codes, slot_ids, fills, part_keys, B, P, M,
                                       Lcap, nlist, kk, S, stages, tile, st)
              : launch_partial<KEY>(lut, probes, codes, slot_ids, fills, part_keys, B, P, M,
                                    Lcap, nlist, kk, S, stages, tile, st);
  if (e != 0) return e;
  return (int)launch_merge_keys(part_keys, nullptr, probes, slot_ids, out_vals, out_ids, B, P,
                                Lcap, kk, S, (P + S - 1) / S, 1, st);
}

// The fused key scan's chunk width: the widest of 32, 16, 8, 4, 1 queries
// at most nq_max whose CTA fits the device's shared memory at M subspaces
// of dsub. Returns a cudaError_t; cudaErrorInvalidConfiguration where not
// even one query fits.
extern "C" int nvdb_adc_fused_plan(int M, int dsub, int nq_max, int* nq) {
  if (M < 1 || dsub < 1 || nq_max < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  for (int w : F_WIDTHS) {
    if (w > nq_max) continue;
    if (fused_smem_bytes(w, M, dsub) + F_STATIC_SMEM <= (size_t)optin) {
      *nq = w;
      return 0;
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

namespace {

// The fused scans' passes on `st` (the entries below): pass 0, pass 1 of
// the mode, then its merge.
template <int MODE>
int fused_entry(const void* q_rot, const void* probes, const void* centroids,
                const void* codebooks, const void* codes, const void* slot_ids,
                const void* leads, const void* fills, void* iscratch, void* part_keys,
                void* out_vals, void* out_ids, int B, int P, int Dp, int M, int dsub, int nlist,
                int Lcap, int kk, int nq, int U, void* stream) {
  using K = typename KeyOf<MODE>::T;
  if (B < 1 || P < 1 || M < 1 || dsub < 1 || (long long)M * dsub > Dp || nlist < 1 ||
      Lcap < 4 || Lcap % 4 != 0 || (MODE == KEY && Lcap > COORD_SPAN) ||
      (long long)P * Lcap >= (1ll << 31) || kk < 1 || kk > MAX_KK || U < 1 ||
      (long long)B * P > 0x7fffffffLL || (MODE == DMA && nq > F_DMA_NQ_MAX))
    return (int)cudaErrorInvalidValue;
  const int T = (Lcap + F_TILE - 1) / F_TILE;
  const long long S = (long long)P * T;
  if (S * (kk + 1) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  // every partial list starts empty and unbounded: the pairs no CTA scans
  // (a dead or out-of-range probe, a tile past the list's end) keep none
  e = cudaMemsetAsync(part_keys, 0, (size_t)B * S * (kk + 1) * sizeof(K), st);
  if (e != cudaSuccess) return (int)e;
  const int BP = B * P;
  int* is = static_cast<int*>(iscratch);
  int* counts = is;
  int* order = is + nlist;
  int* n_items = order + BP;
  int4* items = reinterpret_cast<int4*>(is + nvdb::items_offset(nlist, BP));
  const int* pr = static_cast<const int*>(probes);
  const int* fi = static_cast<const int*>(fills);
  e = nvdb::launch_group(pr, fi, counts, order, items, n_items, nullptr, nullptr, BP, nlist,
                         Lcap, nq, 1, 1, st);
  if (e != cudaSuccess) return (int)e;
  const float* q = static_cast<const float*>(q_rot);
  const float* ce = static_cast<const float*>(centroids);
  const float* cb = static_cast<const float*>(codebooks);
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  const int* si = static_cast<const int*>(slot_ids);
  const int* ld = static_cast<const int*>(leads);
  K* part = static_cast<K*>(part_keys);
  K* thr = part + (size_t)B * S * kk;
#define NVDB_FUSED_ARGS nq, q, ce, cb, cd, si, ld, fi, order, items, n_items, part, thr, P, Dp, \
                        M, dsub, Lcap, kk, U, T, dev, st
  switch (dsub) {
    case 4: e = launch_fused_nq<MODE, 4>(NVDB_FUSED_ARGS); break;
    case 8: e = launch_fused_nq<MODE, 8>(NVDB_FUSED_ARGS); break;
    case 12: e = launch_fused_nq<MODE, 12>(NVDB_FUSED_ARGS); break;
    case 16: e = launch_fused_nq<MODE, 16>(NVDB_FUSED_ARGS); break;
    default: e = launch_fused_nq<MODE, 0>(NVDB_FUSED_ARGS); break;
  }
#undef NVDB_FUSED_ARGS
  if (e != cudaSuccess || NVDB_ADC_ABLATE == 5) return (int)e;
  if constexpr (MODE == DMA) {
    // no leads: every id is held once in the index, and no duplicate pass is needed
    return (int)(leads != nullptr
                     ? launch_merge<true>(part_keys, thr, out_vals, out_ids, B, kk, (int)S, st)
                     : launch_merge<false>(part_keys, thr, out_vals, out_ids, B, kk, (int)S, st));
  } else {
    return (int)launch_merge_keys(part_keys, thr, probes, slot_ids, out_vals, out_ids, B, P,
                                  Lcap, kk, (int)S, 1, T, st);
  }
}

}  // namespace

// The fused key scan: the key mode's result (nvdb_adc_topk_keys on the
// tables of nvdb_adc_tables) with no table in device memory. q_rot [B, Dp]
// f32, probes [B, P] int32, centroids [nlist, Dp] f32, codebooks [M, 256,
// dsub] f32 (M * dsub <= Dp), codes [nlist, M, Lcap] uint8, slot_ids [nlist,
// Lcap] int32 (prefix-packed, unique ids; Lcap a multiple of 4), fills
// [nlist] int32; iscratch the int32 scratch of pass 0 (nvdb::items_offset(nlist, B * P) + 4 U
// ints); part_keys the uint32 scratch of B * P * T * (kk + 1) with T =
// ceil(Lcap / 1024): the partial lists [B, P, T, kk], then each one's
// threshold [B, P, T]; outputs [B, kk]. nq: queries a chunk
// (nvdb_adc_fused_plan), U: pass 1's grid in items (at least the most items
// B * P pairs can make). Returns a cudaError_t (0 on success); the launches
// are asynchronous on `stream`, and nothing is read back.
extern "C" int nvdb_adc_fused_keys(const void* q_rot, const void* probes, const void* centroids,
                                   const void* codebooks, const void* codes,
                                   const void* slot_ids, const void* fills, void* iscratch,
                                   void* part_keys, void* out_vals, void* out_ids, int B, int P,
                                   int Dp, int M, int dsub, int nlist, int Lcap, int kk, int nq,
                                   int U, void* stream) {
  return fused_entry<KEY>(q_rot, probes, centroids, codebooks, codes, slot_ids, nullptr, fills,
                          iscratch, part_keys, out_vals, out_ids, B, P, Dp, M, dsub, nlist,
                          Lcap, kk, nq, U, stream);
}

// The fused dma scan: the dma mode's result (nvdb_adc_topk on the tables of
// nvdb_adc_tables) with no table in device memory. As nvdb_adc_fused_keys,
// but slot_ids may hold holes below a list's fill and an id in several
// lists; leads [nlist, Lcap] int32, for each slot the first lane of its
// 1024-lane tile that holds the same id when the tile holds it more than
// once, else -1 (adc_scan.tile_leads), or null where every id is held once
// in the index (replicas 1; the merge then skips its duplicate pass); no
// bound on Lcap but a multiple of 4; part_keys the uint64 scratch of B * P *
// T * (kk + 1); nq 1, 4 or 8.
extern "C" int nvdb_adc_fused_topk(const void* q_rot, const void* probes, const void* centroids,
                                   const void* codebooks, const void* codes,
                                   const void* slot_ids, const void* leads, const void* fills,
                                   void* iscratch, void* part_keys, void* out_vals, void* out_ids,
                                   int B, int P, int Dp, int M, int dsub, int nlist, int Lcap,
                                   int kk, int nq, int U, void* stream) {
  return fused_entry<DMA>(q_rot, probes, centroids, codebooks, codes, slot_ids, leads, fills,
                          iscratch, part_keys, out_vals, out_ids, B, P, Dp, M, dsub, nlist,
                          Lcap, kk, nq, U, stream);
}
