// The query-major ADC body shared by K3 (stream_select_pq_pairwise.cu) and
// K4 (stream_select_pq.cu).  It replaces the per-slot arithmetic of the
// Pallas kernels fastforward_tpu/ops/stream_kernel_pq.py:191
// (_adc_pairwise_kernel) and :105 (_adc_kernel).  Contract, for every slot s
// of the (n_tiles, cap) grid, with c = cand[s], local = c / qb, qno = c % qb
// and row = tile_idx[s / cap] * r + local:
//
//     out[s] = sum_m lut[qno, m, codes[row, m]]
//     lut[q, m, k] = codebook[m, k, :] . q[m*Ds:(m+1)*Ds]
//
// each LUT entry an fp32 FMA chain over its Ds products in order (codeword
// and query element rounded to bf16 first where the tier says so), the M
// entries then added in fp32 in subspace order.
//
// Why query-major.  ADC shares one lookup table per query across all its
// slots: M*Ks entries (24,576 at PQ(96, 256)), after which a slot costs M
// table reads and adds.  Scoring slot by slot instead re-reads M*Ds codeword
// values and dim query values (6 KB at dim 768) from L2 per slot, ~6.4 GB for
// the 1,048,576 slots of the PQ and OPQ layouts, and that set the time of
// the first forms of K3 and K4.  So the slots are grouped by query on the
// card, each query's table is built once, and a block scores up to
// item_slots slots of one query from its table in shared memory.
//
// The launch sequence (adc_lut_launch), all on the caller's stream:
//   1. zero the per-query counters (cudaMemsetAsync);
//   2. adc_count_kernel: a histogram of qno over the slots, binned per block
//      in shared memory and added to device memory bin by bin;
//   3. adc_scan_kernel (one block): exclusive scans of the counts and of
//      each query's work items, ceil(count / item_slots);
//   4. adc_scatter_kernel: each slot's index into its query's list, ranked
//      per block in shared memory, one range reserved per bin;
//   then, for each group of lut_queries queries (one group at Qb = 512):
//   5. adc_table_kernel: the group's LUTs into the scratch table, one block
//      per (subspace, 8 queries), each thread one codeword dotted with 8
//      queries, so the codebooks leave L2 once per 8 queries;
//   6. adc_score_kernel: one block per work item of the group copies its
//      query's LUT into shared memory and scores the item's slots.
// The grouping is recomputed per call (the layout's plan caches only cand
// and tile_idx), so its time is part of every call's time.
//
// The padding query.  Every padding slot carries qno = qb - 1; at the
// flagship sizes that query owns over half of the slots (~536k of
// 1,048,576).  The count and scatter kernels bin a block's 4,096 slots in
// shared memory (one shared atomic per group of equal queries in a warp
// step) and add each bin to device memory with one atomic, so the padding
// query's counter takes one atomic per block, not one per slot; the
// work-item split cuts its list into pieces of item_slots slots, so ~260
// blocks score it instead of one.  Padding slots are scored like any other
// slot, as the contract says.
//
// The tables.  Each subspace's table is kKsMax = 256 entries wide whatever
// Ks (entries k >= Ks are zero, so any uint8 code stays inside it).  The
// wrapper's scratch holds lut_queries queries' tables (50 MB for Qb = 512
// at PQ(96, 256); the wrapper caps it and the groups come in turn), written
// once and read by each work item of its query: ~770 x 96 KB at the
// flagship sizes, mostly from L2.  Rebuilding the table in every work item
// from the codebooks instead (the first form of this design) read the 786 KB
// of codebooks from L2 per item, ~0.6 GB per call.  A block stages at most
// kLutSubspaces subspaces (96 KB, two blocks per SM); where M exceeds that
// (PQ(384, 256) at dim 768 is 384 KB) it stages and consumes the table in
// chunks of subspaces and carries each slot's partial sum in a register
// across chunks.
//
// Scoring.  One slot per thread (lane-per-slot, no shuffles), kSlotsPerThread
// slots per thread, whose code loads are issued together.  A thread reads
// its slots' code rows with 16-byte loads where M % 16 == 0 and the codes are
// 16-byte aligned (a row starts at row * M), else 4-byte or single-byte
// loads.  The 32 lanes of a warp read 32 random codes of one subspace, so
// their table reads land on random banks (bank = code % 32): about 3.5-way
// conflicts on average.
//
// Bound on the H100: the bytes a call must move are the code rows its
// slots read (M bytes each), the codebooks, queries, cand, tile_idx and out
// (chip_smoke.py's pq_bound, 0.010-0.016 ms at the flagship layouts).  The
// design adds the table's round trip (written once, read per work item),
// the grouping's passes over cand, and the shared-memory table reads.
// Those reads bound the score kernel, the largest of the five: ~100M of
// them per flagship call, each warp's 32 in ~3.5 conflicted wavefronts.
// chip_smoke.py splits one call's time by kernel (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ff {

constexpr int kAdcThreads = 256;
// the score kernel: threads, slots per thread, and slots a block scores at
// most
constexpr int kScoreThreads = 512;
constexpr int kSlotsPerThread = 4;
constexpr int kAdcMaxItemSlots = kScoreThreads * kSlotsPerThread;
constexpr int kKsMax = 256;
constexpr int kLutSubspaces = 96;  // 96 KB of fp32 table per block
constexpr int kTableQueries = 8;  // queries per thread of the table kernel
constexpr int kScanThreads = 1024;
// the grouping kernels: slots per thread and per block, and queries binned
// in shared memory at a time
constexpr int kGroupSlotsPerThread = 16;
constexpr int kGroupSlots = kAdcThreads * kGroupSlotsPerThread;
constexpr int kBins = 2048;
static_assert(kAdcThreads == kKsMax, "a table thread owns one codeword");

typedef unsigned long long u64;

struct AdcArgs {
  const uint8_t* codes;  // (N_pad, m) uint8
  int m;
  const float* codebooks;  // (m, ks, ds) fp32
  int ks, ds;
  const float* q;  // element (d, qno) at q[d * sd + qno * sq]
  long long sd, sq;
  const int* cand;      // (n_slots,) packed local * qb + qno
  const int* tile_idx;  // (n_slots / cap,)
  float* out;           // (n_slots,)
  long long n_slots;
  int cap, qb, r;
  // scratch, qb * 3 + 2 + n_slots words: cursor[qb] | slot_off[qb + 1] |
  // item_off[qb + 1] | order[n_slots]
  u64* scratch;
  int item_slots;       // slots per work item, <= kAdcMaxItemSlots
  long long max_items;  // a bound on the work items of the whole call
  float* lut;           // lut_queries * m * kKsMax fp32
  int lut_queries;
};

namespace adc {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ long long group_slot(int i) {
  return static_cast<long long>(blockIdx.x) * kGroupSlots + i * kAdcThreads +
         threadIdx.x;
}

// The queries of a grouping block's slots (-1 past the end).
__device__ __forceinline__ void load_keys(const int* cand, long long n, int qb,
                                          int* keys) {
#pragma unroll
  for (int i = 0; i < kGroupSlotsPerThread; ++i) {
    const long long s = group_slot(i);
    keys[i] = s < n ? __ldg(cand + s) % qb : -1;
  }
}

// Add one warp step's slots of the window [w0, w0 + kBins) to the block's
// bins, one shared atomic per group of equal queries; returns the slot's
// rank among its bin's slots of the block (unspecified outside the window).
__device__ __forceinline__ unsigned bin_slot(int key, int w0, int width,
                                             unsigned* bins) {
  const int k = key >= w0 && key < w0 + width ? key - w0 : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, k);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  unsigned base = 0;
  if (k >= 0 && lane == leader) base = atomicAdd(bins + k, __popc(peers));
  return __shfl_sync(0xffffffffu, base, leader) +
         __popc(peers & ((1u << lane) - 1));
}

// 2. counts[qno] += the block's slots of qno: the block's kGroupSlots slots
// are binned in shared memory, kBins queries at a time, and each non-empty
// bin goes to device memory with one atomic.
__global__ void __launch_bounds__(kAdcThreads)
    adc_count_kernel(const int* __restrict__ cand, long long n, int qb,
                     u64* __restrict__ counts) {
  __shared__ unsigned bins[kBins];
  int keys[kGroupSlotsPerThread];
  load_keys(cand, n, qb, keys);
  for (int w0 = 0; w0 < qb; w0 += kBins) {
    const int width = min(kBins, qb - w0);
    for (int b = threadIdx.x; b < width; b += kAdcThreads) bins[b] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGroupSlotsPerThread; ++i) bin_slot(keys[i], w0, width, bins);
    __syncthreads();
    for (int b = threadIdx.x; b < width; b += kAdcThreads) {
      if (bins[b]) atomicAdd(counts + w0 + b, static_cast<u64>(bins[b]));
    }
    __syncthreads();  // the next window clears the bins
  }
}

// 3. One block: slot_off and item_off, the exclusive scans of counts and of
// ceil(counts / item_slots), each qb + 1 long; cursor (the counts' storage)
// becomes slot_off[0..qb).
__global__ void __launch_bounds__(kScanThreads)
    adc_scan_kernel(u64* __restrict__ cursor, u64* __restrict__ slot_off,
                    u64* __restrict__ item_off, int qb, int item_slots) {
  __shared__ u64 warp_slots[kScanThreads / 32], warp_items[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (qb + kScanThreads - 1) / kScanThreads;
  const int lo = min(qb, static_cast<int>(threadIdx.x) * per);
  const int hi = min(qb, lo + per);
  u64 slots = 0, items = 0;
  for (int i = lo; i < hi; ++i) {
    const u64 c = cursor[i];
    slots += c;
    items += (c + item_slots - 1) / item_slots;
  }
  // inclusive scan over the warp, then over the warps' totals
  u64 inc_s = slots, inc_i = items;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 s = __shfl_up_sync(0xffffffffu, inc_s, off);
    const u64 t = __shfl_up_sync(0xffffffffu, inc_i, off);
    if (lane >= off) {
      inc_s += s;
      inc_i += t;
    }
  }
  if (lane == 31) {
    warp_slots[warp] = inc_s;
    warp_items[warp] = inc_i;
  }
  __syncthreads();
  u64 run_s = inc_s - slots, run_i = inc_i - items;
  for (int w = 0; w < warp; ++w) {
    run_s += warp_slots[w];
    run_i += warp_items[w];
  }
  for (int i = lo; i < hi; ++i) {
    const u64 c = cursor[i];
    slot_off[i] = run_s;
    item_off[i] = run_i;
    cursor[i] = run_s;
    run_s += c;
    run_i += (c + item_slots - 1) / item_slots;
  }
  if (threadIdx.x == kScanThreads - 1) {  // its run ends at the totals
    slot_off[qb] = run_s;
    item_off[qb] = run_i;
  }
}

// 4. order[cursor[qno]++] = s: the block ranks its slots within their
// bins in shared memory, reserves each non-empty bin's range of its query's
// list with one atomic, and writes its slots there.  The order within a
// query's list varies from run to run; no slot's score depends on it.
__global__ void __launch_bounds__(kAdcThreads)
    adc_scatter_kernel(const int* __restrict__ cand, long long n, int qb,
                       u64* __restrict__ cursor, u64* __restrict__ order) {
  __shared__ unsigned bins[kBins];
  __shared__ u64 base[kBins];
  int keys[kGroupSlotsPerThread];
  unsigned rank[kGroupSlotsPerThread];
  load_keys(cand, n, qb, keys);
  for (int w0 = 0; w0 < qb; w0 += kBins) {
    const int width = min(kBins, qb - w0);
    for (int b = threadIdx.x; b < width; b += kAdcThreads) bins[b] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGroupSlotsPerThread; ++i) {
      rank[i] = bin_slot(keys[i], w0, width, bins);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < width; b += kAdcThreads) {
      if (bins[b]) base[b] = atomicAdd(cursor + w0 + b, static_cast<u64>(bins[b]));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGroupSlotsPerThread; ++i) {
      if (keys[i] >= w0 && keys[i] < w0 + width) {
        order[base[keys[i] - w0] + rank[i]] = static_cast<u64>(group_slot(i));
      }
    }
    __syncthreads();  // the next window clears the bins
  }
}

// 5. lut[(q - g0) * m + sub][k] for the queries [g0, g1) of one group: block
// (sub, query tile), thread k holds codeword k of subspace sub and dots it
// with up to kTableQueries queries (fp32 FMAs in element order); entries
// k >= ks are zero.
template <bool kRoundCodewords, bool kRoundQuery>
__global__ void __launch_bounds__(kAdcThreads)
    adc_table_kernel(AdcArgs a, int g0, int g1) {
  const int sub = blockIdx.x, k = threadIdx.x;
  const int q0 = g0 + blockIdx.y * kTableQueries;
  float acc[kTableQueries];
#pragma unroll
  for (int j = 0; j < kTableQueries; ++j) acc[j] = 0.0f;
  if (k < a.ks) {
    const float* cw =
        a.codebooks + (static_cast<long long>(sub) * a.ks + k) * a.ds;
    const float* qs[kTableQueries];
#pragma unroll
    for (int j = 0; j < kTableQueries; ++j) {
      // queries past the group read the last one and are not written
      qs[j] = a.q + static_cast<long long>(min(q0 + j, g1 - 1)) * a.sq +
              static_cast<long long>(sub) * a.ds * a.sd;
    }
    const bool vec4 = (a.ds & 3) == 0 && a.sd == 1 && (a.sq & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(a.codebooks) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;
    if (vec4) {  // 16-byte loads of codeword and queries
      for (int d = 0; d < a.ds; d += 4) {
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(cw + d));
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int j = 0; j < kTableQueries; ++j) {
          const float4 x4 = __ldg(reinterpret_cast<const float4*>(qs[j] + d));
          const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            acc[j] = fmaf(kRoundCodewords ? round_bf16(w[t]) : w[t],
                          kRoundQuery ? round_bf16(x[t]) : x[t], acc[j]);
          }
        }
      }
    } else {
      for (int d = 0; d < a.ds; ++d) {
        float w = __ldg(cw + d);
        if (kRoundCodewords) w = round_bf16(w);
        const long long off = d * a.sd;
#pragma unroll
        for (int j = 0; j < kTableQueries; ++j) {
          float x = __ldg(qs[j] + off);
          if (kRoundQuery) x = round_bf16(x);
          acc[j] = fmaf(w, x, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTableQueries; ++j) {
    if (q0 + j < g1) {
      a.lut[((static_cast<long long>(q0 + j - g0)) * a.m + sub) * kKsMax + k] =
          acc[j];
    }
  }
}

// Add the table entries of subspaces [m0, m0 + mc) of each slot's code row
// to its sum, in subspace order; the loads of all slots go out together
// (kVec bytes each).
template <int kVec>
__device__ __forceinline__ void add_rows(const uint8_t* const* rows, int m0,
                                         const float* lut, int mc,
                                         float* acc) {
  for (int g = 0; g < mc; g += kVec) {
    if (kVec == 16) {
      uint4 v[kSlotsPerThread];
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        v[i] = __ldg(reinterpret_cast<const uint4*>(rows[i] + m0 + g));
      }
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        const unsigned w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          acc[i] += lut[(g + b) * kKsMax + ((w[b >> 2] >> (8 * (b & 3))) & 0xffu)];
        }
      }
    } else if (kVec == 4) {
      unsigned v[kSlotsPerThread];
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        v[i] = __ldg(reinterpret_cast<const unsigned*>(rows[i] + m0 + g));
      }
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[i] += lut[(g + b) * kKsMax + ((v[i] >> (8 * b)) & 0xffu)];
        }
      }
    } else {
      unsigned v[kSlotsPerThread];
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) v[i] = __ldg(rows[i] + m0 + g);
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) acc[i] += lut[g * kKsMax + v[i]];
    }
  }
}

// 6. One block per work item of the queries [g0, g1): the item's query, its
// table staged in chunks of mc subspaces, and the scores of its slots.
// Blocks past the group's last item leave.
template <int kVec>
__global__ void __launch_bounds__(kScoreThreads)
    adc_score_kernel(AdcArgs a, const u64* __restrict__ slot_off,
                     const u64* __restrict__ item_off,
                     const u64* __restrict__ order, int g0, int g1, int mc) {
  extern __shared__ __align__(16) float lut[];  // mc * kKsMax
  const long long item = static_cast<long long>(item_off[g0]) + blockIdx.x;
  if (item >= static_cast<long long>(item_off[g1])) return;
  // the query whose items hold this one: item_off[lo] <= item < item_off[lo+1]
  int lo = g0, hi = g1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(item_off[mid]) <= item) lo = mid; else hi = mid;
  }
  const long long first = static_cast<long long>(slot_off[lo]) +
                          (item - static_cast<long long>(item_off[lo])) *
                              a.item_slots;
  const int n = static_cast<int>(
      min(static_cast<long long>(a.item_slots),
          static_cast<long long>(slot_off[lo + 1]) - first));

  // each thread's slots; a thread short of slots scores code row 0 for
  // nothing and writes no result
  float acc[kSlotsPerThread];
  const uint8_t* rows[kSlotsPerThread];
  long long slot[kSlotsPerThread];
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    acc[i] = 0.0f;
    rows[i] = a.codes;
    slot[i] = -1;
    const int j = threadIdx.x + i * kScoreThreads;
    if (j < n) {
      const long long s = static_cast<long long>(order[first + j]);
      const int c = __ldg(a.cand + s);
      const long long row =
          static_cast<long long>(__ldg(a.tile_idx + s / a.cap)) * a.r + c / a.qb;
      rows[i] = a.codes + row * a.m;
      slot[i] = s;
    }
  }

  const float4* table = reinterpret_cast<const float4*>(
      a.lut + static_cast<long long>(lo - g0) * a.m * kKsMax);
  float4* staged = reinterpret_cast<float4*>(lut);
  constexpr int kCopy = 4;  // float4 loads in flight per thread
  for (int m0 = 0; m0 < a.m; m0 += mc) {
    const int mcur = min(mc, a.m - m0);
    const int n4 = mcur * (kKsMax / 4);
    const float4* src = table + static_cast<long long>(m0) * (kKsMax / 4);
    __syncthreads();  // the previous chunk's reads are done
    for (int e = threadIdx.x; e < n4; e += kCopy * kScoreThreads) {
      float4 v[kCopy];
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        if (e + u * kScoreThreads < n4) v[u] = __ldg(src + e + u * kScoreThreads);
      }
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        if (e + u * kScoreThreads < n4) staged[e + u * kScoreThreads] = v[u];
      }
    }
    __syncthreads();
    add_rows<kVec>(rows, m0, lut, mcur, acc);
  }
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    if (slot[i] >= 0) a.out[slot[i]] = acc[i];
  }
}

template <int kVec>
cudaError_t launch_score(const AdcArgs& a, const u64* slot_off,
                         const u64* item_off, const u64* order, int g0,
                         int g1, int mc, cudaStream_t stream) {
  const int smem = mc * kKsMax * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      adc_score_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  adc_score_kernel<kVec>
      <<<static_cast<unsigned>(a.max_items), kScoreThreads, smem, stream>>>(
          a, slot_off, item_off, order, g0, g1, mc);
  return cudaGetLastError();
}

}  // namespace adc

// Run the steps for one call; returns the first failing step's
// cudaError_t (0 on success).  The tier is the pair of rounding flags.
template <bool kRoundCodewords, bool kRoundQuery>
cudaError_t adc_lut_launch(const AdcArgs& a, cudaStream_t stream) {
  if (a.n_slots <= 0) return cudaSuccess;
  if (a.item_slots <= 0 || a.item_slots > kAdcMaxItemSlots || a.qb <= 0 ||
      a.ks > kKsMax || a.m <= 0 || a.max_items <= 0 ||
      a.max_items > 0x7fffffffLL || a.lut_queries <= 0) {
    return cudaErrorInvalidValue;
  }
  u64* cursor = a.scratch;
  u64* slot_off = cursor + a.qb;
  u64* item_off = slot_off + a.qb + 1;
  u64* order = item_off + a.qb + 1;
  const unsigned grid =
      static_cast<unsigned>((a.n_slots + kGroupSlots - 1) / kGroupSlots);

  cudaError_t err = cudaMemsetAsync(cursor, 0, sizeof(u64) * a.qb, stream);
  if (err != cudaSuccess) return err;
  adc::adc_count_kernel<<<grid, kAdcThreads, 0, stream>>>(a.cand, a.n_slots,
                                                          a.qb, cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  adc::adc_scan_kernel<<<1, kScanThreads, 0, stream>>>(cursor, slot_off,
                                                       item_off, a.qb,
                                                       a.item_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  adc::adc_scatter_kernel<<<grid, kAdcThreads, 0, stream>>>(
      a.cand, a.n_slots, a.qb, cursor, order);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // subspaces per staged chunk: all of them, or kLutSubspaces (a multiple of
  // 16, so every chunk starts on a 16-byte boundary of the code row)
  const int mc = a.m < kLutSubspaces ? a.m : kLutSubspaces;
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.codes);
  const int vec = a.m % 16 == 0 && base % 16 == 0 ? 16
                  : a.m % 4 == 0 && base % 4 == 0 ? 4
                                                  : 1;
  for (int g0 = 0; g0 < a.qb; g0 += a.lut_queries) {
    const int g1 = min(a.qb, g0 + a.lut_queries);
    const dim3 tables(a.m, (g1 - g0 + kTableQueries - 1) / kTableQueries);
    adc::adc_table_kernel<kRoundCodewords, kRoundQuery>
        <<<tables, kAdcThreads, 0, stream>>>(a, g0, g1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = vec == 16 ? adc::launch_score<16>(a, slot_off, item_off, order, g0, g1, mc, stream)
          : vec == 4 ? adc::launch_score<4>(a, slot_off, item_off, order, g0, g1, mc, stream)
                     : adc::launch_score<1>(a, slot_off, item_off, order, g0, g1, mc, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace ff
