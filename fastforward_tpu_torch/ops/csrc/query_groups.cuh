// The grouping of a streamed layout's slots by query, shared by the
// query-major kernels: K1 and K2 (dense_dot.cuh) and K3 and K4
// (adc_lut.cuh).  A slot s of the (n_tiles, cap) grid packs
// c = cand[s] = local * qb + qno; grouping lists every query's slots and
// cuts each list into work items of at most item_slots slots, so that a
// block can hold one query (its vector, or its lookup table) for a whole
// item and a slot then costs only its row.
//
// The launch sequence (group_slots), all on the caller's stream:
//   1. zero the per-query counters and offsets (cudaMemsetAsync);
//   2. count_kernel: a histogram of qno over the slots, binned per block in
//      shared memory and added to device memory bin by bin; the block that
//      finishes last then takes the exclusive scans of the counts and of
//      each query's work items, ceil(count / item_slots);
//   3. scatter_kernel: each slot's cand value and index into its query's
//      list, ranked per block in shared memory, one range reserved per bin.
// The scoring kernel then runs one block per work item and finds its query
// and slots with find_item, a search by the whole block (two rounds of
// loads at Qb = 512 instead of nine dependent ones).  The grouping is
// recomputed per call (the layout's plan caches only cand and tile_idx),
// so its time is part of every call's time, and each launch it saves is
// host time saved on every call.
//
// The padding query.  Every padding slot carries qno = qb - 1; at the
// flagship sizes that query owns over half of the slots (~536k of
// 1,048,576).  The count and scatter kernels bin a block's 2,048 slots in
// shared memory (one shared atomic per group of equal queries in a warp
// step) and add each bin to device memory with one atomic, so the padding
// query's counter takes one atomic per block, not one per slot; the
// work-item split cuts its list into pieces of item_slots slots, so many
// blocks score it instead of one.  Queries are binned kBins at a time, so
// any qb runs (more than kBins queries take several windows).
//
// Scratch, 3 * qb + 2 + n_slots 64-bit words (the wrapper allocates it):
//   cursor[qb] | slot_off[qb + 1] | item_off[qb + 1] | order[n_slots].
// An entry of order holds the slot's cand value in its high 32 bits and
// its index in the low 32 (a call takes fewer than 2^32 slots), so that a
// scoring kernel finds a slot's row with one load of its list and one of
// tile_idx.  The order within a query's list varies from run to run; no
// slot's score depends on it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ff {

typedef unsigned long long u64;

namespace groups {

constexpr int kThreads = 256;
// slots per thread and per block, and queries binned in shared memory at a
// time
constexpr int kGroupSlotsPerThread = 8;
constexpr int kSlots = kThreads * kGroupSlotsPerThread;
constexpr int kBins = 2048;

// The scratch's four arrays.
struct Lists {
  u64* cursor;    // per query: its count, then the next free place
  u64* slot_off;  // qb + 1: where each query's list starts in order
  u64* item_off;  // qb + 1: each query's first work item
  u64* order;     // n_slots: cand << 32 | slot, query by query
};

// The halves of an order entry.
__device__ __forceinline__ long long entry_slot(u64 e) {
  return static_cast<long long>(e & 0xffffffffu);
}
__device__ __forceinline__ int entry_cand(u64 e) {
  return static_cast<int>(e >> 32);
}

inline Lists lists(u64* scratch, int qb) {
  Lists l;
  l.cursor = scratch;
  l.slot_off = l.cursor + qb;
  l.item_off = l.slot_off + qb + 1;
  l.order = l.item_off + qb + 1;
  return l;
}

__device__ __forceinline__ long long block_slot(int i) {
  return static_cast<long long>(blockIdx.x) * kSlots + i * kThreads +
         threadIdx.x;
}

// The cand values and queries of a block's slots (query -1 past the end).
__device__ __forceinline__ void load_keys(const int* cand, long long n, int qb,
                                          int* values, int* keys) {
#pragma unroll
  for (int i = 0; i < kGroupSlotsPerThread; ++i) {
    const long long s = block_slot(i);
    values[i] = s < n ? __ldg(cand + s) : 0;
    keys[i] = s < n ? values[i] % qb : -1;
  }
}

// Add one warp step's slots of the window [w0, w0 + width) to the block's
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

// Exclusive scans of the counts (cursor) and of ceil(counts / item_slots)
// into slot_off and item_off, each qb + 1 long, by one block of kThreads;
// cursor becomes slot_off[0..qb).  The counts are read from L2, where the
// other blocks' atomics left them.
__device__ __forceinline__ void scan_counts(u64* cursor, u64* slot_off,
                                            u64* item_off, int qb,
                                            int item_slots) {
  __shared__ u64 warp_slots[kThreads / 32], warp_items[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (qb + kThreads - 1) / kThreads;
  const int lo = min(qb, static_cast<int>(threadIdx.x) * per);
  const int hi = min(qb, lo + per);
  u64 slots = 0, items = 0;
  for (int i = lo; i < hi; ++i) {
    const u64 c = __ldcg(cursor + i);
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
    const u64 c = __ldcg(cursor + i);
    slot_off[i] = run_s;
    item_off[i] = run_i;
    cursor[i] = run_s;
    run_s += c;
    run_i += (c + item_slots - 1) / item_slots;
  }
  if (threadIdx.x == kThreads - 1) {  // its run ends at the totals
    slot_off[qb] = run_s;
    item_off[qb] = run_i;
  }
}

// 2. counts[qno] += the block's slots of qno: the block's kSlots slots are
// binned in shared memory, kBins queries at a time, and each non-empty bin
// goes to device memory with one atomic.  Each block then takes a ticket
// (item_off[qb], zero until the scan writes the total there); the last one
// scans.
__global__ void __launch_bounds__(kThreads)
    count_kernel(const int* __restrict__ cand, long long n, int qb,
                 int item_slots, Lists l) {
  __shared__ unsigned bins[kBins];
  __shared__ bool last;
  int values[kGroupSlotsPerThread], keys[kGroupSlotsPerThread];
  load_keys(cand, n, qb, values, keys);
  for (int w0 = 0; w0 < qb; w0 += kBins) {
    const int width = min(kBins, qb - w0);
    for (int b = threadIdx.x; b < width; b += kThreads) bins[b] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGroupSlotsPerThread; ++i) bin_slot(keys[i], w0, width, bins);
    __syncthreads();
    for (int b = threadIdx.x; b < width; b += kThreads) {
      if (bins[b]) atomicAdd(l.cursor + w0 + b, static_cast<u64>(bins[b]));
    }
    __syncthreads();  // the next window clears the bins
  }
  __threadfence();  // this block's counts before its ticket
  if (threadIdx.x == 0) {
    last = atomicAdd(l.item_off + qb, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    scan_counts(l.cursor, l.slot_off, l.item_off, qb, item_slots);
  }
}

// 3. order[cursor[qno]++] = cand[s] << 32 | s: the block ranks its slots
// within their bins in shared memory, reserves each non-empty bin's range of
// its query's list with one atomic, and writes its slots there.
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* __restrict__ cand, long long n, int qb,
                   u64* __restrict__ cursor, u64* __restrict__ order) {
  __shared__ unsigned bins[kBins];
  __shared__ u64 base[kBins];
  int values[kGroupSlotsPerThread], keys[kGroupSlotsPerThread];
  unsigned rank[kGroupSlotsPerThread];
  load_keys(cand, n, qb, values, keys);
  for (int w0 = 0; w0 < qb; w0 += kBins) {
    const int width = min(kBins, qb - w0);
    for (int b = threadIdx.x; b < width; b += kThreads) bins[b] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGroupSlotsPerThread; ++i) {
      rank[i] = bin_slot(keys[i], w0, width, bins);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < width; b += kThreads) {
      if (bins[b]) base[b] = atomicAdd(cursor + w0 + b, static_cast<u64>(bins[b]));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGroupSlotsPerThread; ++i) {
      if (keys[i] >= w0 && keys[i] < w0 + width) {
        order[base[keys[i] - w0] + rank[i]] =
            static_cast<u64>(static_cast<unsigned>(values[i])) << 32 |
            static_cast<u64>(block_slot(i));
      }
    }
    __syncthreads();  // the next window clears the bins
  }
}

// One work item: its query, and its n slots at order[first .. first + n).
struct Item {
  int q;
  long long first;
  int n;
};

// Work item item_off[g0] + rel of the queries [g0, g1); false past their
// last item.  Called by every thread of the block alike.  The item's query
// is the last q with item_off[q] <= item: each round, the threads test
// blockDim.x evenly spaced candidates at once and the range shrinks to the
// gap after the last that passes.
__device__ __forceinline__ bool find_item(const u64* __restrict__ slot_off,
                                          const u64* __restrict__ item_off,
                                          int g0, int g1, long long rel,
                                          int item_slots, Item* it) {
  __shared__ int found;
  const long long item = static_cast<long long>(item_off[g0]) + rel;
  if (item >= static_cast<long long>(item_off[g1])) return false;
  int lo = g0, hi = g1;  // item_off[lo] <= item < item_off[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + blockDim.x - 1) / blockDim.x;
    const int b = lo + static_cast<int>(threadIdx.x) * step;
    if (threadIdx.x == 0) found = lo;
    __syncthreads();
    if (b > lo && b < hi && static_cast<long long>(item_off[b]) <= item) {
      atomicMax(&found, b);
    }
    __syncthreads();
    lo = found;
    hi = min(hi, lo + step);
    __syncthreads();  // every thread has read found before the next round
  }
  it->q = lo;
  it->first = static_cast<long long>(slot_off[lo]) +
              (item - static_cast<long long>(item_off[lo])) * item_slots;
  it->n = static_cast<int>(
      min(static_cast<long long>(item_slots),
          static_cast<long long>(slot_off[lo + 1]) - it->first));
  return true;
}

}  // namespace groups

// Steps 1-3 for n slots over qb queries; returns the first failing step's
// cudaError_t (0 on success).
inline cudaError_t group_slots(const int* cand, long long n, int qb,
                               int item_slots, const groups::Lists& l,
                               cudaStream_t stream) {
  if (n > 0xffffffffLL) return cudaErrorInvalidValue;
  const unsigned grid =
      static_cast<unsigned>((n + groups::kSlots - 1) / groups::kSlots);
  // the counters, the offsets and the scan's ticket (item_off[qb])
  cudaError_t err =
      cudaMemsetAsync(l.cursor, 0, sizeof(u64) * (3 * qb + 2), stream);
  if (err != cudaSuccess) return err;
  groups::count_kernel<<<grid, groups::kThreads, 0, stream>>>(
      cand, n, qb, item_slots, l);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  groups::scatter_kernel<<<grid, groups::kThreads, 0, stream>>>(
      cand, n, qb, l.cursor, l.order);
  return cudaGetLastError();
}

}  // namespace ff
