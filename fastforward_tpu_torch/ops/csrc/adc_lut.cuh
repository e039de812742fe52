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
// Two routes, chosen per query on the card.  ADC can share one lookup table
// per query across all its slots: M * width entries (24,576 at PQ(96,
// 256)), built once, after which a slot costs M table reads and adds.  But
// the table costs the same whatever the query's slot count: its entries
// are computed, written to scratch and staged into shared memory by every
// work item of the query.  Scoring slot by slot instead costs each slot M
// codeword reads (Ds * 4 bytes each, through L2) and M * Ds FMAs, and
// nothing per query.  So the slots are first grouped by query on the card
// (query_groups.cuh), and a query with fewer than slot_limit slots takes
// the slot-wise route, every other query the table route.  slot_limit
// comes from the wrapper: stream_kernel_pq.adc_slot_limit, a cost model of
// the two routes calibrated on the H100 (PERF.md), 0 to force tables, more
// than the call's slots to force slot-wise scoring.  At the flagship
// layouts (about 1,000 slots a query over Ks = 256) every real query takes
// tables; on the hybrid tier's tail blocks (about 70 slots a query) the
// real queries are scored slot-wise and only the padding query Qb - 1,
// with tens of thousands of slots, builds a table; where one subspace's
// table exceeds what a block stages (Ks > 24,576) a table entry costs a
// read through L2 like a codeword does, and every query is scored
// slot-wise.  Both routes compute each entry with the same FMA chain and
// add the entries in the same order, so a slot's score is the same bits on
// either route.
//
// The launch sequence (adc_lut_launch), all on the caller's stream: the
// grouping of query_groups.cuh (a memset and the count and scatter
// kernels: each query's slots listed, the table-route queries' lists cut
// into work items of item_slots slots, the padding query into many), then
//   4. adc_slot_kernel (where slot_limit > 0): the grouped order in chunks
//      of positions, at most kSlotBlocksPerSm blocks an SM; a chunk without
//      a slot-wise query is skipped, and where the grouping's scan found
//      none (an empty span) every block leaves at once;
// then, for each group of lut_queries queries (one group at Qb = 512 and
// width 256), unless every query is slot-wise:
//   5. adc_table_kernel: the group's LUTs into the scratch table, one block
//      per (kTableSubs subspaces, 8 queries), each thread one codeword
//      dotted with 8 queries, so the codebooks leave L2 once per 8 queries;
//      a block whose 8 queries take no table leaves at once;
//   6. adc_score_kernel: one block per work item of the group copies its
//      query's LUT into shared memory and scores the item's slots.
// Padding slots are scored like any other slot, as the contract says.
//
// The tables.  Each subspace's table is `width` entries wide: 256 for
// uint8 codes whatever Ks (entries k >= Ks are zero, so any uint8 code stays
// inside it), Ks rounded up to a multiple of 4 for uint16 and uint32 codes
// (the float4 staging).  The wrapper's scratch holds lut_queries queries'
// tables (50 MB for Qb = 512 at PQ(96, 256); the wrapper caps it and the
// groups come in turn: at PQ(96, 1024) a query's table is 393 KB, 170 of
// them a group), written once and read by each work item of its query,
// mostly from L2.  A block stages at most kLutBytes (96 KB, two blocks per
// SM): 96 subspaces at width 256, 24 at width 1024; where M exceeds that
// (PQ(384, 256) at dim 768 is 384 KB) it stages and consumes the table in
// chunks of subspaces and carries each slot's partial sum in a register
// across chunks.  Where one subspace's table alone exceeds kLutBytes the
// score kernel reads the table from global memory (L2) instead of staging
// it (only a forced table route or a query past slot_limit gets there).
//
// Table-route scoring.  One slot per thread (lane-per-slot, no shuffles),
// kSlotsPerThread slots per thread, whose code loads are issued together.
// Codes are uint8, uint16 or uint32.  A thread reads its slots' code rows
// with 16-byte loads (16, 8 or 4 codes) where the row's bytes and the
// staged chunk divide into them and the codes are 16-byte aligned (a row
// starts at row * M), else 4-byte loads (4 or 2 codes), else one code at a
// time.  The 32 lanes of a warp read 32 random codes of one subspace, so
// their table reads land on random banks (bank = code % 32): about 3.5-way
// conflicts on average.
//
// Slot-wise scoring.  Neighbouring lanes take neighbouring positions of
// the grouped order, so a warp holds consecutive slots of mostly one query
// (a chunk crosses query boundaries, so short queries still fill its
// lanes) and their loads of the query's subvector broadcast.  A slot's
// lanes load its code row as the table route does (16/4/1-byte loads),
// then for each subspace read the slot's codeword (16-byte loads where Ds
// % 4 == 0, through L1/L2: the codebooks of PQ(96, 256) and PQ(96, 1024),
// 786 KB and 3.1 MB, stay in L2; of PQ(96, 32768), 100 MB, a call reads
// only the codewords its slots use) and the query's, and take the FMA
// chain.  A warp's codeword loads are gathers, one L1 wavefront per
// distinct line, so at Ds = 8 two lanes share a slot and each loads 16 of
// its 32 bytes (one load instruction per 16 codewords, not two per 32).
// One slot per lane measured faster than two or four (PERF.md).
//
// Bound on the H100: the bytes a call must move are the code rows its
// slots read (M codes each), the codewords they use, queries, cand,
// tile_idx and out (chip_smoke.py's pq_bound, which charges a query
// min(Ks, its slots) codewords of arithmetic a subspace, the cheaper
// route).  The table route adds the table's round trip and the
// shared-memory table reads, ~100M of them per flagship call, each warp's
// 32 in ~3.5 conflicted wavefronts, which bound the score kernel; the
// slot-wise route adds the codeword reads of repeated codes (each slot
// reads M * Ds * 4 bytes from L2, 3 KB at PQ(96, *)), which bound it.
// Both add the grouping's passes over cand.  chip_smoke.py splits one
// call's time by kernel and times both routes forced beside the chosen
// ones (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "query_groups.cuh"

namespace ff {

constexpr int kAdcThreads = 256;
// the score kernel: threads, slots per thread, and slots a block scores at
// most
constexpr int kScoreThreads = 512;
constexpr int kSlotsPerThread = 4;
constexpr int kAdcMaxItemSlots = kScoreThreads * kSlotsPerThread;
// the width of a uint8 code's table, and the table bytes a block stages
constexpr int kU8Width = 256;
constexpr int kLutBytes = 96 * 1024;
constexpr int kTableQueries = 8;  // queries per thread of the table kernel
// subspaces a block of the table kernel builds in turn (the kernel's body
// in this loop measured 36 us at the flagship PQ(96, 256), against 44 us
// written without it; 2 and 4 measured no faster: PERF.md)
constexpr int kTableSubs = 1;
// the slot-wise kernel: threads a block, and blocks an SM (at most one a
// chunk of positions); each block walks the chunks gridDim.x apart
constexpr int kSlotThreads = 256;
constexpr int kSlotBlocksPerSm = 8;

struct AdcArgs {
  const void* codes;  // (N_pad, m) uint8, uint16 or uint32
  int code_bytes;     // 1, 2 or 4
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
  u64* scratch;         // the grouping's, 3 * qb + 4 + n_slots words
  int item_slots;       // slots per work item, <= kAdcMaxItemSlots
  long long max_items;  // a bound on the work items of the whole call
  float* lut;           // lut_queries * m * width fp32
  int lut_queries;
  int width;  // entries of one subspace's table: 256 for uint8 codes, else
              // Ks rounded up to a multiple of 4
  long long slot_limit;  // queries with fewer slots are scored slot-wise
};

namespace adc {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Codewords and queries read with 16-byte loads.
__host__ __device__ __forceinline__ bool vec4_ok(const AdcArgs& a) {
  return (a.ds & 3) == 0 && a.sd == 1 && (a.sq & 3) == 0 &&
         (reinterpret_cast<uintptr_t>(a.codebooks) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;
}

// Four more products of a codeword with a query subvector on the FMA chain
// `e`, in element order, each element rounded to bf16 first where the tier
// says so.
template <bool kRoundCodewords, bool kRoundQuery>
__device__ __forceinline__ float chain4(float4 w4, float4 x4, float e) {
  const float w[4] = {w4.x, w4.y, w4.z, w4.w};
  const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    e = fmaf(kRoundCodewords ? round_bf16(w[t]) : w[t],
             kRoundQuery ? round_bf16(x[t]) : x[t], e);
  }
  return e;
}

// 5. lut[(q - g0) * m + sub][k] for the table-route queries of [g0, g1):
// block (subspace tile, query tile, codeword tile) builds kTableSubs
// subspaces in turn; thread k holds codeword k of a subspace and dots it
// with up to kTableQueries queries (fp32 FMAs in element order); entries
// k >= ks are zero.  A block none of whose queries takes the table route
// leaves.
template <bool kRoundCodewords, bool kRoundQuery>
__global__ void __launch_bounds__(kAdcThreads)
    adc_table_kernel(AdcArgs a, const u64* __restrict__ slot_off, int g0, int g1) {
  const int k = blockIdx.z * kAdcThreads + threadIdx.x;
  const int q0 = g0 + blockIdx.y * kTableQueries;
  // bit j: query q0 + j takes the table route (route()): lanes 0-8 of each
  // warp read the offsets slot_off[q0 .. q0 + 8] (slot_off[g1] at most)
  const int lane = threadIdx.x & 31;
  const u64 first = __ldg(slot_off + min(q0 + min(lane, kTableQueries), g1));
  const u64 n = __shfl_down_sync(0xffffffffu, first, 1) - first;
  const unsigned table = __ballot_sync(
      0xffffffffu, lane < kTableQueries && q0 + lane < g1 && n > 0 &&
                       n >= static_cast<u64>(a.slot_limit));
  if (k >= a.width || table == 0) return;
  const float* qs[kTableQueries];
#pragma unroll
  for (int j = 0; j < kTableQueries; ++j) {
    // queries past the group read the last one and are not written
    qs[j] = a.q + static_cast<long long>(min(q0 + j, g1 - 1)) * a.sq;
  }
  const bool vec4 = vec4_ok(a);
  const int sub_end = min(a.m, static_cast<int>(blockIdx.x + 1) * kTableSubs);
  for (int sub = blockIdx.x * kTableSubs; sub < sub_end; ++sub) {
    const long long sub_x = static_cast<long long>(sub) * a.ds * a.sd;
    float acc[kTableQueries];
#pragma unroll
    for (int j = 0; j < kTableQueries; ++j) acc[j] = 0.0f;
    if (k < a.ks) {
      const float* cw =
          a.codebooks + (static_cast<long long>(sub) * a.ks + k) * a.ds;
      if (vec4) {  // 16-byte loads of codeword and queries
        for (int d = 0; d < a.ds; d += 4) {
          const float4 w4 = __ldg(reinterpret_cast<const float4*>(cw + d));
#pragma unroll
          for (int j = 0; j < kTableQueries; ++j) {
            acc[j] = chain4<kRoundCodewords, kRoundQuery>(
                w4, __ldg(reinterpret_cast<const float4*>(qs[j] + sub_x + d)), acc[j]);
          }
        }
      } else {
        for (int d = 0; d < a.ds; ++d) {
          float w = __ldg(cw + d);
          if (kRoundCodewords) w = round_bf16(w);
          const long long at = sub_x + d * a.sd;
#pragma unroll
          for (int j = 0; j < kTableQueries; ++j) {
            float x = __ldg(qs[j] + at);
            if (kRoundQuery) x = round_bf16(x);
            acc[j] = fmaf(w, x, acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kTableQueries; ++j) {
      if ((table >> j) & 1) {
        a.lut[((static_cast<long long>(q0 + j - g0)) * a.m + sub) * a.width + k] =
            acc[j];
      }
    }
  }
}

// A table entry: staged in shared memory, or read through L2.
template <bool kGlobal>
__device__ __forceinline__ float entry(const float* lut, int i) {
  if (kGlobal) return __ldg(lut + i);
  return lut[i];
}

// The code of bits [shift, shift + 8 * sizeof(Code)) of a loaded word.
template <typename Code>
__device__ __forceinline__ unsigned field(unsigned word, int shift) {
  return (word >> shift) & (0xffffffffu >> (32 - 8 * sizeof(Code)));
}

// The codes [g, g + kBytes / sizeof(Code)) of a code row, read with one
// load of kBytes bytes (16 or 4) or as one code, kept as 32-bit words.
template <typename Code, int kBytes>
struct CodeLoad {
  unsigned w[kBytes == 16 ? 4 : 1];
};

template <typename Code, int kBytes>
__device__ __forceinline__ CodeLoad<Code, kBytes> load_codes(const Code* row,
                                                            int g) {
  CodeLoad<Code, kBytes> v;
  if constexpr (kBytes == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + g));
    v.w[0] = u.x;
    v.w[1] = u.y;
    v.w[2] = u.z;
    v.w[3] = u.w;
  } else if constexpr (kBytes == 4 && sizeof(Code) < 4) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned*>(row + g));
  } else {
    v.w[0] = __ldg(row + g);
  }
  return v;
}

// Code b of a load.
template <typename Code, int kBytes>
__device__ __forceinline__ unsigned code_of(const CodeLoad<Code, kBytes>& v,
                                            int b) {
  constexpr int kBits = 8 * sizeof(Code);
  return field<Code>(v.w[(b * kBits) >> 5], (b * kBits) & 31);
}

// Add the table entries of subspaces [m0, m0 + mc) of each slot's code row
// to its sum, in subspace order; the loads of all slots go out together
// (kBytes bytes each: 16, 4, or one code).  `lut` holds the mc subspaces'
// tables, `width` entries each (a constant 256 for uint8 codes).
template <typename Code, int kBytes, bool kGlobal>
__device__ __forceinline__ void add_rows(const Code* const* rows, int m0,
                                         const float* lut, int width, int mc,
                                         float* acc) {
  constexpr int kPer = kBytes / sizeof(Code);  // codes a load
  const int w = sizeof(Code) == 1 ? kU8Width : width;
  for (int g = 0; g < mc; g += kPer) {
    CodeLoad<Code, kBytes> v[kSlotsPerThread];
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) v[i] = load_codes<Code, kBytes>(rows[i], m0 + g);
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
#pragma unroll
      for (int b = 0; b < kPer; ++b) {
        acc[i] += entry<kGlobal>(lut, (g + b) * w + static_cast<int>(code_of(v[i], b)));
      }
    }
  }
}

// 6. One block per work item of the queries [g0, g1): the item's query, its
// table staged in chunks of mc subspaces (or, kGlobal, read from the
// scratch through L2 in one pass), and the scores of its slots.  Blocks past
// the group's last item leave.
template <typename Code, int kBytes, bool kGlobal>
__global__ void __launch_bounds__(kScoreThreads)
    adc_score_kernel(AdcArgs a, groups::Lists l, int g0, int g1, int mc) {
  extern __shared__ __align__(16) float lut[];  // mc * width (staged)
  groups::Item it;
  if (!groups::find_item(l.slot_off, l.item_off, g0, g1, blockIdx.x,
                         a.item_slots, &it)) {
    return;
  }

  // each thread's slots; a thread short of slots scores code row 0 for
  // nothing and writes no result
  const Code* codes = static_cast<const Code*>(a.codes);
  float acc[kSlotsPerThread];
  const Code* rows[kSlotsPerThread];
  long long slot[kSlotsPerThread];
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    acc[i] = 0.0f;
    rows[i] = codes;
    slot[i] = -1;
    const int j = threadIdx.x + i * kScoreThreads;
    if (j < it.n) {
      const u64 e = l.order[it.first + j];
      const long long s = groups::entry_slot(e);
      const int c = groups::entry_cand(e);
      const long long row =
          static_cast<long long>(__ldg(a.tile_idx + s / a.cap)) * a.r + c / a.qb;
      rows[i] = codes + row * a.m;
      slot[i] = s;
    }
  }

  const float* table = a.lut + static_cast<long long>(it.q - g0) * a.m * a.width;
  if (kGlobal) {
    add_rows<Code, kBytes, true>(rows, 0, table, a.width, a.m, acc);
  } else {
    const float4* src4 = reinterpret_cast<const float4*>(table);
    float4* staged = reinterpret_cast<float4*>(lut);
    const int w4 = a.width / 4;
    constexpr int kCopy = 4;  // float4 loads in flight per thread
    for (int m0 = 0; m0 < a.m; m0 += mc) {
      const int mcur = min(mc, a.m - m0);
      const int n4 = mcur * w4;
      const float4* src = src4 + static_cast<long long>(m0) * w4;
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
      add_rows<Code, kBytes, false>(rows, m0, lut, a.width, mcur, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    if (slot[i] >= 0) a.out[slot[i]] = acc[i];
  }
}

template <typename Code, int kBytes, bool kGlobal>
cudaError_t launch_score(const AdcArgs& a, const groups::Lists& l, int g0,
                         int g1, int mc, cudaStream_t stream) {
  const int smem =
      kGlobal ? 0 : mc * a.width * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      adc_score_kernel<Code, kBytes, kGlobal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  adc_score_kernel<Code, kBytes, kGlobal>
      <<<static_cast<unsigned>(a.max_items), kScoreThreads, smem, stream>>>(
          a, l, g0, g1, mc);
  return cudaGetLastError();
}

// The score kernel for this code type, load width and table body.
template <typename Code>
cudaError_t launch_score_for(const AdcArgs& a, const groups::Lists& l, int g0,
                             int g1, int mc, int vec_bytes, bool global,
                             cudaStream_t stream) {
  if (global) {
    return vec_bytes == 16 ? launch_score<Code, 16, true>(a, l, g0, g1, mc, stream)
           : vec_bytes == 4 ? launch_score<Code, 4, true>(a, l, g0, g1, mc, stream)
                            : launch_score<Code, sizeof(Code), true>(a, l, g0, g1, mc, stream);
  }
  return vec_bytes == 16 ? launch_score<Code, 16, false>(a, l, g0, g1, mc, stream)
         : vec_bytes == 4 ? launch_score<Code, 4, false>(a, l, g0, g1, mc, stream)
                          : launch_score<Code, sizeof(Code), false>(a, l, g0, g1, mc, stream);
}


// One table entry computed where it is needed: codeword `cw` dotted with
// the query subvector `x` (element d at x[d * sd]) by the table kernel's
// FMA chain, d in order from 0, codeword and query element rounded to bf16
// where the tier says so (16-byte loads of both where vec4).
template <int kDs, bool kRoundCodewords, bool kRoundQuery>
__device__ __forceinline__ float codeword_dot(const float* cw, const float* x,
                                              long long sd, int ds,
                                              bool vec4) {
  float e = 0.0f;
  if (kDs > 0 || vec4) {
    const int n = kDs > 0 ? kDs : ds;
#pragma unroll
    for (int d = 0; d < n; d += 4) {
      e = chain4<kRoundCodewords, kRoundQuery>(
          __ldg(reinterpret_cast<const float4*>(cw + d)),
          __ldg(reinterpret_cast<const float4*>(x + d)), e);
    }
  } else {
    for (int d = 0; d < ds; ++d) {
      float w = __ldg(cw + d);
      if (kRoundCodewords) w = round_bf16(w);
      float v = __ldg(x + d * sd);
      if (kRoundQuery) v = round_bf16(v);
      e = fmaf(w, v, e);
    }
  }
  return e;
}

// 4. The slot-wise route: the grouped order in chunks of kSlotThreads /
// kLanes positions, block b taking chunks b, b + gridDim.x, ...; kLanes
// neighbouring lanes score a chunk's position where it holds a slot of a
// slot-wise query: each of its M entries computed on the table kernel's
// FMA chain and added in subspace order, as the table route adds them.
// kLanes is 2 where Ds = 8 (kDs): each lane reads one half of every
// codeword and query subvector with one 16-byte load, and the first half's
// chain passes to the second lane by a shuffle (so a warp's gather of 16
// codewords takes one load instruction instead of two of 32); else 1.  The
// order is sorted by query, so a chunk holds the queries between those of
// its first and last position; a chunk with no slot-wise query among them
// is skipped, and where the grouping found no slot-wise query at all every
// block leaves at once (a call whose queries all take tables).
template <typename Code, int kBytes, int kDs, bool kRoundCodewords,
          bool kRoundQuery>
__global__ void __launch_bounds__(kSlotThreads)
    adc_slot_kernel(AdcArgs a, groups::Lists l) {
  constexpr int kPer = kBytes / sizeof(Code);  // codes a load
  constexpr int kLanes = kDs == 8 ? 2 : 1;
  constexpr long long kChunk = kSlotThreads / kLanes;
  // no query is short enough: every block leaves
  if (l.span[0] >= l.span[1]) return;
  __shared__ int live;
  const Code* codes = static_cast<const Code*>(a.codes);
  const bool vec4 = vec4_ok(a);
  const long long sub_x = a.ds * a.sd;  // query elements a subspace
  const int half = threadIdx.x % kLanes;
  for (long long p0 = blockIdx.x * kChunk; p0 < a.n_slots; p0 += gridDim.x * kChunk) {
    const long long p1 = min(p0 + kChunk, a.n_slots);
    const int qa = groups::entry_cand(l.order[p0]) % a.qb;
    const int qz = groups::entry_cand(l.order[p1 - 1]) % a.qb;
    __syncthreads();  // every thread has read the previous chunk's flag
    if (threadIdx.x == 0) live = 0;
    __syncthreads();
    for (int q = qa + threadIdx.x; q <= qz; q += kSlotThreads) {
      if (groups::route(l.slot_off, q, a.slot_limit) == groups::kShort) live = 1;
    }
    __syncthreads();
    if (!live) continue;

    // the lanes' slot; lanes without one score code row 0 against query 0
    // for nothing (a warp's lanes stay together for the shuffles) and
    // write no result
    const long long p = p0 + threadIdx.x / kLanes;
    const Code* row_codes = codes;
    const float* x = a.q;
    long long slot = -1;
    if (p < p1) {
      const u64 e = l.order[p];
      const int c = groups::entry_cand(e);
      const int q = c % a.qb;
      if (groups::route(l.slot_off, q, a.slot_limit) == groups::kShort) {
        slot = groups::entry_slot(e);
        const long long row =
            static_cast<long long>(__ldg(a.tile_idx + slot / a.cap)) * a.r + c / a.qb;
        row_codes = codes + row * a.m;
        x = a.q + q * a.sq;
      }
    }
    if (!__any_sync(0xffffffffu, slot >= 0)) continue;
    float acc = 0.0f;
    for (int g = 0; g < a.m; g += kPer) {
      const CodeLoad<Code, kBytes> v = load_codes<Code, kBytes>(row_codes, g);
#pragma unroll
      for (int b = 0; b < kPer; ++b) {
        const float* cw =
            a.codebooks + (static_cast<long long>(g + b) * a.ks + code_of(v, b)) * a.ds;
        const float* xv = x + (g + b) * sub_x;
        if constexpr (kLanes == 2) {
          const float4 w4 = __ldg(reinterpret_cast<const float4*>(cw) + half);
          const float4 x4 = __ldg(reinterpret_cast<const float4*>(xv) + half);
          const float e0 = chain4<kRoundCodewords, kRoundQuery>(w4, x4, 0.0f);
          // the second lane carries the first lane's chain on
          acc += chain4<kRoundCodewords, kRoundQuery>(
              w4, x4, __shfl_up_sync(0xffffffffu, e0, 1));
        } else {
          acc += codeword_dot<kDs, kRoundCodewords, kRoundQuery>(cw, xv, a.sd, a.ds, vec4);
        }
      }
    }
    if (slot >= 0 && half == kLanes - 1) a.out[slot] = acc;
  }
}

template <typename Code, int kBytes, int kDs, bool kRoundCodewords,
          bool kRoundQuery>
cudaError_t launch_slots(const AdcArgs& a, const groups::Lists& l,
                         cudaStream_t stream) {
  constexpr long long kChunk = kSlotThreads / (kDs == 8 ? 2 : 1);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  long long blocks = (a.n_slots + kChunk - 1) / kChunk;
  if (blocks > static_cast<long long>(sms) * kSlotBlocksPerSm) {
    blocks = static_cast<long long>(sms) * kSlotBlocksPerSm;
  }
  adc_slot_kernel<Code, kBytes, kDs, kRoundCodewords, kRoundQuery>
      <<<static_cast<unsigned>(blocks), kSlotThreads, 0, stream>>>(a, l);
  return cudaGetLastError();
}

// The slot-wise kernel for this code type, load width and Ds.
template <typename Code, bool kRoundCodewords, bool kRoundQuery>
cudaError_t launch_slots_for(const AdcArgs& a, const groups::Lists& l,
                             int vec_bytes, cudaStream_t stream) {
  if (a.ds == 8 && vec4_ok(a)) {
    return vec_bytes == 16
               ? launch_slots<Code, 16, 8, kRoundCodewords, kRoundQuery>(a, l, stream)
           : vec_bytes == 4
               ? launch_slots<Code, 4, 8, kRoundCodewords, kRoundQuery>(a, l, stream)
               : launch_slots<Code, sizeof(Code), 8, kRoundCodewords, kRoundQuery>(a, l, stream);
  }
  return vec_bytes == 16
             ? launch_slots<Code, 16, 0, kRoundCodewords, kRoundQuery>(a, l, stream)
         : vec_bytes == 4
             ? launch_slots<Code, 4, 0, kRoundCodewords, kRoundQuery>(a, l, stream)
             : launch_slots<Code, sizeof(Code), 0, kRoundCodewords, kRoundQuery>(a, l, stream);
}

// The widest code load (16 or 4 bytes, else one code) that divides a code
// row, fits `most` codes and that the codes' alignment admits.
inline int code_load_bytes(const AdcArgs& a, int most) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.codes);
  const long long row_bytes = static_cast<long long>(a.m) * a.code_bytes;
  for (int bytes = 16; bytes > a.code_bytes; bytes /= 4) {
    if (row_bytes % bytes == 0 && base % bytes == 0 && most >= bytes / a.code_bytes) {
      return bytes;
    }
  }
  return a.code_bytes;
}

}  // namespace adc

// Run the steps for one call; returns the first failing step's
// cudaError_t (0 on success).  The tier is the pair of rounding flags.
template <bool kRoundCodewords, bool kRoundQuery>
cudaError_t adc_lut_launch(const AdcArgs& a, cudaStream_t stream) {
  if (a.n_slots <= 0) return cudaSuccess;
  const bool width_ok =
      a.code_bytes == 1 ? a.width == kU8Width && a.ks <= kU8Width
                        : (a.code_bytes == 2 || a.code_bytes == 4) &&
                              a.width >= a.ks && a.width % 4 == 0 &&
                              a.width <= 65535LL * kAdcThreads;
  if (!width_ok || a.ks <= 0 || a.item_slots <= 0 ||
      a.item_slots > kAdcMaxItemSlots || a.qb <= 0 || a.m <= 0 ||
      static_cast<long long>(a.m) * a.width > 0x7fffffffLL ||
      a.max_items <= 0 || a.max_items > 0x7fffffffLL || a.lut_queries <= 0 ||
      a.slot_limit < 0) {
    return cudaErrorInvalidValue;
  }
  const groups::Lists l = groups::lists(a.scratch, a.qb);
  cudaError_t err = group_slots(a.cand, a.n_slots, a.qb, a.item_slots, l,
                                stream, a.slot_limit);
  if (err != cudaSuccess) return err;

  if (a.slot_limit > 0) {  // some query may be scored slot-wise
    const int vec = adc::code_load_bytes(a, a.m);
    err = a.code_bytes == 1
              ? adc::launch_slots_for<uint8_t, kRoundCodewords, kRoundQuery>(a, l, vec, stream)
          : a.code_bytes == 2
              ? adc::launch_slots_for<uint16_t, kRoundCodewords, kRoundQuery>(a, l, vec, stream)
              : adc::launch_slots_for<uint32_t, kRoundCodewords, kRoundQuery>(a, l, vec, stream);
    if (err != cudaSuccess) return err;
  }
  if (a.slot_limit > a.n_slots) return cudaSuccess;  // no query takes tables

  // subspaces per staged chunk: as many tables as kLutBytes holds (96 at
  // width 256), all of them where M is smaller; none where one subspace's
  // table alone is larger (the global-memory body, one pass over M)
  const int per_chunk = kLutBytes / (a.width * static_cast<int>(sizeof(float)));
  const bool global = per_chunk == 0;
  int mc = global ? a.m : min(a.m, per_chunk);
  // the widest code load that divides the row and the chunks
  const int vec = adc::code_load_bytes(a, mc);
  const int per = vec / a.code_bytes;
  if (mc != a.m) mc = mc / per * per;  // chunks start on whole loads
  for (int g0 = 0; g0 < a.qb; g0 += a.lut_queries) {
    const int g1 = min(a.qb, g0 + a.lut_queries);
    const dim3 tables((a.m + kTableSubs - 1) / kTableSubs,
                      (g1 - g0 + kTableQueries - 1) / kTableQueries,
                      (a.width + kAdcThreads - 1) / kAdcThreads);
    adc::adc_table_kernel<kRoundCodewords, kRoundQuery>
        <<<tables, kAdcThreads, 0, stream>>>(a, l.slot_off, g0, g1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = a.code_bytes == 1
              ? adc::launch_score_for<uint8_t>(a, l, g0, g1, mc, vec, global, stream)
          : a.code_bytes == 2
              ? adc::launch_score_for<uint16_t>(a, l, g0, g1, mc, vec, global, stream)
              : adc::launch_score_for<uint32_t>(a, l, g0, g1, mc, vec, global, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace ff
