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
// The launch sequence (adc_lut_launch), all on the caller's stream: the
// grouping of query_groups.cuh (a memset and the count and scatter
// kernels: each query's slots listed and cut into work items of item_slots
// slots, the padding query Qb - 1, which owns over half of the flagship
// slots, into many), then, for each group of lut_queries queries (one
// group at Qb = 512):
//   5. adc_table_kernel: the group's LUTs into the scratch table, one block
//      per (subspace, 8 queries), each thread one codeword dotted with 8
//      queries, so the codebooks leave L2 once per 8 queries;
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
// mostly from L2.  Rebuilding the table in every work item from the
// codebooks instead (the first form of this design) read the 786 KB of
// codebooks from L2 per item, ~0.6 GB per call.  A block stages at most
// kLutBytes (96 KB, two blocks per SM): 96 subspaces at width 256, 24 at
// width 1024; where M exceeds that (PQ(384, 256) at dim 768 is 384 KB) it
// stages and consumes the table in chunks of subspaces and carries each
// slot's partial sum in a register across chunks.  Where one subspace's
// table alone exceeds kLutBytes (Ks > 24,576) the score kernel reads the
// table from global memory (L2) instead of staging it: the same contract
// and the same sums, a second body that the launcher picks from the
// geometry.
//
// Scoring.  One slot per thread (lane-per-slot, no shuffles), kSlotsPerThread
// slots per thread, whose code loads are issued together.  Codes are uint8,
// uint16 or uint32.  A thread reads its slots' code rows with 16-byte loads
// (16, 8 or 4 codes) where the row's bytes and the staged chunk divide into
// them and the codes are 16-byte aligned (a row starts at row * M), else
// 4-byte loads (4 or 2 codes), else one code at a time.  The 32 lanes of a warp read 32 random codes of one subspace, so
// their table reads land on random banks (bank = code % 32): about 3.5-way
// conflicts on average.
//
// Bound on the H100: the bytes a call must move are the code rows its
// slots read (M codes each), the codebooks, queries, cand, tile_idx and out
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
  u64* scratch;         // the grouping's, 3 * qb + 2 + n_slots words
  int item_slots;       // slots per work item, <= kAdcMaxItemSlots
  long long max_items;  // a bound on the work items of the whole call
  float* lut;           // lut_queries * m * width fp32
  int lut_queries;
  int width;  // entries of one subspace's table: 256 for uint8 codes, else
              // Ks rounded up to a multiple of 4
};

namespace adc {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 5. lut[(q - g0) * m + sub][k] for the queries [g0, g1) of one group: block
// (sub, query tile, codeword tile), thread k holds codeword k of subspace
// sub and dots it with up to kTableQueries queries (fp32 FMAs in element
// order); entries k >= ks are zero.
template <bool kRoundCodewords, bool kRoundQuery>
__global__ void __launch_bounds__(kAdcThreads)
    adc_table_kernel(AdcArgs a, int g0, int g1) {
  const int sub = blockIdx.x;
  const int k = blockIdx.z * kAdcThreads + threadIdx.x;
  if (k >= a.width) return;
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
      a.lut[((static_cast<long long>(q0 + j - g0)) * a.m + sub) * a.width + k] =
          acc[j];
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

// Add the table entries of subspaces [m0, m0 + mc) of each slot's code row
// to its sum, in subspace order; the loads of all slots go out together
// (kBytes bytes each: 16, 4, or one code).  `lut` holds the mc subspaces'
// tables, `width` entries each (a constant 256 for uint8 codes).
template <typename Code, int kBytes, bool kGlobal>
__device__ __forceinline__ void add_rows(const Code* const* rows, int m0,
                                         const float* lut, int width, int mc,
                                         float* acc) {
  constexpr int kBits = 8 * sizeof(Code);
  constexpr int kPer = kBytes / sizeof(Code);  // codes a load
  const int w = sizeof(Code) == 1 ? kU8Width : width;
  for (int g = 0; g < mc; g += kPer) {
    if (kBytes == 16) {
      uint4 v[kSlotsPerThread];
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        v[i] = __ldg(reinterpret_cast<const uint4*>(rows[i] + m0 + g));
      }
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        const unsigned wd[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int b = 0; b < kPer; ++b) {
          const unsigned c = field<Code>(wd[(b * kBits) >> 5], (b * kBits) & 31);
          acc[i] += entry<kGlobal>(lut, (g + b) * w + static_cast<int>(c));
        }
      }
    } else if (kBytes == 4 && sizeof(Code) < 4) {
      unsigned v[kSlotsPerThread];
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        v[i] = __ldg(reinterpret_cast<const unsigned*>(rows[i] + m0 + g));
      }
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
#pragma unroll
        for (int b = 0; b < kPer; ++b) {
          const unsigned c = field<Code>(v[i], b * kBits);
          acc[i] += entry<kGlobal>(lut, (g + b) * w + static_cast<int>(c));
        }
      }
    } else {
      unsigned v[kSlotsPerThread];
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) v[i] = __ldg(rows[i] + m0 + g);
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        acc[i] += entry<kGlobal>(lut, g * w + static_cast<int>(v[i]));
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
      a.max_items <= 0 || a.max_items > 0x7fffffffLL || a.lut_queries <= 0) {
    return cudaErrorInvalidValue;
  }
  const groups::Lists l = groups::lists(a.scratch, a.qb);
  cudaError_t err =
      group_slots(a.cand, a.n_slots, a.qb, a.item_slots, l, stream);
  if (err != cudaSuccess) return err;

  // subspaces per staged chunk: as many tables as kLutBytes holds (96 at
  // width 256), all of them where M is smaller; none where one subspace's
  // table alone is larger (the global-memory body, one pass over M)
  const int per_chunk = kLutBytes / (a.width * static_cast<int>(sizeof(float)));
  const bool global = per_chunk == 0;
  int mc = global ? a.m : min(a.m, per_chunk);
  // the widest code load that divides the row and the chunks and that the
  // codes' alignment admits
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.codes);
  const long long row_bytes = static_cast<long long>(a.m) * a.code_bytes;
  int vec = a.code_bytes;
  for (int bytes = 16; bytes > a.code_bytes; bytes /= 4) {
    const int per = bytes / a.code_bytes;
    if (row_bytes % bytes == 0 && base % bytes == 0 && mc >= per) {
      mc = mc == a.m ? mc : mc / per * per;  // chunks start on whole loads
      vec = bytes;
      break;
    }
  }
  for (int g0 = 0; g0 < a.qb; g0 += a.lut_queries) {
    const int g1 = min(a.qb, g0 + a.lut_queries);
    const dim3 tables(a.m, (g1 - g0 + kTableQueries - 1) / kTableQueries,
                      (a.width + kAdcThreads - 1) / kAdcThreads);
    adc::adc_table_kernel<kRoundCodewords, kRoundQuery>
        <<<tables, kAdcThreads, 0, stream>>>(a, g0, g1);
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
