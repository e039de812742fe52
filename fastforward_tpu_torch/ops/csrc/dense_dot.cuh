// The query-major dense-dot body shared by K1 (stream_select_pairwise.cu)
// and K2 (stream_select.cu).  It replaces the per-slot arithmetic of the
// Pallas kernels fastforward_tpu/ops/stream_kernel.py:256
// (_pairwise_kernel) and :69 (_select_kernel).  Contract, for every slot s
// of the (n_tiles, cap) grid, with c = cand[s], local = c / qb, qno = c % qb
// and row = tile_idx[s / cap] * r + local:
//
//     out[s] = table[row] . q[:, qno]
//
// one fp32 FMA chain per lane over its elements, the 32 lanes' sums then
// added with shuffles.  The fast tier rounds the row element and the query
// element to bf16 (round to nearest even) before the multiply; the exact
// tier multiplies them as they are (no TF32, no matmul).  The table is
// fp32, bf16 or int8 (int8 codes with the scales folded into the queries
// by the caller), rows of dim elements (dim % 128 == 0; the 3D int8 layout
// (N_pad, dim/128, 128) is the same bytes).  Element (d, qno) of the query
// block is at q[d * sd + qno * sq]: K1 passes its row-major (Qb, dim)
// block (sd = 1, sq = dim), K2 the transposed view it is given.
//
// Why query-major.  Scored slot by slot (one warp per slot, the first forms
// of K1 and K2), each slot re-reads its whole fp32 query from L2 beside its
// row: 3 KB at dim 768, against a 768-byte int8 row, ~3.2 GB of L2 reads
// for the ~1,048,576 slots of the flagship int8 layouts, and that set their
// time.  So the slots are grouped by query on the card (query_groups.cuh)
// and a block holds one query for a whole work item of up to item_slots of
// its slots: the query leaves L2 once per item, and a slot costs its row.
//
// The launch sequence (dense_dot_launch), all on the caller's stream: the
// grouping (a memset and the count and scatter kernels), then
// dot_kernel, one block of kWarps warps per work item:
//   - the block stages its query in shared memory (fp32, rounded to bf16
//     once in the fast tier), permuted so that a warp's 16-byte reads of
//     it are consecutive (no bank conflicts);
//   - each warp takes 32 of the item's slots at a time, one per lane, and
//     finds their rows; lanes whose slots share a row share one dot (the
//     same row and query give the same fp32 sum), so the padding slots
//     (local 0 of their tile, query Qb - 1; over half of the flagship
//     slots, listed tile by tile) cost about one dot per 32 slots;
//   - the warp dots kRowsInFlight distinct rows at a time: each lane loads
//     16 bytes of every row (4 fp32, 8 bf16 or 16 int8 elements) before it
//     multiplies, two steps unrolled, so 8 loads of 16 bytes per lane are
//     in flight; int8 elements widen exactly through a float magic number
//     (an integer op and an fp32 add, no conversion instruction);
//   - each slot's score goes to out[slot], its place in the grid.
// Padding slots are scored like any other slot, as the contract says.
//
// Bound on the H100: bytes.  A call must move the distinct rows its slots
// read (chip_smoke.py's k1_bound: at the flagship int8 layouts 0.18-0.36
// GB, 0.05-0.11 ms at 3.35 TB/s), plus cand, tile_idx, the queries and out;
// the arithmetic, 2 * dim flops a slot, is far below the fp32 rate.  The
// design reads each real slot's row once (a row that two queries want,
// twice), the padding rows from L2, each query once per work item, and
// adds the grouping's passes over cand (~0.03 ms of a 1M-slot call).  What
// bounds it in practice is the rate of random row reads from device
// memory: a query's rows lie anywhere in the table, and 768-byte int8 rows
// read that way come at ~2.2 TB/s on an H100 SXM, against ~2.9 TB/s for
// 3 KB fp32 rows (PERF.md; chip_smoke.py splits one call's time by
// kernel).  That is why K1 keeps slot order for fp32 tables.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "query_groups.cuh"

namespace ff {

struct DenseArgs {
  const void* table;  // (N_pad, dim) rows, 16-byte aligned
  int dim;            // dim % 128 == 0
  const float* q;     // element (d, qno) at q[d * sd + qno * sq]
  long long sd, sq;
  const int* cand;      // (n_slots,) packed local * qb + qno
  const int* tile_idx;  // (n_slots / cap,)
  float* out;           // (n_slots,)
  long long n_slots;
  int cap, qb, r;
  u64* scratch;         // the grouping's, 3 * qb + 2 + n_slots words
  int item_slots;       // slots per work item
  long long max_items;  // a bound on the work items of the whole call
};

namespace dense {

constexpr int kWarps = 8;         // warps per block
constexpr int kRowsInFlight = 4;  // distinct rows a warp dots at once

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A 16-byte load of row elements (kElems of them), widened four at a time
// to fp32 (exactly, for all three types).
template <typename T>
struct Row;

template <>
struct Row<float> {
  static constexpr int kElems = 4;
  __device__ static void widen(const uint4& v, int, float (&x)[4]) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
};

template <>
struct Row<__nv_bfloat16> {
  static constexpr int kElems = 8;
  // little endian: element 2i in the low half of a word, 2i+1 in the high
  // half; a bf16 is the high 16 bits of the fp32 with the same value
  __device__ static void widen(const uint4& v, int j, float (&x)[4]) {
    const unsigned lo = word(v, 2 * j), hi = word(v, 2 * j + 1);
    x[0] = __uint_as_float(lo << 16);
    x[1] = __uint_as_float(lo & 0xffff0000u);
    x[2] = __uint_as_float(hi << 16);
    x[3] = __uint_as_float(hi & 0xffff0000u);
  }
};

template <>
struct Row<int8_t> {
  static constexpr int kElems = 16;
  // byte b + 128 (the xor) in the low mantissa bits of 2^23 is the float
  // 2^23 + b + 128; subtracting 2^23 + 128 leaves b exactly
  __device__ static void widen(const uint4& v, int j, float (&x)[4]) {
    const unsigned w = word(v, j) ^ 0x80808080u;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[t] = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7540u + t)) -
             8388736.0f;
    }
  }
};

// Shared-memory place of query element e, for rows read kElems elements a
// lane: lane l's elements of step k (elements k * 32 * kElems + l * kElems
// onwards) are read as kElems / 4 float4s, the j-th at float4
// (k * kElems / 4 + j) * 32 + l, so a warp's reads of one j are consecutive.
template <int kElems>
__device__ __forceinline__ int staged_place(int e) {
  const int step = e / (32 * kElems), in = e % (32 * kElems);
  const int lane = in / kElems, v = in % kElems;
  return ((step * (kElems / 4) + v / 4) * 32 + lane) * 4 + (v & 3);
}

// acc[k] = rows[k] . query (staged), summed over the warp (every lane gets
// the sums).
template <typename T, bool kFast>
__device__ __forceinline__ void dot_rows(const T* const (&rows)[kRowsInFlight],
                                         const float* qs, int dim, int lane,
                                         float (&acc)[kRowsInFlight]) {
  constexpr int V = Row<T>::kElems;
#pragma unroll
  for (int k = 0; k < kRowsInFlight; ++k) acc[k] = 0.0f;
  const float4* q4 = reinterpret_cast<const float4*>(qs) + lane;
#pragma unroll 2
  for (int i = lane * V; i < dim; i += 32 * V, q4 += 8 * V) {
    uint4 raw[kRowsInFlight];
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      raw[k] = __ldg(reinterpret_cast<const uint4*>(rows[k] + i));
    }
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 qv = q4[j * 32];
      const float qq[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        float x[4];
        Row<T>::widen(raw[k], j, x);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          // bf16 and int8 elements are already exact in bf16
          const float xv =
              kFast && std::is_same<T, float>::value ? round_bf16(x[t]) : x[t];
          acc[k] = fmaf(xv, qq[t], acc[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsInFlight; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
  }
}

// One block per work item: the item's query staged, and the scores of its
// slots.  Blocks past the last item leave.
template <typename T, bool kFast>
__global__ void __launch_bounds__(kWarps * 32)
    dot_kernel(DenseArgs a, groups::Lists l) {
  constexpr int V = Row<T>::kElems;
  extern __shared__ __align__(16) float qs[];
  groups::Item it;
  if (!groups::find_item(l.slot_off, l.item_off, 0, a.qb, blockIdx.x,
                         a.item_slots, &it)) {
    return;
  }
  const int lane = threadIdx.x & 31;
  const T* table = static_cast<const T*>(a.table);
  constexpr int kPass = kWarps * 32;  // slots of the block's warps per pass
  int base = (threadIdx.x >> 5) * 32;
  // the lane's list entry, read one pass ahead (the first one before the
  // query is staged)
  u64 entry = base + lane < it.n ? l.order[it.first + base + lane] : 0;

  // the query, zero past dim up to a whole step
  const int staged = (a.dim + 32 * V - 1) / (32 * V) * (32 * V);
  const float* qcol = a.q + static_cast<long long>(it.q) * a.sq;
  for (int e = threadIdx.x; e < staged; e += kWarps * 32) {
    const float x = e < a.dim ? __ldg(qcol + e * a.sd) : 0.0f;
    qs[staged_place<V>(e)] = kFast ? round_bf16(x) : x;
  }
  __syncthreads();

  for (; base < it.n; base += kPass) {
    const u64 e = entry;
    if (base + kPass + lane < it.n) entry = l.order[it.first + base + kPass + lane];
    // the lane's slot and its row (-1 past the item's end)
    long long slot = -1, row = -1;
    if (base + lane < it.n) {
      slot = groups::entry_slot(e);
      row = static_cast<long long>(__ldg(a.tile_idx + slot / a.cap)) * a.r +
            groups::entry_cand(e) / a.qb;
    }
    // the lowest lane of each row leads it; leaders' rows are dotted
    const unsigned peers = __match_any_sync(0xffffffffu, static_cast<u64>(row));
    const int leader = __ffs(peers) - 1;
    unsigned todo = __ballot_sync(0xffffffffu, row >= 0 && lane == leader);
    float mine = 0.0f;  // the dot of the row this lane leads
    while (todo) {      // warp-uniform
      int src[kRowsInFlight];
      const T* rows[kRowsInFlight];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        // past the last leader, repeat the first row (read from L1, unused)
        src[k] = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        const long long rk =
            __shfl_sync(0xffffffffu, row, src[k] >= 0 ? src[k] : src[0]);
        rows[k] = table + rk * a.dim;
      }
      float acc[kRowsInFlight];
      dot_rows<T, kFast>(rows, qs, a.dim, lane, acc);
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        if (lane == src[k]) mine = acc[k];
      }
    }
    const float score = __shfl_sync(0xffffffffu, mine, leader);
    if (slot >= 0) a.out[slot] = score;
  }
}

template <typename T, bool kFast>
cudaError_t launch_dot(const DenseArgs& a, const groups::Lists& l,
                       cudaStream_t stream) {
  constexpr int kStep = 32 * Row<T>::kElems;
  const int smem = (a.dim + kStep - 1) / kStep * kStep *
                   static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        dot_kernel<T, kFast>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  dot_kernel<T, kFast>
      <<<static_cast<unsigned>(a.max_items), kWarps * 32, smem, stream>>>(a,
                                                                          l);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tier(const DenseArgs& a, const groups::Lists& l, bool fast,
                        cudaStream_t stream) {
  return fast ? launch_dot<T, true>(a, l, stream)
              : launch_dot<T, false>(a, l, stream);
}

}  // namespace dense

// Group the slots and score them, for table dtype code 0 (fp32), 1 (bf16)
// or 2 (int8); `fast` selects the bf16 tier.  Returns the first failing
// step's cudaError_t (0 on success).
inline cudaError_t dense_dot_launch(const DenseArgs& a, int dtype, bool fast,
                                    cudaStream_t stream) {
  if (a.n_slots <= 0) return cudaSuccess;
  if (dtype < 0 || dtype > 2 || a.item_slots <= 0 || a.qb <= 0 ||
      a.dim <= 0 || a.dim % 128 || a.cap <= 0 || a.max_items <= 0 ||
      a.max_items > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const groups::Lists l = groups::lists(a.scratch, a.qb);
  cudaError_t err =
      group_slots(a.cand, a.n_slots, a.qb, a.item_slots, l, stream);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case 0:
      return dense::launch_tier<float>(a, l, fast, stream);
    case 1:
      return dense::launch_tier<__nv_bfloat16>(a, l, fast, stream);
    default:
      return dense::launch_tier<int8_t>(a, l, fast, stream);
  }
}

}  // namespace ff
