// K1 for Hopper: pairwise stream-select scoring, query-major for bf16 and
// int8 tables, one warp per slot for fp32 tables.
//
// Replaces the Pallas kernel fastforward_tpu/ops/stream_kernel.py:397
// stream_select_pairwise (body _pairwise_kernel, :256), which the JAX
// package routes for 2D tables and for int8 tables at cap <= R.  Same
// contract: for every slot s of virtual tile t, with c = cand[t, s],
// local = c / Qb and qno = c % Qb,
//
//     out[t, s] = table[tile_idx[t] * R + local] . q[qno]
//
// exact = 1 is a true fp32 dot; exact = 0 rounds the row element and the
// query element to bf16 (round to nearest even) before the multiply and
// accumulates in fp32, the single-pass bf16 tier of the TPU kernel.  The
// table is fp32, bf16 or int8 (int8 codes with the scales already folded
// into the queries by the caller); the query block is fp32, row-major
// (Qb, dim).  Padding slots (local 0, qno Qb-1) are computed like any other
// slot.
//
// The TPU kernel selects rows and queries with one-hot matmuls because
// Mosaic has no dynamic gather.  This kernel reads the selected rows
// directly, in two bodies, fixed per table type:
//
// - bf16 and int8 tables: query-major.  The first form of this kernel ran
//   one warp per slot and re-read the slot's fp32 query from L2 beside the
//   row (3 KB a slot at dim 768, four times an int8 row; ~3.2 GB of L2
//   reads a call at the flagship int8 layout, which set its time).  Now the
//   slots are grouped by query on the card and a block holds one query for
//   a work item of DENSE_ITEM_SLOTS of its slots, so a slot costs its row.
//   The body, its launch sequence and what bounds it (bytes: the rows the
//   slots read) are in dense_dot.cuh, shared with K2.
// - fp32 tables: one warp per slot (pairwise_kernel below), as first
//   written.  Each lane loads 16 bytes of the row and of the query per
//   step, multiplies them and the warp sums with shuffles.  For fp32 rows
//   the query's L2 reads only match the row bytes, and the slots run in
//   tile order, so rows near each other in device memory are read together
//   and a row that two queries want is read once from device memory; on
//   an H100 SXM at the flagship fp32 layout it ran at 0.514-0.517 ms per
//   call against 0.628-0.648 ms for the query-major body (PERF.md).
//   Bound: bytes, the rows (1.57 GB at the flagship layout, 0.47 ms at
//   3.35 TB/s).
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_dot.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// fp32 rows, one warp per slot: out[slot] = table[row] . q[qno], each lane
// an fp32 FMA chain over 4 elements a step (rounded to bf16 first unless
// kExact), the lanes' sums added with shuffles.
template <bool kExact>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    pairwise_kernel(const float* __restrict__ table, const float* __restrict__ q,
                    const int* __restrict__ cand,
                    const int* __restrict__ tile_idx, float* __restrict__ out,
                    long long n_slots, int cap, int qb, int r, int dim) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= n_slots) return;  // the whole warp leaves together
  const int c = __ldg(cand + slot);
  const long long row =
      static_cast<long long>(__ldg(tile_idx + slot / cap)) * r + c / qb;
  const float* trow = table + row * dim;
  const float* qrow = q + static_cast<long long>(c % qb) * dim;
  float acc = 0.0f;
#pragma unroll 2
  for (int i = lane * 4; i < dim; i += 32 * 4) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(trow + i));
    const float4 qv = __ldg(reinterpret_cast<const float4*>(qrow + i));
    const float x[4] = {xv.x, xv.y, xv.z, xv.w};
    const float y[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc = kExact ? fmaf(x[k], y[k], acc)
                   : fmaf(ff::dense::round_bf16(x[k]),
                          ff::dense::round_bf16(y[k]), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[slot] = acc;
}

}  // namespace

// Table dtype codes: 0 fp32, 1 bf16, 2 int8.  Pointers are device pointers
// (table 16-byte aligned with rows of dim elements, dim % 128 == 0; q
// (qb, dim) fp32; the wrapper checks); scratch holds 3 * qb + 2 + n_slots
// 64-bit words (unused, and may be null, for fp32 tables).  The launches go
// on `stream` of `device` and do not synchronise.  Returns the cudaError_t
// of the first failing launch (0 on success).
extern "C" int ff_stream_select_pairwise(const void* table, int dtype,
                                         const void* q, const void* cand,
                                         const void* tile_idx, void* out,
                                         long long n_slots, int cap, int qb,
                                         int r, int dim, int exact,
                                         void* scratch, int item_slots,
                                         long long max_items, int device,
                                         void* stream) {
  if (n_slots <= 0) return 0;
  // this object links its own CUDA runtime, whose current device is not
  // PyTorch's: select the device the stream belongs to
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(static_cast<unsigned>((n_slots + kWarpsPerBlock - 1) /
                                          kWarpsPerBlock));
    const float* t = static_cast<const float*>(table);
    const float* qf = static_cast<const float*>(q);
    const int* c = static_cast<const int*>(cand);
    const int* ti = static_cast<const int*>(tile_idx);
    float* o = static_cast<float*>(out);
    if (exact) {
      pairwise_kernel<true><<<grid, kWarpsPerBlock * 32, 0, s>>>(
          t, qf, c, ti, o, n_slots, cap, qb, r, dim);
    } else {
      pairwise_kernel<false><<<grid, kWarpsPerBlock * 32, 0, s>>>(
          t, qf, c, ti, o, n_slots, cap, qb, r, dim);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const ff::DenseArgs a{table,
                        dim,
                        static_cast<const float*>(q),
                        1,
                        dim,
                        static_cast<const int*>(cand),
                        static_cast<const int*>(tile_idx),
                        static_cast<float*>(out),
                        n_slots,
                        cap,
                        qb,
                        r,
                        static_cast<ff::u64*>(scratch),
                        item_slots,
                        max_items};
  return static_cast<int>(ff::dense_dot_launch(a, dtype, !exact, s));
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
