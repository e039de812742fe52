// K1 for Hopper: pairwise stream-select scoring, query-major for bf16 and
// int8 tables, one block per virtual tile for fp32 tables.
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
// - fp32 tables: tile-major (tile_dot.cuh), one block per virtual tile in
//   tile order, so rows near each other in device memory are read
//   together.  The block dots only what differs: all padding slots share
//   one dot, a slot that repeats the slot before it copies its result, and
//   each distinct row of the tile is read once and dotted with every query
//   that wants it.  Grouped by query instead, an fp32 row is read once per
//   query that wants it and tile order is lost (slower for fp32 rows,
//   PERF.md).  Exact is true fp32 FMA (no TF32, no tensor cores: each
//   (row, query) pair is one dot).  Bound: bytes, the distinct rows of the
//   tiles.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_dot.cuh"
#include "tile_dot.cuh"

// Table dtype codes: 0 fp32, 1 bf16, 2 int8.  Pointers are device pointers
// (table 16-byte aligned with rows of dim elements, dim % 128 == 0; q
// (qb, dim) fp32; the wrapper checks); scratch holds 3 * qb + 4 + n_slots
// 64-bit words for bf16 and int8 tables, qb * dim floats (the rounded
// queries) for fp32 tables in the fast tier, and may be null for fp32
// tables in the exact tier.  An fp32 table's tiles are split over `split`
// blocks each (tile_dot.cuh); a bf16 or int8 table's queries with fewer
// than pack_limit slots take the packed route (dense_dot.cuh).  The
// launches go on `stream` of `device` and do not synchronise.  Returns the
// cudaError_t of the first failing launch (0 on success).
extern "C" int ff_stream_select_pairwise(const void* table, int dtype,
                                         const void* q, const void* cand,
                                         const void* tile_idx, void* out,
                                         long long n_slots, int cap, int qb,
                                         int r, int dim, int exact,
                                         void* scratch, int item_slots,
                                         long long max_items, int split,
                                         long long pack_limit, int device,
                                         void* stream) {
  if (n_slots <= 0) return 0;
  // this object links its own CUDA runtime, whose current device is not
  // PyTorch's: select the device the stream belongs to
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const ff::tile_dot::Args a{static_cast<const float*>(table),
                               static_cast<const float*>(q),
                               static_cast<const int*>(cand),
                               static_cast<const int*>(tile_idx),
                               static_cast<float*>(out),
                               cap,
                               qb,
                               r,
                               dim,
                               split};
    return static_cast<int>(
        ff::tile_dot::tile_dot_launch(a, n_slots / cap, exact != 0,
                                      static_cast<float*>(scratch), s));
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
                        max_items,
                        pack_limit};
  return static_cast<int>(ff::dense_dot_launch(a, dtype, !exact, s));
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
