// K2 for Hopper: stream-select scoring of dense virtual tiles, query-major.
//
// Replaces the Pallas kernel fastforward_tpu/ops/stream_kernel.py:197
// stream_select (body _select_kernel, :69), which the JAX package routes
// for 3D float tables and for int8 tables at cap > R.  Same contract: for
// every slot s of virtual tile t, with c = cand[t, s], local = c / Qb and
// qno = c % Qb,
//
//     out[t, s] = table[tile_idx[t] * R + local] . qT[:, qno]
//
// The query block arrives transposed, qT of shape (dim, Qb), as strides
// (stride_d, stride_q) in elements: the port passes the transposed view of
// its row-major (Qb, dim) block (stride_d = 1, reads coalesce), and a
// row-major qT works too.  The table is fp32, bf16 or int8 (int8 codes with
// the scales folded into the queries); the 2D (N_pad, dim) and 3D
// (N_pad, dim/128, 128) layouts are the same bytes.  Tiers:
//   exact, high: a true fp32 dot (high's bf16x3 on the TPU approximates
//                exactly this, so both take it);
//   fast:        the row element and the query element rounded to bf16
//                (round to nearest even), products accumulated in fp32.
// Padding slots (local 0, qno Qb-1) are computed like any other slot.
//
// The TPU kernel multiplies the whole R-row tile by every query (an
// R x dim x Qb product) and then selects each slot's score with one-hot
// matmuls, because Mosaic has no dynamic gather.  This kernel computes only
// the cap slot dots.  Its first form staged each tile's rows in shared
// memory and re-read every slot's fp32 query from L2 (1.5 GB a call at the
// int8 dense layout); now the slots are grouped by query on the card and a
// block holds one query for a work item of DENSE_ITEM_SLOTS of its slots,
// so a slot costs its row (768 bytes of int8 at dim 768; a row that several
// queries want is read by each, from L2 where the tiles are dense).  The
// body, its launch sequence and what bounds it (bytes: the rows the slots
// read) are in dense_dot.cuh, shared with K1.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_dot.cuh"

// Table dtype codes: 0 fp32, 1 bf16, 2 int8.  Pointers are device pointers
// (table 16-byte aligned with rows of dim elements, dim % 128 == 0; the
// wrapper checks); qT element (d, qno) is at q[d * q_stride_d + qno *
// q_stride_q]; scratch holds 3 * qb + 2 + n_tiles * cap 64-bit words.
// `fast` selects the bf16 tier (0: exact/high).  The launches go on
// `stream` of `device` and do not synchronise.  Returns the cudaError_t of
// the first failing launch (0 on success).
extern "C" int ff_stream_select(const void* table, int dtype, const void* q,
                                long long q_stride_d, long long q_stride_q,
                                const void* cand, const void* tile_idx,
                                void* out, int n_tiles, int cap, int qb,
                                int r, int dim, int fast, void* scratch,
                                int item_slots, long long max_items,
                                int device, void* stream) {
  if (n_tiles <= 0) return 0;
  // this object links its own CUDA runtime, whose current device is not
  // PyTorch's: select the device the stream belongs to
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ff::DenseArgs a{table,
                        dim,
                        static_cast<const float*>(q),
                        q_stride_d,
                        q_stride_q,
                        static_cast<const int*>(cand),
                        static_cast<const int*>(tile_idx),
                        static_cast<float*>(out),
                        static_cast<long long>(n_tiles) * cap,
                        cap,
                        qb,
                        r,
                        static_cast<ff::u64*>(scratch),
                        item_slots,
                        max_items};
  err = ff::dense_dot_launch(a, dtype, fast != 0,
                             static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
