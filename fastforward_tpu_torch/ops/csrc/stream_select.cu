// K2 for Hopper: stream-select scoring of dense virtual tiles, one block
// per virtual tile with the tile's rows staged in shared memory.
//
// Replaces the Pallas kernel fastforward_tpu/ops/stream_kernel.py:
// stream_select (body _select_kernel).  Same contract: for every slot s of
// virtual tile t, with c = cand[t, s], local = c / Qb and qno = c % Qb,
//
//     out[t, s] = table[tile_idx[t] * R + local] . qT[:, qno]
//
// The query block arrives transposed, qT of shape (dim, Qb), as strides
// (stride_d, stride_q) in elements: the port passes the transposed view of
// its row-major (Qb, dim) block (stride_d = 1, reads coalesce), and a
// row-major qT works too, only slower.  The table is fp32, bf16 or int8
// (int8 codes with the scales folded into the queries); the 2D (N_pad, dim)
// and 3D (N_pad, dim/128, 128) layouts are the same bytes.  Tiers:
//   exact, high: a true fp32 dot (high's bf16x3 on the TPU approximates
//                exactly this, so both take it);
//   fast:        the row element and the query element rounded to bf16
//                (round to nearest even), products accumulated in fp32.
// Padding slots (local 0, qno Qb-1) are computed like any other slot.
//
// The TPU kernel multiplies the whole R-row tile by every query (an
// R x dim x Qb product) and then selects each slot's score with one-hot
// matmuls, because Mosaic has no dynamic gather.  This kernel computes only
// the cap slot dots.  It runs where the tiles are dense (cap > R: every row
// is wanted about cap/R times), so the block stages the tile's rows in
// shared memory, in chunks of up to 48 KB (64 int8 rows at dim 768), and
// its warps score every slot whose row lies in the staged chunk: each row
// leaves device memory once per virtual tile.  Chunks no slot needs are
// skipped (a spill tile with a few slots stages only their rows' chunks).  The staging
// skeleton is staged_tile.cuh, shared with K4.
//
// Bound: memory.  The rows are read once (262,144 int8 rows at dim 768 are
// 0.2 GB, 0.06 ms at 3.35 TB/s); the arithmetic (2 x dim flops per slot) is
// far below the fp32 rate.  Each slot also reads its query (dim fp32) from
// L2, where the whole query block stays: at 512k slots and dim 768 that is
// 1.5 GB of L2 reads, which sets the time of this simple form.
// chip_smoke.py computes the bound for the card it runs on.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "staged_tile.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) {
  return static_cast<float>(x);
}

template <typename T, bool kFast>
__global__ void __launch_bounds__(ff::kStagedThreads)
    select_kernel(const T* __restrict__ table, const float* __restrict__ q,
                  long long q_stride_d, long long q_stride_q,
                  const int* __restrict__ cand,
                  const int* __restrict__ tile_idx, float* __restrict__ out,
                  int cap, int qb, int r, int dim, int chunk_rows) {
  extern __shared__ __align__(16) unsigned char staged_bytes[];
  const T* staged = reinterpret_cast<const T*>(staged_bytes);

  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  float* out_t = out + static_cast<long long>(t) * cap;
  const long long base_row = static_cast<long long>(__ldg(tile_idx + t)) * r;

  // stage rows [row0, row0 + rows) of the tile: 16-byte copies (rows are
  // dim % 128 == 0 elements long, so every chunk is 16-byte aligned)
  auto stage = [&](int row0, int rows) {
    const int4* src =
        reinterpret_cast<const int4*>(table + (base_row + row0) * dim);
    int4* dst = reinterpret_cast<int4*>(staged_bytes);
    const int n16 = static_cast<int>(static_cast<long long>(rows) * dim *
                                     sizeof(T) / 16);
    for (int i = threadIdx.x; i < n16; i += ff::kStagedThreads) {
      dst[i] = __ldg(src + i);
    }
  };
  auto score = [&](int s, int cv, int staged_row) {
    const T* x = staged + static_cast<long long>(staged_row) * dim;
    const float* qcol = q + static_cast<long long>(cv % qb) * q_stride_q;
    float acc = 0.0f;
    for (int d = lane; d < dim; d += 32) {
      float a = widen(x[d]);
      float b = __ldg(qcol + d * q_stride_d);
      if (kFast) {
        // bf16 and int8 elements are already exact in bf16
        if (std::is_same<T, float>::value) a = round_bf16(a);
        b = round_bf16(b);
      }
      acc = fmaf(a, b, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out_t[s] = acc;
  };
  ff::for_each_staged_slot(cand + static_cast<long long>(t) * cap, cap, qb, r,
                           chunk_rows, stage, score);
}

template <typename T, bool kFast>
cudaError_t launch_tier(const void* table, const void* q, long long sd,
                        long long sq, const void* cand, const void* tile_idx,
                        void* out, int n_tiles, int cap, int qb, int r,
                        int dim, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(dim) * sizeof(T);
  const int chunk_rows = ff::staged_chunk_rows(row_bytes, r);
  if (chunk_rows == 0) return cudaErrorInvalidValue;
  return ff::launch_staged(
      select_kernel<T, kFast>, n_tiles, static_cast<int>(row_bytes * chunk_rows),
      stream, static_cast<const T*>(table), static_cast<const float*>(q), sd,
      sq, static_cast<const int*>(cand), static_cast<const int*>(tile_idx),
      static_cast<float*>(out), cap, qb, r, dim, chunk_rows);
}

template <typename T>
cudaError_t launch(const void* table, const void* q, long long sd,
                   long long sq, const void* cand, const void* tile_idx,
                   void* out, int n_tiles, int cap, int qb, int r, int dim,
                   int fast, cudaStream_t stream) {
  if (fast) {
    return launch_tier<T, true>(table, q, sd, sq, cand, tile_idx, out,
                                n_tiles, cap, qb, r, dim, stream);
  }
  return launch_tier<T, false>(table, q, sd, sq, cand, tile_idx, out, n_tiles,
                               cap, qb, r, dim, stream);
}

}  // namespace

// Table dtype codes: 0 fp32, 1 bf16, 2 int8.  Pointers are device pointers
// (table 16-byte aligned with rows of dim elements, dim % 128 == 0; the
// wrapper checks); qT element (d, qno) is at q[d * q_stride_d + qno *
// q_stride_q].  `fast` selects the bf16 tier (0: exact/high).  The launch
// goes on `stream` of `device` and does not synchronise.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ff_stream_select(const void* table, int dtype, const void* q,
                                long long q_stride_d, long long q_stride_q,
                                const void* cand, const void* tile_idx,
                                void* out, int n_tiles, int cap, int qb,
                                int r, int dim, int fast, int device,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  // this object links its own CUDA runtime, whose current device is not
  // PyTorch's: select the device the stream belongs to
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(table, q, q_stride_d, q_stride_q, cand, tile_idx,
                          out, n_tiles, cap, qb, r, dim, fast, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(table, q, q_stride_d, q_stride_q, cand,
                                  tile_idx, out, n_tiles, cap, qb, r, dim,
                                  fast, s);
      break;
    case 2:
      err = launch<int8_t>(table, q, q_stride_d, q_stride_q, cand, tile_idx,
                           out, n_tiles, cap, qb, r, dim, fast, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
