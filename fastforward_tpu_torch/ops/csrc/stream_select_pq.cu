// K4 for Hopper: streamed ADC over PQ codes for dense virtual tiles,
// query-major.
//
// Replaces the Pallas kernel fastforward_tpu/ops/stream_kernel_pq.py:454
// stream_select_pq (body _adc_kernel, :105), which the JAX package routes
// where cap > R.  Same contract: for every slot s of virtual tile t, with
// c = cand[t, s], local = c / Qb, qno = c % Qb and
// row = tile_idx[t] * R + local,
//
//     out[t, s] = sum_m codebook[m, codes[row, m]] . qT[m*Ds:(m+1)*Ds, qno]
//
// The query block arrives transposed, qT of shape (dim, Qb), as strides
// (stride_d, stride_q) in elements: the port passes the transposed view of
// its row-major (Qb, dim) block (stride_d = 1).  Tiers, as the TPU kernel
// defines them:
//   exact: fp32 codewords, fp32 query, fp32 dot;
//   high:  codewords rounded to bf16 (round to nearest even), fp32 query,
//          fp32 dot (the TPU kernel's single bf16 dequantize pass followed
//          by its ~fp32 bf16x3 product);
//   fast:  codewords and query rounded to bf16, fp32 accumulation.
// So "high" differs slightly between K3 (true fp32) and K4, as it does in
// fastforward_tpu.  Codes are uint8 (Ks <= 256), uint16 or uint32 (any Ks
// the type addresses, as the TPU kernel casts any code type to int32),
// (N_pad, M) row major, any M; codebooks are fp32 (M, Ks, Ds).
//
// The TPU kernel decodes the whole R-row tile through block-diagonal bf16
// codebooks on the MXU, multiplies it by every query, then selects each
// slot's score with one-hot matmuls (Mosaic has no dynamic gather).  The
// first form of this kernel scored every slot one by one from a staged
// code tile and re-read 6 KB of codewords and query from L2 per slot.  Now
// the slots are grouped by query on the card; a query with many slots
// (more than the wrapper's slot_limit) gets a lookup table, built once
// into scratch and staged in shared memory by each of its work items, so
// that a slot costs M table reads and adds; a query with few slots (the
// hybrid tier's tail blocks, Ks far above the slots) is scored slot by
// slot, with the same arithmetic, and builds no table.  The dense tiles no
// longer matter to the kernel (a code row is read by each slot that wants
// it, 96 bytes at PQ(96, 256)).  The padding query Qb - 1, which owns over
// half of the slots of the flagship dense layout, is counted per block and
// split into work items of item_slots slots.  The body, its two routes,
// its launch sequence and what bounds it are in adc_lut.cuh, shared with
// K3.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_lut.cuh"

// Pointers are device pointers: codes (N_pad, m) of code_bytes each and codebooks
// (m, ks, ds) fp32, both contiguous (the wrapper checks); qT element
// (d, qno) is at q[d * q_stride_d + qno * q_stride_q]; scratch holds
// 3 * qb + 4 + n_tiles * cap 64-bit words and lut the tables of lut_queries
// queries, lut_queries * m * width fp32 (width: 256 for uint8 codes, else
// Ks rounded up to a multiple of 4).  Queries with fewer than slot_limit
// slots are scored slot-wise.  Tier codes: 0 exact, 1 high, 2 fast.  The
// launches go on `stream` of `device` and do not synchronise.  Returns the
// cudaError_t of the first failing launch (0 on success).
extern "C" int ff_stream_select_pq(const void* codes, int m,
                                   const void* codebooks, int ks, int ds,
                                   const void* q, long long q_stride_d,
                                   long long q_stride_q, const void* cand,
                                   const void* tile_idx, void* out,
                                   int n_tiles, int cap, int qb, int r,
                                   int tier, void* scratch, int item_slots,
                                   long long max_items, void* lut,
                                   int lut_queries, int code_bytes,
                                   int width, long long slot_limit,
                                   int device, void* stream) {
  if (n_tiles <= 0) return 0;
  // this object links its own CUDA runtime, whose current device is not
  // PyTorch's: select the device the stream belongs to
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ff::AdcArgs a{codes,
                      code_bytes,
                      m,
                      static_cast<const float*>(codebooks),
                      ks,
                      ds,
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
                      max_items,
                      static_cast<float*>(lut),
                      lut_queries,
                      width,
                      slot_limit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case 0:
      err = ff::adc_lut_launch<false, false>(a, s);
      break;
    case 1:
      err = ff::adc_lut_launch<true, false>(a, s);
      break;
    case 2:
      err = ff::adc_lut_launch<true, true>(a, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The route each of qb queries takes for the n_slots packed candidates
// `cand` at slot_limit, as ff_stream_select_pq (and K3) decide it: routes
// (qb int32) gets 0 for a query without slots, 1 for the table route, 2
// for the slot-wise route.  scratch holds 3 * qb + 4 + n_slots 64-bit
// words.  Returns the cudaError_t of the first failing launch.
extern "C" int ff_routes(const void* cand, long long n_slots, int qb,
                         long long slot_limit, void* scratch, void* routes,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(ff::group_routes(
      static_cast<const int*>(cand), n_slots, qb, slot_limit,
      static_cast<ff::u64*>(scratch), static_cast<int*>(routes),
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
