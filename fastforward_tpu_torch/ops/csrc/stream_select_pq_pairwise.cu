// K3 for Hopper: pairwise streamed ADC over PQ codes, query-major.
//
// Replaces the Pallas kernel fastforward_tpu/ops/stream_kernel_pq.py:351
// stream_select_pq_pairwise (body _adc_pairwise_kernel, :191), which the
// JAX package routes where cap <= R.  ADC (asymmetric distance computation)
// scores a query against PQ codes without decoding the row.  Same contract:
// for every slot s of virtual tile t, with c = cand[t, s], local = c / Qb,
// qno = c % Qb and row = tile_idx[t] * R + local,
//
//     out[t, s] = sum_m codebook[m, codes[row, m]] . q[qno, m*Ds:(m+1)*Ds]
//
// exact = 1 (the "exact" and "high" tiers) is an fp32 dot of the fp32
// codewords and the query; exact = 0 (the "fast" tier) rounds both the
// codeword element and the query element to bf16 (round to nearest even)
// and accumulates in fp32.  Codes are uint8 (Ks <= 256), (N_pad, M) row
// major, any M; codebooks are fp32 (M, Ks, Ds).
//
// The TPU kernel selects code rows and queries with one-hot matmuls and
// dequantizes through block-diagonal hi/mid/lo bf16 codebooks, because
// Mosaic has no dynamic gather and the MXU wants 128 lanes.  This kernel
// starts from what ADC computes instead: the slots are grouped by query on
// the card, each query's lookup table (its subvector dotted with every
// codeword) is built once into scratch and staged in shared memory by each
// work item of the query, and a slot then costs M table reads and adds,
// where the first form of this kernel re-read 6 KB of codewords and query
// from L2 per slot.  The padding query Qb - 1,
// which owns over half of the slots of the flagship layout, is counted per
// block and split into work items of item_slots slots.  The body, its
// launch sequence and what bounds it are in adc_lut.cuh, shared with K4.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_lut.cuh"

// Pointers are device pointers: codes (N_pad, m) uint8, codebooks
// (m, ks, ds) fp32, q (qb, m * ds) fp32, all contiguous (the wrapper
// checks); scratch holds 3 * qb + 2 + n_slots 64-bit words and lut the
// tables of lut_queries queries, lut_queries * m * 256 fp32.  The launches
// go on `stream` of `device` and do not synchronise.  Returns the
// cudaError_t of the first failing launch (0 on success).
extern "C" int ff_stream_select_pq_pairwise(
    const void* codes, int m, const void* codebooks, int ks, int ds,
    const void* q, const void* cand, const void* tile_idx, void* out,
    long long n_slots, int cap, int qb, int r, int exact, void* scratch,
    int item_slots, long long max_items, void* lut, int lut_queries,
    int device, void* stream) {
  if (n_slots <= 0) return 0;
  // this object links its own CUDA runtime, whose current device is not
  // PyTorch's: select the device the stream belongs to
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ff::AdcArgs a{static_cast<const uint8_t*>(codes),
                      m,
                      static_cast<const float*>(codebooks),
                      ks,
                      ds,
                      static_cast<const float*>(q),
                      1,
                      static_cast<long long>(m) * ds,
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
                      static_cast<float*>(lut),
                      lut_queries};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = exact ? ff::adc_lut_launch<false, false>(a, s)
              : ff::adc_lut_launch<true, true>(a, s);
  return static_cast<int>(err);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
