// K4 for Hopper: streamed ADC over PQ codes for dense virtual tiles, one
// block per virtual tile with the tile's code block staged in shared memory.
//
// Replaces the Pallas kernel fastforward_tpu/ops/stream_kernel_pq.py:
// stream_select_pq (body _adc_kernel).  Same contract: for every slot s of
// virtual tile t, with c = cand[t, s], local = c / Qb, qno = c % Qb and
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
// fastforward_tpu.  Codes are uint8 (Ks <= 256), (N_pad, M) row major;
// codebooks are fp32 (M, Ks, Ds).  Padding slots (local 0, qno Qb-1) are
// computed like any other slot.
//
// The TPU kernel decodes the whole R-row tile through block-diagonal bf16
// codebooks on the MXU, multiplies it by every query, then selects each
// slot's score with one-hot matmuls (Mosaic has no dynamic gather).  This
// kernel computes only the cap slot dots.  It runs where the tiles are
// dense (cap > R), so the block stages the tile's R x M code block in shared
// memory once (512 x 96 B = 48 KB at PQ(96, 256); larger M is staged in
// chunks) and its warps score every slot from there, lane j of a warp
// taking subspaces m = j, j+32, ... and the warp summing with shuffles.
// The staging skeleton is staged_tile.cuh, shared with K2.
//
// Bound: memory.  The code block is read once per virtual tile (25 MB of
// codes at N = 262,144 and M = 96); each slot also reads M*Ds codeword
// values and dim query values from L2, where the codebooks (786 KB) and the
// query block stay, and those reads set the time of this simple form.
// chip_smoke.py computes the device-memory bound for its card.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "staged_tile.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Copy `nbytes` into shared memory with the widest loads the alignment of
// `src` and `nbytes` allows (a tile's code block starts at row * M bytes).
__device__ void stage(unsigned char* dst, const unsigned char* src,
                      int nbytes) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  if ((addr & 15) == 0 && (nbytes & 15) == 0) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < nbytes / 16; i += ff::kStagedThreads) {
      d[i] = __ldg(s + i);
    }
  } else if ((addr & 3) == 0 && (nbytes & 3) == 0) {
    const int* s = reinterpret_cast<const int*>(src);
    int* d = reinterpret_cast<int*>(dst);
    for (int i = threadIdx.x; i < nbytes / 4; i += ff::kStagedThreads) {
      d[i] = __ldg(s + i);
    }
  } else {
    for (int i = threadIdx.x; i < nbytes; i += ff::kStagedThreads) {
      dst[i] = __ldg(src + i);
    }
  }
}

template <bool kRoundCodewords, bool kRoundQuery>
__global__ void __launch_bounds__(ff::kStagedThreads)
    adc_kernel(const uint8_t* __restrict__ codes, int m,
               const float* __restrict__ codebooks, int ks, int ds,
               const float* __restrict__ q, long long q_stride_d,
               long long q_stride_q, const int* __restrict__ cand,
               const int* __restrict__ tile_idx, float* __restrict__ out,
               int cap, int qb, int r, int chunk_rows) {
  extern __shared__ __align__(16) unsigned char staged[];

  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  float* out_t = out + static_cast<long long>(t) * cap;
  const long long base_row = static_cast<long long>(__ldg(tile_idx + t)) * r;

  auto stage_rows = [&](int row0, int rows) {
    stage(staged, codes + (base_row + row0) * m, rows * m);
  };
  auto score = [&](int s, int cv, int staged_row) {
    const unsigned char* crow = staged + staged_row * m;
    const float* qcol = q + static_cast<long long>(cv % qb) * q_stride_q;
    float acc = 0.0f;
    for (int j = lane; j < m; j += 32) {
      const float* cw =
          codebooks + (static_cast<long long>(j) * ks + crow[j]) * ds;
      const long long d0 = static_cast<long long>(j) * ds;
      for (int e = 0; e < ds; ++e) {
        float a = __ldg(cw + e);
        float b = __ldg(qcol + (d0 + e) * q_stride_d);
        if (kRoundCodewords) a = round_bf16(a);
        if (kRoundQuery) b = round_bf16(b);
        acc = fmaf(a, b, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out_t[s] = acc;
  };
  ff::for_each_staged_slot(cand + static_cast<long long>(t) * cap, cap, qb, r,
                           chunk_rows, stage_rows, score);
}

template <bool kRoundCodewords, bool kRoundQuery>
cudaError_t launch(const void* codes, int m, const void* codebooks, int ks,
                   int ds, const void* q, long long sd, long long sq,
                   const void* cand, const void* tile_idx, void* out,
                   int n_tiles, int cap, int qb, int r, cudaStream_t stream) {
  const int chunk_rows = ff::staged_chunk_rows(m, r);
  if (chunk_rows == 0) return cudaErrorInvalidValue;
  return ff::launch_staged(
      adc_kernel<kRoundCodewords, kRoundQuery>, n_tiles, chunk_rows * m,
      stream, static_cast<const uint8_t*>(codes), m,
      static_cast<const float*>(codebooks), ks, ds,
      static_cast<const float*>(q), sd, sq, static_cast<const int*>(cand),
      static_cast<const int*>(tile_idx), static_cast<float*>(out), cap, qb, r,
      chunk_rows);
}

}  // namespace

// Pointers are device pointers: codes (N_pad, m) uint8 and codebooks
// (m, ks, ds) fp32, both contiguous (the wrapper checks); qT element
// (d, qno) is at q[d * q_stride_d + qno * q_stride_q].  Tier codes: 0 exact,
// 1 high, 2 fast.  The launch goes on `stream` of `device` and does not
// synchronise.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ff_stream_select_pq(const void* codes, int m,
                                   const void* codebooks, int ks, int ds,
                                   const void* q, long long q_stride_d,
                                   long long q_stride_q, const void* cand,
                                   const void* tile_idx, void* out,
                                   int n_tiles, int cap, int qb, int r,
                                   int tier, int device, void* stream) {
  if (n_tiles <= 0) return 0;
  // this object links its own CUDA runtime, whose current device is not
  // PyTorch's: select the device the stream belongs to
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case 0:
      err = launch<false, false>(codes, m, codebooks, ks, ds, q, q_stride_d,
                                 q_stride_q, cand, tile_idx, out, n_tiles,
                                 cap, qb, r, s);
      break;
    case 1:
      err = launch<true, false>(codes, m, codebooks, ks, ds, q, q_stride_d,
                                q_stride_q, cand, tile_idx, out, n_tiles, cap,
                                qb, r, s);
      break;
    case 2:
      err = launch<true, true>(codes, m, codebooks, ks, ds, q, q_stride_d,
                               q_stride_q, cand, tile_idx, out, n_tiles, cap,
                               qb, r, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
