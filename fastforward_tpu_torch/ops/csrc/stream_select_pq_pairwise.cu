// K3 for Hopper: pairwise streamed ADC over PQ codes, one warp per slot.
//
// Replaces the Pallas kernel fastforward_tpu/ops/stream_kernel_pq.py:
// stream_select_pq_pairwise (body _adc_pairwise_kernel).  ADC (asymmetric
// distance computation) scores a query against PQ codes without decoding
// the row first.  Same contract: for every slot s of virtual tile t, with
// c = cand[t, s], local = c / Qb, qno = c % Qb and row = tile_idx[t]*R + local,
//
//     out[t, s] = sum_m codebook[m, codes[row, m]] . q[qno, m*Ds:(m+1)*Ds]
//
// exact = 1 (the "exact" and "high" tiers) is an fp32 dot of the fp32
// codewords and the query; exact = 0 (the "fast" tier) rounds both the
// codeword element and the query element to bf16 (round to nearest even)
// and accumulates in fp32.  Codes are uint8 (Ks <= 256), (N_pad, M) row
// major; codebooks are fp32 (M, Ks, Ds).  Padding slots (local 0, qno Qb-1)
// are computed like any other slot.
//
// The TPU kernel selects code rows and queries with one-hot matmuls and
// dequantizes through block-diagonal hi/mid/lo bf16 codebooks, because
// Mosaic has no dynamic gather and the MXU wants 128 lanes.  Here lane j of
// the slot's warp takes subspaces m = j, j+32, ...: it reads the code byte
// (the warp reads the row's M bytes together), the Ds fp32 codeword values
// and the matching Ds query values, and the warp sums its 32 partial dots
// with shuffles.
//
// Bound: memory, and mostly not the table's.  Each slot reads M code bytes
// (96 B at PQ(96, 256)), so 512k slots read ~50 MB of codes, 0.015 ms at
// 3.35 TB/s.  Each slot also reads M*Ds codeword values and dim query
// values (3 KB each at dim 768); the codebooks (786 KB at 96x256x8) and the
// query block stay in L2, and those L2 reads set the time of this simple
// form.  chip_smoke.py computes the device-memory bound for its card.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kExact>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    adc_pairwise_kernel(const uint8_t* __restrict__ codes, int m,
                        const float* __restrict__ codebooks, int ks, int ds,
                        const float* __restrict__ q,
                        const int* __restrict__ cand,
                        const int* __restrict__ tile_idx,
                        float* __restrict__ out, long long n_slots, int cap,
                        int qb, int r) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= n_slots) return;  // the whole warp leaves together
  const int c = __ldg(cand + slot);
  const int t = static_cast<int>(slot / cap);
  const long long row =
      static_cast<long long>(__ldg(tile_idx + t)) * r + c / qb;
  const uint8_t* crow = codes + row * m;
  const float* qrow = q + static_cast<long long>(c % qb) * m * ds;

  float acc = 0.0f;
  for (int j = lane; j < m; j += 32) {
    const int code = __ldg(crow + j);
    const float* cw = codebooks + (static_cast<long long>(j) * ks + code) * ds;
    const float* qs = qrow + static_cast<long long>(j) * ds;
    for (int e = 0; e < ds; ++e) {
      float a = __ldg(cw + e);
      float b = __ldg(qs + e);
      if (!kExact) {
        a = round_bf16(a);
        b = round_bf16(b);
      }
      acc = fmaf(a, b, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[slot] = acc;
}

}  // namespace

// Pointers are device pointers: codes (N_pad, m) uint8, codebooks
// (m, ks, ds) fp32, q (qb, m * ds) fp32, all contiguous (the wrapper
// checks).  The launch goes on `stream` of `device` and does not
// synchronise.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ff_stream_select_pq_pairwise(
    const void* codes, int m, const void* codebooks, int ks, int ds,
    const void* q, const void* cand, const void* tile_idx, void* out,
    long long n_slots, int cap, int qb, int r, int exact, int device,
    void* stream) {
  if (n_slots <= 0) return 0;
  // this object links its own CUDA runtime, whose current device is not
  // PyTorch's: select the device the stream belongs to
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(
      static_cast<unsigned>((n_slots + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c8 = static_cast<const uint8_t*>(codes);
  const float* cb = static_cast<const float*>(codebooks);
  const float* qf = static_cast<const float*>(q);
  const int* cd = static_cast<const int*>(cand);
  const int* ti = static_cast<const int*>(tile_idx);
  float* o = static_cast<float*>(out);
  if (exact) {
    adc_pairwise_kernel<true><<<grid, block, 0, s>>>(
        c8, m, cb, ks, ds, qf, cd, ti, o, n_slots, cap, qb, r);
  } else {
    adc_pairwise_kernel<false><<<grid, block, 0, s>>>(
        c8, m, cb, ks, ds, qf, cd, ti, o, n_slots, cap, qb, r);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
