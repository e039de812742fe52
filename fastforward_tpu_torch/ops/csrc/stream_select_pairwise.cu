// K1 for Hopper: pairwise stream-select scoring, one warp per candidate slot.
//
// Replaces the Pallas kernel fastforward_tpu/ops/stream_kernel.py:
// stream_select_pairwise (body _pairwise_kernel).  Same contract: for every
// slot s of virtual tile t, with c = cand[t, s], local = c / Qb and
// qno = c % Qb,
//
//     out[t, s] = table[tile_idx[t] * R + local] . q[qno]
//
// exact = 1 is a true fp32 dot; exact = 0 rounds the row element and the
// query element to bf16 (round to nearest even) before the multiply and
// accumulates in fp32, the single-pass bf16 tier of the TPU kernel.  The
// table is fp32, bf16 or int8 (int8 codes with the scales already folded
// into the queries by the caller); the query block is always fp32.
//
// The TPU kernel selects rows and queries with one-hot matmuls because
// Mosaic has no dynamic gather.  This kernel reads the selected row and
// query directly: each lane loads 16 bytes of the row per step (4 fp32,
// 8 bf16 or 16 int8 elements), multiplies them by the matching query
// elements, and the warp reduces its 32 partial sums with shuffles.  Padding
// slots (local 0, qno Qb-1) are computed like any other slot.
//
// Bound: memory.  Every slot reads one table row, and each row is read
// about once per call (queries and padding rows stay in L2).  At the
// flagship shape (512k candidate pairs, dim 768) the rows are
// 512k x 768 x 4 B = 1.57 GB for fp32, 0.79 GB for bf16 and 0.39 GB for
// int8; at the H100 SXM's 3.35 TB/s that is 0.47 ms, 0.23 ms and 0.12 ms.
// The arithmetic (2 x 768 flops per slot) is far below the fp32 rate.
// chip_smoke.py computes the bound for the card it runs on.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;

// One 16-byte load of table elements, widened to fp32 (exact for all three).
template <typename T>
struct RowVec;

template <>
struct RowVec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&x)[N]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <>
struct RowVec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&x)[N]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // little endian: element 2i in the low half, 2i+1 in the high half;
      // a bf16 is the high 16 bits of the fp32 with the same value
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct RowVec<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, float (&x)[N]) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t b = static_cast<int8_t>(
            static_cast<uint8_t>((static_cast<unsigned>(w[i]) >> (8 * j)) & 0xffu));
        x[4 * i + j] = static_cast<float>(b);
      }
    }
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, bool kExact>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    pairwise_kernel(const T* __restrict__ table, const float* __restrict__ q,
                    const int* __restrict__ cand,
                    const int* __restrict__ tile_idx, float* __restrict__ out,
                    long long n_slots, int cap, int qb, int r, int dim) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= n_slots) return;  // the whole warp leaves together
  const int c = __ldg(cand + slot);
  const int t = static_cast<int>(slot / cap);
  const long long row =
      static_cast<long long>(__ldg(tile_idx + t)) * r + c / qb;
  const T* trow = table + row * dim;
  const float* qrow = q + static_cast<long long>(c % qb) * dim;

  constexpr int V = RowVec<T>::N;
  float acc = 0.0f;
#pragma unroll 2
  for (int i = lane * V; i < dim; i += 32 * V) {
    float x[V];
    RowVec<T>::load(trow + i, x);
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 qv = __ldg(reinterpret_cast<const float4*>(qrow + i + j));
      const float qq[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float a = x[j + k];
        float b = qq[k];
        if (!kExact) {
          // bf16 and int8 elements are already exact in bf16
          if (std::is_same<T, float>::value) a = round_bf16(a);
          b = round_bf16(b);
        }
        acc = fmaf(a, b, acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[slot] = acc;
}

template <typename T>
void launch(const void* table, const void* q, const void* cand,
            const void* tile_idx, void* out, long long n_slots, int cap,
            int qb, int r, int dim, int exact, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(
      static_cast<unsigned>((n_slots + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const T* t = static_cast<const T*>(table);
  const float* qf = static_cast<const float*>(q);
  const int* c = static_cast<const int*>(cand);
  const int* ti = static_cast<const int*>(tile_idx);
  float* o = static_cast<float*>(out);
  if (exact) {
    pairwise_kernel<T, true><<<grid, block, 0, stream>>>(
        t, qf, c, ti, o, n_slots, cap, qb, r, dim);
  } else {
    pairwise_kernel<T, false><<<grid, block, 0, stream>>>(
        t, qf, c, ti, o, n_slots, cap, qb, r, dim);
  }
}

}  // namespace

// Table dtype codes: 0 fp32, 1 bf16, 2 int8.  Pointers are device pointers
// (16-byte aligned, rows of dim elements with dim % 128 == 0; the wrapper
// checks); the launch goes on `stream` of `device` and does not
// synchronise.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ff_stream_select_pairwise(const void* table, int dtype,
                                         const void* q, const void* cand,
                                         const void* tile_idx, void* out,
                                         long long n_slots, int cap, int qb,
                                         int r, int dim, int exact,
                                         int device, void* stream) {
  if (n_slots <= 0) return 0;
  // this object links its own CUDA runtime, whose current device is not
  // PyTorch's: select the device the stream belongs to
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(table, q, cand, tile_idx, out, n_slots, cap, qb, r, dim,
                    exact, s);
      break;
    case 1:
      launch<__nv_bfloat16>(table, q, cand, tile_idx, out, n_slots, cap, qb,
                            r, dim, exact, s);
      break;
    case 2:
      launch<int8_t>(table, q, cand, tile_idx, out, n_slots, cap, qb, r, dim,
                     exact, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
