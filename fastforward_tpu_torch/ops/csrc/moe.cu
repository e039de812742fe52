// The expert layer of a DeepSeek-V3 decoder (Moonlight-16B-A3B's:
// fastforward_tpu_torch/models/deepseek.py, DeepseekTower._moe), between
// the layer's RMSNorm and its residual:
//
//   s      = sigmoid(W_router h)                       (fp32, E experts)
//   chosen = the top K of s + bias                     (the bias picks only)
//   w_k    = s_k / sum_k s_k * scale                   (over the K chosen)
//   out    = x + sum_k w_k E_k(h) + S(h)               (E_k, S: SwiGLU MLPs)
//
// - route_kernel: the sigmoid, the biased top K, the weights, and each
//   chosen pair's slot among the pairs of its expert (an atomic count a
//   expert); padded tokens route to no expert;
// - permute_kernel: each expert's first row (an exclusive scan of the
//   counts), the token of each row of the expert-sorted order, and each
//   pair's row;
// - grouped_gemm_kernel: C[r] = A[token(r)] W_e^T for the rows r of each
//   expert's segment, bf16 operands on tensor cores (WMMA 16x16x16), fp32
//   sums, bf16 out; the segments' bounds are read on the device;
// - combine_kernel: x + S(h) + sum_k w_k y_k in fp32, rounded to bf16 once.
//
// The router's logits (one fp32 GEMM), the SiLU product between the two
// grouped GEMMs (decoder.cu's swiglu_kernel) and the shared expert S (cuBLAS
// GEMMs and swiglu_kernel) run outside this file.  No host synchronisation:
// every count, offset and row stays on the card, and no token is dropped
// (no capacity: a grouped GEMM's grid covers every way the rows can fall).
//
// Replaces no TPU kernel: the JAX package has no decoder.  At Moonlight's
// widths (64 experts of 2,048 x 1,408 a projection, top 6) on a micro-batch
// of 128 queries (~3,100 real tokens, ~290 a expert) the expert GEMMs sit
// at the card's bf16 ridge: ~0.33 ms of tensor-core work against ~0.33 ms
// of reading the 1.1 GB of expert weights once.  This first design is the
// plain tiled one (64 x 64 tiles, 4 warps, a two-stage cp.async ring, one
// tile of one expert a block): correct and simple first.  The routing and
// the combine are bound by bytes (logits and hidden rows read once).
//
// Numbers: the sigmoid, the sums of the chosen scores, the weights and the
// combine are fp32 on CUDA cores with no contraction into FMAs
// (__fmul_rn / __fadd_rn), as the plain versions in models/deepseek.py
// compute them; the GEMMs' fp32 sums run in tensor-core order.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface at the end).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace ff {
namespace moe {

using bf16 = __nv_bfloat16;

constexpr int kMaxExperts = 256;
constexpr int kPerLane = kMaxExperts / 32;
constexpr int kMaxTopK = 8;

// ---------------------------------------------------------------------------
// Routing.  One warp a token: lane l holds experts l, l + 32, ...; K rounds
// of a warp-wide argmax of the biased scores (ties to the lower expert),
// each taking its winner out.  Lane 0 then writes the K experts in that
// order, their weights, and each pair's slot (an atomicAdd on its expert's
// count).  Bound: the logits read once.

constexpr int kRouteWarps = 8;

__global__ void __launch_bounds__(kRouteWarps * 32)
    route_kernel(const float* __restrict__ logits, const float* __restrict__ bias,
                 const int* __restrict__ mask, long long tokens, int experts, int top_k,
                 int norm, float scale, int* __restrict__ ids, float* __restrict__ weights,
                 int* __restrict__ slots, int* __restrict__ counts) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long t = static_cast<long long>(blockIdx.x) * kRouteWarps + warp;
  if (t >= tokens) return;
  const long long at = t * top_k;
  if (mask[t] == 0) {
    for (int k = lane; k < top_k; k += 32) {
      ids[at + k] = -1;
      weights[at + k] = 0.f;
      slots[at + k] = -1;
    }
    return;
  }
  const float* row = logits + t * experts;
  float score[kPerLane], choice[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = lane + 32 * j;
    if (e < experts) {
      score[j] = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-row[e])));
      choice[j] = __fadd_rn(score[j], bias[e]);
    } else {
      score[j] = 0.f;
      choice[j] = -CUDART_INF_F;
    }
  }
  float picked[kMaxTopK];
  int picked_e[kMaxTopK];
#pragma unroll
  for (int k = 0; k < kMaxTopK; ++k) {
    if (k >= top_k) break;
    float best = -CUDART_INF_F;
    int best_e = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      if (e < experts && (choice[j] > best || (choice[j] == best && e < best_e))) {
        best = choice[j];
        best_e = e;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oe = __shfl_xor_sync(0xffffffffu, best_e, o);
      if (ob > best || (ob == best && oe < best_e)) {
        best = ob;
        best_e = oe;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (lane + 32 * j == best_e) {
        s = score[j];
        choice[j] = -CUDART_INF_F;  // taken: a -inf ties with nothing above it
      }
    }
    picked[k] = __shfl_sync(0xffffffffu, s, best_e % 32);
    picked_e[k] = best_e;
  }
  if (lane != 0) return;
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxTopK; ++k) {
    if (k < top_k) total = __fadd_rn(total, picked[k]);
  }
#pragma unroll
  for (int k = 0; k < kMaxTopK; ++k) {
    if (k >= top_k) break;
    const int e = picked_e[k];
    ids[at + k] = e;
    weights[at + k] = norm ? __fmul_rn(__fdiv_rn(picked[k], total), scale) : __fmul_rn(picked[k], scale);
    slots[at + k] = atomicAdd(counts + e, 1);
  }
}

// ---------------------------------------------------------------------------
// Permutation.  Each block scans the E counts into shared memory (block 0
// also writes them out as the segments' offsets), then each pair (token t,
// choice k) with expert e takes row offsets[e] + slot: rows[row] = t and
// pos[t, k] = row (-1 for a padded token).

constexpr int kPermuteThreads = 256;

__global__ void __launch_bounds__(kPermuteThreads)
    permute_kernel(const int* __restrict__ ids, const int* __restrict__ slots,
                   const int* __restrict__ counts, long long pairs, int top_k, int experts,
                   int* __restrict__ offsets, int* __restrict__ rows, int* __restrict__ pos) {
  __shared__ int off[kMaxExperts + 1];
  if (threadIdx.x == 0) {
    int run = 0;
    for (int e = 0; e < experts; ++e) {
      off[e] = run;
      run += counts[e];
    }
    off[experts] = run;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int e = threadIdx.x; e <= experts; e += blockDim.x) offsets[e] = off[e];
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < pairs;
       p += stride) {
    const int e = ids[p];
    if (e < 0) {
      pos[p] = -1;
      continue;
    }
    const int r = off[e] + slots[p];
    rows[r] = static_cast<int>(p / top_k);
    pos[p] = r;
  }
}

// ---------------------------------------------------------------------------
// Grouped GEMM.  C_z[r, :] = A[a_rows[r], :] W_{z, e}^T for each row r of
// expert e's segment [offsets[e], offsets[e + 1]) (a_rows null: A's row r),
// W_{z, e} an (n, k) bf16 matrix whose address is table[z * E + e], z the
// grid's third index (gate and up in one launch).  A block computes one
// 64 x 64 tile of one expert: blockIdx.y counts the segments' row tiles in
// expert order (each block finds its own by walking the offsets; the grid
// has room for ceil(rows / 64) + E tiles, every way the rows can fall), and
// blockIdx.x the column tiles.  Four warps, 32 x 32 each as 2 x 2 WMMA
// tiles; the k loop in steps of 32 through a two-stage cp.async ring (rows
// past the segment read as zeros); the fp32 tile goes through shared
// memory and out as bf16, the segment's rows only.

constexpr int kBM = 64, kBN = 64, kBK = 32, kPad = 8;
constexpr int kGemmThreads = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kGemmThreads)
    grouped_gemm_kernel(const bf16* __restrict__ a, const int* __restrict__ a_rows,
                        long long lda, const bf16* const* __restrict__ table,
                        const int* __restrict__ offsets, int experts, int n, int k,
                        bf16* __restrict__ c0, bf16* __restrict__ c1) {
  using namespace nvcuda;
  int tile = blockIdx.y, e = 0, lo = 0, hi = 0;
  for (; e < experts; ++e) {
    lo = offsets[e];
    hi = offsets[e + 1];
    const int tiles = (hi - lo + kBM - 1) / kBM;
    if (tile < tiles) break;
    tile -= tiles;
  }
  if (e == experts) return;  // past the last tile
  const int r0 = lo + tile * kBM;
  const int m = min(kBM, hi - r0);
  const int n0 = blockIdx.x * kBN;
  const bf16* w = table[blockIdx.z * experts + e];
  bf16* c = blockIdx.z == 0 ? c0 : c1;

  __shared__ __align__(128) bf16 as[2][kBM][kBK + kPad];
  __shared__ __align__(128) bf16 bs[2][kBN][kBK + kPad];
  __shared__ __align__(128) float cs[kBM][kBN + 4];

  // each thread copies two 16-byte chunks of A's tile and two of W's a step
  const bf16* a_src[2];
  const bf16* b_src[2];
  int a_bytes[2], row_of[2], col_of[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = threadIdx.x + kGemmThreads * i;
    row_of[i] = id / (kBK / 8);
    col_of[i] = (id % (kBK / 8)) * 8;
    const bool ok = row_of[i] < m;
    const long long src = ok ? (a_rows != nullptr ? a_rows[r0 + row_of[i]] : r0 + row_of[i]) : 0;
    a_src[i] = a + src * lda + col_of[i];
    a_bytes[i] = ok ? 16 : 0;
    b_src[i] = w + static_cast<long long>(n0 + row_of[i]) * k + col_of[i];
  }
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cp_async16(&as[stage][row_of[i]][col_of[i]], a_src[i] + k0, a_bytes[i]);
      cp_async16(&bs[stage][row_of[i]][col_of[i]], b_src[i] + k0, 16);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  const int steps = k / kBK;
  load(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int stage = s & 1;
    if (s + 1 < steps) {
      load(stage ^ 1, (s + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], &as[stage][wm + 16 * i][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bfr[j], &bs[stage][wn + 16 * j][kk], kBK + kPad);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
    }
    __syncthreads();  // the stage is read before it is loaded again
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&cs[wm + 16 * i][wn + 16 * j], acc[i][j], kBN + 4, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int id = threadIdx.x; id < kBM * kBN / 8; id += kGemmThreads) {
    const int row = id / (kBN / 8), col = (id % (kBN / 8)) * 8;
    if (row >= m) continue;
    uint4 raw;
    bf16* out = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __float2bfloat16_rn(cs[row][col + i]);
    *reinterpret_cast<uint4*>(c + static_cast<long long>(r0 + row) * n + n0 + col) = raw;
  }
}

// ---------------------------------------------------------------------------
// Combine.  One block a token: for each 8 columns, the K expert rows
// weighted and summed in fp32 in choice order, then the shared expert's row
// and the residual added, rounded to bf16 once.  Bound: the K expert rows,
// the shared row and the residual read once, the output written once.

constexpr int kCombineThreads = 256;

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(const bf16* __restrict__ y, const int* __restrict__ pos,
                   const float* __restrict__ weights, const bf16* __restrict__ shared,
                   const bf16* __restrict__ residual, bf16* __restrict__ out, int top_k,
                   int hidden) {
  const long long t = blockIdx.x;
  const long long at = t * top_k;
  for (int c = threadIdx.x; c < hidden / 8; c += blockDim.x) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < top_k; ++k) {
      const int r = pos[at + k];
      if (r < 0) continue;
      const float wk = weights[at + k];
      float v[8];
      load8(y + static_cast<long long>(r) * hidden + 8 * c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wk, v[i]));
    }
    float sh[8], res[8];
    load8(shared + t * hidden + 8 * c, sh);
    load8(residual + t * hidden + 8 * c, res);
    uint4 raw;
    bf16* o = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16_rn(__fadd_rn(__fadd_rn(acc[i], sh[i]), res[i]));
    *reinterpret_cast<uint4*>(out + t * hidden + 8 * c) = raw;
  }
}

}  // namespace moe
}  // namespace ff

// The C interface.  Pointers are device pointers of contiguous tensors,
// 16-byte aligned (the wrappers in models/deepseek.py check shapes, types,
// alignment and devices).  Each entry selects `device` (this object links
// its own CUDA runtime, whose current device is not PyTorch's), launches on
// `stream` without synchronising, and returns the cudaError_t of the launch
// (0 on success).

namespace {

cudaError_t use_device(int device) { return cudaSetDevice(device); }

}  // namespace

// logits (tokens, experts) fp32, bias (experts) fp32, mask (tokens) int32;
// ids, slots (tokens, top_k) int32, weights (tokens, top_k) fp32 out;
// counts (experts) int32, zeroed by the caller, added to.  experts <= 256,
// top_k <= 8.
extern "C" int ff_moe_route(const void* logits, const void* bias, const void* mask,
                            long long tokens, int experts, int top_k, int norm, float scale,
                            void* ids, void* weights, void* slots, void* counts, int device,
                            void* stream) {
  using namespace ff::moe;
  if (tokens <= 0) return 0;
  if (experts > kMaxExperts || top_k > kMaxTopK || top_k > experts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (tokens + kRouteWarps - 1) / kRouteWarps;
  route_kernel<<<static_cast<unsigned>(blocks), kRouteWarps * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(bias),
      static_cast<const int*>(mask), tokens, experts, top_k, norm, scale, static_cast<int*>(ids),
      static_cast<float*>(weights), static_cast<int*>(slots), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// ids, slots (pairs) int32 from ff_moe_route, counts (experts); offsets
// (experts + 1), rows (pairs; the first offsets[experts] written) and pos
// (pairs) int32 out.
extern "C" int ff_moe_permute(const void* ids, const void* slots, const void* counts,
                              long long pairs, int top_k, int experts, void* offsets, void* rows,
                              void* pos, int device, void* stream) {
  using namespace ff::moe;
  if (pairs <= 0) return 0;
  if (experts > kMaxExperts) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (pairs + kPermuteThreads - 1) / kPermuteThreads;
  blocks = blocks > 1024 ? 1024 : blocks;
  permute_kernel<<<static_cast<unsigned>(blocks), kPermuteThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const int*>(slots),
      static_cast<const int*>(counts), pairs, top_k, experts, static_cast<int*>(offsets),
      static_cast<int*>(rows), static_cast<int*>(pos));
  return static_cast<int>(cudaGetLastError());
}

// a (.., k) bf16 rows at stride lda, a_rows (max_rows) int32 or null; table
// (sets * experts) device pointers to (n, k) bf16 matrices; offsets (experts
// + 1) int32 on the device, offsets[experts] <= max_rows; c0, c1 (max_rows,
// n) bf16 (c1 for sets == 2).  n % 64 == 0, k % 32 == 0, lda % 8 == 0.
extern "C" int ff_moe_grouped_gemm(const void* a, const void* a_rows, long long lda,
                                   const void* table, int sets, const void* offsets, int experts,
                                   long long max_rows, int n, int k, void* c0, void* c1,
                                   int device, void* stream) {
  using namespace ff::moe;
  if (max_rows <= 0) return 0;
  if (n % kBN || k % kBK || lda % 8 || sets < 1 || sets > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (max_rows + kBM - 1) / kBM + experts;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n / kBN), static_cast<unsigned>(tiles),
                  static_cast<unsigned>(sets));
  grouped_gemm_kernel<<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const int*>(a_rows), lda,
      static_cast<const bf16* const*>(table), static_cast<const int*>(offsets), experts, n, k,
      static_cast<bf16*>(c0), static_cast<bf16*>(c1));
  return static_cast<int>(cudaGetLastError());
}

// y (rows, hidden) bf16 expert outputs, pos and weights (tokens, top_k)
// int32 / fp32, shared and residual (tokens, hidden) bf16; out (tokens,
// hidden) bf16.  hidden % 8 == 0.
extern "C" int ff_moe_combine(const void* y, const void* pos, const void* weights,
                              const void* shared, const void* residual, void* out,
                              long long tokens, int top_k, int hidden, int device, void* stream) {
  using namespace ff::moe;
  if (tokens <= 0) return 0;
  if (hidden % 8 || tokens > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (hidden / 8 + 31) / 32 * 32;
  threads = threads < kCombineThreads ? threads : kCombineThreads;
  combine_kernel<<<static_cast<unsigned>(tokens), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(pos),
      static_cast<const float*>(weights), static_cast<const bf16*>(shared),
      static_cast<const bf16*>(residual), static_cast<bf16*>(out), top_k, hidden);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
