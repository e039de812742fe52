// The fp32 element-wise chains of a Mistral decoder layer
// (fastforward_tpu_torch/models/mistral.py, MistralTower), one kernel for
// each gap between two bf16 GEMMs:
//
// - rms_norm_kernel: x / sqrt(mean(x^2) + eps) * g, before the q/k/v
//   GEMMs, before the gate/up GEMMs, and the tower's final norm;
// - rope_attention_kernel: RoPE on q and k, the causal windowed
//   grouped-query attention and its softmax, between the q/k/v GEMMs and
//   the o GEMM;
// - swiglu_kernel: silu(gate) * up, between the gate/up GEMMs and the down
//   GEMM.
//
// Replaces no TPU kernel: the JAX package has no decoder.  Added because
// the plain PyTorch form of these chains runs each fp32 step as its own
// pass over the activations (casts up, the step, a cast down; RoPE's
// rotate_half as a cat; q, k and v permuted into the attention's layout
// and the context permuted back), about 50 launches and some 18 GB of
// device traffic a layer at E5-Mistral's widths over a 512-query call,
// against some 3 GB when each chain reads its bf16 inputs once and writes
// its bf16 output once.  Every kernel is bound by those bytes: their
// arithmetic is a few operations an element (the attention's logits and
// context over a few dozen keys a query run well under the card's fp32
// rate), so each design reads with 8- or 16-byte loads, keeps every
// intermediate in registers or shared memory, and writes its output once.
//
// Numbers: every norm, rotation, logit, softmax and SiLU is fp32 on CUDA
// cores (FMA; no TF32, no tensor cores), the inputs widened from the
// activation type T (bf16 or fp32) and the output rounded to T once, where
// the plain version rounds it.  Products and sums that the plain version
// rounds one by one use __fmul_rn / __fadd_rn, so the compiler does not
// contract them into FMAs.
//
// Built by fastforward_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes (plain C interface at the end).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace ff {
namespace decoder {

// dtype codes of the C interface: 0 fp32, 1 bf16
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// N elements of T at p (16-byte aligned, N * sizeof(T) a multiple of 16)
// as fp32, in 16-byte loads
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(N % kPer == 0, "whole 16-byte loads");
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + c * kPer);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = widen(e[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(N % kPer == 0, "whole 16-byte stores");
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) e[i] = narrow<T>(in[c * kPer + i]);
    *reinterpret_cast<uint4*>(p + c * kPer) = raw;
  }
}

// 4 consecutive elements (8 bytes of bf16, 16 of fp32; aligned to that)
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = widen(e[i]);
}
__device__ __forceinline__ void store4(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* in) {
  uint2 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = narrow<bf16>(in[i]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// RMSNorm.  One block a token row: the row's sum of squares in fp32 (each
// thread over its 16-byte chunks, then warp shuffles and one shared-memory
// step), then each element x * rsqrt(mean + eps) * g, written as TO.  The
// second pass re-reads the row (8 KB at hidden 4,096) from L1/L2.  Bound:
// the row read once and written once.

constexpr int kNormThreads = 256;

template <typename TI, typename TO>
__global__ void __launch_bounds__(kNormThreads)
    rms_norm_kernel(const TI* __restrict__ x, const float* __restrict__ gain,
                    TO* __restrict__ out, int hidden, float eps) {
  constexpr int kE = 8;  // elements a chunk: one bf16 load, two fp32 loads
  __shared__ float part[kNormThreads / 32];
  const long long row = blockIdx.x;
  const TI* xr = x + row * hidden;
  TO* outr = out + row * hidden;
  const int chunks = hidden / kE;
  float ss = 0.f;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    float v[kE];
    load_vec<TI, kE>(xr + c * kE, v);
#pragma unroll
    for (int i = 0; i < kE; ++i) ss = fmaf(v[i], v[i], ss);
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  ss = lane < static_cast<int>(blockDim.x / 32) ? part[lane] : 0.f;
  ss = warp_sum(ss);
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(hidden)), eps));
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    float v[kE], g[kE];
    load_vec<TI, kE>(xr + c * kE, v);
    load_vec<float, kE>(gain + c * kE, g);
#pragma unroll
    for (int i = 0; i < kE; ++i) v[i] = __fmul_rn(__fmul_rn(v[i], rstd), g[i]);
    store_vec<TO, kE>(outr + c * kE, v);
  }
}

template <typename TI, typename TO>
cudaError_t rms_norm_launch(const void* x, const void* gain, void* out,
                            long long rows, int hidden, float eps,
                            cudaStream_t s) {
  const int chunks = hidden / 8;
  int threads = (chunks + 31) / 32 * 32;
  threads = threads < kNormThreads ? threads : kNormThreads;
  rms_norm_kernel<TI, TO><<<static_cast<unsigned>(rows), threads, 0, s>>>(
      static_cast<const TI*>(x), static_cast<const float*>(gain),
      static_cast<TO*>(out), hidden, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SwiGLU.  silu(g) * u = g / (1 + exp(-g)) * u in fp32 over the gate and up
// GEMMs' outputs, element by element, rounded to T once.  Grid-stride over
// 16-byte chunks, then the last n % chunk elements one by one.  Bound: gate
// and up read once, the product written once.

constexpr int kSwigluThreads = 256;

__device__ __forceinline__ float silu_times(float g, float u) {
  return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))), u);
}

template <typename T>
__global__ void __launch_bounds__(kSwigluThreads)
    swiglu_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                  T* __restrict__ out, long long n) {
  constexpr int kE = 16 / sizeof(T);
  const long long chunks = n / kE;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long c = first; c < chunks; c += stride) {
    float g[kE], u[kE];
    load_vec<T, kE>(gate + c * kE, g);
    load_vec<T, kE>(up + c * kE, u);
#pragma unroll
    for (int i = 0; i < kE; ++i) g[i] = silu_times(g[i], u[i]);
    store_vec<T, kE>(out + c * kE, g);
  }
  for (long long i = chunks * kE + first; i < n; i += stride) {
    out[i] = narrow<T>(silu_times(widen(gate[i]), widen(up[i])));
  }
}

template <typename T>
cudaError_t swiglu_launch(const void* gate, const void* up, void* out,
                          long long n, cudaStream_t s) {
  const long long chunks = n / (16 / sizeof(T));
  long long blocks = (chunks + kSwigluThreads - 1) / kSwigluThreads;
  blocks = blocks < 1 ? 1 : (blocks > (1 << 20) ? (1 << 20) : blocks);
  swiglu_kernel<T><<<static_cast<unsigned>(blocks), kSwigluThreads, 0, s>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up),
      static_cast<T*>(out), n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// RoPE + causal windowed grouped-query attention.
//
// q is (B, L, heads, D), k and v (B, L, kv, D), all as the q/k/v GEMMs
// wrote them (no permute); the context is written as (B, L, heads, D),
// which is the (B, L, heads * D) the o GEMM reads.  Query head h reads
// key/value head h / G (G = heads / kv).  Query p sees key j when
// j <= p, p - j < window (window <= 0: no window) and mask[b, j] != 0.
//
// Grid: x = b * kv + g, one key/value head of one sequence; y = a tile of
// that head's L * G query rows (row r: position r / G, query head
// g * G + r % G), so k and v are read for the whole GQA group at once.
// A row is held by LPR = D / 16 lanes, 16 dims a lane: the lane's four
// float4 chunks c = sub + LPR * i (i = 0..3) of the row's D / 4, so the
// lanes of a row read consecutive 16 bytes of shared memory (no bank
// conflicts), and RoPE's partner of chunk c, c +- D / 8, is chunk i ^ 2 of
// the same lane.  A warp holds 32 / LPR rows, a block 8 warps.
//
// The block walks the keys its rows can see in tiles of kKeys: the tile's
// k (rotated, fp32) and v (fp32) go to shared memory, then each row takes
// the tile's keys four at a time: the logits (its lanes' FMA chains summed
// by xor shuffles, times 1 / sqrt(D), as PyTorch divides a CUDA tensor by
// a scalar) and, for the keys allowed, an online softmax step in fp32 (a
// running max, the sum of exp(logit - max) and the context, rescaled when
// the max rises).  Any length runs: the keys are walked in tiles up to the
// window.  A row that sees no key at all (a padded position past the
// window of every real key) gets what the plain version's softmax over
// logits that all read finfo.min gives: the mean of v over all L keys.
//
// Bound: q, k and v read once and the context written once (k and v of a
// tile are re-read from L2 by the row tiles of one head); the logits and
// context products, about 4 D flops a (row, key) pair, run on CUDA cores.
// At E5-Mistral's widths on 32 x 31 tokens the kernel takes ~35 us against
// ~6 us of bytes: the instructions a (row, key) pair costs (each row's
// lanes shuffle every logit together and each computes its exp) set it.

constexpr int kAttnWarps = 8;

template <typename T, int D>
__global__ void __launch_bounds__(kAttnWarps * 32)
    rope_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t,
                          const int* __restrict__ mask, T* __restrict__ out,
                          int length, int heads, int kv_heads, int window,
                          float inv_sqrt_d) {
  constexpr int kLanes = D / 16;             // lanes a row
  constexpr int kRowsPerWarp = 32 / kLanes;  // rows a warp holds
  constexpr int kRows = kAttnWarps * kRowsPerWarp;
  constexpr int kKeys = 32;                  // keys a tile (32 KB of k and v at D 128)
  constexpr int kChunks = D / 4;             // float4 chunks a row
  constexpr int kStep = 4;                   // keys a step of the inner loop
  __shared__ float4 ks[kKeys * kChunks];
  __shared__ float4 vs[kKeys * kChunks];
  __shared__ int key_ok[kKeys];

  const int group = heads / kv_heads;
  const int b = blockIdx.x / kv_heads, g = blockIdx.x % kv_heads;
  const long long seq = static_cast<long long>(b) * length;  // first token of b
  const int rows = length * group;
  const int r0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % kLanes;
  const int r = r0 + warp * kRowsPerWarp + lane / kLanes;
  const bool active = r < rows;
  const int pos = active ? r / group : 0;
  const int head = g * group + (active ? r % group : 0);

  // the row's rotated query, 16 dims: chunk i holds dims 4 (sub + kLanes i)
  float qr[16], acc[16];
  if (active) {
    const T* qrow = q + ((seq + pos) * heads + head) * D;
    float x[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(qrow + 4 * (sub + kLanes * i), x + 4 * i);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d0 = 4 * (sub + kLanes * i);
      float c4[4], s4[4];
      load4(cos_t + static_cast<long long>(pos) * D + d0, c4);
      load4(sin_t + static_cast<long long>(pos) * D + d0, s4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rotate_half: -x[d + D/2] in the first half, x[d - D/2] in the second
        const float partner = x[4 * (i ^ 2) + e];
        const float rot = i < 2 ? -partner : partner;
        qr[4 * i + e] = __fadd_rn(__fmul_rn(x[4 * i + e], c4[e]), __fmul_rn(rot, s4[e]));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) qr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float run_max = -CUDART_INF_F, run_sum = 0.f;

  // the keys this block's rows can see
  const int pos_lo = r0 / group;
  const int pos_hi = min(length - 1, (r0 + kRows - 1) / group);
  const int key_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;
  for (int t0 = key_lo; t0 <= pos_hi; t0 += kKeys) {
    const int n = min(kKeys, pos_hi - t0 + 1);
    __syncthreads();  // the previous tile is read
    for (int u = threadIdx.x; u < n * kChunks; u += blockDim.x) {
      const int jj = u / kChunks, c = u % kChunks;
      const int j = t0 + jj;
      const long long at = ((seq + j) * kv_heads + g) * D;
      float kx[4], kp[4], vx[4], c4[4], s4[4];
      const int pc = (c + kChunks / 2) % kChunks;  // RoPE's partner chunk
      load4(k + at + 4 * c, kx);
      load4(k + at + 4 * pc, kp);
      load4(v + at + 4 * c, vx);
      load4(cos_t + static_cast<long long>(j) * D + 4 * c, c4);
      load4(sin_t + static_cast<long long>(j) * D + 4 * c, s4);
      float rk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float rot = c < kChunks / 2 ? -kp[e] : kp[e];
        rk[e] = __fadd_rn(__fmul_rn(kx[e], c4[e]), __fmul_rn(rot, s4[e]));
      }
      ks[jj * kChunks + c] = make_float4(rk[0], rk[1], rk[2], rk[3]);
      vs[jj * kChunks + c] = make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    for (int jj = threadIdx.x; jj < n; jj += blockDim.x) {
      key_ok[jj] = mask[seq + t0 + jj] != 0;
    }
    __syncthreads();
    // four keys a step: four independent FMA chains and shuffle sums, then
    // one rescale for the four (a key past the tile reads the tile's last
    // and is not allowed)
    for (int jj = 0; jj < n; jj += kStep) {
      float dot[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int row = min(jj + u, n - 1) * kChunks + sub;
        dot[u] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 k4 = ks[row + kLanes * i];
          dot[u] = fmaf(qr[4 * i + 0], k4.x, dot[u]);
          dot[u] = fmaf(qr[4 * i + 1], k4.y, dot[u]);
          dot[u] = fmaf(qr[4 * i + 2], k4.z, dot[u]);
          dot[u] = fmaf(qr[4 * i + 3], k4.w, dot[u]);
        }
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kStep; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
      }
      bool ok[kStep];
      float step_max = run_max;
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int j = t0 + jj + u;
        ok[u] = active && jj + u < n && key_ok[jj + u] && j <= pos &&
                (window <= 0 || pos - j < window);
        dot[u] = __fmul_rn(dot[u], inv_sqrt_d);  // the logit
        if (ok[u]) step_max = fmaxf(step_max, dot[u]);
      }
      if (step_max > run_max) {
        const float corr = expf(run_max - step_max);  // 0 at the first key
        run_sum *= corr;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] *= corr;
        run_max = step_max;
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        if (!ok[u]) continue;
        const float p = expf(dot[u] - run_max);
        run_sum += p;
        const int row = (jj + u) * kChunks + sub;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v4 = vs[row + kLanes * i];
          acc[4 * i + 0] = fmaf(p, v4.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, v4.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, v4.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, v4.w, acc[4 * i + 3]);
        }
      }
    }
  }
  if (!active) return;
  if (run_max == -CUDART_INF_F) {
    // no key allowed: a uniform softmax over all L keys, as the plain
    // version's softmax of logits that all read finfo.min
    const float p = 1.f / static_cast<float>(length);
    for (int j = 0; j < length; ++j) {
      const T* vrow = v + ((seq + j) * kv_heads + g) * D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float vx[4];
        load4(vrow + 4 * (sub + kLanes * i), vx);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * i + e] = fmaf(p, vx[e], acc[4 * i + e]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = __fdiv_rn(acc[i], run_sum);
  }
  T* orow = out + ((seq + pos) * heads + head) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) store4(orow + 4 * (sub + kLanes * i), acc + 4 * i);
}

template <typename T, int D>
cudaError_t attention_launch_d(const void* q, const void* k, const void* v,
                               const void* cos_t, const void* sin_t,
                               const void* mask, void* out, int batch,
                               int length, int heads, int kv_heads, int window,
                               float inv_sqrt_d, cudaStream_t s) {
  constexpr int kRows = kAttnWarps * 32 / (D / 16);
  const long long rows = static_cast<long long>(length) * (heads / kv_heads);
  const dim3 grid(static_cast<unsigned>(batch) * kv_heads,
                  static_cast<unsigned>((rows + kRows - 1) / kRows));
  rope_attention_kernel<T, D><<<grid, kAttnWarps * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const int*>(mask),
      static_cast<T*>(out), length, heads, kv_heads, window, inv_sqrt_d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_launch(int head_dim, const void* q, const void* k,
                             const void* v, const void* cos_t,
                             const void* sin_t, const void* mask, void* out,
                             int batch, int length, int heads, int kv_heads,
                             int window, float inv_sqrt_d, cudaStream_t s) {
  switch (head_dim) {
    case 16:
      return attention_launch_d<T, 16>(q, k, v, cos_t, sin_t, mask, out, batch, length,
                                       heads, kv_heads, window, inv_sqrt_d, s);
    case 128:
      return attention_launch_d<T, 128>(q, k, v, cos_t, sin_t, mask, out, batch, length,
                                        heads, kv_heads, window, inv_sqrt_d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decoder
}  // namespace ff

// The C interface.  Pointers are device pointers of contiguous tensors,
// 16-byte aligned; dtype codes 0 fp32, 1 bf16 (the wrappers in
// models/mistral.py check shapes, types, alignment and devices).  Each entry
// selects `device` (this object links its own CUDA runtime, whose current
// device is not PyTorch's), launches on `stream` without synchronising, and
// returns the cudaError_t of the launch (0 on success).

namespace {

cudaError_t use_device(int device) { return cudaSetDevice(device); }

}  // namespace

// x (rows, hidden) of in_dtype, gain (hidden) fp32, out (rows, hidden) of
// out_dtype; hidden % 8 == 0.  fp32 -> fp32, bf16 -> bf16, bf16 -> fp32.
extern "C" int ff_decoder_rms_norm(const void* x, int in_dtype,
                                   const void* gain, void* out, int out_dtype,
                                   long long rows, int hidden, float eps,
                                   int device, void* stream) {
  using namespace ff::decoder;
  if (rows <= 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return static_cast<int>(rms_norm_launch<float, float>(x, gain, out, rows, hidden, eps, s));
  if (in_dtype == 1 && out_dtype == 1)
    return static_cast<int>(rms_norm_launch<bf16, bf16>(x, gain, out, rows, hidden, eps, s));
  if (in_dtype == 1 && out_dtype == 0)
    return static_cast<int>(rms_norm_launch<bf16, float>(x, gain, out, rows, hidden, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// q (batch, length, heads, head_dim), k and v (batch, length, kv_heads,
// head_dim) of dtype, cos_t and sin_t (length, head_dim) fp32, mask (batch,
// length) int32, out like q; head_dim 16 or 128; window <= 0
// for none; inv_sqrt_d = 1 / sqrt(head_dim) as fp32.
extern "C" int ff_decoder_attention(const void* q, const void* k,
                                    const void* v, const void* cos_t,
                                    const void* sin_t, const void* mask,
                                    void* out, int dtype, int batch,
                                    int length, int heads, int kv_heads,
                                    int head_dim, int window, float inv_sqrt_d,
                                    int device, void* stream) {
  using namespace ff::decoder;
  if (batch <= 0 || length <= 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(attention_launch<float>(head_dim, q, k, v, cos_t, sin_t, mask, out,
                                                    batch, length, heads, kv_heads, window,
                                                    inv_sqrt_d, s));
  if (dtype == 1)
    return static_cast<int>(attention_launch<bf16>(head_dim, q, k, v, cos_t, sin_t, mask, out,
                                                   batch, length, heads, kv_heads, window,
                                                   inv_sqrt_d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// gate, up and out: n elements of dtype each.
extern "C" int ff_decoder_swiglu(const void* gate, const void* up, void* out,
                                 int dtype, long long n, int device,
                                 void* stream) {
  using namespace ff::decoder;
  if (n <= 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(swiglu_launch<float>(gate, up, out, n, s));
  if (dtype == 1) return static_cast<int>(swiglu_launch<bf16>(gate, up, out, n, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
