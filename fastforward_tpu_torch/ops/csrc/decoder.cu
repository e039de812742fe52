// The fp32 element-wise chains of a decoder layer, one kernel for each gap
// between two bf16 GEMMs (fastforward_tpu_torch/models/mistral.py,
// MistralTower; models/deepseek.py, DeepseekTower, takes RMSNorm, SwiGLU and
// the attention's latent instance):
//
// - rms_norm_kernel: x / sqrt(mean(x^2) + eps) * g, before the q/k/v
//   GEMMs, before the gate/up GEMMs, and the tower's final norm;
// - rope_attention_kernel: RoPE on q and k, the causal windowed
//   grouped-query attention and its softmax, between the q/k/v GEMMs and
//   the o GEMM; a second instance takes DeepSeek-V3's latent attention
//   (q/k heads of 128 + 64 RoPE dims, v heads of 128, one RoPE key head);
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
// RoPE + causal windowed attention, two instances of one template.
//
// q is (B, L, heads, DN + DR) as the q GEMM wrote it: DN dims without RoPE,
// then DR dims with it.  A key row is DN dims of `kn` and DR dims of `kr`,
// a value row DV dims of `v`, each addressed by a token stride and a head
// stride (elements), so the GEMMs' outputs are read where they lie: a head
// stride of 0 is one head shared by all.  The context is written as (B, L,
// heads, DV), which is the (B, L, heads * DV) the o GEMM reads.  Query head
// h reads key/value head h / G (G = heads / kv).  Query p sees key j when
// j <= p, p - j < window (window <= 0: no window) and mask[b, j] != 0.
//
// - Mistral (E5-Mistral-7B): DN = 0, DR = DV = D (16 or 128), k and v
//   (B, L, kv, D): grouped-query attention, RoPE on the whole head.
// - Multi-head latent attention (DeepSeek-V3, Moonlight-16B-A3B): DN = 128,
//   DR = 64, DV = 128, kv = heads; k's no-RoPE part and v are the halves of
//   each head of the kv_b GEMM's output (B, L, heads, 256), the RoPE part
//   is one head (B, L, 64) shared by all heads.  The tower permutes the RoPE
//   rows of its weights at load, so DeepSeek's RoPE on pairs (2i, 2i + 1) is
//   the rotate-half form here.
//
// Grid: x = b * kv + g, one key/value head of one sequence; y = a tile of
// that head's L * G query rows (row r: position r / G, query head
// g * G + r % G), so k and v are read for the whole GQA group at once.
// A row is held by LPR = DV / 16 lanes: 16 dims of the context a lane (its
// four float4 chunks c = sub + LPR * i, i = 0..3, of the row's DV / 4), and
// the q chunks c = sub + LPR * i, i = 0..(DN + DR) / (4 LPR) - 1, the first
// DN / (4 LPR) of them without RoPE.  So the lanes of a row read consecutive
// 16 bytes of shared memory (no bank conflicts), and RoPE's partner of a
// chunk, DR / 8 chunks away, is a slot of the same lane.  A warp holds
// 32 / LPR rows, a block 8 warps.
//
// The block walks the keys its rows can see in tiles of kKeys: the tile's
// k (its RoPE part rotated, fp32) and v (fp32) go to shared memory, then
// each row takes the tile's keys four at a time: the logits (its lanes'
// FMA chains summed by xor shuffles, times 1 / sqrt(DN + DR), as PyTorch
// divides a CUDA tensor by a scalar) and, for the keys allowed, an online
// softmax step in fp32 (a running max, the sum of exp(logit - max) and the
// context, rescaled when the max rises).  Any length runs: the keys are
// walked in tiles up to the window.  A row that sees no key at all (a
// padded position past the window of every real key) gets what the plain
// version's softmax over logits that all read finfo.min gives: the mean of
// v over all L keys.
//
// Bound: q, k and v read once and the context written once (k and v of a
// tile are re-read from L2 by the row tiles of one head); the logits and
// context products, about 2 (DN + DR + DV) flops a (row, key) pair, run on
// CUDA cores.  At E5-Mistral's widths on 32 x 31 tokens the kernel takes
// ~35 us against ~6 us of bytes: the instructions a (row, key) pair costs
// (each row's lanes shuffle every logit together and each computes its
// exp) set it.

constexpr int kAttnWarps = 8;

// where the key and value rows lie (elements)
struct KeyLayout {
  long long kn_tok, kn_head;  // k's no-RoPE part
  long long kr_tok, kr_head;  // k's RoPE part (kr_head 0: one head for all)
  long long v_tok, v_head;
};

template <typename T, int DN, int DR, int DV>
__global__ void __launch_bounds__(kAttnWarps * 32)
    rope_attention_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                          const T* __restrict__ kr, const T* __restrict__ v,
                          const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t,
                          const int* __restrict__ mask, T* __restrict__ out,
                          KeyLayout lay, int length, int heads, int kv_heads,
                          int window, float inv_sqrt_d) {
  constexpr int kLanes = DV / 16;            // lanes a row
  constexpr int kRowsPerWarp = 32 / kLanes;  // rows a warp holds
  constexpr int kRows = kAttnWarps * kRowsPerWarp;
  constexpr int kKeys = 32;                  // keys a tile (32 KB of k and v at D 128)
  constexpr int kQ = DN + DR;                // q/k head size
  constexpr int kQChunks = kQ / 4;           // float4 chunks a q/k row
  constexpr int kVChunks = DV / 4;           // float4 chunks a v row
  constexpr int kNChunks = DN / 4;           // ... of them without RoPE
  constexpr int kRChunks = DR / 4;           // ... with RoPE
  constexpr int kSlots = kQ / (4 * kLanes);  // q chunks a lane
  constexpr int kNSlots = DN / (4 * kLanes);
  constexpr int kRHalf = (kSlots - kNSlots) / 2;  // RoPE's partner, in slots
  constexpr int kStep = 4;                   // keys a step of the inner loop
  static_assert(DV % 16 == 0 && 32 % kLanes == 0, "16 context dims a lane");
  static_assert(DN % (4 * kLanes) == 0 && DR % (8 * kLanes) == 0, "whole slots, RoPE halves");
  __shared__ float4 ks[kKeys * kQChunks];
  __shared__ float4 vs[kKeys * kVChunks];
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

  // the row's query, RoPE part rotated: slot i holds dims 4 (sub + kLanes i)
  float qr[4 * kSlots], acc[16];
  if (active) {
    const T* qrow = q + ((seq + pos) * heads + head) * kQ;
    float x[4 * kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) load4(qrow + 4 * (sub + kLanes * i), x + 4 * i);
#pragma unroll
    for (int i = 0; i < kNSlots; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[4 * i + e] = x[4 * i + e];
    }
#pragma unroll
    for (int i = kNSlots; i < kSlots; ++i) {
      const int ir = i - kNSlots;
      const int d0 = 4 * (sub + kLanes * ir);  // dim within the RoPE part
      float c4[4], s4[4];
      load4(cos_t + static_cast<long long>(pos) * DR + d0, c4);
      load4(sin_t + static_cast<long long>(pos) * DR + d0, s4);
      const int ip = kNSlots + (ir < kRHalf ? ir + kRHalf : ir - kRHalf);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rotate_half: -x[d + DR/2] in the first half, x[d - DR/2] in the second
        const float partner = x[4 * ip + e];
        const float rot = ir < kRHalf ? -partner : partner;
        qr[4 * i + e] = __fadd_rn(__fmul_rn(x[4 * i + e], c4[e]), __fmul_rn(rot, s4[e]));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * kSlots; ++i) qr[i] = 0.f;
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
    for (int u = threadIdx.x; u < n * kQChunks; u += blockDim.x) {
      const int jj = u / kQChunks, c = u % kQChunks;
      const long long j = seq + t0 + jj;
      float kx[4];
      if (c < kNChunks) {
        load4(kn + j * lay.kn_tok + g * lay.kn_head + 4 * c, kx);
      } else {
        const int cr = c - kNChunks;
        const int pc = (cr + kRChunks / 2) % kRChunks;  // RoPE's partner chunk
        const T* krow = kr + j * lay.kr_tok + g * lay.kr_head;
        float kp[4], c4[4], s4[4];
        load4(krow + 4 * cr, kx);
        load4(krow + 4 * pc, kp);
        load4(cos_t + (t0 + jj) * static_cast<long long>(DR) + 4 * cr, c4);
        load4(sin_t + (t0 + jj) * static_cast<long long>(DR) + 4 * cr, s4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float rot = cr < kRChunks / 2 ? -kp[e] : kp[e];
          kx[e] = __fadd_rn(__fmul_rn(kx[e], c4[e]), __fmul_rn(rot, s4[e]));
        }
      }
      ks[jj * kQChunks + c] = make_float4(kx[0], kx[1], kx[2], kx[3]);
    }
    for (int u = threadIdx.x; u < n * kVChunks; u += blockDim.x) {
      const int jj = u / kVChunks, c = u % kVChunks;
      float vx[4];
      load4(v + (seq + t0 + jj) * lay.v_tok + g * lay.v_head + 4 * c, vx);
      vs[jj * kVChunks + c] = make_float4(vx[0], vx[1], vx[2], vx[3]);
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
        const int row = min(jj + u, n - 1) * kQChunks + sub;
        dot[u] = 0.f;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
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
        const int row = (jj + u) * kVChunks + sub;
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
      const T* vrow = v + (seq + j) * lay.v_tok + g * lay.v_head;
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
  T* orow = out + ((seq + pos) * heads + head) * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) store4(orow + 4 * (sub + kLanes * i), acc + 4 * i);
}

template <typename T, int DN, int DR, int DV>
cudaError_t attention_launch_d(const void* q, const void* kn, const void* kr,
                               const void* v, const void* cos_t,
                               const void* sin_t, const void* mask, void* out,
                               const KeyLayout& lay, int batch, int length,
                               int heads, int kv_heads, int window,
                               float inv_sqrt_d, cudaStream_t s) {
  constexpr int kRows = kAttnWarps * 32 / (DV / 16);
  const long long rows = static_cast<long long>(length) * (heads / kv_heads);
  const dim3 grid(static_cast<unsigned>(batch) * kv_heads,
                  static_cast<unsigned>((rows + kRows - 1) / kRows));
  rope_attention_kernel<T, DN, DR, DV><<<grid, kAttnWarps * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(kr), static_cast<const T*>(v),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const int*>(mask), static_cast<T*>(out), lay, length, heads,
      kv_heads, window, inv_sqrt_d);
  return cudaGetLastError();
}

// Mistral: k and v (B, L, kv, D), RoPE on the whole head
template <typename T>
cudaError_t attention_launch(int head_dim, const void* q, const void* k,
                             const void* v, const void* cos_t,
                             const void* sin_t, const void* mask, void* out,
                             int batch, int length, int heads, int kv_heads,
                             int window, float inv_sqrt_d, cudaStream_t s) {
  const long long tok = static_cast<long long>(kv_heads) * head_dim;
  const KeyLayout lay{tok, head_dim, tok, head_dim, tok, head_dim};
  switch (head_dim) {
    case 16:
      return attention_launch_d<T, 0, 16, 16>(q, nullptr, k, v, cos_t, sin_t, mask, out, lay,
                                              batch, length, heads, kv_heads, window,
                                              inv_sqrt_d, s);
    case 128:
      return attention_launch_d<T, 0, 128, 128>(q, nullptr, k, v, cos_t, sin_t, mask, out, lay,
                                                batch, length, heads, kv_heads, window,
                                                inv_sqrt_d, s);
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

// Multi-head latent attention (DeepSeek-V3's, at its published head sizes:
// 128 dims without RoPE and 64 with it a q/k head, 128 a v head): q (batch,
// length, heads, 192); k_nope and v rows of 128 at the given token and head
// strides (elements; the halves of the kv_b GEMM's heads); k_rope (batch,
// length) rows of 64 at token stride kr_tok, one head for all; cos_t and
// sin_t (length, 64) fp32; mask (batch, length) int32; out (batch, length,
// heads, 128) of dtype; window <= 0 for none.
extern "C" int ff_decoder_latent_attention(
    const void* q, const void* k_nope, const void* k_rope, const void* v,
    const void* cos_t, const void* sin_t, const void* mask, void* out,
    int dtype, int batch, int length, int heads, long long kn_tok,
    long long kn_head, long long kr_tok, long long v_tok, long long v_head,
    int window, float inv_sqrt_d, int device, void* stream) {
  using namespace ff::decoder;
  if (batch <= 0 || length <= 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KeyLayout lay{kn_tok, kn_head, kr_tok, 0, v_tok, v_head};
  if (dtype == 0)
    return static_cast<int>(attention_launch_d<float, 128, 64, 128>(
        q, k_nope, k_rope, v, cos_t, sin_t, mask, out, lay, batch, length, heads, heads,
        window, inv_sqrt_d, s));
  if (dtype == 1)
    return static_cast<int>(attention_launch_d<bf16, 128, 64, 128>(
        q, k_nope, k_rope, v, cos_t, sin_t, mask, out, lay, batch, length, heads, heads,
        window, inv_sqrt_d, s));
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
