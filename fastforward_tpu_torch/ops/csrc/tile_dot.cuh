// K1's body for fp32 tables (stream_select_pairwise.cu): one block per
// virtual tile, kept in tile order.  Contract, for every slot s of virtual
// tile t, with c = cand[t * cap + s], local = c / qb and qno = c % qb:
//
//     out[t * cap + s] = table[tile_idx[t] * r + local] . q[qno]
//
// one fp32 FMA chain per lane over its elements, the 32 lanes' sums then
// added with shuffles.  The fast tier rounds both elements to bf16 (round
// to nearest even) first: the queries once per call (round_kernel, into
// the caller's scratch), a row once per tile that reads it.
//
// What a tile holds.  The layout builder keeps the input order within a
// tile (ops/scoring.py build_streamed_layout), so the rows a document mode
// repeats to pad a pair to K rows sit in adjacent slots with the same
// value; the padding slots all carry qb - 1 (local 0, the last query); and
// the slots of one tile read rows of one 512-row table tile, so a row that
// several queries want recurs within the tile.  On the MAXP layout of
// chip_smoke.py (8,192 x 1,024 slots) about 4.3M slots are padding, ~2.05M
// repeat the slot before them, and the ~2.05M left read only ~1.28M
// distinct rows; one warp per slot dotted all 8.4M of them.
//
// The block, for its tile (tile_dot_kernel):
//   1. stages the tile's cand values in shared memory (one coalesced load);
//   2. marks each slot's source: a padding slot copies the tile's first
//      padding slot, any other slot the first slot of its run of equal
//      values (a block scan finds the run starts); a slot that is its own
//      source is a leader, and only leaders are dotted;
//   3. groups the leaders by local row, a counting sort over the r rows in
//      shared memory, and lists the distinct rows;
//   4. one warp per distinct row: the warp loads its row once into
//      registers (kTileVecs 16-byte loads a lane, 768 elements a chunk;
//      wider rows in chunks) and dots it with every query that wants it,
//      two queries at a time, the queries read from L2 (512 x 3 KB at the
//      flagship size); results go to shared memory;
//   5. writes every slot's result, its source's, in one coalesced store of
//      the tile's cap floats.
// A tile of padding alone costs one dot and cap stores.  The padding dot
// is the real table[tile_idx[t] * r] . q[qb - 1]: the contract does not
// say that the padding query is zero.
//
// Two geometries.  One block a tile was designed for the resident
// layouts: 1,024-8,192 virtual tiles, which fill the card's block places
// (kTileBlocksPerSm an SM, 528 on an H100 SXM) many times over.  A staged
// tail block of the hybrid tier has 64 tiles (a 32,768-row block at cap
// 1,024), so one block a tile left half of the SMs idle, and each warp
// walked 40-70 distinct rows, one dependent load after another.  So the
// wrapper splits each tile over S blocks, S = stream_kernel.tile_split:
// as many as the card's block places hold for every tile, at most
// kTileMaxSplit (8 at a tail block; 1 from 265 tiles on, where the sweep
// found S = 1 fastest; PERF.md).  Each block of a tile repeats steps 1-3
// (cheap at cap 1,024), dots the distinct rows k with (k / kTileWarps) %
// S equal to its share (row 0, the padding slots' row, is share 0's) and
// writes only the slots whose source row is its own; at S = 1 the
// bookkeeping is compiled out (kSplit).  Each (row, query) dot is the same
// FMA chain and the same shuffles whatever S is, so the scores are the
// same bits.  A warp of a split tile loading two of its rows at once
// measured slower at a tail block (PERF.md).
//
// The exact tier is true fp32 FMA: no TF32 and no tensor cores.  Each
// (row, query) pair is one dot, so there is no matrix product for wgmma to
// take; the bound is bytes: the distinct rows the tiles read (chip_smoke.py
// k1_bound), the queries staying in L2.  A warp waits on its row and query
// loads once per row, so the time follows the warps an SM holds (the
// register cap below); staging rows in shared memory through cp.async, an
// L2 prefetch of the next row, and 16 or 32 warps a block measured slower,
// 4 warps no faster (PERF.md; all on the resident layouts, 4,096-8,192
// tiles).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_dot.cuh"

namespace ff {
namespace tile_dot {

constexpr int kTileWarps = 8;  // warps per block
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kTileVecs = 6;  // 16-byte row loads a lane holds: 768 fp32 a chunk
// blocks an SM holds: 4 caps the registers at 64, which measured faster
// (the loads in flight a warp loses, more warps make up; PERF.md)
constexpr int kTileBlocksPerSm = 4;
// the most blocks a tile is split over (stream_kernel.tile_split picks S)
constexpr int kTileMaxSplit = 16;

struct Args {
  const float* table;   // (N_pad, dim), 16-byte aligned
  const float* q;       // (qb, dim)
  const int* cand;      // (n_tiles, cap) packed local * qb + qno
  const int* tile_idx;  // (n_tiles,)
  float* out;           // (n_tiles, cap)
  int cap, qb, r, dim;
  int split;  // blocks a tile (S): each dots an S-th of its distinct rows
};

// Dynamic shared memory of one block: cand, source, result and leader list
// (cap each), the distinct rows and their list starts (cap + 1 each), and
// one counter a local row.
inline size_t smem_bytes(int cap, int r) {
  return sizeof(int) * (6 * static_cast<size_t>(cap) + 1 + r);
}

__device__ __forceinline__ float4 load4(const float* p, bool round) {
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  if (round) {
    v.x = dense::round_bf16(v.x);
    v.y = dense::round_bf16(v.y);
    v.z = dense::round_bf16(v.z);
    v.w = dense::round_bf16(v.w);
  }
  return v;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Exclusive block scan of (x, y) pairs in thread order: the sum of the
// earlier threads' x, and the max (kMaxY; -1 for thread 0) or the sum of
// their y.  A barrier too; `warp_tot` is read after it, so a later scan
// takes another buffer.
template <bool kMaxY>
__device__ __forceinline__ int2 block_scan(int x, int y, int2* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int sx = x, sy = y;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int nx = __shfl_up_sync(0xffffffffu, sx, off);
    const int ny = __shfl_up_sync(0xffffffffu, sy, off);
    if (lane >= off) {
      sx += nx;
      sy = kMaxY ? max(sy, ny) : sy + ny;
    }
  }
  if (lane == 31) warp_tot[warp] = make_int2(sx, sy);
  const int prev_y = __shfl_up_sync(0xffffffffu, sy, 1);
  int2 before =
      make_int2(sx - x, kMaxY ? (lane ? prev_y : -1) : sy - y);
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    const int2 tot = warp_tot[w];
    before.x += tot.x;
    before.y = kMaxY ? max(before.y, tot.y) : before.y + tot.y;
  }
  return before;
}

// kSplit: a.split blocks a tile (else one, and the split's bookkeeping is
// compiled out).
template <bool kExact, bool kSplit>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm)
    tile_dot_kernel(Args a) {
  extern __shared__ int smem[];
  int* s_cand = smem;                                      // cap
  int* s_src = s_cand + a.cap;                             // cap
  float* s_res = reinterpret_cast<float*>(s_src + a.cap);  // cap
  int* s_list = reinterpret_cast<int*>(s_res + a.cap);     // cap
  int* s_item_row = s_list + a.cap;                        // cap
  int* s_item_start = s_item_row + a.cap;                  // cap + 1
  int* s_row = s_item_start + a.cap + 1;                   // r
  __shared__ int2 s_warp[2][kTileWarps];
  __shared__ int s_first_pad, s_items;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cap = a.cap, qb = a.qb, pad = qb - 1, split = kSplit ? a.split : 1;
  // the tile, and this block's share of its distinct rows
  const long long t = kSplit ? blockIdx.x / split : blockIdx.x;
  const int share = kSplit ? blockIdx.x % split : 0;
  const int* tc = a.cand + t * cap;
  const float* tile =
      a.table + static_cast<long long>(__ldg(a.tile_idx + t)) * a.r * a.dim;

  // 1. stage the tile's cand values; zero the row counters
  if (tid == 0) s_first_pad = cap;
  for (int i = tid; i < cap; i += kTileThreads) s_cand[i] = __ldg(tc + i);
  for (int i = tid; i < a.r; i += kTileThreads) s_row[i] = 0;
  __syncthreads();

  // 2. each slot's source; each thread owns `per` consecutive slots
  const int per = (cap + kTileThreads - 1) / kTileThreads;
  const int lo = min(cap, tid * per), hi = min(cap, lo + per);
  int first_pad = cap, last_start = -1;
  for (int s = lo; s < hi; ++s) {
    const int c = s_cand[s];
    if (c == pad && first_pad == cap) first_pad = s;
    if (s == 0 || s_cand[s - 1] != c) last_start = s;
  }
  if (first_pad < cap) atomicMin(&s_first_pad, first_pad);
  // the start of the run the thread's first slot continues (a barrier too)
  int run_start = block_scan<true>(0, last_start, s_warp[0]).y;
  first_pad = s_first_pad;
  for (int s = lo; s < hi; ++s) {
    const int c = s_cand[s];
    if (s == 0 || s_cand[s - 1] != c) run_start = s;
    const int src = c == pad ? first_pad : run_start;
    s_src[s] = src;
    if (src == s) atomicAdd(&s_row[c / qb], 1);  // a leader: count its row
  }
  __syncthreads();

  // 3. the distinct rows, in row order, and where their leader lists start
  const int rper = (a.r + kTileThreads - 1) / kTileThreads;
  const int rlo = min(a.r, tid * rper), rhi = min(a.r, rlo + rper);
  int n_rows = 0, n_in = 0;
  for (int i = rlo; i < rhi; ++i) {
    n_rows += s_row[i] > 0;
    n_in += s_row[i];
  }
  const int2 before = block_scan<false>(n_rows, n_in, s_warp[1]);
  const int first_item = before.x;
  int item = first_item, start = before.y;
  for (int i = rlo; i < rhi; ++i) {
    const int cnt = s_row[i];
    if (cnt > 0) {
      s_item_row[item] = i;
      s_item_start[item++] = start;
      s_row[i] = start;  // from here on, the row's next free place
      start += cnt;
    }
  }
  if (tid == kTileThreads - 1) {
    s_items = item;
    s_item_start[item] = start;
  }
  __syncthreads();
  for (int s = lo; s < hi; ++s) {
    if (s_src[s] == s) s_list[atomicAdd(&s_row[s_cand[s] / qb], 1)] = s;
  }
  __syncthreads();
  const int n = s_items;
  if (kSplit) {  // from here on, a distinct row's place in the list
    for (int k = first_item; k < item; ++k) s_row[s_item_row[k]] = k;
  }

  // 4. one warp per distinct row, the row in registers (rounded in the
  // fast tier, whose queries come rounded), two queries at a time; a
  // leader's result is the sum of its chunks' warp sums.  Split over S
  // blocks, the rows go to the blocks kTileWarps at a time in turn: row k
  // to share (k / kTileWarps) % S (row 0, the padding slots' row, to
  // share 0), so each block dots about an S-th of them.
  for (int k = share * kTileWarps + warp; k < n; k += split * kTileWarps) {
    const float* row = tile + static_cast<long long>(s_item_row[k]) * a.dim;
    const int begin = s_item_start[k], end = s_item_start[k + 1];
    for (int base = 0; base < a.dim; base += kTileVecs * 128) {
      const int nv = min(kTileVecs, (a.dim - base) / 128);
      float4 x[kTileVecs];
#pragma unroll
      for (int v = 0; v < kTileVecs; ++v) {
        if (v < nv) x[v] = load4(row + base + v * 128 + lane * 4, !kExact);
      }
      for (int j = begin; j < end; j += 2) {
        const bool two = j + 1 < end;
        const int sa = s_list[j], sb = two ? s_list[j + 1] : sa;
        const long long off = base + lane * 4;
        const float* qa = a.q + static_cast<long long>(s_cand[sa] % qb) * a.dim + off;
        const float* qc = a.q + static_cast<long long>(s_cand[sb] % qb) * a.dim + off;
        float acc_a = 0.0f, acc_b = 0.0f;
#pragma unroll
        for (int v = 0; v < kTileVecs; ++v) {
          if (v < nv) {
            acc_a = dot4(x[v], load4(qa + v * 128, false), acc_a);
            if (two) acc_b = dot4(x[v], load4(qc + v * 128, false), acc_b);
          }
        }
        if (two) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            acc_a += __shfl_xor_sync(0xffffffffu, acc_a, o);
            acc_b += __shfl_xor_sync(0xffffffffu, acc_b, o);
          }
        } else {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            acc_a += __shfl_xor_sync(0xffffffffu, acc_a, o);
          }
        }
        if (lane == 0) {
          s_res[sa] = base ? s_res[sa] + acc_a : acc_a;
          if (two) s_res[sb] = base ? s_res[sb] + acc_b : acc_b;
        }
      }
    }
  }
  __syncthreads();

  // 5. every slot's result, its source's, coalesced; split, only the
  // slots whose source's row is this block's
  float* to = a.out + t * cap;
  if (!kSplit) {
    for (int s = tid; s < cap; s += kTileThreads) to[s] = s_res[s_src[s]];
  } else {
    for (int s = tid; s < cap; s += kTileThreads) {
      const int src = s_src[s];
      if ((s_row[s_cand[src] / qb] / kTileWarps) % split == share) to[s] = s_res[src];
    }
  }
}

// out = in rounded to bf16 (round to nearest even) and widened back, n
// floats (n % 4 == 0, both 16-byte aligned).
__global__ void __launch_bounds__(256) round_kernel(const float* __restrict__ in,
                                                   float* __restrict__ out,
                                                   long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x * 4;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
       i < n; i += stride) {
    *reinterpret_cast<float4*>(out + i) = load4(in + i, true);
  }
}

// Launch S = a.split blocks per virtual tile on `stream`; in the fast tier
// (exact == false) the queries are first rounded into `q_rounded`
// (qb * dim floats).  Returns the first failing launch's cudaError_t.
inline cudaError_t tile_dot_launch(const Args& a, long long n_tiles,
                                   bool exact, float* q_rounded,
                                   cudaStream_t stream) {
  if (n_tiles <= 0) return cudaSuccess;
  if (a.cap <= 0 || a.cap % 128 || a.qb <= 0 || a.r <= 0 || a.dim <= 0 ||
      a.dim % 128 || a.split <= 0 || a.split > kTileMaxSplit ||
      n_tiles * a.split > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  Args args = a;
  if (!exact) {
    if (q_rounded == nullptr) return cudaErrorInvalidValue;
    const long long n = static_cast<long long>(a.qb) * a.dim;
    const long long want = (n / 4 + 255) / 256;
    const unsigned blocks = static_cast<unsigned>(want < 1024 ? want : 1024);
    round_kernel<<<blocks, 256, 0, stream>>>(a.q, q_rounded, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    args.q = q_rounded;
  }
  const size_t smem = smem_bytes(a.cap, a.r);
  auto kernel = a.split > 1 ? (exact ? tile_dot_kernel<true, true> : tile_dot_kernel<false, true>)
                            : (exact ? tile_dot_kernel<true, false> : tile_dot_kernel<false, false>);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(n_tiles * a.split), kTileThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace tile_dot
}  // namespace ff
