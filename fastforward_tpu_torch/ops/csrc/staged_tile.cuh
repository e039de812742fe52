// The staging skeleton of the dense-tile kernels K2 (stream_select.cu) and
// K4 (stream_select_pq.cu): one block of kStagedThreads threads per virtual
// tile copies, chunk by chunk, the tile's rows that its slots want into
// shared memory, and its warps score every slot whose row lies in the staged
// chunk.  Each row leaves device memory once per virtual tile; chunks no
// slot wants are skipped (a spill tile with a few slots stages only their
// rows' chunks).
//
// A kernel supplies what a row is: how to stage rows [row0, row0 + rows) of
// the tile and how one warp scores a slot from the staged copy.

#pragma once

#include <cuda_runtime.h>

namespace ff {

constexpr int kStagedWarps = 8;
constexpr int kStagedThreads = kStagedWarps * 32;
// staged rows per chunk take at most this many bytes of shared memory
constexpr int kStagedChunkBytes = 48 * 1024;
constexpr int kStagedMaxChunks = 1024;

// Walk the chunks of virtual tile `slots` (cap packed slots, local * qb +
// qno, rows 0..r-1 of the tile) that some slot wants.  For each such chunk,
// every thread of the block calls stage(row0, rows); after a barrier, warp w
// calls score(s, cv, local - row0) for its slots s = w, w + kStagedWarps, ...
// whose row lies in the chunk (all 32 lanes together: the call is
// warp-uniform).  Must be called by every thread of the block.
template <typename Stage, typename Score>
__device__ __forceinline__ void for_each_staged_slot(
    const int* __restrict__ slots, int cap, int qb, int r, int chunk_rows,
    Stage stage, Score score) {
  __shared__ int needed[kStagedMaxChunks];
  const int warp = threadIdx.x >> 5;
  const int n_chunks = (r + chunk_rows - 1) / chunk_rows;

  // which chunks hold a row some slot wants
  for (int c = threadIdx.x; c < n_chunks; c += kStagedThreads) needed[c] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < cap; s += kStagedThreads) {
    const int c = (__ldg(slots + s) / qb) / chunk_rows;
    if (c < n_chunks) needed[c] = 1;  // slot values are not range-checked
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    if (!needed[c]) continue;  // block-uniform: read after a barrier
    const int row0 = c * chunk_rows;
    const int rows = min(chunk_rows, r - row0);
    stage(row0, rows);
    __syncthreads();
    for (int s = warp; s < cap; s += kStagedWarps) {
      const int cv = __ldg(slots + s);
      const int local = cv / qb;
      if (local < row0 || local >= row0 + rows) continue;  // warp-uniform
      score(s, cv, local - row0);
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
}

// Rows per staged chunk for rows of row_bytes bytes in tiles of r rows: the
// whole tile when it fits kStagedChunkBytes, else as many rows as fit.
// Returns 0 when one row does not fit or a tile needs more chunks than
// kStagedMaxChunks.
inline int staged_chunk_rows(long long row_bytes, int r) {
  if (row_bytes <= 0 || row_bytes > kStagedChunkBytes) return 0;
  const int rows = static_cast<int>(
      row_bytes * r <= kStagedChunkBytes ? r : kStagedChunkBytes / row_bytes);
  return (r + rows - 1) / rows > kStagedMaxChunks ? 0 : rows;
}

template <typename T>
struct exactly {
  using type = T;
};

// Launch a staged kernel with one block per virtual tile and smem bytes of
// dynamic shared memory (static `needed` flags + dynamic above 48 KB needs
// the opt-in).  The arguments take the kernel's parameter types here, before
// the launch.  Returns the launch's cudaError_t.
template <typename... Params>
cudaError_t launch_staged(void (*kernel)(Params...), int n_tiles, int smem,
                          cudaStream_t stream,
                          typename exactly<Params>::type... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, kStagedThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace ff
