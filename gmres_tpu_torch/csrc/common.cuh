// Shared launch geometry and deterministic reductions for the port's
// hand-written Hopper kernels (dia_spmv.cu, basis_sweep.cu, sell_spmv.cu,
// ilu_trisolve.cu, basis_mgs.cu).
//
// Every cross-thread sum is a fixed tree (warp shuffles, then one warp over
// the per-warp values), and every cross-block sum is written as per-block
// (or per-tile) partials that the Python wrapper finishes with torch.sum,
// or that the last block of the launch adds in a fixed order (K2: a ticket
// counter orders the blocks, no atomics touch the values).  So a run
// repeats bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace gmres {

// Threads per block for every kernel.  The Python wrappers read these
// through gmres_kernel_shape() and size their partial buffers from them.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Columns of the Krylov basis one block sweeps (kItems per thread, each
// thread's columns kThreads apart so that every load is coalesced).
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
// Largest basis height (m+1) and DIA band count the kernels take.
constexpr int kMaxRows = 256;
constexpr int kMaxDiags = 256;

// DIA band offsets, passed by value as a kernel argument (1 KB of the
// 4 KB parameter space): read through the constant cache, broadcast to
// every thread, no device copy of the offsets to manage.
struct DiaOffsets {
  int off[kMaxDiags];
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// Sum of v over the block; the result is valid in thread 0.  `scratch`
// holds kWarps values and may be reused after the call returns.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = T(0);
  if (warp == 0) {
    total = lane < kWarps ? scratch[lane] : T(0);
    total = warp_sum(total);
  }
  __syncthreads();
  return total;
}

// Thread threadIdx.x's kItems values of one kTile-column tile starting at
// col0 - threadIdx.x (columns kThreads apart, so every load is coalesced);
// columns at or past n read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, size_t col0,
                                          int n, T (&v)[kItems]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const size_t c = col0 + (size_t)it * kThreads;
    v[it] = c < (size_t)n ? src[c] : T(0);
  }
}

// a * b + c rounded once, spelled out so that every instantiation of a
// kernel contracts the same way whatever the compiler would choose
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

inline int blocks_for(int n, int per_block) { return (n + per_block - 1) / per_block; }

}  // namespace gmres
