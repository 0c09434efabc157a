// Shared launch geometry, deterministic reductions and asynchronous copies
// into shared memory for the port's
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

// An asynchronous copy of one 4- or 8-byte value into shared memory: it
// completes at cp.async.wait_group, and a barrier does not wait for it
template <typename V>
__device__ __forceinline__ void cp_async(V* dst, const V* src) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8, "4- or 8-byte values");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(V) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the N most recently committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bulk copies (TMA) into shared memory completing on an mbarrier (arrival
// count 1: a fill is one expect_tx arrival and its bytes).  Initialize the
// mbarriers, then a __syncthreads(), before any copy is issued on them.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
// wait for the completion of the mbarrier's phase of this parity; a wait
// past 2^26 tries traps rather than hang the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0, tries = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (++tries == (1u << 26)) __trap();
  } while (!done);
}
// the stage's generic-proxy accesses are ordered before the bulk copies
// that refill it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
inline int blocks_for(int n, int per_block) { return (n + per_block - 1) / per_block; }

}  // namespace gmres
