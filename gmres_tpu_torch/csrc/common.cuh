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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace gmres {

// Dtype forms of the basis sweeps.  A sweep reads a basis stored in TV
// against vectors in TW (the work dtype) and sums in acc_t<TW>: fp64 under
// an fp64 vector, else fp32 (a bf16 basis or vector is widened to fp32
// before any product, as the TPU kernels do in VMEM).  up() widens a
// stored value exactly; down() rounds a sum to a stored dtype, to nearest
// even (RNE, as torch's and JAX's astype); rounded() is that rounding kept
// in the wide dtype.  For TV = TW = float or double every conversion is the
// identity, so those instantiations keep their arithmetic.
using bf16 = __nv_bfloat16;
template <typename TW>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};
template <typename TW>
using acc_t = typename AccOf<TW>::type;

template <typename TA, typename T>
__device__ __forceinline__ TA up(T v) {
  if constexpr (std::is_same_v<T, bf16>)
    return (TA)__bfloat162float(v);
  else
    return (TA)v;
}
template <typename T, typename TA>
__device__ __forceinline__ T down(TA v) {
  if constexpr (std::is_same_v<T, bf16>)
    return __float2bfloat16_rn((float)v);
  else
    return (T)v;
}
template <typename T, typename TA>
__device__ __forceinline__ TA rounded(TA v) {
  if constexpr (std::is_same_v<T, TA>)
    return v;
  else
    return up<TA>(down<T>(v));
}

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

// load_tile of a TV basis row or TW vector, widened to TA
template <typename TA, typename T>
__device__ __forceinline__ void load_tile_as(const T* __restrict__ src, size_t col0, int n,
                                             TA (&v)[kItems]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const size_t c = col0 + (size_t)it * kThreads;
    v[it] = c < (size_t)n ? up<TA>(src[c]) : TA(0);
  }
}

// 16 bytes of T values as one vector load (Raw16<T>), and the values it
// holds widened to TA: 4 floats, 2 doubles or 8 bf16 (a bf16 is the high
// half of the float with the same bits)
template <typename T>
struct Raw16;
template <>
struct Raw16<float> {
  using type = float4;
};
template <>
struct Raw16<double> {
  using type = double2;
};
template <>
struct Raw16<bf16> {
  using type = uint4;
};
template <typename T>
__host__ __device__ constexpr int vec16() { return 16 / (int)sizeof(T); }

template <typename TA>
__device__ __forceinline__ void unpack16(const float4& q, TA* v) {
  v[0] = (TA)q.x; v[1] = (TA)q.y; v[2] = (TA)q.z; v[3] = (TA)q.w;
}
template <typename TA>
__device__ __forceinline__ void unpack16(const double2& q, TA* v) {
  v[0] = (TA)q.x; v[1] = (TA)q.y;
}
template <typename TA>
__device__ __forceinline__ void unpack16(const uint4& q, TA* v) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = (TA)__uint_as_float(w[k] << 16);
    v[2 * k + 1] = (TA)__uint_as_float(w[k] & 0xffff0000u);
  }
}
// N values of T at p (16-byte aligned; N a whole number of 16-byte chunks),
// widened to TA: through the read-only cache (global) or from shared memory
template <typename TA, typename T, int N>
__device__ __forceinline__ void ldg_as(const T* p, TA (&v)[N]) {
  static_assert(N % vec16<T>() == 0, "whole 16-byte chunks");
  using R = typename Raw16<T>::type;
#pragma unroll
  for (int q = 0; q < N / vec16<T>(); ++q)
    unpack16<TA>(__ldg(reinterpret_cast<const R*>(p) + q), v + q * vec16<T>());
}
template <typename TA, typename T, int N>
__device__ __forceinline__ void lds_as(const T* p, TA (&v)[N]) {
  static_assert(N % vec16<T>() == 0, "whole 16-byte chunks");
  using R = typename Raw16<T>::type;
#pragma unroll
  for (int q = 0; q < N / vec16<T>(); ++q)
    unpack16<TA>(reinterpret_cast<const R*>(p)[q], v + q * vec16<T>());
}
// N values rounded to T and stored at p (16-byte aligned), 16 bytes a store
template <typename T, typename TA, int N>
__device__ __forceinline__ void st_as(T* p, const TA (&v)[N]) {
  static_assert(N % vec16<T>() == 0, "whole 16-byte chunks");
#pragma unroll
  for (int q = 0; q < N / vec16<T>(); ++q) {
    const TA* s = v + q * vec16<T>();
    if constexpr (std::is_same_v<T, float>) {
      reinterpret_cast<float4*>(p)[q] = make_float4(s[0], s[1], s[2], s[3]);
    } else if constexpr (std::is_same_v<T, double>) {
      reinterpret_cast<double2*>(p)[q] = make_double2(s[0], s[1]);
    } else {
      unsigned w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = (unsigned)__bfloat16_as_ushort(down<bf16>(s[2 * k])) |
               ((unsigned)__bfloat16_as_ushort(down<bf16>(s[2 * k + 1])) << 16);
      reinterpret_cast<uint4*>(p)[q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
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
