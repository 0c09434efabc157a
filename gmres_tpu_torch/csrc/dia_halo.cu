// K12: the DIA SpMV of one row shard of a row-partitioned matrix, over its
// own block of x and the two halo edges received from its neighbours; plain
// and residual modes.
//
// Replaces
//   gmres_tpu/ops/pallas/spmv_kernel.py:dia_spmv_pallas_windowed (the
//     pallas_call at :88), the local SpMV of the distributed halo path
//     (gmres_tpu/parallel/halo.py:halo_spmv): the Arnoldi loop's operator
//     and the ILU-Jacobi factor sweeps of a HaloDIA shard; and
//   gmres_tpu/ops/pallas/df64_kernel.py:residual_df64_halo (a wrapper over
//     the pallas_call at :243), the shard's outer residual r = b - A x with
//     its ||r'||^2 and ||x||^2.  The TPU carried it on double-float pairs
//     for want of fp64 units; here residual mode is native fp64.
//
// The shard owns rows [s r, (s+1) r) of A; data[d, i] = A[s r + i,
// s r + i + off_d].  Column i + off_d of the shard reads
//     left[hl + j]   for -hl <= j < 0     (the tail of rank s-1's block)
//     x[j]           for 0 <= j < r       (this rank's block)
//     right[j - r]   for r <= j < r + hr  (the head of rank s+1's block)
//     0              elsewhere            (the band is 0 there)
// with j = i + off_d.  The TPU kernel read a concatenated window [left | x |
// right], re-padded to a uniform halo for its DMA alignment; the edges
// arrive here in their own buffers (the halo exchange stages them through
// the host), so the kernel takes three pointers and no window is built.
//
// What bounds it: device-memory bandwidth, as K1 (dia_spmv.cu): 2D flops on
// D + 2 values a row (7.3 MB fp32 at r = 262,144, D = 5: ~2.5 us at the
// card's copy rate).  At that size a launch is one or two waves of blocks,
// so what counts is the bytes each thread has in flight, not the grid.
//
// What the design does about it (redesigned for Hopper):
// - A block owns kThreads 16-byte chunks of rows (1024 rows fp32, 512
//   fp64), thread t the chunk's vec rows.  Blocks are of two kinds.  An
//   interior block's rows read only x for every band; it takes a
//   branch-free body.  Only the blocks within max|off| of either end of
//   the shard (two of 256 fp32 and four of 512 fp64 at convdiff@1M over 4
//   ranks) take the window path.  halo_kernel.py:halo_plan computes the
//   interior range [b0, b1) in Python, and the launcher checks it against
//   its own (halo_interior).
// - A thread issues every load of kHaloBands bands (its data chunk and
//   the x values of each band) before the first multiply-add, so a row
//   pays one trip to memory per batch of bands, not one per band.
// - Where r is a multiple of vec and the pointers are 16-byte aligned (the
//   aligned form), a band's data chunk, b and y are 16-byte loads and
//   stores.  x at off = +-1 is not 16-byte aligned for a chunk, and is read
//   one value at a time from L1/L2: on the card that was faster than
//   reading the two aligned chunks that hold it and shifting them by off
//   mod vec, and than staging the block's bands and x in shared memory by
//   bulk copies (PERF.md, section 6).  Elsewhere (the general form) every load is
//   scalar.
// - Each row's sum is one chain: bands in ascending d, from 0, one fused
//   multiply-add a band, in the dtype of A.  The window path adds data * 0
//   where a band reads past the edges.  So y has the bits of the
//   one-thread-a-row kernel this replaces, and of K1's rows of the
//   unpartitioned matrix.
//
// Residual mode writes per-block fp64 partial sums of ||r'||^2 (r' = r
// rounded to fp32 when `demote` is set: the norm of the mixed scheme's start
// vector) and of ||x||^2 over the shard's own rows; the last block to
// finish (K2's ticket counter) adds them in block order and writes the two
// sums, so a call is one launch and its bits do not depend on which block
// ends last.  The caller sums the ranks' shares.
#include <cstdint>

#include "common.cuh"

using namespace gmres;

namespace {

// bands whose loads a thread issues together: the main path's five (a
// batch of 8 held 86-98 registers, two blocks an SM, and was slower in
// fp64)
constexpr int kHaloBands = 5;

template <typename T>
__host__ __device__ constexpr int halo_vec() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int halo_block_rows() { return kThreads * halo_vec<T>(); }

// The interior blocks [b0, b1): block b owns rows [b R, min((b+1) R, r)),
// and is interior when every row i of it reads x[i + off] inside [0, r)
// for every band, i.e. b R >= lo and min((b+1) R, r) <= r - hi with lo =
// max(0, -min off), hi = max(0, max off).  halo_kernel.py:halo_plan is the
// same function.
inline void halo_interior(const int* offsets, int n_diags, int r, int rows_per_block, int* b0,
                          int* b1) {
  int lo = 0, hi = 0;
  for (int d = 0; d < n_diags; ++d) {
    lo = offsets[d] < -lo ? -offsets[d] : lo;
    hi = offsets[d] > hi ? offsets[d] : hi;
  }
  const int n_blocks = blocks_for(r, rows_per_block);
  const long long first = ((long long)lo + rows_per_block - 1) / rows_per_block;
  *b0 = (int)(first < n_blocks ? first : n_blocks);
  const int end = hi == 0 ? n_blocks : (r - hi >= 0 ? (r - hi) / rows_per_block : 0);
  *b1 = end > *b0 ? end : *b0;
}

template <typename T>
__device__ __forceinline__ T window(const T* __restrict__ x, const T* __restrict__ left,
                                    const T* __restrict__ right, int j, int r, int hl,
                                    int hr) {
  if (j < 0) return j >= -hl ? __ldg(left + hl + j) : T(0);
  if (j < r) return __ldg(x + j);
  return j < r + hr ? __ldg(right + j - r) : T(0);
}

template <typename T>
__device__ __forceinline__ void ldg16(const T* p, T (&v)[halo_vec<T>()]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
}

// acc[e] for the thread's rows i0 + e: the interior body (every read in x)
// or the window path, kHaloBands bands' loads issued before their
// multiply-adds
template <typename T, bool kAligned>
__device__ __forceinline__ void halo_rows(const T* __restrict__ data, const T* __restrict__ x,
                                          const T* __restrict__ left,
                                          const T* __restrict__ right, int i0, int r, int hl,
                                          int hr, int n_diags, const DiaOffsets& offs,
                                          bool interior, T (&acc)[halo_vec<T>()]) {
  constexpr int kVec = halo_vec<T>();
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = T(0);
  for (int d0 = 0; d0 < n_diags; d0 += kHaloBands) {
    T a[kHaloBands][kVec], xv[kHaloBands][kVec];
#pragma unroll
    for (int k = 0; k < kHaloBands; ++k) {
      const int d = d0 + k;
      if (d >= n_diags) continue;
      const int off = offs.off[d];
      const T* row = data + (size_t)d * r;
      if (interior && kAligned) {
        // a whole chunk is in [0, r) or past it (r is a multiple of vec)
        if (i0 < r) {
          ldg16(row + i0, a[k]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) xv[k][e] = __ldg(x + i0 + e + off);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) a[k][e] = xv[k][e] = T(0);
        }
      } else if (interior) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const bool live = i0 + e < r;
          a[k][e] = live ? __ldg(row + i0 + e) : T(0);
          xv[k][e] = live ? __ldg(x + i0 + e + off) : T(0);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const bool live = i0 + e < r;
          a[k][e] = live ? __ldg(row + i0 + e) : T(0);
          xv[k][e] = live ? window(x, left, right, i0 + e + off, r, hl, hr) : T(0);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kHaloBands; ++k) {
      if (d0 + k >= n_diags) continue;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmadd(a[k][e], xv[k][e], acc[e]);
    }
  }
}

template <typename T, bool RESIDUAL, bool kAligned>
__global__ void __launch_bounds__(kThreads)
dia_halo_kernel(const T* __restrict__ data, const T* __restrict__ x,
                const T* __restrict__ left, const T* __restrict__ right,
                const T* __restrict__ b, T* __restrict__ y, double* __restrict__ partials,
                unsigned* __restrict__ ticket, double* __restrict__ sums, int r, int hl, int hr,
                int n_diags, DiaOffsets offs, int demote, int b0, int b1) {
  constexpr int kVec = halo_vec<T>();
  const int i0 = blockIdx.x * halo_block_rows<T>() + threadIdx.x * kVec;
  const bool interior = (int)blockIdx.x >= b0 && (int)blockIdx.x < b1;
  T acc[kVec];
  halo_rows<T, kAligned>(data, x, left, right, i0, r, hl, hr, n_diags, offs, interior, acc);

  T out[kVec];
  double r_sq = 0.0, x_sq = 0.0;
  if constexpr (RESIDUAL) {
    T bv[kVec], xs[kVec];
    if (kAligned && i0 < r) {
      ldg16(b + i0, bv);
      ldg16(x + i0, xs);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const bool live = i0 + e < r;
        bv[e] = live ? __ldg(b + i0 + e) : T(0);
        xs[e] = live ? __ldg(x + i0 + e) : T(0);
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      out[e] = bv[e] - acc[e];
      const double rq = demote ? (double)(float)out[e] : (double)out[e];
      r_sq += rq * rq;
      x_sq += (double)xs[e] * (double)xs[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = acc[e];
  }
  if (kAligned && i0 < r) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(y + i0) = make_float4(out[0], out[1], out[2], out[3]);
    else
      *reinterpret_cast<double2*>(y + i0) = make_double2(out[0], out[1]);
  } else if (!kAligned) {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (i0 + e < r) y[i0 + e] = out[e];
  }

  if constexpr (RESIDUAL) {
    __shared__ double scratch[2][kWarps];
    __shared__ bool last;
    r_sq = block_sum(r_sq, scratch[0]);
    x_sq = block_sum(x_sq, scratch[1]);
    if (threadIdx.x == 0) {
      partials[2 * blockIdx.x] = r_sq;
      partials[2 * blockIdx.x + 1] = x_sq;
    }
    // the last block to finish adds the blocks' partials in block order:
    // warp q < 2 sums quantity q, lane l blocks l, l + 32, ..., then a warp
    // tree
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp < 2) {
      double s = 0.0;
      for (int k = lane; k < (int)gridDim.x; k += 32) s += __ldcg(partials + 2 * k + warp);
      s = warp_sum(s);
      if (lane == 0) sums[warp] = s;
    }
    if (threadIdx.x == 0) *ticket = 0u;
  }
}

template <typename T, bool RESIDUAL>
static int launch_halo(const T* data, const T* x, const T* left, const T* right, const T* b,
                       T* y, double* partials, unsigned* ticket, double* sums, int r, int hl,
                       int hr, int n_diags, const int* offsets, int demote, int b0, int b1,
                       void* stream) {
  if (r <= 0 || hl < 0 || hr < 0 || n_diags <= 0 || n_diags > kMaxDiags)
    return (int)cudaErrorInvalidValue;
  int c0 = 0, c1 = 0;
  halo_interior(offsets, n_diags, r, halo_block_rows<T>(), &c0, &c1);
  if (b0 != c0 || b1 != c1) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  for (int d = 0; d < n_diags; ++d) offs.off[d] = offsets[d];
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool aligned = r % halo_vec<T>() == 0 && al(data) && al(x) && al(y) &&
                       (!RESIDUAL || al(b));
  auto kernel =
      aligned ? dia_halo_kernel<T, RESIDUAL, true> : dia_halo_kernel<T, RESIDUAL, false>;
  kernel<<<blocks_for(r, halo_block_rows<T>()), kThreads, 0, (cudaStream_t)stream>>>(
      data, x, left, right, b, y, partials, ticket, sums, r, hl, hr, n_diags, offs, demote, b0,
      b1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// [b0, b1): halo_kernel.py:halo_plan's interior blocks (checked here)
int gmres_dia_spmv_halo_f32(const float* data, const float* x, const float* left,
                            const float* right, float* y, int r, int hl, int hr, int n_diags,
                            const int* offsets, int b0, int b1, void* stream) {
  return launch_halo<float, false>(data, x, left, right, nullptr, y, nullptr, nullptr, nullptr,
                                   r, hl, hr, n_diags, offsets, 0, b0, b1, stream);
}

int gmres_dia_spmv_halo_f64(const double* data, const double* x, const double* left,
                            const double* right, double* y, int r, int hl, int hr,
                            int n_diags, const int* offsets, int b0, int b1, void* stream) {
  return launch_halo<double, false>(data, x, left, right, nullptr, y, nullptr, nullptr,
                                    nullptr, r, hl, hr, n_diags, offsets, 0, b0, b1, stream);
}

// residual mode: partials (blocks, 2) scratch, ticket K2's zeroed counter
// (left zeroed), sums the two fp64 sums of squares
int gmres_dia_residual_halo_f32(const float* data, const float* x, const float* left,
                                const float* right, const float* b, float* res,
                                double* partials, unsigned* ticket, double* sums, int r, int hl,
                                int hr, int n_diags, const int* offsets, int demote, int b0,
                                int b1, void* stream) {
  return launch_halo<float, true>(data, x, left, right, b, res, partials, ticket, sums, r, hl,
                                  hr, n_diags, offsets, demote, b0, b1, stream);
}

int gmres_dia_residual_halo_f64(const double* data, const double* x, const double* left,
                                const double* right, const double* b, double* res,
                                double* partials, unsigned* ticket, double* sums, int r, int hl,
                                int hr, int n_diags, const int* offsets, int demote, int b0,
                                int b1, void* stream) {
  return launch_halo<double, true>(data, x, left, right, b, res, partials, ticket, sums, r, hl,
                                   hr, n_diags, offsets, demote, b0, b1, stream);
}

}  // extern "C"
