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
//     its partial ||r'||^2 and ||x||^2.  The TPU carried it on double-float
//     pairs for want of fp64 units; here residual mode is native fp64.
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
// D + 2 values a row.  One thread per row: the band reads, the x reads of
// each band and the write are coalesced runs; x stays in L2 across the
// bands.  The halo reads are a few warps at each end of the shard.  Offsets
// travel by value in the launch arguments (DiaOffsets).
//
// Residual mode writes per-block fp64 partial sums of ||r'||^2 (r' = r
// rounded to fp32 when `demote` is set: the norm of the mixed scheme's start
// vector) and of ||x||^2 over the shard's own rows; the wrapper folds them,
// and the caller sums the ranks' shares.
#include "common.cuh"

using namespace gmres;

template <typename T>
__device__ __forceinline__ T window(const T* __restrict__ x, const T* __restrict__ left,
                                    const T* __restrict__ right, int j, int r, int hl,
                                    int hr) {
  if (j < 0) return j >= -hl ? left[hl + j] : T(0);
  if (j < r) return x[j];
  return j < r + hr ? right[j - r] : T(0);
}

template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads)
dia_halo_kernel(const T* __restrict__ data, const T* __restrict__ x,
                const T* __restrict__ left, const T* __restrict__ right,
                const T* __restrict__ b, T* __restrict__ y,
                double* __restrict__ partials, int r, int hl, int hr, int n_diags,
                DiaOffsets offs, int demote) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  T acc = T(0);
  if (i < r) {
    for (int d = 0; d < n_diags; ++d)
      acc += data[(size_t)d * r + i] * window(x, left, right, i + offs.off[d], r, hl, hr);
  }
  if constexpr (!RESIDUAL) {
    if (i < r) y[i] = acc;
  } else {
    __shared__ double scratch[2][kWarps];
    double r_sq = 0.0, x_sq = 0.0;
    if (i < r) {
      const T res = b[i] - acc;
      y[i] = res;
      const double rq = demote ? (double)(float)res : (double)res;
      r_sq = rq * rq;
      x_sq = (double)x[i] * (double)x[i];
    }
    r_sq = block_sum(r_sq, scratch[0]);
    x_sq = block_sum(x_sq, scratch[1]);
    if (threadIdx.x == 0) {
      partials[2 * blockIdx.x] = r_sq;
      partials[2 * blockIdx.x + 1] = x_sq;
    }
  }
}

template <typename T, bool RESIDUAL>
static int launch_halo(const T* data, const T* x, const T* left, const T* right, const T* b,
                       T* y, double* partials, int r, int hl, int hr, int n_diags,
                       const int* offsets, int demote, void* stream) {
  if (r <= 0 || hl < 0 || hr < 0 || n_diags <= 0 || n_diags > kMaxDiags)
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  for (int d = 0; d < n_diags; ++d) offs.off[d] = offsets[d];
  dia_halo_kernel<T, RESIDUAL><<<blocks_for(r, kThreads), kThreads, 0,
                                 (cudaStream_t)stream>>>(
      data, x, left, right, b, y, partials, r, hl, hr, n_diags, offs, demote);
  return (int)cudaGetLastError();
}

extern "C" {

int gmres_dia_spmv_halo_f32(const float* data, const float* x, const float* left,
                            const float* right, float* y, int r, int hl, int hr, int n_diags,
                            const int* offsets, void* stream) {
  return launch_halo<float, false>(data, x, left, right, nullptr, y, nullptr, r, hl, hr,
                                   n_diags, offsets, 0, stream);
}

int gmres_dia_spmv_halo_f64(const double* data, const double* x, const double* left,
                            const double* right, double* y, int r, int hl, int hr,
                            int n_diags, const int* offsets, void* stream) {
  return launch_halo<double, false>(data, x, left, right, nullptr, y, nullptr, r, hl, hr,
                                    n_diags, offsets, 0, stream);
}

int gmres_dia_residual_halo_f32(const float* data, const float* x, const float* left,
                                const float* right, const float* b, float* res,
                                double* partials, int r, int hl, int hr, int n_diags,
                                const int* offsets, int demote, void* stream) {
  return launch_halo<float, true>(data, x, left, right, b, res, partials, r, hl, hr, n_diags,
                                  offsets, demote, stream);
}

int gmres_dia_residual_halo_f64(const double* data, const double* x, const double* left,
                                const double* right, const double* b, double* res,
                                double* partials, int r, int hl, int hr, int n_diags,
                                const int* offsets, int demote, void* stream) {
  return launch_halo<double, true>(data, x, left, right, b, res, partials, r, hl, hr,
                                   n_diags, offsets, demote, stream);
}

}  // extern "C"
