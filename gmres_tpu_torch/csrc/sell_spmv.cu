// K5: sliced-ELL sparse matrix-vector product, plain and residual modes.
//
// Replaces, in gmres_tpu/ops/pallas/sell_kernel.py,
//   sell_spmv_pallas: the ELL chunks (pallas_call at :272, bodies
//     _sell_kernel and _sell_kernel_xres) and the dense (W, 128) blocks
//     (pallas_call at :218, _sell_dense_kernel) of the fp32 inner operator;
//   sell_spmv_df64: the same two halves on double-float (hi, lo) pairs
//     (pallas_calls at :452 and :490), the mixed scheme's fp64 outer
//     residual for unstructured operators.  The H100 has fp64 units, so
//     residual mode is native fp64, as K1's is.
//
// The TPU pack (128-row slabs, W-wide column buckets with bucket-relative
// columns, iota-compare densify on the VPU, dense blocks for the MXU)
// existed because v5e has no usable gather.  Hopper gathers in hardware
// and its 50 MB L2 holds all of x (4 MB fp32, 8 MB fp64 at n = 1M), so the
// layout here is the plain sliced ELL of gmres_tpu_torch/ops/sell.py:
// slices of 32 rows, slice s holding w_s slots per row stored column-major
// at slice_ptr[s] + k*32 + r, with absolute int32 columns.  What were dense
// blocks on the TPU are long rows of a slice here.
//
// What bounds it: device-memory bandwidth.  Per slot it reads one value
// and one 4-byte column and does one multiply-add (0.125 flop per byte in
// fp32); the x gathers mostly hit L2.
//
// What the design does about it: one warp per slice and one thread per
// row, so each step k of the slot loop reads 32 consecutive values and 32
// consecutive columns (coalesced), and the warp gathers x[col] through the
// read-only path.  Padding slots carry value 0 and a valid column, so the
// loop has no per-slot test.  Slot addresses are 64-bit.
//
// Residual mode (n_rows == n_cols == n) writes r = b - A x and per-block
// partial sums of ||r'||^2 (r' = r rounded to fp32 when `demote` is set)
// and ||x||^2 in fp64, finished by torch.sum: no atomics, so a run repeats
// bit for bit.
#include "common.cuh"

using namespace gmres;

namespace {

constexpr int kSlice = 32;  // rows per slice: one warp

template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads)
sell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                 const long long* __restrict__ slice_ptr, const T* __restrict__ x,
                 const T* __restrict__ b, T* __restrict__ y,
                 double* __restrict__ partials, int n_rows, int demote) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  T acc = T(0);
  if (i < n_rows) {
    const int s = i / kSlice;
    const long long begin = slice_ptr[s];
    const int width = (int)((slice_ptr[s + 1] - begin) / kSlice);
    const size_t base = (size_t)begin + (size_t)(i % kSlice);
#pragma unroll 4
    for (int k = 0; k < width; ++k) {
      const size_t slot = base + (size_t)k * kSlice;
      acc += vals[slot] * __ldg(x + cols[slot]);
    }
  }
  if constexpr (!RESIDUAL) {
    if (i < n_rows) y[i] = acc;
  } else {
    __shared__ double scratch[2][kWarps];
    double r_sq = 0.0, x_sq = 0.0;
    if (i < n_rows) {
      const T r = b[i] - acc;
      y[i] = r;
      const double rq = demote ? (double)(float)r : (double)r;
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
int launch_sell(const T* vals, const int* cols, const long long* slice_ptr,
                const T* x, const T* b, T* y, double* partials, int n_rows,
                int demote, void* stream) {
  if (n_rows <= 0) return (int)cudaErrorInvalidValue;
  sell_spmv_kernel<T, RESIDUAL><<<blocks_for(n_rows, kThreads), kThreads, 0,
                                  (cudaStream_t)stream>>>(
      vals, cols, slice_ptr, x, b, y, partials, n_rows, demote);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gmres_sell_spmv_f32(const float* vals, const int* cols, const long long* slice_ptr,
                        const float* x, float* y, int n_rows, void* stream) {
  return launch_sell<float, false>(vals, cols, slice_ptr, x, nullptr, y, nullptr,
                                   n_rows, 0, stream);
}

int gmres_sell_spmv_f64(const double* vals, const int* cols, const long long* slice_ptr,
                        const double* x, double* y, int n_rows, void* stream) {
  return launch_sell<double, false>(vals, cols, slice_ptr, x, nullptr, y, nullptr,
                                    n_rows, 0, stream);
}

int gmres_sell_residual_f32(const float* vals, const int* cols,
                            const long long* slice_ptr, const float* x,
                            const float* b, float* r, double* partials, int n,
                            int demote, void* stream) {
  return launch_sell<float, true>(vals, cols, slice_ptr, x, b, r, partials, n,
                                  demote, stream);
}

int gmres_sell_residual_f64(const double* vals, const int* cols,
                            const long long* slice_ptr, const double* x,
                            const double* b, double* r, double* partials, int n,
                            int demote, void* stream) {
  return launch_sell<double, true>(vals, cols, slice_ptr, x, b, r, partials, n,
                                   demote, stream);
}

}  // extern "C"
