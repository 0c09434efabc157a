// K1: DIA sparse matrix-vector product, plain and residual modes.
//
// Replaces
//   gmres_tpu/ops/pallas/spmv_kernel.py:dia_spmv_pallas (the pallas_call at
//     :88), the fp32 inner operator of the Arnoldi loop; and
//   gmres_tpu/ops/pallas/df64_kernel.py:residual_df64 (the pallas_call at
//     :243), the mixed scheme's outer residual r = b - A x with ||r||^2 and
//     ||x||^2.  The TPU ran it on double-float (hi, lo) fp32 pairs because it
//     has no fp64 units; the H100 has them, so residual mode is native fp64.
//
// What bounds it: device-memory bandwidth.  Per row it does 2D flops on
// (D + 2) values (D band values, x, y; + b in residual mode), about 0.25
// flop per byte in fp32, far below the card's balance point.
//
// What the design does about it: one thread per row, so the band reads
// data[d, i] and the output write are fully coalesced, and each of the D
// shifted reads x[i + off_d] is a coalesced run too.  The TPU kernel staged
// a haloed window of x into VMEM once per block to avoid re-reading x per
// band; here x (4 MB fp32, 8 MB fp64 at n = 1M) stays in the 50 MB L2, so the
// D shifted reads cost L2 bandwidth and device memory sees x about once.
// No padded copy of x is made: reads outside [0, n_cols) are skipped (the
// band value there is 0 by the DIA layout).  Offsets travel by value in the
// kernel arguments.
//
// Residual mode also writes per-block partial sums of ||r'||^2 (r' = r
// rounded to the inner dtype when `demote` is set, the norm the solver
// takes of its fp32 start vector) and ||x||^2, accumulated in fp64.
#include "common.cuh"

using namespace gmres;

template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                const T* __restrict__ b, T* __restrict__ y,
                double* __restrict__ partials, int n_rows, int n_cols,
                int n_diags, DiaOffsets offs, int demote) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  T acc = T(0);
  if (i < n_rows) {
    for (int d = 0; d < n_diags; ++d) {
      const int j = i + offs.off[d];
      if (j >= 0 && j < n_cols) acc += data[(size_t)d * n_rows + i] * x[j];
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

// K1's lane form: Y = A X (or R = B - A X with each lane's two per-block
// partials) for L lanes of X at once, the batched solve's SpMV
// (solver/batched.py).  The TPU had no counterpart: the JAX package batched
// its solves with vmap on XLA paths only, because its Pallas kernels do not
// batch.
//
// What bounds it: bytes, as K1.  The bands are the same for every lane, so
// reading each band value once for all L lanes moves (D + 2L) n values
// against L (D + 2) n for L launches of K1.
//
// What the design does about it: K1's thread per row, with L accumulators in
// registers; each band value is loaded once and applied to every lane's
// x[i + off_d].  Lane l of X starts x_ld values after lane l - 1, so X can be
// a strided view (a row of every lane's Krylov basis, V[:, k, :]) and is not
// copied.  L is a template parameter (1, 2, 4, 8); the wrapper runs wider
// batches in chunks.
//
// Bits: lane l is K1 on x_l.  The bands are walked in the same order with the
// same `acc += data * x` (contracted to the same FMA), and in residual mode
// each lane's two sums use K1's block geometry and block_sum, its partials
// written to their own row (p_ld values apart) so that the wrapper finishes
// each lane's as K1's wrapper finishes K1's.
template <typename T, bool RESIDUAL, int L>
__global__ void __launch_bounds__(kThreads)
dia_spmv_lanes_kernel(const T* __restrict__ data, const T* __restrict__ x, long long x_ld,
                      const T* __restrict__ b, long long b_ld, T* __restrict__ y,
                      long long y_ld, double* __restrict__ partials, long long p_ld,
                      int n_rows, int n_cols, int n_diags, DiaOffsets offs, int demote) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  T acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = T(0);
  if (i < n_rows) {
    for (int d = 0; d < n_diags; ++d) {
      const int j = i + offs.off[d];
      if (j >= 0 && j < n_cols) {
        const T v = data[(size_t)d * n_rows + i];
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] += v * x[(size_t)l * x_ld + j];
      }
    }
  }
  if constexpr (!RESIDUAL) {
    if (i < n_rows) {
#pragma unroll
      for (int l = 0; l < L; ++l) y[(size_t)l * y_ld + i] = acc[l];
    }
  } else {
    __shared__ double scratch[2][kWarps];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      double r_sq = 0.0, x_sq = 0.0;
      if (i < n_rows) {
        const T r = b[(size_t)l * b_ld + i] - acc[l];
        y[(size_t)l * y_ld + i] = r;
        const double rq = demote ? (double)(float)r : (double)r;
        r_sq = rq * rq;
        x_sq = (double)x[(size_t)l * x_ld + i] * (double)x[(size_t)l * x_ld + i];
      }
      r_sq = block_sum(r_sq, scratch[0]);
      x_sq = block_sum(x_sq, scratch[1]);
      if (threadIdx.x == 0) {
        partials[(size_t)l * p_ld + 2 * blockIdx.x] = r_sq;
        partials[(size_t)l * p_ld + 2 * blockIdx.x + 1] = x_sq;
      }
    }
  }
}

template <typename T, bool RESIDUAL, int L>
static void launch_lanes(const T* data, const T* x, long long x_ld, const T* b, long long b_ld,
                         T* y, long long y_ld, double* partials, long long p_ld, int n_rows,
                         int n_cols, int n_diags, const DiaOffsets& offs, int demote,
                         void* stream) {
  dia_spmv_lanes_kernel<T, RESIDUAL, L><<<blocks_for(n_rows, kThreads), kThreads, 0,
                                          (cudaStream_t)stream>>>(
      data, x, x_ld, b, b_ld, y, y_ld, partials, p_ld, n_rows, n_cols, n_diags, offs, demote);
}

template <typename T, bool RESIDUAL>
static int launch_dia_lanes(const T* data, const T* x, long long x_ld, const T* b,
                            long long b_ld, T* y, long long y_ld, double* partials,
                            long long p_ld, int n_rows, int n_cols, int n_diags,
                            const int* offsets, int demote, int lanes, void* stream) {
  if (n_rows <= 0 || n_diags <= 0 || n_diags > kMaxDiags) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  for (int d = 0; d < n_diags; ++d) offs.off[d] = offsets[d];
  switch (lanes) {
    case 1:
      launch_lanes<T, RESIDUAL, 1>(data, x, x_ld, b, b_ld, y, y_ld, partials, p_ld, n_rows,
                                   n_cols, n_diags, offs, demote, stream);
      break;
    case 2:
      launch_lanes<T, RESIDUAL, 2>(data, x, x_ld, b, b_ld, y, y_ld, partials, p_ld, n_rows,
                                   n_cols, n_diags, offs, demote, stream);
      break;
    case 4:
      launch_lanes<T, RESIDUAL, 4>(data, x, x_ld, b, b_ld, y, y_ld, partials, p_ld, n_rows,
                                   n_cols, n_diags, offs, demote, stream);
      break;
    case 8:
      launch_lanes<T, RESIDUAL, 8>(data, x, x_ld, b, b_ld, y, y_ld, partials, p_ld, n_rows,
                                   n_cols, n_diags, offs, demote, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool RESIDUAL>
static int launch_dia(const T* data, const T* x, const T* b, T* y,
                      double* partials, int n_rows, int n_cols, int n_diags,
                      const int* offsets, int demote, void* stream) {
  if (n_rows <= 0 || n_diags <= 0 || n_diags > kMaxDiags) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  for (int d = 0; d < n_diags; ++d) offs.off[d] = offsets[d];
  dia_spmv_kernel<T, RESIDUAL><<<blocks_for(n_rows, kThreads), kThreads, 0,
                                 (cudaStream_t)stream>>>(
      data, x, b, y, partials, n_rows, n_cols, n_diags, offs, demote);
  return (int)cudaGetLastError();
}

extern "C" {

int gmres_dia_spmv_f32(const float* data, const float* x, float* y, int n_rows,
                       int n_cols, int n_diags, const int* offsets, void* stream) {
  return launch_dia<float, false>(data, x, nullptr, y, nullptr, n_rows, n_cols,
                                  n_diags, offsets, 0, stream);
}

int gmres_dia_spmv_f64(const double* data, const double* x, double* y, int n_rows,
                       int n_cols, int n_diags, const int* offsets, void* stream) {
  return launch_dia<double, false>(data, x, nullptr, y, nullptr, n_rows, n_cols,
                                   n_diags, offsets, 0, stream);
}

int gmres_dia_residual_f32(const float* data, const float* x, const float* b,
                           float* r, double* partials, int n, int n_diags,
                           const int* offsets, int demote, void* stream) {
  return launch_dia<float, true>(data, x, b, r, partials, n, n, n_diags, offsets,
                                 demote, stream);
}

int gmres_dia_residual_f64(const double* data, const double* x, const double* b,
                           double* r, double* partials, int n, int n_diags,
                           const int* offsets, int demote, void* stream) {
  return launch_dia<double, true>(data, x, b, r, partials, n, n, n_diags, offsets,
                                  demote, stream);
}

int gmres_dia_spmv_lanes_f32(const float* data, const float* x, long long x_ld, float* y,
                             long long y_ld, int n_rows, int n_cols, int n_diags,
                             const int* offsets, int lanes, void* stream) {
  return launch_dia_lanes<float, false>(data, x, x_ld, nullptr, 0, y, y_ld, nullptr, 0, n_rows,
                                        n_cols, n_diags, offsets, 0, lanes, stream);
}

int gmres_dia_spmv_lanes_f64(const double* data, const double* x, long long x_ld, double* y,
                             long long y_ld, int n_rows, int n_cols, int n_diags,
                             const int* offsets, int lanes, void* stream) {
  return launch_dia_lanes<double, false>(data, x, x_ld, nullptr, 0, y, y_ld, nullptr, 0, n_rows,
                                         n_cols, n_diags, offsets, 0, lanes, stream);
}

int gmres_dia_residual_lanes_f32(const float* data, const float* x, long long x_ld,
                                 const float* b, long long b_ld, float* r, long long r_ld,
                                 double* partials, long long p_ld, int n, int n_diags,
                                 const int* offsets, int demote, int lanes, void* stream) {
  return launch_dia_lanes<float, true>(data, x, x_ld, b, b_ld, r, r_ld, partials, p_ld, n, n,
                                       n_diags, offsets, demote, lanes, stream);
}

int gmres_dia_residual_lanes_f64(const double* data, const double* x, long long x_ld,
                                 const double* b, long long b_ld, double* r, long long r_ld,
                                 double* partials, long long p_ld, int n, int n_diags,
                                 const int* offsets, int demote, int lanes, void* stream) {
  return launch_dia_lanes<double, true>(data, x, x_ld, b, b_ld, r, r_ld, partials, p_ld, n, n,
                                        n_diags, offsets, demote, lanes, stream);
}

const char* gmres_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch geometry, so that the Python wrappers size their partial buffers
// from the constants the kernels were compiled with.
void gmres_kernel_shape(int* threads, int* tile, int* max_rows, int* max_diags) {
  *threads = kThreads;
  *tile = kTile;
  *max_rows = kMaxRows;
  *max_diags = kMaxDiags;
}

}  // extern "C"
