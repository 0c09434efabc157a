// K2-K4 and K2x2: sweeps over the row-stored Krylov basis V (m+1, n).
//
// K2 basis_gram<TV>            u[j] = sum_i V[j,i] w[i]            for j < rows
//   replaces gmres_tpu/ops/pallas/orth_kernel.py:_gram (pallas_call at :59).
// K3 basis_update<TV,GRAM,SUMSQ>  w' = w - sum_j u[j] V[j,:], fused with
//   u2 = V w' (GRAM) or ||w'||^2 (SUMSQ) over the same tile
//   replaces orth_kernel.py:_update_gram (:171) and _update_sumsq (:216);
//   with both flags off it is _update (:129), exported as basis_update
//   (CGS passes of CGSR with orth_steps != 2).  gram, update_gram and
//   update_sumsq chained are one CGSR step (orth_kernel.py:cgsr2_pallas).
// K2x2 basis_gram2<TV>        (u0, u1) = (V w0, V w1) over rows < rows
//   replaces orth_kernel.py:_gram2 (:102), the one reduction of an ICWY
//   (one-reduce MGS) step: each tile of V is read once for both vectors,
//   so the sweep costs one read of the basis where two K2 launches cost
//   two.  Partials (n_blocks, m+1, 2), no atomics, as in K2.
// K4 basis_axpy<TV,TX>         x[i] += (TX)(sum_{j<rows} y[j] V[j,i])
//   replaces gmres_tpu/ops/pallas/df64_kernel.py:axpy_df64 (:295) and the
//   basis combination gmres_tpu/solver/gmres.py:547 does with jnp.matmul:
//   the increment is summed in the basis dtype and added to the fp64 iterate
//   without ever being written to memory.  The TPU added it to a
//   double-float pair; the H100 has native fp64.
// K4 pair mode basis_axpy_pair   x[i] += sum_{j<rows} y[j] (Vh[j,i] + Vl[j,i])
//   the solution update of a df64 cycle (gmres_tpu/solver/gmres.py:538-545,
//   df_basis_comb then a pair add): each basis pair is merged to fp64 in
//   registers and the sum taken in native fp64, so no fp64 copy of the basis
//   (250 MB at m = 30, n = 1M) is ever made.
//
// What bounds them: device-memory bandwidth.  Each sweep reads rows x n basis
// values and does 2 flops per value (124 MB per full fp32 sweep at m+1 = 31,
// n = 1M), about 0.5 flop per byte.
//
// What the design does about it:
// - Only rows 0..rows-1 are read.  Inside the Arnoldi loop rows k+1..m of V
//   are still zero (orth_kernel.py:11-13), so the caller passes rows = k+1,
//   the host loop index: an average step reads half the basis instead of
//   all of it, where the TPU kernels always streamed all m+1 rows.
// - A block owns a tile of kTile columns; each thread keeps its kItems
//   values of w (and of w') in registers, so w is read once per sweep and
//   every basis row is one coalesced pass over the tile.
// - Cross-column sums are a warp-shuffle tree per row and per-block partials
//   (n_blocks, m+1) that the wrapper finishes with torch.sum: no atomics.
// - The GRAM pass of K3 reads the tile's rows a second time right after the
//   update pass; the tile (rows x kTile values, <= 248 KB) was just read, so
//   that second read is served by L1/L2 rather than device memory.
// - Sums are taken in the basis dtype: fp32 for the mixed inner loop, fp64
//   for the baseline (the TPU kernels were fp32-only; fp64 went to XLA).
#include "common.cuh"

using namespace gmres;

// red[warp * kMaxRows + j] holds warp `warp`'s share of row j; thread j
// finishes row j over the warps and writes the block's partial.  Rows
// rows..m1-1 get a zero partial, so the caller's torch.sum over blocks
// yields the full (m1,) vector with its zero tail.
template <typename T>
__device__ __forceinline__ void write_row_partials(const T* red, T* partials,
                                                   int rows, int m1) {
  __syncthreads();
  for (int j = threadIdx.x; j < m1; j += kThreads) {
    T s = T(0);
    if (j < rows) {
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q * kMaxRows + j];
    }
    partials[(size_t)blockIdx.x * m1 + j] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
basis_gram_kernel(const T* __restrict__ V, const T* __restrict__ w,
                  T* __restrict__ partials, int n, int rows, int m1) {
  __shared__ T red[kWarps * kMaxRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t col0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  T wv[kItems];
  load_tile(w, col0, n, wv);
  for (int j = 0; j < rows; ++j) {
    T rv[kItems];
    load_tile(V + (size_t)j * n, col0, n, rv);
    T p = T(0);
#pragma unroll
    for (int it = 0; it < kItems; ++it) p += rv[it] * wv[it];
    p = warp_sum(p);
    if (lane == 0) red[warp * kMaxRows + j] = p;
  }
  write_row_partials(red, partials, rows, m1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
basis_gram2_kernel(const T* __restrict__ V, const T* __restrict__ w0,
                   const T* __restrict__ w1, T* __restrict__ partials, int n, int rows,
                   int m1) {
  // red[(c * kWarps + warp) * kMaxRows + j]: warp `warp`'s share of row j
  // against vector c (32 KB in fp64)
  __shared__ T red[2 * kWarps * kMaxRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t col0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  T av[kItems], bv[kItems];
  load_tile(w0, col0, n, av);
  load_tile(w1, col0, n, bv);
  for (int j = 0; j < rows; ++j) {
    T rv[kItems];
    load_tile(V + (size_t)j * n, col0, n, rv);
    T p0 = T(0), p1 = T(0);
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      p0 += rv[it] * av[it];
      p1 += rv[it] * bv[it];
    }
    p0 = warp_sum(p0);
    p1 = warp_sum(p1);
    if (lane == 0) {
      red[warp * kMaxRows + j] = p0;
      red[(kWarps + warp) * kMaxRows + j] = p1;
    }
  }
  __syncthreads();
  // partials[block][j][c]; rows past `rows` get zeros (the zero tail)
  for (int j = threadIdx.x; j < m1; j += kThreads) {
    T s0 = T(0), s1 = T(0);
    if (j < rows) {
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        s0 += red[q * kMaxRows + j];
        s1 += red[(kWarps + q) * kMaxRows + j];
      }
    }
    T* out = partials + ((size_t)blockIdx.x * m1 + j) * 2;
    out[0] = s0;
    out[1] = s1;
  }
}

template <typename T, bool GRAM, bool SUMSQ>
__global__ void __launch_bounds__(kThreads)
basis_update_kernel(const T* __restrict__ V, const T* __restrict__ w,
                    const T* __restrict__ u, T* __restrict__ w_out,
                    T* __restrict__ partials, int n, int rows, int m1) {
  __shared__ T us[kMaxRows];
  __shared__ T red[GRAM ? kWarps * kMaxRows : kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < rows; j += kThreads) us[j] = u[j];
  __syncthreads();

  const size_t col0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  T wv[kItems], acc[kItems];
  load_tile(w, col0, n, wv);
#pragma unroll
  for (int it = 0; it < kItems; ++it) acc[it] = T(0);
  // w' = w - (u^T V): the combination is summed first and subtracted once,
  // the order of the reference formulation (orth_kernel.py:_update_kernel).
  for (int j = 0; j < rows; ++j) {
    T rv[kItems];
    load_tile(V + (size_t)j * n, col0, n, rv);
    const T uj = us[j];
#pragma unroll
    for (int it = 0; it < kItems; ++it) acc[it] += uj * rv[it];
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    wv[it] -= acc[it];
    const size_t c = col0 + (size_t)it * kThreads;
    if (c < (size_t)n) w_out[c] = wv[it];
  }
  // out-of-range columns hold w = 0 and acc = 0, so wv is 0 there and adds
  // nothing to the sums below

  if constexpr (GRAM) {
    for (int j = 0; j < rows; ++j) {
      T rv[kItems];
      load_tile(V + (size_t)j * n, col0, n, rv);
      T p = T(0);
#pragma unroll
      for (int it = 0; it < kItems; ++it) p += rv[it] * wv[it];
      p = warp_sum(p);
      if (lane == 0) red[warp * kMaxRows + j] = p;
    }
    write_row_partials(red, partials, rows, m1);
  }
  if constexpr (SUMSQ) {
    T p = T(0);
#pragma unroll
    for (int it = 0; it < kItems; ++it) p += wv[it] * wv[it];
    p = block_sum(p, red);
    if (threadIdx.x == 0) partials[blockIdx.x] = p;
  }
}

template <typename T, typename TX>
__global__ void __launch_bounds__(kThreads)
basis_axpy_kernel(const T* __restrict__ V, const T* __restrict__ y,
                  TX* __restrict__ x, int n, int rows) {
  __shared__ T ys[kMaxRows];
  for (int j = threadIdx.x; j < rows; j += kThreads) ys[j] = y[j];
  __syncthreads();
  const size_t col0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  T acc[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) acc[it] = T(0);
  for (int j = 0; j < rows; ++j) {
    T rv[kItems];
    load_tile(V + (size_t)j * n, col0, n, rv);
    const T yj = ys[j];
#pragma unroll
    for (int it = 0; it < kItems; ++it) acc[it] += yj * rv[it];
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const size_t c = col0 + (size_t)it * kThreads;
    if (c < (size_t)n) x[c] += (TX)acc[it];
  }
}

__global__ void __launch_bounds__(kThreads)
basis_axpy_pair_kernel(const float* __restrict__ Vh, const float* __restrict__ Vl,
                       const double* __restrict__ y, double* __restrict__ x, int n, int rows) {
  __shared__ double ys[kMaxRows];
  for (int j = threadIdx.x; j < rows; j += kThreads) ys[j] = y[j];
  __syncthreads();
  const size_t col0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  double acc[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) acc[it] = 0.0;
  for (int j = 0; j < rows; ++j) {
    float vh[kItems], vl[kItems];
    load_tile(Vh + (size_t)j * n, col0, n, vh);
    load_tile(Vl + (size_t)j * n, col0, n, vl);
    const double yj = ys[j];
#pragma unroll
    for (int it = 0; it < kItems; ++it) acc[it] += yj * ((double)vh[it] + (double)vl[it]);
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const size_t c = col0 + (size_t)it * kThreads;
    if (c < (size_t)n) x[c] += acc[it];
  }
}

static bool bad_shape(int n, int rows, int m1) {
  return n <= 0 || rows <= 0 || rows > m1 || m1 > kMaxRows;
}

template <typename T>
static int launch_gram(const T* V, const T* w, T* partials, int n, int rows, int m1,
                       void* stream) {
  if (bad_shape(n, rows, m1)) return (int)cudaErrorInvalidValue;
  basis_gram_kernel<T><<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      V, w, partials, n, rows, m1);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_gram2(const T* V, const T* w0, const T* w1, T* partials, int n, int rows,
                        int m1, void* stream) {
  if (bad_shape(n, rows, m1)) return (int)cudaErrorInvalidValue;
  basis_gram2_kernel<T><<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      V, w0, w1, partials, n, rows, m1);
  return (int)cudaGetLastError();
}

template <typename T, bool GRAM, bool SUMSQ>
static int launch_update(const T* V, const T* w, const T* u, T* w_out, T* partials,
                         int n, int rows, int m1, void* stream) {
  if (bad_shape(n, rows, m1)) return (int)cudaErrorInvalidValue;
  basis_update_kernel<T, GRAM, SUMSQ>
      <<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
          V, w, u, w_out, partials, n, rows, m1);
  return (int)cudaGetLastError();
}

template <typename T, typename TX>
static int launch_axpy(const T* V, const T* y, TX* x, int n, int rows, void* stream) {
  if (bad_shape(n, rows, rows)) return (int)cudaErrorInvalidValue;
  basis_axpy_kernel<T, TX><<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      V, y, x, n, rows);
  return (int)cudaGetLastError();
}

extern "C" {

int gmres_basis_gram_f32(const float* V, const float* w, float* partials, int n,
                         int rows, int m1, void* stream) {
  return launch_gram<float>(V, w, partials, n, rows, m1, stream);
}

int gmres_basis_gram_f64(const double* V, const double* w, double* partials, int n,
                         int rows, int m1, void* stream) {
  return launch_gram<double>(V, w, partials, n, rows, m1, stream);
}

int gmres_basis_gram2_f32(const float* V, const float* w0, const float* w1, float* partials,
                          int n, int rows, int m1, void* stream) {
  return launch_gram2<float>(V, w0, w1, partials, n, rows, m1, stream);
}

int gmres_basis_gram2_f64(const double* V, const double* w0, const double* w1,
                          double* partials, int n, int rows, int m1, void* stream) {
  return launch_gram2<double>(V, w0, w1, partials, n, rows, m1, stream);
}

// K3 with both flags off: w' = w - u^T V alone (orth_kernel.py:_update)
int gmres_basis_update_f32(const float* V, const float* w, const float* u, float* w_out,
                           int n, int rows, int m1, void* stream) {
  return launch_update<float, false, false>(V, w, u, w_out, nullptr, n, rows, m1, stream);
}

int gmres_basis_update_f64(const double* V, const double* w, const double* u,
                           double* w_out, int n, int rows, int m1, void* stream) {
  return launch_update<double, false, false>(V, w, u, w_out, nullptr, n, rows, m1, stream);
}

int gmres_basis_update_gram_f32(const float* V, const float* w, const float* u,
                                float* w_out, float* partials, int n, int rows,
                                int m1, void* stream) {
  return launch_update<float, true, false>(V, w, u, w_out, partials, n, rows, m1,
                                           stream);
}

int gmres_basis_update_gram_f64(const double* V, const double* w, const double* u,
                                double* w_out, double* partials, int n, int rows,
                                int m1, void* stream) {
  return launch_update<double, true, false>(V, w, u, w_out, partials, n, rows, m1,
                                            stream);
}

int gmres_basis_update_sumsq_f32(const float* V, const float* w, const float* u,
                                 float* w_out, float* partials, int n, int rows,
                                 int m1, void* stream) {
  return launch_update<float, false, true>(V, w, u, w_out, partials, n, rows, m1,
                                           stream);
}

int gmres_basis_update_sumsq_f64(const double* V, const double* w, const double* u,
                                 double* w_out, double* partials, int n, int rows,
                                 int m1, void* stream) {
  return launch_update<double, false, true>(V, w, u, w_out, partials, n, rows, m1,
                                            stream);
}

// suffix: basis dtype, then iterate dtype
int gmres_basis_axpy_f32_f64(const float* V, const float* y, double* x, int n, int rows,
                             void* stream) {
  return launch_axpy<float, double>(V, y, x, n, rows, stream);
}

int gmres_basis_axpy_f64_f64(const double* V, const double* y, double* x, int n,
                             int rows, void* stream) {
  return launch_axpy<double, double>(V, y, x, n, rows, stream);
}

int gmres_basis_axpy_f32_f32(const float* V, const float* y, float* x, int n, int rows,
                             void* stream) {
  return launch_axpy<float, float>(V, y, x, n, rows, stream);
}

// pair mode: the basis as (hi, lo) fp32 pairs, y and x fp64
int gmres_basis_axpy_pair(const float* Vh, const float* Vl, const double* y, double* x, int n,
                          int rows, void* stream) {
  if (bad_shape(n, rows, rows)) return (int)cudaErrorInvalidValue;
  basis_axpy_pair_kernel<<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      Vh, Vl, y, x, n, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
