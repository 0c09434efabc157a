// K9-K11: sweeps over the double-float Krylov basis (Vh, Vl), each (m+1, n)
// fp32, of a df64 solve.
//
// K9  df_gram            u[j] = <V_j, w>                        for j < rows
//   replaces gmres_tpu/ops/pallas/df64_kernel.py:df_gram_pallas (the
//   pallas_call at :559); with a one-row basis it is also the df64 dot and
//   norm (the TPU's ops/blas.py:_df64_dot_fast rode the same kernel).
// K10 df_update_gram     w' = w - sum_j u[j] V_j,  u2 = V w'
//   replaces df64_kernel.py:df_update_gram_pallas (:602), the middle pass
//   of a CGSR step.
// K11 df_update_sumsq    w' = w - sum_j u[j] V_j,  ||w'||^2
//   replaces df64_kernel.py:df_update_sumsq_pallas (:656): the last pass of
//   CGS, CGSR and ICWY MGS, and with a one-row basis each row of sequential
//   MGS.
// w, w' and V are (hi, lo) pairs; u arrives in fp64 and is split per row;
// u, u2 and ||w'||^2 leave in fp64.  Products and sums are the
// error-free-transform chains of df64.cuh, in the plain version's order.
//
// What bounds them: device-memory bandwidth.  A sweep reads 2 x rows x n
// basis words; the chains cost about 20 fp32 instructions a (row, column)
// (K10 40), ~2.5 instructions per byte, below the card's balance point for
// adds at half the FMA rate (~11 per byte at 33.5 T/s against ~3 TB/s).
//
// What the design does about it: K2/K3's structure.
// - Only rows 0..rows-1 are read: the caller passes rows = k + 1.
// - A block owns a tile of kTile columns, each thread kItems of them kThreads
//   apart, so w stays in registers and every basis row is one coalesced pass.
// - The combination sum_j u_j V_j is accumulated per column in row order
//   from a zero pair (eft.py:df_basis_comb), so w' matches the plain version
//   bit for bit.
// - Column sums: each thread adds its kItems products in order, a fixed
//   shuffle tree adds the warp's, and one thread per row adds the warps' in
//   order; the block's pair is written merged to fp64 as its partial
//   (n_blocks, m+1), which the wrapper folds with torch.sum in fp64.  No
//   atomics: the result repeats bit for bit.  (The TPU kept per-lane pair
//   partials and merged at the end, df64_kernel.py:505-511.)  The plain
//   version sums by a halving tree over n, so sums agree to rounding.
// - K10's second pass reads the tile's rows again right after the update
//   pass, from L1/L2.
#include "df64.cuh"

using namespace gmres;

// red[c][warp * kMaxRows + j] holds warp `warp`'s pair component c of row j;
// thread j adds row j over the warps in order and writes the block's fp64
// partial; rows rows..m1-1 get 0, so the wrapper's torch.sum over blocks
// yields the full (m1,) vector with its zero tail.
__device__ __forceinline__ void write_pair_partials(float (*red)[kWarps * kMaxRows],
                                                    double* partials, int rows, int m1) {
  __syncthreads();
  for (int j = threadIdx.x; j < m1; j += kThreads) {
    float h = 0.f, l = 0.f;
    if (j < rows) {
      for (int q = 0; q < kWarps; ++q)
        df_add(h, l, red[0][q * kMaxRows + j], red[1][q * kMaxRows + j], h, l);
    }
    partials[(size_t)blockIdx.x * m1 + j] = merge_f64(h, l);
  }
}

// rows 0..rows-1 of (Vh, Vl) against the pair (ah, al) in registers: each
// row's block sum into red
__device__ __forceinline__ void gram_rows(const float* __restrict__ Vh,
                                          const float* __restrict__ Vl, const float (&ah)[kItems],
                                          const float (&al)[kItems], size_t col0, int n, int rows,
                                          float (*red)[kWarps * kMaxRows]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < rows; ++j) {
    float vh[kItems], vl[kItems];
    load_tile(Vh + (size_t)j * n, col0, n, vh);
    load_tile(Vl + (size_t)j * n, col0, n, vl);
    float h = 0.f, l = 0.f;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      float ph, pl;
      df_mul(vh[it], vl[it], ah[it], al[it], ph, pl);
      df_add(h, l, ph, pl, h, l);
    }
    warp_df_sum(h, l);
    if (lane == 0) {
      red[0][warp * kMaxRows + j] = h;
      red[1][warp * kMaxRows + j] = l;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
df_gram_kernel(const float* __restrict__ Vh, const float* __restrict__ Vl,
               const float* __restrict__ wh, const float* __restrict__ wl,
               double* __restrict__ partials, int n, int rows, int m1) {
  __shared__ float red[2][kWarps * kMaxRows];
  const size_t col0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  float ah[kItems], al[kItems];
  load_tile(wh, col0, n, ah);
  load_tile(wl, col0, n, al);
  gram_rows(Vh, Vl, ah, al, col0, n, rows, red);
  write_pair_partials(red, partials, rows, m1);
}

template <bool GRAM>
__global__ void __launch_bounds__(kThreads)
df_update_kernel(const float* __restrict__ Vh, const float* __restrict__ Vl,
                 const float* __restrict__ wh, const float* __restrict__ wl,
                 const double* __restrict__ u, float* __restrict__ woh,
                 float* __restrict__ wol, double* __restrict__ partials, int n, int rows,
                 int m1) {
  __shared__ float us[2][kMaxRows];
  __shared__ float red[2][GRAM ? kWarps * kMaxRows : kWarps];
  for (int j = threadIdx.x; j < rows; j += kThreads) split_f64(u[j], us[0][j], us[1][j]);
  __syncthreads();

  const size_t col0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  float ah[kItems], al[kItems], ch[kItems], cl[kItems];
  load_tile(wh, col0, n, ah);
  load_tile(wl, col0, n, al);
#pragma unroll
  for (int it = 0; it < kItems; ++it) ch[it] = cl[it] = 0.f;
  for (int j = 0; j < rows; ++j) {
    float vh[kItems], vl[kItems];
    load_tile(Vh + (size_t)j * n, col0, n, vh);
    load_tile(Vl + (size_t)j * n, col0, n, vl);
    const float uh = us[0][j], ul = us[1][j];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      float ph, pl;
      df_mul(vh[it], vl[it], uh, ul, ph, pl);
      df_add(ch[it], cl[it], ph, pl, ch[it], cl[it]);
    }
  }
  // w' = w - c; out-of-range columns hold zero pairs and stay zero
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    df_add(ah[it], al[it], -ch[it], -cl[it], ah[it], al[it]);
    const size_t c = col0 + (size_t)it * kThreads;
    if (c < (size_t)n) {
      woh[c] = ah[it];
      wol[c] = al[it];
    }
  }

  if constexpr (GRAM) {
    gram_rows(Vh, Vl, ah, al, col0, n, rows, red);
    write_pair_partials(red, partials, rows, m1);
  } else {
    float h = 0.f, l = 0.f;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      float ph, pl;
      df_mul(ah[it], al[it], ah[it], al[it], ph, pl);
      df_add(h, l, ph, pl, h, l);
    }
    warp_df_sum(h, l);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      red[0][warp] = h;
      red[1][warp] = l;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      h = l = 0.f;
      for (int q = 0; q < kWarps; ++q) df_add(h, l, red[0][q], red[1][q], h, l);
      partials[blockIdx.x] = merge_f64(h, l);
    }
  }
}

static bool bad_shape(int n, int rows, int m1) {
  return n <= 0 || rows <= 0 || rows > m1 || m1 > kMaxRows;
}

extern "C" {

int gmres_df_gram(const float* Vh, const float* Vl, const float* wh, const float* wl,
                  double* partials, int n, int rows, int m1, void* stream) {
  if (bad_shape(n, rows, m1)) return (int)cudaErrorInvalidValue;
  df_gram_kernel<<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      Vh, Vl, wh, wl, partials, n, rows, m1);
  return (int)cudaGetLastError();
}

int gmres_df_update_gram(const float* Vh, const float* Vl, const float* wh, const float* wl,
                         const double* u, float* woh, float* wol, double* partials, int n,
                         int rows, int m1, void* stream) {
  if (bad_shape(n, rows, m1)) return (int)cudaErrorInvalidValue;
  df_update_kernel<true><<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      Vh, Vl, wh, wl, u, woh, wol, partials, n, rows, m1);
  return (int)cudaGetLastError();
}

int gmres_df_update_sumsq(const float* Vh, const float* Vl, const float* wh, const float* wl,
                          const double* u, float* woh, float* wol, double* partials, int n,
                          int rows, int m1, void* stream) {
  if (bad_shape(n, rows, m1)) return (int)cudaErrorInvalidValue;
  df_update_kernel<false><<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      Vh, Vl, wh, wl, u, woh, wol, partials, n, rows, m1);
  return (int)cudaGetLastError();
}

}  // extern "C"
