// K8: DIA sparse matrix-vector product on double-float (hi, lo) fp32 pairs.
//
// Replaces gmres_tpu/ops/pallas/df64_kernel.py:_dia_spmv_df64 (the
// pallas_call at :141, behind dia_spmv_df64 :351): y = A x with the bands
// and x carried as pairs and every product and sum an error-free-transform
// chain (df64.cuh), about 2^-48 relative.  It is every inner SpMV of a
// df64 solve on a DIA operator.  The outer residual of that solve stays
// native fp64 on K1.
//
// What bounds it: device-memory bandwidth.  Per row it reads 2D band words
// and writes two, (2D + 4) x 4 bytes with x; the chains are about 20 fp32
// instructions a band, ~0.6 instruction per byte at D = 5, below the card's
// balance point even for adds, which issue at half the FMA rate.
//
// What the design does about it: K1's layout.  One thread per row, so each
// band read and the two writes are coalesced runs, and each shifted read of
// the x pair is a coalesced run served from L2 (the pair of x is 8 MB at
// n = 1M).  The TPU kernel copied a haloed window of x into VMEM per block;
// here reads outside [0, n_cols) are skipped, as in K1 (the band value
// there is 0 by the DIA layout, and adding a zero pair changes nothing).
// Bands are summed in offset order from a zero pair, the order of the plain
// version, which it matches bit for bit.
#include "df64.cuh"

using namespace gmres;

__global__ void __launch_bounds__(kThreads)
dia_spmv_df64_kernel(const float* __restrict__ dh, const float* __restrict__ dl,
                     const float* __restrict__ xh, const float* __restrict__ xl,
                     float* __restrict__ yh, float* __restrict__ yl, int n_rows, int n_cols,
                     int n_diags, DiaOffsets offs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  float h = 0.f, l = 0.f;
  for (int d = 0; d < n_diags; ++d) {
    const int j = i + offs.off[d];
    if (j >= 0 && j < n_cols) {
      const size_t k = (size_t)d * n_rows + i;
      float ph, pl;
      df_mul(dh[k], dl[k], xh[j], xl[j], ph, pl);
      df_add(h, l, ph, pl, h, l);
    }
  }
  yh[i] = h;
  yl[i] = l;
}

extern "C" {

int gmres_dia_spmv_df64(const float* dh, const float* dl, const float* xh, const float* xl,
                        float* yh, float* yl, int n_rows, int n_cols, int n_diags,
                        const int* offsets, void* stream) {
  if (n_rows <= 0 || n_diags <= 0 || n_diags > kMaxDiags) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  for (int d = 0; d < n_diags; ++d) offs.off[d] = offsets[d];
  dia_spmv_df64_kernel<<<blocks_for(n_rows, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      dh, dl, xh, xl, yh, yl, n_rows, n_cols, n_diags, offs);
  return (int)cudaGetLastError();
}

}  // extern "C"
