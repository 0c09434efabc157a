// Host helper for the ILU(0) preconditioners: the factorization, the
// triangular dependency levels and an exact substitution used as a host
// oracle.  Carried from gmres_tpu's csrc/gmres_native.cpp (ilu0_factorize,
// tri_level_counts, ilu_trisolve) with 64-bit row pointers and columns,
// the layout of gmres_tpu_torch.sparse.CSRMatrix.
//
// Built by the system C++ compiler at first use (gmres_tpu_torch/ops/cuda/
// _build.py:host_library) with -ffp-contract=off: the factor update
// vals[j] -= factor * vals[p] must round the product and the difference
// separately, as the numpy twin (precond/ilu0.py:ilu0_factorize_numpy)
// does, so that both give the same bits.  A contracted FMA would not.

#include <cstdint>

extern "C" {

// Sequential IKJ ILU(0) on a CSR pattern with sorted rows.  vals (fp64) is
// overwritten with the combined L\U factor (unit-lower L stored without its
// ones); diag_pos receives each row's first position with column >= row.
// Pivots of rows 1..n-1 below boost_alpha in magnitude are clamped to
// +/-boost_alpha (row 0 is not boosted, as in the reference).  Returns 0,
// or -(i+1) when row i stores no entry with column >= i.
int ilu_host_factorize(int64_t n, const int64_t* row_ptr, const int64_t* col_idx,
                       double* vals, int64_t* diag_pos, double boost_alpha) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t lo = row_ptr[i], hi = row_ptr[i + 1];
    while (lo < hi) {  // rows are sorted: the first column >= i
      const int64_t mid = lo + (hi - lo) / 2;
      if (col_idx[mid] < i) lo = mid + 1; else hi = mid;
    }
    if (lo >= row_ptr[i + 1]) return (int)(-(i + 1));
    diag_pos[i] = lo;
  }
  for (int64_t i = 1; i < n; ++i) {
    const int64_t row_end = row_ptr[i + 1];
    for (int64_t k_ind = row_ptr[i]; col_idx[k_ind] < i; ++k_ind) {
      const int64_t k = col_idx[k_ind];
      const double factor = vals[k_ind] / vals[diag_pos[k]];
      vals[k_ind] = factor;
      int64_t prev_ind = diag_pos[k] + 1;
      const int64_t prev_end = row_ptr[k + 1];
      int64_t j_ind = k_ind + 1;
      while (j_ind < row_end && prev_ind < prev_end) {
        const int64_t cp = col_idx[prev_ind], cj = col_idx[j_ind];
        if (cp < cj) {
          ++prev_ind;
        } else if (cp > cj) {
          ++j_ind;
        } else {
          vals[j_ind] -= factor * vals[prev_ind];
          ++prev_ind;
          ++j_ind;
        }
      }
    }
    double& dv = vals[diag_pos[i]];
    if (dv >= 0) {
      if (dv < boost_alpha) dv = boost_alpha;
    } else {
      if (dv > -boost_alpha) dv = -boost_alpha;
    }
  }
  return 0;
}

// Per-row dependency levels of the strict-lower (lev_l) and strict-upper
// (lev_u) parts: level 0 rows depend on no row of their triangle, level k
// rows on a level k-1 row and nothing deeper.
void ilu_host_levels(int64_t n, const int64_t* row_ptr, const int64_t* col_idx,
                     const int64_t* diag_pos, int64_t* lev_l, int64_t* lev_u) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t lv = 0;
    for (int64_t j = row_ptr[i]; j < diag_pos[i]; ++j) {
      const int64_t d = lev_l[col_idx[j]] + 1;
      if (d > lv) lv = d;
    }
    lev_l[i] = lv;
  }
  for (int64_t i = n - 1; i >= 0; --i) {
    int64_t lv = 0;
    for (int64_t j = diag_pos[i] + 1; j < row_ptr[i + 1]; ++j) {
      const int64_t d = lev_u[col_idx[j]] + 1;
      if (d > lv) lv = d;
    }
    lev_u[i] = lv;
  }
}

// Per-row dependency levels of one strict triangle stored as DIA bands:
// row i depends on row i + offs[d] wherever nonzero[d * n + i] and that row
// lies in [0, n).  A lower triangle (every offset < 0) is walked forward, an
// upper one (every offset > 0) backward, so each dependency's level is known
// when its row is reached.  With seg > 0 only dependencies within a row's
// segment of seg rows count (the segmented solve's intra-segment levels).
// Returns the level count (max level + 1; 1 for no bands), or -1 when an
// offset has the wrong sign for the direction.
int64_t ilu_host_dia_levels(int64_t n, int64_t n_diags, const int64_t* offs,
                            const uint8_t* nonzero, int upper, int64_t seg, int64_t* lev) {
  for (int64_t d = 0; d < n_diags; ++d)
    if (upper ? offs[d] <= 0 : offs[d] >= 0) return -1;
  int64_t top = 0;
  for (int64_t t = 0; t < n; ++t) {
    const int64_t i = upper ? n - 1 - t : t;
    int64_t lv = 0;
    for (int64_t d = 0; d < n_diags; ++d) {
      const int64_t j = i + offs[d];
      if (j < 0 || j >= n || !nonzero[d * n + i] || (seg > 0 && j / seg != i / seg)) continue;
      if (lev[j] + 1 > lv) lv = lev[j] + 1;
    }
    lev[i] = lv;
    if (lv > top) top = lv;
  }
  return top + 1;
}

// Exact sequential substitution on the combined factor: unit-lower forward,
// then upper backward (the reference's ilusv).  x is in-out, fp64.
void ilu_host_trisolve(int64_t n, const int64_t* row_ptr, const int64_t* col_idx,
                       const double* vals, const int64_t* diag_pos, double* x) {
  for (int64_t i = 0; i < n; ++i) {
    double sum = x[i];
    for (int64_t j = row_ptr[i]; j < diag_pos[i]; ++j) sum -= vals[j] * x[col_idx[j]];
    x[i] = sum;
  }
  for (int64_t i = n - 1; i >= 0; --i) {
    double sum = x[i];
    for (int64_t j = diag_pos[i] + 1; j < row_ptr[i + 1]; ++j) sum -= vals[j] * x[col_idx[j]];
    x[i] = sum / vals[diag_pos[i]];
  }
}

}  // extern "C"
