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
//   K2 (redesigned) finishes its own sum in the same launch: see
//   basis_gram_kernel.
// - The GRAM pass of K3 reads the tile's rows a second time right after the
//   update pass; the tile (rows x kTile values, <= 248 KB) was just read, so
//   that second read is served by L1/L2 rather than device memory.
// - Sums are taken in the basis dtype: fp32 for the mixed inner loop, fp64
//   for the baseline (the TPU kernels were fp32-only; fp64 went to XLA).
#include <cstdint>

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

// K2, redesigned for Hopper: a persistent grid walks fixed column tiles of
// kGramTileCols columns (tile t -> block t mod grid), each thread covering
// gram_chunks 16-byte chunks of a tile; rows go kGramRows at a time, every
// row's 16-byte loads of a chunk issued before any is used, so a thread
// keeps kGramRows x 16 bytes in flight where one row at a time kept 16.
// The warp sums run once per group of rows, the block's sum once per row
// and tile.  Each tile writes its (rows,) partial; the last block to finish
// (a ticket counter after __threadfence, no atomics on the values) adds the
// tiles' partials in tile order and writes u, so a call is one launch and
// its bits depend on n and the alignment only, not on the grid.
//
// Alignment: a row starts 16-byte aligned only where n is a multiple of
// the vector width.  The aligned form keeps w's tile in registers; the
// general form stages w's tile in shared memory and splits each row's tile
// at its own phase a (the first column whose address is 16-byte aligned):
// a scalar head [0, a), vector chunks from a, and the chunk that crosses
// the tile's end (or n) in scalars.  orth_kernel.py:gram_plan and
// tile_row_split hold the same geometry for the CPU tests.
// 2048-column tiles (512 at n = 1M) and blocks of at most 64 registers a
// thread, so that 4 blocks (128 KB of loads in flight) fit on an SM
constexpr int kGramRows = 8;
constexpr int kGramTileCols = 2048;
constexpr int kGramBlocksPerSM = 4;

template <typename T>
__host__ __device__ constexpr int gram_vec() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int gram_tile() { return kGramTileCols; }
template <typename T>
__host__ __device__ constexpr int gram_chunks() { return kGramTileCols / (kThreads * gram_vec<T>()); }

template <typename T>
__device__ __forceinline__ void load16(const T* p, T (&v)[gram_vec<T>()]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
}

// Row j's tile partial of this thread over its chunks, the general form:
// w's tile in shared memory `ws`, the row split at its phase `a`
template <typename T>
__device__ __forceinline__ T gram_row_general(const T* __restrict__ vrow, const T* ws, int cols,
                                              int a) {
  constexpr int kVec = gram_vec<T>();
  T acc = T(0);
  if ((int)threadIdx.x < a && (int)threadIdx.x < cols)
    acc = fmadd(__ldg(vrow + threadIdx.x), ws[threadIdx.x], acc);
#pragma unroll
  for (int u = 0; u < gram_chunks<T>(); ++u) {
    const int cc = a + (u * kThreads + (int)threadIdx.x) * kVec;
    if (cc + kVec <= cols) {
      T v[kVec];
      load16(vrow + cc, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc = fmadd(v[e], ws[cc + e], acc);
    } else {
      for (int e = 0; e < kVec && cc + e < cols; ++e)
        acc = fmadd(__ldg(vrow + cc + e), ws[cc + e], acc);
    }
  }
  return acc;
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads, kGramBlocksPerSM)
basis_gram_kernel(const T* __restrict__ V, const T* __restrict__ w, T* __restrict__ u,
                  T* __restrict__ partials, unsigned* __restrict__ ticket, int n, int rows,
                  int m1, int n_tiles) {
  constexpr int kVec = gram_vec<T>();
  constexpr int kTileCols = gram_tile<T>();
  __shared__ T red[kWarps * kMaxRows];
  __shared__ T ws[kAligned ? 1 : kTileCols];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // element offset of V's first column from a 16-byte boundary
  const int v_phase = (int)((reinterpret_cast<uintptr_t>(V) / sizeof(T)) % kVec);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const size_t c0 = (size_t)t * kTileCols;
    const int cols = (int)min((size_t)kTileCols, (size_t)n - c0);
    T wv[gram_chunks<T>()][kVec];
    if constexpr (kAligned) {
#pragma unroll
      for (int q = 0; q < gram_chunks<T>(); ++q) {
        const int c = (q * kThreads + (int)threadIdx.x) * kVec;
        if (c < cols) {
          load16(w + c0 + c, wv[q]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) wv[q][e] = T(0);
        }
      }
    } else {
      for (int c = threadIdx.x; c < kTileCols; c += kThreads) ws[c] = c < cols ? w[c0 + c] : T(0);
      __syncthreads();
    }
    for (int g = 0; g < rows; g += kGramRows) {
      T acc[kGramRows];
#pragma unroll
      for (int r = 0; r < kGramRows; ++r) acc[r] = T(0);
      if constexpr (kAligned) {
#pragma unroll
        for (int q = 0; q < gram_chunks<T>(); ++q) {
          const int c = (q * kThreads + (int)threadIdx.x) * kVec;
          if (c >= cols) continue;
          T v[kGramRows][kVec];
#pragma unroll
          for (int r = 0; r < kGramRows; ++r) {
            if (g + r < rows) {
              load16(V + (size_t)(g + r) * n + c0 + c, v[r]);
            } else {
#pragma unroll
              for (int e = 0; e < kVec; ++e) v[r][e] = T(0);
            }
          }
#pragma unroll
          for (int r = 0; r < kGramRows; ++r)
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[r] = fmadd(v[r][e], wv[q][e], acc[r]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kGramRows; ++r) {
          if (g + r >= rows) continue;
          const size_t start = (size_t)(g + r) * n + c0;
          const int a = (int)((kVec - (int)((v_phase + start) % kVec)) % kVec);
          acc[r] = gram_row_general(V + start, ws, cols, a);
        }
      }
#pragma unroll
      for (int r = 0; r < kGramRows; ++r) {
        if (g + r >= rows) continue;
        const T s = warp_sum(acc[r]);
        if (lane == 0) red[warp * kMaxRows + g + r] = s;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += kThreads) {
      T s = T(0);
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q * kMaxRows + j];
      partials[(size_t)j * n_tiles + t] = s;
    }
    __syncthreads();
  }

  // the last block to finish sums the tiles' partials in tile order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // warp w sums rows w, w + 8, w + 16, w + 24 together (their loads in
  // flight at once); each lane takes tiles lane, lane + 32, ... in order
  constexpr int kSumRows = 4;
  for (int j0 = warp; j0 < m1; j0 += kSumRows * kWarps) {
    T s[kSumRows];
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) s[r] = T(0);
#pragma unroll 4
    for (int t = lane; t < n_tiles; t += 32) {
#pragma unroll
      for (int r = 0; r < kSumRows; ++r) {
        const int j = j0 + r * kWarps;
        if (j < rows) s[r] += __ldcg(partials + (size_t)j * n_tiles + t);
      }
    }
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) {
      const int j = j0 + r * kWarps;  // the same in every lane
      if (j >= m1) continue;
      const T v = j < rows ? warp_sum(s[r]) : T(0);
      if (lane == 0) u[j] = v;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
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
static int launch_gram(const T* V, const T* w, T* u, T* partials, unsigned* ticket, int n,
                       int rows, int m1, int tile, int n_tiles, int grid, void* stream) {
  if (bad_shape(n, rows, m1) || tile != gram_tile<T>() ||
      n_tiles != blocks_for(n, gram_tile<T>()) || grid < 1)
    return (int)cudaErrorInvalidValue;
  const bool aligned = n % gram_vec<T>() == 0 && reinterpret_cast<uintptr_t>(V) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kernel = aligned ? basis_gram_kernel<T, true> : basis_gram_kernel<T, false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(V, w, u, partials, ticket, n, rows, m1,
                                                      n_tiles);
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

// K2: u (m1,) from V and w in one launch; partials (rows, n_tiles) scratch,
// ticket one zeroed counter that the kernel leaves zeroed
int gmres_basis_gram_f32(const float* V, const float* w, float* u, float* partials,
                         unsigned* ticket, int n, int rows, int m1, int tile, int n_tiles,
                         int grid, void* stream) {
  return launch_gram<float>(V, w, u, partials, ticket, n, rows, m1, tile, n_tiles, grid, stream);
}

int gmres_basis_gram_f64(const double* V, const double* w, double* u, double* partials,
                         unsigned* ticket, int n, int rows, int m1, int tile, int n_tiles,
                         int grid, void* stream) {
  return launch_gram<double>(V, w, u, partials, ticket, n, rows, m1, tile, n_tiles, grid,
                             stream);
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
