// K2-K4 and K2x2: sweeps over the row-stored Krylov basis V (m+1, n).
//
// K2 basis_gram<TV>            u[j] = sum_i V[j,i] w[i]            for j < rows
//   replaces gmres_tpu/ops/pallas/orth_kernel.py:_gram (pallas_call at :59).
// K3 basis_update<TV,SUMSQ>    w' = w - sum_j u[j] V[j,:], fused with
//   ||w'||^2 (SUMSQ) over the same tile
//   replaces orth_kernel.py:_update_sumsq (:216); with the flag off it is
//   _update (:129), exported as basis_update (CGS passes of CGSR with
//   orth_steps != 2).
// K3 GRAM basis_update_gram<TV>  w' = w - sum_j u[j] V[j,:] and u2 = V w'
//   replaces orth_kernel.py:_update_gram (:171, kernel body :144-163).  In
//   fp32 each tile of the basis is staged in shared memory once and both
//   passes read it there, in one launch (basis_update_gram_kernel); in fp64
//   the one-row-at-a-time arithmetic, its rows loaded a batch at a time and
//   its re-read served by L2 (basis_update_gram_blocks_kernel).  gram,
//   update_gram and update_sumsq chained are one CGSR step
//   (orth_kernel.py:cgsr2_pallas).
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
//   K2 and K3 GRAM (both redesigned) finish their own sums in the same
//   launch: see basis_gram_kernel and basis_update_gram_kernel.
// - Sums are taken in the basis dtype: fp32 for the mixed inner loop, fp64
//   for the baseline (the TPU kernels were fp32-only; fp64 went to XLA).
#include <cstdint>

#include "common.cuh"

using namespace gmres;

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

template <typename T, bool SUMSQ>
__global__ void __launch_bounds__(kThreads)
basis_update_kernel(const T* __restrict__ V, const T* __restrict__ w,
                    const T* __restrict__ u, T* __restrict__ w_out,
                    T* __restrict__ partials, int n, int rows, int m1) {
  __shared__ T us[kMaxRows];
  __shared__ T red[kWarps];
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
  // nothing to the sum below

  if constexpr (SUMSQ) {
    T p = T(0);
#pragma unroll
    for (int it = 0; it < kItems; ++it) p += wv[it] * wv[it];
    p = block_sum(p, red);
    if (threadIdx.x == 0) partials[blockIdx.x] = p;
  }
}

// K3 GRAM in fp32, redesigned for Hopper: the update pass and the GRAM pass
// both read the basis tile from shared memory, so V leaves device memory
// once.
// A persistent grid walks fixed column tiles of ug_tile<T>(rows) columns
// (tile t -> block t mod grid).  A block stages all `rows` rows of a tile
// and w's tile into shared memory with asynchronous copies (where every
// row starts 16-byte aligned, one bulk copy (TMA) a row, issued by one
// thread and completing on the stage's mbarrier; else one cp.async a
// value), all of them in flight at once, in a ring of two stages: the next
// tile's copies are issued before the current tile is computed, so a tile
// is always in flight while the block computes.  Then
// - the update pass: thread t owns 16-byte chunks t, t + kThreads, ... of
//   the tile; per column the combination is summed over j in ascending
//   order with one fmadd a row, starting from 0, and subtracted from w once
//   (the reference's order, orth_kernel.py:_update_kernel), so w' has the
//   bits of the one-row-at-a-time form it replaces; w' is written to device
//   memory and over w's tile in the stage;
// - the GRAM pass: warp q takes rows q, q + kWarps, ... (kUgRows of them at
//   once, sharing each 16-byte read of w'), its lanes the tile's chunks in
//   turn; each row's tile partial goes to partials[j * stride + t].
// The tile width is the widest run of whole 128-byte lines whose two stages
// ((rows + 1) rows of the tile each) and u fit kUgSmemBudget, at every rows
// in 1..kMaxRows, and at most kUgMaxRowBytes a row; the grid holds up to
// kUgBlocksPerSM blocks an SM, as many as the stages leave room for.  The
// last block to finish (K2's ticket) adds each row's tile partials, 16
// bytes a lane, in a fixed order, so a call is one launch and its bits
// depend on n, rows, the dtype and the alignment, not on the grid.
// orth_kernel.py:update_gram_plan holds the same geometry for the CPU tests.
constexpr int kUgSmemBudget = 230400;   // dynamic bytes: 225 KB of a block's 227
constexpr int kUgLine = 128;
constexpr int kUgMaxRowBytes = 8192;
constexpr int kUgBlocksPerSM = 2;
constexpr int kUgRows = 4;

template <typename T>
__host__ __device__ constexpr int ug_vec() { return 16 / (int)sizeof(T); }
// u's slots in the stage, a whole number of 16-byte chunks
template <typename T>
__host__ __device__ inline int ug_u_slots(int rows) {
  return (rows + ug_vec<T>() - 1) / ug_vec<T>() * ug_vec<T>();
}
template <typename T>
inline int ug_tile(int rows) {
  const int line = kUgLine / (int)sizeof(T);
  const int fit =
      (kUgSmemBudget / (int)sizeof(T) - ug_u_slots<T>(rows)) / (2 * (rows + 1)) / line * line;
  const int cap = kUgMaxRowBytes / (int)sizeof(T);
  return fit < cap ? fit : cap;
}
template <typename T>
inline size_t ug_smem(int rows, int tile) {
  return ((size_t)2 * (rows + 1) * tile + ug_u_slots<T>(rows)) * sizeof(T);
}

// 16 bytes of shared memory (16-byte aligned) into and out of registers
template <typename T>
__device__ __forceinline__ void lds16(const T* p, T (&v)[gram_vec<T>()]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}
template <typename T>
__device__ __forceinline__ void st16(T* p, const T (&v)[gram_vec<T>()]) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
// a[0] + ... + a[K-1] as a balanced tree
template <typename T, int K>
__device__ __forceinline__ T pairwise(const T* a) {
  if constexpr (K == 1)
    return a[0];
  else
    return pairwise<T, K / 2>(a) + pairwise<T, K / 2>(a + K / 2);
}

template <typename T>
__device__ __forceinline__ void ldcg16(const T* p, T (&v)[gram_vec<T>()]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 q = __ldcg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
}

// tile t's rows 0..rows-1 of V and w's tile (as row `rows`) into `vs`:
// aligned, one bulk copy a row issued by thread 0 on `bar`; else one
// cp.async a value, by every thread
template <typename T, bool kAligned>
__device__ __forceinline__ void stage_tile(T* vs, const T* __restrict__ V,
                                           const T* __restrict__ w, int t, int n, int rows,
                                           int tile, unsigned long long* bar) {
  const size_t c0 = (size_t)t * tile;
  const int cols = (int)min((size_t)tile, (size_t)n - c0);
  if constexpr (kAligned) {
    if (threadIdx.x != 0) return;
    const unsigned bytes = (unsigned)(cols * sizeof(T));  // whole 16-byte chunks here
    mbar_expect(bar, (rows + 1) * bytes);
    for (int j = 0; j <= rows; ++j)
      bulk_copy(vs + (size_t)j * tile, (j < rows ? V + (size_t)j * n : w) + c0, bytes, bar);
  } else {
    for (int j = 0; j <= rows; ++j) {
      const T* src = (j < rows ? V + (size_t)j * n : w) + c0;
      for (int k = threadIdx.x; k < cols; k += kThreads)
        cp_async(vs + (size_t)j * tile + k, src + k);
    }
  }
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads, kUgBlocksPerSM)
basis_update_gram_kernel(const T* __restrict__ V, const T* __restrict__ w,
                         const T* __restrict__ u, T* __restrict__ w_out, T* __restrict__ u2,
                         T* __restrict__ partials, unsigned* __restrict__ ticket, int n,
                         int rows, int m1, int tile, int n_tiles, int stride) {
  constexpr int kVec = ug_vec<T>();
  extern __shared__ __align__(16) unsigned char ug_smem_raw[];
  T* us = reinterpret_cast<T*>(ug_smem_raw);
  const size_t stage = (size_t)(rows + 1) * tile;
  T* const ring = us + ug_u_slots<T>(rows);  // stage s at ring + s * stage
  __shared__ bool last;
  __shared__ __align__(8) unsigned long long bars[2];  // the stages' mbarriers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < rows; j += kThreads) us[j] = u[j];
  if (kAligned && threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    fence_proxy_async();
  }
  __syncthreads();

  if ((int)blockIdx.x < n_tiles)
    stage_tile<T, kAligned>(ring, V, w, blockIdx.x, n, rows, tile, &bars[0]);
  if (!kAligned) cp_async_commit();
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    // the next tile into the other stage (free since the last barrier),
    // then wait for this one (its stage's (it / 2)-th fill)
    if (t + (int)gridDim.x < n_tiles)
      stage_tile<T, kAligned>(ring + ((it + 1) & 1) * stage, V, w, t + gridDim.x, n, rows,
                              tile, &bars[(it + 1) & 1]);
    if constexpr (kAligned) {
      mbar_wait(&bars[it & 1], (it >> 1) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    T* vs = ring + (it & 1) * stage;  // row j of the tile at j * tile
    T* ws = vs + (size_t)rows * tile;  // w's tile, then w''s
    const size_t c0 = (size_t)t * tile;
    const int cols = (int)min((size_t)tile, (size_t)n - c0);

    // update pass; a chunk that crosses `cols` (general form only) computes
    // on stale slots past it and stores only its live columns
    for (int c = threadIdx.x * kVec; c < cols; c += kThreads * kVec) {
      T acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = T(0);
      for (int j = 0; j < rows; ++j) {
        const T uj = us[j];
        T v[kVec];
        lds16(vs + (size_t)j * tile + c, v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmadd(uj, v[e], acc[e]);
      }
      T wv[kVec];
      lds16(ws + c, wv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) wv[e] -= acc[e];
      st16(ws + c, wv);
      if constexpr (kAligned) {
        st16(w_out + c0 + c, wv);
      } else {
        for (int e = 0; e < kVec && c + e < cols; ++e) w_out[c0 + c + e] = wv[e];
      }
    }
    __syncthreads();

    // GRAM pass over whole chunks, then the columns of a chunk that
    // crosses `cols` one by one; a lane keeps one sum per element of a
    // chunk and adds them pairwise, so no sum runs longer than the tile's
    // chunks a lane takes
    const int full = cols / kVec * kVec;
    for (int j0 = warp; j0 < rows; j0 += kWarps * kUgRows) {
      T p[kUgRows][kVec];
#pragma unroll
      for (int r = 0; r < kUgRows; ++r)
#pragma unroll
        for (int e = 0; e < kVec; ++e) p[r][e] = T(0);
      for (int c = lane * kVec; c < full; c += 32 * kVec) {
        T wv[kVec];
        lds16(ws + c, wv);
#pragma unroll
        for (int r = 0; r < kUgRows; ++r) {
          const int j = j0 + r * kWarps;
          if (j >= rows) continue;
          T v[kVec];
          lds16(vs + (size_t)j * tile + c, v);
#pragma unroll
          for (int e = 0; e < kVec; ++e) p[r][e] = fmadd(v[e], wv[e], p[r][e]);
        }
      }
      for (int c = full + lane; c < cols; c += 32) {
#pragma unroll
        for (int r = 0; r < kUgRows; ++r) {
          const int j = j0 + r * kWarps;
          if (j < rows) p[r][0] = fmadd(vs[(size_t)j * tile + c], ws[c], p[r][0]);
        }
      }
#pragma unroll
      for (int r = 0; r < kUgRows; ++r) {
        const int j = j0 + r * kWarps;  // the same in every lane
        if (j >= rows) continue;
        const T s = warp_sum(pairwise<T, kVec>(p[r]));
        if (lane == 0) partials[(size_t)j * stride + t] = s;
      }
    }
    if (kAligned) fence_proxy_async();
    __syncthreads();  // this stage is refilled by the tile after next
  }

  // the last block to finish adds each row's tile partials: warp q takes
  // rows q, q + kWarps, ... (kUgRows at once), lane l the 16-byte chunks
  // l, l + 32, ... of the row into two sets of sums (even and odd turns),
  // then the tiles past the last whole chunk; each lane's sums pairwise,
  // then a warp tree
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int full = n_tiles / kVec * kVec;
  for (int j0 = warp; j0 < m1; j0 += kWarps * kUgRows) {
    T s[kUgRows][2 * kVec];
#pragma unroll
    for (int r = 0; r < kUgRows; ++r)
#pragma unroll
      for (int e = 0; e < 2 * kVec; ++e) s[r][e] = T(0);
    for (int k = lane * kVec; k < full; k += 64 * kVec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = k + h * 32 * kVec;
        if (kk >= full) continue;
#pragma unroll
        for (int r = 0; r < kUgRows; ++r) {
          const int j = j0 + r * kWarps;
          if (j >= rows) continue;
          T v[kVec];
          ldcg16(partials + (size_t)j * stride + kk, v);
#pragma unroll
          for (int e = 0; e < kVec; ++e) s[r][h * kVec + e] += v[e];
        }
      }
    }
    for (int k = full + lane; k < n_tiles; k += 32) {
#pragma unroll
      for (int r = 0; r < kUgRows; ++r) {
        const int j = j0 + r * kWarps;
        if (j < rows) s[r][0] += __ldcg(partials + (size_t)j * stride + k);
      }
    }
#pragma unroll
    for (int r = 0; r < kUgRows; ++r) {
      const int j = j0 + r * kWarps;
      if (j >= m1) continue;
      const T v = j < rows ? warp_sum(pairwise<T, 2 * kVec>(s[r])) : T(0);
      if (lane == 0) u2[j] = v;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// K3 GRAM in fp64: the arithmetic of the one-row-at-a-time kernel it
// replaces, so w' and u2 keep their bits.  (The fp32 kernel's summation of
// u2 moved the ILU-Jacobi(3) baseline count at convdiff@1M by up to 9
// restarts between K2 and its plain twin; with these bits the two agree,
// PERF.md, section 6.)  A block owns kTile columns, thread t the kItems columns
// t + i * kThreads;
// w' is the combination summed from 0 with one fmadd a row, subtracted
// once; a row's block partial is the thread's items in order, a warp tree
// and the warps in order, and the wrapper adds the (n_blocks, m1) partials
// with torch.sum.  What changed is the loads: kUgBatch rows are loaded
// before any is used, in both passes, and `pad` bytes of dynamic shared
// memory cap the blocks an SM, so that the tiles the GRAM pass reads again
// are still in L2.
constexpr int kUgBatch = 8;
constexpr int kUgPadMax = 200 * 1024;  // with its 18 KB of static shared memory, < 227 KB

template <typename T>
__global__ void __launch_bounds__(kThreads)
basis_update_gram_blocks_kernel(const T* __restrict__ V, const T* __restrict__ w,
                                const T* __restrict__ u, T* __restrict__ w_out,
                                T* __restrict__ partials, int n, int rows, int m1) {
  __shared__ T us[kMaxRows];
  __shared__ T red[kWarps * kMaxRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < rows; j += kThreads) us[j] = u[j];
  __syncthreads();

  const size_t col0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  T wv[kItems], acc[kItems];
  load_tile(w, col0, n, wv);
#pragma unroll
  for (int it = 0; it < kItems; ++it) acc[it] = T(0);
  for (int j0 = 0; j0 < rows; j0 += kUgBatch) {
    T rv[kUgBatch][kItems];
#pragma unroll
    for (int r = 0; r < kUgBatch; ++r)
      if (j0 + r < rows) load_tile(V + (size_t)(j0 + r) * n, col0, n, rv[r]);
#pragma unroll
    for (int r = 0; r < kUgBatch; ++r) {
      if (j0 + r >= rows) continue;
      const T uj = us[j0 + r];
#pragma unroll
      for (int it = 0; it < kItems; ++it) acc[it] += uj * rv[r][it];
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    wv[it] -= acc[it];
    const size_t c = col0 + (size_t)it * kThreads;
    if (c < (size_t)n) w_out[c] = wv[it];
  }
  // out-of-range columns hold w = 0 and acc = 0, so wv is 0 there and adds
  // nothing to the sums below
  for (int j0 = 0; j0 < rows; j0 += kUgBatch) {
    T rv[kUgBatch][kItems];
#pragma unroll
    for (int r = 0; r < kUgBatch; ++r)
      if (j0 + r < rows) load_tile(V + (size_t)(j0 + r) * n, col0, n, rv[r]);
#pragma unroll
    for (int r = 0; r < kUgBatch; ++r) {
      if (j0 + r >= rows) continue;
      T p = T(0);
#pragma unroll
      for (int it = 0; it < kItems; ++it) p += rv[r][it] * wv[it];
      p = warp_sum(p);
      if (lane == 0) red[warp * kMaxRows + j0 + r] = p;
    }
  }
  __syncthreads();
  // rows rows..m1-1 get a zero partial: torch.sum over the blocks yields the
  // full (m1,) vector with its zero tail
  for (int j = threadIdx.x; j < m1; j += kThreads) {
    T s = T(0);
    if (j < rows) {
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q * kMaxRows + j];
    }
    partials[(size_t)blockIdx.x * m1 + j] = s;
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

template <typename T, bool SUMSQ>
static int launch_update(const T* V, const T* w, const T* u, T* w_out, T* partials,
                         int n, int rows, int m1, void* stream) {
  if (bad_shape(n, rows, m1)) return (int)cudaErrorInvalidValue;
  basis_update_kernel<T, SUMSQ>
      <<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
          V, w, u, w_out, partials, n, rows, m1);
  return (int)cudaGetLastError();
}

// K3 GRAM's stages are dynamic shared memory above the 48 KB default, with
// the largest shared-memory carveout; set once a device for each form
template <typename T, bool kAligned>
static cudaError_t allow_ug_stages() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  const void* kernel = (const void*)basis_update_gram_kernel<T, kAligned>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kUgSmemBudget);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T>
static int launch_update_gram(const T* V, const T* w, const T* u, T* w_out, T* u2, T* partials,
                              unsigned* ticket, int n, int rows, int m1, int tile, int n_tiles,
                              int stride, int grid, int smem, void* stream) {
  if (bad_shape(n, rows, m1) || tile != ug_tile<T>(rows) || n_tiles != blocks_for(n, tile) ||
      stride != blocks_for(n_tiles, ug_vec<T>()) * ug_vec<T>() ||
      (size_t)smem != ug_smem<T>(rows, tile) || grid < 1 || grid > n_tiles)
    return (int)cudaErrorInvalidValue;
  const bool aligned = n % ug_vec<T>() == 0 && reinterpret_cast<uintptr_t>(V) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w_out) % 16 == 0;
  auto kernel = aligned ? basis_update_gram_kernel<T, true> : basis_update_gram_kernel<T, false>;
  const cudaError_t err = aligned ? allow_ug_stages<T, true>() : allow_ug_stages<T, false>();
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(V, w, u, w_out, u2, partials, ticket, n,
                                                         rows, m1, tile, n_tiles, stride);
  return (int)cudaGetLastError();
}

static int launch_update_gram_blocks(const double* V, const double* w, const double* u,
                                     double* w_out, double* partials, int n, int rows, int m1,
                                     int pad, void* stream) {
  if (bad_shape(n, rows, m1) || pad < 0 || pad > kUgPadMax) return (int)cudaErrorInvalidValue;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(dev < 64 && done[dev])) {
    err = cudaFuncSetAttribute((const void*)basis_update_gram_blocks_kernel<double>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kUgPadMax);
    if (err == cudaSuccess && dev < 64) done[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  basis_update_gram_blocks_kernel<double>
      <<<blocks_for(n, kTile), kThreads, pad, (cudaStream_t)stream>>>(V, w, u, w_out, partials, n,
                                                                      rows, m1);
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

// K3 with the flag off: w' = w - u^T V alone (orth_kernel.py:_update)
int gmres_basis_update_f32(const float* V, const float* w, const float* u, float* w_out,
                           int n, int rows, int m1, void* stream) {
  return launch_update<float, false>(V, w, u, w_out, nullptr, n, rows, m1, stream);
}

int gmres_basis_update_f64(const double* V, const double* w, const double* u,
                           double* w_out, int n, int rows, int m1, void* stream) {
  return launch_update<double, false>(V, w, u, w_out, nullptr, n, rows, m1, stream);
}

// K3 GRAM: w_out and u2 (m1,) in one launch over the plan of
// orth_kernel.py:update_gram_plan (tile, n_tiles, partials' row stride,
// grid, dynamic shared bytes; checked here); partials (rows, stride)
// scratch, ticket K2's zeroed counter, left zeroed
int gmres_basis_update_gram_f32(const float* V, const float* w, const float* u, float* w_out,
                                float* u2, float* partials, unsigned* ticket, int n, int rows,
                                int m1, int tile, int n_tiles, int stride, int grid, int smem,
                                void* stream) {
  return launch_update_gram<float>(V, w, u, w_out, u2, partials, ticket, n, rows, m1, tile,
                                   n_tiles, stride, grid, smem, stream);
}

// K3 GRAM in fp64: w_out and the (n_blocks, m1) block partials that the
// wrapper adds; pad: dynamic shared bytes that cap the blocks an SM
int gmres_basis_update_gram_f64(const double* V, const double* w, const double* u,
                                double* w_out, double* partials, int n, int rows, int m1,
                                int pad, void* stream) {
  return launch_update_gram_blocks(V, w, u, w_out, partials, n, rows, m1, pad, stream);
}

int gmres_basis_update_sumsq_f32(const float* V, const float* w, const float* u,
                                 float* w_out, float* partials, int n, int rows,
                                 int m1, void* stream) {
  return launch_update<float, true>(V, w, u, w_out, partials, n, rows, m1,
                                           stream);
}

int gmres_basis_update_sumsq_f64(const double* V, const double* w, const double* u,
                                 double* w_out, double* partials, int n, int rows,
                                 int m1, void* stream) {
  return launch_update<double, true>(V, w, u, w_out, partials, n, rows, m1,
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
