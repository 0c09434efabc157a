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
// What the design does about it (K9, K11): K2/K3's structure.
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
//
// K10, redesigned for Hopper (df_update_gram_kernel), on the design of K3
// GRAM in fp32 (basis_sweep.cu: basis_update_gram_kernel): the pair basis
// doubles a tile's bytes, and its chains (~40 fp32 instructions a (row,
// column) over both passes, ~41% of the bytes bound at 33.5 T/s) have to
// run under the copies, not after them.
// - A persistent grid walks tiles of whole 128-byte lines (tile t -> block
//   t mod grid).  Each tile's 2 rows basis rows (Vh, then Vl) and w's pair
//   are staged in shared memory once, by bulk copies (TMA) on an mbarrier
//   where the rows are 16-byte aligned, else by cp.async, in a ring of two
//   stages: the next tile's copies are in flight while the block computes
//   on this one.  The stages and u fit kDfSmemBudget at every rows 1..256.
// - Both passes read the stage.  The update pass: thread t owns columns t,
//   t + kThreads, ... of the tile, two chains at a time (every thread busy
//   at a tile of 448 columns, where 16-byte chunks would leave half idle);
//   per column c is summed over j
//   in ascending order from a zero pair with df_mul and df_add and w' = w +
//   (-c), the chain of the kernel it replaces, so w' keeps its bits; w' goes
//   to device memory and over w's pair in the stage.  The GRAM pass: warp q
//   takes rows q, q + kWarps, ... (kDfRows of them at once, sharing each
//   read of w'), its lanes the tile's chunks in turn, a pair sum per element
//   of a chunk, added pairwise, then a warp tree; each row's tile partial is
//   merged to fp64 into partials[j * n_tiles + t].
// - The last block to finish (K2's ticket) adds each row's tile partials in
//   fp64 in tile order (lane l tiles l, l + 32, ..., then a warp tree) and
//   writes u2, so a call is one device kernel and its bits depend on n,
//   rows, the tile and the alignment, not on the grid.
// df64_orth_kernel.py:df_update_gram_plan holds the same geometry for the
// CPU tests.
#include <cstdint>

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

// K11: w' and the block's pair sum of squares of w', merged to fp64
__global__ void __launch_bounds__(kThreads)
df_update_sumsq_kernel(const float* __restrict__ Vh, const float* __restrict__ Vl,
                       const float* __restrict__ wh, const float* __restrict__ wl,
                       const double* __restrict__ u, float* __restrict__ woh,
                       float* __restrict__ wol, double* __restrict__ partials, int n, int rows) {
  __shared__ float us[2][kMaxRows];
  __shared__ float red[2][kWarps];
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

// K10's stages (df64_orth_kernel.py: DF_SMEM_BUDGET, DF_LINE, DF_MAX_TILE,
// DF_BLOCKS_PER_SM): dynamic bytes of a block's two stages and u (225 KB of
// the 227 a block may have); tiles of whole 128-byte lines, at most 8 KB a
// row
constexpr int kDfSmemBudget = 230400;
constexpr int kDfLine = 32;  // floats in a 128-byte line
constexpr int kDfMaxTile = 2048;
constexpr int kDfBlocksPerSM = 2;
constexpr int kDfRows = 4;

// u's hi (and lo) slots, a whole number of 16-byte chunks
__host__ __device__ inline int df_u_slots(int rows) { return (rows + 3) / 4 * 4; }
inline size_t df_smem(int rows, int tile) {
  return ((size_t)2 * (2 * rows + 2) * tile + 2 * df_u_slots(rows)) * sizeof(float);
}

__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// tile t's rows 0..rows-1 of Vh (stage rows 0..rows-1) and of Vl (rows
// rows..2 rows-1), and w's pair (rows 2 rows, 2 rows + 1) into `vs`:
// aligned, one bulk copy a row, issued by the lanes of warp 0 after lane 0
// set the fill's bytes on `bar`; else one cp.async a value, by every thread
template <bool kAligned>
__device__ __forceinline__ void stage_pair_tile(float* vs, const float* __restrict__ Vh,
                                                const float* __restrict__ Vl,
                                                const float* __restrict__ wh,
                                                const float* __restrict__ wl, int t, int n,
                                                int rows, int tile, unsigned long long* bar) {
  const size_t c0 = (size_t)t * tile;
  const int cols = (int)min((size_t)tile, (size_t)n - c0);
  const int n_rows = 2 * rows + 2;
  auto src = [&](int j) {
    return (j < rows       ? Vh + (size_t)j * n
            : j < 2 * rows ? Vl + (size_t)(j - rows) * n
            : j == 2 * rows ? wh
                            : wl) + c0;
  };
  if constexpr (kAligned) {
    if (threadIdx.x >= 32) return;
    const unsigned bytes = (unsigned)(cols * sizeof(float));  // whole 16-byte chunks here
    if (threadIdx.x == 0) mbar_expect(bar, n_rows * bytes);
    __syncwarp();
    for (int j = threadIdx.x; j < n_rows; j += 32)
      bulk_copy(vs + (size_t)j * tile, src(j), bytes, bar);
  } else {
    for (int j = 0; j < n_rows; ++j) {
      const float* p = src(j);
      for (int k = threadIdx.x; k < cols; k += kThreads) cp_async(vs + (size_t)j * tile + k, p + k);
    }
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, kDfBlocksPerSM)
df_update_gram_kernel(const float* __restrict__ Vh, const float* __restrict__ Vl,
                      const float* __restrict__ wh, const float* __restrict__ wl,
                      const double* __restrict__ u, float* __restrict__ woh,
                      float* __restrict__ wol, double* __restrict__ u2,
                      double* __restrict__ partials, unsigned* __restrict__ ticket, int n,
                      int rows, int m1, int tile, int n_tiles) {
  extern __shared__ __align__(16) unsigned char df_smem_raw[];
  float* us = reinterpret_cast<float*>(df_smem_raw);  // u's hi at us[j], lo at us[slots + j]
  const int slots = df_u_slots(rows);
  const size_t stage = (size_t)(2 * rows + 2) * tile;
  float* const ring = us + 2 * slots;  // stage s at ring + s * stage
  __shared__ bool last;
  __shared__ __align__(8) unsigned long long bars[2];  // the stages' mbarriers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < rows; j += kThreads) split_f64(u[j], us[j], us[slots + j]);
  if (kAligned && threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    fence_proxy_async();
  }
  __syncthreads();

  if ((int)blockIdx.x < n_tiles)
    stage_pair_tile<kAligned>(ring, Vh, Vl, wh, wl, blockIdx.x, n, rows, tile, &bars[0]);
  if (!kAligned) cp_async_commit();
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    // the next tile into the other stage (free since the last barrier),
    // then wait for this one (its stage's (it / 2)-th fill)
    if (t + (int)gridDim.x < n_tiles)
      stage_pair_tile<kAligned>(ring + ((it + 1) & 1) * stage, Vh, Vl, wh, wl, t + gridDim.x,
                                n, rows, tile, &bars[(it + 1) & 1]);
    if constexpr (kAligned) {
      mbar_wait(&bars[it & 1], (it >> 1) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    float* vs = ring + (it & 1) * stage;  // Vh row j at j * tile, Vl row j at (rows + j) * tile
    float* wsh = vs + (size_t)2 * rows * tile;  // w's pair, then w''s
    float* wsl = wsh + tile;
    const size_t c0 = (size_t)t * tile;
    const int cols = (int)min((size_t)tile, (size_t)n - c0);

    // update pass: thread t owns columns t, t + kThreads, ... of the tile,
    // two at a time (their chains interleaved; a second column past `cols`
    // repeats the first and is not stored)
    for (int c = threadIdx.x; c < cols; c += 2 * kThreads) {
      const bool two = c + kThreads < cols;
      const int cc[2] = {c, two ? c + kThreads : c};
      float ch[2] = {0.f, 0.f}, cl[2] = {0.f, 0.f};
      for (int j = 0; j < rows; ++j) {
        const float uh = us[j], ul = us[slots + j];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float ph, pl;
          df_mul(vs[(size_t)j * tile + cc[q]], vs[(size_t)(rows + j) * tile + cc[q]], uh, ul,
                 ph, pl);
          df_add(ch[q], cl[q], ph, pl, ch[q], cl[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 1 && !two) continue;
        float ah = wsh[cc[q]], al = wsl[cc[q]];
        df_add(ah, al, -ch[q], -cl[q], ah, al);
        wsh[cc[q]] = ah;
        wsl[cc[q]] = al;
        woh[c0 + cc[q]] = ah;
        wol[c0 + cc[q]] = al;
      }
    }
    __syncthreads();

    // GRAM pass over whole chunks, then the columns of a chunk that crosses
    // `cols` one by one
    const int full = cols / 4 * 4;
    for (int j0 = warp; j0 < rows; j0 += kWarps * kDfRows) {
      float ph[kDfRows][4], pl[kDfRows][4];
#pragma unroll
      for (int q = 0; q < kDfRows; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) ph[q][e] = pl[q][e] = 0.f;
      for (int c = lane * 4; c < full; c += 32 * 4) {
        float ah[4], al[4];
        lds4(wsh + c, ah);
        lds4(wsl + c, al);
#pragma unroll
        for (int q = 0; q < kDfRows; ++q) {
          const int j = j0 + q * kWarps;
          if (j >= rows) continue;
          float vh[4], vl[4];
          lds4(vs + (size_t)j * tile + c, vh);
          lds4(vs + (size_t)(rows + j) * tile + c, vl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float qh, ql;
            df_mul(vh[e], vl[e], ah[e], al[e], qh, ql);
            df_add(ph[q][e], pl[q][e], qh, ql, ph[q][e], pl[q][e]);
          }
        }
      }
      for (int c = full + lane; c < cols; c += 32) {
#pragma unroll
        for (int q = 0; q < kDfRows; ++q) {
          const int j = j0 + q * kWarps;
          if (j >= rows) continue;
          float qh, ql;
          df_mul(vs[(size_t)j * tile + c], vs[(size_t)(rows + j) * tile + c], wsh[c], wsl[c],
                 qh, ql);
          df_add(ph[q][0], pl[q][0], qh, ql, ph[q][0], pl[q][0]);
        }
      }
#pragma unroll
      for (int q = 0; q < kDfRows; ++q) {
        const int j = j0 + q * kWarps;  // the same in every lane
        if (j >= rows) continue;
        float h01, l01, h23, l23, h, l;
        df_add(ph[q][0], pl[q][0], ph[q][1], pl[q][1], h01, l01);
        df_add(ph[q][2], pl[q][2], ph[q][3], pl[q][3], h23, l23);
        df_add(h01, l01, h23, l23, h, l);
        warp_df_sum(h, l);
        if (lane == 0) partials[(size_t)j * n_tiles + t] = merge_f64(h, l);
      }
    }
    if (kAligned) fence_proxy_async();
    __syncthreads();  // this stage is refilled by the tile after next
  }

  // the last block to finish adds each row's tile partials in fp64: warp q
  // takes rows q, q + kWarps, ... (kDfRows at once), lane l tiles l, l + 32,
  // ... in order, then a warp tree
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j0 = warp; j0 < m1; j0 += kWarps * kDfRows) {
    double acc[kDfRows];
#pragma unroll
    for (int q = 0; q < kDfRows; ++q) acc[q] = 0.0;
    for (int k = lane; k < n_tiles; k += 32) {
#pragma unroll
      for (int q = 0; q < kDfRows; ++q) {
        const int j = j0 + q * kWarps;
        if (j < rows) acc[q] += __ldcg(partials + (size_t)j * n_tiles + k);
      }
    }
#pragma unroll
    for (int q = 0; q < kDfRows; ++q) {
      const int j = j0 + q * kWarps;  // the same in every lane
      if (j >= m1) continue;
      const double v = j < rows ? warp_sum(acc[q]) : 0.0;
      if (lane == 0) u2[j] = v;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// K10's stages are dynamic shared memory above the 48 KB default, with the
// largest shared-memory carveout; set once a device for each form
template <bool kAligned>
static cudaError_t allow_df_stages() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  const void* kernel = (const void*)df_update_gram_kernel<kAligned>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDfSmemBudget);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
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

// K10: w' and u2 (m1,) in one launch over the plan of
// df64_orth_kernel.py:df_update_gram_plan (tile, n_tiles, grid, dynamic
// shared bytes; checked here); partials (rows, n_tiles) fp64 scratch,
// ticket K2's zeroed counter, left zeroed
int gmres_df_update_gram(const float* Vh, const float* Vl, const float* wh, const float* wl,
                         const double* u, float* woh, float* wol, double* u2, double* partials,
                         unsigned* ticket, int n, int rows, int m1, int tile, int n_tiles,
                         int grid, int smem, void* stream) {
  if (bad_shape(n, rows, m1) || tile < kDfLine || tile % kDfLine != 0 || tile > kDfMaxTile ||
      n_tiles != blocks_for(n, tile) || (size_t)smem != df_smem(rows, tile) ||
      smem > kDfSmemBudget || grid < 1 || grid > n_tiles)
    return (int)cudaErrorInvalidValue;
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool aligned = n % 4 == 0 && al(Vh) && al(Vl) && al(wh) && al(wl) && al(woh) && al(wol);
  const cudaError_t err = aligned ? allow_df_stages<true>() : allow_df_stages<false>();
  if (err != cudaSuccess) return (int)err;
  auto kernel = aligned ? df_update_gram_kernel<true> : df_update_gram_kernel<false>;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(Vh, Vl, wh, wl, u, woh, wol, u2,
                                                         partials, ticket, n, rows, m1, tile,
                                                         n_tiles);
  return (int)cudaGetLastError();
}

int gmres_df_update_sumsq(const float* Vh, const float* Vl, const float* wh, const float* wl,
                          const double* u, float* woh, float* wol, double* partials, int n,
                          int rows, int m1, void* stream) {
  if (bad_shape(n, rows, m1)) return (int)cudaErrorInvalidValue;
  df_update_sumsq_kernel<<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      Vh, Vl, wh, wl, u, woh, wol, partials, n, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
