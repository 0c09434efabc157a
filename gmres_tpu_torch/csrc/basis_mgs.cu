// K7 basis_mgs: the whole modified Gram-Schmidt recurrence of one Arnoldi
// step in one cooperative launch,
//
//   for j < rows:  h_j = <w, v_j>;  w <- w - h_j v_j;      then ||w||^2,
//
// over the row-stored Krylov basis V (m+1, n).  Replaces
// gmres_tpu/ops/pallas/orth_kernel.py:_mgs (the pallas_call at :381, kernel
// _mgs_kernel :290-365).  The operation order is the reference's
// (Orthogonalization.hpp:91-107): h_j from the already updated w, then
// w - h_j v_j.  Sums are taken in the basis dtype: fp32 for the mixed inner
// loop, fp64 for the baseline (the TPU kernel was fp32-only).
//
// What bounds it: each h_j is a reduction over all n columns, and the next
// row's update needs it, so a step is `rows` dependent grid-wide barriers;
// besides, it must read V's first `rows` rows once, w once and write w'
// once: (rows + 2) n s bytes.  The TPU kernel kept w in VMEM across a
// sequential grid and streamed one basis row per step; Hopper's blocks run
// in parallel and in no order.
//
// What the design does about it:
// - One cooperative launch per Arnoldi step, on a persistent grid no larger
//   than the resident block count (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//   optionally capped per SM by the caller); grid.sync() separates the rows.
//   A refused launch returns its error.
// - Columns are cut into fixed tiles of kTile; block b owns tiles
//   [b*TILES, (b+1)*TILES) and each thread keeps its TILES*kItems values of
//   w and of the current basis row in registers for the whole recurrence,
//   so V is read once and w never leaves the chip.
// - Per row, each tile's partial of <w, v_j> is a fixed tree (kItems fused
//   multiply-adds in order, a warp-shuffle tree, the warps in order) written
//   to its own slot partials[j][tile]: every row has its own slots, so no
//   second barrier is needed to reuse them.  After the barrier every block
//   sums partials[j][0..n_tiles) in the same fixed order (each thread a
//   strided share, then a block tree), so every block
//   gets the same bits of h_j, and since neither the tiles nor their trees
//   depend on the grid, the result is the same at every grid size.  No
//   atomics.
// - Row j+1 does not depend on h_j: its loads are issued before row j's
//   barrier and overlap it.
// - ||w'||^2 per tile goes to ss partials that the wrapper finishes with
//   torch.sum, as K3's SUMSQ mode does.
// - Where the resident grid cannot hold n in registers (more than
//   kMaxTiles tiles per block), or when the caller forbids registers, the
//   same recurrence runs with w kept in w_out (L2) and two basis rows read
//   per pass: the same tiles, trees and operations, so the same bits, at
//   about twice the traffic.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace gmres;

namespace {

constexpr int kMaxTiles = 8;  // tiles per block held in registers

// lane 0 of each warp stores the warp's share of sum_it a[it] * b[it]
template <typename T>
__device__ __forceinline__ void warp_tile_dot(const T (&a)[kItems], const T (&b)[kItems],
                                              T* slot) {
  T p = T(0);
#pragma unroll
  for (int it = 0; it < kItems; ++it) p = fmadd(a[it], b[it], p);
  p = warp_sum(p);
  if ((threadIdx.x & 31) == 0) *slot = p;
}

// the tile's partial: its kWarps warp shares in order
template <typename T>
__device__ __forceinline__ T finish_tile(const T* shares) {
  T s = T(0);
#pragma unroll
  for (int q = 0; q < kWarps; ++q) s += shares[q];
  return s;
}

// h_j = the row's n_tiles partials in a fixed order (thread-strided sums,
// then block_sum's tree), written to *out by thread 0; the whole block loads,
// so a row costs one round trip to L2.  `scratch` holds kWarps values.
template <typename T>
__device__ __forceinline__ void sum_row(const T* row_partials, int n_tiles, T* scratch,
                                        T* out) {
  T s = T(0);
#pragma unroll 4
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) s += __ldcg(row_partials + t);
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) *out = s;
}

template <typename T>
__device__ __forceinline__ void store_tile(T* dst, size_t col0, int n, const T (&v)[kItems]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const size_t c = col0 + (size_t)it * kThreads;
    if (c < (size_t)n) dst[c] = v[it];
  }
}

// a tile of w_out that this thread wrote earlier in the launch, read
// through L2
template <typename T>
__device__ __forceinline__ void load_tile_l2(const T* src, size_t col0, int n,
                                             T (&v)[kItems]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const size_t c = col0 + (size_t)it * kThreads;
    v[it] = c < (size_t)n ? __ldcg(src + c) : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void write_h(T* h, const T* hs, int rows, int m1) {
  if (blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < m1; i += kThreads) h[i] = i < rows ? hs[i] : T(0);
}

// w and the current basis row in registers: TILES tiles per block
template <typename T, int TILES>
__global__ void __launch_bounds__(kThreads)
basis_mgs_kernel(const T* __restrict__ V, const T* __restrict__ w, T* __restrict__ w_out,
                 T* __restrict__ h, T* partials, T* __restrict__ ss_part, int n, int rows,
                 int m1, int n_tiles) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red[TILES * kWarps];
  __shared__ T hs[kMaxRows];
  const int warp = threadIdx.x >> 5;
  const int tile0 = blockIdx.x * TILES;
  T wv[TILES][kItems], vc[TILES][kItems];
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const size_t col0 = (size_t)(tile0 + t) * kTile + threadIdx.x;
    load_tile(w, col0, n, wv[t]);
    load_tile(V, col0, n, vc[t]);
  }
  for (int j = 0; j < rows; ++j) {
#pragma unroll
    for (int t = 0; t < TILES; ++t) warp_tile_dot(wv[t], vc[t], &red[t * kWarps + warp]);
    T vn[TILES][kItems];
    const bool more = j + 1 < rows;
    if (more) {
      const T* next = V + (size_t)(j + 1) * n;
#pragma unroll
      for (int t = 0; t < TILES; ++t)
        load_tile(next, (size_t)(tile0 + t) * kTile + threadIdx.x, n, vn[t]);
    }
    __syncthreads();
    if ((int)threadIdx.x < TILES && tile0 + (int)threadIdx.x < n_tiles)
      partials[(size_t)j * n_tiles + tile0 + threadIdx.x] =
          finish_tile(red + threadIdx.x * kWarps);
    grid.sync();
    sum_row(partials + (size_t)j * n_tiles, n_tiles, red, &hs[j]);
    __syncthreads();
    const T nh = -hs[j];
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) wv[t][it] = fmadd(nh, vc[t][it], wv[t][it]);
    }
    if (more) {
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
#pragma unroll
        for (int it = 0; it < kItems; ++it) vc[t][it] = vn[t][it];
      }
    }
  }
  // out-of-range columns hold w = 0 and add nothing to the sum of squares
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    warp_tile_dot(wv[t], wv[t], &red[t * kWarps + warp]);
    store_tile(w_out, (size_t)(tile0 + t) * kTile + threadIdx.x, n, wv[t]);
  }
  __syncthreads();
  if ((int)threadIdx.x < TILES && tile0 + (int)threadIdx.x < n_tiles)
    ss_part[tile0 + threadIdx.x] = finish_tile(red + threadIdx.x * kWarps);
  write_h(h, hs, rows, m1);
}

// w in w_out: tiles grid-stride, pass j applies h_{j-1} v_{j-1} and takes
// the partials of <w, v_j> (pass `rows`: of ||w||^2)
template <typename T>
__global__ void __launch_bounds__(kThreads)
basis_mgs_global_kernel(const T* __restrict__ V, const T* __restrict__ w, T* w_out,
                        T* __restrict__ h, T* partials, T* __restrict__ ss_part, int n,
                        int rows, int m1, int n_tiles) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red[kWarps];
  __shared__ T hs[kMaxRows];
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j <= rows; ++j) {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const size_t col0 = (size_t)tile * kTile + threadIdx.x;
      T wv[kItems];
      if (j == 0) {
        load_tile(w, col0, n, wv);
      } else {
        T vp[kItems];
        load_tile_l2(w_out, col0, n, wv);
        load_tile(V + (size_t)(j - 1) * n, col0, n, vp);
        const T nh = -hs[j - 1];
#pragma unroll
        for (int it = 0; it < kItems; ++it) wv[it] = fmadd(nh, vp[it], wv[it]);
      }
      store_tile(w_out, col0, n, wv);
      if (j < rows) {
        T vj[kItems];
        load_tile(V + (size_t)j * n, col0, n, vj);
        warp_tile_dot(wv, vj, &red[warp]);
      } else {
        warp_tile_dot(wv, wv, &red[warp]);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        const T s = finish_tile(red);
        if (j < rows)
          partials[(size_t)j * n_tiles + tile] = s;
        else
          ss_part[tile] = s;
      }
      __syncthreads();
    }
    if (j < rows) {
      grid.sync();
      sum_row(partials + (size_t)j * n_tiles, n_tiles, red, &hs[j]);
      __syncthreads();
    }
  }
  write_h(h, hs, rows, m1);
}

template <typename T, int TILES>
const void* mgs_kernel() {
  if constexpr (TILES == 0)
    return (const void*)basis_mgs_global_kernel<T>;
  else
    return (const void*)basis_mgs_kernel<T, TILES>;
}

// blocks resident on the device for `fn`, per_sm > 0 capping the per-SM count
static cudaError_t resident_blocks(const void* fn, int per_sm, int* out) {
  int device = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads, 0);
  if (per_sm > 0 && per_sm < occ) occ = per_sm;
  *out = occ * sms;
  return err;
}

// Plan (the smallest register tiling whose grid is resident under the
// per-SM cap, else without it, else the L2 form) and launch.
template <typename T>
int launch_mgs(const T* V, const T* w, T* w_out, T* h, T* partials, T* ss_part, int n,
               int rows, int m1, int per_sm, int max_tiles, int* blocks_out,
               int* tiles_out, void* stream) {
  if (n <= 0 || rows <= 0 || rows > m1 || m1 > kMaxRows || per_sm < 0 || max_tiles < 0)
    return (int)cudaErrorInvalidValue;
  int n_tiles = blocks_for(n, kTile);
  const void* fns[] = {mgs_kernel<T, 1>(), mgs_kernel<T, 2>(), mgs_kernel<T, 4>(),
                       mgs_kernel<T, kMaxTiles>()};
  const int tiling[] = {1, 2, 4, kMaxTiles};
  const void* fn = nullptr;
  int tiles = 0, blocks = 0, cap = 0;
  cudaError_t err;
  // the per-SM cap first; past its register capacity, every resident block
  for (int pass = 0; pass < 2 && fn == nullptr; ++pass) {
    const int cap_sm = pass == 0 ? per_sm : 0;
    if (pass == 1 && per_sm == 0) break;
    for (int i = 0; i < 4 && tiling[i] <= max_tiles; ++i) {
      if ((err = resident_blocks(fns[i], cap_sm, &cap)) != cudaSuccess) return (int)err;
      const int need = blocks_for(n_tiles, tiling[i]);
      if (need <= cap) {
        fn = fns[i];
        tiles = tiling[i];
        blocks = need;
        break;
      }
    }
  }
  if (fn == nullptr) {
    fn = mgs_kernel<T, 0>();
    if ((err = resident_blocks(fn, per_sm, &cap)) != cudaSuccess) return (int)err;
    blocks = cap < n_tiles ? cap : n_tiles;
  }
  if (blocks <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks_out = blocks;
  *tiles_out = tiles;
  void* args[] = {(void*)&V,        (void*)&w,       (void*)&w_out, (void*)&h,
                  (void*)&partials, (void*)&ss_part, (void*)&n,     (void*)&rows,
                  (void*)&m1,       (void*)&n_tiles};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `syncs` grid-wide barriers and nothing else: the time of one barrier of a
// cooperative grid of this many blocks, the floor of K6 and K7
__global__ void __launch_bounds__(kThreads) grid_sync_probe_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}

}  // namespace

extern "C" {

int gmres_basis_mgs_f32(const float* V, const float* w, float* w_out, float* h,
                        float* partials, float* ss_part, int n, int rows, int m1, int per_sm,
                        int max_tiles, int* blocks, int* tiles, void* stream) {
  return launch_mgs<float>(V, w, w_out, h, partials, ss_part, n, rows, m1, per_sm,
                           max_tiles, blocks, tiles, stream);
}

int gmres_basis_mgs_f64(const double* V, const double* w, double* w_out, double* h,
                        double* partials, double* ss_part, int n, int rows, int m1,
                        int per_sm, int max_tiles, int* blocks, int* tiles, void* stream) {
  return launch_mgs<double>(V, w, w_out, h, partials, ss_part, n, rows, m1, per_sm,
                            max_tiles, blocks, tiles, stream);
}

int gmres_grid_sync_probe(int blocks, int syncs, void* stream) {
  if (blocks <= 0 || syncs < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&syncs};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)grid_sync_probe_kernel,
                                                dim3(blocks), dim3(kThreads), args, 0,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
