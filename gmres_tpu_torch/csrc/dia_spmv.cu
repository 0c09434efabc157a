// K1 and K12: the DIA sparse matrix-vector product, in plain and residual
// modes, over L lanes of x at once (K1's lane form) or over one rank's row
// block and the two halo edges from its neighbours (K12).  One kernel
// serves all of them: K1 is K12 with empty edges.
//
// Replaces
//   gmres_tpu/ops/pallas/spmv_kernel.py:dia_spmv_pallas (the pallas_call at
//     :88), the fp32 inner operator of the Arnoldi loop (K1), and
//     dia_spmv_pallas_windowed (the same pallas_call), the local SpMV of the
//     distributed halo path, gmres_tpu/parallel/halo.py:halo_spmv (K12); and
//   gmres_tpu/ops/pallas/df64_kernel.py:residual_df64 (the pallas_call at
//     :243) and residual_df64_halo (a wrapper over it), the mixed scheme's
//     outer residual r = b - A x with ||r'||^2 and ||x||^2.  The TPU ran it
//     on double-float (hi, lo) fp32 pairs because it has no fp64 units; the
//     H100 has them, so residual mode is native fp64.
// K1's lane form (Y = A X over the s lanes of a batched solve,
// solver/batched.py) has no TPU counterpart: the JAX package batched its
// solves with vmap on XLA paths only.
//
// Rows i in [0, n) of A; data[d, i] = A[i, i + off_d].  Column j = i + off_d
// of lane l reads
//     left[hl + j]             for -hl <= j < 0          (K12: rank s-1's tail)
//     x[l x_ld + j]            for 0 <= j < n_cols
//     right[j - n_cols]        for n_cols <= j < n_cols + hr  (rank s+1's head)
//     0                        elsewhere (the band is 0 there)
// K1 passes no edges (hl = hr = 0); K12 passes one lane.
//
// What bounds it: device-memory bandwidth.  Per row it does 2D flops on
// D + 2L values (D band values, each lane's x and y; + b in residual mode),
// about 0.25 flop per byte in fp32.  At convdiff@1M (D = 5) K1 moves 29 MB
// fp32: ~10 us at the card's copy rate, a launch of one or two waves of
// blocks, so what counts is the bytes each thread has in flight.
//
// What the design does about it (redesigned for Hopper; the one-thread-a-row
// kernels it replaces kept a band's loads behind a bounds branch):
// - The rows fall into blocks of kThreads R rows, thread t of a block owning
//   R contiguous rows: a 16-byte chunk (R = 4 fp32, 2 fp64) at one lane and
//   in residual mode, two rows in the plain lane form, one fp64 row at 8
//   lanes (dia_rows_per_thread).  A launch of G blocks walks them, block g
//   taking blocks g, g + G, ... (dia_grid_per_sm).  An interior block's
//   rows read only x for every band and take a branch-free body, one check
//   a chunk in the aligned form; only the blocks within max|off| of either
//   end take the window path.  ops/cuda/spmv_kernel.py:dia_plan
//   computes the interior range [b0, b1) in Python, and the launcher checks
//   it against its own (dia_interior).
// - A thread issues every load of a batch of bands (dia_bands: 5 at one
//   lane, fewer as the lanes' x values multiply) before the first
//   multiply-add, so a row pays one trip to memory per batch; registers are
//   capped for dia_min_blocks blocks an SM.  The bands and b, read once,
//   are loaded, and y and r stored, evict-first, which keeps x in L1 and L2
//   for its other bands (3-6% at one lane on the card; PERF.md, section 6,
//   PR 16).
// - Each band value is loaded once for all L lanes, with L accumulators per
//   row (a launch of fewer lanes than L reads its last lane in their place).
// - Where n is a multiple of R and data, y and b lie on R-value boundaries
//   (the aligned form), a band's values, b and y are one 16- or 8-byte load
//   or store a thread, and so is x at a band offset that is a multiple of R
//   where x and its lane stride are aligned too.  x at an unaligned offset
//   (+-1) is read one value at a time from L1/L2: on the card that was
//   faster than shifting aligned chunks and than staging in shared memory
//   (PERF.md, section 6, PRs 9 and 16).  Elsewhere (the general form) every
//   load is scalar.
// - Each row's sum is one chain: bands in ascending d, from 0, one fused
//   multiply-add a band, in the dtype of A; the window path adds data * 0
//   where a band reads past the edges.  So y (and r = b - y) has the bits
//   of the one-thread-a-row kernel this replaces, on every grid, in every
//   form and for every lane, and K12's rows those of K1 over the whole
//   matrix.
//
// Residual mode: each block of rows writes its fp64 partial sums of
// ||r'||^2 (r' = r rounded to fp32 when `demote` is set: the norm of the
// mixed scheme's start vector) and ||x||^2 for each lane; the last block of
// the launch to finish (K2's ticket counter) adds them in block order and
// writes 2 sums a lane, so a call is one launch, and its bits depend on
// neither the grid nor the lane count: lane l has the sums of a one-lane
// launch on x_l.  K12's are the shard's: the caller sums the ranks' shares.
#include <cstdint>

#include "common.cuh"

using namespace gmres;

namespace {

// The launch shape of each form, chosen on the card among rows a thread
// (1, 2, 4), bands a batch (1, 2, 3, 5) and blocks an SM (1-8) by
// scripts/port_k1_shapes.py (PERF.md, section 6, PR 16): rows a thread
// owns, contiguous (a 16-byte chunk in residual mode, so that every lane
// count sums the same blocks of rows, and at one lane; fewer in the plain
// lane form, whose L accumulators a row leave no registers for more), bands
// whose loads it issues together, and the blocks an SM its registers are
// capped for.  spmv_kernel.py:rows_per_thread is dia_rows_per_thread.
template <typename T, bool RESIDUAL, int L>
__host__ __device__ constexpr int dia_rows_per_thread() {
  if (RESIDUAL || L == 1) return 16 / (int)sizeof(T);
  return sizeof(T) == 4 || L <= 4 ? 2 : 1;
}
template <typename T, bool RESIDUAL, int L>
__host__ __device__ constexpr int dia_bands() {
  if (RESIDUAL || L == 1) return L == 1 ? 5 : L == 2 ? 3 : L == 4 ? 2 : 1;
  if (sizeof(T) == 4) return L == 2 ? 5 : L == 4 ? 3 : 2;
  return 5;
}
template <typename T, bool RESIDUAL, int L>
__host__ __device__ constexpr int dia_min_blocks() {
  if (RESIDUAL || L == 1) return L == 1 ? 4 : L == 2 ? 3 : 2;
  if (sizeof(T) == 4) return L == 4 ? 3 : 4;
  return L == 2 ? 3 : 2;
}

// The default grid of a launch: blocks an SM of a persistent grid, or 0 for
// one block a block of rows.  Residual mode sweeps its blocks of rows 4-6%
// sooner on dia_min_blocks blocks an SM, and the plain fp32 form at 8 lanes
// 3% sooner on 6 (PERF.md, section 6, PR 16).
template <typename T, bool RESIDUAL, int L>
__host__ __device__ constexpr int dia_grid_per_sm() {
  if (RESIDUAL) return dia_min_blocks<T, RESIDUAL, L>();
  return sizeof(T) == 4 && L == 8 ? 6 : 0;
}

// The interior blocks [b0, b1): block b owns rows [b R, min((b+1) R, n)),
// and is interior when every row i of it reads x[i + off] inside [0, n_cols)
// for every band, i.e. b R >= lo and min((b+1) R, n) <= n_cols - hi with lo
// = max(0, -min off), hi = max(0, max off).  spmv_kernel.py:dia_plan is the
// same function.
void dia_interior(const int* offsets, int n_diags, int n, int n_cols, int rows_per_block,
                  int* b0, int* b1) {
  int lo = 0, hi = 0;
  for (int d = 0; d < n_diags; ++d) {
    lo = offsets[d] < -lo ? -offsets[d] : lo;
    hi = offsets[d] > hi ? offsets[d] : hi;
  }
  const int n_blocks = blocks_for(n, rows_per_block);
  const long long first = ((long long)lo + rows_per_block - 1) / rows_per_block;
  *b0 = (int)(first < n_blocks ? first : n_blocks);
  const long long room = (long long)n_cols - hi;
  const int end = n <= room ? n_blocks : (room >= 0 ? (int)(room / rows_per_block) : 0);
  *b1 = end > *b0 ? end : *b0;
}

template <typename T>
struct DiaArgs {
  const T* data;
  const T* x;
  long long x_ld;
  const T* left;
  const T* right;
  const T* b;
  long long b_ld;
  T* y;
  long long y_ld;
  double* partials;  // residual: (lanes, n_blocks, 2) scratch
  unsigned* ticket;  // residual: K2's zeroed counter (left zeroed)
  double* sums;      // residual: (lanes, 2)
  int n, n_cols, hl, hr, n_diags, demote, lanes, b0, b1, n_blocks;
  bool x_wide;  // x and its lane stride aligned as data (aligned form only)
};

template <typename T>
__device__ __forceinline__ T window(const T* __restrict__ x, const T* __restrict__ left,
                                    const T* __restrict__ right, int j, int n_cols, int hl,
                                    int hr) {
  if (j < 0) return j >= -hl ? __ldg(left + hl + j) : T(0);
  if (j < n_cols) return __ldg(x + j);
  return j < n_cols + hr ? __ldg(right + j - n_cols) : T(0);
}

// One load through the read-only path, or, for values the kernel reads once
// (the bands, b), one marked to be evicted first, so that they do not push
// x out of L1 and L2.
template <bool kOnce, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (kOnce)
    return __ldcs(p);
  else
    return __ldg(p);
}

// R contiguous values at p: one load (or store) of 16 or 8 bytes where R
// values take that many, else one value.  Stores are marked to be evicted
// first: this kernel does not read y or r back.
template <typename T, int R, bool kOnce = false>
__device__ __forceinline__ void ldg_rows(const T* p, T (&v)[R]) {
  if constexpr (R * sizeof(T) == 16 && sizeof(T) == 4) {
    const float4 q = ld<kOnce>(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (R * sizeof(T) == 16) {
    const double2 q = ld<kOnce>(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else if constexpr (R == 2) {
    const float2 q = ld<kOnce>(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = ld<kOnce>(p);
  }
}

template <typename T, int R>
__device__ __forceinline__ void st_rows(T* p, const T (&v)[R]) {
  if constexpr (R * sizeof(T) == 16 && sizeof(T) == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (R * sizeof(T) == 16)
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  else if constexpr (R == 2)
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  else
    __stcs(p, v[0]);
}

// the thread's R values of p at rows i0 + e (0 past n): one load where
// `wide`, else value by value
template <typename T, int R, bool kOnce = false>
__device__ __forceinline__ void load_rows(const T* __restrict__ p, int i0, int n, bool wide,
                                          T (&v)[R]) {
  if (wide && i0 < n) {
    ldg_rows<T, R, kOnce>(p + i0, v);
  } else {
#pragma unroll
    for (int e = 0; e < R; ++e) v[e] = i0 + e < n ? ld<kOnce>(p + i0 + e) : T(0);
  }
}

// acc[l][e] for lane l's rows i0 + e: the interior body (every read in x)
// or the window path, kB bands' loads issued before their multiply-adds.
// In the aligned form a thread's chunk lies wholly before n or wholly past
// it, so an interior chunk takes its loads with no check a value, and x at
// a band offset that keeps the chunk aligned in one load (one branch a
// band, the same for the whole launch).
template <typename T, bool kAligned, bool kInterior, int L, int R, int kB>
__device__ __forceinline__ void dia_rows(const DiaArgs<T>& a, const DiaOffsets& offs, int i0,
                                         T (&acc)[L][R]) {
  constexpr bool kWhole = kInterior && kAligned;
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int e = 0; e < R; ++e) acc[l][e] = T(0);
  if (kWhole && i0 >= a.n) return;
  for (int d0 = 0; d0 < a.n_diags; d0 += kB) {
    T av[kB][R], xv[kB][L][R];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int d = d0 + k;
      if (d >= a.n_diags) continue;
      const int off = offs.off[d];
      const T* row = a.data + (size_t)d * a.n;
      // a launch of fewer lanes than L reads its last lane again in their
      // place (no branch in the batch; their sums are never stored)
      auto xl = [&](int l) {
        return a.x + (size_t)(L > 1 && l >= a.lanes ? a.lanes - 1 : l) * a.x_ld + off;
      };
      if constexpr (kWhole) {
        ldg_rows<T, R, true>(row + i0, av[k]);
        // one pointer stepped a lane stride a lane, which holds fewer
        // registers than L lane pointers
        const T* xp = a.x + off + i0;
        if (R > 1 && a.x_wide && (off & (R - 1)) == 0) {
#pragma unroll
          for (int l = 0; l < L; ++l) {
            ldg_rows<T, R>(xp, xv[k][l]);
            xp += l + 1 < a.lanes ? a.x_ld : 0;
          }
        } else {
#pragma unroll
          for (int l = 0; l < L; ++l) {
#pragma unroll
            for (int e = 0; e < R; ++e) xv[k][l][e] = __ldg(xp + e);
            xp += l + 1 < a.lanes ? a.x_ld : 0;
          }
        }
      } else {
        load_rows<T, R, true>(row, i0, a.n, kAligned, av[k]);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if constexpr (kInterior) {
            load_rows<T, R>(xl(l), i0, a.n, false, xv[k][l]);
          } else {
            const T* x = xl(l) - off;
#pragma unroll
            for (int e = 0; e < R; ++e)
              xv[k][l][e] = i0 + e < a.n ? window(x, a.left, a.right, i0 + e + off, a.n_cols,
                                                  a.hl, a.hr)
                                         : T(0);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      if (d0 + k >= a.n_diags) continue;
#pragma unroll
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int e = 0; e < R; ++e) acc[l][e] = fmadd(av[k][e], xv[k][l][e], acc[l][e]);
      }
    }
  }
}

template <typename T, bool RESIDUAL, bool kAligned, int L>
__global__ void __launch_bounds__(kThreads, (dia_min_blocks<T, RESIDUAL, L>()))
dia_spmv_kernel(const DiaArgs<T> a, const DiaOffsets offs) {
  constexpr int R = dia_rows_per_thread<T, RESIDUAL, L>();
  // residual mode: each lane's two partials of a block, then the block's
  __shared__ double scratch[RESIDUAL ? 2 * L : 1][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int blk = blockIdx.x; blk < a.n_blocks; blk += gridDim.x) {
    const int i0 = (blk * kThreads + threadIdx.x) * R;
    constexpr int kB = dia_bands<T, RESIDUAL, L>();
    T acc[L][R];
    if (blk >= a.b0 && blk < a.b1)
      dia_rows<T, kAligned, true, L, R, kB>(a, offs, i0, acc);
    else
      dia_rows<T, kAligned, false, L, R, kB>(a, offs, i0, acc);
    double sq[2 * L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (L > 1 && l >= a.lanes) continue;
      if constexpr (RESIDUAL) {
        T bv[R], xs[R];
        load_rows<T, R, true>(a.b + (size_t)l * a.b_ld, i0, a.n, kAligned, bv);
        load_rows<T, R>(a.x + (size_t)l * a.x_ld, i0, a.n, a.x_wide, xs);
        double r_sq = 0.0, x_sq = 0.0;
#pragma unroll
        for (int e = 0; e < R; ++e) {
          acc[l][e] = bv[e] - acc[l][e];
          const double rq = a.demote ? (double)(float)acc[l][e] : (double)acc[l][e];
          r_sq += rq * rq;
          x_sq += (double)xs[e] * (double)xs[e];
        }
        sq[2 * l] = r_sq;
        sq[2 * l + 1] = x_sq;
      }
      T* yl = a.y + (size_t)l * a.y_ld;
      if (kAligned) {
        if (i0 < a.n) st_rows<T, R>(yl + i0, acc[l]);
      } else {
#pragma unroll
        for (int e = 0; e < R; ++e)
          if (i0 + e < a.n) __stcs(yl + i0 + e, acc[l][e]);
      }
    }
    if constexpr (RESIDUAL) {
      // block_sum's tree for each of the 2 lanes values: a warp sum, then
      // the warps' sums over one warp
#pragma unroll
      for (int k = 0; k < 2 * L; ++k) {
        if (L > 1 && k >= 2 * a.lanes) continue;
        const double v = warp_sum(sq[k]);
        if (lane == 0) scratch[k][warp] = v;
      }
      __syncthreads();
      for (int k = warp; k < 2 * a.lanes; k += kWarps) {
        double t = lane < kWarps ? scratch[k][lane] : 0.0;
        t = warp_sum(t);
        if (lane == 0) a.partials[((size_t)(k >> 1) * a.n_blocks + blk) * 2 + (k & 1)] = t;
      }
      __syncthreads();
    }
  }

  if constexpr (RESIDUAL) {
    __shared__ bool last;
    // the last block to finish adds the blocks' partials in block order:
    // warp w sums quantity w, w + kWarps, ... (lane l's 2l and 2l + 1), its
    // lane j blocks j, j + 32, ..., then a warp tree
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int k = warp; k < 2 * a.lanes; k += kWarps) {
      const double* p = a.partials + (size_t)(k >> 1) * a.n_blocks * 2 + (k & 1);
      double s = 0.0;
      for (int j = lane; j < a.n_blocks; j += 32) s += __ldcg(p + 2 * j);
      s = warp_sum(s);
      if (lane == 0) a.sums[k] = s;
    }
    if (threadIdx.x == 0) *a.ticket = 0u;
  }
}

bool aligned_to(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// one launch of width L: the plan's blocks of kThreads R rows, checked
// against [b0, b1); the aligned form where n is a multiple of R and data, y
// (and b) lie on R-value boundaries, x loaded R values at a time where it
// does too.  grid <= 0 takes the form's default, dia_grid_per_sm blocks on
// each of the card's `sms` SMs (the caller's count, read once a process) or
// one block a block of rows
template <typename T, bool RESIDUAL, int L>
int launch_width(DiaArgs<T> a, const int* offsets, int grid, int sms, cudaStream_t stream) {
  constexpr int R = dia_rows_per_thread<T, RESIDUAL, L>();
  constexpr int kBytes = R * (int)sizeof(T);
  int c0 = 0, c1 = 0;
  dia_interior(offsets, a.n_diags, a.n, a.n_cols, kThreads * R, &c0, &c1);
  if (a.b0 != c0 || a.b1 != c1) return (int)cudaErrorInvalidValue;
  a.n_blocks = blocks_for(a.n, kThreads * R);
  if (grid <= 0) grid = sms * dia_grid_per_sm<T, RESIDUAL, L>();
  grid = grid <= 0 || grid > a.n_blocks ? a.n_blocks : grid;
  DiaOffsets offs;
  for (int d = 0; d < a.n_diags; ++d) offs.off[d] = offsets[d];
  const bool many = a.lanes > 1;
  const bool aligned = a.n % R == 0 && aligned_to(a.data, kBytes) && aligned_to(a.y, kBytes) &&
                       (!many || a.y_ld % R == 0) &&
                       (!RESIDUAL || (aligned_to(a.b, kBytes) && (!many || a.b_ld % R == 0)));
  a.x_wide = aligned && aligned_to(a.x, kBytes) && a.n_cols % R == 0 &&
             (!many || a.x_ld % R == 0);
  if (aligned)
    dia_spmv_kernel<T, RESIDUAL, true, L><<<grid, kThreads, 0, stream>>>(a, offs);
  else
    dia_spmv_kernel<T, RESIDUAL, false, L><<<grid, kThreads, 0, stream>>>(a, offs);
  return (int)cudaGetLastError();
}

template <typename T, bool RESIDUAL>
int launch_dia(const DiaArgs<T>& a, const int* offsets, int grid, int sms, void* stream) {
  if (a.n <= 0 || a.n_cols <= 0 || a.hl < 0 || a.hr < 0 || a.n_diags <= 0 ||
      a.n_diags > kMaxDiags || a.lanes < 1 || a.lanes > 8 ||
      (a.lanes > 1 && (a.hl > 0 || a.hr > 0)) || (grid <= 0 && sms <= 0))
    return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  if (a.lanes == 1) return launch_width<T, RESIDUAL, 1>(a, offsets, grid, sms, s);
  if (a.lanes == 2) return launch_width<T, RESIDUAL, 2>(a, offsets, grid, sms, s);
  if (a.lanes <= 4) return launch_width<T, RESIDUAL, 4>(a, offsets, grid, sms, s);
  return launch_width<T, RESIDUAL, 8>(a, offsets, grid, sms, s);
}

template <typename T>
int spmv_entry(const T* data, const T* x, long long x_ld, const T* left, const T* right, int hl,
               int hr, T* y, long long y_ld, int n, int n_cols, int n_diags, const int* offsets,
               int lanes, int b0, int b1, int grid, int sms, void* stream) {
  DiaArgs<T> a{data, x, x_ld, left, right, nullptr, 0, y, y_ld, nullptr, nullptr, nullptr,
               n, n_cols, hl, hr, n_diags, 0, lanes, b0, b1, 0, false};
  return launch_dia<T, false>(a, offsets, grid, sms, stream);
}

template <typename T>
int residual_entry(const T* data, const T* x, long long x_ld, const T* left, const T* right,
                   int hl, int hr, const T* b, long long b_ld, T* r, long long r_ld,
                   double* partials, unsigned* ticket, double* sums, int n, int n_diags,
                   const int* offsets, int demote, int lanes, int b0, int b1, int grid,
                   int sms, void* stream) {
  DiaArgs<T> a{data, x, x_ld, left, right, b, b_ld, r, r_ld, partials, ticket, sums,
               n, n, hl, hr, n_diags, demote, lanes, b0, b1, 0, false};
  return launch_dia<T, true>(a, offsets, grid, sms, stream);
}

}  // namespace

extern "C" {

// y (lanes, y_ld) = A x for lanes 1..8 of x (lanes x_ld values apart), over
// the edges left (hl values) and right (hr) where hl or hr > 0 (one lane);
// [b0, b1): spmv_kernel.py:dia_plan's interior blocks (checked here)
int gmres_dia_spmv_f32(const float* data, const float* x, long long x_ld, const float* left,
                       const float* right, int hl, int hr, float* y, long long y_ld, int n,
                       int n_cols, int n_diags, const int* offsets, int lanes, int b0, int b1,
                       int grid, int sms, void* stream) {
  return spmv_entry(data, x, x_ld, left, right, hl, hr, y, y_ld, n, n_cols, n_diags, offsets,
                    lanes, b0, b1, grid, sms, stream);
}

int gmres_dia_spmv_f64(const double* data, const double* x, long long x_ld, const double* left,
                       const double* right, int hl, int hr, double* y, long long y_ld, int n,
                       int n_cols, int n_diags, const int* offsets, int lanes, int b0, int b1,
                       int grid, int sms, void* stream) {
  return spmv_entry(data, x, x_ld, left, right, hl, hr, y, y_ld, n, n_cols, n_diags, offsets,
                    lanes, b0, b1, grid, sms, stream);
}

// residual mode: r = b - A x a lane, partials (lanes, n_blocks, 2) scratch,
// ticket K2's zeroed counter (left zeroed), sums (lanes, 2) the fp64 sums
// of squares
int gmres_dia_residual_f32(const float* data, const float* x, long long x_ld,
                           const float* left, const float* right, int hl, int hr,
                           const float* b, long long b_ld, float* r, long long r_ld,
                           double* partials, unsigned* ticket, double* sums, int n,
                           int n_diags, const int* offsets, int demote, int lanes, int b0,
                           int b1, int grid, int sms, void* stream) {
  return residual_entry(data, x, x_ld, left, right, hl, hr, b, b_ld, r, r_ld, partials, ticket,
                        sums, n, n_diags, offsets, demote, lanes, b0, b1, grid, sms, stream);
}

int gmres_dia_residual_f64(const double* data, const double* x, long long x_ld,
                           const double* left, const double* right, int hl, int hr,
                           const double* b, long long b_ld, double* r, long long r_ld,
                           double* partials, unsigned* ticket, double* sums, int n,
                           int n_diags, const int* offsets, int demote, int lanes, int b0,
                           int b1, int grid, int sms, void* stream) {
  return residual_entry(data, x, x_ld, left, right, hl, hr, b, b_ld, r, r_ld, partials, ticket,
                        sums, n, n_diags, offsets, demote, lanes, b0, b1, grid, sms, stream);
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
