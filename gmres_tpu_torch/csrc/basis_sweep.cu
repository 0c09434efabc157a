// K2-K4 and K2x2: sweeps over the row-stored Krylov basis V (m+1, n).
//
// K2 basis_gram<TV,TW>           u[j] = sum_i V[j,i] w[i]            for j < rows
//   replaces gmres_tpu/ops/pallas/orth_kernel.py:_gram (pallas_call at :59).
// K3 basis_update<TV,TW,SUMSQ>   w' = w - sum_j u[j] V[j,:], fused with
//   ||w'||^2 (SUMSQ) over the same tile
//   replaces orth_kernel.py:_update_sumsq (:216); with the flag off it is
//   _update (:129), exported as basis_update (CGS passes of CGSR with
//   orth_steps != 2).
// K3 GRAM basis_update_gram<TV,TW>  w' = w - sum_j u[j] V[j,:] and u2 = V w'
//   replaces orth_kernel.py:_update_gram (:171, kernel body :144-163).  In
//   fp32 and every mixed form each tile of the basis is staged in shared
//   memory once and both passes read it there, in one launch
//   (basis_update_gram_kernel); in fp64 the one-row-at-a-time arithmetic,
//   its rows loaded a batch at a time and its re-read served by L2
//   (basis_update_gram_blocks_kernel).  gram, update_gram and update_sumsq
//   chained are one CGSR step (orth_kernel.py:cgsr2_pallas).
// K2x2 basis_gram2<TV,TW>        (u0, u1) = (V w0, V w1) over rows < rows
//   replaces orth_kernel.py:_gram2 (:102), the one reduction of an ICWY
//   (one-reduce MGS) step: each tile of V is read once for both vectors,
//   so the sweep costs one read of the basis where two K2 launches cost
//   two.  It is K2's kernel with two vectors (basis_gram_kernel, NV = 2):
//   one launch, u0 and u1 each with the bits of K2's u for that vector.
// K4 basis_axpy<TV,TY,TX>        x[i] += (TX)(sum_{j<rows} y[j] V[j,i])
//   replaces gmres_tpu/ops/pallas/df64_kernel.py:axpy_df64 (:295) and the
//   basis combination gmres_tpu/solver/gmres.py:547 does with jnp.matmul:
//   the increment is summed in the dtype jnp gives (y, V) and added to the
//   iterate without ever being written to memory.  The TPU added it to a
//   double-float pair; the H100 has native fp64.
// K4 pair mode basis_axpy_pair   x[i] += sum_{j<rows} y[j] (Vh[j,i] + Vl[j,i])
//   the solution update of a df64 cycle (gmres_tpu/solver/gmres.py:538-545,
//   df_basis_comb then a pair add): each basis pair is merged to fp64 in
//   registers and the sum taken in native fp64, so no fp64 copy of the basis
//   (250 MB at m = 30, n = 1M) is ever made.
//
// Dtype forms (TV the basis, TW the vectors; sums in acc_t<TW>, common.cuh):
// (f32, f32) and (f64, f64) for the native tiers; the compressed basis
// (gmres_tpu/config.py:PrecisionSpec.basis) stores V narrower than the
// arithmetic: (bf16, f32) under an fp32 inner loop, (f32, f64) under fp64;
// the bf16 inner tier sweeps (bf16, bf16).  As in the TPU kernels, the
// products and sums of a sweep run in the accumulation dtype and only the
// outputs are rounded to TW: K3 GRAM's u2 and K3 SUMSQ's ||w'||^2 are taken
// from w' before it is rounded (orth_kernel.py:144-160, :192-207), and K2's
// u and K3 GRAM's u2 leave the kernel in TW (:70), so a bf16 u is rounded
// between the passes.  K4's forms are those of jnp.matmul(y, V) promoted to
// x: (f32 V, f32 y) and (bf16 V, f32 y) sum in fp32, (f32 V, f64 y) in fp64,
// (bf16 V, bf16 y) in fp32 rounded to bf16 before the add.
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
//   K2, K2x2 and K3 GRAM (redesigned) finish their own sums in the same
//   launch: see basis_gram_kernel and basis_update_gram_kernel; K4
//   (redesigned) sums each column in one thread: see basis_axpy_kernel.
#include <cstdint>
#include <cstring>

#include "common.cuh"

using namespace gmres;

// K2, redesigned for Hopper: a persistent grid walks fixed column tiles of
// kGramTileCols columns (tile t -> block t mod grid), each thread covering
// gram_chunks 16-byte chunks of a basis row's tile; rows go kGramRows at a
// time, every row's 16-byte loads of a chunk issued before any is used, so a
// thread keeps kGramRows x 16 bytes in flight where one row at a time kept
// 16.  The warp sums run once per group of rows, the block's sum once per
// row and tile.  Each tile writes its (rows,) partial; the last block to
// finish (a ticket counter after __threadfence, no atomics on the values)
// adds the tiles' partials in tile order and writes u, so a call is one
// launch and its bits depend on n and the alignment only, not on the grid.
//
// K2x2 is the same kernel with NV = 2 vectors: both w tiles in registers
// (aligned form) or in shared memory (general form), each 16-byte chunk of
// a basis row loaded once and used for both products, tile partials (rows,
// NV, n_tiles) and u (m1, NV).  Every operation on vector v is the one K2
// does on it, in the same order, so u[:, v] is K2's u for w_v bit for bit.
// Two vectors keep twice the w values and sums in registers, so NV = 2
// runs kGram2BlocksPerSM blocks an SM (up to 128 registers a thread, no
// spill) where K2 runs kGramBlocksPerSM.
//
// Alignment: a row starts 16-byte aligned only where n is a multiple of
// the basis's vector width.  The aligned form keeps w's tile in registers;
// the general form stages w's tile in shared memory and splits each row's
// tile at its own phase a (the first column whose address is 16-byte
// aligned): a scalar head [0, a), vector chunks from a, and the chunk that
// crosses the tile's end (or n) in scalars.  orth_kernel.py:gram_plan and
// tile_row_split hold the same geometry for the CPU tests.
// 2048-column tiles (512 at n = 1M) and blocks of at most 64 registers a
// thread, so that 4 blocks (128 KB of loads in flight) fit on an SM
constexpr int kGramRows = 8;
constexpr int kGramTileCols = 2048;
constexpr int kGramBlocksPerSM = 4;
constexpr int kGram2BlocksPerSM = 2;

template <typename TV>
__host__ __device__ constexpr int gram_chunks() { return kGramTileCols / (kThreads * vec16<TV>()); }
template <int NV>
__host__ __device__ constexpr int gram_blocks_per_sm() {
  return NV == 1 ? kGramBlocksPerSM : kGram2BlocksPerSM;
}
// dynamic shared bytes: the warps' row sums red[(v * kWarps + warp) *
// kMaxRows + j], then (general form) w's tiles ws[v * kGramTileCols + c]
template <typename TA, int NV>
__host__ __device__ constexpr size_t gram_smem(bool aligned) {
  return sizeof(TA) * NV * ((size_t)kWarps * kMaxRows + (aligned ? 0 : kGramTileCols));
}

// Row j's tile partials of this thread over its chunks against the NV
// vectors, the general form: w's tiles in shared memory `ws`, the row split
// at its phase `a`
template <int NV, typename TA, typename TV>
__device__ __forceinline__ void gram_row_general(const TV* __restrict__ vrow, const TA* ws,
                                                 int cols, int a, TA (&acc)[NV]) {
  constexpr int kVec = vec16<TV>();
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = TA(0);
  if ((int)threadIdx.x < a && (int)threadIdx.x < cols) {
    const TA x = up<TA>(vrow[threadIdx.x]);
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = fmadd(x, ws[v * kGramTileCols + threadIdx.x], acc[v]);
  }
#pragma unroll
  for (int u = 0; u < gram_chunks<TV>(); ++u) {
    const int cc = a + (u * kThreads + (int)threadIdx.x) * kVec;
    if (cc + kVec <= cols) {
      TA x[kVec];
      ldg_as(vrow + cc, x);
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[v] = fmadd(x[e], ws[v * kGramTileCols + cc + e], acc[v]);
    } else {
      for (int e = 0; e < kVec && cc + e < cols; ++e) {
        const TA x = up<TA>(vrow[cc + e]);
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[v] = fmadd(x, ws[v * kGramTileCols + cc + e], acc[v]);
      }
    }
  }
}

template <typename TV, typename TW, bool kAligned, int NV>
__global__ void __launch_bounds__(kThreads, gram_blocks_per_sm<NV>())
basis_gram_kernel(const TV* __restrict__ V, const TW* __restrict__ w0,
                  const TW* __restrict__ w1, TW* __restrict__ u,
                  acc_t<TW>* __restrict__ partials, unsigned* __restrict__ ticket, int n,
                  int rows, int m1, int n_tiles) {
  using TA = acc_t<TW>;
  using R = typename Raw16<TV>::type;
  constexpr int kVec = vec16<TV>();
  constexpr int kTileCols = kGramTileCols;
  extern __shared__ __align__(16) unsigned char gram_smem_raw[];
  TA* const red = reinterpret_cast<TA*>(gram_smem_raw);
  TA* const ws = red + NV * kWarps * kMaxRows;
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TW* const w[2] = {w0, w1};
  // element offset of V's first column from a 16-byte boundary
  const int v_phase = (int)((reinterpret_cast<uintptr_t>(V) / sizeof(TV)) % kVec);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const size_t c0 = (size_t)t * kTileCols;
    const int cols = (int)min((size_t)kTileCols, (size_t)n - c0);
    TA wv[NV][gram_chunks<TV>()][kVec];
    if constexpr (kAligned) {
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int q = 0; q < gram_chunks<TV>(); ++q) {
          const int c = (q * kThreads + (int)threadIdx.x) * kVec;
          if (c < cols) {
            ldg_as(w[v] + c0 + c, wv[v][q]);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) wv[v][q][e] = TA(0);
          }
        }
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v)
        for (int c = threadIdx.x; c < kTileCols; c += kThreads)
          ws[v * kTileCols + c] = c < cols ? up<TA>(w[v][c0 + c]) : TA(0);
      __syncthreads();
    }
    for (int g = 0; g < rows; g += kGramRows) {
      TA acc[kGramRows][NV];
#pragma unroll
      for (int r = 0; r < kGramRows; ++r)
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[r][v] = TA(0);
      if constexpr (kAligned) {
#pragma unroll
        for (int q = 0; q < gram_chunks<TV>(); ++q) {
          const int c = (q * kThreads + (int)threadIdx.x) * kVec;
          if (c >= cols) continue;
          // the rows' 16 bytes in flight together, widened where used
          R raw[kGramRows];
#pragma unroll
          for (int r = 0; r < kGramRows; ++r)
            raw[r] = g + r < rows ? __ldg(reinterpret_cast<const R*>(V + (size_t)(g + r) * n +
                                                                      c0 + c))
                                  : R{};
#pragma unroll
          for (int r = 0; r < kGramRows; ++r) {
            TA x[kVec];
            unpack16<TA>(raw[r], x);
#pragma unroll
            for (int v = 0; v < NV; ++v)
#pragma unroll
              for (int e = 0; e < kVec; ++e) acc[r][v] = fmadd(x[e], wv[v][q][e], acc[r][v]);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < kGramRows; ++r) {
          if (g + r >= rows) continue;
          const size_t start = (size_t)(g + r) * n + c0;
          const int a = (int)((kVec - (int)((v_phase + start) % kVec)) % kVec);
          gram_row_general<NV>(V + start, ws, cols, a, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kGramRows; ++r) {
        if (g + r >= rows) continue;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const TA s = warp_sum(acc[r][v]);
          if (lane == 0) red[(v * kWarps + warp) * kMaxRows + g + r] = s;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < NV; ++v)
      for (int j = threadIdx.x; j < rows; j += kThreads) {
        TA s = TA(0);
#pragma unroll
        for (int q = 0; q < kWarps; ++q) s += red[(v * kWarps + q) * kMaxRows + j];
        partials[((size_t)j * NV + v) * n_tiles + t] = s;
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
    TA s[kSumRows][NV];
#pragma unroll
    for (int r = 0; r < kSumRows; ++r)
#pragma unroll
      for (int v = 0; v < NV; ++v) s[r][v] = TA(0);
#pragma unroll 4
    for (int t = lane; t < n_tiles; t += 32) {
#pragma unroll
      for (int r = 0; r < kSumRows; ++r) {
        const int j = j0 + r * kWarps;
        if (j >= rows) continue;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          s[r][v] += __ldcg(partials + ((size_t)j * NV + v) * n_tiles + t);
      }
    }
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) {
      const int j = j0 + r * kWarps;  // the same in every lane
      if (j >= m1) continue;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const TA x = j < rows ? warp_sum(s[r][v]) : TA(0);
        if (lane == 0) u[(size_t)j * NV + v] = down<TW>(x);
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename TV, typename TW, bool SUMSQ>
__global__ void __launch_bounds__(kThreads)
basis_update_kernel(const TV* __restrict__ V, const TW* __restrict__ w,
                    const TW* __restrict__ u, TW* __restrict__ w_out,
                    acc_t<TW>* __restrict__ partials, int n, int rows, int m1) {
  using TA = acc_t<TW>;
  __shared__ TA us[kMaxRows];
  __shared__ TA red[kWarps];
  for (int j = threadIdx.x; j < rows; j += kThreads) us[j] = up<TA>(u[j]);
  __syncthreads();

  const size_t col0 = (size_t)blockIdx.x * kTile + threadIdx.x;
  TA wv[kItems], acc[kItems];
  load_tile_as(w, col0, n, wv);
#pragma unroll
  for (int it = 0; it < kItems; ++it) acc[it] = TA(0);
  // w' = w - (u^T V): the combination is summed first and subtracted once,
  // the order of the reference formulation (orth_kernel.py:_update_kernel).
  for (int j = 0; j < rows; ++j) {
    TA rv[kItems];
    load_tile_as(V + (size_t)j * n, col0, n, rv);
    const TA uj = us[j];
#pragma unroll
    for (int it = 0; it < kItems; ++it) acc[it] += uj * rv[it];
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    wv[it] -= acc[it];
    const size_t c = col0 + (size_t)it * kThreads;
    if (c < (size_t)n) w_out[c] = down<TW>(wv[it]);
  }
  // out-of-range columns hold w = 0 and acc = 0, so wv is 0 there and adds
  // nothing to the sum below

  if constexpr (SUMSQ) {
    // of w' before it is rounded to TW (orth_kernel.py:_update_sumsq_kernel)
    TA p = TA(0);
#pragma unroll
    for (int it = 0; it < kItems; ++it) p += wv[it] * wv[it];
    p = block_sum(p, red);
    if (threadIdx.x == 0) partials[blockIdx.x] = p;
  }
}

// K3 GRAM in fp32 and the mixed forms, redesigned for Hopper: the update
// pass and the GRAM pass both read the basis tile from shared memory, so V
// leaves device memory once.
// A persistent grid walks fixed column tiles of ug_tile<TV,TW>(rows)
// columns (tile t -> block t mod grid).  A block stages all `rows` rows of
// a tile and w's tile into shared memory with asynchronous copies (where
// every row starts 16-byte aligned, one bulk copy (TMA) a row, issued by
// one thread and completing on the stage's mbarrier; else one cp.async a
// value, or for bf16 values, which cp.async cannot copy alone, a load and
// a store), all of them in flight at once, in a ring of two stages: the
// next tile's copies are issued before the current tile is computed, so a
// tile is always in flight while the block computes.  Then
// - the update pass: thread t owns 16-byte chunks t, t + kThreads, ... of
//   the basis tile; per column the combination is summed over j in
//   ascending order with one fmadd a row, starting from 0, and subtracted
//   from w once (the reference's order, orth_kernel.py:_update_kernel), so
//   w' has the bits of the one-row-at-a-time form it replaces; w' is
//   written to device memory (rounded to TW) and, unrounded, over w's tile
//   in the stage (TW = TA) or into a tile of its own (a bf16 w);
// - the GRAM pass: warp q takes rows q, q + kWarps, ... (kUgRows of them at
//   once, sharing each read of w'), its lanes the tile's chunks in turn;
//   each row's tile partial goes to partials[j * stride + t].
// The tile width is the widest run of whole 128-byte lines of a basis row
// whose two stages ((rows) basis rows and w's row of the tile each), the
// unrounded w' of a bf16 w and u fit kUgSmemBudget, at every rows in
// 1..kMaxRows, and at most kUgMaxRowBytes a basis row; the grid holds up
// to kUgBlocksPerSM blocks an SM, as many as the stages leave room for.
// The last block to finish (K2's ticket) adds each row's tile partials, 16
// bytes a lane, in a fixed order, so a call is one launch and its bits
// depend on n, rows, the dtypes and the alignment, not on the grid.
// orth_kernel.py:update_gram_plan holds the same geometry for the CPU tests.
constexpr int kUgSmemBudget = 230400;   // dynamic bytes: 225 KB of a block's 227
constexpr int kUgLine = 128;
constexpr int kUgMaxRowBytes = 8192;
constexpr int kUgBlocksPerSM = 2;
constexpr int kUgRows = 4;

// u's slots in the stage, a whole number of 16-byte chunks of TA
template <typename TW>
__host__ __device__ inline int ug_u_slots(int rows) {
  constexpr int vec = vec16<acc_t<TW>>();
  return (rows + vec - 1) / vec * vec;
}
// bytes a tile column takes outside the ring: w' of a bf16 w
template <typename TW>
__host__ __device__ constexpr int ug_wp_bytes() {
  return std::is_same_v<TW, acc_t<TW>> ? 0 : (int)sizeof(acc_t<TW>);
}
template <typename TV, typename TW>
inline int ug_tile(int rows) {
  const int line = kUgLine / (int)sizeof(TV);
  const int fixed = ug_u_slots<TW>(rows) * (int)sizeof(acc_t<TW>);
  const int per_col = 2 * (rows * (int)sizeof(TV) + (int)sizeof(TW)) + ug_wp_bytes<TW>();
  const int fit = (kUgSmemBudget - fixed) / per_col / line * line;
  const int cap = kUgMaxRowBytes / (int)sizeof(TV);
  return fit < cap ? fit : cap;
}
template <typename TV, typename TW>
inline size_t ug_smem(int rows, int tile) {
  return (size_t)ug_u_slots<TW>(rows) * sizeof(acc_t<TW>) +
         (size_t)tile * (2 * (rows * sizeof(TV) + sizeof(TW)) + ug_wp_bytes<TW>());
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
__device__ __forceinline__ void ldcg16(const T* p, T (&v)[vec16<T>()]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 q = __ldcg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
}

// one value into shared memory for the general form: cp.async copies 4 or
// 8 bytes, a bf16 is loaded and stored (the barrier before the tile is
// read orders it)
template <typename T>
__device__ __forceinline__ void stage_value(T* dst, const T* src) {
  if constexpr (sizeof(T) >= 4)
    cp_async(dst, src);
  else
    *dst = *src;
}

// tile t's rows 0..rows-1 of V and w's tile into the stage at `stage`: row
// j at stage + j * tile * sizeof(TV) bytes, w's at stage + rows * tile *
// sizeof(TV); aligned, one bulk copy a row issued by thread 0 on `bar`;
// else one copy a value, by every thread
template <typename TV, typename TW, bool kAligned>
__device__ __forceinline__ void stage_tile(unsigned char* stage, const TV* __restrict__ V,
                                           const TW* __restrict__ w, int t, int n, int rows,
                                           int tile, unsigned long long* bar) {
  const size_t c0 = (size_t)t * tile;
  const int cols = (int)min((size_t)tile, (size_t)n - c0);
  TV* vs = reinterpret_cast<TV*>(stage);
  TW* ws = reinterpret_cast<TW*>(stage + (size_t)rows * tile * sizeof(TV));
  if constexpr (kAligned) {
    if (threadIdx.x != 0) return;
    // whole 16-byte chunks here
    const unsigned vbytes = (unsigned)(cols * sizeof(TV)), wbytes = (unsigned)(cols * sizeof(TW));
    mbar_expect(bar, rows * vbytes + wbytes);
    for (int j = 0; j < rows; ++j)
      bulk_copy(vs + (size_t)j * tile, V + (size_t)j * n + c0, vbytes, bar);
    bulk_copy(ws, w + c0, wbytes, bar);
  } else {
    for (int j = 0; j < rows; ++j) {
      const TV* src = V + (size_t)j * n + c0;
      for (int k = threadIdx.x; k < cols; k += kThreads)
        stage_value(vs + (size_t)j * tile + k, src + k);
    }
    for (int k = threadIdx.x; k < cols; k += kThreads) stage_value(ws + k, w + c0 + k);
  }
}

template <typename TV, typename TW, bool kAligned>
__global__ void __launch_bounds__(kThreads, kUgBlocksPerSM)
basis_update_gram_kernel(const TV* __restrict__ V, const TW* __restrict__ w,
                         const TW* __restrict__ u, TW* __restrict__ w_out, TW* __restrict__ u2,
                         acc_t<TW>* __restrict__ partials, unsigned* __restrict__ ticket, int n,
                         int rows, int m1, int tile, int n_tiles, int stride) {
  using TA = acc_t<TW>;
  constexpr int kVec = vec16<TV>();     // columns of a chunk: 16 bytes of a basis row
  constexpr bool kOwnWp = !std::is_same_v<TW, TA>;
  extern __shared__ __align__(16) unsigned char ug_smem_raw[];
  TA* us = reinterpret_cast<TA*>(ug_smem_raw);
  TA* const wp_own = us + ug_u_slots<TW>(rows);  // w' of a bf16 w: `tile` values
  unsigned char* const ring =
      reinterpret_cast<unsigned char*>(wp_own + (kOwnWp ? tile : 0));  // stage s at s * stage
  const size_t stage = (size_t)tile * (rows * sizeof(TV) + sizeof(TW));
  __shared__ bool last;
  __shared__ __align__(8) unsigned long long bars[2];  // the stages' mbarriers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < rows; j += kThreads) us[j] = up<TA>(u[j]);
  if (kAligned && threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    fence_proxy_async();
  }
  __syncthreads();

  if ((int)blockIdx.x < n_tiles)
    stage_tile<TV, TW, kAligned>(ring, V, w, blockIdx.x, n, rows, tile, &bars[0]);
  if (!kAligned) cp_async_commit();
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    // the next tile into the other stage (free since the last barrier),
    // then wait for this one (its stage's (it / 2)-th fill)
    if (t + (int)gridDim.x < n_tiles)
      stage_tile<TV, TW, kAligned>(ring + ((it + 1) & 1) * stage, V, w, t + gridDim.x, n, rows,
                                   tile, &bars[(it + 1) & 1]);
    if constexpr (kAligned) {
      mbar_wait(&bars[it & 1], (it >> 1) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    const TV* vs = reinterpret_cast<const TV*>(ring + (it & 1) * stage);  // row j at j * tile
    TW* ws = reinterpret_cast<TW*>(ring + (it & 1) * stage + (size_t)rows * tile * sizeof(TV));
    TA* wp = kOwnWp ? wp_own : reinterpret_cast<TA*>(ws);  // w' as the GRAM pass reads it
    const size_t c0 = (size_t)t * tile;
    const int cols = (int)min((size_t)tile, (size_t)n - c0);

    // update pass; a chunk that crosses `cols` (general form only) computes
    // on stale slots past it and stores only its live columns
    for (int c = threadIdx.x * kVec; c < cols; c += kThreads * kVec) {
      TA acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = TA(0);
      for (int j = 0; j < rows; ++j) {
        const TA uj = us[j];
        TA v[kVec];
        lds_as(vs + (size_t)j * tile + c, v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmadd(uj, v[e], acc[e]);
      }
      TA wv[kVec];
      lds_as(ws + c, wv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) wv[e] -= acc[e];
      st_as(wp + c, wv);
      if constexpr (kAligned) {
        st_as(w_out + c0 + c, wv);
      } else {
        for (int e = 0; e < kVec && c + e < cols; ++e) w_out[c0 + c + e] = down<TW>(wv[e]);
      }
    }
    __syncthreads();

    // GRAM pass over whole chunks, then the columns of a chunk that
    // crosses `cols` one by one; a lane keeps one sum per element of a
    // chunk and adds them pairwise, so no sum runs longer than the tile's
    // chunks a lane takes
    const int full = cols / kVec * kVec;
    for (int j0 = warp; j0 < rows; j0 += kWarps * kUgRows) {
      TA p[kUgRows][kVec];
#pragma unroll
      for (int r = 0; r < kUgRows; ++r)
#pragma unroll
        for (int e = 0; e < kVec; ++e) p[r][e] = TA(0);
      for (int c = lane * kVec; c < full; c += 32 * kVec) {
        TA wv[kVec];
        lds_as(wp + c, wv);
#pragma unroll
        for (int r = 0; r < kUgRows; ++r) {
          const int j = j0 + r * kWarps;
          if (j >= rows) continue;
          TA v[kVec];
          lds_as(vs + (size_t)j * tile + c, v);
#pragma unroll
          for (int e = 0; e < kVec; ++e) p[r][e] = fmadd(v[e], wv[e], p[r][e]);
        }
      }
      for (int c = full + lane; c < cols; c += 32) {
#pragma unroll
        for (int r = 0; r < kUgRows; ++r) {
          const int j = j0 + r * kWarps;
          if (j < rows) p[r][0] = fmadd(up<TA>(vs[(size_t)j * tile + c]), wp[c], p[r][0]);
        }
      }
#pragma unroll
      for (int r = 0; r < kUgRows; ++r) {
        const int j = j0 + r * kWarps;  // the same in every lane
        if (j >= rows) continue;
        const TA s = warp_sum(pairwise<TA, kVec>(p[r]));
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
  constexpr int kVecA = vec16<TA>();
  const int full = n_tiles / kVecA * kVecA;
  for (int j0 = warp; j0 < m1; j0 += kWarps * kUgRows) {
    TA s[kUgRows][2 * kVecA];
#pragma unroll
    for (int r = 0; r < kUgRows; ++r)
#pragma unroll
      for (int e = 0; e < 2 * kVecA; ++e) s[r][e] = TA(0);
    for (int k = lane * kVecA; k < full; k += 64 * kVecA) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = k + h * 32 * kVecA;
        if (kk >= full) continue;
#pragma unroll
        for (int r = 0; r < kUgRows; ++r) {
          const int j = j0 + r * kWarps;
          if (j >= rows) continue;
          TA v[kVecA];
          ldcg16(partials + (size_t)j * stride + kk, v);
#pragma unroll
          for (int e = 0; e < kVecA; ++e) s[r][h * kVecA + e] += v[e];
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
      const TA v = j < rows ? warp_sum(pairwise<TA, 2 * kVecA>(s[r])) : TA(0);
      if (lane == 0) u2[j] = down<TW>(v);
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

// K4, redesigned for Hopper: a thread owns kAxpyCols = 8 columns of a tile
// of kThreads * kAxpyCols: axpy_chunks 16-byte chunks of a basis row (one
// of a bf16 basis, two of fp32, four of fp64), chunk k at k * kThreads *
// kVec columns from the thread's first, so that every chunk is one
// coalesced pass of the block.  The block walks tiles t, t + grid, ...;
// rows go axpy_rows at a time (4 of a bf16 or fp32 basis; of an fp64 basis
// one, its four chunks the loads in flight), every row's chunk loads issued
// before any multiply-add, y's rows in shared memory.  (The fastest of the
// rows, chunks and grids tried on the card at n = 1M, 30 rows: PERF.md
// section 6.)  The thread's values of
// x are read once and written once, 16 bytes an access (a bf16 chunk meets
// 32 bytes of fp32 x or 64 of fp64).  Each column's sum still runs over j
// in order, in the accumulation dtype, one fmadd a term from 0 (the
// one-row-at-a-time kernel it replaces contracted `acc += y_j * v` to the
// same fma), and a bf16 y rounds the increment to bf16 before the add, so x
// keeps that kernel's bits in every form and on every grid.
//
// Alignment: the aligned form (n a multiple of kVec, V and x 16-byte
// aligned) loads every chunk whole.  Otherwise a row's chunk is one 16-byte
// load where that row's chunk starts 16-byte aligned and lies whole below n,
// else value by value (a column's sum runs down the column in one thread, so
// a thread owns the same columns in every row, and rows of other phases
// cannot be split at their own phase as K2's are); x value by value.
// outer_kernel.py:axpy_plan holds the launch geometry, and
// tests/test_torch_kernel_plans.py models the chunks and the split.
constexpr int kAxpyCols = 8;
constexpr int kAxpyBlocksPerSM = 4;

template <typename TV>
__host__ __device__ constexpr int axpy_chunks() { return kAxpyCols / vec16<TV>(); }
template <typename TV>
__host__ __device__ constexpr int axpy_rows() { return sizeof(TV) == 8 ? 1 : 4; }

template <typename T>
struct Bits;
template <>
struct Bits<bf16> {
  using type = unsigned short;
};
template <>
struct Bits<float> {
  using type = unsigned;
};
template <>
struct Bits<double> {
  using type = unsigned long long;
};

// the live values of a basis row's chunk at p (zeros past them) as 16 raw
// bytes: one load where p is 16-byte aligned and the chunk whole
template <typename TV>
__device__ __forceinline__ typename Raw16<TV>::type load_chunk(const TV* p, int live) {
  using R = typename Raw16<TV>::type;
  using B = typename Bits<TV>::type;
  if (live == vec16<TV>() && reinterpret_cast<uintptr_t>(p) % 16 == 0)
    return __ldg(reinterpret_cast<const R*>(p));
  B b[vec16<TV>()];
#pragma unroll
  for (int e = 0; e < vec16<TV>(); ++e)
    b[e] = e < live ? __ldg(reinterpret_cast<const B*>(p) + e) : B(0);
  R r;
  memcpy(&r, b, sizeof(r));
  return r;
}

// kWhole (the aligned form where n is a whole number of tiles, as at n = 1M,
// of a bf16 or fp32 basis): every chunk is whole, so none is checked.  An
// fp64 basis keeps the checked loop: on the card it was the faster of the
// two there (PERF.md section 6)
template <typename TV, typename TY, typename TX, bool kAligned, bool kWhole>
__global__ void __launch_bounds__(kThreads, kAxpyBlocksPerSM)
basis_axpy_kernel(const TV* __restrict__ V, const TY* __restrict__ y, TX* __restrict__ x, int n,
                  int rows, int n_tiles) {
  using TA = acc_t<TY>;
  using R = typename Raw16<TV>::type;
  constexpr int kVec = vec16<TV>();
  constexpr int kChunks = axpy_chunks<TV>();
  constexpr int kRows = axpy_rows<TV>();
  __shared__ TA ys[kMaxRows];
  for (int j = threadIdx.x; j < rows; j += kThreads) ys[j] = up<TA>(y[j]);
  __syncthreads();
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const size_t c0 = (size_t)t * kThreads * kAxpyCols + (size_t)threadIdx.x * kVec;
    int live[kChunks];  // the chunk's columns below n
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const size_t c = c0 + (size_t)k * kThreads * kVec;
      live[k] = kWhole ? kVec : c < (size_t)n ? (int)min((size_t)kVec, (size_t)n - c) : 0;
    }
    TA acc[kChunks][kVec];
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[k][e] = TA(0);
    for (int g = 0; g < rows; g += kRows) {
      R raw[kRows][kChunks];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (g + r >= rows) continue;
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          if (live[k] == 0) continue;
          const TV* p = V + (size_t)(g + r) * n + c0 + (size_t)k * kThreads * kVec;
          raw[r][k] = kAligned ? __ldg(reinterpret_cast<const R*>(p)) : load_chunk(p, live[k]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (g + r >= rows) continue;
        const TA yj = ys[g + r];
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          if (live[k] == 0) continue;
          TA v[kVec];
          unpack16<TA>(raw[r][k], v);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[k][e] = fmadd(yj, v[e], acc[k][e]);
        }
      }
    }
    // a bf16 y gives a bf16 increment (jnp.matmul of two bf16 operands)
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      TX* xc = x + c0 + (size_t)k * kThreads * kVec;
      if constexpr (kAligned) {
        if (live[k] == 0) continue;
        TX xv[kVec];
        lds_as(xc, xv);  // a generic load: x is written here, so not through __ldg
#pragma unroll
        for (int e = 0; e < kVec; ++e) xv[e] += (TX)rounded<TY>(acc[k][e]);
        st_as(xc, xv);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (e < live[k]) xc[e] += (TX)rounded<TY>(acc[k][e]);
      }
    }
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

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A kernel's dynamic shared memory above the 48 KB default (K2x2's general
// form in fp64), set once a device
template <typename TV, typename TW, bool kAligned, int NV>
static cudaError_t allow_gram_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute((const void*)basis_gram_kernel<TV, TW, kAligned, NV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gram_smem<acc_t<TW>, NV>(kAligned));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// K2 (NV = 1, w1 unused) and K2x2 (NV = 2): u (m1, NV)
template <typename TV, typename TW, int NV>
static int launch_gram(const TV* V, const TW* w0, const TW* w1, TW* u, acc_t<TW>* partials,
                       unsigned* ticket, int n, int rows, int m1, int tile, int n_tiles, int grid,
                       void* stream) {
  if (bad_shape(n, rows, m1) || tile != kGramTileCols ||
      n_tiles != blocks_for(n, kGramTileCols) || grid < 1)
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      n % vec16<TV>() == 0 && aligned16(V) && aligned16(w0) && (NV == 1 || aligned16(w1));
  const size_t smem = gram_smem<acc_t<TW>, NV>(aligned);
  if (smem > 48 * 1024) {
    const cudaError_t err = aligned ? allow_gram_smem<TV, TW, true, NV>()
                                    : allow_gram_smem<TV, TW, false, NV>();
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel =
      aligned ? basis_gram_kernel<TV, TW, true, NV> : basis_gram_kernel<TV, TW, false, NV>;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(V, w0, w1, u, partials, ticket, n, rows,
                                                         m1, n_tiles);
  return (int)cudaGetLastError();
}

template <typename TV, typename TW, bool SUMSQ>
static int launch_update(const TV* V, const TW* w, const TW* u, TW* w_out, acc_t<TW>* partials,
                         int n, int rows, int m1, void* stream) {
  if (bad_shape(n, rows, m1)) return (int)cudaErrorInvalidValue;
  basis_update_kernel<TV, TW, SUMSQ>
      <<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
          V, w, u, w_out, partials, n, rows, m1);
  return (int)cudaGetLastError();
}

// K3 GRAM's stages are dynamic shared memory above the 48 KB default, with
// the largest shared-memory carveout; set once a device for each form
template <typename TV, typename TW, bool kAligned>
static cudaError_t allow_ug_stages() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  const void* kernel = (const void*)basis_update_gram_kernel<TV, TW, kAligned>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kUgSmemBudget);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename TV, typename TW>
static int launch_update_gram(const TV* V, const TW* w, const TW* u, TW* w_out, TW* u2,
                              acc_t<TW>* partials, unsigned* ticket, int n, int rows, int m1,
                              int tile, int n_tiles, int stride, int grid, int smem,
                              void* stream) {
  constexpr int vec_a = vec16<acc_t<TW>>();
  if (bad_shape(n, rows, m1) || tile != ug_tile<TV, TW>(rows) ||
      n_tiles != blocks_for(n, tile) || stride != blocks_for(n_tiles, vec_a) * vec_a ||
      (size_t)smem != ug_smem<TV, TW>(rows, tile) || grid < 1 || grid > n_tiles)
    return (int)cudaErrorInvalidValue;
  const bool aligned = n % vec16<TV>() == 0 && aligned16(V) && aligned16(w) && aligned16(w_out);
  auto kernel = aligned ? basis_update_gram_kernel<TV, TW, true>
                        : basis_update_gram_kernel<TV, TW, false>;
  const cudaError_t err =
      aligned ? allow_ug_stages<TV, TW, true>() : allow_ug_stages<TV, TW, false>();
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

template <typename TV, typename TY, typename TX>
static int launch_axpy(const TV* V, const TY* y, TX* x, int n, int rows, int n_tiles, int grid,
                       void* stream) {
  if (bad_shape(n, rows, rows) || n_tiles != blocks_for(n, kThreads * kAxpyCols) || grid < 1 ||
      grid > n_tiles)
    return (int)cudaErrorInvalidValue;
  const bool aligned = n % vec16<TV>() == 0 && aligned16(V) && aligned16(x);
  auto kernel = aligned ? basis_axpy_kernel<TV, TY, TX, true, false>
                        : basis_axpy_kernel<TV, TY, TX, false, false>;
  if constexpr (sizeof(TV) < 8) {
    if (aligned && n % (kThreads * kAxpyCols) == 0)
      kernel = basis_axpy_kernel<TV, TY, TX, true, true>;
  }
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(V, y, x, n, rows, n_tiles);
  return (int)cudaGetLastError();
}

// The C entry points of one (TV, TW) form, suffixed by the basis dtype and
// the vectors' (one name where both are the same: f32, f64):
//   gram          K2: u (m1,) from V and w in one launch; partials (rows,
//                 n_tiles) of the accumulation dtype, scratch; ticket one
//                 zeroed counter that the kernel leaves zeroed
//   gram2         K2x2: u (m1, 2) from V, w0 and w1 in one launch, K2's
//                 plan; partials (rows, 2, n_tiles) scratch; ticket as K2's
//   update        K3 with the flag off: w' = w - u^T V alone
//                 (orth_kernel.py:_update)
//   update_sumsq  K3 with SUMSQ: w' and the (n_blocks,) partials of ||w'||^2
//   update_gram   K3 GRAM: w_out and u2 (m1,) in one launch over the plan of
//                 orth_kernel.py:update_gram_plan (tile, n_tiles, partials'
//                 row stride, grid, dynamic shared bytes; checked here);
//                 partials (rows, stride) scratch, ticket K2's zeroed
//                 counter, left zeroed
#define GMRES_SWEEP_FORM(SFX, TV, TW)                                                          \
  int gmres_basis_gram_##SFX(const TV* V, const TW* w, TW* u, acc_t<TW>* partials,            \
                             unsigned* ticket, int n, int rows, int m1, int tile, int n_tiles,  \
                             int grid, void* stream) {                                          \
    return launch_gram<TV, TW, 1>(V, w, nullptr, u, partials, ticket, n, rows, m1, tile,       \
                                  n_tiles, grid, stream);                                       \
  }                                                                                             \
  int gmres_basis_update_##SFX(const TV* V, const TW* w, const TW* u, TW* w_out, int n,        \
                               int rows, int m1, void* stream) {                                \
    return launch_update<TV, TW, false>(V, w, u, w_out, nullptr, n, rows, m1, stream);         \
  }                                                                                             \
  int gmres_basis_update_sumsq_##SFX(const TV* V, const TW* w, const TW* u, TW* w_out,         \
                                     acc_t<TW>* partials, int n, int rows, int m1,              \
                                     void* stream) {                                            \
    return launch_update<TV, TW, true>(V, w, u, w_out, partials, n, rows, m1, stream);         \
  }
#define GMRES_GRAM2_FORM(SFX, TV, TW)                                                           \
  int gmres_basis_gram2_##SFX(const TV* V, const TW* w0, const TW* w1, TW* u,                  \
                              acc_t<TW>* partials, unsigned* ticket, int n, int rows, int m1,   \
                              int tile, int n_tiles, int grid, void* stream) {                  \
    return launch_gram<TV, TW, 2>(V, w0, w1, u, partials, ticket, n, rows, m1, tile, n_tiles,  \
                                  grid, stream);                                                \
  }
#define GMRES_UPDATE_GRAM_FORM(SFX, TV, TW)                                                     \
  int gmres_basis_update_gram_##SFX(const TV* V, const TW* w, const TW* u, TW* w_out, TW* u2,  \
                                    acc_t<TW>* partials, unsigned* ticket, int n, int rows,     \
                                    int m1, int tile, int n_tiles, int stride, int grid,        \
                                    int smem, void* stream) {                                   \
    return launch_update_gram<TV, TW>(V, w, u, w_out, u2, partials, ticket, n, rows, m1, tile, \
                                      n_tiles, stride, grid, smem, stream);                     \
  }
// K4: suffix the basis dtype, then the iterate's, where y is in the basis
// dtype; else the basis's, y's and the iterate's; n_tiles (tiles of
// kThreads x kAxpyCols columns) and grid as outer_kernel.py:axpy_plan gives
// them (checked here)
#define GMRES_AXPY_FORM(SFX, TV, TY, TX)                                                        \
  int gmres_basis_axpy_##SFX(const TV* V, const TY* y, TX* x, int n, int rows, int n_tiles,    \
                             int grid, void* stream) {                                          \
    return launch_axpy<TV, TY, TX>(V, y, x, n, rows, n_tiles, grid, stream);                    \
  }

extern "C" {

GMRES_SWEEP_FORM(f32, float, float)
GMRES_SWEEP_FORM(f64, double, double)
GMRES_SWEEP_FORM(bf16_f32, bf16, float)
GMRES_SWEEP_FORM(f32_f64, float, double)
GMRES_SWEEP_FORM(bf16_bf16, bf16, bf16)

// the ICWY step feeds K2x2 its vectors in the accumulation dtype
// (gmres_tpu/ops/orth.py:163-164), so a bf16 vector never reaches it
GMRES_GRAM2_FORM(f32, float, float)
GMRES_GRAM2_FORM(f64, double, double)
GMRES_GRAM2_FORM(bf16_f32, bf16, float)
GMRES_GRAM2_FORM(f32_f64, float, double)

GMRES_UPDATE_GRAM_FORM(f32, float, float)
GMRES_UPDATE_GRAM_FORM(bf16_f32, bf16, float)
GMRES_UPDATE_GRAM_FORM(f32_f64, float, double)
GMRES_UPDATE_GRAM_FORM(bf16_bf16, bf16, bf16)

// K3 GRAM in fp64: w_out and the (n_blocks, m1) block partials that the
// wrapper adds; pad: dynamic shared bytes that cap the blocks an SM
int gmres_basis_update_gram_f64(const double* V, const double* w, const double* u,
                                double* w_out, double* partials, int n, int rows, int m1,
                                int pad, void* stream) {
  return launch_update_gram_blocks(V, w, u, w_out, partials, n, rows, m1, pad, stream);
}

GMRES_AXPY_FORM(f32_f64, float, float, double)
GMRES_AXPY_FORM(f64_f64, double, double, double)
GMRES_AXPY_FORM(f32_f32, float, float, float)
GMRES_AXPY_FORM(bf16_f32_f64, bf16, float, double)
GMRES_AXPY_FORM(bf16_f32_f32, bf16, float, float)
GMRES_AXPY_FORM(f32_f64_f64, float, double, double)
GMRES_AXPY_FORM(bf16_bf16_f64, bf16, bf16, double)
GMRES_AXPY_FORM(bf16_bf16_f32, bf16, bf16, float)

// pair mode: the basis as (hi, lo) fp32 pairs, y and x fp64
int gmres_basis_axpy_pair(const float* Vh, const float* Vl, const double* y, double* x, int n,
                          int rows, void* stream) {
  if (bad_shape(n, rows, rows)) return (int)cudaErrorInvalidValue;
  basis_axpy_pair_kernel<<<blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      Vh, Vl, y, x, n, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
