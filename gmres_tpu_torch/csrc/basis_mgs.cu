// K7 basis_mgs: the whole modified Gram-Schmidt recurrence of one Arnoldi
// step in one cooperative launch,
//
//   for j < rows:  h_j = <w, v_j>;  w <- w - h_j v_j;      then ||w||^2,
//
// over the row-stored Krylov basis V (m+1, n).  Replaces
// gmres_tpu/ops/pallas/orth_kernel.py:_mgs (the pallas_call at :381, kernel
// _mgs_kernel :290-365).  The operation order is the reference's
// (Orthogonalization.hpp:91-107): h_j from the already updated w, then
// w - h_j v_j.  Sums are taken in acc_t<TW> (common.cuh): fp32 for the mixed
// inner loop, fp64 for the baseline (the TPU kernel was fp32-only).
//
// Dtype forms (TV the basis, TW w and the outputs): (f32, f32), (f64, f64),
// and for the compressed basis and the bf16 inner tier (bf16, f32), (f32,
// f64) and (bf16, bf16).  As in the TPU kernel, h_j and w's update run in
// the accumulation dtype; under a bf16 w, w is rounded to bf16 after every
// row (its VMEM copy is stored in w's dtype, orth_kernel.py:353), so the
// next h_j and ||w'||^2 read the rounded w; h and ||w'|| are rounded to TW
// when written.
//
// What bounds it: each h_j is a reduction over all n columns, and the next
// row's update needs it, so a step is `rows` dependent grid-wide exchanges;
// besides, it must read V's first `rows` rows once, w once and write w'
// once: (rows + 2) n s bytes.  The TPU kernel kept w in VMEM across a
// sequential grid and streamed one basis row per step; Hopper's blocks run
// in parallel and in no order.
//
// What the design does about it:
// - One cooperative launch per Arnoldi step, on a persistent grid no larger
//   than the resident block count (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//   optionally capped per SM by the caller), so every block is resident and
//   may wait for the others.  A refused launch returns its error.
// - Columns are cut into fixed tiles of kTile and the tiles into fixed
//   groups of `group` tiles (the smallest power of two, at most kMaxTiles,
//   that leaves at most kMgsSlots groups): both depend on n only.  Block b
//   owns TILES / group whole groups, tiles [b*TILES, (b+1)*TILES), and each
//   thread keeps its TILES*kItems values of w and of the current basis row
//   in registers for the whole recurrence, so V is read once and w never
//   leaves the chip.
// - Per row, each group's partial of <w, v_j> is a fixed tree: each
//   thread's fused multiply-adds over the group's tiles and items in order
//   from 0, a warp-shuffle tree, the warps in order.  It is published in its
//   own slot of row j as 64-bit words that carry 32 bits of the value and a
//   32-bit tag (the launch's epoch and j), each stored and loaded whole
//   (relaxed, device scope), so a reader that sees the tag sees the value.
//   Every thread of every block then reads its share of the row's slots
//   (all in flight at once), adds its slots in order, a warp tree and the
//   warps in order: every block gets the same bits of h_j from one read of
//   256 slots at most, where the old design's blocks each added 1024 tile
//   partials with a block-wide tree.  Neither the groups nor their trees
//   depend on the grid, so the result is the same at every grid size.  No
//   atomics on values.
// - Two ways to wait for a row's slots, the same bits either way: kSync, a
//   grid.sync() after publishing; kPoll, no barrier: each block reads the
//   slots again (backing off 100 ns) until every tag is the row's, so a
//   block goes on one L2 round trip after the last partial lands.  The
//   wrapper picks one per dtype (mgs_kernel.py: EXCHANGE).  A poll past
//   kMaxSpins reads traps rather than hang.
// - ||w'||^2 is one more row of slots; block 0 adds it and writes ||w'||
//   after h, so a step is one launch.
// - Row j+1 does not depend on h_j: its loads are issued before row j's
//   exchange and overlap it.
// - Where the resident grid cannot hold n in registers (more than
//   kMaxTiles tiles per block), or when the caller forbids registers, the
//   same recurrence runs with w kept in w_out (L2) and two basis rows read
//   per pass, the groups taken grid-stride: the same groups, trees and
//   operations, so the same bits, at about twice the traffic.
//   mgs_kernel.py:mgs_groups holds the grouping for the CPU tests.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace gmres;

namespace {

constexpr int kMaxTiles = 8;        // tiles per block held in registers
constexpr int kMgsSlots = 256;      // most groups whose slots one poll reads
constexpr unsigned kMaxSpins = 1u << 24;

template <typename T>
__host__ __device__ constexpr int slot_words() { return sizeof(T) == 4 ? 1 : 2; }

// publish a group partial of row j in its slot: (tag << 32 | 32 value bits)
// words, each stored whole (relaxed, device scope)
__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <typename T>
__device__ __forceinline__ void publish(unsigned long long* slot, T v, unsigned tag) {
  const unsigned long long t = (unsigned long long)tag << 32;
  if constexpr (sizeof(T) == 4) {
    store_word(slot, t | __float_as_uint(v));
  } else {
    const unsigned long long bits = (unsigned long long)__double_as_longlong(v);
    store_word(slot, t | (bits >> 32));
    store_word(slot + 1, t | (bits & 0xffffffffull));
  }
}

// one read of a slot: its value, and whether every word carries `tag`
template <typename T>
__device__ __forceinline__ bool read_slot(const unsigned long long* slot, unsigned tag, T* v) {
  if constexpr (sizeof(T) == 4) {
    const unsigned long long a = load_word(slot);
    *v = __uint_as_float((unsigned)a);
    return (unsigned)(a >> 32) == tag;
  } else {
    const unsigned long long a = load_word(slot), b = load_word(slot + 1);
    *v = __longlong_as_double((long long)((a << 32) | (b & 0xffffffffull)));
    return (unsigned)(a >> 32) == tag && (unsigned)(b >> 32) == tag;
  }
}

// the sum of a row's n_groups slots: thread x reads slots x, x + kThreads,
// ... in order (a whole pass of them in flight, polled until every tag is
// the row's), then a warp tree and the warps in order (`scratch` holds
// kWarps values; every thread of the block returns the same bits)
template <typename T>
__device__ __forceinline__ T sum_row(const unsigned long long* row, int n_groups, unsigned tag,
                                     T* scratch) {
  constexpr int W = slot_words<T>();
  T s = T(0);
  for (int base = 0; base < n_groups; base += kThreads) {
    const int g = base + (int)threadIdx.x;
    T v = T(0);
    unsigned spins = 0;
    for (;;) {
      const bool ok = g >= n_groups || read_slot(row + (size_t)g * W, tag, &v);
      if (__syncthreads_and(ok)) break;
      if (++spins == kMaxSpins) __trap();
      __nanosleep(100);
    }
    s += g < n_groups ? v : T(0);
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
  __syncthreads();
  T h = T(0);
#pragma unroll
  for (int q = 0; q < kWarps; ++q) h += scratch[q];
  return h;  // scratch is written again only after the next row's barriers
}

// Exchange modes of a row's partials: kSync waits at a grid.sync() for every
// block to have published (the reads then find every tag), kPoll lets each
// block read as soon as the slots carry the row's tags
constexpr int kSync = 0, kPoll = 1;

__device__ __forceinline__ void exchange_barrier(int exchange) {
  if (exchange == kSync) cg::this_grid().sync();
}

template <typename T, typename TA>
__device__ __forceinline__ void store_tile(T* dst, size_t col0, int n, const TA (&v)[kItems]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const size_t c = col0 + (size_t)it * kThreads;
    if (c < (size_t)n) dst[c] = down<T>(v[it]);
  }
}

// load_tile of stored values, not widened (a bf16 zero past n)
template <typename T>
__device__ __forceinline__ void load_tile_raw(const T* __restrict__ src, size_t col0, int n,
                                              T (&v)[kItems]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const size_t c = col0 + (size_t)it * kThreads;
    if constexpr (std::is_same_v<T, bf16>)
      v[it] = c < (size_t)n ? src[c] : __ushort_as_bfloat16(0);
    else
      v[it] = c < (size_t)n ? src[c] : T(0);
  }
}

// a tile of w_out that this thread wrote earlier in the launch, read
// through L2 (a bf16 tile through the same path, two bytes at a time)
template <typename T, typename TA>
__device__ __forceinline__ void load_tile_l2(const T* src, size_t col0, int n,
                                             TA (&v)[kItems]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const size_t c = col0 + (size_t)it * kThreads;
    if constexpr (std::is_same_v<T, bf16>)
      v[it] = c < (size_t)n ? up<TA>(__ushort_as_bfloat16(
                                  __ldcg(reinterpret_cast<const unsigned short*>(src) + c)))
                            : TA(0);
    else
      v[it] = c < (size_t)n ? (TA)__ldcg(src + c) : TA(0);
  }
}

// red[k * kWarps + warp] holds warp `warp`'s share of the block's k-th
// group; thread k < groups adds the shares in warp order and returns it
template <typename T>
__device__ __forceinline__ T finish_group(const T* red) {
  T s = T(0);
#pragma unroll
  for (int q = 0; q < kWarps; ++q) s += red[threadIdx.x * kWarps + q];
  return s;
}

template <typename T>
__device__ __forceinline__ void write_h_tail(T* h, int rows, int m1) {
  if (blockIdx.x != 0) return;
  for (int i = rows + threadIdx.x; i < m1; i += kThreads) h[i] = down<T>(0.0f);
}

// w and the current basis row in registers (in the accumulation dtype):
// TILES tiles (TILES / group whole groups) per block
template <typename TV, typename TW, int TILES>
__global__ void __launch_bounds__(kThreads)
basis_mgs_kernel(const TV* __restrict__ V, const TW* __restrict__ w, TW* __restrict__ w_out,
                 TW* __restrict__ h, unsigned long long* slots, int n, int rows, int m1,
                 int group, int n_groups, unsigned tag0, int exchange) {
  using T = acc_t<TW>;
  constexpr int W = slot_words<T>();
  __shared__ T red[TILES * kWarps];
  __shared__ T scratch[kWarps];
  const int warp = threadIdx.x >> 5;
  const int tile0 = blockIdx.x * TILES;
  const int group0 = tile0 / group, groups = TILES / group;
  const bool publisher = (int)threadIdx.x < groups && group0 + (int)threadIdx.x < n_groups;
  T wv[TILES][kItems], vc[TILES][kItems];
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const size_t col0 = (size_t)(tile0 + t) * kTile + threadIdx.x;
    load_tile_as(w, col0, n, wv[t]);
    load_tile_as(V, col0, n, vc[t]);
  }
  for (int j = 0; j < rows; ++j) {
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) acc = fmadd(wv[t][it], vc[t][it], acc);
      if ((t + 1) % group == 0) {
        acc = warp_sum(acc);
        if ((threadIdx.x & 31) == 0) red[(t / group) * kWarps + warp] = acc;
        acc = T(0);
      }
    }
    // the next row stays in the basis dtype until it is used: widened at
    // its load, a bf16 or fp32 row would stall the thread on the load
    // before the row's exchange instead of during it
    TV vn[TILES][kItems];
    const bool more = j + 1 < rows;
    if (more) {
      const TV* next = V + (size_t)(j + 1) * n;
#pragma unroll
      for (int t = 0; t < TILES; ++t)
        load_tile_raw(next, (size_t)(tile0 + t) * kTile + threadIdx.x, n, vn[t]);
    }
    __syncthreads();
    unsigned long long* row = slots + (size_t)j * n_groups * W;
    if (publisher)
      publish(row + (size_t)(group0 + threadIdx.x) * W, finish_group(red), tag0 + j);
    exchange_barrier(exchange);
    const T hj = sum_row<T>(row, n_groups, tag0 + j, scratch);
    if (blockIdx.x == 0 && threadIdx.x == 0) h[j] = down<TW>(hj);
    const T nh = -hj;
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
#pragma unroll
      for (int it = 0; it < kItems; ++it)
        wv[t][it] = rounded<TW>(fmadd(nh, vc[t][it], wv[t][it]));
    }
    if (more) {
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
#pragma unroll
        for (int it = 0; it < kItems; ++it) vc[t][it] = up<T>(vn[t][it]);
      }
    }
  }
  // out-of-range columns hold w = 0 and add nothing to the sum of squares
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) acc = fmadd(wv[t][it], wv[t][it], acc);
    if ((t + 1) % group == 0) {
      acc = warp_sum(acc);
      if ((threadIdx.x & 31) == 0) red[(t / group) * kWarps + warp] = acc;
      acc = T(0);
    }
    store_tile(w_out, (size_t)(tile0 + t) * kTile + threadIdx.x, n, wv[t]);
  }
  __syncthreads();
  // ||w'||^2 is row `rows` of the slots; block 0 adds it and writes its root
  // after h
  unsigned long long* row = slots + (size_t)rows * n_groups * W;
  if (publisher)
    publish(row + (size_t)(group0 + threadIdx.x) * W, finish_group(red), tag0 + rows);
  exchange_barrier(exchange);
  if (blockIdx.x != 0) return;
  const T ss = sum_row<T>(row, n_groups, tag0 + rows, scratch);
  if (threadIdx.x == 0) h[m1] = down<TW>(sqrt(ss));
  write_h_tail(h, rows, m1);
}

// w in w_out (in TW, so a bf16 w is rounded at every store, as the
// registers form rounds it): groups grid-stride, pass j applies h_{j-1}
// v_{j-1} and takes the partials of <w, v_j> (pass `rows`: of ||w||^2)
template <typename TV, typename TW>
__global__ void __launch_bounds__(kThreads)
basis_mgs_global_kernel(const TV* __restrict__ V, const TW* __restrict__ w, TW* w_out,
                        TW* __restrict__ h, unsigned long long* slots, int n, int rows, int m1,
                        int group, int n_groups, unsigned tag0, int exchange) {
  using T = acc_t<TW>;
  constexpr int W = slot_words<T>();
  __shared__ T red[kWarps];
  __shared__ T scratch[kWarps];
  const int warp = threadIdx.x >> 5;
  T hp = T(0);  // h_{j-1}
  for (int j = 0; j <= rows; ++j) {
    for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
      T acc = T(0);
      for (int tile = g * group; tile < (g + 1) * group; ++tile) {
        const size_t col0 = (size_t)tile * kTile + threadIdx.x;
        T wv[kItems];
        if (j == 0) {
          load_tile_as(w, col0, n, wv);
        } else {
          T vp[kItems];
          load_tile_l2(w_out, col0, n, wv);
          load_tile_as(V + (size_t)(j - 1) * n, col0, n, vp);
          const T nh = -hp;
#pragma unroll
          for (int it = 0; it < kItems; ++it) wv[it] = rounded<TW>(fmadd(nh, vp[it], wv[it]));
        }
        store_tile(w_out, col0, n, wv);
        T vj[kItems];
        if (j < rows) load_tile_as(V + (size_t)j * n, col0, n, vj);
#pragma unroll
        for (int it = 0; it < kItems; ++it) acc = fmadd(wv[it], j < rows ? vj[it] : wv[it], acc);
      }
      acc = warp_sum(acc);
      if ((threadIdx.x & 31) == 0) red[warp] = acc;
      __syncthreads();
      if (threadIdx.x == 0) publish(slots + ((size_t)j * n_groups + g) * W, finish_group(red),
                                    tag0 + j);
      __syncthreads();
    }
    exchange_barrier(exchange);
    if (j < rows || blockIdx.x == 0)
      hp = sum_row<T>(slots + (size_t)j * n_groups * W, n_groups, tag0 + j, scratch);
    if (blockIdx.x == 0 && threadIdx.x == 0) h[j < rows ? j : m1] = down<TW>(j < rows ? hp : sqrt(hp));
  }
  write_h_tail(h, rows, m1);
}

template <typename TV, typename TW, int TILES>
const void* mgs_kernel() {
  if constexpr (TILES == 0)
    return (const void*)basis_mgs_global_kernel<TV, TW>;
  else
    return (const void*)basis_mgs_kernel<TV, TW, TILES>;
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

// tiles per group: the smallest power of two (at most kMaxTiles) that leaves
// at most kMgsSlots groups (mgs_kernel.py:mgs_groups)
static int mgs_group(int n_tiles) {
  int g = 1;
  while (g < kMaxTiles && blocks_for(n_tiles, g) > kMgsSlots) g *= 2;
  return g;
}

// Plan (the smallest register tiling of whole groups whose grid is resident
// under the per-SM cap, else without it, else the L2 form) and launch.
// slots: (rows + 1, n_groups) slots of slot_words<acc_t<TW>>() 64-bit
// words, whose tags never equal this launch's (tag0 + j, j <= rows)
template <typename TV, typename TW>
int launch_mgs(const TV* V, const TW* w, TW* w_out, TW* h, unsigned long long* slots, int n,
               int rows, int m1, int group, int n_groups, unsigned tag0, int per_sm,
               int max_tiles, int exchange, int* blocks_out, int* tiles_out, void* stream) {
  if (n <= 0 || rows <= 0 || rows > m1 || m1 > kMaxRows || per_sm < 0 || max_tiles < 0 ||
      (exchange != kSync && exchange != kPoll))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = blocks_for(n, kTile);
  if (group != mgs_group(n_tiles) || n_groups != blocks_for(n_tiles, group))
    return (int)cudaErrorInvalidValue;
  const void* fns[] = {mgs_kernel<TV, TW, 1>(), mgs_kernel<TV, TW, 2>(),
                       mgs_kernel<TV, TW, 4>(), mgs_kernel<TV, TW, kMaxTiles>()};
  const int tiling[] = {1, 2, 4, kMaxTiles};
  const void* fn = nullptr;
  int tiles = 0, blocks = 0, cap = 0;
  cudaError_t err;
  // the per-SM cap first; past its register capacity, every resident block
  for (int pass = 0; pass < 2 && fn == nullptr; ++pass) {
    const int cap_sm = pass == 0 ? per_sm : 0;
    if (pass == 1 && per_sm == 0) break;
    for (int i = 0; i < 4 && tiling[i] <= max_tiles; ++i) {
      if (tiling[i] < group) continue;
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
    fn = mgs_kernel<TV, TW, 0>();
    if ((err = resident_blocks(fn, per_sm, &cap)) != cudaSuccess) return (int)err;
    blocks = cap < n_groups ? cap : n_groups;
  }
  if (blocks <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks_out = blocks;
  *tiles_out = tiles;
  void* args[] = {(void*)&V,  (void*)&w,    (void*)&w_out, (void*)&h,
                  (void*)&slots, (void*)&n, (void*)&rows,
                  (void*)&m1, (void*)&group, (void*)&n_groups, (void*)&tag0, (void*)&exchange};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `syncs` grid-wide barriers and nothing else: the time of one barrier of a
// cooperative grid of this many blocks (K6's old design's floor; what a row
// of K7 cost before its slots)
__global__ void __launch_bounds__(kThreads) grid_sync_probe_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}

}  // namespace

// K7: h (m1,), then ||w'|| at h[m1], and w_out in one launch; slots the
// (rows + 1, n_groups) tagged slots (mgs_kernel.py keeps them a card),
// group/n_groups from mgs_groups (checked here), tag0 the launch's tag.
// Suffixed by the basis dtype and w's (one name where both are the same).
#define GMRES_MGS_FORM(SFX, TV, TW)                                                             \
  int gmres_basis_mgs_##SFX(const TV* V, const TW* w, TW* w_out, TW* h,                        \
                            unsigned long long* slots, int n, int rows, int m1, int group,     \
                            int n_groups, unsigned tag0, int per_sm, int max_tiles,            \
                            int exchange, int* blocks, int* tiles, void* stream) {             \
    return launch_mgs<TV, TW>(V, w, w_out, h, slots, n, rows, m1, group, n_groups, tag0,       \
                              per_sm, max_tiles, exchange, blocks, tiles, stream);             \
  }

extern "C" {

GMRES_MGS_FORM(f32, float, float)
GMRES_MGS_FORM(f64, double, double)
GMRES_MGS_FORM(bf16_f32, bf16, float)
GMRES_MGS_FORM(f32_f64, float, double)
GMRES_MGS_FORM(bf16_bf16, bf16, bf16)

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
