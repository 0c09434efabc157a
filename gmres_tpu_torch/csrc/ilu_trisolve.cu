// K6: exact ILU(0) triangular solves x = U^-1 L^-1 w over DIA factor bands,
// one launch per apply, each row computed once, level by level.
//
// Replaces gmres_tpu/ops/pallas/trisolve_kernel.py:
//   ilu_trisolve_fused (the pallas_call at :213), all nilpotent Jacobi sweeps
//     of both triangles in one launch with the bands and the iterate in VMEM;
//   ilu_trisolve_segmented (the pallas_calls at :155), the same solve one
//     VMEM-sized segment at a time.
// The TPU kernels sweep every row once per dependency level (a VMEM pass is
// cheap there).  Both forms here run one level schedule (built once per
// preconditioner on the host, ops/cuda/trisolve_kernel.py:level_schedule):
// the rows of each triangle in level order, level pointers, and the bands
// (and, for U, D^-1) repacked in the same order, so a level's independent
// values are one contiguous read.
//
// Semantics, the same bits as the sweeps (trisolve_kernel.py:30-36).  L
// phase, level by level from x = w:
//   x[i] = x[i] - sum_d L[d, i] x[i + off_l[d]]
// then U phase, level by level from the L result b':
//   x[i] = D^-1[i] (x[i] - sum_d U[d, i] x[i + off_u[d]])
// with the sum in band order from 0, each product and sum rounded once
// (__fmul_rn/__fadd_rn, as the plain version's torch ops round), and terms
// whose column falls outside [0, n) left out.  At its level a row's inputs
// are final, so it gets exactly the value the last sweep of the old design
// (and of the plain version) leaves in it.  A band's stored zero times a
// finite value (w, b' or a result) adds nothing to the sum, so the schedule
// gives it no neighbour (dep -1) and the kernel skips it: the bits are the
// sweeps' wherever the values are finite (where a value read through a zero
// band is not, the sweeps give NaN in that row).  At a grid's edges the DIA
// bands' stored zeros point at rows of later levels, outside the ring, which
// the kernel would otherwise read from device memory on each level holding
// such an edge row (half of them at convdiff@1M).
//
// What bounds it: latency.  An apply is a chain of dependent levels (2 x 2047
// at convdiff@1M); the bytes (bands + 3 values a row) are 32 MB in fp32.
//
// What the design does about it:
// - Each level is a barrier plus the reads of the neighbours' values.  The
//   grid is sized to the widest level, not to the vector: one block of 1024
//   threads while the widest level fits it (1024 rows at convdiff@1M), with
//   a __syncthreads() barrier and the last kRing results kept in a
//   shared-memory ring, so a neighbour's value is a shared-memory read;
//   else a cooperative grid (grid.sync()), neighbours read from L2
//   (__ldcg).  chip_smoke.py measures the empty barrier of each candidate
//   (one block, a thread-block cluster, a cooperative grid) and the kernel
//   on both forms.  A cluster (cluster.sync()) beat the grid at 2-8 blocks
//   in that table, but no workload has levels wider than one block, so the
//   kernel has no cluster form; the probe keeps its barrier measured.
// - The values live in level order (xl for L, xu for U; the wrapper gathers
//   w into L order, the L phase writes each result to its U position too,
//   the U phase to its row), and the schedule gives each band's neighbour
//   as a position.  So everything a row needs but its neighbours (its own
//   value, D^-1, band values, neighbour positions, where the result goes)
//   is a read at its own position, independent of x, and is staged
//   kSlots - 1 levels ahead with cp.async into the thread's shared-memory
//   slots.  A barrier waits for the loads a thread has outstanding, not for
//   cp.async copies, so the staging stays off the chain.  The level
//   pointers are copied to shared memory once.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace gmres;

namespace {

constexpr int kLevelThreads = 1024;  // threads per block
constexpr int kMaxClusterBlocks = 8; // portable cluster size (the barrier probe)
constexpr int kStageBands = 2;       // bands a row stages in shared memory
constexpr int kSlots = 4;            // staged levels: the current one and 3 ahead
// One block keeps the x values of the last kRing positions in shared
// memory: the previous level's rows while two levels together hold at most
// kRing rows (2 x 1024 at convdiff@1M); older ones come from device memory,
// which holds every value too.
constexpr int kRing = 2048;
constexpr int kMaxSmem = 232448;     // an H100 block's shared memory

// the kernel's two forms; the cluster barrier is measured by the probe only
enum SyncMode { kBlockSync = 0, kGridSync = 1, kClusterProbe = 2 };

// One triangle's schedule, everything in level order (position p)
template <typename T>
struct Triangle {
  const int* ptr;    // (nlev + 1,) level pointers
  const T* bands;    // (nd, n) band values
  const int* dep;    // (nd, n) position of each band's row, -1 outside [0, n) or zero band
  const int* out;    // (n,) where the result goes: L the row's U position, U the row
  const T* invd;     // (n,) D^-1 (U only)
  int nlev, nd;
};

template <typename T>
struct LevelParams {
  Triangle<T> lo, up;
  T* xl;     // (n,) in: w in L order; the L phase's values
  T* xu;     // (n,) the L result b' in U order; the U phase's values
  T* x;      // (n,) out: the solve, in row order
  int n;
  int shared_ptr;  // level pointers copied to shared memory
};

// Shared memory: [slot][thread] staging, the ring, the level pointers
template <typename T>
struct Smem {
  T* own;    // (kSlots, threads) the row's own value (w or b')
  T* invd;   // (kSlots, threads)
  T* band;   // (kSlots, kStageBands, threads)
  int* dep;  // (kSlots, kStageBands, threads)
  int* out;  // (kSlots, threads)
  T* ring;   // (kRing,)
  int* ptr;  // (nlev_l + 1 + nlev_u + 1,)

  __device__ Smem(char* base) {
    own = reinterpret_cast<T*>(base);
    invd = own + kSlots * kLevelThreads;
    band = invd + kSlots * kLevelThreads;
    ring = band + kSlots * kStageBands * kLevelThreads;
    dep = reinterpret_cast<int*>(ring + kRing);
    out = dep + kSlots * kStageBands * kLevelThreads;
    ptr = out + kSlots * kLevelThreads;
  }
};

template <typename T>
constexpr size_t smem_fixed() {
  return (size_t)kSlots * kLevelThreads * (2 + kStageBands) * sizeof(T) + kRing * sizeof(T) +
         (size_t)kSlots * kLevelThreads * (kStageBands + 1) * sizeof(int);
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// values written in one level and read in the next: within one block the
// barrier makes them visible; across blocks they are read from L2
template <int kMode, typename T>
__device__ __forceinline__ T load_x(const T* p) {
  if constexpr (kMode == kBlockSync) return *p;
  else return __ldcg(p);
}

template <int kMode>
__device__ __forceinline__ void level_barrier() {
  if constexpr (kMode == kBlockSync) __syncthreads();
  else if constexpr (kMode == kClusterProbe) cg::this_cluster().sync();
  else cg::this_grid().sync();
}

// One row at position p of level [P[k], P[k+1]): its own value (from the
// staged slot, or loaded), its neighbours' values in band order, and the
// result written to the phase's array, the ring and the output array.
template <int kMode, bool kUpper, typename T>
__device__ __forceinline__ void solve_row(const Triangle<T>& tr, T* xs, T* xo, T* ring,
                                          int lo, int hi, int n, int p, T own, T invd,
                                          const T* band, const int* dep, int out, int stride) {
  const int ring_lo = hi - kRing;
  T acc = T(0);
  for (int d = 0; d < tr.nd; ++d) {
    const bool staged = d < kStageBands;
    const int q = staged ? dep[d * stride] : __ldg(tr.dep + (size_t)d * n + p);
    if (q < 0) continue;
    const T b = staged ? band[d * stride] : __ldg(tr.bands + (size_t)d * n + p);
    T v;
    if (kMode == kBlockSync && q >= ring_lo && q < lo)
      v = ring[q & (kRing - 1)];
    else
      v = load_x<kMode>(xs + q);
    acc = add_rn(acc, mul_rn(b, v));
  }
  const T r = kUpper ? mul_rn(invd, sub_rn(own, acc)) : sub_rn(own, acc);
  xs[p] = r;
  if constexpr (kMode == kBlockSync) ring[p & (kRing - 1)] = r;
  xo[out] = r;
}

// One triangle, level by level, a barrier after every level but the last
// of the launch.  Thread g takes position P[k] + g of level k; what does
// not depend on x (its own value, D^-1, kStageBands band values and their
// positions, where its result goes) is staged kSlots - 1 levels ahead by
// cp.async into the thread's own shared-memory slots.  Rows past the grid's
// threads (a level wider than the grid) load as they go.
template <int kMode, bool kUpper, typename T>
__device__ void run_phase(const Triangle<T>& tr, const int* P, T* xs, T* xo,
                          const Smem<T>& sm, int n, bool last_barrier) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int nb = tr.nd < kStageBands ? tr.nd : kStageBands;
  auto stage = [&](int k) {
    if (k >= tr.nlev) return;
    const int p = P[k] + g;
    if (p >= P[k + 1]) return;
    const int i = (k % kSlots) * kLevelThreads + threadIdx.x;
    cp_async(sm.own + i, xs + p);
    cp_async(sm.out + i, tr.out + p);
    if (kUpper) cp_async(sm.invd + i, tr.invd + p);
    for (int d = 0; d < nb; ++d) {
      const int id = ((k % kSlots) * kStageBands + d) * kLevelThreads + threadIdx.x;
      cp_async(sm.band + id, tr.bands + (size_t)d * n + p);
      cp_async(sm.dep + id, tr.dep + (size_t)d * n + p);
    }
  };
  for (int k = 0; k < kSlots - 1; ++k) {
    stage(k);
    cp_async_commit();
  }
  for (int k = 0; k < tr.nlev; ++k) {
    stage(k + kSlots - 1);  // into the slot level k - 1 used
    cp_async_commit();
    cp_async_wait<kSlots - 1>();  // level k's copies have landed
    const int lo = P[k], hi = P[k + 1];
    if (lo + g < hi) {
      const int s = k % kSlots, i = s * kLevelThreads + threadIdx.x;
      solve_row<kMode, kUpper>(tr, xs, xo, sm.ring, lo, hi, n, lo + g, sm.own[i],
                               kUpper ? sm.invd[i] : T(0),
                               sm.band + s * kStageBands * kLevelThreads + threadIdx.x,
                               sm.dep + s * kStageBands * kLevelThreads + threadIdx.x,
                               sm.out[i], kLevelThreads);
    }
    for (int p = lo + g + nthreads; p < hi; p += nthreads)
      solve_row<kMode, kUpper>(tr, xs, xo, sm.ring, lo, hi, n, p, load_x<kMode>(xs + p),
                               kUpper ? __ldg(tr.invd + p) : T(0), tr.bands + p, tr.dep + p,
                               __ldg(tr.out + p), n);
    if (k + 1 < tr.nlev || last_barrier) level_barrier<kMode>();
  }
  cp_async_wait<0>();
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kLevelThreads) ilu_levels_kernel(LevelParams<T> a) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem<T> sm(smem_raw);
  const int* Pl = a.lo.ptr;
  const int* Pu = a.up.ptr;
  if (a.shared_ptr) {
    for (int k = threadIdx.x; k <= a.lo.nlev; k += blockDim.x) sm.ptr[k] = a.lo.ptr[k];
    int* su = sm.ptr + a.lo.nlev + 1;
    for (int k = threadIdx.x; k <= a.up.nlev; k += blockDim.x) su[k] = a.up.ptr[k];
    __syncthreads();
    Pl = sm.ptr;
    Pu = su;
  }
  // L phase in L order (xl), each result also to its U position (xu); then
  // the U phase in U order (xu), each result to its row (x)
  run_phase<kMode, false>(a.lo, Pl, a.xl, a.xu, sm, a.n, true);
  run_phase<kMode, true>(a.up, Pu, a.xu, a.x, sm, a.n, false);
}

template <int kMode>
__global__ void __launch_bounds__(kLevelThreads) level_sync_probe_kernel(int syncs) {
  for (int i = 0; i < syncs; ++i) level_barrier<kMode>();
}

// Launch `args` in sync mode `mode`: block_fn on one block, or grid_fn as
// a cooperative grid of *blocks blocks of kLevelThreads (cut to the resident
// blocks; the grid used is left in *blocks).
template <typename... Args>
int launch_mode(void (*block_fn)(Args...), void (*grid_fn)(Args...), int mode, int* blocks,
                size_t smem, void* stream, Args... args) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kBlockSync) {
    if (*blocks != 1) return (int)cudaErrorInvalidValue;
    block_fn<<<1, kLevelThreads, smem, s>>>(args...);
    return (int)cudaGetLastError();
  }
  if (mode != kGridSync || *blocks < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_fn, kLevelThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (*blocks > per_sm * sms) *blocks = per_sm * sms;
  void* argv[] = {(void*)&args...};
  err = cudaLaunchCooperativeKernel((const void*)grid_fn, dim3(*blocks), dim3(kLevelThreads),
                                    argv, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
bool fill_triangle(Triangle<T>& tr, const int* ptr, const T* bands, const int* dep,
                   const int* out, const T* invd, int nlev, int nd, int n) {
  if (nlev < 1 || nlev > n || nd < 0) return false;
  tr.ptr = ptr;
  tr.bands = bands;
  tr.dep = dep;
  tr.out = out;
  tr.invd = invd;
  tr.nlev = nlev;
  tr.nd = nd;
  return true;
}

template <typename T>
int launch_levels(const int* ptr_l, const T* bands_l, const int* dep_l, const int* upos_l,
                  int nlev_l, int d_l, const int* ptr_u, const T* bands_u, const int* dep_u,
                  const int* rows_u, const T* invd_u, int nlev_u, int d_u, T* xl, T* xu, T* x,
                  int n, int mode, int* blocks, void* stream) {
  LevelParams<T> a;
  if (n <= 0 ||
      !fill_triangle(a.lo, ptr_l, bands_l, dep_l, upos_l, (const T*)nullptr, nlev_l, d_l, n) ||
      !fill_triangle(a.up, ptr_u, bands_u, dep_u, rows_u, invd_u, nlev_u, d_u, n))
    return (int)cudaErrorInvalidValue;
  a.xl = xl;
  a.xu = xu;
  a.x = x;
  a.n = n;
  const size_t ptr_bytes = (size_t)(nlev_l + 1 + nlev_u + 1) * sizeof(int);
  a.shared_ptr = smem_fixed<T>() + ptr_bytes <= (size_t)kMaxSmem;
  const size_t smem = smem_fixed<T>() + (a.shared_ptr ? ptr_bytes : 0);
  void (*fns[2])(LevelParams<T>) = {ilu_levels_kernel<T, kBlockSync>,
                                    ilu_levels_kernel<T, kGridSync>};
  if (mode != kBlockSync && mode != kGridSync) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)fns[mode],
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return launch_mode(fns[0], fns[1], mode, blocks, smem, stream, a);
}

}  // namespace

extern "C" {

// K6 over the level schedule of both triangles (ops/cuda/
// trisolve_kernel.py:LevelSchedule): xl holds w in L order (and is
// overwritten), xu is scratch, x receives the solve in row order; mode 0
// one block, 1 a cooperative grid of *blocks blocks (the grid used is left
// in *blocks)
int gmres_ilu_levels_f32(const int* ptr_l, const float* bands_l, const int* dep_l,
                         const int* upos_l, int nlev_l, int d_l, const int* ptr_u,
                         const float* bands_u, const int* dep_u, const int* rows_u,
                         const float* invd_u, int nlev_u, int d_u, float* xl, float* xu,
                         float* x, int n, int mode, int* blocks, void* stream) {
  return launch_levels<float>(ptr_l, bands_l, dep_l, upos_l, nlev_l, d_l, ptr_u, bands_u, dep_u,
                              rows_u, invd_u, nlev_u, d_u, xl, xu, x, n, mode, blocks, stream);
}

int gmres_ilu_levels_f64(const int* ptr_l, const double* bands_l, const int* dep_l,
                         const int* upos_l, int nlev_l, int d_l, const int* ptr_u,
                         const double* bands_u, const int* dep_u, const int* rows_u,
                         const double* invd_u, int nlev_u, int d_u, double* xl, double* xu,
                         double* x, int n, int mode, int* blocks, void* stream) {
  return launch_levels<double>(ptr_l, bands_l, dep_l, upos_l, nlev_l, d_l, ptr_u, bands_u,
                               dep_u, rows_u, invd_u, nlev_u, d_u, xl, xu, x, n, mode, blocks,
                               stream);
}

// `syncs` barriers of sync mode `mode` on `blocks` blocks of kLevelThreads
// and nothing else: one empty barrier of each candidate for K6's levels
// (mode 0 one block, 1 a cooperative grid, 2 a thread-block cluster)
int gmres_level_sync_probe(int mode, int blocks, int syncs, int* blocks_out, void* stream) {
  if (syncs < 0) return (int)cudaErrorInvalidValue;
  *blocks_out = blocks;
  if (mode != kClusterProbe)
    return launch_mode(level_sync_probe_kernel<kBlockSync>, level_sync_probe_kernel<kGridSync>,
                       mode, blocks_out, 0, stream, syncs);
  if (blocks < 1 || blocks > kMaxClusterBlocks) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kLevelThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, level_sync_probe_kernel<kClusterProbe>, syncs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
