// K6: exact ILU(0) triangular solves x = U^-1 L^-1 w over DIA factor bands,
// fused (the whole vector at once) or segmented (one segment at a time).
//
// Replaces gmres_tpu/ops/pallas/trisolve_kernel.py:
//   ilu_trisolve_fused (the pallas_call at :213), all nilpotent Jacobi sweeps
//     of both triangles in one launch with the bands and the iterate in VMEM;
//   ilu_trisolve_segmented (the pallas_calls at :155), the same solve one
//     VMEM-sized segment at a time, a band-width halo carrying the already
//     final rows of the neighbour segment.
// Semantics (trisolve_kernel.py:30-36): the L phase runs steps_l sweeps
// x <- w - L_s x from x = w; the U phase steps_u sweeps x <- D^-1 (b' - U_s x)
// from x = b', the L result.  steps is the triangle's dependency-level count
// (for a segment: its intra-segment count), at which the sweeps reach the
// exact substitution.
//
// What bounds it: latency.  An apply is a chain of ~levels dependent sweeps
// (2 x 2047 at convdiff@1M), each a pass of (D + 3) values per row, so the
// per-sweep cost is a grid-wide barrier plus one pass over vectors that
// stay in the 50 MB L2 when the working set fits it.
//
// What the design does about it: one cooperative launch per apply (no
// host round trip per sweep, the round-1 landmine the TPU kernel escaped):
// a persistent grid of (blocks resident per SM) x (SMs), rows visited
// grid-stride, grid.sync() between sweeps.  Sweeps update x in place: a row
// whose level is below the sweep count is recomputed from exact inputs in
// the same band order, so it gets the same bits whether a neighbour's value
// was read before or after that neighbour's update in the same sweep, and
// after `steps` barrier-separated sweeps every row is exact, as with the
// double-buffered Jacobi sweep of the TPU kernel.  x and b' are read with
// __ldcg (L2, not the SM's L1), since other blocks write them within the
// launch.  The segmented form needs no halo copy: the output lives in
// device memory, so segment c's L sweeps read the final rows of segment
// c-1 (and its U sweeps those of c+1) in place; it is the fused sweep
// restricted to rows [a, b) with a step count per segment, one launch for
// all segments.  Reads outside [0, n) count as 0, as the TPU kernel's
// zero-filled halo does.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace gmres;

namespace {

constexpr int kMaxTriDiags = 64;  // bands per triangle
constexpr int kMaxSegs = 256;     // segments of the segmented form

// Passed by value (2.6 KB of the 4 KB parameter space): offsets and the
// per-segment sweep counts reach every thread through the constant cache.
struct TriParams {
  int n;      // rows of the factors (band width)
  int seg;    // rows per segment; the last one may be partial
  int n_seg;
  int d_l, d_u;
  int off_l[kMaxTriDiags];
  int off_u[kMaxTriDiags];
  int steps_l[kMaxSegs];
  int steps_u[kMaxSegs];
};

// sum_d bands[d, i] * x[i + offs[d]], in band order (the TPU kernel's)
template <typename T>
__device__ __forceinline__ T band_sum(const T* __restrict__ bands, const int* offs,
                                      int n_diags, const T* x, int i, int n) {
  T acc = T(0);
  for (int d = 0; d < n_diags; ++d) {
    const int j = i + offs[d];
    if (j >= 0 && j < n) acc += bands[(size_t)d * n + i] * __ldcg(x + j);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ilu_trisolve_kernel(const T* __restrict__ ld, const T* __restrict__ ud,
                    const T* __restrict__ invd, const T* __restrict__ w, T* x,
                    T* b2, TriParams p) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int n = p.n;

  // L phase: x = w, then per segment in forward order its sweeps
  for (int i = first; i < n; i += stride) x[i] = w[i];
  if (p.d_l > 0) {
    for (int c = 0; c < p.n_seg; ++c) {
      const int a = c * p.seg, b = min(a + p.seg, n);
      for (int t = 0; t < p.steps_l[c]; ++t) {
        grid.sync();
        for (int i = a + first; i < b; i += stride)
          x[i] = w[i] - band_sum(ld, p.off_l, p.d_l, x, i, n);
      }
    }
  }
  grid.sync();
  // U phase: b' = x (x already holds x0 = b'), then per segment in reverse
  // order its sweeps
  if (p.d_u == 0) {
    for (int i = first; i < n; i += stride) x[i] = invd[i] * __ldcg(x + i);
    return;
  }
  for (int i = first; i < n; i += stride) b2[i] = __ldcg(x + i);
  for (int c = p.n_seg - 1; c >= 0; --c) {
    const int a = c * p.seg, b = min(a + p.seg, n);
    for (int t = 0; t < p.steps_u[c]; ++t) {
      grid.sync();
      for (int i = a + first; i < b; i += stride)
        x[i] = invd[i] * (__ldcg(b2 + i) - band_sum(ud, p.off_u, p.d_u, x, i, n));
    }
  }
}

template <typename T>
int launch_trisolve(const T* ld, const T* ud, const T* invd, const T* w, T* x, T* b2,
                    int n, int d_l, const int* offs_l, int d_u, const int* offs_u,
                    int seg, int n_seg, const int* steps_l, const int* steps_u,
                    int* blocks_out, void* stream) {
  if (n <= 0 || seg <= 0 || n_seg <= 0 || n_seg > kMaxSegs ||
      (long long)seg * n_seg < n || (long long)seg * (n_seg - 1) >= n || d_l < 0 ||
      d_l > kMaxTriDiags || d_u < 0 || d_u > kMaxTriDiags)
    return (int)cudaErrorInvalidValue;
  TriParams p;
  p.n = n;
  p.seg = seg;
  p.n_seg = n_seg;
  p.d_l = d_l;
  p.d_u = d_u;
  for (int d = 0; d < d_l; ++d) p.off_l[d] = offs_l[d];
  for (int d = 0; d < d_u; ++d) p.off_u[d] = offs_u[d];
  for (int c = 0; c < n_seg; ++c) {
    p.steps_l[c] = steps_l[c];
    p.steps_u[c] = steps_u[c];
  }
  // a persistent grid: as many blocks as can be resident at once, and no
  // more than the rows of a segment (and so of the vector) need
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ilu_trisolve_kernel<T>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  int blocks = per_sm * sms;
  const int need = blocks_for(n < seg ? n : seg, kThreads);
  if (need < blocks) blocks = need;
  *blocks_out = blocks;
  void* args[] = {(void*)&ld, (void*)&ud, (void*)&invd, (void*)&w,
                  (void*)&x,  (void*)&b2, (void*)&p};
  err = cudaLaunchCooperativeKernel((const void*)ilu_trisolve_kernel<T>, dim3(blocks),
                                    dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gmres_ilu_trisolve_f32(const float* ld, const float* ud, const float* invd,
                           const float* w, float* x, float* b2, int n, int d_l,
                           const int* offs_l, int d_u, const int* offs_u, int seg,
                           int n_seg, const int* steps_l, const int* steps_u,
                           int* blocks, void* stream) {
  return launch_trisolve<float>(ld, ud, invd, w, x, b2, n, d_l, offs_l, d_u, offs_u, seg,
                                n_seg, steps_l, steps_u, blocks, stream);
}

int gmres_ilu_trisolve_f64(const double* ld, const double* ud, const double* invd,
                           const double* w, double* x, double* b2, int n, int d_l,
                           const int* offs_l, int d_u, const int* offs_u, int seg,
                           int n_seg, const int* steps_l, const int* steps_u,
                           int* blocks, void* stream) {
  return launch_trisolve<double>(ld, ud, invd, w, x, b2, n, d_l, offs_l, d_u, offs_u, seg,
                                 n_seg, steps_l, steps_u, blocks, stream);
}

}  // extern "C"
