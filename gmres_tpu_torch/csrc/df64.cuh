// Double-float (two-fp32) arithmetic for the df64 kernels (df64_spmv.cu,
// df64_sweep.cu): the error-free transforms of
// gmres_tpu/ops/pallas/df64_kernel.py:64-99, operation for operation as
// gmres_tpu_torch/ops/eft.py computes them.
//
// nvcc contracts a * b + c into one fused multiply-add by default, which
// would round once where the plain PyTorch version rounds twice and change
// the low word.  So every add and multiply of a chain is an explicit
// round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn), which the
// compiler never contracts.  two_prod is the one exception: its error term
// is the exact a * b - p, which __fmaf_rn gives in one instruction and the
// plain version's Veltkamp split gives in seven; both are exact, so both
// give the same pair.  No --use_fast_math: denormals are kept.
#pragma once

#include "common.cuh"

namespace gmres {

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// requires |a| >= |b|
__device__ __forceinline__ void quick_two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

// (h, l) = (ah, al) * (bh, bl); the inputs are copies, so the outputs may
// alias them
__device__ __forceinline__ void df_mul(float ah, float al, float bh, float bl, float& h,
                                       float& l) {
  float p, e;
  two_prod(ah, bh, p, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(ah, bl), __fmul_rn(al, bh)));
  quick_two_sum(p, e, h, l);
}

// (h, l) = (ah, al) + (bh, bl)
__device__ __forceinline__ void df_add(float ah, float al, float bh, float bl, float& h,
                                       float& l) {
  float s, e;
  two_sum(ah, bh, s, e);
  e = __fadd_rn(__fadd_rn(e, al), bl);
  quick_two_sum(s, e, h, l);
}

// Pair sum over the warp by a fixed shuffle tree; the result is valid in
// lane 0.
__device__ __forceinline__ void warp_df_sum(float& h, float& l) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float oh = __shfl_down_sync(0xffffffffu, h, s);
    const float ol = __shfl_down_sync(0xffffffffu, l, s);
    df_add(h, l, oh, ol, h, l);
  }
}

// The fp64 value of a pair (gmres_tpu/ops/pallas/df64_kernel.py:merge_f64).
__device__ __forceinline__ double merge_f64(float h, float l) {
  return __dadd_rn((double)h, (double)l);
}

// An fp64 value as a pair (split_f64): hi rounded to fp32, lo the rounded
// remainder (the subtraction is exact).
__device__ __forceinline__ void split_f64(double x, float& h, float& l) {
  h = __double2float_rn(x);
  l = __double2float_rn(__dsub_rn(x, (double)h));
}

}  // namespace gmres
