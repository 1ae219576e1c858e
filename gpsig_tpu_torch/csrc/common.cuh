// Device math shared by the inducing-covariance kernels (kzz_fwd.cu,
// kzx_fwd.cu): the cancellation-free slot-Gram algebra of
// gpsig_tpu/ops/inducing_pallas.py (_slot_gram_zz :153, _slot_gram_zx :554)
// on norm-augmented value/difference vectors.
//
// Transcendentals: CUDA's accurate expf (max 2 ulp) and expm1f (max 1 ulp),
// never the __expf intrinsic -- the library is built without
// --use_fast_math.  This is a deliberate divergence from the TPU kernels,
// which carry their own exp (gram.exp_accurate) and a Taylor branch for
// expm1 (signature_pallas._expm1) because Mosaic's native f32 exp is only
// ~4e-6 accurate.  expm1f is relatively accurate near 0, which is all the
// Taylor branch existed for.
#pragma once

#include <cuda_runtime.h>

namespace gpsig {

// Base kernels the hand kernels cover; the values match
// gpsig_tpu_torch/ops/inducing_cuda.py::_BASE_IDS.
enum Base : int { kRbf = 0, kLinear = 1 };

// Signature levels a kernel is instantiated for (level loops and the
// per-thread recursion state are unrolled at compile time).
constexpr int kMaxLevels = 8;

// Kzz slot Gram of lhs tensor (v, dv) against rhs tensor (w, dw) from the
// four augmented dots a00 = <v,w>, d01 = <v,dw>, d10 = <dv,w>, dxx = <dv,dw>.
// rbf with increments is G11 + G00 - G10 - G01 of the two 2-point paths,
// evaluated as exp(A00) (expm1(d01+d10+dxx) - expm1(d01) - expm1(d10)).
__device__ __forceinline__ float slot_gram_zz(float a00, float d01, float d10,
                                              float dxx, int base,
                                              bool increments) {
  if (base == kLinear) return increments ? dxx : a00;
  if (!increments) return expf(a00);
  return expf(a00) * (expm1f(d01 + d10 + dxx) - expm1f(d01) - expm1f(d10));
}

// Kzx slot Gram of inducing tensor (v, dv) against observation x_t with
// time step dx_t, from a0 = <v,x>, dza = <dv,x>, da0 = <v,dx>, dda = <dv,dx>.
// rbf with increments and difference is the (z-increment x time-increment)
// entry exp(A0) (exp(dZA) expm1(dA0 + ddA) - expm1(dA0)).
__device__ __forceinline__ float slot_gram_zx(float a0, float dza, float da0,
                                              float dda, int base,
                                              bool increments,
                                              bool difference) {
  if (base == kLinear) {
    if (increments) return difference ? dda : dza;
    return difference ? da0 : a0;
  }
  if (increments) {
    if (difference) return expf(a0) * (expf(dza) * expm1f(da0 + dda) - expm1f(da0));
    return expf(a0) * expm1f(dza);
  }
  if (difference) return expf(a0) * expm1f(da0);
  return expf(a0);
}

}  // namespace gpsig

// Runtime num_levels -> compile-time template argument; returns the launch's
// cudaError_t as an int, or cudaErrorInvalidValue past kMaxLevels.
#define GPSIG_SWITCH_LEVELS(num_levels, FN, ...)                    \
  switch (num_levels) {                                             \
    case 1: return static_cast<int>(FN<1>(__VA_ARGS__));            \
    case 2: return static_cast<int>(FN<2>(__VA_ARGS__));            \
    case 3: return static_cast<int>(FN<3>(__VA_ARGS__));            \
    case 4: return static_cast<int>(FN<4>(__VA_ARGS__));            \
    case 5: return static_cast<int>(FN<5>(__VA_ARGS__));            \
    case 6: return static_cast<int>(FN<6>(__VA_ARGS__));            \
    case 7: return static_cast<int>(FN<7>(__VA_ARGS__));            \
    case 8: return static_cast<int>(FN<8>(__VA_ARGS__));            \
    default: return static_cast<int>(cudaErrorInvalidValue);        \
  }
