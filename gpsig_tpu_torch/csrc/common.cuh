// Device math shared by the covariance kernels: the cancellation-free
// slot-Gram algebra of gpsig_tpu/ops/inducing_pallas.py (_slot_gram_zz :153,
// _slot_gram_zz_bwd :175, _slot_gram_zx :554, _slot_gram_zx_bwd :604) on
// norm-augmented value/difference vectors, for kzz_fwd.cu, kzz_bwd.cu,
// kzx_fwd.cu and kzx_bwd.cu; and the group scans and row dots of the
// seq x seq kernels seq_fwd.cu and seq_bwd.cu.
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
// It is also the seq x seq increment-Gram entry of step s of one sequence
// against step t of another (signature_pallas.py _increment_gram_row
// :257-283) with increments = difference: the steps are 2-point paths, and
// without difference the entry is the plain Gram exp(A00) / A00.  It is
// symmetric in d01 and d10, so either sequence may be the row side.
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

// slot_gram_zz and its partials p = dG/d(a00, d01, d10, dxx) in one pass;
// the backward weights of _slot_gram_zz_bwd are the slot cotangent times p
// (W_A00, W_d01, W_d10, W_dxx), and so are those of the seq x seq backward
// with Mbar in place of the slot cotangent (signature_pallas.py:1021-1034).
// Returns G.
__device__ __forceinline__ float slot_gram_zz_partials(float a00, float d01,
                                                       float d10, float dxx,
                                                       int base,
                                                       bool increments,
                                                       float p[4]) {
  p[0] = p[1] = p[2] = p[3] = 0.f;
  if (base == kLinear) {
    p[increments ? 3 : 0] = 1.f;
    return increments ? dxx : a00;
  }
  const float ea = expf(a00);
  if (!increments) {
    p[0] = ea;
    return ea;
  }
  const float es = expm1f(d01 + d10 + dxx);
  const float e01 = expm1f(d01), e10 = expm1f(d10);
  const float g = ea * (es - e01 - e10);
  p[0] = g;
  p[1] = ea * (es - e01);
  p[2] = ea * (es - e10);
  p[3] = ea * (es + 1.f);
  return g;
}

// slot_gram_zx and its partials p = dG/d(a0, dza, da0, dda) in one pass;
// the backward weights of _slot_gram_zx_bwd are the slot cotangent times p
// (W_A0, W_dZA, W_dA0, W_ddA).  Returns G.
__device__ __forceinline__ float slot_gram_zx_partials(float a0, float dza,
                                                       float da0, float dda,
                                                       int base,
                                                       bool increments,
                                                       bool difference,
                                                       float p[4]) {
  p[0] = p[1] = p[2] = p[3] = 0.f;
  if (base == kLinear) {
    const int which = (increments ? 1 : 0) + (difference ? 2 : 0);
    p[which] = 1.f;
    return which == 3 ? dda : which == 2 ? da0 : which == 1 ? dza : a0;
  }
  const float ea = expf(a0);
  if (increments && difference) {
    const float edz = expf(dza);
    const float em1s = expm1f(da0 + dda), em1d = expm1f(da0);
    const float g = ea * (edz * em1s - em1d);
    p[0] = g;
    p[1] = ea * edz * em1s;
    p[2] = ea * (edz * (em1s + 1.f) - (em1d + 1.f));
    p[3] = ea * edz * (em1s + 1.f);
    return g;
  }
  if (increments) {
    const float em1z = expm1f(dza);
    p[0] = ea * em1z;
    p[1] = ea * (em1z + 1.f);
    return p[0];
  }
  if (difference) {
    const float em1d = expm1f(da0);
    p[0] = ea * em1d;
    p[2] = ea * (em1d + 1.f);
    return p[0];
  }
  p[0] = ea;
  return ea;
}

// ---------------------------------------------------------------------------
// seq x seq (seq_fwd.cu, seq_bwd.cu)
// ---------------------------------------------------------------------------

// A pair of sequences is handled by a group of G lanes of one warp (G a power
// of two <= 32); lane lg of the group owns the inner time steps lg + j G,
// j < cpl <= kSeqCols.  The group scans below run over the steps in that
// order; every lane of the warp must call them (all groups of a warp share
// G and cpl).
constexpr int kSeqCols = 4;      // inner steps per lane: inner length <= 128
constexpr int kSeqThreads = 128;  // threads per block of K5 / K6
constexpr int kSeqWarps = kSeqThreads / 32;

// y[j] = sum of x over the group's steps before step lg + j G (exclusive
// prefix along the inner time axis).
__device__ __forceinline__ void group_excl_scan(const float (&x)[kSeqCols],
                                                float (&y)[kSeqCols], int cpl,
                                                int lg, int G) {
  float carry = 0.f;
#pragma unroll
  for (int j = 0; j < kSeqCols; ++j) {
    if (j < cpl) {
      float incl = x[j];
      for (int off = 1; off < G; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off, G);
        if (lg >= off) incl += t;
      }
      const float ex = __shfl_up_sync(0xffffffffu, incl, 1, G);
      y[j] = carry + (lg == 0 ? 0.f : ex);
      carry += __shfl_sync(0xffffffffu, incl, G - 1, G);
    } else {
      y[j] = 0.f;
    }
  }
}

// y[j] = sum of x over the group's steps after step lg + j G (the adjoint:
// exclusive suffix along the inner time axis).
__device__ __forceinline__ void group_rev_excl_scan(
    const float (&x)[kSeqCols], float (&y)[kSeqCols], int cpl, int lg,
    int G) {
  float carry = 0.f;
#pragma unroll
  for (int j = kSeqCols - 1; j >= 0; --j) {
    if (j < cpl) {
      float incl = x[j];
      for (int off = 1; off < G; off <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, incl, off, G);
        if (lg + off < G) incl += t;
      }
      const float ex = __shfl_down_sync(0xffffffffu, incl, 1, G);
      y[j] = carry + (lg == G - 1 ? 0.f : ex);
      carry += __shfl_sync(0xffffffffu, incl, 0, G);
    } else {
      y[j] = 0.f;
    }
  }
}

// Sum of v over the group's G lanes, in every lane.
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, G);
  return v;
}

// The four dots of outer row s (value ov_s, step od_s: d2 floats each)
// against the lane's inner steps of one inner sequence, stored transposed
// (ivT, idT: [d2][Li]).  Steps past the sweep read a live column and are
// masked by the caller.  Without difference only a00 is formed.
__device__ __forceinline__ void seq_row_dots(
    const float* __restrict__ ov_s, const float* __restrict__ od_s,
    const float* __restrict__ ivT, const float* __restrict__ idT, int Li,
    int d2, int lg, int G, int cpl, bool difference, float (&a00)[kSeqCols],
    float (&d01)[kSeqCols], float (&d10)[kSeqCols], float (&dxx)[kSeqCols]) {
  int col[kSeqCols];
#pragma unroll
  for (int j = 0; j < kSeqCols; ++j) {
    a00[j] = d01[j] = d10[j] = dxx[j] = 0.f;
    col[j] = min(lg + j * G, Li - 1);
  }
  for (int c = 0; c < d2; ++c) {
    const float a = __ldg(ov_s + c);
    const float b = difference ? __ldg(od_s + c) : 0.f;
    const float* xr = ivT + static_cast<size_t>(c) * Li;
    const float* yr = idT + static_cast<size_t>(c) * Li;
#pragma unroll
    for (int j = 0; j < kSeqCols; ++j) {
      if (j < cpl) {
        const float x = __ldg(xr + col[j]);
        a00[j] = fmaf(a, x, a00[j]);
        if (difference) {
          const float y = __ldg(yr + col[j]);
          d01[j] = fmaf(a, y, d01[j]);
          d10[j] = fmaf(b, x, d10[j]);
          dxx[j] = fmaf(b, y, dxx[j]);
        }
      }
    }
  }
}

// The inner sequences [lo, hi) that block (o, split) of K5 / K6 takes.  In
// symmetric mode each unordered pair is taken once: the upper triangle
// (inner >= o) when `upper`, else the lower one (inner <= o).
__device__ __forceinline__ void seq_inner_range(int o, int split, int splits,
                                                int n_in, bool symmetric,
                                                bool upper, int& lo,
                                                int& hi) {
  int first = 0, last = n_in;
  if (symmetric) {
    if (upper) first = o;
    else last = o + 1;
  }
  const int per = (last - first + splits - 1) / splits;
  lo = first + split * per;
  hi = min(lo + per, last);
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
