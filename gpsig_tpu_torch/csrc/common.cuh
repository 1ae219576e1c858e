// Device math shared by the covariance kernels: the cancellation-free
// slot-Gram algebra of gpsig_tpu/ops/inducing_pallas.py (_slot_gram_zz :153,
// _slot_gram_zz_bwd :175, _slot_gram_zx :554, _slot_gram_zx_bwd :604) on
// norm-augmented value/difference vectors, for kzz_fwd.cu, kzz_bwd.cu,
// kzx_fwd.cu and kzx_bwd.cu, with the matern12 base's closed forms
// (gpsig_tpu/ops/gram.py mat12_*_from_dots :279-350) and their partials
// written out; the Kzz tiles K1 and K2 share; the group scans of the
// seq x seq backward seq_bwd.cu; and the level switch every launcher ends
// in.
//
// Transcendentals: CUDA's accurate expf (max 2 ulp) and expm1f (max 1
// ulp), never the __expf intrinsic -- the library is built without
// --use_fast_math; K1, K2, K3 and K5 call the shorter expm1_acc below
// (max 4.5 ulp; chip_smoke.py phase 2e measures it) in place of expm1f.  This is a
// deliberate divergence from the TPU kernels, which carry their own exp
// (gram.exp_accurate) and a Taylor branch for expm1
// (signature_pallas._expm1) because Mosaic's native f32 exp is only ~4e-6
// accurate.  expm1f and expm1_acc are relatively accurate near 0, which is
// all the Taylor branch existed for.
#pragma once

#include <cuda_runtime.h>

namespace gpsig {

// expm1(x) to a few ulp in ~20 instructions, shorter than CUDA's expm1f
// (1 ulp, with its own range reduction and branches), which K3 and K5 call
// two and three times an entry: the Taylor series to x^8 on |x| < 0.41
// (remainder < 2e-9 relative), expf(x) - 1 elsewhere (|expm1(x)| > 0.33
// there and the subtraction exact, so expf's 2 ulp become <= 4.5: an ulp of
// expm1 is at least half one of exp); both computed and one selected, so
// no branch.
__device__ __forceinline__ float expm1_acc(float x) {
  float p = 1.f / 40320.f;
  p = fmaf(p, x, 1.f / 5040.f);
  p = fmaf(p, x, 1.f / 720.f);
  p = fmaf(p, x, 1.f / 120.f);
  p = fmaf(p, x, 1.f / 24.f);
  p = fmaf(p, x, 1.f / 6.f);
  p = fmaf(p, x, 0.5f);
  p = fmaf(p, x * x, x);
  const float e = expf(x) - 1.f;
  return fabsf(x) < 0.41f ? p : e;
}

// expm1 of the slot Grams: CUDA's expm1f, or (SHORT: K1, K2, K3, K5)
// expm1_acc.
template <bool SHORT>
__device__ __forceinline__ float slot_expm1(float x) {
  return SHORT ? expm1_acc(x) : expm1f(x);
}

// Base kernels the hand kernels cover; the values match
// gpsig_tpu_torch/ops/inducing_cuda.py::_BASE_IDS.  Every kernel takes
// matern12 as a compile-time instance of its own (template flag M12): its
// closed form needs the step norms and six partials, and the rbf/linear
// instances keep their registers.
enum Base : int { kRbf = 0, kLinear = 1, kMatern12 = 2 };

// Signature levels the main library is instantiated for (level loops and
// the per-thread recursion state are unrolled at compile time).  A call
// with more levels loads a second library built from the same sources
// with -DGPSIG_EXTRA_LEVELS=M, which holds the instances for that M only
// (ops/_cuda_build.py; GPSIG_SWITCH_LEVELS below).
constexpr int kMaxLevels = 8;

// A launcher's check of its base: one the kernels cover, and with
// matern12 the two step-norm arrays it reads.
inline bool base_ok(int base, const float* n1, const float* n2) {
  if (base == kMatern12) return n1 != nullptr && n2 != nullptr;
  return base == kRbf || base == kLinear;
}

// ---------------------------------------------------------------------------
// matern12, exp(-r): the corner-distance algebra of
// gpsig_tpu/ops/gram.py::radius_gaps_from_dots (:279) on the augmented dots
// (a00 = -r00^2/2, d01 / d10 the one-step gaps, dxx = <dx, dy>) and the
// step norms nx, ny of the true channels as triangle-inequality floors:
//   g01 = -2 d01 / (r01 + r00),  g10 = -2 d10 / (r10 + r00),
//   u = 2 (d01 + dxx) / (r10 + r11) + 2 d01 / (r00 + r01),
//   delta = -2 dxx / (r11 + r01) - 2 d10 u / ((r11 + r01) (r10 + r00)),
//   M = exp(-r00) (exp(-(g01 + g10)) expm1(-delta) + expm1(-g01) expm1(-g10))
// with every denominator max(den, max(norm, 1e-30)) and every radius
// sqrt(max(r00^2 + s, 1e-36)) -- the JAX floors, exactly.  The partials are
// the reverse sweep written out (the same formulas as
// ops/gram.py::mat12_cross_partials); a tie of a max splits its gradient in
// halves, as JAX's VJP does (a00 = 0 exactly at some Kzz self-pairs).
// ---------------------------------------------------------------------------

constexpr float kTinySq = 1e-36f;   // radius guard, a normal float
constexpr float kTinyDen = 1e-30f;  // denominator floor

// Weight of a in max(a, b)'s gradient: 1 where it wins, 1/2 at a tie.
__device__ __forceinline__ float max_w(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

template <bool SHORT>
__device__ __forceinline__ float mat12_cross(float a00, float d01, float d10,
                                             float dxx, float nx, float ny) {
  const float r00sq = fmaxf(-2.f * a00, 0.f);
  const float r00 = sqrtf(fmaxf(r00sq, kTinySq));
  const float r01 = sqrtf(fmaxf(r00sq + -2.f * d01, kTinySq));
  const float r10 = sqrtf(fmaxf(r00sq + -2.f * d10, kTinySq));
  const float r11 = sqrtf(fmaxf(r00sq + -2.f * (d01 + d10 + dxx), kTinySq));
  const float fx = fmaxf(nx, kTinyDen), fy = fmaxf(ny, kTinyDen);
  const float D1 = fmaxf(r01 + r00, fy), D2 = fmaxf(r10 + r00, fx);
  const float D3 = fmaxf(r10 + r11, fy), D5 = fmaxf(r11 + r01, fx);
  const float g01 = -2.f * d01 / D1, g10 = -2.f * d10 / D2;
  const float u = 2.f * (d01 + dxx) / D3 + 2.f * d01 / D1;
  const float delta = -2.f * dxx / D5 - 2.f * d10 / D2 * (u / D5);
  return expf(-r00) * (expf(-(g01 + g10)) * slot_expm1<SHORT>(-delta) +
                       slot_expm1<SHORT>(-g01) * slot_expm1<SHORT>(-g10));
}

// mat12_cross and p = dM/d(a00, d01, d10, dxx, nx, ny).  Returns M.
template <bool SHORT>
__device__ __forceinline__ float mat12_cross_partials(
    float a00, float d01, float d10, float dxx, float nx, float ny,
    float (&p)[6]) {
  const float x0 = -2.f * a00, r00sq = fmaxf(x0, 0.f);
  const float s01 = r00sq + -2.f * d01, s10 = r00sq + -2.f * d10;
  const float s11 = r00sq + -2.f * (d01 + d10 + dxx);
  const float r00 = sqrtf(fmaxf(r00sq, kTinySq));
  const float r01 = sqrtf(fmaxf(s01, kTinySq));
  const float r10 = sqrtf(fmaxf(s10, kTinySq));
  const float r11 = sqrtf(fmaxf(s11, kTinySq));
  const float fx = fmaxf(nx, kTinyDen), fy = fmaxf(ny, kTinyDen);
  const float n1 = r01 + r00, n2 = r10 + r00, n3 = r10 + r11, n5 = r11 + r01;
  const float D1 = fmaxf(n1, fy), D2 = fmaxf(n2, fx);
  const float D3 = fmaxf(n3, fy), D5 = fmaxf(n5, fx);
  const float g01 = -2.f * d01 / D1, q2 = 2.f * d10 / D2;
  const float g10 = -2.f * d10 / D2;
  const float ua = 2.f * (d01 + dxx) / D3, ub = 2.f * d01 / D1;
  const float u = ua + ub;
  const float qd1 = -2.f * dxx / D5, qu = u / D5;
  const float delta = qd1 - q2 * qu;
  const float E0 = expf(-r00), eg = expf(-(g01 + g10));
  const float em_d = slot_expm1<SHORT>(-delta);
  const float e1 = slot_expm1<SHORT>(-g01), e2 = slot_expm1<SHORT>(-g10);
  const float M = E0 * (eg * em_d + e1 * e2);
  // dM/d(g01, g10, delta); dM/dr00 has M's own -M
  const float Gg01 = -E0 * (eg * em_d + (e1 + 1.f) * e2);
  const float Gg10 = -E0 * (eg * em_d + (e2 + 1.f) * e1);
  const float Gd = -E0 * eg * (em_d + 1.f);
  const float dq2 = -Gd * qu, dqu = -Gd * q2;  // delta = qd1 - q2 qu
  const float du = dqu / D5;
  const float dD5 = -(dqu * qu + Gd * qd1) / D5;
  const float dD3 = -du * ua / D3;
  const float dD1 = -(du * ub + Gg01 * g01) / D1;
  const float dD2 = -(Gg10 * g10 + dq2 * q2) / D2;
  const float dd01 = 2.f * du / D3 + (2.f * du - 2.f * Gg01) / D1;
  const float dd10 = (2.f * dq2 - 2.f * Gg10) / D2;
  const float ddxx = 2.f * du / D3 - 2.f * Gd / D5;
  // denominators: to the radii where the sum wins, to the floors else
  const float w1 = max_w(n1, fy), w2 = max_w(n2, fx);
  const float w3 = max_w(n3, fy), w5 = max_w(n5, fx);
  const float dr00 = -M + dD1 * w1 + dD2 * w2;
  const float dr01 = dD1 * w1 + dD5 * w5;
  const float dr10 = dD2 * w2 + dD3 * w3;
  const float dr11 = dD3 * w3 + dD5 * w5;
  const float dfx = dD2 * max_w(fx, n2) + dD5 * max_w(fx, n5);
  const float dfy = dD1 * max_w(fy, n1) + dD3 * max_w(fy, n3);
  // radii r = sqrt(max(s, 1e-36))
  const float ds00 = dr00 * 0.5f / r00 * max_w(r00sq, kTinySq);
  const float ds01 = dr01 * 0.5f / r01 * max_w(s01, kTinySq);
  const float ds10 = dr10 * 0.5f / r10 * max_w(s10, kTinySq);
  const float ds11 = dr11 * 0.5f / r11 * max_w(s11, kTinySq);
  p[0] = -2.f * (ds00 + ds01 + ds10 + ds11) * max_w(x0, 0.f);
  p[1] = dd01 - 2.f * (ds01 + ds11);
  p[2] = dd10 - 2.f * (ds10 + ds11);
  p[3] = ddxx - 2.f * ds11;
  p[4] = dfx * max_w(nx, kTinyDen);
  p[5] = dfy * max_w(ny, kTinyDen);
  return M;
}

// One-sided matern12 difference k(x', y) - k(x, y) = exp(-r00)
// expm1(-g10) (gram.py::mat12_onesided_from_dots :332) and, with `p`, its
// partials dM/d(a00, d10, nx).
template <bool SHORT, bool PARTIALS = false>
__device__ __forceinline__ float mat12_onesided(float a00, float d10,
                                                float nx, float* p = nullptr) {
  const float x0 = -2.f * a00, r00sq = fmaxf(x0, 0.f);
  const float s10 = r00sq - 2.f * d10;
  const float r00 = sqrtf(fmaxf(r00sq, kTinySq));
  const float r10 = sqrtf(fmaxf(s10, kTinySq));
  const float fx = fmaxf(nx, kTinyDen), n2 = r10 + r00;
  const float D2 = fmaxf(n2, fx);
  const float g10 = -2.f * d10 / D2;
  const float E0 = expf(-r00), e2 = slot_expm1<SHORT>(-g10);
  const float M = E0 * e2;
  if (PARTIALS) {
    const float Gg10 = -E0 * (e2 + 1.f);
    const float dD2 = -Gg10 * g10 / D2;
    const float w2 = max_w(n2, fx);
    const float ds10 = dD2 * w2 * 0.5f / r10 * max_w(s10, kTinySq);
    const float ds00 = (dD2 * w2 - M) * 0.5f / r00 * max_w(r00sq, kTinySq);
    p[0] = -2.f * (ds00 + ds10) * max_w(x0, 0.f);
    p[1] = -2.f * Gg10 / D2 - 2.f * ds10;
    p[2] = dD2 * max_w(fx, n2) * max_w(nx, kTinyDen);
  }
  return M;
}

// Plain matern12 Gram entry exp(-r00) (gram.py::mat12_plain_from_dots
// :346) and, with `p`, dM/da00.
template <bool PARTIALS = false>
__device__ __forceinline__ float mat12_plain(float a00, float* p = nullptr) {
  const float x0 = -2.f * a00, r00sq = fmaxf(x0, 0.f);
  const float r00 = sqrtf(fmaxf(r00sq, kTinySq));
  const float M = expf(-r00);
  if (PARTIALS)
    p[0] = M / r00 * max_w(r00sq, kTinySq) * max_w(x0, 0.f);
  return M;
}

// Kzz slot Gram of lhs tensor (v, dv) against rhs tensor (w, dw) from the
// four augmented dots a00 = <v,w>, d01 = <v,dw>, d10 = <dv,w>, dxx = <dv,dw>.
// rbf with increments is G11 + G00 - G10 - G01 of the two 2-point paths,
// evaluated as exp(A00) (expm1(d01+d10+dxx) - expm1(d01) - expm1(d10)).
// It is also the seq x seq increment-Gram entry of step s of one sequence
// against step t of another (signature_pallas.py _increment_gram_row
// :257-283) with increments = difference: the steps are 2-point paths, and
// without difference the entry is the plain Gram exp(A00) / A00.  It is
// symmetric in d01 and d10, so either sequence may be the row side.
// M12: matern12 (mat12_cross) with nx, ny the step norms of the lhs
// and rhs tensors; symmetric too, with nx and ny swapped.
template <bool SHORT = false, bool M12 = false>
__device__ __forceinline__ float slot_gram_zz(float a00, float d01, float d10,
                                              float dxx, int base,
                                              bool increments, float nx = 0.f,
                                              float ny = 0.f) {
  if (M12)
    return increments ? mat12_cross<SHORT>(a00, d01, d10, dxx, nx, ny)
                      : mat12_plain(a00);
  if (base == kLinear) return increments ? dxx : a00;
  if (!increments) return expf(a00);
  return expf(a00) * (slot_expm1<SHORT>(d01 + d10 + dxx) -
                      slot_expm1<SHORT>(d01) - slot_expm1<SHORT>(d10));
}

// Kzx slot Gram of inducing tensor (v, dv) against observation x_t with
// time step dx_t, from a0 = <v,x>, dza = <dv,x>, da0 = <v,dx>, dda = <dv,dx>.
// rbf with increments and difference is the (z-increment x time-increment)
// entry exp(A0) (exp(dZA) expm1(dA0 + ddA) - expm1(dA0)).  M12: matern12
// with the tensor's step on the x side (d10 = dza, norm nz) and the time
// step on the y side (d01 = da0, norm nt), or the one-sided difference of
// the one that is there (_slot_gram_zx, inducing_pallas.py:566-585).
template <bool SHORT = false, bool M12 = false>
__device__ __forceinline__ float slot_gram_zx(float a0, float dza, float da0,
                                              float dda, int base,
                                              bool increments,
                                              bool difference, float nz = 0.f,
                                              float nt = 0.f) {
  if (M12) {
    if (increments && difference)
      return mat12_cross<SHORT>(a0, da0, dza, dda, nz, nt);
    if (increments) return mat12_onesided<SHORT>(a0, dza, nz);
    if (difference) return mat12_onesided<SHORT>(a0, da0, nt);
    return mat12_plain(a0);
  }
  if (base == kLinear) {
    if (increments) return difference ? dda : dza;
    return difference ? da0 : a0;
  }
  if (increments) {
    if (difference)
      return expf(a0) * (expf(dza) * slot_expm1<SHORT>(da0 + dda) -
                         slot_expm1<SHORT>(da0));
    return expf(a0) * slot_expm1<SHORT>(dza);
  }
  if (difference) return expf(a0) * slot_expm1<SHORT>(da0);
  return expf(a0);
}

// slot_gram_zz and its partials p = dG/d(a00, d01, d10, dxx, nx, ny) in one
// pass (p[4] and p[5], the step norms', are 0 but under M12); the backward
// weights of _slot_gram_zz_bwd are the slot cotangent times p (W_A00,
// W_d01, W_d10, W_dxx, W_nx, W_ny), and so are those of the seq x seq
// backward with Mbar in place of the slot cotangent
// (signature_pallas.py:1021-1034 and, matern12, :991-1017).
// SHORT (K2): expm1_acc.  Returns G.
template <bool SHORT = false, bool M12 = false>
__device__ __forceinline__ float slot_gram_zz_partials(
    float a00, float d01, float d10, float dxx, int base, bool increments,
    float (&p)[6], float nx = 0.f, float ny = 0.f) {
  // every index below is a constant, so p stays in registers
  p[0] = p[1] = p[2] = p[3] = p[4] = p[5] = 0.f;
  if (M12) {
    if (increments)
      return mat12_cross_partials<SHORT>(a00, d01, d10, dxx, nx, ny, p);
    return mat12_plain<true>(a00, p);
  }
  if (base == kLinear) {
    p[0] = increments ? 0.f : 1.f;
    p[3] = increments ? 1.f : 0.f;
    return increments ? dxx : a00;
  }
  const float ea = expf(a00);
  if (!increments) {
    p[0] = ea;
    return ea;
  }
  const float es = slot_expm1<SHORT>(d01 + d10 + dxx);
  const float e01 = slot_expm1<SHORT>(d01), e10 = slot_expm1<SHORT>(d10);
  const float g = ea * (es - e01 - e10);
  p[0] = g;
  p[1] = ea * (es - e01);
  p[2] = ea * (es - e10);
  p[3] = ea * (es + 1.f);
  return g;
}

// slot_gram_zx and its partials p = dG/d(a0, dza, da0, dda, nz, nt) in one
// pass (p[4] and p[5], the step norms', are 0 but under M12); the backward
// weights of _slot_gram_zx_bwd are the slot cotangent times p (W_A0, W_dZA,
// W_dA0, W_ddA, W_nz, W_nt).  Returns G.
template <bool M12 = false>
__device__ __forceinline__ float slot_gram_zx_partials(
    float a0, float dza, float da0, float dda, int base, bool increments,
    bool difference, float (&p)[6], float nz = 0.f, float nt = 0.f) {
  // every index below is a constant, so p stays in registers
  p[0] = p[1] = p[2] = p[3] = p[4] = p[5] = 0.f;
  if (M12) {
    float q[6];
    if (increments && difference) {
      const float g =
          mat12_cross_partials<false>(a0, da0, dza, dda, nz, nt, q);
      p[0] = q[0], p[1] = q[2], p[2] = q[1], p[3] = q[3];
      p[4] = q[4], p[5] = q[5];
      return g;
    }
    if (increments) {
      const float g = mat12_onesided<false, true>(a0, dza, nz, q);
      p[0] = q[0], p[1] = q[1], p[4] = q[2];
      return g;
    }
    if (difference) {
      const float g = mat12_onesided<false, true>(a0, da0, nt, q);
      p[0] = q[0], p[2] = q[1], p[5] = q[2];
      return g;
    }
    return mat12_plain<true>(a0, p);
  }
  if (base == kLinear) {
    const int which = (increments ? 1 : 0) + (difference ? 2 : 0);
    p[0] = which == 0 ? 1.f : 0.f;
    p[1] = which == 1 ? 1.f : 0.f;
    p[2] = which == 2 ? 1.f : 0.f;
    p[3] = which == 3 ? 1.f : 0.f;
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
// Kzz tiles (kzz_fwd.cu, kzz_bwd.cu)
// ---------------------------------------------------------------------------

// K1 and K2 take the (i, j) pairs of Kzz in tiles of kZzTile x kZzTile, a
// block of kZzThreads threads, thread (ty, tx) = (t / 16, t % 16) owning the
// 2 x 2 pairs (ty + 16 a, tx + 16 b).  A slot's four row arrays -- lhs vl,
// dl of the tile's rows, rhs vr, dr of its columns -- are staged kZzCB
// channels at a time, each row padded to kZzPad floats so that the float4
// reads of 8 lanes on 8 different rows hit distinct banks.
constexpr int kZzTile = 32;
constexpr int kZzThreads = 256;
constexpr int kZzCB = 16;
constexpr int kZzPad = 20;

struct __align__(16) ZzRows {
  float r[4][kZzTile][kZzPad];  // vl, dl (tile rows), vr, dr (tile columns)
};

// Stage channels cb kZzCB .. of slot k's lhs rows i0 .. and rhs rows j0 ..
// of (lt, nz, d2) arrays; rows past nz and channels past d2 stage as 0.
// Rows of a multiple of 4 channels come in as float4s, 2 a thread.
__device__ __forceinline__ void zz_stage(ZzRows& s, const float* vl,
                                         const float* dl, const float* vr,
                                         const float* dr, int k, int i0,
                                         int j0, int cb, int nz, int d2) {
  if (d2 % 4 == 0) {
    static_assert(4 * kZzTile * kZzCB / 4 == 2 * kZzThreads, "2 a thread");
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = it * kZzThreads + threadIdx.x;
      const int a = e / (kZzTile * kZzCB / 4);
      const int r = (e / (kZzCB / 4)) % kZzTile, c4 = e % (kZzCB / 4);
      const int row = (a < 2 ? i0 : j0) + r, ch = cb * kZzCB + 4 * c4;
      const float* src = a == 0 ? vl : a == 1 ? dl : a == 2 ? vr : dr;
      reinterpret_cast<float4*>(s.r[a][r])[c4] =
          row < nz && ch < d2
              ? *reinterpret_cast<const float4*>(
                    src + (static_cast<size_t>(k) * nz + row) * d2 + ch)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  constexpr int kPer = kZzTile * kZzCB / kZzThreads;  // passes an array
#pragma unroll
  for (int it = 0; it < 4 * kPer; ++it) {
    const int a = it / kPer;
    const int e = (it % kPer) * kZzThreads + threadIdx.x;
    const int r = e / kZzCB, c = e % kZzCB;
    const int row = (a < 2 ? i0 : j0) + r, ch = cb * kZzCB + c;
    const float* src = a == 0 ? vl : a == 1 ? dl : a == 2 ? vr : dr;
    s.r[a][r][c] =
        row < nz && ch < d2
            ? src[(static_cast<size_t>(k) * nz + row) * d2 + ch]
            : 0.f;
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The four slot dots of the thread's 2 x 2 pairs over the staged channels,
// added to acc[2 a + b] = (a00, d01, d10, dxx): a00 = <vl_i, vr_j>, d01 =
// <vl_i, dr_j>, d10 = <dl_i, vr_j>, dxx = <dl_i, dr_j>.  8 float4 loads
// (the lhs ones broadcast) for 64 FMAs.
__device__ __forceinline__ void zz_dots(const ZzRows& s,
                                        float (&acc)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int c4 = 0; c4 < kZzCB / 4; ++c4) {
    float4 lv[2], ld[2], rv[2], rd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lv[h] = reinterpret_cast<const float4*>(s.r[0][ty + 16 * h])[c4];
      ld[h] = reinterpret_cast<const float4*>(s.r[1][ty + 16 * h])[c4];
      rv[h] = reinterpret_cast<const float4*>(s.r[2][tx + 16 * h])[c4];
      rd[h] = reinterpret_cast<const float4*>(s.r[3][tx + 16 * h])[c4];
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float* q = acc[2 * a + b];
        q[0] = dot4(lv[a], rv[b], q[0]);
        q[1] = dot4(lv[a], rd[b], q[1]);
        q[2] = dot4(ld[a], rv[b], q[2]);
        q[3] = dot4(ld[a], rd[b], q[3]);
      }
  }
}

// Pair p, row-major, of the upper triangle (a <= b) of an n x n grid.
__device__ __forceinline__ void upper_pair(long long p, int n, int& a,
                                           int& b) {
  auto start = [n](long long r) { return r * n - r * (r - 1) / 2; };
  const double h = 2.0 * n + 1.0;
  long long r = static_cast<long long>((h - sqrt(h * h - 8.0 * p)) / 2.0);
  r = r < 0 ? 0 : (r > n - 1 ? n - 1 : r);
  while (r > 0 && start(r) > p) --r;
  while (r + 1 < n && start(r + 1) <= p) ++r;
  a = static_cast<int>(r);
  b = static_cast<int>(r + (p - start(r)));
}

// ---------------------------------------------------------------------------
// seq x seq (seq_fwd.cu, seq_bwd.cu)
// ---------------------------------------------------------------------------

// K6's pairs (seq_bwd.cu) are handled by a group of G lanes of one warp (G
// a power of two <= 32); lane lg of the group owns the inner time steps
// c0 + lg + j G, j < cpl <= kSeqCols, of the chunk of G cpl inner steps
// that starts at c0.  The group scans below run over the chunk's steps in
// that order; every lane of the warp must call them (all groups of a warp
// share G and cpl).
constexpr int kSeqCols = 4;      // inner steps per lane: a chunk <= 128
constexpr int kSeqThreads = 128;  // threads per block of K5 / K6
constexpr int kSeqWarps = kSeqThreads / 32;

// y[j] = sum of x over the group's steps before step lg + j G (exclusive
// prefix along the chunk's inner steps).  N, the lane's register slots, is
// kSeqCols or fewer (cpl <= N).  Returns the sum over all the chunk's
// steps (the row carry of the next chunk needs it).
template <int N>
__device__ __forceinline__ float group_excl_scan(const float (&x)[N],
                                                 float (&y)[N], int cpl,
                                                 int lg, int G) {
  float carry = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
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
  return carry;
}

// y[j] = sum of x over the group's steps after step lg + j G (the adjoint:
// exclusive suffix along the chunk's inner steps).  Returns the sum over
// all the chunk's steps.
template <int N>
__device__ __forceinline__ float group_rev_excl_scan(const float (&x)[N],
                                                     float (&y)[N], int cpl,
                                                     int lg, int G) {
  float carry = 0.f;
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
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
  return carry;
}

// Sum of v over the group's G lanes, in every lane.
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, G);
  return v;
}

// ---------------------------------------------------------------------------
// order > 1 (seq_fwd.cu, seq_bwd.cu): the (order x order) grid of partial
// tensors of signature_pallas._pair_levels_fwd (:306-324).  Level i (d =
// min(i, ORD)) holds tiles R_i(a, b), a, b < d; at outer step s, with M the
// row's increment Grams,
//   R_i(0, 0)  = M P(sum of all tiles of level i-1)      2-D prefix
//   R_i(0, b)  = M cc_{i-1, b-1} / (b + 1)                column carry only
//   R_i(a, 0)  = M Q(rowmarg_{i-1, a-1}) / (a + 1)        in-row prefix only
//   R_i(a, b)  = M R_{i-1}(a-1, b-1) / ((a + 1)(b + 1))   pointwise
// where cc_{i, c}[t] = sum_{s' < s} sum_a R_i(a, c)[s', t] is carried over
// the rows, rowmarg_{i, c} = sum_b R_i(c, b) at this row, and Q is the
// exclusive prefix along the inner steps at this row.  So level i carries
// d column sums where order 1 carries one, and takes d exclusive scans a
// row (one 2-D, d - 1 in-row) where order 1 takes one.  At ORD == 1 the
// counts below reduce to order 1's: M - 1 carries and M - 1 scans a row.
template <int ORD>
__host__ __device__ constexpr int grid_d(int i) {
  return i < ORD ? i : ORD;
}
// column carries a row and inner step: levels 1 .. M-1, d of each
template <int M, int ORD>
__host__ __device__ constexpr int grid_nc() {
  int n = 0;
  for (int i = 1; i < M; ++i) n += grid_d<ORD>(i);
  return n;
}
// scans a row: levels 2 .. M, d of each (slot 0 the 2-D prefix, a the
// in-row prefix of rowmarg_{i-1, a-1})
template <int M, int ORD>
__host__ __device__ constexpr int grid_ns() {
  int n = 0;
  for (int i = 2; i <= M; ++i) n += grid_d<ORD>(i);
  return n;
}
// tiles of levels 2 .. M
template <int M, int ORD>
__host__ __device__ constexpr int grid_nt() {
  int n = 0;
  for (int i = 2; i <= M; ++i) n += grid_d<ORD>(i) * grid_d<ORD>(i);
  return n;
}
template <int ORD>
__host__ __device__ constexpr int grid_cc_at(int i, int c) {
  int n = 0;
  for (int i2 = 1; i2 < i; ++i2) n += grid_d<ORD>(i2);
  return n + c;
}
template <int ORD>
__host__ __device__ constexpr int grid_slot(int i, int a) {
  int n = 0;
  for (int i2 = 2; i2 < i; ++i2) n += grid_d<ORD>(i2);
  return n + a;
}
template <int ORD>
__host__ __device__ constexpr int grid_tile(int i, int a, int b) {
  int n = 0;
  for (int i2 = 2; i2 < i; ++i2) n += grid_d<ORD>(i2) * grid_d<ORD>(i2);
  return n + a * grid_d<ORD>(i) + b;
}

// One row of the grid: the coefficients coef_i(a, b) = R_i(a, b) / M of
// levels 2 .. M at the lane's CPL inner steps, from the row's increment
// Grams Mv, the incoming column carries cc (rows before, grid_cc_at) and
// scan(x, y, slot), the caller's exclusive prefix along the inner steps
// (in-lane, over the group, and over the chunks before; grid_slot names
// the scan).  Every index is a compile-time constant once unrolled.
template <int M, int ORD, int CPL, typename Scan>
__device__ __forceinline__ void grid_row(
    const float (&Mv)[CPL], const float (&cc)[grid_nc<M, ORD>()][CPL],
    Scan&& scan, float (&coef)[grid_nt<M, ORD>()][CPL]) {
#pragma unroll
  for (int i = 2; i <= M; ++i) {
    const int d = grid_d<ORD>(i), dp = grid_d<ORD>(i - 1);
    // R_{i-1}(p, q) at this row
    auto prev = [&](int p, int q, int j) {
      return i == 2 ? Mv[j] : Mv[j] * coef[grid_tile<ORD>(i - 1, p, q)][j];
    };
    float x[CPL], y[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      x[j] = 0.f;
#pragma unroll
      for (int c = 0; c < ORD; ++c)
        if (c < dp) x[j] += cc[grid_cc_at<ORD>(i - 1, c)][j];
    }
    scan(x, y, grid_slot<ORD>(i, 0));
#pragma unroll
    for (int j = 0; j < CPL; ++j) coef[grid_tile<ORD>(i, 0, 0)][j] = y[j];
#pragma unroll
    for (int b = 1; b < ORD; ++b)
      if (b < d) {
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          coef[grid_tile<ORD>(i, 0, b)][j] =
              cc[grid_cc_at<ORD>(i - 1, b - 1)][j] / static_cast<float>(b + 1);
      }
#pragma unroll
    for (int a = 1; a < ORD; ++a)
      if (a < d) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          x[j] = 0.f;
#pragma unroll
          for (int b = 0; b < ORD; ++b)
            if (b < dp) x[j] += prev(a - 1, b, j);
        }
        scan(x, y, grid_slot<ORD>(i, a));
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          coef[grid_tile<ORD>(i, a, 0)][j] = y[j] / static_cast<float>(a + 1);
#pragma unroll
        for (int b = 1; b < ORD; ++b)
          if (b < d) {
#pragma unroll
            for (int j = 0; j < CPL; ++j)
              coef[grid_tile<ORD>(i, a, b)][j] =
                  prev(a - 1, b - 1, j) / static_cast<float>((a + 1) * (b + 1));
          }
      }
  }
}

// One round of warp_reduce_scatter32: the lanes whose bit H is set keep
// the upper H of their 2H values, the others the lower H, and each adds
// the partner's copy of the half it keeps (the partner is H lanes away).
// H is a template argument so that every index is known at compile time
// and v stays in registers; the halves are picked by bit masks, since
// `up ? v[i] : v[i + H]` may be compiled as a choice of address.
template <int H>
__device__ __forceinline__ void reduce_scatter_round(float (&v)[32]) {
  const unsigned up = 0u - ((threadIdx.x / H) & 1u);  // all ones if bit H
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const unsigned lo = __float_as_uint(v[i]), hi = __float_as_uint(v[i + H]);
    const float send = __uint_as_float((lo & up) | (hi & ~up));
    const float keep = __uint_as_float((hi & up) | (lo & ~up));
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) reduce_scatter_round<H / 2>(v);
}

// Reduce-scatter of 32 values over the warp: returns, in lane l, the sum of
// v[l] over the 32 lanes (16 + 8 + 4 + 2 + 1 = 31 shuffles for 32 sums,
// where 32 warp sums would take 160).  The sums run in a fixed order, so
// the result is deterministic.  Every lane of the warp must call it, with
// threadIdx.x % 32 its lane; v is clobbered.
__device__ __forceinline__ float warp_reduce_scatter32(float (&v)[32]) {
  reduce_scatter_round<16>(v);
  return v[0];
}

}  // namespace gpsig

// Runtime num_levels -> compile-time template argument; returns the launch's
// cudaError_t as an int, or cudaErrorInvalidValue for a level count the
// library holds no instance of.  The main library holds 1..kMaxLevels; one
// built with -DGPSIG_EXTRA_LEVELS=M holds M alone.
#ifdef GPSIG_EXTRA_LEVELS
static_assert(GPSIG_EXTRA_LEVELS > gpsig::kMaxLevels,
              "the extra library holds a level count past the main one's");
#define GPSIG_SWITCH_LEVELS(num_levels, FN, ...)                    \
  if ((num_levels) == GPSIG_EXTRA_LEVELS)                           \
    return static_cast<int>(FN<GPSIG_EXTRA_LEVELS>(__VA_ARGS__));   \
  return static_cast<int>(cudaErrorInvalidValue);
#else
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
#endif

// K5 and K6 (seq_fwd.cu, seq_bwd.cu) take the order too.  The main library,
// and one built for a level count, holds order 1; one built with
// -DGPSIG_ORDER=k -DGPSIG_ORDER_LEVELS=M (ops/_cuda_build.py) holds K5 and
// K6 at order k and M levels alone.
#ifdef GPSIG_ORDER
static_assert(GPSIG_ORDER > 1 && GPSIG_ORDER <= GPSIG_ORDER_LEVELS,
              "an order library holds 1 < order <= its level count");
#define GPSIG_SWITCH_SEQ(num_levels, order, FN, ...)                       \
  if ((num_levels) == GPSIG_ORDER_LEVELS && (order) == GPSIG_ORDER)        \
    return static_cast<int>(                                               \
        FN<GPSIG_ORDER_LEVELS, GPSIG_ORDER>(__VA_ARGS__));                 \
  return static_cast<int>(cudaErrorInvalidValue);
#else
#define GPSIG_SWITCH_SEQ(num_levels, order, FN, ...)                       \
  if ((order) != 1) return static_cast<int>(cudaErrorInvalidValue);        \
  GPSIG_SWITCH_LEVELS(num_levels, FN, __VA_ARGS__)
#endif
