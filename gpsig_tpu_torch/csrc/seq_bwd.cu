// K6, seq x seq backward: the VJP of K5 (seq_fwd.cu) under a cotangent ct of
// the (M+1, N1, N2) level stack.  Replaces the TPU kernel _kernel_bwd
// (gpsig_tpu/ops/signature_pallas.py:827, launched by _bwd_call :1070).
//
// For one pair, with level cotangents g_m = ct[m, a, b], the reverse sweep
// of _pair_levels_bwd (:348-376) is
//   Rbar_M = g_M,  Rbar_m = g_m + P^T(M * Rbar_{m+1})   (m = M-1 .. 1),
//   Mbar = Rbar_1 + sum_{m>=2} C_m * Rbar_m,  C_m = P(R_{m-1}),
// with P^T(Y)[s, t] = sum_{s'>s, t'>t} Y[s', t'] the reversed exclusive
// prefix.  Mbar then pulls back through the increment algebra: the weights
// W = Mbar * dM/d(a00, d01, d10, dxx) (common.cuh::slot_gram_zz_partials)
// give the row side g_v[s] += W_a00 w_t + W_d01 dw_t, g_dv[s] += W_d10 w_t +
// W_dxx dw_t (:1020-1034).
//
// One launch does both sides: its first N1 * splits0 blocks take the first
// argument's rows as the outer rows, the rest the second's.  Each side runs
// K5's sweep over its outer rows for every pair it takes and returns the
// gradient of those rows only, so the reduction over the inner steps is a
// reduction over lanes, and over the inner sequences a reduction over the
// groups of a warp: no thread ever sums into another's memory.  The sweep
// forward stores, per row, the column sums C (the state the reverse sweep
// needs) into a per-thread global scratch, so C_m[s, .] is read back exact;
// it is never recovered by subtracting from a total.  The reverse sweep
// carries, per level, D_m[t] = sum_{s'>s} (M * Rbar_{m+1})[s', t] and takes
// P^T as a reversed exclusive scan of D_m over the lanes.  Each row's
// gradient is reduced over the warp through shared memory (each lane sums
// one of 32 channels) and added into the warp's own slab; the wrapper sums
// the slabs with torch.sum.  No atomics: the result is deterministic.
//
// Symmetric mode (one set of sequences, K5 computed each unordered pair
// once and mirrored it): the wrapper folds the cotangent onto the upper
// triangle (ct + ct^T off the diagonal), side 0 takes the pairs with inner
// >= outer and side 1 those with inner <= outer.
//
// What bounds it on the card: per entry K5's dots and transcendentals twice
// (forward sweep and reverse sweep), the partials, and four weight
// contractions of d2 -- about 2.5x K5's FMAs on each side, so 5x K5 in all
// -- plus the per-row warp reductions through shared memory.
//
// Layouts: lv, ld (N1, L1, d2) and rv, rd (N2, L2, d2); the same transposed
// as lvT, ldT (N1, d2, L1), rvT, rdT (N2, d2, L2); ct (M+1, N1, N2); slabs
// g1 (N1, splits0, 4, T1, 2, d2) and g2 (N2, splits1, 4, T2, 2, d2), zeroed
// by the wrapper, T = L - 1 with difference, else L; scratch per side
// (T, M-1, cpl, threads of the side).
#include "common.cuh"

namespace gpsig {
namespace {

template <int M>
__global__ void __launch_bounds__(kSeqThreads)
seq_bwd_kernel(const float* __restrict__ lv, const float* __restrict__ ld,
               const float* __restrict__ rv, const float* __restrict__ rd,
               const float* __restrict__ lvT, const float* __restrict__ ldT,
               const float* __restrict__ rvT, const float* __restrict__ rdT,
               const float* __restrict__ ct, float* __restrict__ g1,
               float* __restrict__ g2, float* __restrict__ scratch, int n1,
               int L1, int n2, int L2, int d2, int base, int difference,
               int symmetric, int G0, int cpl0, int splits0, int G1,
               int cpl1, int splits1) {
  constexpr int MC = M > 1 ? M - 1 : 1;
  __shared__ float red[kSeqWarps][32][33];
  const bool diff = difference != 0, sym = symmetric != 0;
  const int nb0 = n1 * splits0;
  const bool side1 = static_cast<int>(blockIdx.x) >= nb0;
  const int blk = side1 ? blockIdx.x - nb0 : blockIdx.x;
  // this side's roles: outer rows (o), inner rows transposed (i)
  const float* ov = side1 ? rv : lv;
  const float* od = side1 ? rd : ld;
  const float* ivT = side1 ? lvT : rvT;
  const float* idT = side1 ? ldT : rdT;
  const int n_in = side1 ? n1 : n2;
  const int L_out = side1 ? L2 : L1, L_in = side1 ? L1 : L2;
  const int G = side1 ? G1 : G0, cpl = side1 ? cpl1 : cpl0;
  const int splits = side1 ? splits1 : splits0;
  const int To = diff ? L_out - 1 : L_out;
  const int Ti = diff ? L_in - 1 : L_in;
  const int To0 = diff ? L1 - 1 : L1;
  float* scr = scratch + (side1 ? static_cast<size_t>(nb0) * kSeqThreads *
                                      To0 * (M - 1) * cpl0
                                : 0);
  const size_t nthreads =
      static_cast<size_t>(side1 ? n2 * splits1 : nb0) * kSeqThreads;
  const size_t gtid = static_cast<size_t>(blk) * kSeqThreads + threadIdx.x;

  const int o = blk / splits, split = blk % splits;
  const int lg = threadIdx.x % G, gi = threadIdx.x / G;
  const int gpb = kSeqThreads / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int lo, hi;
  seq_inner_range(o, split, splits, n_in, sym, !side1, lo, hi);
  const float* ov_o = ov + static_cast<size_t>(o) * L_out * d2;
  const float* od_o = od + static_cast<size_t>(o) * L_out * d2;
  float* slab = (side1 ? g2 : g1) +
                ((static_cast<size_t>(o) * splits + split) * kSeqWarps +
                 warp) * To * 2 * d2;
  const size_t plane = static_cast<size_t>(n1) * n2;
  int col[kSeqCols];
#pragma unroll
  for (int j = 0; j < kSeqCols; ++j) col[j] = min(lg + j * G, L_in - 1);

  for (int i0 = lo; i0 < hi; i0 += gpb) {
    const int i = i0 + gi;
    const bool live = i < hi;
    const int ic = live ? i : lo;
    const size_t inner = static_cast<size_t>(ic) * d2 * L_in;
    const size_t pair = side1 ? static_cast<size_t>(ic) * n2 + o
                              : static_cast<size_t>(o) * n2 + ic;
    float g[M + 1];
#pragma unroll
    for (int m = 0; m <= M; ++m) g[m] = live ? ct[m * plane + pair] : 0.f;

    // forward sweep, storing each row's incoming column sums
    float Cs[MC][kSeqCols];
#pragma unroll
    for (int k = 0; k < MC; ++k)
#pragma unroll
      for (int j = 0; j < kSeqCols; ++j) Cs[k][j] = 0.f;
    for (int s = 0; s < To; ++s) {
#pragma unroll
      for (int k = 0; k < M - 1; ++k)
#pragma unroll
        for (int j = 0; j < kSeqCols; ++j)
          if (j < cpl)
            scr[((static_cast<size_t>(s) * (M - 1) + k) * cpl + j) *
                    nthreads + gtid] = Cs[k][j];
      if (M == 1) continue;
      float a00[kSeqCols], d01[kSeqCols], d10[kSeqCols], dxx[kSeqCols];
      seq_row_dots(ov_o + static_cast<size_t>(s) * d2,
                   od_o + static_cast<size_t>(s) * d2, ivT + inner,
                   idT + inner, L_in, d2, lg, G, cpl, diff, a00, d01, d10,
                   dxx);
      float Mv[kSeqCols];
#pragma unroll
      for (int j = 0; j < kSeqCols; ++j)
        Mv[j] = (j < cpl && lg + j * G < Ti)
                    ? slot_gram_zz(a00[j], d01[j], d10[j], dxx[j], base, diff)
                    : 0.f;
      float P[MC][kSeqCols];
#pragma unroll
      for (int m = 2; m < M; ++m) group_excl_scan(Cs[m - 2], P[m - 2], cpl, lg, G);
#pragma unroll
      for (int j = 0; j < kSeqCols; ++j) {
        Cs[0][j] += Mv[j];
#pragma unroll
        for (int m = 2; m < M; ++m) Cs[m - 1][j] += Mv[j] * P[m - 2][j];
      }
    }

    // reverse sweep
    float D[MC][kSeqCols];
#pragma unroll
    for (int k = 0; k < MC; ++k)
#pragma unroll
      for (int j = 0; j < kSeqCols; ++j) D[k][j] = 0.f;
    for (int s = To - 1; s >= 0; --s) {
#pragma unroll
      for (int k = 0; k < M - 1; ++k)
#pragma unroll
        for (int j = 0; j < kSeqCols; ++j)
          Cs[k][j] = j < cpl
                         ? scr[((static_cast<size_t>(s) * (M - 1) + k) * cpl +
                                j) * nthreads + gtid]
                         : 0.f;
      float P[MC][kSeqCols];
#pragma unroll
      for (int m = 2; m <= M; ++m) group_excl_scan(Cs[m - 2], P[m - 2], cpl, lg, G);

      float a00[kSeqCols], d01[kSeqCols], d10[kSeqCols], dxx[kSeqCols];
      seq_row_dots(ov_o + static_cast<size_t>(s) * d2,
                   od_o + static_cast<size_t>(s) * d2, ivT + inner,
                   idT + inner, L_in, d2, lg, G, cpl, diff, a00, d01, d10,
                   dxx);
      float Mv[kSeqCols], W[4][kSeqCols];
#pragma unroll
      for (int j = 0; j < kSeqCols; ++j) {
        float p[4];
        const bool ok = j < cpl && lg + j * G < Ti;
        Mv[j] = slot_gram_zz_partials(a00[j], d01[j], d10[j], dxx[j], base,
                                      diff, p);
        if (!ok) Mv[j] = p[0] = p[1] = p[2] = p[3] = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) W[w][j] = p[w];
      }
      // Rbar_m at this row, m = M .. 1, from D (rows > s)
      float Rb[M + 1][kSeqCols];
#pragma unroll
      for (int j = 0; j < kSeqCols; ++j) Rb[M][j] = g[M];
#pragma unroll
      for (int m = M - 1; m >= 1; --m) {
        float t[kSeqCols];
        group_rev_excl_scan(D[m - 1], t, cpl, lg, G);
#pragma unroll
        for (int j = 0; j < kSeqCols; ++j) Rb[m][j] = g[m] + t[j];
      }
#pragma unroll
      for (int j = 0; j < kSeqCols; ++j) {
        float mbar = Rb[1][j];
#pragma unroll
        for (int m = 2; m <= M; ++m) mbar = fmaf(P[m - 2][j], Rb[m][j], mbar);
#pragma unroll
        for (int m = 1; m < M; ++m) D[m - 1][j] = fmaf(Mv[j], Rb[m + 1][j], D[m - 1][j]);
#pragma unroll
        for (int w = 0; w < 4; ++w) W[w][j] *= mbar;
      }

      // this row's gradient: g_v = W_a00 w + W_d01 dw, g_dv = W_d10 w +
      // W_dxx dw, summed over the lane's steps, then over the warp
      for (int c0 = 0; c0 < d2; c0 += 16) {
#pragma unroll
        for (int cc = 0; cc < 16; ++cc) {
          const int c = c0 + cc;
          float pv = 0.f, pd = 0.f;
          if (c < d2) {
            const float* xr = ivT + inner + static_cast<size_t>(c) * L_in;
            const float* yr = idT + inner + static_cast<size_t>(c) * L_in;
#pragma unroll
            for (int j = 0; j < kSeqCols; ++j) {
              if (j < cpl) {
                const float x = __ldg(xr + col[j]);
                pv = fmaf(W[0][j], x, pv);
                pd = fmaf(W[2][j], x, pd);
                if (diff) {
                  const float y = __ldg(yr + col[j]);
                  pv = fmaf(W[1][j], y, pv);
                  pd = fmaf(W[3][j], y, pd);
                }
              }
            }
          }
          red[warp][cc][lane] = pv;
          red[warp][16 + cc][lane] = pd;
        }
        __syncwarp();
        float sum = 0.f;
#pragma unroll 8
        for (int l = 0; l < 32; ++l) sum += red[warp][lane][l];
        const int c = c0 + (lane & 15);
        if (c < d2)
          slab[static_cast<size_t>(s) * 2 * d2 + (lane >> 4) * d2 + c] += sum;
        __syncwarp();
      }
    }
  }
}

template <int M>
cudaError_t launch_seq_bwd(const float* lv, const float* ld, const float* rv,
                           const float* rd, const float* lvT,
                           const float* ldT, const float* rvT,
                           const float* rdT, const float* ct, float* g1,
                           float* g2, float* scratch, int n1, int L1, int n2,
                           int L2, int d2, int base, int difference,
                           int symmetric, int G0, int cpl0, int splits0,
                           int G1, int cpl1, int splits1,
                           cudaStream_t stream) {
  const dim3 grid(n1 * splits0 + n2 * splits1);
  seq_bwd_kernel<M><<<grid, kSeqThreads, 0, stream>>>(
      lv, ld, rv, rd, lvT, ldT, rvT, rdT, ct, g1, g2, scratch, n1, L1, n2,
      L2, d2, base, difference, symmetric, G0, cpl0, splits0, G1, cpl1,
      splits1);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_seq_bwd(const float* lv, const float* ld,
                             const float* rv, const float* rd,
                             const float* lvT, const float* ldT,
                             const float* rvT, const float* rdT,
                             const float* ct, float* g1, float* g2,
                             float* scratch, int n1, int L1, int n2, int L2,
                             int d2, int num_levels, int base, int difference,
                             int symmetric, int G0, int cpl0, int splits0,
                             int G1, int cpl1, int splits1, void* stream) {
  auto bad_group = [](int G, int cpl) {
    return G <= 0 || G > 32 || (G & (G - 1)) != 0 || cpl <= 0 ||
           cpl > gpsig::kSeqCols;
  };
  if (n1 <= 0 || n2 <= 0 || L1 <= 0 || L2 <= 0 || d2 <= 0 ||
      bad_group(G0, cpl0) || bad_group(G1, cpl1) || splits0 <= 0 ||
      splits1 <= 0 ||
      static_cast<long long>(n1) * splits0 +
              static_cast<long long>(n2) * splits1 > 2147483647LL ||
      (symmetric && (n1 != n2 || L1 != L2)))
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_seq_bwd, lv, ld, rv, rd, lvT,
                      ldT, rvT, rdT, ct, g1, g2, scratch, n1, L1, n2, L2, d2,
                      base, difference, symmetric, G0, cpl0, splits0, G1,
                      cpl1, splits1, static_cast<cudaStream_t>(stream))
}
