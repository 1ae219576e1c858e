// K5, seq x seq forward: the (M+1, N1, N2) first-order signature level
// stack of two sets of sequences.  Replaces the TPU kernel _kernel_fwd
// (gpsig_tpu/ops/signature_pallas.py:436, launched by _fwd_call :593).
//
// For a pair of sequences, M[s, t] is the increment Gram of outer step s
// against inner step t (common.cuh::slot_gram_zz), and level m is
//   K_m = sum_{s,t} R_m[s, t],  R_1 = M,  R_m = M * P(R_{m-1}),
// with P the 2-D exclusive prefix sum P(R)[s, t] = sum_{s'<s, t'<t} R[s', t']
// (signature_pallas._pair_levels_fwd :286-324).  The TPU restated P as
// triangular-ones matmuls with lane-segment carries; here it is one sweep
// over the outer steps s that carries, per level, the column sums
// C_m[t] = sum_{s'<s} R_m[s', t], and takes P(R_m)[s, .] as the exclusive
// prefix of C_m along t -- a segmented warp scan over the lanes.
//
// What bounds it on the card: per entry 4 dots of d2 and up to 3
// transcendentals (~70 FMA at d2 = 16 and M = 4) -- ~0.3 G FMA for the
// 500 x 500 Kzz of length-5 inducing sequences, ~0.6 G for Kzx at 500 x 50
// (5 vs 93 steps), ~1.5 G for a full 50 x 50 Kxx at 93 steps: FMA issue,
// and the shuffles of the scans.  The design: a group of G lanes (the power
// of two >= the inner length, at most 32) takes one pair, each lane owning
// up to 4 inner steps, so a warp runs 32/G pairs at once whatever the
// lengths (4 x 4, 4 x 92 and 92 x 92 are all one kernel).  A block owns one
// outer sequence and walks a share of the inner ones, so the outer row
// loads are warp-wide broadcasts; inner rows come transposed ([d2][L]) so
// a group's loads are coalesced.  The wrapper puts the longer sequence on
// the inner axis.  In symmetric mode each unordered pair is computed once
// and written to both places, so the Gram is exactly symmetric.
//
// Lengths differ natively: no padding to a common length (the TPU padded
// both to a multiple of 128).  With difference the last step of each
// sequence has dx = 0 (inducing_cuda._prep_seq repeats the last
// observation), so the sweep stops at L - 1 and repeat padding of a request
// stays exact; without difference all L observations count.
//
// Inputs: outer rows ov, od (N_out, L_out, d2); inner rows transposed ivT,
// idT (N_in, d2, L_in).  Output out (M+1, N1, N2), written at (m, o, i), or
// (m, i, o) when `swap` says the outer rows are the second argument's.
#include "common.cuh"

namespace gpsig {
namespace {

template <int M>
__global__ void __launch_bounds__(kSeqThreads)
seq_fwd_kernel(const float* __restrict__ ov, const float* __restrict__ od,
               const float* __restrict__ ivT, const float* __restrict__ idT,
               float* __restrict__ out, int n_out, int L_out, int n_in,
               int L_in, int d2, int base, int difference, int symmetric,
               int swap, int G, int cpl, int splits) {
  constexpr int MC = M > 1 ? M - 1 : 1;
  const bool diff = difference != 0, sym = symmetric != 0;
  const int To = diff ? L_out - 1 : L_out;
  const int Ti = diff ? L_in - 1 : L_in;
  const int o = blockIdx.x / splits, split = blockIdx.x % splits;
  const int lg = threadIdx.x % G, gi = threadIdx.x / G;
  const int gpb = kSeqThreads / G;
  int lo, hi;
  seq_inner_range(o, split, splits, n_in, sym, true, lo, hi);
  const float* ov_o = ov + static_cast<size_t>(o) * L_out * d2;
  const float* od_o = od + static_cast<size_t>(o) * L_out * d2;
  const size_t plane = static_cast<size_t>(n_out) * n_in;

  // every group of the block runs the same number of rounds, so the warps
  // stay converged for the scans; groups past `hi` recompute `lo`
  for (int i0 = lo; i0 < hi; i0 += gpb) {
    const int i = i0 + gi;
    const bool live = i < hi;
    const size_t inner = static_cast<size_t>(live ? i : lo) * d2 * L_in;
    float Cs[MC][kSeqCols];  // column sums of R_1 .. R_{M-1} over rows < s
    float acc[M + 1];
#pragma unroll
    for (int k = 0; k < MC; ++k)
#pragma unroll
      for (int j = 0; j < kSeqCols; ++j) Cs[k][j] = 0.f;
#pragma unroll
    for (int m = 0; m <= M; ++m) acc[m] = 0.f;

    for (int s = 0; s < To; ++s) {
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
      // P(R_{m-1})[s, .] for m = 2..M, all from rows < s
      float P[MC][kSeqCols];
#pragma unroll
      for (int m = 2; m <= M; ++m) group_excl_scan(Cs[m - 2], P[m - 2], cpl, lg, G);
#pragma unroll
      for (int j = 0; j < kSeqCols; ++j) {
        acc[1] += Mv[j];
        if (M > 1) Cs[0][j] += Mv[j];
#pragma unroll
        for (int m = 2; m <= M; ++m) {
          const float r = Mv[j] * P[m - 2][j];
          acc[m] += r;
          if (m < M) Cs[m - 1][j] += r;
        }
      }
    }

#pragma unroll
    for (int m = 1; m <= M; ++m) acc[m] = group_sum(acc[m], G);
    if (live && lg == 0) {
      const size_t at = swap ? static_cast<size_t>(i) * n_out + o
                             : static_cast<size_t>(o) * n_in + i;
      const size_t mirror = static_cast<size_t>(i) * n_in + o;
      out[at] = 1.f;
      if (sym) out[mirror] = 1.f;
#pragma unroll
      for (int m = 1; m <= M; ++m) {
        out[m * plane + at] = acc[m];
        if (sym) out[m * plane + mirror] = acc[m];
      }
    }
  }
}

template <int M>
cudaError_t launch_seq_fwd(const float* ov, const float* od, const float* ivT,
                           const float* idT, float* out, int n_out, int L_out,
                           int n_in, int L_in, int d2, int base,
                           int difference, int symmetric, int swap, int G,
                           int cpl, int splits, cudaStream_t stream) {
  const dim3 grid(n_out * splits);
  seq_fwd_kernel<M><<<grid, kSeqThreads, 0, stream>>>(
      ov, od, ivT, idT, out, n_out, L_out, n_in, L_in, d2, base, difference,
      symmetric, swap, G, cpl, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_seq_fwd(const float* ov, const float* od,
                             const float* ivT, const float* idT, float* out,
                             int n_out, int L_out, int n_in, int L_in, int d2,
                             int num_levels, int base, int difference,
                             int symmetric, int swap, int G, int cpl,
                             int splits, void* stream) {
  const bool pow2 = G > 0 && (G & (G - 1)) == 0;
  if (n_out <= 0 || n_in <= 0 || L_out <= 0 || L_in <= 0 || d2 <= 0 ||
      !pow2 || G > 32 || cpl <= 0 || cpl > gpsig::kSeqCols ||
      splits <= 0 || static_cast<long long>(n_out) * splits > 2147483647LL ||
      (symmetric && (n_out != n_in || L_out != L_in)))
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_seq_fwd, ov, od, ivT, idT,
                      out, n_out, L_out, n_in, L_in, d2, base, difference,
                      symmetric, swap, G, cpl, splits,
                      static_cast<cudaStream_t>(stream))
}
