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
// give both sides' gradients (:1020-1034):
//   outer row s:  g_ov[s] += W_a00 iv_t + W_d01 id_t,
//                 g_od[s] += W_d10 iv_t + W_dxx id_t,
//   inner step t: g_iv[t] += W_a00 ov_s + W_d10 od_s,
//                 g_id[t] += W_d01 ov_s + W_dxx od_s.
//
// One sweep per pair: the shorter sequence on the inner axis (a group of G
// lanes, lane lg owning steps lg + j G, j < cpl, of a chunk of at most 128
// steps), the longer on the outer axis at any length.  The sweep runs
// forward once, storing each row's incoming column sums C (the state the
// reverse needs, read back exact, never recovered by subtraction), and
// then in reverse once, carrying per level D_m[t] = sum_{s'>s} (M *
// Rbar_{m+1})[s', t] and taking P^T as a reversed exclusive scan over the
// group.  Both arguments' gradients come out of that one pair of sweeps.
//
// An inner sequence longer than one chunk (G cpl steps) is taken in nc
// chunks with carries between them.  The forward sweeps the chunks in
// order: for chunk ch, P(R_m)[s, t] is the in-chunk prefix of the column
// sums plus the row carry Y_m[s] = sum_{s'<s} of row s''s R_m over the
// chunks before; sweeping chunk ch, row s adds the chunk's column-sum
// total to Y for chunk ch + 1.  Each chunk's column sums and row carries
// are stored.  The reverse then takes the chunks last to first: P^T(Y)[s,
// t] is the in-chunk suffix plus Z_m[s], the same sum over s' > s and the
// chunks after, which the reverse has already swept and which it adds to
// in place.  The outer rows' gradients are written by the first chunk the
// reverse takes and added to by the others (the same lane each time), the
// inner steps' gradients accumulate per chunk in the workspace.
//
// Work split: a warp owns a "set" of 32 / G inner sequences (one per group)
// and a range of outer sequences, and takes every (outer, set) pair of it
// in turn; all groups of a warp sweep the same outer rows in lock step.
//   * The inner rows of the set (every chunk) are staged once in a
//     per-warp workspace, and the inner steps' gradients accumulate there
//     over every outer row of the range; the warp writes them once, into a
//     slab per (inner sequence, range).
//   * Each outer row's gradient (2 d2 values a lane) is summed over the
//     warp -- the group's G lanes and the set's sequences -- by a shuffle
//     reduce-scatter (common.cuh::warp_reduce_scatter32), and written once
//     into a slab per (outer sequence, set) (added to chunk by chunk).
//   The wrapper sums both slabs with torch.sum: no atomics, a fixed order,
//   a deterministic result.  The workspace (inner rows, inner gradients)
//   and the column-sum store live in shared memory where they fit, else in
//   a global scratch (the wrapper picks; the addressing is the same).
//   * With one inner step a lane (inner length <= 32: Kzz and Kzx of the
//     inducing-sequences model, 4 steps) four outer rows go together: their
//     dots, partials and contractions are independent (only the level
//     carries are serial), so they overlap, and each load of an inner value
//     or an inner gradient serves the four.  Longer inner sequences (up to
//     kSeqCols steps a lane) take one row at a time.  Outer rows are read
//     as broadcast float4s.
//
// Symmetric mode (one set of sequences, K5 computed each unordered pair
// once and mirrored it): the wrapper folds the cotangent onto the upper
// triangle (ct + ct^T off the diagonal) and a warp takes only the pairs
// with inner >= outer.
//
// What bounds it on the card: per entry K5's dots and transcendentals twice
// (the forward and the reverse sweep), the partials, and 8 d2 FMAs of
// weight contraction -- ~16 d2 + 30 FMAs, of which 12 d2 are the work the
// function needs -- read from shared memory at ~8 d2 loads and stores an
// entry; plus the column-sum store (4 (M-1) bytes an entry each way).
//
// matern12 (M12, a compile-time instance of each configuration): the
// outer sequence on the x side and the inner one on the y side of
// common.cuh's mat12_cross (K5's orientation), six partials, so six weights
// a row, inner step and register slot (W[r][6][j], compile-time indices),
// and the JAX kernel's dead-step mask (signature_pallas.py:991-1017): the
// weights of an entry whose outer or inner step is zero are 0 (its forward
// is exactly 0, and the pad-adjoint partials through the 1e-30 floors
// would leave f32 residue).  The step-norm weights, divided by their norms,
// add their chains in the contraction: od[s] to the outer row's g_od, id[t]
// to the inner step's g_id, over the true channels.
//
// Layouts: ov, od (N_out, L_out, d2) and iv, id (N_in, L_in, d2), the outer
// and inner arguments (the wrapper's `swap` says which is the first); ct
// (M+1, N1, N2); slabs g_out (N_out, sets, To, 2, d2) and g_in (N_in,
// ranges, Ti, 2, d2), T = L - 1 with difference, else L; workspace and
// column-sum store per warp as seq_bwd_ws_floats / seq_bwd_cs_floats say;
// with matern12 the step norms no (N_out, L_out) and ni (N_in, L_in).
#include <cstdint>

#include "common.cuh"

namespace gpsig {
namespace {

constexpr int kWarpsPerBlock = kSeqWarps;

// A warp's workspace, nc chunks of [in_v, in_d, acc_v, acc_d][d2][cpl][32],
// and its column-sum store, nc chunks of [To][NC][cpl][32] and, with more
// than one chunk, the row carries [nc][To][NS][32] and the suffix carries
// [To][NS][32] (floats; NC column sums and NS scans a row, M - 1 each at
// order 1, common.cuh::grid_nc / grid_ns; ops/signature_cuda.py sizes them
// the same way).
__host__ __device__ inline size_t seq_bwd_ws_floats(int d2, int cpl, int nc) {
  return 4 * static_cast<size_t>(d2) * cpl * 32 * nc;
}
__host__ __device__ inline size_t seq_bwd_cs_floats(int NC, int NS, int To,
                                                    int cpl, int nc) {
  const size_t per = static_cast<size_t>(To) * 32;
  return per * NC * cpl * nc + (nc > 1 ? per * NS * (nc + 1) : 0);
}

// Four consecutive values p[c .. c+3] of an outer row (zeros past d2): one
// broadcast float4 load when the rows are 16-byte aligned (vec4).
__device__ __forceinline__ void outer4(const float* __restrict__ p, int c,
                                       int d2, bool vec4, float (&v)[4]) {
  if (vec4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + c));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c + e < d2 ? __ldg(p + c + e) : 0.f;
  }
}

// The four dots of R outer rows (srow[r] of ov_o, od_o) against the lane's
// inner steps, staged at in_v / in_d as [c][j][lane]; each inner value is
// read once for the R rows, each outer value as part of a float4.  Without
// difference only a00 is formed.
template <int CPL, int R>
__device__ __forceinline__ void seq_rows_dots(
    const float* __restrict__ ov_o, const float* __restrict__ od_o,
    const int (&srow)[R], const float* in_v, const float* in_d, int d2,
    int cstride, int cpl, int lane, bool diff, bool vec4,
    float (&a00)[R][CPL], float (&d01)[R][CPL], float (&d10)[R][CPL],
    float (&dxx)[R][CPL]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      a00[r][j] = d01[r][j] = d10[r][j] = dxx[r][j] = 0.f;
  for (int c = 0; c < d2; c += 4) {
    float x[4][CPL], y[4][CPL];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const bool ok = j < cpl && c + e < d2;
        const int at = (c + e) * cstride + j * 32 + lane;
        x[e][j] = ok ? in_v[at] : 0.f;
        y[e][j] = (diff && ok) ? in_d[at] : 0.f;
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a[4], b[4];
      outer4(ov_o + srow[r] * d2, c, d2, vec4, a);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          a00[r][j] = fmaf(a[e], x[e][j], a00[r][j]);
      if (diff) {
        outer4(od_o + srow[r] * d2, c, d2, vec4, b);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            d01[r][j] = fmaf(a[e], y[e][j], d01[r][j]);
            d10[r][j] = fmaf(b[e], x[e][j], d10[r][j]);
            dxx[r][j] = fmaf(b[e], y[e][j], dxx[r][j]);
          }
      }
    }
  }
}

// CPL: the lane's register slots for inner steps (cpl <= CPL); R: outer rows
// taken together, whose dots, partials and contractions are independent
// (only the level carries are serial), so they overlap and share each load
// of an inner value and of an inner gradient; D2: d2 as a compile-time
// constant (the benchmark's 16), or 0 for any d2; M12: matern12; ORD: the
// order (common.cuh::grid_row past 1, one row at a time).
template <int M, int ORD, int CPL, int R, int D2, bool M12>
__global__ void __launch_bounds__(kSeqThreads)
seq_bwd_kernel(const float* __restrict__ ov, const float* __restrict__ od,
               const float* __restrict__ iv, const float* __restrict__ id,
               const float* __restrict__ no, const float* __restrict__ ni,
               const float* __restrict__ ct, float* __restrict__ g_out,
               float* __restrict__ g_in, float* __restrict__ gscratch,
               int n_out, int L_out, int n_in, int L_in, int d2, int base,
               int difference, int symmetric, int swap, int G, int cpl,
               int nc, int n_ranges, int ws_mode, int vec4) {
  if (D2 > 0) d2 = D2;  // the launcher checked d2 == D2
  constexpr int MC = M > 1 ? M - 1 : 1;
  // column sums stored and scans a row (M - 1 each at order 1), and the
  // grid's tiles of levels 2 .. M
  constexpr int NC = ORD > 1 ? grid_nc<M, ORD>() : M - 1;
  constexpr int NS = grid_ns<M, ORD>();
  constexpr int NT = ORD > 1 ? grid_nt<M, ORD>() : 1;
  static_assert(ORD == 1 || R == 1, "order > 1 takes one row at a time");
  constexpr int CB = 16 / R;  // channels a contraction round: R x 2 x CB = 32
  constexpr int NW = M12 ? 6 : 4;  // weights an entry
  extern __shared__ float smem[];
  const bool diff = difference != 0, sym = symmetric != 0;
  const int To = diff ? L_out - 1 : L_out;
  const int Ti = diff ? L_in - 1 : L_in;
  const int gps = 32 / G;  // inner sequences a warp holds
  const int n_sets = (n_in + gps - 1) / gps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = blockIdx.x * kWarpsPerBlock + warp;
  if (wg >= n_sets * n_ranges) return;  // whole warps only: no block sync
  const int set = wg % n_sets, range = wg / n_sets;
  const int lg = lane % G, gi = lane / G;
  const int i = set * gps + gi;
  const bool live_i = i < n_in;

  // this warp's workspace and column-sum store, in shared or global memory
  const size_t ws_floats = seq_bwd_ws_floats(d2, cpl, nc);
  const size_t cs_floats = seq_bwd_cs_floats(NC, NS, To, cpl, nc);
  float* ws;
  float* cs;
  if (ws_mode == 0) {
    ws = smem + warp * (ws_floats + cs_floats);
    cs = ws + ws_floats;
  } else if (ws_mode == 1) {
    ws = smem + warp * ws_floats;
    cs = gscratch + static_cast<size_t>(wg) * cs_floats;
  } else {
    ws = gscratch + static_cast<size_t>(wg) * (ws_floats + cs_floats);
    cs = ws + ws_floats;
  }
  // inner chunk ch of W = G cpl steps: lane lg owns steps ch W + lg + j G;
  // its rows and gradients sit at ws + ch * chunk_ws, its column sums at
  // cs + ch * chunk_cs, [c][j][lane] and [s][k][j][lane]: each lane its
  // own slots
  const bool chunked = nc > 1;
  const int W = G * cpl;
  const int cstride = cpl * 32;
  const size_t chunk_ws = 4 * static_cast<size_t>(d2) * cstride;
  const size_t chunk_cs = static_cast<size_t>(To) * NC * cstride;
  // with chunks: the row carries Y[ch][s][k][lane] (scan k at row s over
  // the inner steps before chunk ch; at order 1 P(R_{k+1})) and the suffix
  // carries Z[s][k][lane] (its adjoint over the steps after the chunk the
  // reverse is on)
  const size_t chunk_y = static_cast<size_t>(To) * NS * 32;
  float* ycar = cs + nc * chunk_cs;
  float* zcar = ycar + nc * chunk_y;
  auto carry_at = [&](int s, int k) { return (s * NS + k) * 32 + lane; };

  // stage the set's inner rows, every chunk (zeros past the sequence or
  // the set)
  for (int ch = 0; ch < nc; ++ch) {
    float* in_v = ws + ch * chunk_ws;
    float* in_d = in_v + d2 * cstride;
    float* acc_v = in_d + d2 * cstride;
    float* acc_d = acc_v + d2 * cstride;
    for (int j = 0; j < cpl; ++j) {
      const int t = ch * W + lg + j * G;
      const bool ok = live_i && t < L_in;
      const size_t row = (static_cast<size_t>(ok ? i : 0) * L_in +
                          (ok ? t : 0)) * d2;
      for (int c = 0; c < d2; ++c) {
        const int at = c * cstride + j * 32 + lane;
        in_v[at] = ok ? __ldg(iv + row + c) : 0.f;
        in_d[at] = ok ? __ldg(id + row + c) : 0.f;
        acc_v[at] = 0.f;
        acc_d[at] = 0.f;
      }
    }
  }

  // outer sequences of this range: all of them, or in symmetric mode those
  // that meet an inner sequence of the set at or after them
  const int hi_o = sym ? min(n_out, (set + 1) * gps) : n_out;
  const int per = (hi_o + n_ranges - 1) / n_ranges;
  const int o_lo = range * per, o_hi = min(o_lo + per, hi_o);
  const size_t plane = static_cast<size_t>(n_out) * n_in;

  for (int o = o_lo; o < o_hi; ++o) {
    const bool live = live_i && (!sym || i >= o);
    const size_t pair = swap ? static_cast<size_t>(live ? i : 0) * n_out + o
                             : static_cast<size_t>(o) * n_in + (live ? i : 0);
    float g[M + 1];
#pragma unroll
    for (int m = 0; m <= M; ++m) g[m] = live ? ct[m * plane + pair] : 0.f;
    const float* ov_o = ov + static_cast<size_t>(o) * L_out * d2;
    const float* od_o = od + static_cast<size_t>(o) * L_out * d2;
    float* gout_o =
        g_out + (static_cast<size_t>(o) * n_sets + set) * To * 2 * d2;
    // M12: the step norm of outer row s and of the lane's inner steps of
    // chunk ch
    auto outer_norm = [&](int s) {
      return M12 ? __ldg(no + static_cast<size_t>(o) * L_out + s) : 0.f;
    };
    auto inner_norms = [&](int ch, float (&nin)[CPL]) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int t = ch * W + lg + j * G;
        nin[j] = M12 && j < cpl && live_i && t < L_in
                     ? __ldg(ni + static_cast<size_t>(i) * L_in + t)
                     : 0.f;
      }
    };

    // forward sweeps, chunk by chunk: store each row's incoming column
    // sums, and with chunks the row carries of the next chunk
    for (int ch = 0; M > 1 && ch < nc; ++ch) {
      const float* in_v = ws + ch * chunk_ws;
      const float* in_d = in_v + d2 * cstride;
      float* cs_c = cs + ch * chunk_cs;
      auto inner_ok = [&](int j) {
        return j < cpl && ch * W + lg + j * G < Ti;
      };
      float nin[CPL];
      inner_norms(ch, nin);
      float Cs[MC][CPL];
      float cc[NC > 0 ? NC : 1][CPL];  // order > 1: the grid's column carries
#pragma unroll
      for (int k = 0; k < MC; ++k)
#pragma unroll
        for (int j = 0; j < CPL; ++j) Cs[k][j] = 0.f;
#pragma unroll
      for (int k = 0; k < (NC > 0 ? NC : 1); ++k)
#pragma unroll
        for (int j = 0; j < CPL; ++j) cc[k][j] = 0.f;
      for (int s0 = 0; s0 < To; s0 += R) {
        int srow[R];
#pragma unroll
        for (int r = 0; r < R; ++r) srow[r] = min(s0 + r, To - 1);
        float a00[R][CPL], d01[R][CPL], d10[R][CPL], dxx[R][CPL];
        seq_rows_dots<CPL, R>(ov_o, od_o, srow, in_v, in_d, d2, cstride, cpl,
                              lane, diff, vec4 != 0, a00, d01, d10, dxx);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int s = s0 + r;
          if (s >= To) break;
          const float nos = outer_norm(s);
          if constexpr (ORD > 1) {
            // the row's incoming column carries, then its grid: level i's
            // carries take its tiles' column sums, and with chunks each
            // scan's total goes into the next chunk's row carry
#pragma unroll
            for (int k = 0; k < NC; ++k)
#pragma unroll
              for (int j = 0; j < CPL; ++j)
                if (j < cpl)
                  cs_c[((s * NC + k) * cpl + j) * 32 + lane] = cc[k][j];
            float mv[CPL];
#pragma unroll
            for (int j = 0; j < CPL; ++j)
              mv[j] = inner_ok(j) ? slot_gram_zz<false, M12>(
                                        a00[r][j], d01[r][j], d10[r][j],
                                        dxx[r][j], base, diff, nos, nin[j])
                                  : 0.f;
            auto scan = [&](const float (&x)[CPL], float (&y)[CPL],
                            int slot) {
              const float tot = group_excl_scan(x, y, cpl, lg, G);
              if (chunked) {
                const float y0 =
                    ch > 0 ? ycar[ch * chunk_y + carry_at(s, slot)] : 0.f;
#pragma unroll
                for (int j = 0; j < CPL; ++j) y[j] += y0;
                if (ch + 1 < nc)
                  ycar[(ch + 1) * chunk_y + carry_at(s, slot)] = y0 + tot;
              }
            };
            float coef[NT][CPL];
            grid_row<M, ORD, CPL>(mv, cc, scan, coef);
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              cc[0][j] += mv[j];
#pragma unroll
              for (int i = 2; i < M; ++i) {
                const int d = grid_d<ORD>(i);
#pragma unroll
                for (int a = 0; a < ORD; ++a)
#pragma unroll
                  for (int b = 0; b < ORD; ++b)
                    if (a < d && b < d)
                      cc[grid_cc_at<ORD>(i, b)][j] +=
                          mv[j] * coef[grid_tile<ORD>(i, a, b)][j];
              }
            }
            continue;
          }
#pragma unroll
          for (int k = 0; k < M - 1; ++k)
#pragma unroll
            for (int j = 0; j < CPL; ++j)
              if (j < cpl)
                cs_c[((s * (M - 1) + k) * cpl + j) * 32 + lane] = Cs[k][j];
          // P(R_{m-1}) at this row: the in-chunk prefix plus the row carry
          // (level M's is needed only for the next chunk's carry)
          float P[MC][CPL];
#pragma unroll
          for (int m = 2; m <= M; ++m) {
            if (m == M && !chunked) break;
            const float tot =
                group_excl_scan(Cs[m - 2], P[m - 2], cpl, lg, G);
            if (chunked) {
              const float y = ch > 0 ? ycar[ch * chunk_y + carry_at(s, m - 2)]
                                     : 0.f;
#pragma unroll
              for (int j = 0; j < CPL; ++j) P[m - 2][j] += y;
              if (ch + 1 < nc)
                ycar[(ch + 1) * chunk_y + carry_at(s, m - 2)] = y + tot;
            }
          }
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const float mv =
                inner_ok(j) ? slot_gram_zz<false, M12>(
                                  a00[r][j], d01[r][j], d10[r][j], dxx[r][j],
                                  base, diff, nos, nin[j])
                            : 0.f;
            Cs[0][j] += mv;
#pragma unroll
            for (int m = 2; m < M; ++m) Cs[m - 1][j] += mv * P[m - 2][j];
          }
        }
      }
    }

    // reverse sweeps, the chunks last to first, R rows at a time from the
    // last; the outer rows' gradients are written by the first chunk taken
    // and added to by the others
    for (int ch = nc - 1; ch >= 0; --ch) {
      float* in_v = ws + ch * chunk_ws;
      float* in_d = in_v + d2 * cstride;
      float* acc_v = in_d + d2 * cstride;
      float* acc_d = acc_v + d2 * cstride;
      const float* cs_c = cs + ch * chunk_cs;
      auto inner_ok = [&](int j) {
        return j < cpl && ch * W + lg + j * G < Ti;
      };
      float nin[CPL];
      inner_norms(ch, nin);
      float D[MC][CPL];
      // order > 1: per level i < M the column suffixes over rows > s of
      // M Rbar_{i+1}(0, 0) (slot 0, the double suffix's) and of M Rbar_{i+1}
      // (0, c + 1) / (c + 2) (slot c + 1, Tbar's)
      float Dg[ORD > 1 ? MC : 1][ORD][CPL];
#pragma unroll
      for (int k = 0; k < MC; ++k)
#pragma unroll
        for (int j = 0; j < CPL; ++j) D[k][j] = 0.f;
#pragma unroll
      for (int k = 0; k < (ORD > 1 ? MC : 1); ++k)
#pragma unroll
        for (int c = 0; c < ORD; ++c)
#pragma unroll
          for (int j = 0; j < CPL; ++j) Dg[k][c][j] = 0.f;
      for (int s_hi = To - 1; s_hi >= 0; s_hi -= R) {
        int srow[R];
#pragma unroll
        for (int r = 0; r < R; ++r) srow[r] = max(s_hi - r, 0);
        // P(R_{m-1}) at each row, from the stored column sums (order 1)
        float P[R][MC][CPL];
#pragma unroll
        for (int r = 0; r < R && ORD == 1; ++r) {
          float C[MC][CPL];
#pragma unroll
          for (int k = 0; k < MC; ++k)
#pragma unroll
            for (int j = 0; j < CPL; ++j)
              C[k][j] = (k < M - 1 && j < cpl && s_hi - r >= 0)
                            ? cs_c[((srow[r] * (M - 1) + k) * cpl + j) * 32 +
                                   lane]
                            : 0.f;
#pragma unroll
          for (int m = 2; m <= M; ++m) {
            group_excl_scan(C[m - 2], P[r][m - 2], cpl, lg, G);
            if (chunked && ch > 0) {
              const float y = ycar[ch * chunk_y + carry_at(srow[r], m - 2)];
#pragma unroll
              for (int j = 0; j < CPL; ++j) P[r][m - 2][j] += y;
            }
          }
        }
        float W[R][NW][CPL], Mv[R][CPL], nrow[R];
        {
          float a00[R][CPL], d01[R][CPL], d10[R][CPL], dxx[R][CPL];
          seq_rows_dots<CPL, R>(ov_o, od_o, srow, in_v, in_d, d2, cstride, cpl,
                                lane, diff, vec4 != 0, a00, d01, d10, dxx);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            nrow[r] = outer_norm(srow[r]);
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              float p[6];
              Mv[r][j] = slot_gram_zz_partials<false, M12>(
                  a00[r][j], d01[r][j], d10[r][j], dxx[r][j], base, diff, p,
                  nrow[r], nin[j]);
              if (!(inner_ok(j) && s_hi - r >= 0)) {
                Mv[r][j] = 0.f;
#pragma unroll
                for (int w = 0; w < 6; ++w) p[w] = 0.f;
              }
              // the dead-step mask: a zero step on either side
              if (M12 && diff && !(nrow[r] > 0.f && nin[j] > 0.f)) {
#pragma unroll
                for (int w = 0; w < 6; ++w) p[w] = 0.f;
              }
#pragma unroll
              for (int w = 0; w < NW; ++w) W[r][w][j] = p[w];
            }
          }
        }
        // Mbar from Rbar_M .. Rbar_1, row by row downwards; D (rows > s) is
        // read before the row adds to it
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int s = s_hi - r;
          float mbar[CPL];
          if constexpr (ORD > 1) {
            // level i's tiles at this row, recomputed from the stored
            // column carries and the row carries of the chunks before
            // (read, never recovered by subtraction)
            float ccr[NC > 0 ? NC : 1][CPL];
#pragma unroll
            for (int k = 0; k < NC; ++k)
#pragma unroll
              for (int j = 0; j < CPL; ++j)
                ccr[k][j] = j < cpl ? cs_c[((s * NC + k) * cpl + j) * 32 +
                                           lane]
                                    : 0.f;
            auto scan = [&](const float (&x)[CPL], float (&y)[CPL],
                            int slot) {
              group_excl_scan(x, y, cpl, lg, G);
              if (chunked && ch > 0) {
                const float y0 = ycar[ch * chunk_y + carry_at(s, slot)];
#pragma unroll
                for (int j = 0; j < CPL; ++j) y[j] += y0;
              }
            };
            float coef[NT][CPL];
            grid_row<M, ORD, CPL>(Mv[r], ccr, scan, coef);
            // the adjoint suffix of x along the inner steps at this row,
            // with the chunks after (scan `slot`'s suffix carry)
            auto rscan = [&](const float (&x)[CPL], float (&y)[CPL],
                             int slot) {
              const float tot = group_rev_excl_scan(x, y, cpl, lg, G);
              if (chunked) {
                const float z = ch + 1 < nc ? zcar[carry_at(s, slot)] : 0.f;
#pragma unroll
                for (int j = 0; j < CPL; ++j) y[j] += z;
                if (ch > 0) zcar[carry_at(s, slot)] = z + tot;
              }
            };
            // rb: Rbar_{i+1}(a, b) at this row, from level M down
            float rb[ORD][ORD][CPL];
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              mbar[j] = 0.f;
#pragma unroll
              for (int a = 0; a < ORD; ++a)
#pragma unroll
                for (int b = 0; b < ORD; ++b) {
                  rb[a][b][j] = g[M];
                  if (a < grid_d<ORD>(M) && b < grid_d<ORD>(M))
                    mbar[j] = fmaf(coef[grid_tile<ORD>(M, a, b)][j], g[M],
                                   mbar[j]);
                }
            }
#pragma unroll
            for (int i = M - 1; i >= 1; --i) {
              const int dq = grid_d<ORD>(i + 1), di = grid_d<ORD>(i);
              float S[CPL], U[ORD][CPL], x[CPL];
              // (0, 0) of level i+1: the double suffix, into every tile
              rscan(Dg[i - 1][0], S, grid_slot<ORD>(i + 1, 0));
              // (c + 1, 0) of level i+1: the in-row suffix Ubar, into
              // level i's row c
#pragma unroll
              for (int c = 0; c + 1 < ORD; ++c)
                if (c + 1 < dq) {
#pragma unroll
                  for (int j = 0; j < CPL; ++j)
                    x[j] = Mv[r][j] * rb[c + 1][0][j] /
                           static_cast<float>(c + 2);
                  rscan(x, U[c], grid_slot<ORD>(i + 1, c + 1));
                }
              float rn[ORD][ORD][CPL];
#pragma unroll
              for (int a = 0; a < ORD; ++a)
#pragma unroll
                for (int b = 0; b < ORD; ++b)
#pragma unroll
                  for (int j = 0; j < CPL; ++j) {
                    float v = g[i] + S[j];
                    // (0, b + 1) of level i+1: the column suffix Tbar
                    if (b + 1 < dq) v += Dg[i - 1][b + 1][j];
                    if (a + 1 < dq) v += U[a][j];
                    // (a + 1, b + 1) of level i+1: pointwise
                    if (a + 1 < dq && b + 1 < dq)
                      v += Mv[r][j] * rb[a + 1][b + 1][j] /
                           static_cast<float>((a + 2) * (b + 2));
                    rn[a][b][j] = v;
                  }
#pragma unroll
              for (int j = 0; j < CPL; ++j) {
                Dg[i - 1][0][j] = fmaf(Mv[r][j], rb[0][0][j], Dg[i - 1][0][j]);
#pragma unroll
                for (int c = 0; c + 1 < ORD; ++c)
                  if (c + 1 < dq)
                    Dg[i - 1][c + 1][j] += Mv[r][j] * rb[0][c + 1][j] /
                                           static_cast<float>(c + 2);
              }
#pragma unroll
              for (int a = 0; a < ORD; ++a)
#pragma unroll
                for (int b = 0; b < ORD; ++b)
#pragma unroll
                  for (int j = 0; j < CPL; ++j) {
                    if (a < di && b < di)
                      mbar[j] = i >= 2 ? fmaf(coef[grid_tile<ORD>(
                                                  i >= 2 ? i : 2, a, b)][j],
                                              rn[a][b][j], mbar[j])
                                       : mbar[j] + rn[a][b][j];
                    rb[a][b][j] = rn[a][b][j];
                  }
            }
          } else {
            float prev[CPL];
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              prev[j] = g[M];
              mbar[j] = M >= 2 ? P[r][M >= 2 ? M - 2 : 0][j] * g[M] : g[M];
            }
#pragma unroll
            for (int m = M - 1; m >= 1; --m) {
              float t[CPL];
              const float tot = group_rev_excl_scan(D[m - 1], t, cpl, lg, G);
              if (chunked && s >= 0) {  // P^T over the chunks after this one
                const float z =
                    ch + 1 < nc ? zcar[carry_at(s, m - 1)] : 0.f;
#pragma unroll
                for (int j = 0; j < CPL; ++j) t[j] += z;
                if (ch > 0) zcar[carry_at(s, m - 1)] = z + tot;
              }
#pragma unroll
              for (int j = 0; j < CPL; ++j) {
                const float rb = g[m] + t[j];
                D[m - 1][j] = fmaf(Mv[r][j], prev[j], D[m - 1][j]);
                mbar[j] = m >= 2
                              ? fmaf(P[r][m >= 2 ? m - 2 : 0][j], rb, mbar[j])
                              : mbar[j] + rb;
                prev[j] = rb;
              }
            }
          }
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
#pragma unroll
            for (int w = 0; w < NW; ++w) W[r][w][j] *= mbar[j];
            if (M12) {  // the norm weights over their norms, for the chain
              W[r][M12 ? 4 : 0][j] /= fmaxf(nrow[r], kTinyDen);
              W[r][M12 ? 5 : 0][j] /= fmaxf(nin[j], kTinyDen);
            }
          }
        }

        // contractions, CB channels of the R rows at a time: the outer rows'
        // gradients (summed over the warp) and the inner steps' (accumulated)
        for (int c0 = 0; c0 < d2; c0 += CB) {
          float vals[32], oa[R][CB], ob[R][CB];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int q4 = 0; q4 < CB; q4 += 4) {
              float t[4];
              outer4(ov_o + srow[r] * d2, c0 + q4, d2, vec4 != 0, t);
#pragma unroll
              for (int e = 0; e < 4; ++e) oa[r][q4 + e] = t[e];
              if (diff) outer4(od_o + srow[r] * d2, c0 + q4, d2, vec4 != 0, t);
#pragma unroll
              for (int e = 0; e < 4; ++e) ob[r][q4 + e] = diff ? t[e] : 0.f;
            }
#pragma unroll
          for (int q = 0; q < CB; ++q) {
            const int c = c0 + q;
            float gv[R], gd[R];
#pragma unroll
            for (int r = 0; r < R; ++r) gv[r] = gd[r] = 0.f;
            if (c < d2) {
              float a[R], b[R];
#pragma unroll
              for (int r = 0; r < R; ++r) a[r] = oa[r][q], b[r] = ob[r][q];
#pragma unroll
              for (int j = 0; j < CPL; ++j) {
                if (j < cpl) {
                  const int at = c * cstride + j * 32 + lane;
                  const float x = in_v[at];
                  float av = acc_v[at];
#pragma unroll
                  for (int r = 0; r < R; ++r) {
                    gv[r] = fmaf(W[r][0][j], x, gv[r]);
                    gd[r] = fmaf(W[r][2][j], x, gd[r]);
                    av = fmaf(W[r][0][j], a[r], av);
                  }
                  if (diff) {
                    const float y = in_d[at];
                    float ad = acc_d[at];
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                      gv[r] = fmaf(W[r][1][j], y, gv[r]);
                      gd[r] = fmaf(W[r][3][j], y, gd[r]);
                      av = fmaf(W[r][2][j], b[r], av);
                      ad = fmaf(W[r][3][j], b[r], fmaf(W[r][1][j], a[r], ad));
                      if (M12 && c < d2 - 2) {  // the step-norm chains
                        gd[r] = fmaf(W[r][M12 ? 4 : 0][j], b[r], gd[r]);
                        ad = fmaf(W[r][M12 ? 5 : 0][j], y, ad);
                      }
                    }
                    acc_d[at] = ad;
                  }
                  acc_v[at] = av;
                }
              }
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
              vals[(2 * r) * CB + q] = gv[r];
              vals[(2 * r + 1) * CB + q] = gd[r];
            }
          }
          const float red = warp_reduce_scatter32(vals);
          const int r = lane / (2 * CB), half = (lane / CB) & 1;
          const int c = c0 + lane % CB, s = s_hi - r;
          if (c < d2 && s >= 0) {
            float* dst =
              gout_o + static_cast<size_t>(s) * 2 * d2 + half * d2 + c;
            *dst = ch == nc - 1 ? red : *dst + red;
          }
        }
      }
    }
  }

  // the inner steps' gradients of this range, once
  if (live_i) {
    float* gin_i =
        g_in + (static_cast<size_t>(i) * n_ranges + range) * Ti * 2 * d2;
    for (int ch = 0; ch < nc; ++ch) {
      const float* acc_v = ws + ch * chunk_ws + 2 * d2 * cstride;
      const float* acc_d = acc_v + d2 * cstride;
      for (int j = 0; j < cpl; ++j) {
        const int t = ch * W + lg + j * G;
        if (t >= Ti) continue;
        for (int c = 0; c < d2; ++c) {
          const int at = c * cstride + j * 32 + lane;
          gin_i[static_cast<size_t>(t) * 2 * d2 + c] = acc_v[at];
          gin_i[static_cast<size_t>(t) * 2 * d2 + d2 + c] = acc_d[at];
        }
      }
    }
  }
}

template <int M, int ORD, int CPL, int R, int D2, bool M12>
cudaError_t launch_seq_bwd_tiles(const float* ov, const float* od,
                                 const float* iv, const float* id,
                                 const float* no, const float* ni,
                                 const float* ct, float* g_out, float* g_in,
                                 float* gscratch, int n_out, int L_out,
                                 int n_in, int L_in, int d2, int base,
                                 int difference, int symmetric, int swap,
                                 int G, int cpl, int nc, int n_ranges,
                                 int ws_mode, int vec4, cudaStream_t stream) {
  const int To = difference ? L_out - 1 : L_out;
  const long long ws = seq_bwd_ws_floats(d2, cpl, nc);
  constexpr int NC = ORD > 1 ? grid_nc<M, ORD>() : M - 1;
  constexpr int NS = grid_ns<M, ORD>();
  const long long cs = seq_bwd_cs_floats(NC, NS, To, cpl, nc);
  const long long per_warp = ws_mode == 0 ? ws + cs : ws_mode == 1 ? ws : 0;
  const long long smem = per_warp * kWarpsPerBlock * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seq_bwd_kernel<M, ORD, CPL, R, D2, M12>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int gps = 32 / G;
  const long long warps =
      static_cast<long long>((n_in + gps - 1) / gps) * n_ranges;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  seq_bwd_kernel<M, ORD, CPL, R, D2, M12><<<static_cast<unsigned>(blocks),
                                            kSeqThreads,
                                            static_cast<size_t>(smem),
                                            stream>>>(
      ov, od, iv, id, no, ni, ct, g_out, g_in, gscratch, n_out, L_out, n_in,
      L_in, d2, base, difference, symmetric, swap, G, cpl, nc, n_ranges,
      ws_mode, vec4);
  return cudaGetLastError();
}

// One inner step a lane (inner length <= 32): four outer rows together
// (order 1; one at a higher order), with d2 = 16 (the benchmark's) a
// compile-time constant (not at an order past 1 with more than kMaxLevels
// levels, as in seq_fwd.cu); more: one row at a time, with room for
// kSeqCols steps a lane.  Outer rows are read as float4s when d2 is a multiple of 4
// and the rows are aligned.
template <int M, int ORD, bool M12>
cudaError_t launch_seq_bwd_base(const float* ov, const float* od,
                                const float* iv, const float* id,
                                const float* no, const float* ni,
                                const float* ct, float* g_out, float* g_in,
                                float* gscratch, int n_out, int L_out,
                                int n_in, int L_in, int d2, int base,
                                int difference, int symmetric, int swap,
                                int G, int cpl, int nc, int n_ranges,
                                int ws_mode, cudaStream_t stream) {
  const int vec4 = d2 % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(ov) |
                    reinterpret_cast<uintptr_t>(od)) % 16 == 0;
#define GPSIG_SEQ_BWD(CPL, R, D2)                                            \
  return launch_seq_bwd_tiles<M, ORD, CPL, R, D2, M12>(                      \
      ov, od, iv, id, no, ni, ct, g_out, g_in, gscratch, n_out, L_out, n_in, \
      L_in, d2, base, difference, symmetric, swap, G, cpl, nc, n_ranges,     \
      ws_mode, vec4, stream)
  constexpr int RS = ORD > 1 ? 1 : 4;  // rows together, one inner step a lane
  if constexpr (ORD == 1 || M <= kMaxLevels) {  // see above
    if (cpl == 1 && d2 == 16) GPSIG_SEQ_BWD(1, RS, 16);
  }
  if (cpl == 1) GPSIG_SEQ_BWD(1, RS, 0);
  GPSIG_SEQ_BWD(kSeqCols, 1, 0);
#undef GPSIG_SEQ_BWD
}

template <int M, int ORD = 1>
cudaError_t launch_seq_bwd(const float* ov, const float* od, const float* iv,
                           const float* id, const float* no, const float* ni,
                           const float* ct, float* g_out, float* g_in,
                           float* gscratch, int n_out, int L_out, int n_in,
                           int L_in, int d2, int base, int difference,
                           int symmetric, int swap, int G, int cpl, int nc,
                           int n_ranges, int ws_mode, cudaStream_t stream) {
  return (base == kMatern12 ? launch_seq_bwd_base<M, ORD, true>
                            : launch_seq_bwd_base<M, ORD, false>)(
      ov, od, iv, id, no, ni, ct, g_out, g_in, gscratch, n_out, L_out, n_in,
      L_in, d2, base, difference, symmetric, swap, G, cpl, nc, n_ranges,
      ws_mode, stream);
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_seq_bwd(const float* ov, const float* od,
                             const float* iv, const float* id,
                             const float* no, const float* ni,
                             const float* ct, float* g_out, float* g_in,
                             float* gscratch, int n_out, int L_out, int n_in,
                             int L_in, int d2, int num_levels, int order,
                             int base,
                             int difference, int symmetric, int swap, int G,
                             int cpl, int nc, int n_ranges, int ws_mode,
                             void* stream) {
  const bool pow2 = G > 0 && (G & (G - 1)) == 0;
  const int To = difference ? L_out - 1 : L_out;
  const int Ti = difference ? L_in - 1 : L_in;
  if (n_out <= 0 || n_in <= 0 || To < 0 || Ti < 0 || d2 <= 0 || !pow2 ||
      G > 32 || cpl <= 0 || cpl > gpsig::kSeqCols || nc < 1 ||
      Ti > static_cast<long long>(G) * cpl * nc || n_ranges <= 0 ||
      ws_mode < 0 || ws_mode > 2 ||
      (symmetric && (n_out != n_in || L_out != L_in || swap)) ||
      !gpsig::base_ok(base, no, ni))
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_SEQ(num_levels, order, gpsig::launch_seq_bwd, ov, od, iv, id,
                   no, ni, ct, g_out, g_in, gscratch, n_out, L_out, n_in,
                   L_in, d2, base, difference, symmetric, swap, G, cpl, nc,
                   n_ranges, ws_mode, static_cast<cudaStream_t>(stream))
}
