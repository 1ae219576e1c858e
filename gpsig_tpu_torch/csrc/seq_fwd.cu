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
// prefix of C_m along t.
//
// What bounds it on the card: per entry 4 dots of d2 (64 FMAs at d2 = 16)
// and 4 transcendentals (expf and 3 common.cuh::expm1_acc: ~75
// instructions), then ~3 FMAs a level -- ~0.3 G FMAs for the 500 x 500 Kzz
// of length-5 inducing sequences, ~0.6 G for Kzx at 500 x 50 (5 vs 93
// steps), ~0.7 G for a full 50 x 50 Kxx at 93 steps: instruction issue,
// and at Kzz each pair's fixed costs (16 entries a pair).  The previous
// design spent its time elsewhere: it reread the inner rows through __ldg
// at every outer step (a load per FMA), a lane owned strided steps so each
// level took cpl group scans an outer step, and short pairs ran 8 to a
// warp with group sums of 16 entries.
//
// The design:
//   * A group of G lanes (a power of two <= 32) takes one pair; lane lg
//     owns the CPL contiguous inner steps c W + lg CPL + j of chunk c (W =
//     G CPL), their rows held in registers for the whole sweep (REG, d2 <=
//     16 zero-padded; wider rows sit in a per-warp shared workspace).  So
//     no inner row is reloaded inside the sweep -- except past ~200
//     channels (PEMS has 963), where the workspace outgrows shared memory
//     and the rows are read through L1 at each outer step, as are outer
//     rows past 2,048 channels.
//   * A block owns 4 x 32 / G inner sequences and one outer sequence, or
//     up to 8 short ones in turn over the same inner rows (the Kzz of
//     4-step pairs); the outer rows are staged in shared memory (128 rows
//     at a time) and every lane reads them as broadcast float4s: one load
//     feeds 8 CPL FMAs.
//   * A level's prefix at an outer step is a serial in-lane prefix over the
//     lane's CPL steps plus one exclusive scan of the lane totals over the
//     group: (M-1)(log2 G + 1) shuffles an outer step, none at G = 1.  The
//     main path's group widths (2 and 32) are compiled in, so a row's
//     scans are straight-line code, and rows go two an iteration, so the
//     next row's dots and transcendentals overlap this row's scans.
//   * Short pairs take few lanes: the Kzz of length-5 inducing sequences
//     (4 x 4 steps) and Kzx (4 inner steps against 92 outer ones) run with
//     G = 2, CPL = 2, 16 pairs a warp, one shuffle a level and row.
//   * Inner sequences longer than a chunk of W steps are taken chunk by
//     chunk: P(R_m)[s, t] is the in-chunk prefix plus the row carry Y_m[s]
//     = sum_{s'<s} of row s''s R_m over the chunks before, which the sweep
//     of the chunk before left, per level and row, in shared memory (a
//     global scratch past 48 KB a block), double-buffered by chunk.  So any
//     length on both sides.
//   The wrapper picks G, CPL, which sequence goes inner and the outer
//   sequences a block takes from a cost estimate (ops/signature_cuda.py
//   _k5_plan).  In symmetric mode each unordered pair is computed once and
//   written to both places, so the Gram is exactly symmetric.
//
// Lengths differ natively: no padding to a common length (the TPU padded
// both to a multiple of 128).  With difference the last step of each
// sequence has dx = 0 (inducing_cuda._prep_seq repeats the last
// observation), so the sweep stops at L - 1 and repeat padding of a request
// stays exact; without difference all L observations count.
//
// matern12 (M12, a compile-time instance of each configuration): the entry
// is common.cuh's mat12_cross with the outer sequence on the x side and
// the inner one on the y side, floored by the step norms of both (no, ni:
// a lane holds its inner steps' next to their rows, an outer step's is a
// broadcast load) -- the form is symmetric in its two sides, so either
// argument may go inner.
//
// Inputs: outer rows ov, od (N_out, L_out, d2); inner rows iv, id (N_in,
// L_in, d2); with matern12 their step norms no (N_out, L_out) and ni (N_in,
// L_in), else null.  Output out (M+1, N1, N2), written at (m, o, i), or
// (m, i, o) when `swap` says the outer rows are the second argument's.
#include "common.cuh"

namespace gpsig {
namespace {

constexpr int kWarps = kSeqWarps;   // warps a block
constexpr int kRegD2 = 16;          // channels an inner row holds in REG
constexpr int kRowChunk = 128;      // outer rows staged at once, at most
constexpr int kOuterBytes = 16 * 1024;
constexpr int kCarryBytes = 48 * 1024;  // row carries in shared memory
constexpr long long kSmemMax = 227 * 1024;  // a block's, on the H100

// CPL: inner steps a lane; REG: inner rows in registers (d2 <= kRegD2);
// GC: the group width G as a compile-time constant (the plans of the main
// path: 2 for short inner sequences, 32 for long ones), or 0 for any G, so
// that a row's scans unroll into straight-line code; ORD: the order
// (common.cuh::grid_row past 1).
template <int M, int ORD, int CPL, bool REG, int GC, bool M12>
__global__ void __launch_bounds__(kSeqThreads)
seq_fwd_kernel(const float* __restrict__ ov, const float* __restrict__ od,
               const float* __restrict__ iv, const float* __restrict__ id,
               const float* __restrict__ no, const float* __restrict__ ni,
               float* __restrict__ out, float* __restrict__ gcarry,
               int n_out, int L_out, int n_in, int L_in, int d2, int base,
               int difference, int symmetric, int swap, int G_rt, int nc,
               int orng, int bpr, int rc, int carry_smem, int o_smem,
               int in_smem) {
  constexpr int MC = M > 1 ? M - 1 : 1;
  constexpr int NS = grid_ns<M, ORD>();  // scans a row (M - 1 at order 1)
  constexpr int NC = ORD > 1 ? grid_nc<M, ORD>() : 1;
  constexpr int NT = ORD > 1 ? grid_nt<M, ORD>() : 1;
  const int G = GC > 0 ? GC : G_rt;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const bool diff = difference != 0, sym = symmetric != 0;
  const bool chunked = nc > 1;
  const int To = diff ? L_out - 1 : L_out;
  const int Ti = diff ? L_in - 1 : L_in;
  const int P = 32 / G;                       // pairs a warp
  const int o0 = blockIdx.x / bpr * orng;  // this block's outer sequences
  const int i_lo = (sym ? o0 : 0) + (blockIdx.x % bpr) * kWarps * P;
  if (i_lo >= n_in) return;  // the whole block: before any barrier
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lg = lane % G, gi = lane / G;
  const int i = i_lo + warp * P + gi;
  const bool live = i < n_in;
  const int ic = live ? i : n_in - 1;  // dead groups sweep a live sequence
  const int W = G * CPL;
  const int xs = REG ? kRegD2 : (d2 + 3) & ~3;  // channels of a staged row

  // shared memory: outer rows [rc][2][xs] (o_smem), then, with chunks, the
  // row carries where they fit ([kWarps][2][To][NS][P]), then (not REG,
  // in_smem) the inner rows [kWarps][2][d2][32].  One chunk has no carries
  // and the launcher sizes no room for them.
  float* s_o = smem;
  float* s_c = s_o + (o_smem ? rc * 2 * xs : 0);
  const size_t carry_warp = 2 * static_cast<size_t>(To) * NS * P;
  float* carry = (carry_smem ? s_c : gcarry +
                  static_cast<size_t>(blockIdx.x) * kWarps * carry_warp) +
                 warp * carry_warp;
  float* s_in = s_c + (chunked && carry_smem ? kWarps * carry_warp : 0) +
                warp * 2 * d2 * 32;
  // row carry of scan k (order 1: level k + 1's) at row s, buffer `par`
  // (chunk parity)
  auto carry_at = [&](int par, int s, int k) {
    return ((par * To + s) * NS + k) * P + gi;
  };
  // the lane's inner rows of a chunk (zeros past the sequence), loaded once
  // for all of the block's outer sequences when the inner side is one chunk
  float xv[REG ? CPL : 1][kRegD2], xd[REG ? CPL : 1][kRegD2];
  bool valid[CPL];
  float nin[CPL];  // M12: the step norms of the lane's inner steps
  // not REG: channel c of the lane's inner value row is xin[c * xst] and of
  // its difference row xin[(d2 + c) * xst] (in_smem), or din[c] (through
  // L1, rows too wide for shared memory)
  const float* xin = s_in + lane;
  const float* din = nullptr;
  int xst = 32;

  for (int o = o0; o < min(n_out, o0 + orng); ++o) {
    if (sym && o > i_lo + kWarps * P - 1) break;  // no pair i >= o is left
    const float* ov_o = ov + static_cast<size_t>(o) * L_out * d2;
    const float* od_o = od + static_cast<size_t>(o) * L_out * d2;

    float acc[M + 1];
#pragma unroll
    for (int m = 0; m <= M; ++m) acc[m] = 0.f;

    for (int ch = 0; ch < nc; ++ch) {
      if (chunked || o == o0) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int t = ch * W + lg * CPL + j;
          valid[j] = t < Ti;
          const bool ok = t < L_in;
          const size_t row =
              (static_cast<size_t>(ic) * L_in + (ok ? t : 0)) * d2;
          nin[j] = M12 && ok ? __ldg(ni + static_cast<size_t>(ic) * L_in + t)
                             : 0.f;
          if (REG) {
#pragma unroll
            for (int c = 0; c < kRegD2; ++c) {
              xv[REG ? j : 0][c] = ok && c < d2 ? __ldg(iv + row + c) : 0.f;
              xd[REG ? j : 0][c] = ok && c < d2 ? __ldg(id + row + c) : 0.f;
            }
          } else if (in_smem) {  // CPL == 1: [2][d2][lane]
            __syncwarp();
            for (int c = 0; c < d2; ++c) {
              s_in[c * 32 + lane] = ok ? __ldg(iv + row + c) : 0.f;
              s_in[(d2 + c) * 32 + lane] = ok ? __ldg(id + row + c) : 0.f;
            }
            __syncwarp();
          } else {  // steps past the sequence are masked by valid[]
            xin = iv + row, din = id + row, xst = 1;
          }
        }
      }
      __syncwarp();  // the chunk before's carries are visible to the warp
      float C[MC][CPL];  // column sums of R_1 .. R_{M-1} over rows < s
      float cc[NC][CPL];  // order > 1: the grid's column carries
#pragma unroll
      for (int k = 0; k < MC; ++k)
#pragma unroll
        for (int j = 0; j < CPL; ++j) C[k][j] = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int j = 0; j < CPL; ++j) cc[k][j] = 0.f;

      for (int s0 = 0; s0 < To; s0 += rc) {
        const int rn = min(rc, To - s0);
        if (o_smem && (To > rc || ch == 0)) {  // stage outer rows s0 ..
          __syncthreads();
          for (int idx = threadIdx.x; idx < rn * 2 * xs; idx += kSeqThreads) {
            const int r = idx / (2 * xs), h = (idx / xs) % 2, c = idx % xs;
            const float* src = h ? od_o : ov_o;
            s_o[idx] = c < d2 ? src[static_cast<size_t>(s0 + r) * d2 + c] : 0.f;
          }
          __syncthreads();
        }
        // two rows an iteration: the next row's dots and transcendentals do
        // not wait on this row's scans
#pragma unroll 2
        for (int s = s0; s < s0 + rn; ++s) {
          // the outer row: staged, or (rows too wide) read through L1,
          // the same address in every lane
          const float* orow = s_o + (s - s0) * 2 * xs;
          const float* orow_v = o_smem ? orow : ov_o + s * d2;
          const float* orow_d = o_smem ? orow + xs : od_o + s * d2;
          float a00[CPL], d01[CPL], d10[CPL], dxx[CPL];
#pragma unroll
          for (int j = 0; j < CPL; ++j) a00[j] = d01[j] = d10[j] = dxx[j] = 0.f;
          if (REG) {
            const float4* a4 = reinterpret_cast<const float4*>(orow);
            const float4* b4 = reinterpret_cast<const float4*>(orow + xs);
#pragma unroll
            for (int c4 = 0; c4 < kRegD2 / 4; ++c4) {
              const float4 p4 = a4[c4];
              const float a[4] = {p4.x, p4.y, p4.z, p4.w};
              float b[4] = {0.f, 0.f, 0.f, 0.f};
              if (diff) {
                const float4 q4 = b4[c4];
                b[0] = q4.x, b[1] = q4.y, b[2] = q4.z, b[3] = q4.w;
              }
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int j = 0; j < CPL; ++j) {
                  const float x = xv[REG ? j : 0][4 * c4 + e];
                  const float y = xd[REG ? j : 0][4 * c4 + e];
                  a00[j] = fmaf(a[e], x, a00[j]);
                  d01[j] = fmaf(a[e], y, d01[j]);
                  d10[j] = fmaf(b[e], x, d10[j]);
                  dxx[j] = fmaf(b[e], y, dxx[j]);
                }
            }
          } else {
            for (int c = 0; c < d2; ++c) {
              const float a = orow_v[c], b = orow_d[c];
              const float x = xin[c * xst];
              const float y = in_smem ? xin[(d2 + c) * xst] : din[c];
              a00[0] = fmaf(a, x, a00[0]);
              d01[0] = fmaf(a, y, d01[0]);
              d10[0] = fmaf(b, x, d10[0]);
              dxx[0] = fmaf(b, y, dxx[0]);
            }
          }
          const float nos =
              M12 ? __ldg(no + static_cast<size_t>(o) * L_out + s) : 0.f;
          float Mv[CPL];
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            Mv[j] = valid[j] ? slot_gram_zz<true, M12>(a00[j], d01[j], d10[j],
                                                       dxx[j], base, diff,
                                                       nos, nin[j])
                             : 0.f;
          // exclusive prefix y of x along the inner steps at this row:
          // in-lane prefix, one group scan of the lane totals, the row
          // carry of the chunks before (scan `slot`'s own)
          auto scan = [&](const float (&x)[CPL], float (&y)[CPL], int slot) {
            float run = 0.f;
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              y[j] = run;
              run += x[j];
            }
            float incl = run;
#pragma unroll
            for (int off = 1; off < (GC > 0 ? GC : 32); off <<= 1) {
              if (GC == 0 && off >= G) break;
              const float t = __shfl_up_sync(0xffffffffu, incl, off, G);
              if (lg >= off) incl += t;
            }
            float base_s = __shfl_up_sync(0xffffffffu, incl, 1, G);
            base_s = lg == 0 ? 0.f : base_s;
            if (chunked) {
              const float y0 = ch > 0 ? carry[carry_at(ch & 1, s, slot)] : 0.f;
              base_s += y0;
              const float tot = __shfl_sync(0xffffffffu, incl, G - 1, G);
              if (ch + 1 < nc && lg == 0)
                carry[carry_at((ch + 1) & 1, s, slot)] = y0 + tot;
            }
#pragma unroll
            for (int j = 0; j < CPL; ++j) y[j] += base_s;
          };
          if constexpr (ORD > 1) {
            // the grid at this row, then its level sums and column carries
            float coef[NT][CPL];
            grid_row<M, ORD, CPL>(Mv, cc, scan, coef);
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              acc[1] += Mv[j];
              cc[0][j] += Mv[j];
#pragma unroll
              for (int i = 2; i <= M; ++i) {
                const int d = grid_d<ORD>(i);
#pragma unroll
                for (int a = 0; a < ORD; ++a)
#pragma unroll
                  for (int b = 0; b < ORD; ++b)
                    if (a < d && b < d) {
                      const float r = Mv[j] * coef[grid_tile<ORD>(i, a, b)][j];
                      acc[i] += r;
                      if (i < M) cc[grid_cc_at<ORD>(i, b)][j] += r;
                    }
              }
            }
          } else {
            // P(R_{k+1})[s, .] for k = 0 .. M-2
            float Pv[MC][CPL];
#pragma unroll
            for (int k = 0; k < M - 1; ++k) scan(C[k], Pv[k], k);
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              acc[1] += Mv[j];
              if (M > 1) C[0][j] += Mv[j];
#pragma unroll
              for (int m = 2; m <= M; ++m) {
                const float r = Mv[j] * Pv[m - 2][j];
                acc[m] += r;
                if (m < M) C[m - 1][j] += r;
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int m = 1; m <= M; ++m) acc[m] = group_sum(acc[m], G);
    if (live && lg == 0 && (!sym || i >= o)) {
      const size_t plane = static_cast<size_t>(n_out) * n_in;
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

template <int M, int ORD, int CPL, bool REG, int GC, bool M12>
cudaError_t launch_seq_fwd_tiles(const float* ov, const float* od,
                                 const float* iv, const float* id,
                                 const float* no, const float* ni, float* out,
                                 float* gcarry, int n_out, int L_out,
                                 int n_in, int L_in, int d2, int base,
                                 int difference, int symmetric, int swap,
                                 int G, int nc, int orng,
                                 cudaStream_t stream) {
  const int To = difference ? L_out - 1 : L_out;
  const int xs = REG ? kRegD2 : (d2 + 3) & ~3;
  int rc = kOuterBytes / (2 * xs * static_cast<int>(sizeof(float)));
  // an outer row pair wider than kOuterBytes is read through L1
  const int o_smem = rc >= 1 ? 1 : 0;
  rc = rc < kRowChunk ? rc : kRowChunk;
  rc = rc < To ? rc : To;
  rc = rc > 1 ? rc : 1;
  if (!o_smem) rc = To > 1 ? To : 1;
  const long long carry_block = nc > 1 ? 2LL * kWarps * To *
                                             grid_ns<M, ORD>() * (32 / G) *
                                             sizeof(float)
                                       : 0;
  const int carry_smem = carry_block <= kCarryBytes ? 1 : 0;
  if (!carry_smem && gcarry == nullptr) return cudaErrorInvalidValue;
  long long smem = (o_smem ? static_cast<long long>(rc) * 2 * xs *
                                 sizeof(float)
                           : 0) +
                   (carry_smem ? carry_block : 0);
  // not REG: the inner rows in shared memory where they fit, else read
  // through L1 at each outer step (d2 past ~200)
  const long long in_bytes = 2LL * kWarps * d2 * 32 * sizeof(float);
  const int in_smem = !REG && smem + in_bytes <= kSmemMax ? 1 : 0;
  smem += in_smem ? in_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seq_fwd_kernel<M, ORD, CPL, REG, GC, M12>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int per_block = kWarps * (32 / G);  // inner sequences a block
  const int bpr = (n_in + per_block - 1) / per_block;
  const long long blocks =
      static_cast<long long>((n_out + orng - 1) / orng) * bpr;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  seq_fwd_kernel<M, ORD, CPL, REG, GC, M12><<<static_cast<unsigned>(blocks),
                                              kSeqThreads,
                                              static_cast<size_t>(smem),
                                              stream>>>(
      ov, od, iv, id, no, ni, out, gcarry, n_out, L_out, n_in, L_in, d2, base,
      difference, symmetric, swap, G, nc, orng, bpr, rc, carry_smem, o_smem,
      in_smem);
  return cudaGetLastError();
}

// d2 <= 16: inner rows in registers, one or two steps a lane, with the
// group widths of the main path's plans compiled in (not at an order past
// 1 with more than kMaxLevels levels: that library's grid unrolls far, and
// its build would set the smoke run's; it holds the general instances);
// wider rows: one step a lane, its row in shared memory where it fits,
// else read through L1.
template <int M, int ORD, bool M12>
cudaError_t launch_seq_fwd_base(const float* ov, const float* od,
                                const float* iv, const float* id,
                                const float* no, const float* ni, float* out,
                                float* gcarry, int n_out, int L_out, int n_in,
                                int L_in, int d2, int base, int difference,
                                int symmetric, int swap, int G, int cpl,
                                int nc, int orng, cudaStream_t stream) {
#define GPSIG_SEQ_FWD(CPL, REG, GC)                                          \
  return launch_seq_fwd_tiles<M, ORD, CPL, REG, GC, M12>(                    \
      ov, od, iv, id, no, ni, out, gcarry, n_out, L_out, n_in, L_in, d2,     \
      base, difference, symmetric, swap, G, nc, orng, stream)
  if constexpr (ORD == 1 || M <= kMaxLevels) {  // see above
    if (d2 <= kRegD2 && cpl == 2 && G == 2) GPSIG_SEQ_FWD(2, true, 2);
    if (d2 <= kRegD2 && cpl == 2 && G == 32) GPSIG_SEQ_FWD(2, true, 32);
  }
  if (d2 <= kRegD2 && cpl == 2) GPSIG_SEQ_FWD(2, true, 0);
  if (d2 <= kRegD2 && cpl == 1) GPSIG_SEQ_FWD(1, true, 0);
  if (cpl == 1) GPSIG_SEQ_FWD(1, false, 0);
#undef GPSIG_SEQ_FWD
  return cudaErrorInvalidValue;
}

template <int M, int ORD = 1>
cudaError_t launch_seq_fwd(const float* ov, const float* od, const float* iv,
                           const float* id, const float* no, const float* ni,
                           float* out, float* gcarry, int n_out, int L_out,
                           int n_in, int L_in, int d2, int base,
                           int difference, int symmetric, int swap, int G,
                           int cpl, int nc, int orng, cudaStream_t stream) {
  return (base == kMatern12 ? launch_seq_fwd_base<M, ORD, true>
                            : launch_seq_fwd_base<M, ORD, false>)(
      ov, od, iv, id, no, ni, out, gcarry, n_out, L_out, n_in, L_in, d2,
      base, difference, symmetric, swap, G, cpl, nc, orng, stream);
}

}  // namespace
}  // namespace gpsig

// gcarry: the row carries past kCarryBytes a block, (blocks, 4 warps, 2, To,
// scans a row (common.cuh::grid_ns), 32 / G) floats; may be null otherwise.
// order: the main library holds order 1, one built with -DGPSIG_ORDER
// that order alone (GPSIG_SWITCH_SEQ).
extern "C" int gpsig_seq_fwd(const float* ov, const float* od,
                             const float* iv, const float* id,
                             const float* no, const float* ni, float* out,
                             float* gcarry, int n_out, int L_out, int n_in,
                             int L_in, int d2, int num_levels, int order,
                             int base,
                             int difference, int symmetric, int swap, int G,
                             int cpl, int nc, int orng, void* stream) {
  const bool pow2 = G > 0 && (G & (G - 1)) == 0;
  const int Ti = difference ? L_in - 1 : L_in;
  if (n_out <= 0 || n_in <= 0 || L_out <= 0 || L_in <= 0 || d2 <= 0 ||
      !pow2 || G > 32 || cpl < 1 || cpl > 2 || nc < 0 || orng < 1 ||
      static_cast<long long>(G) * cpl * nc < Ti ||
      (symmetric && (n_out != n_in || L_out != L_in || swap)) ||
      !gpsig::base_ok(base, no, ni))
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_SEQ(num_levels, order, gpsig::launch_seq_fwd, ov, od, iv, id,
                   no, ni, out, gcarry, n_out, L_out, n_in, L_in, d2, base,
                   difference, symmetric, swap, G, cpl, nc, orng,
                   static_cast<cudaStream_t>(stream))
}

// Test hook, not a kernel of any path: for args[i] = (a00, d01, d10, dxx)
// writes out[2i] = (expm1_acc(a00), expm1f(a00), the rbf slot Gram with
// expm1_acc, the same with expm1f) and out[2i + 1] = its partials
// dG/d(d01, d10, dxx) with expm1_acc (K2's weights) and dG/d(d01) with
// expm1f, so that the shorter expm1 is held against float64 alone and where
// its terms cancel (chip_smoke.py phase 2e, tests/test_torch_cuda_kernels.py).
namespace gpsig {
namespace {
__global__ void expm1_probe_kernel(const float4* __restrict__ args,
                                   float4* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 a = args[i];
  float p[6], pf[6];
  const float g = slot_gram_zz_partials<true>(a.x, a.y, a.z, a.w, kRbf, true,
                                              p);
  const float gf = slot_gram_zz_partials<false>(a.x, a.y, a.z, a.w, kRbf,
                                                true, pf);
  out[2 * i] = make_float4(expm1_acc(a.x), expm1f(a.x), g, gf);
  out[2 * i + 1] = make_float4(p[1], p[2], p[3], pf[1]);
}

// Test hook, not a kernel of any path: for args[i] = (a00, d01, d10, dxx,
// nx, ny, -, -) writes out[i] = (mat12_cross as K1, K3 and K5 evaluate it,
// its value and six partials dM/d(a00, d01, d10, dxx, nx, ny) as K2 takes
// them (expm1_acc), the value as K4 and K6 take it (expm1f)), so that the
// device algebra is held against float64 (chip_smoke.py phase 9a).
__global__ void m12_probe_kernel(const float* __restrict__ args,
                                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* a = args + 8 * static_cast<size_t>(i);
  float p[6], pf[6];
  float* o = out + 9 * static_cast<size_t>(i);
  o[0] = mat12_cross<true>(a[0], a[1], a[2], a[3], a[4], a[5]);
  o[1] = mat12_cross_partials<true>(a[0], a[1], a[2], a[3], a[4], a[5], p);
  o[8] = mat12_cross_partials<false>(a[0], a[1], a[2], a[3], a[4], a[5], pf);
  for (int k = 0; k < 6; ++k) o[2 + k] = p[k];
}
}  // namespace
}  // namespace gpsig

extern "C" int gpsig_expm1_probe(const float* args, float* out, int n,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gpsig::expm1_probe_kernel<<<(n + 255) / 256, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(args), reinterpret_cast<float4*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gpsig_m12_probe(const float* args, float* out, int n,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gpsig::m12_probe_kernel<<<(n + 255) / 256, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(args, out,
                                                                 n);
  return static_cast<int>(cudaGetLastError());
}
