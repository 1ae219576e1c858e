// K2, Kzz backward: the VJP of K1 (kzz_fwd.cu) under a cotangent ct of the
// (M+1, nZ, nZ) level stack.  Replaces the TPU kernel _kernel_tens_bwd
// (gpsig_tpu/ops/inducing_pallas.py:256, launched by _make_tens_core.bwd
// :493).
//
// Level m at (i, j) is the product of its m slot Grams G_s(i, j), so slot s
// receives Mbar_s = ct[m](i, j) * prod_{r != s} G_r(i, j) (exclusive
// products, inducing_pallas.py:276-290), and its four weights W = Mbar_s *
// dG_s/d(a00, d01, d10, dxx) (common.cuh::slot_gram_zz_partials) spread
// over the rows:
//   g_vl[i] += W_A00 vr[j] + W_d01 dr[j]    g_dl[i] += W_d10 vr[j] + W_dxx dr[j]
//   g_vr[j] += W_A00 vl[i] + W_d10 dl[i]    g_dr[j] += W_d01 vl[i] + W_dxx dl[i]
// Symmetric mode (K1's): the cotangent is folded onto the upper triangle
// (ct + ct^T above the diagonal, ct on it, 0 below; inducing_cuda._fold), as
// the TPU's mirror adjoint does (inducing_pallas.py:497-501), and only the
// upper tile pairs are evaluated.  The kernel folds as it reads: a tile's
// ct^T comes in coalesced through shared memory.
//
// What bounds it on the card: at the training shape (lt=10, nZ=500, d2=16,
// symmetric) 125k unordered pairs x 10 slots, each slot Gram evaluated once
// (4 dots of 16, expf and three common.cuh::expm1_acc) and its four
// weights contracted with 16-wide rows on both sides (8 x 16 FMAs): ~0.2 G
// FMAs against ~6 MB of inputs and outputs, FMA and transcendental issue
// (~0.007 ms at 67 TFLOP/s, transcendentals not counted).
//
// The design:
//   * the strips of 32 rows go in `ranges` ranges of `per` strips (one
//     strip a range up to nZ = 1,024); a block takes one range pair (the
//     upper ones when symmetric) at one level -- at nZ=500, M=4, 136 x 4 =
//     544 blocks of 256 threads, the highest level first; one code body
//     for every level (run-time slot loops), so the blocks on an SM share
//     their instructions;
//   * for each tile pair of its ranges, each thread computes the slot
//     Grams, partials, exclusive products and weights of its 2 x 2 pairs,
//     once (rows staged 16 channels at a time, double-buffered so that the
//     next slot's loads overlap this one's work, common.cuh zz_stage /
//     zz_dots); then, slot by slot, the weights go to shared memory and the
//     block contracts them with the staged rows of both tiles: two warps
//     for each of g_vl, g_dl (strip I) and g_vr, g_dr (strip J), a thread
//     2 rows x 4 channels, 6 shared loads for 16 FMAs;
//   * shared memory is two channel blocks of rows and one slot's weights,
//     37 KB at any width and level count (46 KB with matern12);
//   * a block writes its lhs gradients into the partial slab of its J
//     range and its rhs gradients into that of its I range, adding over
//     the tile pairs it walks (each thread re-reads only what it wrote);
//     when symmetric it also writes zeros where the mirrored range pair
//     would write, so every slab entry is written by exactly one block and
//     the wrapper sums the slabs with torch.sum: no atomics, the result is
//     deterministic.
//
// matern12 (M12, a compile-time instance): pass 1 keeps a slot's four dots,
// not its Gram and partials (the rbf shortcut that dG/da00 = G does not
// hold); the weights step evaluates the closed forms (common.cuh
// mat12_cross) for the exclusive products and keeps Mbar; pass 2 takes the
// six partials (mat12_cross_partials) as it writes the slot's weights.  The
// two step-norm weights W_nx, W_ny, divided by their norms, take two more
// planes of shared memory (46 KB in all), and the warps of g_dl and g_dr
// add their chain, dl[i] * sum_j W_nx(i, j) / max(n_i, 1e-30) over the
// true channels (signature_pallas._norm_chain_col / _row :218-238), to the
// contraction.
//
// Inputs are (lt, nZ, d2) row-major float32 (inducing_cuda._prep_tensors),
// with matern12 the step norms nl, nr (lt, nZ) of dl and dr (else null),
// and ct (M+1, nZ, nZ); out is (ranges, 2 sides, 2 [value, difference], lt,
// nZ, d2p) -- in that order g_vl, g_dl, g_vr, g_dr -- d2p = d2 rounded up
// to 16, side 0 the lhs rows (vl, dl), side 1 the rhs rows (vr, dr).
#include "common.cuh"

namespace gpsig {
namespace {

struct KzzBwdArgs {
  const float* vl;
  const float* dl;
  const float* vr;
  const float* dr;
  const float* nl;
  const float* nr;
  const float* ct;
  float* out;
  int nz, d2, d2p, lt, base, increments, symmetric, ranges, per, strips;
};

// W_A00, W_d01, W_d10, W_dxx of a slot; M12: W_nx / nx, W_ny / ny too
template <bool M12>
struct __align__(16) KzzBwdSmem {
  ZzRows rows[2];  // double-buffered staged rows
  float w[M12 ? 6 : 4][kZzTile][kZzTile + 1];
};

// The thread's 2 rows x 4 channels of gradient g over the staged channel
// block: g = 0, 1 the lhs value / difference rows of the tile's rows (the
// weights (A00, d01) / (d10, dxx) against the rhs rows vr, dr), g = 2, 3 the
// rhs value / difference rows of its columns ((A00, d10) / (d01, dxx)
// against vl, dl).  Row r and r + 16, channels 4q .. 4q + 3.  M12: g = 1,
// 3 add the norm chain over the block's true channels (the first n_true).
template <bool M12>
__device__ __forceinline__ void kzz_contract(const KzzBwdSmem<M12>& s,
                                             const ZzRows& rows, int g,
                                             int r, int q, int n_true,
                                             float (&acc)[2][4]) {
  const bool lhs = g < 2;
  const int xa = g == 1 ? 2 : g == 3 ? 1 : 0;
  const int xb = g == 0 ? 1 : g == 2 ? 2 : 3;
  const float* wa = &s.w[xa][0][0];
  const float* wb = &s.w[xb][0][0];
  // W[i][j]: the lhs side sums over j, the rhs side over i
  const int rs = lhs ? kZzTile + 1 : 1, ks = lhs ? 1 : kZzTile + 1;
  const float(*xv)[kZzPad] = rows.r[lhs ? 2 : 0];
  const float(*xd)[kZzPad] = rows.r[lhs ? 3 : 1];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
#pragma unroll 8
  for (int k = 0; k < kZzTile; ++k) {
    const float a0 = wa[r * rs + k * ks], a1 = wa[(r + 16) * rs + k * ks];
    const float b0 = wb[r * rs + k * ks], b1 = wb[(r + 16) * rs + k * ks];
    const float4 v = reinterpret_cast<const float4*>(xv[k])[q];
    const float4 d = reinterpret_cast<const float4*>(xd[k])[q];
    acc[0][0] = fmaf(a0, v.x, fmaf(b0, d.x, acc[0][0]));
    acc[0][1] = fmaf(a0, v.y, fmaf(b0, d.y, acc[0][1]));
    acc[0][2] = fmaf(a0, v.z, fmaf(b0, d.z, acc[0][2]));
    acc[0][3] = fmaf(a0, v.w, fmaf(b0, d.w, acc[0][3]));
    acc[1][0] = fmaf(a1, v.x, fmaf(b1, d.x, acc[1][0]));
    acc[1][1] = fmaf(a1, v.y, fmaf(b1, d.y, acc[1][1]));
    acc[1][2] = fmaf(a1, v.z, fmaf(b1, d.z, acc[1][2]));
    acc[1][3] = fmaf(a1, v.w, fmaf(b1, d.w, acc[1][3]));
  }
  if (M12 && (g & 1)) {
    // the step-norm chain: the row's summed W_n / n times its own
    // difference channels
    const float* wn = &s.w[g == 1 ? 4 : 5][0][0];
    float n0 = 0.f, n1 = 0.f;
#pragma unroll 8
    for (int k = 0; k < kZzTile; ++k) {
      n0 += wn[r * rs + k * ks];
      n1 += wn[(r + 16) * rs + k * ks];
    }
    const float(*own)[kZzPad] = rows.r[g == 1 ? 1 : 3];
    const float4 o0 = reinterpret_cast<const float4*>(own[r])[q];
    const float4 o1 = reinterpret_cast<const float4*>(own[r + 16])[q];
    const float x0[4] = {o0.x, o0.y, o0.z, o0.w};
    const float x1[4] = {o1.x, o1.y, o1.z, o1.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * q + e < n_true) {
        acc[0][e] = fmaf(n0, x0[e], acc[0][e]);
        acc[1][e] = fmaf(n1, x1[e], acc[1][e]);
      }
    }
  }
}

// Row `row` of slab p's gradient (side, value / difference vd) of slot k.
__device__ __forceinline__ float* slab(const KzzBwdArgs& A, int p, int side,
                                       int vd, int k, int row) {
  return A.out +
         ((((static_cast<size_t>(p) * 2 + side) * 2 + vd) * A.lt + k) * A.nz +
          row) * A.d2p;
}

// Level m of range pair (ra, rb): slots k0 .. k0 + m - 1.  One body for
// every level: the slot loops run at run time, so a block's code is the same
// whatever its level, and the thread's slot Grams and partials sit in
// register arrays sized for M, written and read at compile-time indices
// picked by predicates.
//
// A tile pair is a sequence of steps, each on one staged channel block of
// one slot's rows while the next step's rows are staged into the other
// buffer, each ending in a barrier:
//   pass 1, every slot: the dots, then (at its last channel block) the slot
//     Grams and partials, once;
//   then the weights W = ct * prod_{r != s} G_r * dG_s of every slot, in
//     place, in registers;
//   pass 2, every slot: its weights into shared memory (at its first
//     channel block), then the contraction.
// dG/da00 is not kept: it is G for rbf and a constant for the linear base.
template <int M, bool M12>
__device__ __forceinline__ void kzz_bwd_level(KzzBwdSmem<M12>& s,
                                              const KzzBwdArgs& A, int m,
                                              int ra, int rb) {
  const int k0 = m * (m - 1) / 2;
  const int ncb = A.d2p / kZzCB;
  const int steps = 2 * m * ncb;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = w >> 1;                          // the gradient it sums
  const int q = lane & 3, r = (lane >> 2) + 8 * (w & 1);
  const bool inc = A.increments != 0, sym = A.symmetric != 0;
  const bool rbf = A.base == kRbf;
  const size_t plane = static_cast<size_t>(A.nz) * A.nz;
  const int i_begin = ra * A.per, i_end = min(i_begin + A.per, A.strips);
  const int j_begin = rb * A.per, j_end = min(j_begin + A.per, A.strips);

  if (sym && ra < rb) {
    // the entries the mirrored range pair (rb, ra) would write: the lhs
    // rows of range rb in slab ra and the rhs rows of range ra in slab rb
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int side = 0; side < 2; ++side) {
      const int p = side ? rb : ra;
      const int r0 = (side ? i_begin : j_begin) * kZzTile;
      const int r1 = min((side ? i_end : j_end) * kZzTile, A.nz);
      const int n4 = (r1 - r0) * A.d2p / 4;
      for (int vd = 0; vd < 2; ++vd)
        for (int sl = 0; sl < m; ++sl) {
          float4* dst =
              reinterpret_cast<float4*>(slab(A, p, side, vd, k0 + sl, r0));
          for (int idx = threadIdx.x; idx < n4; idx += kZzThreads)
            dst[idx] = zero;
        }
    }
  }

  for (int ti = i_begin; ti < i_end; ++ti) {
    const int j_first = sym && ra == rb ? ti : j_begin;
    for (int tj = j_first; tj < j_end; ++tj) {
      const int i0 = ti * kZzTile, j0 = tj * kZzTile;
      const bool diag = sym && ti == tj;
      // the first step's rows; when symmetric, the tile's cotangent
      // transposed, for the fold
      zz_stage(s.rows[0], A.vl, A.dl, A.vr, A.dr, k0, i0, j0, 0, A.nz, A.d2);
      if (sym) {
        for (int e = threadIdx.x; e < kZzTile * kZzTile; e += kZzThreads) {
          const int row = j0 + e / kZzTile, col = i0 + e % kZzTile;
          s.w[0][e / kZzTile][e % kZzTile] =
              row < A.nz && col < A.nz
                  ? A.ct[m * plane + static_cast<size_t>(row) * A.nz + col]
                  : 0.f;
        }
      }
      __syncthreads();
      // the cotangent of the thread's pairs; when symmetric folded onto the
      // upper triangle (ct + ct^T above the diagonal, ct on it, 0 below)
      float c[4];
#pragma unroll
      for (int pq = 0; pq < 4; ++pq) {
        const int il = ty + 16 * (pq >> 1), jl = tx + 16 * (pq & 1);
        const int i = i0 + il, j = j0 + jl;
        c[pq] = i < A.nz && j < A.nz
                    ? A.ct[m * plane + static_cast<size_t>(i) * A.nz + j]
                    : 0.f;
        if (diag && il > jl) c[pq] = 0.f;
        else if (sym && (!diag || il < jl)) c[pq] += s.w[0][jl][il];
      }
      // lhs gradients of strip I add over its J tiles, rhs ones of strip J
      // over its I tiles; the first of each is written
      const bool first = g < 2 ? tj == j_first : ti == i_begin;
      const int p_slab = g < 2 ? rb : ra, side = g < 2 ? 0 : 1;
      const int row0 = g < 2 ? i0 : j0;

      // G[u]: slot u's Gram, then its weight W_A00; P[u]: its partials
      // dG/d(d01, d10, dxx), then their weights.  M12: G[u] and P[u] hold
      // the slot's dots (a00; d01, d10, dxx) and Mb[u] its Mbar
      float G[M][4], P[M][4][3], acc[4][4];
      float Mb[M12 ? M : 1][4];
      // the step norms of the thread's pair pq in slot k (M12)
      auto norms = [&](int k, int pq, float& nx, float& ny) {
        const int i = i0 + ty + 16 * (pq >> 1), j = j0 + tx + 16 * (pq & 1);
        const size_t at = static_cast<size_t>(k) * A.nz;
        nx = i < A.nz ? __ldg(A.nl + at + i) : 0.f;
        ny = j < A.nz ? __ldg(A.nr + at + j) : 0.f;
      };
      int buf = 0;
      for (int t = 0; t < steps; ++t) {
        const bool pass1 = t < m * ncb;
        const int sl = (pass1 ? t : t - m * ncb) / ncb, cb = t % ncb;
        if (t + 1 < steps) {  // the next step's rows into the other buffer
          const int tn = t + 1 < m * ncb ? t + 1 : t + 1 - m * ncb;
          zz_stage(s.rows[buf ^ 1], A.vl, A.dl, A.vr, A.dr, k0 + tn / ncb,
                   i0, j0, tn % ncb, A.nz, A.d2);
        }
        if (pass1) {
          if (cb == 0) {
#pragma unroll
            for (int pq = 0; pq < 4; ++pq)
              acc[pq][0] = acc[pq][1] = acc[pq][2] = acc[pq][3] = 0.f;
          }
          zz_dots(s.rows[buf], acc);
          if (cb == ncb - 1) {
#pragma unroll
            for (int pq = 0; pq < 4; ++pq) {
              float pd[6] = {acc[pq][0], acc[pq][1], acc[pq][2], acc[pq][3]};
              const float gv =
                  M12 ? acc[pq][0]
                      : slot_gram_zz_partials<true>(
                            acc[pq][0], acc[pq][1], acc[pq][2], acc[pq][3],
                            A.base, inc, pd);
#pragma unroll
              for (int u = 0; u < M; ++u) {
                if (u == sl) {
                  G[u][pq] = gv;
                  P[u][pq][0] = pd[1], P[u][pq][1] = pd[2];
                  P[u][pq][2] = pd[3];
                }
              }
            }
          }
          if (M12 && t == m * ncb - 1) {
            // each slot's Gram from its dots, then Mbar_s = ct * prod_{r !=
            // s} G_r, kept for pass 2
#pragma unroll
            for (int pq = 0; pq < 4; ++pq) {
              float gv[M];
#pragma unroll
              for (int u = 0; u < M; ++u) {
                gv[u] = 1.f;
                if (u < m) {
                  float nx, ny;
                  norms(k0 + u, pq, nx, ny);
                  gv[u] = slot_gram_zz<true, true>(
                      G[u][pq], P[u][pq][0], P[u][pq][1], P[u][pq][2],
                      A.base, inc, nx, ny);
                }
              }
              float pre = c[pq];
#pragma unroll
              for (int u = 0; u < M; ++u) {
                float suf = 1.f;
#pragma unroll
                for (int v = u + 1; v < M; ++v) suf *= gv[v];
                Mb[M12 ? u : 0][pq] = pre * suf;
                pre *= gv[u];
              }
            }
          } else if (t == m * ncb - 1) {
            // every slot's weights, in place: Mbar_s = ct * prod_{r < s} G_r
            // * prod_{r > s} G_r, G_s read before it becomes W_A00
#pragma unroll
            for (int pq = 0; pq < 4; ++pq) {
              float pre = c[pq];
#pragma unroll
              for (int u = 0; u < M; ++u) {
                if (u < m) {
                  float suf = 1.f;
#pragma unroll
                  for (int v = u + 1; v < M; ++v)
                    if (v < m) suf *= G[v][pq];
                  const float mbar = pre * suf;
                  pre *= G[u][pq];
                  G[u][pq] = mbar * (rbf ? G[u][pq] : (inc ? 0.f : 1.f));
#pragma unroll
                  for (int x = 0; x < 3; ++x) P[u][pq][x] *= mbar;
                }
              }
            }
          }
        } else {
          if (cb == 0) {  // slot sl's weights; the slot before's are read
#pragma unroll
            for (int u = 0; u < M; ++u) {
              if (u == sl) {
#pragma unroll
                for (int pq = 0; pq < 4; ++pq) {
                  const int il = ty + 16 * (pq >> 1), jl = tx + 16 * (pq & 1);
                  if (M12) {  // the six partials from the kept dots
                    float nx, ny, pd[6];
                    norms(k0 + u, pq, nx, ny);
                    slot_gram_zz_partials<true, true>(
                        G[u][pq], P[u][pq][0], P[u][pq][1], P[u][pq][2],
                        A.base, inc, pd, nx, ny);
                    const float mb = Mb[M12 ? u : 0][pq];
#pragma unroll
                    for (int x = 0; x < 4; ++x) s.w[x][il][jl] = mb * pd[x];
                    s.w[M12 ? 4 : 0][il][jl] = mb * pd[4] / fmaxf(nx, kTinyDen);
                    s.w[M12 ? 5 : 0][il][jl] = mb * pd[5] / fmaxf(ny, kTinyDen);
                  } else {
                    s.w[0][il][jl] = G[u][pq];
#pragma unroll
                    for (int x = 0; x < 3; ++x)
                      s.w[x + 1][il][jl] = P[u][pq][x];
                  }
                }
              }
            }
            __syncthreads();  // the weights are written
          }
          float out[2][4];
          kzz_contract<M12>(s, s.rows[buf], g, r, q,
                            A.d2 - 2 - cb * kZzCB, out);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + r + 16 * h;
            if (row >= A.nz) continue;
            float4* dst = reinterpret_cast<float4*>(
                slab(A, p_slab, side, g & 1, k0 + sl, row) + cb * kZzCB) + q;
            float4 v = make_float4(out[h][0], out[h][1], out[h][2],
                                   out[h][3]);
            if (!first) {
              const float4 o = *dst;
              v.x += o.x, v.y += o.y, v.z += o.z, v.w += o.w;
            }
            *dst = v;
          }
        }
        __syncthreads();  // this step's rows (and weights) are read
        buf ^= 1;
      }
    }
  }
}

// Two blocks an SM (128 registers, a few spilled): on the H100 as fast as
// one block of 230 registers with none, and faster than three.  matern12
// spilled ~1 KB a thread at 128 registers: one block an SM.
template <int M, bool M12>
__global__ void __launch_bounds__(kZzThreads, M12 ? 1 : 2)
kzz_bwd_kernel(const KzzBwdArgs A) {
  __shared__ KzzBwdSmem<M12> s;
  const int n_pairs =
      A.symmetric ? A.ranges * (A.ranges + 1) / 2 : A.ranges * A.ranges;
  const int m = M - static_cast<int>(blockIdx.x) / n_pairs;
  const int p = static_cast<int>(blockIdx.x) % n_pairs;
  int ra, rb;
  if (A.symmetric) {
    upper_pair(p, A.ranges, ra, rb);
  } else {
    ra = p / A.ranges;
    rb = p % A.ranges;
  }
  kzz_bwd_level<M, M12>(s, A, m, ra, rb);
}

template <int M>
cudaError_t launch_kzz_bwd(const KzzBwdArgs& A, cudaStream_t stream) {
  const int n_pairs =
      A.symmetric ? A.ranges * (A.ranges + 1) / 2 : A.ranges * A.ranges;
  auto* kernel = A.base == kMatern12 ? kzz_bwd_kernel<M, true>
                                     : kzz_bwd_kernel<M, false>;
  kernel<<<M * n_pairs, kZzThreads, 0, stream>>>(A);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_kzz_bwd(const float* vl, const float* dl,
                             const float* vr, const float* dr,
                             const float* nl, const float* nr,
                             const float* ct, float* out, int lt, int nz,
                             int d2, int num_levels, int base, int increments,
                             int symmetric, int ranges, int per,
                             void* stream) {
  const int strips = (nz + gpsig::kZzTile - 1) / gpsig::kZzTile;
  if (lt != num_levels * (num_levels + 1) / 2 || nz <= 0 || d2 <= 0 ||
      ranges <= 0 || ranges > 1024 || per <= 0 ||
      (ranges - 1) * per >= strips || ranges * per < strips ||
      !gpsig::base_ok(base, nl, nr))
    return static_cast<int>(cudaErrorInvalidValue);
  const gpsig::KzzBwdArgs A{vl, dl, vr, dr, nl, nr, ct, out,
                            nz, d2, (d2 + gpsig::kZzCB - 1) / gpsig::kZzCB *
                                        gpsig::kZzCB,
                            lt, base, increments, symmetric, ranges, per,
                            strips};
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_kzz_bwd, A,
                      static_cast<cudaStream_t>(stream))
}
