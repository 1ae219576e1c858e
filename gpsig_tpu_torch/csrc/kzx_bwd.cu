// K4, Kzx backward: the VJP of K3 (kzx_fwd.cu) under a cotangent ct of the
// (M+1, nZ, N) level stack.  Replaces the TPU kernel _kernel_zx_bwd
// (gpsig_tpu/ops/inducing_pallas.py:740, launched by _make_zx_core.bwd
// :917).
//
// K3's sweep for level m with slots s_1..s_m is R_1(t) = G_1(t),
// R_j(t) = G_j(t) S_{j-1}(t), S_j(t) = sum_{t' < t} R_j(t'), level sum
// sum_t R_m(t).  Its adjoint runs backward in time:
//   Rbar_m(t) = ct[m],  Gbar_j(t) = Rbar_j(t) S_{j-1}(t),
//   Rbar_{j-1}(t) = sum_{t' > t} Rbar_j(t') G_j(t'),
// and each slot's weights W = Gbar * dG/d(a0, dza, da0, dda) (common.cuh)
// give, with A0 = <v, x>, dZA = <dv, x>, dA0 = <v, dx>, ddA = <dv, dx>:
//   g_vl[z] += W_A0 x_t + W_dA0 dx_t    g_dl[z] += W_dZA x_t + W_ddA dx_t
//   g_xv[t] += W_A0 v_z + W_dZA dv_z    g_xd[t] += W_dA0 v_z + W_ddA dv_z.
//
// Each S_j is an exclusive prefix sum over time once S_{j-1} is known, and
// each Rbar_{j-1} a reversed one once Rbar_j is: so both sweeps run as
// block-wide scans over a chunk's time steps, one round per slot of the
// chain (M - 1 rounds forward, M - 1 in reverse; the levels' chains run in
// the same rounds), each step's thread adding the chunk's earlier (later)
// steps from shared memory to the carry of the chunks before (after) it.
// A block owns one example n and 32 inducing tensors (one per lane); its 8
// warps own the 8 steps of a chunk, so every warp works in every phase:
//   1. the chunk's slot Grams and their partials, a run of (slot, step)
//      items per warp in slot-major order, so a slot's inducing rows are
//      held in registers for the run and each step's rows x_t, dx_t read
//      as broadcast float4s, into shared memory;
//   2. the scans, each thread for its step;
//   3. the weights of its step and the x-side gradient of its step, summed
//      over the 32 lanes by a shuffle reduce-scatter
//      (common.cuh::warp_reduce_scatter32) into a slab per block of lanes;
//   4. the z-side gradient, (half, slot, 8 channels) items spread over the
//      warps, each a register-tiled product of the chunk's weights with its
//      rows x_t, dx_t, accumulated over the chunks in a per-example slab.
// With d2 <= 16 (the benchmark's 16) the block's inducing rows are staged
// in shared memory once (STAGED; 40 KB at lt = 10); phases 1 and 3 read
// them there, not through L1 at every use.
// S_{j-1}(t) is needed in the reverse sweep.  Recovering it by subtracting
// from a final sum would cancel in f32, so a first pass runs the forward
// scans alone and checkpoints the carries at every chunk start (a global
// scratch), and the second pass takes the chunks in reverse, re-scanning
// each from its checkpoint.  That is why the slot Grams are computed twice
// when the sequence spans more than one chunk: keeping a sequence's Grams
// and partials (5 lt floats a step and lane) for the reverse pass would
// take ~590 KB a block at L = 93, in shared memory or as a global round
// trip larger than the recompute.  The first pass skips each level's last
// slot (its Gram feeds no scan: lt - M of the lt Grams), and a sequence
// that fits one chunk skips the first pass.  The sweep bounds are K3's:
// with difference the last step (dx = 0) is excluded, so repeat padding
// stays exact and gets no gradient.
//
// What bounds it on the card: per (z, n, t) the lt slot Grams (4 dots of d2
// and up to 3 transcendentals each; twice, see above) and four weight
// contractions of d2 -- ~4.4 G FMAs of needed work at the training shape
// (lt=10, d2=16, nZ=500, N=50, L=93), so FMA and transcendental issue
// bound it (~0.13 ms at 67 TFLOP/s).  The wrapper sums both slabs
// (torch.sum): no atomics, a fixed order, a deterministic result.  Edge
// lanes that recompute column nZ - 1 take a zero cotangent and write no
// gradient.
//
// The grid is (nZ / 32, examples); past 65535 examples the launcher runs
// one launch per slice of 65535 (grid y's limit), in order on the stream.
//
// matern12 (M12, a compile-time instance): six partials (common.cuh
// slot_gram_zx_partials, expm1f), so six planes of weights a step and slot
// (the wrapper sizes the chunk for them), and the step-norm chains:
// phase 3 adds each lane's sum over the slots of W_nt / max(nt, 1e-30)
// times the step's difference channels to the x-side values before the
// reduce-scatter, phase 4 the chunk's sum of W_nz / max(nz, 1e-30) times
// the tensor's own difference channels to g_dl (the true channels only:
// signature_pallas._norm_chain_col / _row :218-238).  No dead-step mask:
// the TPU kernel's Kzx backward has none.
//
// Layouts: vl, dl (lt, d2, nZ) as in K3; xv, xd (N, L, d2); ct
// (M+1, nZ, N); gz (N, 2, lt, d2, nZ); gx (ceil(nZ/32), N, 2, L, d2);
// the checkpoint scratch ck (N, ceil(nZ/32), chunks, lt, 32); with
// matern12 the step norms nzn (lt, nZ) and ntn (N, L), else null.
#include "common.cuh"

namespace gpsig {
namespace {

constexpr int kZ = 32;   // inducing tensors per block (lanes)
constexpr int kTG = 8;   // warps per block; a chunk has at most kTG steps
constexpr int kThreads = kZ * kTG;
constexpr int kCB = 8;   // channels per z-side item
constexpr int kMaxGridY = 65535;  // examples a launch covers (grid y)

constexpr int kRegD2 = 16;  // d2 up to which a thread holds a slot's rows

// x_t rows in shared memory are padded to a multiple of 4 floats, so a
// warp reads them as broadcast float4s
__host__ __device__ inline int kzx_bwd_row_floats(int d2) {
  return (d2 + 3) & ~3;
}

// shared floats for a chunk of tc steps: x_t, dx_t; G (then Gbar); np
// partials (then weights: 4, or 6 with matern12); the scan exchange
inline int kzx_bwd_smem_floats(int lt, int d2, int tc, int np) {
  return 2 * tc * kzx_bwd_row_floats(d2) + (2 + np) * tc * lt * kZ;
}

// STAGED: d2 <= kRegD2, the block's inducing rows are staged in shared
// memory once, and a thread holds the rows of the slot it works on in
// registers; else they are read through L1 at each use
template <int M, bool STAGED, bool M12>
__global__ void __launch_bounds__(kThreads, 2)
kzx_bwd_kernel(const float* __restrict__ vl, const float* __restrict__ dl,
               const float* __restrict__ xv, const float* __restrict__ xd,
               const float* __restrict__ nzn, const float* __restrict__ ntn,
               const float* __restrict__ ct, float* __restrict__ gz,
               float* __restrict__ gx, float* __restrict__ ck, int nz,
               int n_ex, int n0, int L, int d2, int t_chunk, int base,
               int increments, int difference) {
  constexpr int LT = M * (M + 1) / 2;
  constexpr int NP = M12 ? 6 : 4;  // partials a slot Gram
  extern __shared__ float smem[];
  const bool inc = increments != 0, diff = difference != 0;
  const int T = diff ? L - 1 : L;
  const int n_chunks = (T + t_chunk - 1) / t_chunk;
  // channels of a row in shared memory: STAGED pads to kRegD2 with zeros,
  // so its loops and offsets are compile-time constants
  const int d2p = STAGED ? kRegD2 : kzx_bwd_row_floats(d2);
  const int dr = STAGED ? kRegD2 : d2;  // channels of a staged inducing row
  float* s_xv = smem;                        // [tc][d2p]
  float* s_xd = s_xv + t_chunk * d2p;        // [tc][d2p]
  float* s_g = s_xd + t_chunk * d2p;         // [tc][LT][kZ]
  float* s_p = s_g + t_chunk * LT * kZ;       // [tc][LT][NP][kZ]
  float* s_r = s_p + NP * t_chunk * LT * kZ;  // [tc][LT][kZ]
  // the block's inducing rows, [LT][kRegD2][kZ] each, when STAGED
  float* s_rv = s_r + t_chunk * LT * kZ;
  float* s_rd = s_rv + LT * kRegD2 * kZ;

  const int lane = threadIdx.x, tt = threadIdx.y;  // this thread's step
  const int tid = tt * kZ + lane;
  const int z = blockIdx.x * kZ + lane;
  const int n = n0 + blockIdx.y;  // launches cover <= 65535 examples each
  const int zc = z < nz ? z : nz - 1;  // edge lanes recompute a live column
  const float* xv_n = xv + static_cast<size_t>(n) * L * d2;
  const float* xd_n = xd + static_cast<size_t>(n) * L * d2;
  // this block's checkpoints, [n_chunks][LT][kZ]
  float* ck_b = ck + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) *
                         n_chunks * LT * kZ;
  // this example's z-side slab, [2][LT][d2][nz]
  float* gz_n = gz + static_cast<size_t>(n) * 2 * LT * d2 * nz;
  // this block's x-side slab, [2][L][d2]
  float* gx_b = gx + (static_cast<size_t>(blockIdx.x) * n_ex + n) * 2 * L * d2;

  // the inducing rows of slot k, channel c for this lane
  const float* rows_v = STAGED ? s_rv : vl;
  const float* rows_d = STAGED ? s_rd : dl;
  const int rstride = STAGED ? kZ : nz, roff = STAGED ? lane : zc;
  if (STAGED) {
    for (int idx = tid; idx < LT * kRegD2 * kZ; idx += kThreads) {
      const int k = idx / (kRegD2 * kZ), c = (idx / kZ) % kRegD2, l = idx % kZ;
      const int zl = min(static_cast<int>(blockIdx.x) * kZ + l, nz - 1);
      const size_t at = static_cast<size_t>(k * d2 + c) * nz + zl;
      s_rv[idx] = c < d2 ? vl[at] : 0.f;
      s_rd[idx] = c < d2 ? dl[at] : 0.f;
    }
  }
  auto row_at = [&](int k, int c) {
    return static_cast<size_t>(k * dr + c) * rstride + roff;
  };
  auto stage = [&](int t0, int tc) {
    for (int idx = tid; idx < tc * d2p; idx += kThreads) {
      const int st = idx / d2p, c = idx % d2p;
      const size_t at = static_cast<size_t>(t0 + st) * d2 + c;
      s_xv[idx] = c < d2 ? xv_n[at] : 0.f;
      s_xd[idx] = c < d2 ? xd_n[at] : 0.f;
    }
  };
  // slot Grams of the chunk (with their partials when `partials`): each
  // warp takes a run of (slot, step) items in slot-major order, so a slot's
  // inducing rows are loaded once for the run (into registers when
  // STAGED) and each step's x_t, dx_t are read as broadcast float4s.  The
  // forward scans alone (`partials` false) never read a level's last slot,
  // so those M slots are skipped there.
  auto grams = [&](int t0, int tc, bool partials) {
    const int n_slots = partials ? LT : LT - M;
    const int per = (n_slots * tc + kTG - 1) / kTG;
    float rv[STAGED ? kRegD2 : 1], rd[STAGED ? kRegD2 : 1];
    int held = -1;
    for (int it = tt * per; it < min((tt + 1) * per, n_slots * tc); ++it) {
      const int st = it % tc;
      int k = it / tc;  // the k-th slot taken; without partials, skip tops
      if (!partials) {
#pragma unroll
        for (int m = 1; m <= M; ++m)
          if (k >= m * (m - 1) / 2 + m - 1) ++k;
      }
      if (STAGED && k != held) {
#pragma unroll
        for (int c = 0; c < kRegD2; ++c) {
          rv[c] = rows_v[row_at(k, c)];
          rd[c] = rows_d[row_at(k, c)];
        }
        held = k;
      }
      const float4* xvt = reinterpret_cast<const float4*>(s_xv + st * d2p);
      const float4* xdt = reinterpret_cast<const float4*>(s_xd + st * d2p);
      float a0 = 0.f, dza = 0.f, da0 = 0.f, dda = 0.f;
      if (STAGED) {
#pragma unroll
        for (int c4 = 0; c4 < kRegD2 / 4; ++c4) {
          {
            const float4 p4 = xvt[c4], q4 = xdt[c4];
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
            const float q[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = rv[4 * c4 + e], w = rd[4 * c4 + e];
              a0 = fmaf(v, p[e], a0);
              dza = fmaf(w, p[e], dza);
              da0 = fmaf(v, q[e], da0);
              dda = fmaf(w, q[e], dda);
            }
          }
        }
      } else {
        const float* xs = s_xv + st * d2p;
        const float* ds = s_xd + st * d2p;
#pragma unroll 4
        for (int c = 0; c < d2; ++c) {
          const float v = rows_v[row_at(k, c)], w = rows_d[row_at(k, c)];
          a0 = fmaf(v, xs[c], a0);
          dza = fmaf(w, xs[c], dza);
          da0 = fmaf(v, ds[c], da0);
          dda = fmaf(w, ds[c], dda);
        }
      }
      const int sk = st * LT + k;
      const float nzk = M12 ? __ldg(nzn + static_cast<size_t>(k) * nz + zc)
                            : 0.f;
      const float ntt =
          M12 ? __ldg(ntn + static_cast<size_t>(n) * L + t0 + st) : 0.f;
      if (partials) {
        float p[6];
        s_g[sk * kZ + lane] = slot_gram_zx_partials<M12>(
            a0, dza, da0, dda, base, inc, diff, p, nzk, ntt);
#pragma unroll
        for (int w = 0; w < NP; ++w) s_p[(sk * NP + w) * kZ + lane] = p[w];
      } else {
        s_g[sk * kZ + lane] = slot_gram_zx<false, M12>(
            a0, dza, da0, dda, base, inc, diff, nzk, ntt);
      }
    }
  };
  // sum of s_r[.][k][lane] over the chunk's steps before this one (`part`;
  // after it when `reverse`) and over all of them (returned), one pass in
  // step order (reversed when `reverse`)
  auto chunk_sums = [&](int k, int tc, bool reverse, float& part) {
    float total = 0.f;
    part = 0.f;
    for (int i = 0; i < tc; ++i) {
      const int u = reverse ? tc - 1 - i : i;
      if (u == tt) part = total;
      total += s_r[(u * LT + k) * kZ + lane];
    }
    return total;
  };
  // the forward scans over the chunk: Sv[k] = S_{j-1} at this step for
  // slot k = k0 + j of level m (1 for j = 0); S carries each chain's sum
  // over the chunks before, and gets this chunk's
  auto forward_scans = [&](int tc, float (&S)[LT], float (&Sv)[LT]) {
    const bool mine = tt < tc;
#pragma unroll
    for (int m = 1; m <= M; ++m) Sv[m * (m - 1) / 2] = 1.f;
#pragma unroll
    for (int r = 0; r + 1 < M; ++r) {
#pragma unroll
      for (int m = r + 2; m <= M; ++m) {
        const int k = m * (m - 1) / 2 + r;
        // only the chunk's steps: past tc the thread's row is outside
        // s_r when the chunk holds fewer than kTG steps
        if (mine)
          s_r[(tt * LT + k) * kZ + lane] =
              s_g[(tt * LT + k) * kZ + lane] * Sv[k];
      }
      __syncthreads();
#pragma unroll
      for (int m = r + 2; m <= M; ++m) {
        const int k = m * (m - 1) / 2 + r;
        float excl;
        const float total = chunk_sums(k, tc, false, excl);
        Sv[k + 1] = S[k] + excl;
        S[k] += total;
      }
    }
  };

  float S[LT], Sv[LT];
#pragma unroll
  for (int k = 0; k < LT; ++k) S[k] = Sv[k] = 0.f;

  // pass 1: the forward scans alone, the carries checkpointed at each
  // chunk start (not needed when the sweep is one chunk)
  if (n_chunks > 1) {
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int t0 = ch * t_chunk, tc = min(t_chunk, T - t0);
      if (tt == 0) {
#pragma unroll
        for (int k = 0; k < LT; ++k) ck_b[(ch * LT + k) * kZ + lane] = S[k];
      }
      __syncthreads();
      stage(t0, tc);
      __syncthreads();
      grams(t0, tc, false);
      __syncthreads();
      forward_scans(tc, S, Sv);
    }
  }

  // pass 2: the chunks in reverse, each re-scanned from its checkpoint
  float U[LT];  // U[k] = sum over later steps of Rbar G of slot k
  float ctm[M + 1];
#pragma unroll
  for (int k = 0; k < LT; ++k) U[k] = 0.f;
#pragma unroll
  for (int m = 0; m <= M; ++m)
    ctm[m] = z < nz ? ct[(static_cast<size_t>(m) * nz + z) * n_ex + n] : 0.f;
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * t_chunk, tc = min(t_chunk, T - t0);
    const bool mine = tt < tc;
    __syncthreads();
    stage(t0, tc);
#pragma unroll
    for (int k = 0; k < LT; ++k)
      S[k] = n_chunks > 1 ? ck_b[(ch * LT + k) * kZ + lane] : 0.f;
    __syncthreads();
    grams(t0, tc, true);
    __syncthreads();
    forward_scans(tc, S, Sv);

    // the reverse scans: round r takes slot k0 + m - 1 - r of each level m
    // that has it; Gbar replaces G in s_g, slot by slot, in this thread's
    // own entries
    float Rb[M + 1];
#pragma unroll
    for (int m = 1; m <= M; ++m) Rb[m] = ctm[m];
#pragma unroll
    for (int r = 0; r + 1 < M; ++r) {
#pragma unroll
      for (int m = r + 2; m <= M; ++m) {
        const int k = m * (m - 1) / 2 + (m - 1 - r);
        float* gk = s_g + (tt * LT + k) * kZ + lane;
        const float g = mine ? *gk : 0.f;
        if (mine) {
          *gk = Rb[m] * Sv[k];
          s_r[(tt * LT + k) * kZ + lane] = Rb[m] * g;
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = r + 2; m <= M; ++m) {
        const int k = m * (m - 1) / 2 + (m - 1 - r);
        float rexcl;
        const float total = chunk_sums(k, tc, true, rexcl);
        Rb[m] = U[k] + rexcl;
        U[k] += total;
      }
    }
    if (mine) {
#pragma unroll
      for (int m = 1; m <= M; ++m)
        s_g[(tt * LT + m * (m - 1) / 2) * kZ + lane] = Rb[m];
    }

    // weights of this step, in place, and the x-side gradient of this step
    if (mine) {
      float wnt = 0.f;  // M12: this lane's W_nt over the slots
      for (int k = 0; k < LT; ++k) {
        const float gbar = s_g[(tt * LT + k) * kZ + lane];
#pragma unroll
        for (int w = 0; w < NP; ++w)
          s_p[((tt * LT + k) * NP + w) * kZ + lane] *= gbar;
        if (M12) wnt += s_p[((tt * LT + k) * NP + 5) * kZ + lane];
      }
      if (M12)
        wnt /= fmaxf(ntn[static_cast<size_t>(n) * L + t0 + tt], kTinyDen);
      for (int c0 = 0; c0 < dr; c0 += 16) {
        float vals[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) vals[q] = 0.f;
        if (M12) {  // the time step's norm chain, summed with the lanes
#pragma unroll
          for (int cc = 0; cc < 16; ++cc)
            if (c0 + cc < d2 - 2)
              vals[16 + cc] = wnt * s_xd[tt * d2p + c0 + cc];
        }
        for (int k = 0; k < LT; ++k) {
          const float* pw = s_p + (tt * LT + k) * NP * kZ + lane;
          const float w0 = pw[0], w1 = pw[kZ];
          const float w2 = pw[2 * kZ], w3 = pw[3 * kZ];
#pragma unroll
          for (int cc = 0; cc < 16; ++cc) {
            const int c = c0 + cc;
            if (c < dr) {
              const float v = rows_v[row_at(k, c)], w = rows_d[row_at(k, c)];
              vals[cc] = fmaf(w0, v, fmaf(w1, w, vals[cc]));
              vals[16 + cc] = fmaf(w2, v, fmaf(w3, w, vals[16 + cc]));
            }
          }
        }
        const float sum = warp_reduce_scatter32(vals);
        const int c = c0 + (lane & 15);
        if (c < d2)
          gx_b[(static_cast<size_t>(lane >> 4) * L + t0 + tt) * d2 + c] = sum;
      }
    }
    __syncthreads();

    // z side: g_vl pairs (W_A0, W_dA0) with (x, dx), g_dl (W_dZA, W_ddA),
    // kCB channels an item, x_t and dx_t read as broadcast float4s; the
    // first chunk (the last in time) writes the slab, the others add to it
    // (the slab's values are loaded before the products, hiding latency)
    const int n_cb = (d2 + kCB - 1) / kCB;
    for (int it = tt; it < 2 * LT * n_cb; it += kTG) {
      const int half = it / (LT * n_cb), k = (it / n_cb) % LT,
                cb = it % n_cb;
      const int wa = half ? 1 : 0, wb = half ? 3 : 2;
      float* dst = gz_n + ((static_cast<size_t>(half) * LT + k) * d2 +
                           cb * kCB) * nz + z;
      const bool first = ch == n_chunks - 1;  // the last chunk in time
      float acc[kCB];
#pragma unroll
      for (int q = 0; q < kCB; ++q)  // issued now, used after the products
        acc[q] = (!first && z < nz && cb * kCB + q < d2)
                     ? dst[static_cast<size_t>(q) * nz] : 0.f;
      float wnz = 0.f;  // M12, g_dl: the chunk's W_nz of this slot
      for (int u = 0; u < tc; ++u) {
        const float* pw = s_p + (u * LT + k) * NP * kZ + lane;
        const float a = pw[wa * kZ], b = pw[wb * kZ];
        if (M12 && half) wnz += pw[4 * kZ];
        const float4* xs =
            reinterpret_cast<const float4*>(s_xv + u * d2p + cb * kCB);
        const float4* ds =
            reinterpret_cast<const float4*>(s_xd + u * d2p + cb * kCB);
#pragma unroll
        for (int q4 = 0; q4 < kCB / 4; ++q4) {
          if (cb * kCB + 4 * q4 < d2p) {
            const float4 x4 = xs[q4], y4 = ds[q4];
            const float xq[4] = {x4.x, x4.y, x4.z, x4.w};
            const float yq[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[4 * q4 + e] =
                  fmaf(a, xq[e], fmaf(b, yq[e], acc[4 * q4 + e]));
          }
        }
      }
      if (M12 && half) {  // the tensor's step-norm chain
        wnz /= fmaxf(nzn[static_cast<size_t>(k) * nz + zc], kTinyDen);
#pragma unroll
        for (int q = 0; q < kCB; ++q)
          if (cb * kCB + q < d2 - 2)
            acc[q] = fmaf(wnz, rows_d[row_at(k, cb * kCB + q)], acc[q]);
      }
      if (z < nz) {
#pragma unroll
        for (int q = 0; q < kCB; ++q)
          if (cb * kCB + q < d2) dst[static_cast<size_t>(q) * nz] = acc[q];
      }
    }
  }

  if (n_chunks == 0 && z < nz) {
    for (int e = tt; e < 2 * LT * d2; e += kTG)
      gz_n[static_cast<size_t>(e) * nz + z] = 0.f;
  }
  // steps past the sweep get no gradient
  for (int idx = tid; idx < 2 * (L - T) * d2; idx += kThreads) {
    const int half = idx / ((L - T) * d2), rem = idx % ((L - T) * d2);
    gx_b[static_cast<size_t>(half) * L * d2 + static_cast<size_t>(T) * d2 +
         rem] = 0.f;
  }
}

template <int M, bool STAGED, bool M12>
cudaError_t launch_kzx_bwd_rows(const float* vl, const float* dl,
                                const float* xv, const float* xd,
                                const float* nzn, const float* ntn,
                                const float* ct, float* gz, float* gx,
                                float* ck, int nz, int n_ex, int L, int d2,
                                int base, int increments, int difference,
                                int t_chunk, cudaStream_t stream) {
  constexpr int LT = M * (M + 1) / 2;
  const int smem = (kzx_bwd_smem_floats(LT, STAGED ? kRegD2 : d2, t_chunk,
                                        M12 ? 6 : 4) +
                    (STAGED ? 2 * LT * kRegD2 * kZ : 0)) *
                   static_cast<int>(sizeof(float));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kzx_bwd_kernel<M, STAGED, M12>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  // the example index is blockIdx.y (at most 65535 a launch): one launch
  // per slice of examples, all on the stream in order
  const dim3 block(kZ, kTG);
  for (int n0 = 0; n0 < n_ex; n0 += kMaxGridY) {
    const int count = n_ex - n0 < kMaxGridY ? n_ex - n0 : kMaxGridY;
    const dim3 grid((nz + kZ - 1) / kZ, count);
    kzx_bwd_kernel<M, STAGED, M12><<<grid, block, smem, stream>>>(
        vl, dl, xv, xd, nzn, ntn, ct, gz, gx, ck, nz, n_ex, n0, L, d2,
        t_chunk, base, increments, difference);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The staged kernel where the wrapper staged the rows (they fit in shared
// memory) and d2 <= kRegD2; else the one that reads them through L1.
template <int M>
cudaError_t launch_kzx_bwd(const float* vl, const float* dl, const float* xv,
                           const float* xd, const float* nzn,
                           const float* ntn, const float* ct, float* gz,
                           float* gx, float* ck, int nz, int n_ex, int L,
                           int d2, int base, int increments, int difference,
                           int t_chunk, int stage_rows, cudaStream_t stream) {
#define GPSIG_KZX_BWD(STAGED, M12)                                           \
  return launch_kzx_bwd_rows<M, STAGED, M12>(                                \
      vl, dl, xv, xd, nzn, ntn, ct, gz, gx, ck, nz, n_ex, L, d2, base,       \
      increments, difference, t_chunk, stream)
  const bool staged = stage_rows && d2 <= kRegD2;
  if (base == kMatern12) {
    if (staged) GPSIG_KZX_BWD(true, true);
    GPSIG_KZX_BWD(false, true);
  }
  if (staged) GPSIG_KZX_BWD(true, false);
  GPSIG_KZX_BWD(false, false);
#undef GPSIG_KZX_BWD
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_kzx_bwd(const float* vl, const float* dl,
                             const float* xv, const float* xd,
                             const float* nzn, const float* ntn,
                             const float* ct, float* gz, float* gx,
                             float* ck, int lt, int nz, int n_ex, int L,
                             int d2, int num_levels, int base, int increments,
                             int difference, int t_chunk, int stage_rows,
                             void* stream) {
  if (lt != num_levels * (num_levels + 1) / 2 || nz <= 0 || n_ex <= 0 ||
      L <= 0 || d2 <= 0 || t_chunk <= 0 ||
      t_chunk > gpsig::kTG || !gpsig::base_ok(base, nzn, ntn))
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_kzx_bwd, vl, dl, xv, xd, nzn,
                      ntn, ct, gz, gx, ck, nz, n_ex, L, d2, base, increments,
                      difference, t_chunk, stage_rows,
                      static_cast<cudaStream_t>(stream))
}
