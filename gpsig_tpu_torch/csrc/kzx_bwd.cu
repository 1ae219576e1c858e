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
// S_{j-1}(t) is needed at every t.  Recovering it by subtracting from the
// final sum would cancel in f32, so a first forward pass checkpoints S at
// every chunk boundary (in a global scratch, read back by the thread that
// wrote it), and the backward pass takes the chunks in reverse order,
// re-sweeping each from its checkpoint to have S_{j-1}(t) exact before one
// warp carries the adjoint sums back through it.  The sweep bounds are K3's: with difference the last step (dx = 0)
// is excluded, so repeat padding stays exact and gets no gradient.
//
// What bounds it on the card: per (z, n, t) the lt slot Grams twice (the
// checkpoint pass and the backward pass: 4 dots of d2 and up to 3
// transcendentals each) and four weight contractions of d2 -- about 4.6 G
// FMAs at the training shape (lt=10, d2=16, nZ=500, N=50, L=93), so FMA
// and transcendental throughput bound it (~0.14 ms at 67 TFLOP/s).  The design
// keeps K3's grid: a block owns one example n and 32 inducing tensors (one
// per lane); its 8 warps compute a chunk's slot Grams and partials in
// parallel into shared memory, warp 0 sweeps, then all warps turn the
// partials into weights and contract them.  The chunk length is set by the
// wrapper so that three blocks fit on an SM.  The z-side gradient (a sum
// over n and t) accumulates over the chunks in a per-example slab, each
// entry owned by one thread; the x-side (a sum over z and the slots) is a
// warp reduction over the lanes into a slab per block of 32 lanes.  The wrapper sums both slabs (torch.sum): no atomics,
// so the result is deterministic.  Edge lanes that recompute column
// nZ - 1 take a zero cotangent and write no gradient.
//
// Layouts: vl, dl (lt, d2, nZ) as in K3; xv, xd (N, L, d2); ct
// (M+1, nZ, N); gz (N, 2, lt, d2, nZ); gx (ceil(nZ/32), N, 2, L, d2);
// the checkpoint scratch ck (N, ceil(nZ/32), chunks, lt, 32).
#include "common.cuh"

namespace gpsig {
namespace {

constexpr int kZ = 32;         // inducing tensors per block (lanes)
constexpr int kTG = 8;         // warps per block
constexpr int kThreads = kZ * kTG;

// shared floats for a chunk of tc steps: the chunk's x_t, dx_t; G then
// Gbar; 4 partials then weights; the exclusive sums S
inline int kzx_bwd_smem_floats(int lt, int d2, int tc) {
  return 2 * tc * d2 + 6 * tc * lt * kZ;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
kzx_bwd_kernel(const float* __restrict__ vl, const float* __restrict__ dl,
               const float* __restrict__ xv, const float* __restrict__ xd,
               const float* __restrict__ ct, float* __restrict__ gz,
               float* __restrict__ gx, float* __restrict__ ck, int nz,
               int n_ex, int L, int d2, int t_chunk, int base,
               int increments, int difference) {
  constexpr int LT = M * (M + 1) / 2;
  extern __shared__ float smem[];
  const bool inc = increments != 0, diff = difference != 0;
  const int T = diff ? L - 1 : L;
  const int n_chunks = (T + t_chunk - 1) / t_chunk;
  float* s_xv = smem;                        // [tc][d2]
  float* s_xd = s_xv + t_chunk * d2;         // [tc][d2]
  float* s_g = s_xd + t_chunk * d2;          // [tc][LT][kZ]
  float* s_p = s_g + t_chunk * LT * kZ;      // [tc][LT][4][kZ]
  float* s_S = s_p + 4 * t_chunk * LT * kZ;  // [tc][LT][kZ]

  const int lane = threadIdx.x, tg = threadIdx.y;
  const int tid = tg * kZ + lane;
  const int z = blockIdx.x * kZ + lane;
  const int n = blockIdx.y;
  const int zc = z < nz ? z : nz - 1;  // edge lanes recompute a live column
  const float* xv_n = xv + static_cast<size_t>(n) * L * d2;
  const float* xd_n = xd + static_cast<size_t>(n) * L * d2;
  // this block's checkpoints, [n_chunks][LT][kZ]
  float* ck_b = ck + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) *
                         n_chunks * LT * kZ;
  // this example's z-side slab, [2][LT][d2][nz]
  float* gz_n = gz + static_cast<size_t>(n) * 2 * LT * d2 * nz;

  // the four dots of slot k at chunk step tt, for this lane's column
  auto dots = [&](int k, int tt, float& a0, float& dza, float& da0,
                  float& dda) {
    const float* vk = vl + static_cast<size_t>(k) * d2 * nz + zc;
    const float* dk = dl + static_cast<size_t>(k) * d2 * nz + zc;
    const float* xvt = s_xv + tt * d2;
    const float* xdt = s_xd + tt * d2;
    a0 = dza = da0 = dda = 0.f;
    for (int c = 0; c < d2; ++c) {
      const float v = __ldg(vk + static_cast<size_t>(c) * nz);
      const float w = __ldg(dk + static_cast<size_t>(c) * nz);
      const float p = xvt[c], q = xdt[c];
      a0 = fmaf(v, p, a0);
      dza = fmaf(w, p, dza);
      da0 = fmaf(v, q, da0);
      dda = fmaf(w, q, dda);
    }
  };
  auto stage = [&](int t0, int tc) {
    for (int idx = tid; idx < tc * d2; idx += kThreads) {
      s_xv[idx] = xv_n[static_cast<size_t>(t0) * d2 + idx];
      s_xd[idx] = xd_n[static_cast<size_t>(t0) * d2 + idx];
    }
  };
  // K3's order-1 recursion over one step: slots go last to first within a
  // level so R_j reads S_{j-1} before this step adds to it
  auto advance = [&](float* S, const float* g) {
    int k = 0;
#pragma unroll
    for (int m = 1; m <= M; ++m) {
#pragma unroll
      for (int j = m - 2; j >= 0; --j) {
        float r = g[(k + j) * kZ];
        if (j > 0) r *= S[j > 0 ? k + j - 1 : 0];
        S[k + j] += r;
      }
      k += m;
    }
  };

  // pass 1: the forward sweep, S checkpointed at each chunk start
  float S[LT];
#pragma unroll
  for (int k = 0; k < LT; ++k) S[k] = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * t_chunk, tc = min(t_chunk, T - t0);
    __syncthreads();
    stage(t0, tc);
    __syncthreads();
    for (int tt = tg; tt < tc; tt += kTG) {
#pragma unroll 1
      for (int k = 0; k < LT; ++k) {
        float a0, dza, da0, dda;
        dots(k, tt, a0, dza, da0, dda);
        s_g[(tt * LT + k) * kZ + lane] =
            slot_gram_zx(a0, dza, da0, dda, base, inc, diff);
      }
    }
    __syncthreads();
    if (tg == 0) {
#pragma unroll
      for (int k = 0; k < LT; ++k) ck_b[(ch * LT + k) * kZ + lane] = S[k];
      for (int tt = 0; tt < tc; ++tt) advance(S, s_g + tt * LT * kZ + lane);
    }
  }

  // pass 2: the chunks in reverse, each re-swept from its checkpoint
  float U[LT];  // U[k] = sum over later steps of Rbar G of slot k
  float ctm[M + 1];
#pragma unroll
  for (int k = 0; k < LT; ++k) U[k] = 0.f;
#pragma unroll
  for (int m = 0; m <= M; ++m)
    ctm[m] = z < nz ? ct[(static_cast<size_t>(m) * nz + z) * n_ex + n] : 0.f;
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * t_chunk, tc = min(t_chunk, T - t0);
    __syncthreads();
    stage(t0, tc);
    __syncthreads();
    for (int tt = tg; tt < tc; tt += kTG) {
#pragma unroll 1
      for (int k = 0; k < LT; ++k) {
        float a0, dza, da0, dda, p[4];
        dots(k, tt, a0, dza, da0, dda);
        const int tk = tt * LT + k;
        s_g[tk * kZ + lane] =
            slot_gram_zx_partials(a0, dza, da0, dda, base, inc, diff, p);
#pragma unroll
        for (int w = 0; w < 4; ++w) s_p[(tk * 4 + w) * kZ + lane] = p[w];
      }
    }
    __syncthreads();
    if (tg == 0) {
#pragma unroll
      for (int k = 0; k < LT; ++k) S[k] = ck_b[(ch * LT + k) * kZ + lane];
      for (int tt = 0; tt < tc; ++tt) {
#pragma unroll
        for (int k = 0; k < LT; ++k) s_S[(tt * LT + k) * kZ + lane] = S[k];
        advance(S, s_g + tt * LT * kZ + lane);
      }
      for (int tt = tc - 1; tt >= 0; --tt) {
        float* g = s_g + tt * LT * kZ + lane;
        const float* sp = s_S + tt * LT * kZ + lane;
        int k = 0;
#pragma unroll
        for (int m = 1; m <= M; ++m) {
          float rbar = ctm[m];
#pragma unroll
          for (int j = m - 1; j >= 0; --j) {
            const float gk = g[(k + j) * kZ];
            g[(k + j) * kZ] = j > 0 ? rbar * sp[(j > 0 ? k + j - 1 : 0) * kZ]
                                    : rbar;  // Gbar in place of G
            if (j > 0) {
              const float next = U[k + j];
              U[k + j] = fmaf(rbar, gk, U[k + j]);
              rbar = next;
            }
          }
          k += m;
        }
      }
    }
    __syncthreads();
    // weights: partials times the slot cotangent, in place
    for (int idx = tid; idx < tc * LT * kZ; idx += kThreads) {
      const int tk = idx / kZ, l = idx % kZ;
      const float gbar = s_g[idx];
#pragma unroll
      for (int w = 0; w < 4; ++w) s_p[(tk * 4 + w) * kZ + l] *= gbar;
    }
    __syncthreads();
    // z side: g_vl pairs (W_A0, W_dA0) with (x, dx), g_dl (W_dZA, W_ddA);
    // the first chunk (the last in time) writes the slab, the others add
    for (int e = tg; e < 2 * LT * d2; e += kTG) {
      const int half = e / (LT * d2), k = (e / d2) % LT, c = e % d2;
      const int wa = half ? 1 : 0, wb = half ? 3 : 2;
      float acc = 0.f;
      for (int tt = 0; tt < tc; ++tt) {
        const float* pw = s_p + (tt * LT + k) * 4 * kZ + lane;
        acc = fmaf(pw[wa * kZ], s_xv[tt * d2 + c], acc);
        acc = fmaf(pw[wb * kZ], s_xd[tt * d2 + c], acc);
      }
      if (z < nz) {
        float* dst = gz_n + static_cast<size_t>(e) * nz + z;
        *dst = ch == n_chunks - 1 ? acc : *dst + acc;
      }
    }
    // x side: g_xv pairs (W_A0, W_dZA) with (v, dv), g_xd (W_dA0, W_ddA)
    for (int e = tg; e < 2 * tc * d2; e += kTG) {
      const int half = e / (tc * d2), tt = (e / d2) % tc, c = e % d2;
      const int wa = half ? 2 : 0, wb = half ? 3 : 1;
      float acc = 0.f;
#pragma unroll 1
      for (int k = 0; k < LT; ++k) {
        const size_t at = (static_cast<size_t>(k) * d2 + c) * nz + zc;
        const float* pw = s_p + (tt * LT + k) * 4 * kZ + lane;
        acc = fmaf(pw[wa * kZ], __ldg(vl + at), acc);
        acc = fmaf(pw[wb * kZ], __ldg(dl + at), acc);
      }
#pragma unroll
      for (int off = kZ / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0)
        gx[((static_cast<size_t>(blockIdx.x) * n_ex + n) * 2 + half) * L * d2 +
           static_cast<size_t>(t0 + tt) * d2 + c] = acc;
    }
  }

  if (n_chunks == 0 && z < nz) {
    for (int e = tg; e < 2 * LT * d2; e += kTG)
      gz_n[static_cast<size_t>(e) * nz + z] = 0.f;
  }
  // steps past the sweep get no gradient
  for (int idx = tid; idx < 2 * (L - T) * d2; idx += kThreads) {
    const int half = idx / ((L - T) * d2), rem = idx % ((L - T) * d2);
    gx[((static_cast<size_t>(blockIdx.x) * n_ex + n) * 2 + half) * L * d2 +
       static_cast<size_t>(T) * d2 + rem] = 0.f;
  }
}

template <int M>
cudaError_t launch_kzx_bwd(const float* vl, const float* dl, const float* xv,
                           const float* xd, const float* ct, float* gz,
                           float* gx, float* ck, int nz, int n_ex, int L,
                           int d2, int base, int increments, int difference,
                           int t_chunk, cudaStream_t stream) {
  constexpr int LT = M * (M + 1) / 2;
  const int smem = kzx_bwd_smem_floats(LT, d2, t_chunk) *
                   static_cast<int>(sizeof(float));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kzx_bwd_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kZ, kTG);
  const dim3 grid((nz + kZ - 1) / kZ, n_ex);
  kzx_bwd_kernel<M><<<grid, block, smem, stream>>>(
      vl, dl, xv, xd, ct, gz, gx, ck, nz, n_ex, L, d2, t_chunk, base,
      increments, difference);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_kzx_bwd(const float* vl, const float* dl,
                             const float* xv, const float* xd,
                             const float* ct, float* gz, float* gx,
                             float* ck, int lt, int nz, int n_ex, int L,
                             int d2, int num_levels, int base, int increments,
                             int difference, int t_chunk, void* stream) {
  if (lt != num_levels * (num_levels + 1) / 2 || nz <= 0 || n_ex <= 0 ||
      n_ex > 65535 || L <= 0 || d2 <= 0 || t_chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_kzx_bwd, vl, dl, xv, xd, ct,
                      gz, gx, ck, nz, n_ex, L, d2, base, increments,
                      difference, t_chunk, static_cast<cudaStream_t>(stream))
}
