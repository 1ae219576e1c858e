// K3, Kzx forward: the (M+1, nZ, N) level stack of inducing tensors against
// first-order sequence signatures.  Replaces the TPU kernel _kernel_zx_fwd
// (gpsig_tpu/ops/inducing_pallas.py:697, launched by _make_zx_core.fwd
// :886).
//
// For inducing tensor z and example n, level m with slots s_1..s_m is
//   sum_t R_m(t),  R_1(t) = G_{s_1}(t),  R_j(t) = G_{s_j}(t) * S_{j-1}(t),
// with S_j(t) = sum_{t' < t} R_j(t') -- the TPU's R = M[k] * excl_cumsum_t(R)
// restated as one sweep over time that carries the S_j in registers
// (lt - M scalars; 6 at M = 4).  G_k(t) is the slot Gram of slot k against
// observation t and its time step (common.cuh::slot_gram_zx).
//
// What bounds it on the card: per (z, n, t) it takes lt slot Grams, each 4
// dots of d2 plus up to 3 transcendentals -- at the serving shape (lt=10,
// d2=16, nZ=500, N=32, L=93) about 1e9 FMAs and 4.6e7 exp/expm1, so it is
// bound by FMA and transcendental issue, and by how many (z, n) pairs there
// are to run in parallel (16k here, few for 132 SMs).  The design: a block
// owns one example n and 32 inducing tensors (one per lane); it stages the
// example's augmented rows x_t, dx_t in shared memory a chunk of time steps
// at a time; its 8 warps compute the chunk's slot Grams in parallel (time
// steps spread over the warps) into shared memory; then warp 0 runs the
// sequential recursion over the chunk.  The inducing rows come through L1
// in the (lt, d2, nZ) layout, so a warp's loads are coalesced.
//
// The last time step has dx = 0 (inducing_cuda._prep_seq repeats the last
// observation), so with difference the sweep stops at L - 1 and repeat
// padding of a request stays exact; without difference every one of the L
// observations counts and the sweep stops at L (the TPU kernel's tail mask).
#include "common.cuh"

namespace gpsig {
namespace {

constexpr int kZ = 32;               // inducing tensors per block (lanes)
constexpr int kTG = 8;               // warps sharing a chunk's slot Grams
constexpr int kMaxChunk = 64;        // time steps staged per chunk
constexpr int kSmemBudget = 96 * 1024;

template <int M>
__global__ void __launch_bounds__(kZ * kTG)
kzx_fwd_kernel(const float* __restrict__ vl, const float* __restrict__ dl,
               const float* __restrict__ xv, const float* __restrict__ xd,
               float* __restrict__ out, int nz, int n_ex, int L, int d2,
               int t_chunk, int base, int increments, int difference) {
  constexpr int LT = M * (M + 1) / 2;
  extern __shared__ float smem[];
  float* s_xv = smem;                // (t_chunk, d2)
  float* s_xd = s_xv + t_chunk * d2; // (t_chunk, d2)
  float* s_g = s_xd + t_chunk * d2;  // (t_chunk, LT, kZ)

  const int lane = threadIdx.x, tg = threadIdx.y;
  const int tid = tg * kZ + lane;
  const int z = blockIdx.x * kZ + lane;
  const int n = blockIdx.y;
  const int zc = z < nz ? z : nz - 1;  // edge lanes recompute a live column
  const bool inc = increments != 0, diff = difference != 0;
  const int T = diff ? L - 1 : L;
  const float* xv_n = xv + static_cast<size_t>(n) * L * d2;
  const float* xd_n = xd + static_cast<size_t>(n) * L * d2;

  float S[LT];       // running exclusive time sums, S[k] after slot k
  float acc[M + 1];  // level sums
#pragma unroll
  for (int k = 0; k < LT; ++k) S[k] = 0.f;
#pragma unroll
  for (int m = 0; m <= M; ++m) acc[m] = 0.f;

  for (int t0 = 0; t0 < T; t0 += t_chunk) {
    const int tc = min(t_chunk, T - t0);
    __syncthreads();  // the previous chunk's sweep is done with shared memory
    for (int idx = tid; idx < tc * d2; idx += kZ * kTG) {
      s_xv[idx] = xv_n[static_cast<size_t>(t0) * d2 + idx];
      s_xd[idx] = xd_n[static_cast<size_t>(t0) * d2 + idx];
    }
    __syncthreads();

    // slot Grams of the chunk, time steps spread over the warps
    for (int tt = tg; tt < tc; tt += kTG) {
      const float* xvt = s_xv + tt * d2;
      const float* xdt = s_xd + tt * d2;
#pragma unroll 1
      for (int k = 0; k < LT; ++k) {
        const float* vk = vl + static_cast<size_t>(k) * d2 * nz + zc;
        const float* dk = dl + static_cast<size_t>(k) * d2 * nz + zc;
        float a0 = 0.f, dza = 0.f, da0 = 0.f, dda = 0.f;
        for (int c = 0; c < d2; ++c) {
          const float v = __ldg(vk + static_cast<size_t>(c) * nz);
          const float w = __ldg(dk + static_cast<size_t>(c) * nz);
          const float p = xvt[c], q = xdt[c];
          a0 = fmaf(v, p, a0);
          dza = fmaf(w, p, dza);
          da0 = fmaf(v, q, da0);
          dda = fmaf(w, q, dda);
        }
        s_g[(tt * LT + k) * kZ + lane] =
            slot_gram_zx(a0, dza, da0, dda, base, inc, diff);
      }
    }
    __syncthreads();

    // the order-1 recursion, one sweep over the chunk's time steps; within
    // a level the slots go last to first, so R_j reads S_{j-1} before this
    // step adds to it (the exclusive sum)
    if (tg == 0) {
      for (int tt = 0; tt < tc; ++tt) {
        const float* g = s_g + tt * LT * kZ + lane;
        int k = 0;
#pragma unroll
        for (int m = 1; m <= M; ++m) {
#pragma unroll
          for (int j = m - 1; j >= 0; --j) {
            float r = g[(k + j) * kZ];
            if (j > 0) r *= S[j > 0 ? k + j - 1 : 0];
            if (j == m - 1) {
              acc[m] += r;
            } else {
              S[k + j] += r;
            }
          }
          k += m;
        }
      }
    }
  }

  if (tg == 0 && z < nz) {
    const size_t plane = static_cast<size_t>(nz) * n_ex;
    const size_t at = static_cast<size_t>(z) * n_ex + n;
    out[at] = 1.f;
#pragma unroll
    for (int m = 1; m <= M; ++m) out[m * plane + at] = acc[m];
  }
}

template <int M>
cudaError_t launch_kzx(const float* vl, const float* dl, const float* xv,
                       const float* xd, float* out, int nz, int n_ex, int L,
                       int d2, int base, int increments, int difference,
                       cudaStream_t stream) {
  constexpr int LT = M * (M + 1) / 2;
  const int T = difference ? L - 1 : L;
  const int per_step = (2 * d2 + LT * kZ) * static_cast<int>(sizeof(float));
  int t_chunk = kSmemBudget / per_step;
  t_chunk = t_chunk < kMaxChunk ? t_chunk : kMaxChunk;
  t_chunk = t_chunk < T ? t_chunk : T;
  t_chunk = t_chunk > 1 ? t_chunk : 1;
  const int smem = t_chunk * per_step;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kzx_fwd_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kZ, kTG);
  const dim3 grid((nz + kZ - 1) / kZ, n_ex);
  kzx_fwd_kernel<M><<<grid, block, smem, stream>>>(
      vl, dl, xv, xd, out, nz, n_ex, L, d2, t_chunk, base, increments,
      difference);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_kzx_fwd(const float* vl, const float* dl,
                             const float* xv, const float* xd, float* out,
                             int lt, int nz, int n_ex, int L, int d2,
                             int num_levels, int base, int increments,
                             int difference, void* stream) {
  if (lt != num_levels * (num_levels + 1) / 2 || nz <= 0 || n_ex <= 0 ||
      n_ex > 65535 || L <= 0 || d2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_kzx, vl, dl, xv, xd, out, nz,
                      n_ex, L, d2, base, increments, difference,
                      static_cast<cudaStream_t>(stream))
}
