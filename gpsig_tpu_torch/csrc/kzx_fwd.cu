// K3, Kzx forward: the (M+1, nZ, N) level stack of inducing tensors against
// first-order sequence signatures.  Replaces the TPU kernel _kernel_zx_fwd
// (gpsig_tpu/ops/inducing_pallas.py:697, launched by _make_zx_core.fwd
// :886).
//
// For inducing tensor z and example n, level m with slots s_1..s_m is the
// chain sum
//   K_m = sum_{t_1 < ... < t_m} G_{s_1}(t_1) ... G_{s_m}(t_m),
// G_k(t) the slot Gram of slot k against observation t and its time step
// (common.cuh::slot_gram_zx) -- the TPU's R = M[k] * excl_cumsum_t(R).
//
// What bounds it on the card: per (z, n, t) it takes lt slot Grams, each 4
// dots of d2 (64 FMAs at d2 = 16) and 4 transcendentals (2 expf, 2
// common.cuh::expm1_acc: ~60 instructions) -- at the training shape
// (lt=10, d2=16, nZ=500, N=50, L=93) 23.5 M slot Grams, ~1.5 G FMAs and
// ~3.5 G instructions in all: instruction issue, not bytes.  The previous
// design reloaded each slot's inducing rows from global memory at every
// time step (4 loads for 4 FMAs) and ran the time recursion on one warp
// while seven waited.
//
// The design:
//   * A block owns 32 inducing tensors (one per lane) of one example and
//     stages their rows in shared memory once (STAGED: [k][lane][c], rows
//     padded to 20 floats so a quarter-warp's float4 loads hit distinct
//     banks; 51 KB at lt = 10); where they do not fit (more levels, wider
//     rows) they are read through L1.
//   * The example's rows x_t, dx_t are staged a chunk of steps at a time;
//     each of the 8 warps takes a contiguous range of the chunk's steps.
//   * Dots from float4s: a step's rows are read as broadcasts and a
//     slot's as float4s of its padded row, 16 loads for 64 FMAs.  Slots go
//     level by level; the compiler may overlap a slot's transcendentals
//     with the next slot's dots, but not hoist the next slot's loads (an
//     empty asm barrier: unrolled, it held every slot's rows and spilled).
//   * The recursion spread over all warps: each warp sums, over its range,
//     every contiguous sub-chain (i..j) of every level's slots (m(m+1)/2 a
//     level, 20 in all at M = 4: one FMA each a step), and warp 0 chains
//     the 8 ranges in time order by Chen's identity,
//       chain(i..j) over [a, c) = chain(i..j)[a, b) + chain(i..j)[b, c)
//                     + sum_{i<=k<j} chain(i..k)[a, b) chain(k+1..j)[b, c),
//     ~35 FMAs a range at M = 4 -- no warp waits on a serial recursion.
//     The ranges' states pass through shared memory 8 at a time, or 4, 2,
//     1 where 8 do not fit (M >= 10: 220 sums a lane); the block's state
//     must fit beside one, which it does up to 16 levels (816 sums).
//   * Past that (or where a step's rows are too wide beside the states)
//     the serial path: one warp a block walks the steps in order with
//     each level's prefix chain sums, lt floats a lane, in shared memory,
//     and reads the rows through L1 -- slow, but any level count that
//     leaves lt floats a lane room in shared memory (up to 59 levels).
//   * The block index folds (example, tensor tile) into grid x (2^31 -
//     1), so any number of examples takes one launch.
//   At serving batches (N = 1, 8) the grid is 16 and 128 blocks on 132 SMs.
//   Splitting the time axis across blocks and chaining the segments in a
//   second launch was built and measured; it gave no gain a request could
//   see (requests are host-bound) and was taken out (PERF.md §6).
//
// matern12 (M12, a compile-time instance of both paths): the slot Gram is
// common.cuh's mat12_cross (or its one-sided or plain form) with the step
// norms of the slot's tensor and of the time step (nzn (lt, nZ), ntn (N,
// L), read through L1); the rbf-only RID instance stays rbf-only.
//
// The last time step has dx = 0 (inducing_cuda._prep_seq repeats the last
// observation), so with difference the sweep stops at L - 1 and repeat
// padding of a request stays exact; without difference every one of the L
// observations counts and the sweep stops at L (the TPU kernel's tail mask).
#include "common.cuh"

namespace gpsig {
namespace {

constexpr int kZ = 32;                // inducing tensors per block (lanes)
constexpr int kW = 8;                 // warps per block
constexpr int kThreads = kZ * kW;
constexpr int kCB = 16;               // channels a register block holds
constexpr int kMaxChunk = 128;        // time steps staged per chunk
constexpr int kChunkBytes = 16 * 1024;
constexpr int kStageBytes = 64 * 1024;  // staged inducing rows at most
constexpr long long kSmemMax = 227 * 1024;  // a block's, on the H100
// a staged row's stride in floats: 16 channels padded so that 8 lanes
// reading float4s of consecutive tensors hit distinct banks
constexpr int kRowPad = 20;

template <int M>
struct ZxShape {
  static constexpr int LT = M * (M + 1) / 2;          // slots
  static constexpr int NQ = M * (M + 1) * (M + 2) / 6;  // sub-chains
};

// Sub-chain (i..j), 0 <= i <= j < m, of level m in the packed state.
__host__ __device__ constexpr int qidx(int m, int i, int j) {
  return (m - 1) * m * (m + 1) / 6 + j * (j + 1) / 2 + i;
}

// a <- a chained with b, a over earlier steps than b (Chen's identity).
// For fixed i, j runs down so a(i..k), k < j, is read before it changes.
template <int M>
__device__ __forceinline__ void chain_product(
    float (&a)[ZxShape<M>::NQ], const float (&b)[ZxShape<M>::NQ]) {
#pragma unroll
  for (int m = 1; m <= M; ++m)
#pragma unroll
    for (int i = 0; i < m; ++i)
#pragma unroll
      for (int j = m - 1; j >= i; --j) {
        float c = a[qidx(m, i, j)] + b[qidx(m, i, j)];
#pragma unroll
        for (int k = i; k < j; ++k)
          c = fmaf(a[qidx(m, i, k)], b[qidx(m, k + 1, j)], c);
        a[qidx(m, i, j)] = c;
      }
}

// STAGED: the block's inducing rows in shared memory; ONE: d2 <= kCB, one
// channel block (the channel loop is then unrolled); RID: the main path's
// slot Gram (rbf, increments, difference) compiled in, so a slot's
// transcendentals are straight-line code the compiler can interleave with
// the next slot's dots (~6% at N = 50 on the H100); M12: matern12.
template <int M, bool STAGED, bool ONE, bool RID, bool M12>
__global__ void __launch_bounds__(kThreads, 2)
kzx_fwd_kernel(const float* __restrict__ vl, const float* __restrict__ dl,
               const float* __restrict__ xv, const float* __restrict__ xd,
               const float* __restrict__ nzn, const float* __restrict__ ntn,
               float* __restrict__ out, int nz, int n_ex, int L, int d2,
               int ncb, int t_chunk, int nr, int base, int increments,
               int difference) {
  using S = ZxShape<M>;
  constexpr int LT = S::LT, NQ = S::NQ;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int xs = ncb * kCB;                // channels of a staged row
  float* s_x = smem;                       // [t_chunk][2][xs]: x_t, dx_t
  float* s_q = s_x + t_chunk * 2 * xs;     // [nr][NQ][kZ]: range states
  float* s_b = s_q + nr * NQ * kZ;         // [NQ][kZ]: the block's state
  float* s_r = s_b + NQ * kZ;              // STAGED: [2][LT][kZ][kRowPad]

  const int lane = threadIdx.x % kZ, w = threadIdx.x / kZ;
  const int n_zt = (nz + kZ - 1) / kZ;
  const int zt = blockIdx.x % n_zt;
  const int n = blockIdx.x / n_zt;
  const int z = zt * kZ + lane;
  const int zc = z < nz ? z : nz - 1;  // edge lanes recompute a live column
  const bool inc = increments != 0, diff = difference != 0;
  const int T = diff ? L - 1 : L;
  const float* xv_n = xv + static_cast<size_t>(n) * L * d2;
  const float* xd_n = xd + static_cast<size_t>(n) * L * d2;

  if (STAGED) {  // kCB channels (ONE)
    for (int idx = threadIdx.x; idx < 2 * LT * kZ * kCB; idx += kThreads) {
      const int h = idx / (LT * kZ * kCB), k = (idx / (kZ * kCB)) % LT;
      const int l = (idx / kCB) % kZ, c = idx % kCB;
      const int zl = min(zt * kZ + l, nz - 1);
      const float* src = h ? dl : vl;
      s_r[((h * LT + k) * kZ + l) * kRowPad + c] =
          c < d2 ? src[(static_cast<size_t>(k) * nz + zl) * d2 + c] : 0.f;
    }
  }
  for (int q = w; q < NQ; q += kW) s_b[q * kZ + lane] = 0.f;
  // channel c of slot k's value (h = 0) or difference (h = 1) row, read
  // through L1 (not STAGED)
  auto row = [&](int h, int k, int c) {
    return c < d2 ? (h ? dl : vl)[(static_cast<size_t>(k) * nz + zc) * d2 + c]
                  : 0.f;
  };

  for (int t0 = 0; t0 < T; t0 += t_chunk) {
    const int tc = min(t_chunk, T - t0);
    __syncthreads();  // the chunk before is done with s_x and s_q
    for (int idx = threadIdx.x; idx < tc * 2 * xs; idx += kThreads) {
      const int st = idx / (2 * xs), h = (idx / xs) % 2, c = idx % xs;
      const float* src = h ? xd_n : xv_n;
      s_x[idx] = c < d2 ? src[static_cast<size_t>(t0 + st) * d2 + c] : 0.f;
    }
    __syncthreads();

    // this warp's range of the chunk, a step at a time
    const int per = (tc + kW - 1) / kW;
    const int r0 = w * per, r1 = min(tc, r0 + per);
    float Q[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) Q[q] = 0.f;
    for (int st = r0; st < r1; ++st) {
      const float* xr = s_x + st * 2 * xs;
      const float nt =
          M12 ? __ldg(ntn + static_cast<size_t>(n) * L + t0 + st) : 0.f;
#pragma unroll
      for (int m = 1; m <= M; ++m) {
        float G[M];  // level m's slot Grams at this step
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const int k = m * (m - 1) / 2 + i;
          // no loads of this slot before the last slot's: unrolled across
          // slots, the compiler held every slot's rows at once and spilled
          // ~1 KB a thread; the transcendentals still overlap
          asm volatile("" ::: "memory");
          const float* rv = s_r + (k * kZ + lane) * kRowPad;
          const float* rd = s_r + ((LT + k) * kZ + lane) * kRowPad;
          float a0 = 0.f, dza = 0.f, da0 = 0.f, dda = 0.f;
          for (int cb = 0; cb < (ONE ? 1 : ncb); ++cb) {
            const float4* x4 = reinterpret_cast<const float4*>(xr + cb * kCB);
            const float4* d4 =
                reinterpret_cast<const float4*>(xr + xs + cb * kCB);
#pragma unroll
            for (int c4 = 0; c4 < kCB / 4; ++c4) {
              // the step's rows as broadcasts, the slot's as float4s of
              // the padded rows (STAGED) or through L1
              const float4 p4 = x4[c4], q4 = d4[c4];
              const float p[4] = {p4.x, p4.y, p4.z, p4.w};
              const float q[4] = {q4.x, q4.y, q4.z, q4.w};
              float v[4], dv[4];
              if (STAGED) {
                const float4 a = reinterpret_cast<const float4*>(rv)[c4];
                const float4 b = reinterpret_cast<const float4*>(rd)[c4];
                v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
                dv[0] = b.x, dv[1] = b.y, dv[2] = b.z, dv[3] = b.w;
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  v[e] = row(0, k, cb * kCB + 4 * c4 + e);
                  dv[e] = row(1, k, cb * kCB + 4 * c4 + e);
                }
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                a0 = fmaf(v[e], p[e], a0);
                dza = fmaf(dv[e], p[e], dza);
                da0 = fmaf(v[e], q[e], da0);
                dda = fmaf(dv[e], q[e], dda);
              }
            }
          }
          const float nzk =
              M12 ? __ldg(nzn + static_cast<size_t>(k) * nz + zc) : 0.f;
          G[i] = RID ? slot_gram_zx<true>(a0, dza, da0, dda, kRbf, true,
                                          true)
                     : slot_gram_zx<true, M12>(a0, dza, da0, dda, base, inc,
                                               diff, nzk, nt);
        }
        // the sub-chains of level m; j runs down so chain(i..j-1) is read
        // before this step adds to it
#pragma unroll
        for (int j = m - 1; j >= 0; --j) {
#pragma unroll
          for (int i = 0; i < j; ++i)
            Q[qidx(m, i, j)] = fmaf(Q[qidx(m, i, j - 1)], G[j],
                                    Q[qidx(m, i, j)]);
          Q[qidx(m, j, j)] += G[j];
        }
      }
    }
    // warp 0 chains the block's state with the 8 ranges, in time order;
    // the ranges pass through s_q nr at a time (all 8 but at many levels,
    // where 8 states outgrow shared memory)
    for (int r0 = 0; r0 < kW; r0 += nr) {
      if (r0 > 0) __syncthreads();  // warp 0 is done with the round before
      if (w >= r0 && w < r0 + nr) {
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          s_q[((w - r0) * NQ + q) * kZ + lane] = Q[q];
      }
      __syncthreads();
      if (w == 0) {  // its own range went into s_q in the first round
        float B[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) Q[q] = s_b[q * kZ + lane];
        for (int ww = 0; ww < nr; ++ww) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) B[q] = s_q[(ww * NQ + q) * kZ + lane];
          chain_product<M>(Q, B);
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) s_b[q * kZ + lane] = Q[q];
      }
    }
  }

  __syncthreads();
  if (w == 0 && z < nz) {  // level m is the whole sequence's chain(1..m)
    const size_t plane = static_cast<size_t>(nz) * n_ex;
    const size_t at = static_cast<size_t>(z) * n_ex + n;
    out[at] = 1.f;
#pragma unroll
    for (int m = 1; m <= M; ++m)
      out[m * plane + at] = s_b[qidx(m, 0, m - 1) * kZ + lane];
  }
}

// The serial path: a block is one warp, 32 inducing tensors (one a lane)
// of one example, walking the steps in order.  S[k] of level m's i-th slot
// k = m(m-1)/2 + i is the sum over t_1 < ... < t_{i+1} (up to this step)
// of that level's first i+1 slot Grams: a step adds S[k-1] G_k(t) to S[k],
// i running down so that S[k-1] is still the sum over earlier steps.
template <int M, bool M12>
__global__ void __launch_bounds__(kZ)
kzx_fwd_serial_kernel(const float* __restrict__ vl,
                      const float* __restrict__ dl,
                      const float* __restrict__ xv,
                      const float* __restrict__ xd,
                      const float* __restrict__ nzn,
                      const float* __restrict__ ntn, float* __restrict__ out,
                      int nz, int n_ex, int L, int d2, int base,
                      int increments, int difference) {
  constexpr int LT = ZxShape<M>::LT;
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);  // [LT][kZ]
  const int lane = threadIdx.x;
  const int n_zt = (nz + kZ - 1) / kZ;
  const int n = blockIdx.x / n_zt, z = (blockIdx.x % n_zt) * kZ + lane;
  const int zc = z < nz ? z : nz - 1;
  const bool inc = increments != 0, diff = difference != 0;
  const int T = diff ? L - 1 : L;
  const float* xv_n = xv + static_cast<size_t>(n) * L * d2;
  const float* xd_n = xd + static_cast<size_t>(n) * L * d2;
  for (int k = 0; k < LT; ++k) s_s[k * kZ + lane] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float* x = xv_n + static_cast<size_t>(t) * d2;
    const float* dx = xd_n + static_cast<size_t>(t) * d2;
    for (int m = 1; m <= M; ++m) {
      for (int i = m - 1; i >= 0; --i) {
        const int k = m * (m - 1) / 2 + i;
        const float* v = vl + (static_cast<size_t>(k) * nz + zc) * d2;
        const float* dv = dl + (static_cast<size_t>(k) * nz + zc) * d2;
        float a0 = 0.f, dza = 0.f, da0 = 0.f, dda = 0.f;
        for (int c = 0; c < d2; ++c) {
          a0 = fmaf(v[c], x[c], a0);
          dza = fmaf(dv[c], x[c], dza);
          da0 = fmaf(v[c], dx[c], da0);
          dda = fmaf(dv[c], dx[c], dda);
        }
        const float g = slot_gram_zx<true, M12>(
            a0, dza, da0, dda, base, inc, diff,
            M12 ? nzn[static_cast<size_t>(k) * nz + zc] : 0.f,
            M12 ? ntn[static_cast<size_t>(n) * L + t] : 0.f);
        const float prev = i > 0 ? s_s[(k - 1) * kZ + lane] : 1.f;
        s_s[k * kZ + lane] = fmaf(prev, g, s_s[k * kZ + lane]);
      }
    }
  }
  if (z < nz) {  // level m is its last slot's sum
    const size_t plane = static_cast<size_t>(nz) * n_ex;
    const size_t at = static_cast<size_t>(z) * n_ex + n;
    out[at] = 1.f;
    for (int m = 1; m <= M; ++m)
      out[m * plane + at] = s_s[(m * (m + 1) / 2 - 1) * kZ + lane];
  }
}

template <int M>
cudaError_t launch_kzx_serial(const float* vl, const float* dl,
                              const float* xv, const float* xd,
                              const float* nzn, const float* ntn, float* out,
                              int nz, int n_ex, int L, int d2, int base,
                              int increments, int difference,
                              long long blocks, cudaStream_t stream) {
  const long long smem = ZxShape<M>::LT * kZ * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto* kernel = base == kMatern12 ? kzx_fwd_serial_kernel<M, true>
                                   : kzx_fwd_serial_kernel<M, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kZ, static_cast<int>(smem),
           stream>>>(vl, dl, xv, xd, nzn, ntn, out, nz, n_ex, L, d2, base,
                     increments, difference);
  return cudaGetLastError();
}

template <int M, bool STAGED, bool ONE, bool RID, bool M12>
cudaError_t launch_kzx_rows(const float* vl, const float* dl, const float* xv,
                            const float* xd, const float* nzn,
                            const float* ntn, float* out, int nz, int n_ex,
                            int L, int d2, int ncb, int t_chunk, int nr,
                            int base, int increments, int difference,
                            int smem, long long blocks, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kzx_fwd_kernel<M, STAGED, ONE, RID, M12>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kzx_fwd_kernel<M, STAGED, ONE, RID, M12><<<static_cast<unsigned>(blocks),
                                             kThreads, smem, stream>>>(
      vl, dl, xv, xd, nzn, ntn, out, nz, n_ex, L, d2, ncb, t_chunk, nr, base,
      increments, difference);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_kzx_chained(const float* vl, const float* dl,
                               const float* xv, const float* xd,
                               const float* nzn, const float* ntn, float* out,
                               int nz, int n_ex, int L, int d2, int base,
                               int increments, int difference,
                               long long blocks, cudaStream_t stream) {
  using S = ZxShape<M>;
  const int ncb = (d2 + kCB - 1) / kCB, xs = ncb * kCB;
  int t_chunk = kChunkBytes / (2 * xs * static_cast<int>(sizeof(float)));
  t_chunk = t_chunk < kMaxChunk ? t_chunk : kMaxChunk;
  t_chunk = t_chunk > 1 ? t_chunk : 1;
  const long long rows_bytes = 2LL * S::LT * kZ * kRowPad * sizeof(float);
  const bool staged = ncb == 1 && rows_bytes <= kStageBytes;
  // the steps, nr range states and the block's state; past 9 levels the
  // states take fewer warps a round, then fewer steps a chunk
  auto bytes = [&](int tc, int r) {
    return (static_cast<long long>(tc) * 2 * xs + (r + 1LL) * S::NQ * kZ) *
               static_cast<long long>(sizeof(float)) +
           (staged ? rows_bytes : 0);
  };
  int nr = kW;
  while (nr > 1 && bytes(t_chunk, nr) > kSmemMax) nr /= 2;
  while (t_chunk > 1 && bytes(t_chunk, nr) > kSmemMax) t_chunk /= 2;
  const long long smem = bytes(t_chunk, nr);
  if (smem > kSmemMax)  // rows too wide beside the states
    return launch_kzx_serial<M>(vl, dl, xv, xd, nzn, ntn, out, nz, n_ex, L,
                                d2, base, increments, difference, blocks,
                                stream);
  const bool rid = base == kRbf && increments && difference;
#define GPSIG_KZX_ROWS(...)                                                  \
  return launch_kzx_rows<M, __VA_ARGS__>(                                    \
      vl, dl, xv, xd, nzn, ntn, out, nz, n_ex, L, d2, ncb, t_chunk, nr,      \
      base, increments, difference, static_cast<int>(smem), blocks, stream)
  if (base == kMatern12) {
    if (staged) GPSIG_KZX_ROWS(true, true, false, true);
    if (ncb == 1) GPSIG_KZX_ROWS(false, true, false, true);
    GPSIG_KZX_ROWS(false, false, false, true);
  }
  if (staged && rid) GPSIG_KZX_ROWS(true, true, true, false);
  if (staged) GPSIG_KZX_ROWS(true, true, false, false);
  if (ncb == 1) GPSIG_KZX_ROWS(false, true, false, false);
  GPSIG_KZX_ROWS(false, false, false, false);
#undef GPSIG_KZX_ROWS
}

template <int M>
cudaError_t launch_kzx(const float* vl, const float* dl, const float* xv,
                       const float* xd, const float* nzn, const float* ntn,
                       float* out, int nz, int n_ex, int L, int d2, int base,
                       int increments, int difference, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(n_ex) * ((nz + kZ - 1) / kZ);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  // the chained path holds one range state and the block's beside a step
  constexpr bool kChains = (2LL * ZxShape<M>::NQ * kZ + 2 * kCB) *
                               static_cast<long long>(sizeof(float)) <=
                           kSmemMax;
  if constexpr (kChains)
    return launch_kzx_chained<M>(vl, dl, xv, xd, nzn, ntn, out, nz, n_ex, L,
                                 d2, base, increments, difference, blocks,
                                 stream);
  else
    return launch_kzx_serial<M>(vl, dl, xv, xd, nzn, ntn, out, nz, n_ex, L,
                                d2, base, increments, difference, blocks,
                                stream);
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_kzx_fwd(const float* vl, const float* dl,
                             const float* xv, const float* xd,
                             const float* nzn, const float* ntn, float* out,
                             int lt, int nz, int n_ex, int L, int d2,
                             int num_levels, int base, int increments,
                             int difference, void* stream) {
  if (lt != num_levels * (num_levels + 1) / 2 || nz <= 0 || n_ex <= 0 ||
      L <= 0 || d2 <= 0 || !gpsig::base_ok(base, nzn, ntn))
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_kzx, vl, dl, xv, xd, nzn, ntn,
                      out, nz, n_ex, L, d2, base, increments, difference,
                      static_cast<cudaStream_t>(stream))
}
