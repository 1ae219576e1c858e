// K1, Kzz forward: the (M+1, nZ, nZ) level stack of the inducing-tensor
// Gram.  Replaces the TPU kernel _kernel_tens_fwd
// (gpsig_tpu/ops/inducing_pallas.py:223, launched by _tens_fwd_call :312).
//
// Level m at (i, j) is the product of the slot Grams of level m's m packed
// slots (triangular packing: level m owns slots m(m-1)/2 .. m(m-1)/2+m-1);
// level 0 is 1.
//
// Symmetric mode (one set of inducing tensors, lhs- and rhs-augmented):
// a00(i, j) = a00(j, i), d01(i, j) = d10(j, i), dxx(i, j) = dxx(j, i), so
// Kzz is symmetric.  Only the upper tile pairs (I <= J) are computed, as
// the TPU kernel computes its upper blocks (symmetric=True,
// inducing_pallas.py:483-487), and each off-diagonal tile is written twice:
// at (I, J) and, through a shared-memory transpose so that both stores are
// coalesced, at (J, I); a diagonal tile writes its upper half and mirrors
// it.  The output is exactly symmetric.
//
// What bounds it on the card: at the serving shape (lt=10, nZ=500, d2=16,
// symmetric) 125k unordered pairs x 10 slots x (4 dots of 16 + 4
// transcendentals, expf and three common.cuh::expm1_acc): ~0.08 G FMAs and
// ~0.15 G instructions of transcendentals, against a 5 MB output -- a few
// microseconds of issue.
//
// The design:
//   * a block per (32 x 32 tile pair, level), the highest level first (its
//     blocks carry the most slots), 136 x 4 = 544 blocks at nZ=500, M=4;
//   * 256 threads of 2 x 2 pairs each (common.cuh: zz_stage, zz_dots):
//     each slot's rows of both tiles staged once per 16 channels, double
//     buffered, so one barrier a slot at d2 <= 16; the dots from float4s,
//     8 loads for 64 FMAs; any width in blocks of 16 channels.
//
// matern12 (M12, a compile-time instance): the slot Gram is common.cuh's
// mat12_cross with the step norms of the pair's tensors (two float loads a
// pair and slot, through L1) -- 4 square roots, 7 divisions and 5
// exp/expm1 an entry where rbf takes 4 transcendentals; two blocks an SM.
//
// Inputs are (lt, nZ, d2) row-major float32: lhs-augmented values vl and
// differences dl, rhs-augmented vr and dr (inducing_cuda._prep_tensors);
// with matern12 the step norms nl, nr (lt, nZ) of dl and dr's true
// channels (inducing_cuda._step_norms), else null.
#include "common.cuh"

namespace gpsig {
namespace {

// Four blocks an SM (64 registers; 528 slots for the 544 blocks at nZ=500,
// M=4, so nearly all run at once): faster on the H100 than the three that
// 80 registers allowed.  matern12's closed form takes two (128 registers).
template <int M, bool M12>
__global__ void __launch_bounds__(kZzThreads, M12 ? 2 : 4)
kzz_fwd_kernel(const float* __restrict__ vl, const float* __restrict__ dl,
               const float* __restrict__ vr, const float* __restrict__ dr,
               const float* __restrict__ nl, const float* __restrict__ nr,
               float* __restrict__ out, int nz, int d2, int base,
               int increments, int symmetric) {
  __shared__ ZzRows s_rows[2];
  __shared__ float s_t[kZzTile][kZzTile + 1];

  const int n = (nz + kZzTile - 1) / kZzTile;
  const long long n_pairs = symmetric ? static_cast<long long>(n) * (n + 1) / 2
                                      : static_cast<long long>(n) * n;
  const int m = M - static_cast<int>(blockIdx.x / n_pairs);
  const long long p = blockIdx.x % n_pairs;
  int ti, tj;
  if (symmetric) {
    upper_pair(p, n, ti, tj);
  } else {
    ti = static_cast<int>(p / n);
    tj = static_cast<int>(p % n);
  }
  const int i0 = ti * kZzTile, j0 = tj * kZzTile;
  const int k0 = m * (m - 1) / 2;
  const int ncb = (d2 + kZzCB - 1) / kZzCB;
  const int n_it = m * ncb;  // (slot, channel block) in order
  const bool inc = increments != 0;

  float R[4] = {1.f, 1.f, 1.f, 1.f}, acc[4][4];
  zz_stage(s_rows[0], vl, dl, vr, dr, k0, i0, j0, 0, nz, d2);
  __syncthreads();
  for (int it = 0; it < n_it; ++it) {
    // the next (slot, channel block) into the other buffer, read by the
    // iteration before the last barrier
    if (it + 1 < n_it)
      zz_stage(s_rows[(it + 1) & 1], vl, dl, vr, dr, k0 + (it + 1) / ncb,
               i0, j0, (it + 1) % ncb, nz, d2);
    const int cb = it % ncb;
    if (cb == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
    }
    zz_dots(s_rows[it & 1], acc);
    if (cb == ncb - 1) {
      const int k = k0 + it / ncb;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float nx = 0.f, ny = 0.f;
        if (M12) {  // the step norms of the pair's tensors
          const int i = i0 + threadIdx.x / 16 + 16 * (q >> 1);
          const int j = j0 + threadIdx.x % 16 + 16 * (q & 1);
          nx = i < nz ? __ldg(nl + static_cast<size_t>(k) * nz + i) : 0.f;
          ny = j < nz ? __ldg(nr + static_cast<size_t>(k) * nz + j) : 0.f;
        }
        R[q] *= slot_gram_zz<true, M12>(acc[q][0], acc[q][1], acc[q][2],
                                        acc[q][3], base, inc, nx, ny);
      }
    }
    __syncthreads();
  }

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool diag = symmetric && ti == tj;
  const size_t plane = static_cast<size_t>(nz) * nz;
  float* o = out + m * plane;
  // (i, j) itself; a diagonal tile its upper half
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty + 16 * (q >> 1), c = tx + 16 * (q & 1);
    const int i = i0 + r, j = j0 + c;
    if (i < nz && j < nz && (!diag || r <= c)) {
      const size_t at = static_cast<size_t>(i) * nz + j;
      o[at] = R[q];
      if (m == 1) out[at] = 1.f;  // level 0
    }
  }
  if (!symmetric) return;
  // the mirror (j, i) through a transpose: thread (ty, tx) writes row
  // j0 + r, column i0 + c, the value of pair (i0 + c, j0 + r); a diagonal
  // tile its lower half
#pragma unroll
  for (int q = 0; q < 4; ++q)
    s_t[ty + 16 * (q >> 1)][tx + 16 * (q & 1)] = R[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty + 16 * (q >> 1), c = tx + 16 * (q & 1);
    const int row = j0 + r, col = i0 + c;
    if (row < nz && col < nz && (!diag || r > c)) {
      const size_t at = static_cast<size_t>(row) * nz + col;
      o[at] = s_t[c][r];
      if (m == 1) out[at] = 1.f;
    }
  }
}

template <int M>
cudaError_t launch_kzz(const float* vl, const float* dl, const float* vr,
                       const float* dr, const float* nl, const float* nr,
                       float* out, int nz, int d2, int base, int increments,
                       int symmetric, cudaStream_t stream) {
  const long long n = (nz + kZzTile - 1) / kZzTile;
  const long long blocks = M * (symmetric ? n * (n + 1) / 2 : n * n);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  auto* kernel = base == kMatern12 ? kzz_fwd_kernel<M, true>
                                   : kzz_fwd_kernel<M, false>;
  kernel<<<static_cast<unsigned>(blocks), kZzThreads, 0, stream>>>(
      vl, dl, vr, dr, nl, nr, out, nz, d2, base, increments, symmetric);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_kzz_fwd(const float* vl, const float* dl,
                             const float* vr, const float* dr,
                             const float* nl, const float* nr, float* out,
                             int lt, int nz, int d2, int num_levels, int base,
                             int increments, int symmetric, void* stream) {
  if (lt != num_levels * (num_levels + 1) / 2 || nz <= 0 || d2 <= 0 ||
      !gpsig::base_ok(base, nl, nr))
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_kzz, vl, dl, vr, dr, nl, nr,
                      out, nz, d2, base, increments, symmetric,
                      static_cast<cudaStream_t>(stream))
}
