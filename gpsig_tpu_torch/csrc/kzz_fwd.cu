// K1, Kzz forward: the (M+1, nZ, nZ) level stack of the inducing-tensor
// Gram.  Replaces the TPU kernel _kernel_tens_fwd
// (gpsig_tpu/ops/inducing_pallas.py:223, launched by _tens_fwd_call :312).
//
// Level m at (i, j) is the product of the slot Grams of level m's m packed
// slots (triangular packing: level m owns slots m(m-1)/2 .. m(m-1)/2+m-1);
// level 0 is 1.
//
// What bounds it on the card: at the serving shape (lt=10, nZ=500, d2=16)
// the work is 250k outputs x 10 slots x (4 dots of 16 + 3 transcendentals),
// about 0.3 GFLOP, and the output is (M+1) nZ^2 floats = 5 MB, so a single
// call is latency- and launch-bound rather than bound by FLOPs or bytes.
// The design keeps it to one launch with enough independent threads: one
// thread per (i, j) pair, 16x16 pairs per block, and the four augmented
// rows of each slot staged through shared memory in 16-column chunks so any
// feature width d2 tiles through.  Every (i, j) is computed outright; the
// TPU kernel's upper-triangle-and-mirror is a later optimisation.
//
// Inputs are (lt, nZ, d2) row-major float32: lhs-augmented values vl and
// differences dl, rhs-augmented vr and dr (inducing_cuda._prep_tensors).
#include "common.cuh"

namespace gpsig {
namespace {

constexpr int kTile = 16;  // output tile edge and feature chunk width

template <int M>
__global__ void __launch_bounds__(kTile * kTile)
kzz_fwd_kernel(const float* __restrict__ vl, const float* __restrict__ dl,
               const float* __restrict__ vr, const float* __restrict__ dr,
               float* __restrict__ out, int nz, int d2, int base,
               int increments) {
  __shared__ float s_vl[kTile][kTile + 1];
  __shared__ float s_dl[kTile][kTile + 1];
  __shared__ float s_vr[kTile][kTile + 1];
  __shared__ float s_dr[kTile][kTile + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int i = i0 + ty, j = j0 + tx;
  const bool live = i < nz && j < nz;
  const bool inc = increments != 0;
  const size_t plane = static_cast<size_t>(nz) * nz;
  const size_t at = static_cast<size_t>(i) * nz + j;
  // staging: thread (ty, tx) brings column c0+tx of lhs row i0+ty and of
  // rhs row j0+ty; rows and columns past the edge stage as 0
  const int li = i0 + ty, rj = j0 + ty;

  if (live) out[at] = 1.f;
  int k = 0;
#pragma unroll
  for (int m = 1; m <= M; ++m) {
    float R = 1.f;
    for (int s = 0; s < m; ++s, ++k) {
      const size_t slot = static_cast<size_t>(k) * nz * d2;
      float a00 = 0.f, d01 = 0.f, d10 = 0.f, dxx = 0.f;
      for (int c0 = 0; c0 < d2; c0 += kTile) {
        const int c = c0 + tx;
        const bool lok = li < nz && c < d2, rok = rj < nz && c < d2;
        const size_t lo = slot + static_cast<size_t>(li) * d2 + c;
        const size_t ro = slot + static_cast<size_t>(rj) * d2 + c;
        s_vl[ty][tx] = lok ? vl[lo] : 0.f;
        s_dl[ty][tx] = lok ? dl[lo] : 0.f;
        s_vr[ty][tx] = rok ? vr[ro] : 0.f;
        s_dr[ty][tx] = rok ? dr[ro] : 0.f;
        __syncthreads();
#pragma unroll
        for (int cc = 0; cc < kTile; ++cc) {
          const float a = s_vl[ty][cc], b = s_dl[ty][cc];
          const float x = s_vr[tx][cc], y = s_dr[tx][cc];
          a00 = fmaf(a, x, a00);
          d01 = fmaf(a, y, d01);
          d10 = fmaf(b, x, d10);
          dxx = fmaf(b, y, dxx);
        }
        __syncthreads();
      }
      R *= slot_gram_zz(a00, d01, d10, dxx, base, inc);
    }
    if (live) out[m * plane + at] = R;
  }
}

template <int M>
cudaError_t launch_kzz(const float* vl, const float* dl, const float* vr,
                       const float* dr, float* out, int nz, int d2, int base,
                       int increments, cudaStream_t stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((nz + kTile - 1) / kTile, (nz + kTile - 1) / kTile);
  kzz_fwd_kernel<M><<<grid, block, 0, stream>>>(vl, dl, vr, dr, out, nz, d2,
                                                base, increments);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_kzz_fwd(const float* vl, const float* dl,
                             const float* vr, const float* dr, float* out,
                             int lt, int nz, int d2, int num_levels, int base,
                             int increments, void* stream) {
  if (lt != num_levels * (num_levels + 1) / 2 || nz <= 0 || d2 <= 0 ||
      (nz + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_kzz, vl, dl, vr, dr, out, nz,
                      d2, base, increments,
                      static_cast<cudaStream_t>(stream))
}
