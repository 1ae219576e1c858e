// K2, Kzz backward: the VJP of K1 (kzz_fwd.cu) under a cotangent ct of the
// (M+1, nZ, nZ) level stack.  Replaces the TPU kernel _kernel_tens_bwd
// (gpsig_tpu/ops/inducing_pallas.py:256, launched by _make_tens_core.bwd
// :493).
//
// Level m at (i, j) is the product of its m slot Grams G_s(i, j), so slot s
// receives Mbar_s = ct[m](i, j) * prod_{r != s} G_r(i, j) (exclusive
// products by prefix and suffix, inducing_pallas.py:276-290), and its four
// weights W = Mbar_s * dG_s/d(a00, d01, d10, dxx) (common.cuh) spread over
// the rows:
//   g_vl[i] += W_A00 vr[j] + W_d01 dr[j]    g_dl[i] += W_d10 vr[j] + W_dxx dr[j]
//   g_vr[j] += W_A00 vl[i] + W_d10 dl[i]    g_dr[j] += W_d01 vl[i] + W_dxx dl[i]
// K1 computes every (i, j) pair, so the cotangent is used as it comes; the
// TPU's mirror adjoint (inducing_pallas.py:497-501) has no counterpart.
//
// What bounds it on the card: at the training shape (lt=10, nZ=500,
// d2=16) each side recomputes 250k pairs x 10 slots x 4 dots of 16 and
// contracts 4 weights per slot with 16-wide rows: about 0.5 G FMAs in all,
// against ~6 MB of inputs and outputs, so FMA throughput bounds it (~0.015 ms
// at 67 TFLOP/s).  The design: grid (row strips, shares, 2 sides).  A block
// owns a strip of 16 rows of one side ("own") and walks a share of the
// other side's 16-row tiles, level by level.  For each tile, each of its
// 256 threads computes one pair's m slot Grams and weights into shared
// memory; then the block contracts the weights with the other side's
// staged rows into per-row accumulators in shared memory, each accumulator
// owned by one thread.  A block writes its share as a partial slab; the
// wrapper sums the shares (torch.sum), as XLA summed the TPU kernel's
// slabs.  No atomics: the result is deterministic.
//
// Inputs are (lt, nZ, d2) row-major float32 (inducing_cuda._prep_tensors)
// and ct (M+1, nZ, nZ); out is (2 sides, splits, 2 [value, difference],
// lt, nZ, d2), side 0 the lhs rows (vl, dl), side 1 the rhs rows (vr, dr).
#include "common.cuh"

namespace gpsig {
namespace {

constexpr int kTile = 16;                 // strip / tile edge
constexpr int kThreads = kTile * kTile;   // one thread per pair of a tile

// Shared floats a block needs at level m (the largest level sets the size).
inline int kzz_bwd_smem_floats(int m, int d2) {
  const int ds = d2 + 1;                  // padded row stride
  return 4 * m * kTile * ds               // own / other value, diff rows
         + 4 * m * kThreads               // weights
         + 2 * m * kTile * d2;            // own-row accumulators
}

template <int M>
__global__ void __launch_bounds__(kThreads)
kzz_bwd_kernel(const float* __restrict__ vl, const float* __restrict__ dl,
               const float* __restrict__ vr, const float* __restrict__ dr,
               const float* __restrict__ ct, float* __restrict__ out, int nz,
               int d2, int base, int increments, int splits,
               int tiles_per_split) {
  constexpr int LT = M * (M + 1) / 2;
  extern __shared__ float smem[];
  const int ds = d2 + 1;
  const int tid = threadIdx.x;
  const int a = tid / kTile, b = tid % kTile;  // own row, other row of a pair
  const bool row_side = blockIdx.z == 0;
  const float* own_v = row_side ? vl : vr;
  const float* own_d = row_side ? dl : dr;
  const float* oth_v = row_side ? vr : vl;
  const float* oth_d = row_side ? dr : dl;
  const int own0 = blockIdx.x * kTile;
  const int n_tiles = (nz + kTile - 1) / kTile;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  const bool inc = increments != 0;
  const size_t plane = static_cast<size_t>(nz) * nz;
  const size_t slot_stride = static_cast<size_t>(nz) * d2;
  float* out_blk = out + static_cast<size_t>(blockIdx.z * splits + blockIdx.y)
                             * 2 * LT * slot_stride;

  int k0 = 0;
#pragma unroll
  for (int m = 1; m <= M; ++m) {  // level m owns slots k0 .. k0 + m - 1
    float* s_own_v = smem;
    float* s_own_d = s_own_v + m * kTile * ds;
    float* s_oth_v = s_own_d + m * kTile * ds;
    float* s_oth_d = s_oth_v + m * kTile * ds;
    float* s_w = s_oth_d + m * kTile * ds;   // [m][4][kThreads]
    float* s_acc = s_w + 4 * m * kThreads;   // [m][2][kTile][d2]
    const int n_rows = m * kTile * d2;
    const int n_acc = 2 * n_rows;

    __syncthreads();  // the previous level is done with shared memory
    for (int idx = tid; idx < n_rows; idx += kThreads) {
      const int s = idx / (kTile * d2), r = (idx / d2) % kTile, c = idx % d2;
      const int row = own0 + r;
      const size_t g = (k0 + s) * slot_stride + static_cast<size_t>(row) * d2 + c;
      s_own_v[(s * kTile + r) * ds + c] = row < nz ? own_v[g] : 0.f;
      s_own_d[(s * kTile + r) * ds + c] = row < nz ? own_d[g] : 0.f;
    }
    for (int idx = tid; idx < n_acc; idx += kThreads) s_acc[idx] = 0.f;

    for (int tile = tile_begin; tile < tile_end; ++tile) {
      const int oth0 = tile * kTile;
      __syncthreads();  // the previous tile's contraction is done
      for (int idx = tid; idx < n_rows; idx += kThreads) {
        const int s = idx / (kTile * d2), r = (idx / d2) % kTile, c = idx % d2;
        const int row = oth0 + r;
        const size_t g =
            (k0 + s) * slot_stride + static_cast<size_t>(row) * d2 + c;
        s_oth_v[(s * kTile + r) * ds + c] = row < nz ? oth_v[g] : 0.f;
        s_oth_d[(s * kTile + r) * ds + c] = row < nz ? oth_d[g] : 0.f;
      }
      __syncthreads();

      // this thread's pair: slot Grams, partials, exclusive products
      const int own = own0 + a, oth = oth0 + b;
      const bool live = own < nz && oth < nz;
      float G[M], P[M][4];
#pragma unroll
      for (int s = 0; s < m; ++s) {
        const float* ov = s_own_v + (s * kTile + a) * ds;
        const float* od = s_own_d + (s * kTile + a) * ds;
        const float* xv = s_oth_v + (s * kTile + b) * ds;
        const float* xd = s_oth_d + (s * kTile + b) * ds;
        float vv = 0.f, vd = 0.f, dv = 0.f, dd = 0.f;
        for (int c = 0; c < d2; ++c) {
          vv = fmaf(ov[c], xv[c], vv);
          vd = fmaf(ov[c], xd[c], vd);
          dv = fmaf(od[c], xv[c], dv);
          dd = fmaf(od[c], xd[c], dd);
        }
        // d01 = <vl, dr>, d10 = <dl, vr>: own is lhs on the row side
        G[s] = slot_gram_zz_partials(vv, row_side ? vd : dv,
                                     row_side ? dv : vd, dd, base, inc, P[s]);
      }
      const size_t at = row_side ? static_cast<size_t>(own) * nz + oth
                                 : static_cast<size_t>(oth) * nz + own;
      const float c_m = live ? ct[m * plane + at] : 0.f;
      float pre = 1.f;
#pragma unroll
      for (int s = 0; s < m; ++s) {
        float suf = 1.f;
#pragma unroll
        for (int r = s + 1; r < m; ++r) suf *= G[r];
        const float mbar = c_m * pre * suf;
        pre *= G[s];
        // weights on the own side: value rows pair W_A00 with the other
        // side's values and W_X with its differences; difference rows
        // pair W_Y with values and W_dxx with differences
        s_w[(s * 4 + 0) * kThreads + tid] = mbar * P[s][0];
        s_w[(s * 4 + 1) * kThreads + tid] = mbar * P[s][row_side ? 1 : 2];
        s_w[(s * 4 + 2) * kThreads + tid] = mbar * P[s][row_side ? 2 : 1];
        s_w[(s * 4 + 3) * kThreads + tid] = mbar * P[s][3];
      }
      __syncthreads();

      // contraction over the tile's other rows into the own-row sums
      for (int idx = tid; idx < n_acc; idx += kThreads) {
        const int s = idx / (2 * kTile * d2);
        const int half = (idx / (kTile * d2)) % 2;
        const int r = (idx / d2) % kTile, c = idx % d2;
        const float* w1 = s_w + (s * 4 + (half ? 2 : 0)) * kThreads + r * kTile;
        const float* w2 = s_w + (s * 4 + (half ? 3 : 1)) * kThreads + r * kTile;
        const float* xv = s_oth_v + s * kTile * ds + c;
        const float* xd = s_oth_d + s * kTile * ds + c;
        float acc = 0.f;
#pragma unroll
        for (int bb = 0; bb < kTile; ++bb) {
          acc = fmaf(w1[bb], xv[bb * ds], acc);
          acc = fmaf(w2[bb], xd[bb * ds], acc);
        }
        s_acc[idx] += acc;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < n_acc; idx += kThreads) {
      const int s = idx / (2 * kTile * d2);
      const int half = (idx / (kTile * d2)) % 2;
      const int r = (idx / d2) % kTile, c = idx % d2;
      const int row = own0 + r;
      if (row < nz)
        out_blk[(static_cast<size_t>(half) * LT + k0 + s) * slot_stride +
                static_cast<size_t>(row) * d2 + c] = s_acc[idx];
    }
    k0 += m;
  }
}

template <int M>
cudaError_t launch_kzz_bwd(const float* vl, const float* dl, const float* vr,
                           const float* dr, const float* ct, float* out,
                           int nz, int d2, int base, int increments,
                           int splits, int tiles_per_split,
                           cudaStream_t stream) {
  const int smem =
      kzz_bwd_smem_floats(M, d2) * static_cast<int>(sizeof(float));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kzz_bwd_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((nz + kTile - 1) / kTile, splits, 2);
  kzz_bwd_kernel<M><<<grid, kThreads, smem, stream>>>(
      vl, dl, vr, dr, ct, out, nz, d2, base, increments, splits,
      tiles_per_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gpsig

extern "C" int gpsig_kzz_bwd(const float* vl, const float* dl,
                             const float* vr, const float* dr,
                             const float* ct, float* out, int lt, int nz,
                             int d2, int num_levels, int base, int increments,
                             int splits, int tiles_per_split, void* stream) {
  const int n_tiles = (nz + 15) / 16;
  if (lt != num_levels * (num_levels + 1) / 2 || nz <= 0 || d2 <= 0 ||
      n_tiles > 65535 || splits <= 0 || splits > 65535 ||
      tiles_per_split <= 0 || (splits - 1) * tiles_per_split >= n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  GPSIG_SWITCH_LEVELS(num_levels, gpsig::launch_kzz_bwd, vl, dl, vr, dr, ct,
                      out, nz, d2, base, increments, splits, tiles_per_split,
                      static_cast<cudaStream_t>(stream))
}
