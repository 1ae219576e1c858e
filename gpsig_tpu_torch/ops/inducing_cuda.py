"""Inducing-tensor covariances (Kzz, Kzx) through hand-written CUDA kernels.

The port of ``gpsig_tpu/ops/inducing_pallas.py``, forward and backward:

* ``kzz_fwd`` launches K1 (``csrc/kzz_fwd.cu``), which replaces the TPU
  kernel ``_kernel_tens_fwd`` (``inducing_pallas.py:223``);
* ``kzz_bwd`` launches K2 (``csrc/kzz_bwd.cu``), which replaces
  ``_kernel_tens_bwd`` (``inducing_pallas.py:256``);
* ``kzx_fwd`` launches K3 (``csrc/kzx_fwd.cu``), which replaces
  ``_kernel_zx_fwd`` (``inducing_pallas.py:697``);
* ``kzx_bwd`` launches K4 (``csrc/kzx_bwd.cu``), which replaces
  ``_kernel_zx_bwd`` (``inducing_pallas.py:740``).

Each wrapper has a plain PyTorch version beside it (``kzz_fwd_plain``, ...)
built from the same algebra in torch ops, and a launch counter
(``kzz_fwd.launches``, ...) that rises by one per kernel launch and nowhere
else.  A wrapper runs its plain version only because the tensors it was
given lie on the CPU; on a CUDA tensor it launches the kernel or raises
(float64, an unsupported base, mixed devices).  There is no fallback from a
failed build or launch.

``_KzzFn`` and ``_KzxFn`` tie each forward to its backward as
``torch.autograd.Function``s over the augmented rows, the counterpart of the
JAX package's ``jax.custom_vjp`` cores.  The host-side prep stays in torch,
as the JAX package keeps it in XLA, so autograd carries the adjoint from
the rows to Z, X and the lengthscales (``jax.vjp(prep, ...)`` at
``inducing_pallas.py:494`` and ``:919``): the norm augmentation that turns
the rbf exponent -|z - x|^2/2 into one dot product, lhs ``[z, -|z|^2/2, 1]``
against rhs ``[x, 1, -|x|^2/2]``, and the exact norm-channel differences
``-<z1 + z0, z1 - z0>/2`` of each increment.  The kernels take the augmented
rows and nothing else.  The TPU-only machinery (lane batching, VMEM plans,
padding to 128, the Kzz mirror) has no counterpart.

Each wrapper's docstring says what bounds its kernel on the H100 and what
the design does about it; the header of its ``.cu`` file has the detail.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import gram
from .signature import (cumsum_exclusive,
                        signature_kern_tens_vs_seq_first_order, tensor_kern)

SUPPORTED_BASES = ("rbf", "linear")
_BASE_IDS = {"rbf": 0, "linear": 1}  # csrc/common.cuh::Base
MAX_LEVELS = 8  # csrc/common.cuh::kMaxLevels
_K2_TILE = 16  # csrc/kzz_bwd.cu::kTile
_K4_LANES = 32  # csrc/kzx_bwd.cu::kZ
_K4_MAX_CHUNK = 16  # time steps a K4 block stages at once
_K4_SMEM = 64 * 1024  # K4's shared memory: three blocks on an SM
_TARGET_BLOCKS = 2 * 132  # two blocks for each SM of an H100


# ---------------------------------------------------------------------------
# host-side prep
# ---------------------------------------------------------------------------


def _aug_value(Z, base: str, lhs: bool):
    """(..., d) -> (..., d2) norm-augmented value vectors."""
    if base == "linear":
        return Z
    n = -0.5 * torch.sum(torch.square(Z), dim=-1, keepdim=True)
    ones = torch.ones_like(n)
    return torch.cat([Z, n, ones] if lhs else [Z, ones, n], dim=-1)


def _aug_diff(Z0, Z1, base: str, lhs: bool):
    """Difference vectors with the exact norm-channel difference."""
    dZ = Z1 - Z0
    if base == "linear":
        return dZ
    dn = -0.5 * torch.sum((Z1 + Z0) * dZ, dim=-1, keepdim=True)
    zeros = torch.zeros_like(dn)
    return torch.cat([dZ, dn, zeros] if lhs else [dZ, zeros, dn], dim=-1)


def _prep_tensors(Z, base: str, increments: bool, lhs: bool):
    """(lt, nZ, [2,] d) -> value / difference rows, each (lt, nZ, d2)."""
    if increments:
        V = _aug_value(Z[:, :, 0, :], base, lhs)
        D = _aug_diff(Z[:, :, 0, :], Z[:, :, 1, :], base, lhs)
    else:
        V = _aug_value(Z, base, lhs)
        D = torch.zeros_like(V)
    return V.contiguous(), D.contiguous()


def _prep_seq(X, base: str, lhs: bool = False):
    """(N, L, d) -> value / step rows, each (N, L, d2), rhs-augmented unless
    ``lhs``; the last step repeats the last observation, so its difference
    is exactly 0."""
    Xn = torch.cat([X[:, 1:], X[:, -1:]], dim=1)
    V = _aug_value(X, base, lhs=lhs)
    D = _aug_diff(X, Xn, base, lhs=lhs)
    return V.contiguous(), D.contiguous()


def _check_config(num_levels: int, base: str, lt: int):
    if base not in SUPPORTED_BASES:
        raise ValueError(
            f"base {base!r} has no inducing kernel; supported: "
            f"{SUPPORTED_BASES}"
        )
    if lt != num_levels * (num_levels + 1) // 2:
        raise ValueError(f"{lt} packed slots do not make {num_levels} levels")


def _check_cuda(name: str, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: inputs must share one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name} runs in float32 on the card, got {t.dtype}; "
                "float64 runs on the CPU (the plain version)"
            )


def _launch(fn_name: str, *args):
    from . import _cuda_build

    rc = getattr(_cuda_build.load().lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed to launch: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1: Kzz
# ---------------------------------------------------------------------------


def kzz_fwd_plain(Vl, Dl, Vr, Dr, *, num_levels: int, base: str,
                  increments: bool):
    """Plain torch version of K1 on the augmented rows (lt, nZ, d2):
    ``(num_levels+1, nZ, nZ)``.  f32 uses ``gram.exp_accurate`` and the
    Taylor ``expm1``; f64 the native exp/expm1."""
    def dots(A, B):
        return torch.matmul(A, B.transpose(1, 2))

    if base == "linear":
        G = dots(Dl, Dr) if increments else dots(Vl, Vr)
    elif not increments:
        G = gram.exp_accurate(dots(Vl, Vr))
    else:
        d01, d10 = dots(Vl, Dr), dots(Dl, Vr)
        expm1 = gram._expm1_stable
        G = gram.exp_accurate(dots(Vl, Vr)) * (
            expm1(d01 + d10 + dots(Dl, Dr)) - expm1(d01) - expm1(d10)
        )
    return tensor_kern(G, num_levels)


def kzz_fwd(Vl, Dl, Vr, Dr, *, num_levels: int, base: str,
            increments: bool):
    """K1 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_tens_fwd`` (``gpsig_tpu/ops/inducing_pallas.py:223``).
    Bound on the H100: at nZ=500 the output is (M+1) nZ^2 floats = 5 MB and
    the work ~0.3 GFLOP, so a call is latency- and launch-bound.  Design:
    one launch, one thread per (i, j), rows staged through shared memory in
    16-column chunks (``csrc/kzz_fwd.cu``)."""
    lt, nz, d2 = Vl.shape
    _check_config(num_levels, base, lt)
    for t in (Dl, Vr, Dr):
        if t.shape != Vl.shape:
            raise ValueError(f"kzz_fwd: shape {tuple(t.shape)} != "
                             f"{tuple(Vl.shape)}")
    if Vl.device.type == "cpu":
        return kzz_fwd_plain(Vl, Dl, Vr, Dr, num_levels=num_levels,
                             base=base, increments=increments)
    _check_cuda("kzz_fwd", Vl, Dl, Vr, Dr)
    if num_levels > MAX_LEVELS:
        raise ValueError(f"kzz_fwd is built for up to {MAX_LEVELS} levels")
    Vl, Dl, Vr, Dr = (t.contiguous() for t in (Vl, Dl, Vr, Dr))
    out = torch.empty((num_levels + 1, nz, nz), dtype=torch.float32,
                      device=Vl.device)
    _launch("gpsig_kzz_fwd", Vl.data_ptr(), Dl.data_ptr(), Vr.data_ptr(),
            Dr.data_ptr(), out.data_ptr(), lt, nz, d2, num_levels,
            _BASE_IDS[base], int(increments), _stream(Vl))
    kzz_fwd.launches += 1
    return out


kzz_fwd.launches = 0


# ---------------------------------------------------------------------------
# K2: Kzz backward
# ---------------------------------------------------------------------------


def _level_slots(num_levels: int):
    """(m, slots of level m) under the triangular packing."""
    k = 0
    for m in range(1, num_levels + 1):
        yield m, list(range(k, k + m))
        k += m


def _excl_products(Ms):
    """prod_{b != a} Ms[b] for each a by prefix and suffix products
    (``inducing_pallas.py:276-290``); None for an empty product."""
    n = len(Ms)
    pre, suf = [None] * n, [None] * n
    for a in range(1, n):
        pre[a] = Ms[a - 1] if pre[a - 1] is None else pre[a - 1] * Ms[a - 1]
    for a in range(n - 2, -1, -1):
        suf[a] = Ms[a + 1] if suf[a + 1] is None else suf[a + 1] * Ms[a + 1]
    return [s if p is None else (p if s is None else p * s)
            for p, s in zip(pre, suf)]


def _contract(terms, like):
    """Sum of ``fn(w, rows)`` over the (fn, w, rows) whose weight is set."""
    out = None
    for fn, w, rows in terms:
        if w is not None:
            out = fn(w, rows) if out is None else out + fn(w, rows)
    return torch.zeros_like(like) if out is None else out


def _slot_dots(A, B):
    return torch.matmul(A, B.transpose(1, 2))


def _zz_partials(Vl, Dl, Vr, Dr, base: str, increments: bool,
                 dots=_slot_dots):
    """Slot Grams G (lt, nZ, nZ) and their partials dG/d(A00, d01, d10,
    dxx), None where zero: ``common.cuh::slot_gram_zz_partials`` in torch
    ops (``_slot_gram_zz_bwd``, ``inducing_pallas.py:175``, before the slot
    cotangent).  ``dots`` contracts the feature axis; the seq x seq plain
    versions pass their own, for (N1, N2, L1, L2) increment Grams."""

    exp, expm1 = gram.exp_accurate, gram._expm1_stable
    if base == "linear":
        if increments:
            return dots(Dl, Dr), (None, None, None, 1.0)
        return dots(Vl, Vr), (1.0, None, None, None)
    eA = exp(dots(Vl, Vr))
    if not increments:
        return eA, (eA, None, None, None)
    d01, d10 = dots(Vl, Dr), dots(Dl, Vr)
    es, e01, e10 = expm1(d01 + d10 + dots(Dl, Dr)), expm1(d01), expm1(d10)
    G = eA * (es - e01 - e10)
    return G, (G, eA * (es - e01), eA * (es - e10), eA * (es + 1.0))


def kzz_bwd_plain(Vl, Dl, Vr, Dr, ct, *, num_levels: int, base: str,
                  increments: bool):
    """Plain torch version of K2: the VJP of ``kzz_fwd_plain`` under the
    cotangent ``ct`` (num_levels+1, nZ, nZ) -> (g_vl, g_dl, g_vr, g_dr),
    each (lt, nZ, d2)."""
    G, P = _zz_partials(Vl, Dl, Vr, Dr, base, increments)
    mbar = [None] * G.shape[0]
    for m, slots in _level_slots(num_levels):
        excl = _excl_products([G[k] for k in slots])
        for k, ex in zip(slots, excl):
            mbar[k] = ct[m] if ex is None else ct[m] * ex
    Mbar = torch.stack(mbar)
    W_A, W_01, W_10, W_xx = (None if p is None else Mbar * p for p in P)

    def rows(w, B):  # sum over columns j: w[k, i, j] B[k, j, :]
        return torch.matmul(w, B)

    def cols(w, A):  # sum over rows i: w[k, i, j] A[k, i, :]
        return torch.matmul(w.transpose(1, 2), A)

    return (_contract([(rows, W_A, Vr), (rows, W_01, Dr)], Vl),
            _contract([(rows, W_10, Vr), (rows, W_xx, Dr)], Dl),
            _contract([(cols, W_A, Vl), (cols, W_10, Dl)], Vr),
            _contract([(cols, W_01, Vl), (cols, W_xx, Dl)], Dr))


def kzz_bwd(Vl, Dl, Vr, Dr, ct, *, num_levels: int, base: str,
            increments: bool):
    """K2 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_tens_bwd`` (``gpsig_tpu/ops/inducing_pallas.py:256``).
    Bound on the H100: at nZ=500, lt=10, d2=16 about 0.5 G FMAs (the slot
    dots recomputed on both sides, the weight contractions) against ~6 MB
    of inputs and outputs, so FMA throughput bounds it (~0.015 ms at 67
    TFLOP/s).
    Design: one launch of two sides (grid z); a block owns a 16-row strip
    of one side and walks a share of the other side's 16-row tiles, level
    by level: each thread computes one pair's slot Grams, exclusive
    products and weights into shared memory, then the block contracts the
    weights with the other side's rows into per-row accumulators.  The
    shares are per-block partial slabs summed here with ``torch.sum``, as
    XLA summed the TPU kernel's slabs; no atomics, so the result is
    deterministic (``csrc/kzz_bwd.cu``)."""
    lt, nz, d2 = Vl.shape
    _check_config(num_levels, base, lt)
    for t in (Dl, Vr, Dr):
        if t.shape != Vl.shape:
            raise ValueError(f"kzz_bwd: shape {tuple(t.shape)} != "
                             f"{tuple(Vl.shape)}")
    if ct.shape != (num_levels + 1, nz, nz):
        raise ValueError(f"kzz_bwd: cotangent shape {tuple(ct.shape)}")
    if Vl.device.type == "cpu":
        return kzz_bwd_plain(Vl, Dl, Vr, Dr, ct, num_levels=num_levels,
                             base=base, increments=increments)
    _check_cuda("kzz_bwd", Vl, Dl, Vr, Dr, ct)
    if num_levels > MAX_LEVELS:
        raise ValueError(f"kzz_bwd is built for up to {MAX_LEVELS} levels")
    Vl, Dl, Vr, Dr, ct = (t.contiguous() for t in (Vl, Dl, Vr, Dr, ct))
    tiles = -(-nz // _K2_TILE)
    per = -(-tiles // min(tiles, -(-_TARGET_BLOCKS // (2 * tiles))))
    splits = -(-tiles // per)
    out = torch.empty((2, splits, 2, lt, nz, d2), dtype=torch.float32,
                      device=Vl.device)
    _launch("gpsig_kzz_bwd", Vl.data_ptr(), Dl.data_ptr(), Vr.data_ptr(),
            Dr.data_ptr(), ct.data_ptr(), out.data_ptr(), lt, nz, d2,
            num_levels, _BASE_IDS[base], int(increments), splits, per,
            _stream(Vl))
    kzz_bwd.launches += 1
    g = torch.sum(out, dim=1)
    return g[0, 0], g[0, 1], g[1, 0], g[1, 1]


kzz_bwd.launches = 0


# ---------------------------------------------------------------------------
# K3: Kzx
# ---------------------------------------------------------------------------


def kzx_fwd_plain(Vl, Dl, Xv, Xd, *, num_levels: int, base: str,
                  increments: bool, difference: bool):
    """Plain torch version of K3: tensor rows (lt, nZ, d2) against sequence
    rows (N, L, d2) -> ``(num_levels+1, nZ, N)``.  f32 uses
    ``gram.exp_accurate`` and the Taylor ``expm1``; f64 the native ones."""
    T = Xv.shape[1] - 1 if difference else Xv.shape[1]
    Xv, Xd = Xv[:, :T], Xd[:, :T]

    def dots(A, B):
        return torch.einsum("kzc,ntc->kznt", A, B)

    exp, expm1 = gram.exp_accurate, gram._expm1_stable
    if base == "linear":
        G = dots(Dl if increments else Vl, Xd if difference else Xv)
    elif increments:
        eA0, dZA = exp(dots(Vl, Xv)), dots(Dl, Xv)
        if difference:
            dA0 = dots(Vl, Xd)
            G = eA0 * (exp(dZA) * expm1(dA0 + dots(Dl, Xd)) - expm1(dA0))
        else:
            G = eA0 * expm1(dZA)
    elif difference:
        G = exp(dots(Vl, Xv)) * expm1(dots(Vl, Xd))
    else:
        G = exp(dots(Vl, Xv))
    return signature_kern_tens_vs_seq_first_order(G, num_levels,
                                                  difference=False)


def kzx_fwd(Vl, Dl, Xv, Xd, *, num_levels: int, base: str, increments: bool,
            difference: bool):
    """K3 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_zx_fwd`` (``gpsig_tpu/ops/inducing_pallas.py:697``).
    Bound on the H100: exp/FMA issue -- per (z, n, t) about lt slots x 4
    dots of d2 plus 3 transcendentals -- and the few (z, n) pairs to run in
    parallel.  Design: the time recursion is one register-carried sweep;
    a block's warps compute a time chunk's slot Grams in parallel into
    shared memory before one warp sweeps it (``csrc/kzx_fwd.cu``)."""
    lt, nz, d2 = Vl.shape
    n_ex, L, _ = Xv.shape
    _check_config(num_levels, base, lt)
    if Dl.shape != Vl.shape or Xd.shape != Xv.shape or Xv.shape[-1] != d2:
        raise ValueError("kzx_fwd: inconsistent input shapes")
    if Vl.device.type == "cpu":
        return kzx_fwd_plain(Vl, Dl, Xv, Xd, num_levels=num_levels,
                             base=base, increments=increments,
                             difference=difference)
    _check_cuda("kzx_fwd", Vl, Dl, Xv, Xd)
    if num_levels > MAX_LEVELS:
        raise ValueError(f"kzx_fwd is built for up to {MAX_LEVELS} levels")
    if n_ex > 65535:
        raise ValueError("kzx_fwd takes at most 65535 examples per call")
    # the kernel reads the inducing rows as (lt, d2, nZ): coalesced per warp
    VlT = Vl.transpose(1, 2).contiguous()
    DlT = Dl.transpose(1, 2).contiguous()
    Xv, Xd = Xv.contiguous(), Xd.contiguous()
    out = torch.empty((num_levels + 1, nz, n_ex), dtype=torch.float32,
                      device=Vl.device)
    _launch("gpsig_kzx_fwd", VlT.data_ptr(), DlT.data_ptr(), Xv.data_ptr(),
            Xd.data_ptr(), out.data_ptr(), lt, nz, n_ex, L, d2, num_levels,
            _BASE_IDS[base], int(increments), int(difference), _stream(Vl))
    kzx_fwd.launches += 1
    return out


kzx_fwd.launches = 0


# ---------------------------------------------------------------------------
# K4: Kzx backward
# ---------------------------------------------------------------------------


def _zx_partials(Vl, Dl, Xv, Xd, base: str, increments: bool,
                 difference: bool):
    """Slot Grams G (lt, nZ, N, T) and their partials dG/d(A0, dZA, dA0,
    ddA), None where zero: ``common.cuh::slot_gram_zx_partials`` in torch
    ops (``_slot_gram_zx_bwd``, ``inducing_pallas.py:604``, before the slot
    cotangent).  A0 = <v, x>, dZA = <dv, x>, dA0 = <v, dx>, ddA = <dv, dx>."""
    def dots(A, B):
        return torch.einsum("kzc,ntc->kznt", A, B)

    exp, expm1 = gram.exp_accurate, gram._expm1_stable
    if base == "linear":
        P = [None] * 4
        P[int(increments) + 2 * int(difference)] = 1.0
        return dots(Dl if increments else Vl,
                    Xd if difference else Xv), tuple(P)
    eA0 = exp(dots(Vl, Xv))
    if increments:
        dZA = dots(Dl, Xv)
        if difference:
            dA0 = dots(Vl, Xd)
            edZ = exp(dZA)
            em1s, em1d = expm1(dA0 + dots(Dl, Xd)), expm1(dA0)
            G = eA0 * (edZ * em1s - em1d)
            return G, (G, eA0 * edZ * em1s,
                       eA0 * (edZ * (em1s + 1.0) - (em1d + 1.0)),
                       eA0 * edZ * (em1s + 1.0))
        em1z = expm1(dZA)
        G = eA0 * em1z
        return G, (G, eA0 * (em1z + 1.0), None, None)
    if difference:
        em1d = expm1(dots(Vl, Xd))
        G = eA0 * em1d
        return G, (G, None, eA0 * (em1d + 1.0), None)
    return eA0, (eA0, None, None, None)


def _rev_cumsum_exclusive(x, dim: int):
    """sum over t' > t along ``dim``: the adjoint of ``cumsum_exclusive``."""
    return torch.flip(cumsum_exclusive(torch.flip(x, (dim,)), dim), (dim,))


def kzx_bwd_plain(Vl, Dl, Xv, Xd, ct, *, num_levels: int, base: str,
                  increments: bool, difference: bool):
    """Plain torch version of K4: the VJP of ``kzx_fwd_plain`` under the
    cotangent ``ct`` (num_levels+1, nZ, N) -> (g_vl, g_dl) (lt, nZ, d2) and
    (g_xv, g_xd) (N, L, d2).  The chain's adjoint runs backward in time:
    Gbar_j = Rbar_j S_{j-1} and Rbar_{j-1}(t) = sum_{t' > t} Rbar_j G_j."""
    L = Xv.shape[1]
    T = L - 1 if difference else L
    Xv_t, Xd_t = Xv[:, :T], Xd[:, :T]
    G, P = _zx_partials(Vl, Dl, Xv_t, Xd_t, base, increments, difference)
    gbar = [None] * G.shape[0]
    for m, slots in _level_slots(num_levels):
        chain = []
        for k in slots:
            chain.append(G[k] if not chain
                         else G[k] * cumsum_exclusive(chain[-1], dim=2))
        Rbar = ct[m][:, :, None].expand_as(G[slots[0]])
        for a in range(m - 1, -1, -1):
            k = slots[a]
            if a == 0:
                gbar[k] = Rbar
            else:
                gbar[k] = Rbar * cumsum_exclusive(chain[a - 1], dim=2)
                Rbar = _rev_cumsum_exclusive(G[k] * Rbar, dim=2)
    Gbar = torch.stack(gbar)
    W_A0, W_dZ, W_dA, W_dd = (None if p is None else Gbar * p for p in P)

    def z_side(w, X):
        return torch.einsum("kznt,ntc->kzc", w, X)

    def x_side(w, Z):
        return torch.einsum("kznt,kzc->ntc", w, Z)

    def pad(g):  # steps past the sweep get no gradient
        return torch.cat([g, torch.zeros_like(Xv[:, T:])], dim=1)

    return (_contract([(z_side, W_A0, Xv_t), (z_side, W_dA, Xd_t)], Vl),
            _contract([(z_side, W_dZ, Xv_t), (z_side, W_dd, Xd_t)], Dl),
            pad(_contract([(x_side, W_A0, Vl), (x_side, W_dZ, Dl)], Xv_t)),
            pad(_contract([(x_side, W_dA, Vl), (x_side, W_dd, Dl)], Xd_t)))


def kzx_bwd(Vl, Dl, Xv, Xd, ct, *, num_levels: int, base: str,
            increments: bool, difference: bool):
    """K4 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_zx_bwd`` (``gpsig_tpu/ops/inducing_pallas.py:740``).
    Bound on the H100: per (z, n, t) the lt slot Grams of the forward twice
    (once for the checkpoints, once for the reverse sweep) and four weight
    contractions of d2 -- about 4.6 G FMAs at nZ=500, N=50, L=93, so FMA
    and transcendental throughput bound it (~0.14 ms at 67 TFLOP/s).  Design:
    K3's grid, a block per example and 32 inducing lanes; a forward pass
    checkpoints the running sums S at chunk boundaries (a global scratch),
    then the chunks run in reverse, each re-swept from its checkpoint so
    S_{j-1}(t) is exact (never recovered by subtraction), and one warp
    carries the adjoint sums backward in time.  Chunks are sized so three
    blocks fit on an SM.  The z-side gradient reduces over the chunks into
    a per-example slab, the x-side over the lanes by warp shuffles into a
    per-lane-block slab; both slabs are summed here with ``torch.sum``
    (deterministic, no atomics; ``csrc/kzx_bwd.cu``)."""
    lt, nz, d2 = Vl.shape
    n_ex, L, _ = Xv.shape
    _check_config(num_levels, base, lt)
    if Dl.shape != Vl.shape or Xd.shape != Xv.shape or Xv.shape[-1] != d2:
        raise ValueError("kzx_bwd: inconsistent input shapes")
    if ct.shape != (num_levels + 1, nz, n_ex):
        raise ValueError(f"kzx_bwd: cotangent shape {tuple(ct.shape)}")
    if Vl.device.type == "cpu":
        return kzx_bwd_plain(Vl, Dl, Xv, Xd, ct, num_levels=num_levels,
                             base=base, increments=increments,
                             difference=difference)
    _check_cuda("kzx_bwd", Vl, Dl, Xv, Xd, ct)
    if num_levels > MAX_LEVELS:
        raise ValueError(f"kzx_bwd is built for up to {MAX_LEVELS} levels")
    if n_ex > 65535:
        raise ValueError("kzx_bwd takes at most 65535 examples per call")
    VlT = Vl.transpose(1, 2).contiguous()
    DlT = Dl.transpose(1, 2).contiguous()
    Xv, Xd, ct = Xv.contiguous(), Xd.contiguous(), ct.contiguous()
    # csrc/kzx_bwd.cu::kzx_bwd_smem_floats for a chunk of t_chunk steps
    step_bytes = 4 * (2 * d2 + 6 * lt * _K4_LANES)
    t_chunk = max(1, min(_K4_MAX_CHUNK, _K4_SMEM // step_bytes))
    T = L - 1 if difference else L
    n_zb = -(-nz // _K4_LANES)
    gz = torch.empty((n_ex, 2, lt, d2, nz), dtype=torch.float32,
                     device=Vl.device)
    gx = torch.empty((n_zb, n_ex, 2, L, d2), dtype=torch.float32,
                     device=Vl.device)
    ck = torch.empty((n_ex, n_zb, -(-T // t_chunk), lt, _K4_LANES),
                     dtype=torch.float32, device=Vl.device)
    _launch("gpsig_kzx_bwd", VlT.data_ptr(), DlT.data_ptr(), Xv.data_ptr(),
            Xd.data_ptr(), ct.data_ptr(), gz.data_ptr(), gx.data_ptr(),
            ck.data_ptr(), lt, nz, n_ex, L, d2, num_levels, _BASE_IDS[base],
            int(increments), int(difference), t_chunk, _stream(Vl))
    kzx_bwd.launches += 1
    gz = torch.sum(gz, dim=0).transpose(-1, -2)
    gx = torch.sum(gx, dim=0)
    return gz[0], gz[1], gx[:, 0], gx[:, 1]


kzx_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd: forward kernel, backward kernel
# ---------------------------------------------------------------------------


class _KzzFn(torch.autograd.Function):
    """Kzz level stack over the augmented rows: forward K1, backward K2."""

    @staticmethod
    def forward(ctx, Vl, Dl, Vr, Dr, num_levels, base, increments):
        ctx.save_for_backward(Vl, Dl, Vr, Dr)
        ctx.opts = dict(num_levels=num_levels, base=base,
                        increments=increments)
        return kzz_fwd(Vl, Dl, Vr, Dr, **ctx.opts)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        grads = kzz_bwd(*ctx.saved_tensors, ct.contiguous(), **ctx.opts)
        return (*grads, None, None, None)


class _KzxFn(torch.autograd.Function):
    """Kzx level stack over the augmented rows: forward K3, backward K4."""

    @staticmethod
    def forward(ctx, Vl, Dl, Xv, Xd, num_levels, base, increments,
                difference):
        ctx.save_for_backward(Vl, Dl, Xv, Xd)
        ctx.opts = dict(num_levels=num_levels, base=base,
                        increments=increments, difference=difference)
        return kzx_fwd(Vl, Dl, Xv, Xd, **ctx.opts)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        grads = kzx_bwd(*ctx.saved_tensors, ct.contiguous(), **ctx.opts)
        return (*grads, None, None, None, None)


# ---------------------------------------------------------------------------
# public entry points (signatures of the JAX package's fused wrappers)
# ---------------------------------------------------------------------------


def fused_tensor_levels(Z, *, num_levels: int, base: str = "rbf",
                        increments: bool = True):
    """(num_levels+1, nZ, nZ) inducing-tensor level Grams.

    Z: (lt, nZ, 2, d) with increments, else (lt, nZ, d).  Differentiable:
    K1 forward, K2 backward."""
    Vl, Dl = _prep_tensors(Z, base, increments, lhs=True)
    Vr, Dr = _prep_tensors(Z, base, increments, lhs=False)
    return _KzzFn.apply(Vl, Dl, Vr, Dr, num_levels, base, increments)


def fused_tens_vs_seq_levels(Z, X, *, num_levels: int, base: str = "rbf",
                             increments: bool = True,
                             difference: bool = True, fast_math="high"):
    """(num_levels+1, nZ, N) tensor-vs-sequence level kernels, order 1.

    Z: (lt, nZ, 2, d) with increments else (lt, nZ, d); X: (N, L, d).
    ``fast_math`` is accepted for the JAX signature; every value means full
    f32 on the card.  Differentiable: K3 forward, K4 backward."""
    del fast_math
    Vl, Dl = _prep_tensors(Z, base, increments, lhs=True)
    Xv, Xd = _prep_seq(X, base)
    return _KzxFn.apply(Vl, Dl, Xv, Xd, num_levels, base, increments,
                        difference)
