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
failed build or launch.  Any number of levels: past
``_cuda_build.MAIN_LEVELS`` the wrappers load a library built for that level
count at its first use.

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
padding to 128) has no counterpart.

Symmetric mode (``symmetric=True`` of ``kzz_fwd`` / ``kzz_bwd``, which
``fused_tensor_levels`` asks for: it builds both sides from one Z): each
unordered pair of inducing tensors is computed once and mirrored, as the
TPU kernel computes its upper blocks once and mirrors them
(``inducing_pallas.py:483-487``), so Kzz is exactly symmetric; the
backward takes the cotangent folded onto the upper triangle (``_fold``,
``inducing_pallas.py:497-501``).  ``signature_cuda`` shares ``_mirror`` and
``_fold``.

matern12 (exp(-r)) launches each kernel's matern12 instance with the
step norms of the difference rows (``_step_norms``): the closed form
floors its denominators by them, and the backward kernels chain their
cotangents into the difference rows themselves (``_norm_chain`` is the
plain versions' counterpart).

Each wrapper's docstring says what bounds its kernel on the H100 and what
the design does about it; the header of its ``.cu`` file has the detail.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import gram
from .signature import (cumsum_exclusive,
                        signature_kern_tens_vs_seq_first_order, tensor_kern)

SUPPORTED_BASES = ("rbf", "linear", "matern12")
_BASE_IDS = {"rbf": 0, "linear": 1, "matern12": 2}  # csrc/common.cuh::Base
_ZZ_TILE = 32  # csrc/common.cuh::kZzTile: K1's and K2's tile edge
_ZZ_CB = 16  # csrc/common.cuh::kZzCB: channels a staged row block holds
# K2 gives each strip of tile rows at most _K2_RANGES partial slabs
_K2_RANGES = 32
_K4_LANES = 32  # csrc/kzx_bwd.cu::kZ
_K4_MAX_CHUNK = 8  # time steps a K4 block stages at once: csrc/kzx_bwd.cu::kTG
_K4_SMEM = 64 * 1024  # K4's shared memory for a chunk of steps
# K4 stages a block's inducing rows in shared memory, padded to 16 channels
# (csrc/kzx_bwd.cu::kRegD2), where d2 <= 16 and they take at most 48 KB (two
# blocks on an SM with the chunk's 64 KB)
_K4_ROW_CHANNELS = 16
_K4_ROWS_SMEM = 48 * 1024


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


def _step_norms(D, base: str):
    """Euclidean norms of the true channels of augmented difference rows
    (..., d2) -> (...), for matern12 (None for the other bases): the two
    norm-augmentation channels are left out, as ``_aug_mask`` leaves them
    (``signature_pallas.py:210``).  matern12 floors its denominators by
    them and, with a zero step, ``seq_bwd`` masks the cotangent."""
    if base != "matern12":
        return None
    return torch.linalg.vector_norm(D[..., :-2], dim=-1)


def _norm_chain(g_D, D, W_n, n):
    """``g_D[..., :d] += D[..., :d] W_n / max(n, 1e-30)``: a step-norm
    cotangent W_n (...) into the gradient of its difference rows (...,
    d2), as ``_norm_chain_col`` / ``_norm_chain_row`` do
    (``signature_pallas.py:218-238``); the augmentation channels get
    none."""
    chain = D[..., :-2] * (W_n / torch.clamp(n, min=1e-30))[..., None]
    return torch.cat([g_D[..., :-2] + chain, g_D[..., -2:]], dim=-1)


def _ptr(t) -> int:
    """A tensor's device pointer, 0 for None (a kernel argument that the
    base does not read)."""
    return 0 if t is None else t.data_ptr()


def _check_config(num_levels: int, base: str, lt: int):
    if base not in SUPPORTED_BASES:
        raise ValueError(
            f"base {base!r} has no inducing kernel; supported: "
            f"{SUPPORTED_BASES}"
        )
    if lt != num_levels * (num_levels + 1) // 2:
        raise ValueError(f"{lt} packed slots do not make {num_levels} levels")


def _check_cuda(name: str, *tensors):
    dev = tensors[0].get_device()  # -1 off the card; an int is quick to get
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name}: inputs must share one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name} runs in float32 on the card, got {t.dtype}; "
                "float64 runs on the CPU (the plain version)"
            )


def _launch(fn_name: str, num_levels: int, *args, order: int = 1):
    """Call ``fn_name`` of the library that holds ``num_levels`` (and, for
    K5 and K6, ``order``)."""
    from . import _cuda_build

    rc = getattr(_cuda_build.load(num_levels, order).lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed to launch: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    """The current stream of t's card as a raw handle.  The wrappers' host
    work sets a call's time at small shapes, and this lookup is far
    cheaper than building ``torch.cuda.current_stream(...)`` (PERF.md
    §6)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _mirror(K):
    """(..., N, N) -> exactly symmetric, from the upper triangle."""
    return torch.triu(K) + torch.triu(K, 1).transpose(-1, -2)


def _fold(ct):
    """The cotangent of ``_mirror``: ct + ct^T above the diagonal, ct on
    it, 0 below."""
    return (torch.triu(ct + ct.transpose(-1, -2), 1)
            + torch.diag_embed(torch.diagonal(ct, dim1=-2, dim2=-1)))


def _check_zz(name: str, Vl, Dl, Vr, Dr):
    """Kzz rows: four arrays of one shape (lt, nZ, d2), so one set of
    inducing tensors; symmetric mode needs nothing more."""
    for t in (Dl, Vr, Dr):
        if t.shape != Vl.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(Vl.shape)}")


# ---------------------------------------------------------------------------
# K1: Kzz
# ---------------------------------------------------------------------------


def kzz_fwd_plain(Vl, Dl, Vr, Dr, *, num_levels: int, base: str,
                  increments: bool, symmetric: bool = False):
    """Plain torch version of K1 on the augmented rows (lt, nZ, d2):
    ``(num_levels+1, nZ, nZ)``, mirrored from its upper triangle when
    ``symmetric``.  f32 uses ``gram.exp_accurate`` and the Taylor
    ``expm1``; f64 the native exp/expm1."""
    G = _zz_gram(Vl, Dl, Vr, Dr, base, increments,
                 _zz_norms(Dl, Dr, base, increments))
    out = tensor_kern(G, num_levels)
    return _mirror(out) if symmetric else out


def kzz_fwd(Vl, Dl, Vr, Dr, *, num_levels: int, base: str,
            increments: bool, symmetric: bool = False):
    """K1 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_tens_fwd`` (``gpsig_tpu/ops/inducing_pallas.py:223``).
    ``symmetric``: the rows are one set of inducing tensors (lhs- and
    rhs-augmented), each unordered pair is computed once and written to
    (i, j) and (j, i), so the output is exactly symmetric.
    Bound on the H100: at nZ=500 about 0.16 G FMAs of dots for the upper
    pairs and 4 transcendentals a slot Gram, against a 5 MB output: issue
    of the dots and transcendentals, a few microseconds, so one launch
    with every SM busy.  Design: a block per (32 x 32 tile pair, level),
    the upper tile pairs only when symmetric (136 x 4 = 544 blocks at
    nZ=500, M=4, the highest level first); 256 threads of 2 x 2 pairs
    each, a slot's rows of both tiles staged once per 16 channels and
    double-buffered (one barrier a slot at d2 <= 16), dots from float4s
    (8 loads for 64 FMAs); the mirror tile is written through a
    shared-memory transpose, so both stores are coalesced
    (``csrc/kzz_fwd.cu``)."""
    lt, nz, d2 = Vl.shape
    _check_config(num_levels, base, lt)
    _check_zz("kzz_fwd", Vl, Dl, Vr, Dr)
    if Vl.is_cpu:
        return kzz_fwd_plain(Vl, Dl, Vr, Dr, num_levels=num_levels,
                             base=base, increments=increments,
                             symmetric=symmetric)
    _check_cuda("kzz_fwd", Vl, Dl, Vr, Dr)
    Vl, Dl, Vr, Dr = (t.contiguous() for t in (Vl, Dl, Vr, Dr))
    nl, nr = _step_norms(Dl, base), _step_norms(Dr, base)
    out = torch.empty((num_levels + 1, nz, nz), dtype=torch.float32,
                      device=Vl.device)
    _launch("gpsig_kzz_fwd", num_levels, Vl.data_ptr(), Dl.data_ptr(),
            Vr.data_ptr(), Dr.data_ptr(), _ptr(nl), _ptr(nr), out.data_ptr(),
            lt, nz, d2, num_levels, _BASE_IDS[base], int(increments),
            int(symmetric), _stream(Vl))
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


def _zz_norms(Dl, Dr, base: str, increments: bool):
    """matern12's step norms of Kzz's lhs and rhs rows, broadcast to the
    slot Grams' (lt, nZ, nZ); None for the other bases and without
    increments."""
    if base != "matern12" or not increments:
        return None
    return _step_norms(Dl, base)[:, :, None], _step_norms(Dr, base)[:, None]


def _zz_gram(Vl, Dl, Vr, Dr, base: str, increments: bool, norms=None,
             dots=_slot_dots):
    """Slot Grams G (lt, nZ, nZ): ``common.cuh::slot_gram_zz`` (matern12:
    ``mat12_cross``) in torch ops (``_slot_gram_zz``,
    ``inducing_pallas.py:153``).
    ``dots`` contracts the feature axis; the seq x seq plain versions pass
    their own, for (N1, N2, L1, L2) increment Grams.  ``norms``: matern12's
    step norms of the lhs and rhs rows, broadcast to G's shape."""
    if base == "linear":
        return dots(Dl, Dr) if increments else dots(Vl, Vr)
    a00 = dots(Vl, Vr)
    if base == "matern12":
        if not increments:
            return gram.mat12_plain_from_dots(a00)
        return gram.mat12_cross_from_dots(a00, dots(Vl, Dr), dots(Dl, Vr),
                                          dots(Dl, Dr), *norms)
    if not increments:
        return gram.exp_accurate(a00)
    d01, d10 = dots(Vl, Dr), dots(Dl, Vr)
    expm1 = gram._expm1_stable
    return gram.exp_accurate(a00) * (
        expm1(d01 + d10 + dots(Dl, Dr)) - expm1(d01) - expm1(d10))


def _zz_partials(Vl, Dl, Vr, Dr, base: str, increments: bool, norms=None,
                 dots=_slot_dots):
    """Slot Grams G (lt, nZ, nZ) and their partials dG/d(A00, d01, d10,
    dxx, nx, ny), None where zero -- nx, ny the step norms of the lhs and
    rhs rows (matern12's floors): ``common.cuh::slot_gram_zz_partials``
    (matern12: ``mat12_cross_partials``) in torch ops (``_slot_gram_zz_bwd``,
    ``inducing_pallas.py:175``, before the slot cotangent); ``dots`` and
    ``norms`` as ``_zz_gram``'s."""

    exp, expm1 = gram.exp_accurate, gram._expm1_stable
    if base == "linear":
        if increments:
            return dots(Dl, Dr), (None, None, None, 1.0, None, None)
        return dots(Vl, Vr), (1.0, None, None, None, None, None)
    if base == "matern12":
        if not increments:
            G, (pa,) = gram.mat12_plain_partials(dots(Vl, Vr))
            return G, (pa, None, None, None, None, None)
        return gram.mat12_cross_partials(dots(Vl, Vr), dots(Vl, Dr),
                                         dots(Dl, Vr), dots(Dl, Dr), *norms)
    eA = exp(dots(Vl, Vr))
    if not increments:
        return eA, (eA, None, None, None, None, None)
    d01, d10 = dots(Vl, Dr), dots(Dl, Vr)
    es, e01, e10 = expm1(d01 + d10 + dots(Dl, Dr)), expm1(d01), expm1(d10)
    G = eA * (es - e01 - e10)
    return G, (G, eA * (es - e01), eA * (es - e10), eA * (es + 1.0), None,
               None)


def kzz_bwd_plain(Vl, Dl, Vr, Dr, ct, *, num_levels: int, base: str,
                  increments: bool, symmetric: bool = False):
    """Plain torch version of K2: the VJP of ``kzz_fwd_plain`` (with the
    same ``symmetric``) under the cotangent ``ct`` (num_levels+1, nZ, nZ)
    -> (g_vl, g_dl, g_vr, g_dr), each (lt, nZ, d2).  matern12's step-norm
    cotangents chain into g_dl and g_dr (``_norm_chain``)."""
    if symmetric:
        ct = _fold(ct)
    norms = _zz_norms(Dl, Dr, base, increments)
    G, P = _zz_partials(Vl, Dl, Vr, Dr, base, increments, norms)
    mbar = [None] * G.shape[0]
    for m, slots in _level_slots(num_levels):
        excl = _excl_products([G[k] for k in slots])
        for k, ex in zip(slots, excl):
            mbar[k] = ct[m] if ex is None else ct[m] * ex
    Mbar = torch.stack(mbar)
    W_A, W_01, W_10, W_xx, W_nx, W_ny = (None if p is None else Mbar * p
                                         for p in P)

    def rows(w, B):  # sum over columns j: w[k, i, j] B[k, j, :]
        return torch.matmul(w, B)

    def cols(w, A):  # sum over rows i: w[k, i, j] A[k, i, :]
        return torch.matmul(w.transpose(1, 2), A)

    g_dl = _contract([(rows, W_10, Vr), (rows, W_xx, Dr)], Dl)
    g_dr = _contract([(cols, W_01, Vl), (cols, W_xx, Dl)], Dr)
    if norms is not None:
        g_dl = _norm_chain(g_dl, Dl, torch.sum(W_nx, dim=2), norms[0][..., 0])
        g_dr = _norm_chain(g_dr, Dr, torch.sum(W_ny, dim=1), norms[1][:, 0])
    return (_contract([(rows, W_A, Vr), (rows, W_01, Dr)], Vl), g_dl,
            _contract([(cols, W_A, Vl), (cols, W_10, Dl)], Vr), g_dr)


def _k2_plan(nz: int):
    """K2's launch plan: the strips of 32 rows go in ``ranges`` ranges of
    ``per`` strips; a block takes one range pair (the upper ones when
    symmetric) at one level.  Returns (ranges, per)."""
    strips = -(-nz // _ZZ_TILE)
    per = -(-strips // min(strips, _K2_RANGES))
    return -(-strips // per), per


def kzz_bwd(Vl, Dl, Vr, Dr, ct, *, num_levels: int, base: str,
            increments: bool, symmetric: bool = False):
    """K2 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_tens_bwd`` (``gpsig_tpu/ops/inducing_pallas.py:256``).
    ``symmetric``: the VJP of ``kzz_fwd(symmetric=True)``; the cotangent
    is folded onto the upper triangle (``_fold``; the kernel folds as it
    reads) and only the upper tile pairs are evaluated.
    Bound on the H100: at nZ=500, lt=10, d2=16, symmetric, each unordered
    pair's slot Grams once (4 dots of d2 and 4 transcendentals) and four
    d2-wide weight contractions on each side, about 0.2 G FMAs against ~6
    MB of inputs and outputs: FMA and transcendental issue (~0.007 ms at
    67 TFLOP/s).
    Design: a block per (range pair, level), the highest level first; at
    nZ <= 1,024 a range is one strip of 32 rows, so 136 upper tile pairs x
    4 levels = 544 blocks at nZ=500, M=4 (1,024 when not symmetric), on
    132 SMs.  For each tile pair a block of 256 threads, 2 x 2 pairs each,
    computes the level's slot Grams once (rows staged 16 channels at a
    time, dots from float4s), the exclusive products and the four weights,
    then per slot contracts the weights (in shared memory) with the rows
    of both tiles: the lhs gradients of strip I and the rhs gradients of
    strip J from the one evaluation, 2 x 4 outputs a thread, 6 shared
    loads for 16 FMAs.  Shared memory does not grow with the width or the
    level count.  Each block writes its lhs gradients into the partial
    slab of its J range and its rhs gradients into that of its I range
    (and, when symmetric, zeros where the mirrored range pair would
    write), so every slab entry is written once; the ``ranges`` slabs are
    summed here with ``torch.sum``: no atomics, deterministic
    (``csrc/kzz_bwd.cu``)."""
    lt, nz, d2 = Vl.shape
    _check_config(num_levels, base, lt)
    _check_zz("kzz_bwd", Vl, Dl, Vr, Dr)
    if ct.shape != (num_levels + 1, nz, nz):
        raise ValueError(f"kzz_bwd: cotangent shape {tuple(ct.shape)}")
    if Vl.is_cpu:
        return kzz_bwd_plain(Vl, Dl, Vr, Dr, ct, num_levels=num_levels,
                             base=base, increments=increments,
                             symmetric=symmetric)
    _check_cuda("kzz_bwd", Vl, Dl, Vr, Dr, ct)
    Vl, Dl, Vr, Dr, ct = (t.contiguous() for t in (Vl, Dl, Vr, Dr, ct))
    nl, nr = _step_norms(Dl, base), _step_norms(Dr, base)
    ranges, per = _k2_plan(nz)
    d2p = -(-d2 // _ZZ_CB) * _ZZ_CB  # slab rows padded to channel blocks
    # (ranges, [g_vl, g_dl, g_vr, g_dr], lt, nZ, d2p)
    out = torch.empty((ranges, 4, lt, nz, d2p), dtype=torch.float32,
                      device=Vl.device)
    _launch("gpsig_kzz_bwd", num_levels, Vl.data_ptr(), Dl.data_ptr(),
            Vr.data_ptr(), Dr.data_ptr(), _ptr(nl), _ptr(nr), ct.data_ptr(),
            out.data_ptr(), lt, nz, d2, num_levels, _BASE_IDS[base],
            int(increments), int(symmetric), ranges, per, _stream(Vl))
    kzz_bwd.launches += 1
    g = torch.sum(out, dim=0)
    return (g if d2p == d2 else g[..., :d2]).unbind(0)


kzz_bwd.launches = 0


# ---------------------------------------------------------------------------
# K3: Kzx
# ---------------------------------------------------------------------------


def _zx_norms(Dl, Xd, base: str, T: int):
    """matern12's step norms of the inducing tensors (lt, nZ) and of the
    first T time steps (N, T), broadcast to the slot Grams' (lt, nZ, N,
    T); None for the other bases."""
    if base != "matern12":
        return None
    return (_step_norms(Dl, base)[:, :, None, None],
            _step_norms(Xd[:, :T], base)[None, None])


def _zx_gram(Vl, Dl, Xv, Xd, base: str, increments: bool, difference: bool,
             norms, partials: bool):
    """Slot Grams G (lt, nZ, N, T) of tensor rows against the first T
    sequence rows, or with ``partials`` (G, dG/d(A0, dZA, dA0, ddA, nz,
    nt)), None where zero: ``common.cuh::slot_gram_zx(_partials)``
    (matern12: ``mat12_cross``, ``mat12_onesided``, ``mat12_plain``) in
    torch ops (``_slot_gram_zx`` / ``_slot_gram_zx_bwd``,
    ``inducing_pallas.py:554`` / ``:604``).  A0 = <v, x>, dZA = <dv, x>,
    dA0 = <v, dx>, ddA = <dv, dx>; nz, nt the step norms of the inducing
    tensors and the time steps (``_zx_norms``)."""
    def dots(A, B):
        return torch.einsum("kzc,ntc->kznt", A, B)

    exp, expm1 = gram.exp_accurate, gram._expm1_stable
    P = [None] * 6
    if base == "linear":
        P[int(increments) + 2 * int(difference)] = 1.0
        G = dots(Dl if increments else Vl, Xd if difference else Xv)
        return (G, tuple(P)) if partials else G
    A0 = dots(Vl, Xv)
    if base == "matern12":
        # the closed forms' (A00, d01, d10, dxx) are (A0, dA0, dZA, ddA):
        # the z step on the lhs (x) side, the time step on the rhs (y)
        nz, nt = norms
        if increments and difference:
            args = (A0, dots(Vl, Xd), dots(Dl, Xv), dots(Dl, Xd), nz, nt)
            if not partials:
                return gram.mat12_cross_from_dots(*args)
            G, (pa, p01, p10, pxx, pnx, pny) = gram.mat12_cross_partials(
                *args)
            return G, (pa, p10, p01, pxx, pnx, pny)
        if increments or difference:
            gap, n = (dots(Dl, Xv), nz) if increments else (dots(Vl, Xd), nt)
            if not partials:
                return gram.mat12_onesided_from_dots(A0, gap, n)
            G, (pa, pg, pn) = gram.mat12_onesided_partials(A0, gap, n)
            at = 1 if increments else 2
            P[0], P[at], P[at + 3] = pa, pg, pn
            return G, tuple(P)
        if not partials:
            return gram.mat12_plain_from_dots(A0)
        G, (P[0],) = gram.mat12_plain_partials(A0)
        return G, tuple(P)
    eA0 = exp(A0)
    if increments:
        dZA = dots(Dl, Xv)
        if difference:
            dA0 = dots(Vl, Xd)
            edZ = exp(dZA)
            em1s, em1d = expm1(dA0 + dots(Dl, Xd)), expm1(dA0)
            G = eA0 * (edZ * em1s - em1d)
            P[:4] = (G, eA0 * edZ * em1s,
                     eA0 * (edZ * (em1s + 1.0) - (em1d + 1.0)),
                     eA0 * edZ * (em1s + 1.0))
        else:
            em1z = expm1(dZA)
            G = eA0 * em1z
            P[:2] = G, eA0 * (em1z + 1.0)
    elif difference:
        em1d = expm1(dots(Vl, Xd))
        G = eA0 * em1d
        P[0], P[2] = G, eA0 * (em1d + 1.0)
    else:
        G = eA0
        P[0] = eA0
    return (G, tuple(P)) if partials else G


def kzx_fwd_plain(Vl, Dl, Xv, Xd, *, num_levels: int, base: str,
                  increments: bool, difference: bool):
    """Plain torch version of K3: tensor rows (lt, nZ, d2) against sequence
    rows (N, L, d2) -> ``(num_levels+1, nZ, N)``.  f32 uses
    ``gram.exp_accurate`` and the Taylor ``expm1``; f64 the native ones."""
    T = Xv.shape[1] - 1 if difference else Xv.shape[1]
    G = _zx_gram(Vl, Dl, Xv[:, :T], Xd[:, :T], base, increments, difference,
                 _zx_norms(Dl, Xd, base, T), partials=False)
    return signature_kern_tens_vs_seq_first_order(G, num_levels,
                                                  difference=False)


def kzx_fwd(Vl, Dl, Xv, Xd, *, num_levels: int, base: str, increments: bool,
            difference: bool):
    """K3 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_zx_fwd`` (``gpsig_tpu/ops/inducing_pallas.py:697``).
    Bound on the H100: instruction issue -- per (z, n, t) lt slot Grams of
    4 dots of d2 and up to 4 accurate transcendentals.  Design: a block of
    8 warps owns 32 inducing tensors (their rows staged in shared memory)
    and one example; each warp takes a range of a chunk's steps with
    register-tiled dots and sums every sub-chain of each level's slots over
    it, and the ranges are chained in time order by Chen's identity
    (``csrc/kzx_fwd.cu``).  Past 16 levels (the chained states outgrow
    shared memory) a serial path takes over: a warp a block walks the
    steps in order with each level's prefix chain sums, lt floats a lane."""
    lt, nz, d2 = Vl.shape
    n_ex, L, _ = Xv.shape
    _check_config(num_levels, base, lt)
    if Dl.shape != Vl.shape or Xd.shape != Xv.shape or Xv.shape[-1] != d2:
        raise ValueError("kzx_fwd: inconsistent input shapes")
    if Vl.is_cpu:
        return kzx_fwd_plain(Vl, Dl, Xv, Xd, num_levels=num_levels,
                             base=base, increments=increments,
                             difference=difference)
    _check_cuda("kzx_fwd", Vl, Dl, Xv, Xd)
    Vl, Dl, Xv, Xd = (t.contiguous() for t in (Vl, Dl, Xv, Xd))
    nz_, nt = _step_norms(Dl, base), _step_norms(Xd, base)
    out = torch.empty((num_levels + 1, nz, n_ex), dtype=torch.float32,
                      device=Vl.device)
    _launch("gpsig_kzx_fwd", num_levels, Vl.data_ptr(), Dl.data_ptr(),
            Xv.data_ptr(), Xd.data_ptr(), _ptr(nz_), _ptr(nt),
            out.data_ptr(), lt, nz, n_ex, L, d2, num_levels, _BASE_IDS[base],
            int(increments), int(difference), _stream(Vl))
    kzx_fwd.launches += 1
    return out


kzx_fwd.launches = 0


# ---------------------------------------------------------------------------
# K4: Kzx backward
# ---------------------------------------------------------------------------


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
    norms = _zx_norms(Dl, Xd, base, T)
    G, P = _zx_gram(Vl, Dl, Xv_t, Xd_t, base, increments, difference, norms,
                    partials=True)
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
    W_A0, W_dZ, W_dA, W_dd, W_nz, W_nt = (None if p is None else Gbar * p
                                          for p in P)

    def z_side(w, X):
        return torch.einsum("kznt,ntc->kzc", w, X)

    def x_side(w, Z):
        return torch.einsum("kznt,kzc->ntc", w, Z)

    def pad(g):  # steps past the sweep get no gradient
        return torch.cat([g, torch.zeros_like(Xv[:, T:])], dim=1)

    g_dl = _contract([(z_side, W_dZ, Xv_t), (z_side, W_dd, Xd_t)], Dl)
    g_xd = _contract([(x_side, W_dA, Vl), (x_side, W_dd, Dl)], Xd_t)
    if W_nz is not None:
        g_dl = _norm_chain(g_dl, Dl, torch.sum(W_nz, dim=(2, 3)),
                           norms[0][:, :, 0, 0])
    if W_nt is not None:
        g_xd = _norm_chain(g_xd, Xd_t, torch.sum(W_nt, dim=(0, 1)),
                           norms[1][0, 0])
    return (_contract([(z_side, W_A0, Xv_t), (z_side, W_dA, Xd_t)], Vl),
            g_dl,
            pad(_contract([(x_side, W_A0, Vl), (x_side, W_dZ, Dl)], Xv_t)),
            pad(g_xd))


def kzx_bwd(Vl, Dl, Xv, Xd, ct, *, num_levels: int, base: str,
            increments: bool, difference: bool):
    """K4 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_zx_bwd`` (``gpsig_tpu/ops/inducing_pallas.py:740``).
    Bound on the H100: per (z, n, t) the lt slot Grams of the forward and
    four weight contractions of d2 -- about 4.4 G FMAs of needed work at
    nZ=500, N=50, L=93, so FMA and transcendental issue bound it (~0.13 ms
    at 67 TFLOP/s).  Design: K3's grid, a block per example and 32
    inducing lanes (their rows staged in shared memory when they fit),
    whose 8 warps own the 8 steps of a time chunk; the forward sums S_j
    and the adjoint sums Rbar_{j-1} are block-wide scans over the chunk's
    steps, one round per slot of the chain.  A first pass
    checkpoints the forward carries at chunk starts (a global scratch), the
    second takes the chunks in reverse, re-scanning each from its
    checkpoint, so S_{j-1}(t) is exact (never recovered by subtraction).
    The x-side gradient is summed over the lanes by a shuffle
    reduce-scatter into a per-lane-block slab, the z side over the chunks
    into a per-example slab; both slabs are summed here with ``torch.sum``
    (deterministic, no atomics; ``csrc/kzx_bwd.cu``).  Past 65,535
    examples (the grid's y limit) the C launcher loops, one CUDA launch per
    slice of 65,535 examples; ``kzx_bwd.launches`` counts calls."""
    lt, nz, d2 = Vl.shape
    n_ex, L, _ = Xv.shape
    _check_config(num_levels, base, lt)
    if Dl.shape != Vl.shape or Xd.shape != Xv.shape or Xv.shape[-1] != d2:
        raise ValueError("kzx_bwd: inconsistent input shapes")
    if ct.shape != (num_levels + 1, nz, n_ex):
        raise ValueError(f"kzx_bwd: cotangent shape {tuple(ct.shape)}")
    if Vl.is_cpu:
        return kzx_bwd_plain(Vl, Dl, Xv, Xd, ct, num_levels=num_levels,
                             base=base, increments=increments,
                             difference=difference)
    _check_cuda("kzx_bwd", Vl, Dl, Xv, Xd, ct)
    VlT = Vl.transpose(1, 2).contiguous()
    DlT = Dl.transpose(1, 2).contiguous()
    Xv, Xd, ct = Xv.contiguous(), Xd.contiguous(), ct.contiguous()
    nz_, nt = _step_norms(Dl, base), _step_norms(Xd, base)
    # csrc/kzx_bwd.cu::kzx_bwd_smem_floats for a chunk of t_chunk steps: G,
    # the scan exchange and a slot Gram's partials (six with matern12)
    n_p = 6 if base == "matern12" else 4
    step_bytes = 4 * (2 * (-(-d2 // 4) * 4) + (2 + n_p) * lt * _K4_LANES)
    t_chunk = max(1, min(_K4_MAX_CHUNK, _K4_SMEM // step_bytes))
    # the block's inducing rows, padded to _K4_ROW_CHANNELS, in shared memory
    stage = d2 <= _K4_ROW_CHANNELS and (
        2 * lt * _K4_ROW_CHANNELS * _K4_LANES * 4 <= _K4_ROWS_SMEM)
    T = L - 1 if difference else L
    n_zb = -(-nz // _K4_LANES)
    gz = torch.empty((n_ex, 2, lt, d2, nz), dtype=torch.float32,
                     device=Vl.device)
    gx = torch.empty((n_zb, n_ex, 2, L, d2), dtype=torch.float32,
                     device=Vl.device)
    ck = torch.empty((n_ex, n_zb, -(-T // t_chunk), lt, _K4_LANES),
                     dtype=torch.float32, device=Vl.device)
    _launch("gpsig_kzx_bwd", num_levels, VlT.data_ptr(), DlT.data_ptr(),
            Xv.data_ptr(), Xd.data_ptr(), _ptr(nz_), _ptr(nt), ct.data_ptr(),
            gz.data_ptr(), gx.data_ptr(), ck.data_ptr(), lt, nz, n_ex, L, d2,
            num_levels, _BASE_IDS[base], int(increments), int(difference),
            t_chunk, int(stage), _stream(Vl))
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
    def forward(ctx, Vl, Dl, Vr, Dr, num_levels, base, increments,
                symmetric):
        ctx.save_for_backward(Vl, Dl, Vr, Dr)
        ctx.opts = dict(num_levels=num_levels, base=base,
                        increments=increments, symmetric=symmetric)
        return kzz_fwd(Vl, Dl, Vr, Dr, **ctx.opts)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        grads = kzz_bwd(*ctx.saved_tensors, ct.contiguous(), **ctx.opts)
        return (*grads, None, None, None, None)


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

    Z: (lt, nZ, 2, d) with increments, else (lt, nZ, d).  Both sides come
    from one Z, so K1 and K2 run in symmetric mode: the Gram is exactly
    symmetric (the JAX kernel's, mirrored by blocks, is too).
    Differentiable: K1 forward, K2 backward."""
    Vl, Dl = _prep_tensors(Z, base, increments, lhs=True)
    Vr, Dr = _prep_tensors(Z, base, increments, lhs=False)
    return _KzzFn.apply(Vl, Dl, Vr, Dr, num_levels, base, increments, True)


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
