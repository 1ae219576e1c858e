"""First-order signature Grams between sets of sequences through
hand-written CUDA kernels.

The port of ``gpsig_tpu/ops/signature_pallas.py``, forward and backward:

* ``seq_fwd`` launches K5 (``csrc/seq_fwd.cu``), which replaces the TPU
  kernel ``_kernel_fwd`` (``signature_pallas.py:436``);
* ``seq_bwd`` launches K6 (``csrc/seq_bwd.cu``), which replaces
  ``_kernel_bwd`` (``signature_pallas.py:827``).

Each has a plain PyTorch version beside it (``seq_fwd_plain``,
``seq_bwd_plain``) built from the same algebra in torch ops, and a launch
counter (``seq_fwd.launches``, ``seq_bwd.launches``) that rises by one per
kernel launch and nowhere else.  A wrapper runs its plain version only
because the tensors it was given lie on the CPU; on a CUDA tensor it
launches the kernel or raises (float64, an unsupported base, more levels or
steps than the kernels are built for).  There is no fallback.

``_SeqFn`` ties K5 to K6 as a ``torch.autograd.Function`` over the
augmented rows; the host prep stays in torch so autograd carries the
adjoint to the sequences (and through them to lengthscales and inducing
sequences): the lhs rows ``[x, -|x|^2/2, 1]`` and rhs rows
``[y, 1, -|y|^2/2]`` of ``_prep_inputs`` (``signature_pallas.py:566-590``)
with exact norm-channel step differences, the last step repeating the last
observation so its difference is exactly 0 (``inducing_cuda._prep_seq``).

Symmetric mode (``X2 is None``): each unordered pair is computed once and
mirrored, so the Gram is exactly symmetric, as the Cholesky of Kzz wants.
The JAX kernel computes its diagonal blocks in full and is symmetric only
to rounding (~3e-8 at f32); that mirror is the only difference.  The
backward folds the cotangent onto the upper triangle (ct + ct^T off the
diagonal).

Not ported here: ``order > 1`` (ROADMAP Queue 1, item 6) and the matern12
base (Queue 1, item 2); both raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import gram
from . import inducing_cuda as ic

MAX_STEPS = 32 * 4  # inner steps a group holds: csrc/common.cuh kSeqCols x 32
_THREADS = 128  # csrc/common.cuh::kSeqThreads
_WARPS = _THREADS // 32
_PLAIN_BLOCK = 1 << 21  # increment-Gram entries per block of the plain versions
# blocks to aim for: 8 blocks of 4 warps on each of an H100's 132 SMs, since
# a group's sweep is a chain of dependent FMAs, shuffles and exps that only
# other warps can hide
_TARGET_BLOCKS = 8 * 132


def _check_config(num_levels: int, base: str, order: int = 1):
    if order != 1:
        raise NotImplementedError(
            "order > 1 in the seq x seq kernels is not ported yet: ROADMAP "
            "Queue 1, item 6")
    if base == "matern12":
        raise NotImplementedError(
            "matern12 in the seq x seq kernels is not ported yet: ROADMAP "
            "Queue 1, item 2")
    if base not in ic.SUPPORTED_BASES:
        raise ValueError(f"base {base!r} has no seq x seq kernel; supported:"
                         f" {ic.SUPPORTED_BASES}")
    if num_levels < 1:
        raise ValueError("num_levels must be >= 1")


def _check_rows(name, Vl, Dl, Vr, Dr, symmetric):
    if Dl.shape != Vl.shape or Dr.shape != Vr.shape or Vl.ndim != 3 or (
            Vl.shape[-1] != Vr.shape[-1]):
        raise ValueError(f"{name}: inconsistent row shapes "
                         f"{tuple(Vl.shape)}, {tuple(Vr.shape)}")
    if symmetric and Vl.shape != Vr.shape:
        raise ValueError(f"{name}: symmetric mode needs one set of "
                         "sequences")


def _steps(L: int, difference: bool) -> int:
    return L - 1 if difference else L


def _mirror(K):
    """(..., N, N) -> exactly symmetric, from the upper triangle."""
    return torch.triu(K) + torch.triu(K, 1).transpose(-1, -2)


def _fold(ct):
    """The cotangent of ``_mirror``: ct + ct^T above the diagonal, ct on
    it, 0 below."""
    return (torch.triu(ct + ct.transpose(-1, -2), 1)
            + torch.diag_embed(torch.diagonal(ct, dim1=-2, dim2=-1)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _pair_dots(A, B):
    """(A, T1, c), (B, T2, c) -> (A, B, T1, T2)."""
    return torch.einsum("asc,btc->abst", A, B)


def _row_blocks(n1: int, n2: int, T1: int, T2: int):
    per = max(1, _PLAIN_BLOCK // max(1, n2 * T1 * T2))
    for a0 in range(0, n1, per):
        yield a0, min(n1, a0 + per)


def _prefix(R, A1, A2):
    """2-D exclusive prefix P(R)[s, t] = sum_{s'<s, t'<t} R[s', t']."""
    return torch.matmul(torch.matmul(A1, R), A2.T)


def _levels(M, num_levels: int):
    """(M+1, ...) level sums of (..., T1, T2) increment Grams:
    R_1 = M, R_m = M * P(R_{m-1}) by triangular-ones matmuls."""
    A1 = gram._tri_ones(M.shape[-2], M.dtype, M.device)
    A2 = gram._tri_ones(M.shape[-1], M.dtype, M.device)
    K = [torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device),
         torch.sum(M, dim=(-2, -1))]
    R = M
    for _ in range(2, num_levels + 1):
        R = M * _prefix(R, A1, A2)
        K.append(torch.sum(R, dim=(-2, -1)))
    return torch.stack(K)


def _levels_vjp(M, ct, num_levels: int):
    """Mbar of ``_levels`` under level cotangents ct (M+1, ...): the
    reverse sweep Rbar_M = g_M, Rbar_m = g_m + P^T(M * Rbar_{m+1}), Mbar =
    Rbar_1 + sum_{m>=2} P(R_{m-1}) * Rbar_m (``_pair_levels_bwd``)."""
    A1 = gram._tri_ones(M.shape[-2], M.dtype, M.device)
    A2 = gram._tri_ones(M.shape[-1], M.dtype, M.device)
    g = ct[..., None, None]
    Cs, R = [], M
    for _ in range(2, num_levels + 1):
        C = _prefix(R, A1, A2)
        Cs.append(C)
        R = M * C
    Rbar = g[num_levels].expand_as(M)
    Mbar = torch.zeros_like(M)
    for m in range(num_levels - 1, 0, -1):
        Mbar = Mbar + Cs[m - 1] * Rbar
        Rbar = g[m] + torch.matmul(torch.matmul(A1.T, M * Rbar), A2)
    return Mbar + Rbar


def seq_fwd_plain(Vl, Dl, Vr, Dr, *, num_levels: int, base: str,
                  difference: bool, symmetric: bool = False):
    """Plain torch version of K5 on the augmented rows, lhs (N1, L1, d2)
    and rhs (N2, L2, d2): ``(num_levels+1, N1, N2)``.  f32 uses
    ``gram.exp_accurate`` and the Taylor ``expm1``; f64 the native ones.
    Blocked over the lhs sequences so full-width f64 stays within a few
    hundred MB."""
    _check_rows("seq_fwd_plain", Vl, Dl, Vr, Dr, symmetric)
    n1, n2 = Vl.shape[0], Vr.shape[0]
    T1 = _steps(Vl.shape[1], difference)
    T2 = _steps(Vr.shape[1], difference)
    Vl, Dl, Vr, Dr = Vl[:, :T1], Dl[:, :T1], Vr[:, :T2], Dr[:, :T2]
    if T1 == 0 or T2 == 0:
        out = torch.zeros((num_levels + 1, n1, n2), dtype=Vl.dtype,
                          device=Vl.device)
        out[0] = 1.0
        return out
    blocks = []
    for a0, a1 in _row_blocks(n1, n2, T1, T2):
        M, _ = ic._zz_partials(Vl[a0:a1], Dl[a0:a1], Vr, Dr, base, difference,
                               dots=_pair_dots)
        blocks.append(_levels(M, num_levels))
    out = torch.cat(blocks, dim=1)
    return _mirror(out) if symmetric else out


def seq_bwd_plain(Vl, Dl, Vr, Dr, ct, *, num_levels: int, base: str,
                  difference: bool, symmetric: bool = False):
    """Plain torch version of K6: the VJP of ``seq_fwd_plain`` under the
    cotangent ct (num_levels+1, N1, N2) -> (g_vl, g_dl) (N1, L1, d2) and
    (g_vr, g_dr) (N2, L2, d2)."""
    _check_rows("seq_bwd_plain", Vl, Dl, Vr, Dr, symmetric)
    if symmetric:
        ct = _fold(ct)
    n1, n2 = Vl.shape[0], Vr.shape[0]
    T1 = _steps(Vl.shape[1], difference)
    T2 = _steps(Vr.shape[1], difference)
    grads = [torch.zeros_like(t) for t in (Vl, Dl, Vr, Dr)]
    if T1 == 0 or T2 == 0:
        return tuple(grads)
    g_vl, g_dl, g_vr, g_dr = grads
    Vr_t, Dr_t = Vr[:, :T2], Dr[:, :T2]

    def rows(w, B):  # sum over (b, t): w[a, b, s, t] B[b, t, :]
        return torch.einsum("abst,btc->asc", w, B)

    def cols(w, A):  # sum over (a, s): w[a, b, s, t] A[a, s, :]
        return torch.einsum("abst,asc->btc", w, A)

    for a0, a1 in _row_blocks(n1, n2, T1, T2):
        Vl_a, Dl_a = Vl[a0:a1, :T1], Dl[a0:a1, :T1]
        M, P = ic._zz_partials(Vl_a, Dl_a, Vr_t, Dr_t, base, difference,
                               dots=_pair_dots)
        Mbar = _levels_vjp(M, ct[:, a0:a1], num_levels)
        W_A, W_01, W_10, W_xx = (None if p is None else Mbar * p for p in P)
        g_vl[a0:a1, :T1] += ic._contract([(rows, W_A, Vr_t),
                                          (rows, W_01, Dr_t)], Vl_a)
        g_dl[a0:a1, :T1] += ic._contract([(rows, W_10, Vr_t),
                                          (rows, W_xx, Dr_t)], Dl_a)
        g_vr[:, :T2] += ic._contract([(cols, W_A, Vl_a),
                                      (cols, W_10, Dl_a)], Vr_t)
        g_dr[:, :T2] += ic._contract([(cols, W_01, Vl_a),
                                      (cols, W_xx, Dl_a)], Dr_t)
    return g_vl, g_dl, g_vr, g_dr


# ---------------------------------------------------------------------------
# K5 and K6
# ---------------------------------------------------------------------------


def _group(T: int) -> tuple[int, int]:
    """(lanes G, steps per lane) of a group holding T inner steps."""
    G = 1
    while G < min(max(T, 1), 32):
        G *= 2
    return G, -(-max(T, 1) // G)


def _splits(n_out: int, n_in: int, G: int) -> int:
    """Blocks per outer sequence: enough blocks to fill the card, no more
    than there are rounds of inner sequences."""
    want = -(-_TARGET_BLOCKS // n_out)
    return max(1, min(want, -(-n_in // (_THREADS // G))))


def _check_levels(name: str, num_levels: int):
    if num_levels > ic.MAX_LEVELS:
        raise ValueError(f"{name} is built for up to {ic.MAX_LEVELS} levels")


def seq_fwd(Vl, Dl, Vr, Dr, *, num_levels: int, base: str, difference: bool,
            symmetric: bool = False):
    """K5 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_fwd`` (``gpsig_tpu/ops/signature_pallas.py:436``).
    Bound on the H100: per increment entry 4 dots of d2 and up to 3
    transcendentals, so FMA issue (~0.01 ms for the 500 x 500 Kzz of
    length-5 sequences, ~0.02 ms for Kzx at 500 x 50 and 5 vs 93 steps, at
    67 TFLOP/s).  Design: a group of lanes per pair sweeps the outer steps,
    carrying each level's column sums, and takes the 2-D exclusive prefix
    as a segmented warp scan along the inner steps; the longer sequence
    goes on the inner axis, which holds at most ``MAX_STEPS`` steps
    (``csrc/seq_fwd.cu``)."""
    _check_config(num_levels, base)
    _check_rows("seq_fwd", Vl, Dl, Vr, Dr, symmetric)
    if Vl.device.type == "cpu":
        return seq_fwd_plain(Vl, Dl, Vr, Dr, num_levels=num_levels,
                             base=base, difference=difference,
                             symmetric=symmetric)
    ic._check_cuda("seq_fwd", Vl, Dl, Vr, Dr)
    _check_levels("seq_fwd", num_levels)
    (n1, L1, d2), (n2, L2, _) = Vl.shape, Vr.shape
    T1, T2 = _steps(L1, difference), _steps(L2, difference)
    swap = not symmetric and (MAX_STEPS >= T1 > T2 or T2 > MAX_STEPS)
    if min(T1, T2) > MAX_STEPS:
        raise ValueError(
            f"seq_fwd holds at most {MAX_STEPS} steps of the shorter "
            f"sequence on its inner axis; got {T1} and {T2} steps")
    outer, inner = ((Vr, Dr), (Vl, Dl)) if swap else ((Vl, Dl), (Vr, Dr))
    ov, od = (t.contiguous() for t in outer)
    ivT, idT = (t.transpose(1, 2).contiguous() for t in inner)
    n_out, L_out = ov.shape[0], ov.shape[1]
    n_in, L_in = ivT.shape[0], ivT.shape[2]
    G, cpl = _group(T1 if swap else T2)
    splits = _splits(n_out, n_in, G)
    out = torch.empty((num_levels + 1, n1, n2), dtype=torch.float32,
                      device=Vl.device)
    ic._launch("gpsig_seq_fwd", ov.data_ptr(), od.data_ptr(), ivT.data_ptr(),
               idT.data_ptr(), out.data_ptr(), n_out, L_out, n_in, L_in, d2,
               num_levels, ic._BASE_IDS[base], int(difference),
               int(symmetric), int(swap), G, cpl, splits, ic._stream(Vl))
    seq_fwd.launches += 1
    return out


seq_fwd.launches = 0


def seq_bwd(Vl, Dl, Vr, Dr, ct, *, num_levels: int, base: str,
            difference: bool, symmetric: bool = False):
    """K6 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_bwd`` (``gpsig_tpu/ops/signature_pallas.py:827``).
    Bound on the H100: K5's work twice on each side (forward and reverse
    sweeps) plus the partials and four weight contractions of d2, so FMA
    issue, and the per-row warp reductions of the row gradients.  Design:
    one launch of two sides, each taking one argument's sequences as the
    outer rows and returning their gradient; the forward sweep stores each
    row's column sums in a per-thread scratch so the reverse sweep reads
    P(R) exact, never recovered by subtraction; per-warp slabs summed here
    with ``torch.sum`` (no atomics, deterministic; ``csrc/seq_bwd.cu``)."""
    _check_config(num_levels, base)
    _check_rows("seq_bwd", Vl, Dl, Vr, Dr, symmetric)
    (n1, L1, d2), (n2, L2, _) = Vl.shape, Vr.shape
    if ct.shape != (num_levels + 1, n1, n2):
        raise ValueError(f"seq_bwd: cotangent shape {tuple(ct.shape)}")
    if Vl.device.type == "cpu":
        return seq_bwd_plain(Vl, Dl, Vr, Dr, ct, num_levels=num_levels,
                             base=base, difference=difference,
                             symmetric=symmetric)
    ic._check_cuda("seq_bwd", Vl, Dl, Vr, Dr, ct)
    _check_levels("seq_bwd", num_levels)
    T1, T2 = _steps(L1, difference), _steps(L2, difference)
    if max(T1, T2) > MAX_STEPS:
        raise ValueError(
            f"seq_bwd holds at most {MAX_STEPS} steps of each sequence on "
            f"its inner axis; got {T1} and {T2} steps")
    if symmetric:
        ct = _fold(ct)
    Vl, Dl, Vr, Dr, ct = (t.contiguous() for t in (Vl, Dl, Vr, Dr, ct))
    lvT, ldT, rvT, rdT = (t.transpose(1, 2).contiguous()
                          for t in (Vl, Dl, Vr, Dr))
    G0, cpl0 = _group(T2)  # side 0: lhs rows outer, rhs steps inner
    G1, cpl1 = _group(T1)  # side 1: rhs rows outer, lhs steps inner
    s0, s1 = _splits(n1, n2, G0), _splits(n2, n1, G1)
    dev = Vl.device
    g1 = torch.zeros((n1, s0, _WARPS, T1, 2, d2), dtype=torch.float32,
                     device=dev)
    g2 = torch.zeros((n2, s1, _WARPS, T2, 2, d2), dtype=torch.float32,
                     device=dev)
    states = (num_levels - 1) * _THREADS * (
        n1 * s0 * T1 * cpl0 + n2 * s1 * T2 * cpl1)
    scratch = torch.empty((max(states, 1),), dtype=torch.float32, device=dev)
    ic._launch("gpsig_seq_bwd", Vl.data_ptr(), Dl.data_ptr(), Vr.data_ptr(),
               Dr.data_ptr(), lvT.data_ptr(), ldT.data_ptr(), rvT.data_ptr(),
               rdT.data_ptr(), ct.data_ptr(), g1.data_ptr(), g2.data_ptr(),
               scratch.data_ptr(), n1, L1, n2, L2, d2, num_levels,
               ic._BASE_IDS[base], int(difference), int(symmetric), G0, cpl0,
               s0, G1, cpl1, s1, ic._stream(Vl))
    seq_bwd.launches += 1
    out = []
    for g, V in ((g1, Vl), (g2, Vr)):
        g = torch.sum(g, dim=(1, 2))
        gv, gd = torch.zeros_like(V), torch.zeros_like(V)
        gv[:, :g.shape[1]] = g[:, :, 0]
        gd[:, :g.shape[1]] = g[:, :, 1]
        out += [gv, gd]
    return tuple(out)


seq_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd and the public entry point
# ---------------------------------------------------------------------------


class _SeqFn(torch.autograd.Function):
    """seq x seq level stack over the augmented rows: forward K5, backward
    K6."""

    @staticmethod
    def forward(ctx, Vl, Dl, Vr, Dr, num_levels, base, difference,
                symmetric):
        ctx.save_for_backward(Vl, Dl, Vr, Dr)
        ctx.opts = dict(num_levels=num_levels, base=base,
                        difference=difference, symmetric=symmetric)
        return seq_fwd(Vl, Dl, Vr, Dr, **ctx.opts)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        grads = seq_bwd(*ctx.saved_tensors, ct.contiguous(), **ctx.opts)
        return (*grads, None, None, None, None)


def fused_first_order_levels(X, X2=None, *, num_levels: int, base: str = "rbf",
                             difference: bool = True, order: int = 1):
    """(num_levels+1, N1, N2) first-order signature level kernels of
    scaled sequences X (N1, L1, d) against X2 (N2, L2, d), or against X
    itself when X2 is None.  L1 and L2 may differ.  The symmetric Gram is
    exactly symmetric (each unordered pair computed once and mirrored);
    the JAX kernel's is symmetric only to rounding, and that is the only
    difference between the two.

    Differentiable: K5 forward, K6 backward.  With ``difference``, level 1
    is the telescoped ``gram.level1_exact_cross`` in torch, as the JAX
    package sets it (``signature_pallas.py:754-762``): autograd gives it its
    gradient and the kernel's own level-1 sum a zero cotangent."""
    _check_config(num_levels, base, order)
    symmetric = X2 is None
    X2 = X if symmetric else X2
    Vl, Dl = ic._prep_seq(X, base, lhs=True)
    Vr, Dr = ic._prep_seq(X2, base, lhs=False)
    out = _SeqFn.apply(Vl, Dl, Vr, Dr, num_levels, base, difference,
                       symmetric)
    if not difference:
        return out
    inc_cross, _ = gram.increment_gram_fns(base)
    level1 = gram.level1_exact_cross(inc_cross, X, X2).to(out.dtype)
    if symmetric:
        level1 = _mirror(level1)
    return torch.cat([out[:1], level1[None], out[2:]], dim=0)
