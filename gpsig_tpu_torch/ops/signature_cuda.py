"""Signature Grams between sets of sequences through hand-written CUDA
kernels, at order 1 and at any higher order.

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
launches the kernel or raises (float64, an unsupported base).  There is no
fallback.  Both sequences may have any length: the kernels take a long
inner sequence in chunks with carries between them (``_k5_plan``,
``_k6_plan``), and any number of levels (past ``_cuda_build.MAIN_LEVELS``
from a library built for that level count).

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

matern12 takes the step norms of both sides' difference rows
(``inducing_cuda._step_norms``) as the floors of its closed form, and its
backward masks the cotangent of an increment entry whose step on either
side is zero, as ``_kernel_bwd`` does (``signature_pallas.py:991-1017``):
there the forward is exactly 0, so the mask is exact for repeat padding
and the lengthscales, and at a genuinely repeated observation of an
inducing sequence it keeps the JAX package's gradient.

At ``order`` k > 1 (clamped to the level count, as ``SignatureKernel``
does) each level is an (k x k) grid of partial tensors with 1/j, 1/(jk)
weights (``_pair_levels_fwd`` / ``_pair_levels_bwd``,
``signature_pallas.py:286-419``; ``csrc/common.cuh::grid_row``): the
kernels carry up to k column sums a level and take up to k scans a row,
and K6's reverse adds the three adjoints of the grid (the double suffix,
the column suffix Tbar, the in-row suffix Ubar) and the pointwise one.
K5 and K6 at an order past 1 come from a library built for that level
count and order (``_cuda_build.load(num_levels, order)``).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import gram
from . import inducing_cuda as ic
from . import signature as sig_ops

_THREADS = 128  # csrc/common.cuh::kSeqThreads
_WARPS = _THREADS // 32
_PLAIN_BLOCK = 1 << 21  # increment-Gram entries per block of the plain versions
# K5 (csrc/seq_fwd.cu): rows of at most _K5_REG_D2 channels sit in registers,
# two inner steps a lane (wider rows: one); the row carries of a block sit
# in shared memory up to _K5_CARRY_SMEM bytes
_K5_REG_D2 = 16
_K5_CARRY_SMEM = 48 * 1024
# a K5 block takes up to _K5_OUTER_RANGE outer sequences, of at most
# _K5_OUTER_STEPS steps in all, over the same inner rows
_K5_OUTER_RANGE = 8
_K5_OUTER_STEPS = 32
# K6: warps to aim for (16 on each SM), the shared memory a block of 4
# warps may take for its workspaces and column sums (all of it: four blocks
# an SM; the workspaces alone: two), the inner steps a chunk holds
# (csrc/common.cuh kSeqCols x 32), and the global scratch it may take
_TARGET_WARPS = 16 * 132
_K6_SMEM_ALL = 56 * 1024
_K6_SMEM_WS = 100 * 1024
_K6_CHUNK = 4 * 32
_K6_SCRATCH = 2 << 30


def _order(order: int, num_levels: int) -> int:
    """The grid's order: ``order`` clamped to the level count (order <= 0
    or >= num_levels: the full grid), as ``SignatureKernel`` clamps it."""
    return num_levels if order <= 0 or order >= num_levels else int(order)


def _grid_counts(num_levels: int, order: int) -> tuple[int, int]:
    """(column sums a row stores, scans a row) of K5/K6 at ``order``: M - 1
    each at order 1 (csrc/common.cuh grid_nc, grid_ns)."""
    d = [min(i, order) for i in range(num_levels + 1)]
    return sum(d[1:num_levels]), sum(d[2:])


def _check_config(num_levels: int, base: str):
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


def _cum_rows(t):
    return sig_ops.cumsum_exclusive(t, dim=-2)


def _cum_cols(t):
    return sig_ops.cumsum_exclusive(t, dim=-1)


def _levels(M, num_levels: int, order: int = 1):
    """(M+1, ...) level sums of (..., T1, T2) increment Grams: R_1 = M,
    R_m = M * P(R_{m-1}) by triangular-ones matmuls; at order > 1 the
    (order x order) tile grid (``_pair_levels_fwd``, ``signature.grid_next``)
    with the rows (the first argument's steps) on ``cum_rows``, its
    one-axis prefixes as exclusive cumsums (O(T) a row, where a matmul is
    O(T^2): the grid takes up to 8 of them a level)."""
    K = [torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device),
         torch.sum(M, dim=(-2, -1))]
    if order > 1:
        R = {(0, 0): M}
        for i in range(2, num_levels + 1):
            R = sig_ops.grid_next(M, R, min(i, order), _cum_rows, _cum_cols)
            K.append(torch.sum(sum(R.values()), dim=(-2, -1)))
        return torch.stack(K)
    A1 = gram._tri_ones(M.shape[-2], M.dtype, M.device)
    A2 = gram._tri_ones(M.shape[-1], M.dtype, M.device)
    R = M
    for _ in range(2, num_levels + 1):
        R = M * _prefix(R, A1, A2)
        K.append(torch.sum(R, dim=(-2, -1)))
    return torch.stack(K)


def _grid_keys(level: int, order: int):
    """The tiles (a, b) of level ``level``'s grid: a, b < min(level,
    order) (``_grid_keys``, ``signature_pallas.py:422``)."""
    d = min(level, order)
    return [(a, b) for a in range(d) for b in range(d)]


def _levels_vjp(M, ct, num_levels: int, order: int = 1):
    """Mbar of ``_levels`` under level cotangents ct (M+1, ...): the
    reverse sweep Rbar_M = g_M, Rbar_m = g_m + P^T(M * Rbar_{m+1}), Mbar =
    Rbar_1 + sum_{m>=2} P(R_{m-1}) * Rbar_m (``_pair_levels_bwd``).  At
    order > 1 the grid recursion's adjoint written out, as
    ``_pair_levels_bwd`` :378-419 has it (not autograd, so that it checks
    K6's algebra): level i-1's grid recomputed forward, then for each tile
    of level i its weight into Mbar and its cotangent into level i-1's
    tiles -- the double suffix for (0, 0), the column suffix Tbar for (0,
    j-1), the in-row reversed scan Ubar for (j-1, 0), pointwise for the
    rest."""
    g = ct[..., None, None]
    if order > 1:
        cum_rows, cum_cols = _cum_rows, _cum_cols

        def rcum_rows(t):
            return ic._rev_cumsum_exclusive(t, dim=-2)

        def rcum_cols(t):
            return ic._rev_cumsum_exclusive(t, dim=-1)

        Mbar = torch.zeros_like(M)
        Rbar = {key: g[num_levels].expand_as(M)
                for key in _grid_keys(num_levels, order)}
        for i in range(num_levels, 1, -1):
            d = min(i, order)
            Rprev = {(0, 0): M}
            for i2 in range(2, i):
                Rprev = sig_ops.grid_next(M, Rprev, min(i2, order),
                                          cum_rows, cum_cols)
            Rbar_prev = {key: g[i - 1].expand_as(M)
                         for key in _grid_keys(i - 1, order)}
            Mbar = Mbar + Rbar[(0, 0)] * cum_rows(cum_cols(
                sum(Rprev.values())))
            Sbar = rcum_rows(rcum_cols(M * Rbar[(0, 0)]))
            for key in Rbar_prev:
                Rbar_prev[key] = Rbar_prev[key] + Sbar
            for j in range(2, d + 1):
                row_keys = [(a, j - 2) for a in range(d)
                            if (a, j - 2) in Rprev]
                col_keys = [(j - 2, b) for b in range(d)
                            if (j - 2, b) in Rprev]
                row_sum = sum(Rprev[k] for k in row_keys)
                Mbar = Mbar + (1.0 / j) * Rbar[(0, j - 1)] * cum_rows(row_sum)
                Tbar = (1.0 / j) * rcum_rows(M * Rbar[(0, j - 1)])
                for k in row_keys:
                    Rbar_prev[k] = Rbar_prev[k] + Tbar
                col_sum = sum(Rprev[k] for k in col_keys)
                Mbar = Mbar + (1.0 / j) * Rbar[(j - 1, 0)] * cum_cols(col_sum)
                Ubar = (1.0 / j) * rcum_cols(M * Rbar[(j - 1, 0)])
                for k in col_keys:
                    Rbar_prev[k] = Rbar_prev[k] + Ubar
                for k2 in range(2, d + 1):
                    src = (j - 2, k2 - 2)
                    w = 1.0 / (j * k2)
                    Mbar = Mbar + w * Rbar[(j - 1, k2 - 1)] * Rprev[src]
                    Rbar_prev[src] = (Rbar_prev[src]
                                      + w * M * Rbar[(j - 1, k2 - 1)])
            Rbar = Rbar_prev
        return Mbar + Rbar[(0, 0)]
    A1 = gram._tri_ones(M.shape[-2], M.dtype, M.device)
    A2 = gram._tri_ones(M.shape[-1], M.dtype, M.device)
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


def _seq_norms(Dl, Dr, base: str, difference: bool):
    """matern12's step norms of both sides, broadcast to the increment
    Grams' (N1, N2, T1, T2) as (N1, 1, T1, 1) and (1, N2, 1, T2); (None,
    None) for the other bases and without difference."""
    if base != "matern12" or not difference:
        return None, None
    return (ic._step_norms(Dl, base)[:, None, :, None],
            ic._step_norms(Dr, base)[None, :, None, :])


def seq_fwd_plain(Vl, Dl, Vr, Dr, *, num_levels: int, base: str,
                  difference: bool, symmetric: bool = False, order: int = 1):
    """Plain torch version of K5 on the augmented rows, lhs (N1, L1, d2)
    and rhs (N2, L2, d2): ``(num_levels+1, N1, N2)``, the lhs steps on the
    grid's rows at order > 1 (``_pair_levels_fwd``).  f32 uses
    ``gram.exp_accurate`` and the Taylor ``expm1``; f64 the native ones.
    Blocked over the lhs sequences so full-width f64 stays within a few
    hundred MB."""
    _check_rows("seq_fwd_plain", Vl, Dl, Vr, Dr, symmetric)
    order = _order(order, num_levels)
    n1, n2 = Vl.shape[0], Vr.shape[0]
    T1 = _steps(Vl.shape[1], difference)
    T2 = _steps(Vr.shape[1], difference)
    Vl, Dl, Vr, Dr = Vl[:, :T1], Dl[:, :T1], Vr[:, :T2], Dr[:, :T2]
    if T1 == 0 or T2 == 0:
        out = torch.zeros((num_levels + 1, n1, n2), dtype=Vl.dtype,
                          device=Vl.device)
        out[0] = 1.0
        return out
    nl, nr = _seq_norms(Dl, Dr, base, difference)
    blocks = []
    for a0, a1 in _row_blocks(n1, n2, T1, T2):
        norms = None if nl is None else (nl[a0:a1], nr)
        M = ic._zz_gram(Vl[a0:a1], Dl[a0:a1], Vr, Dr, base, difference,
                        norms, dots=_pair_dots)
        blocks.append(_levels(M, num_levels, order))
    out = torch.cat(blocks, dim=1)
    return ic._mirror(out) if symmetric else out


def seq_bwd_plain(Vl, Dl, Vr, Dr, ct, *, num_levels: int, base: str,
                  difference: bool, symmetric: bool = False, order: int = 1):
    """Plain torch version of K6: the VJP of ``seq_fwd_plain`` under the
    cotangent ct (num_levels+1, N1, N2) -> (g_vl, g_dl) (N1, L1, d2) and
    (g_vr, g_dr) (N2, L2, d2).  matern12: Mbar is masked where either
    step is zero (the module docstring), and the step-norm cotangents
    chain into g_dl and g_dr."""
    _check_rows("seq_bwd_plain", Vl, Dl, Vr, Dr, symmetric)
    order = _order(order, num_levels)
    if symmetric:
        ct = ic._fold(ct)
    n1, n2 = Vl.shape[0], Vr.shape[0]
    T1 = _steps(Vl.shape[1], difference)
    T2 = _steps(Vr.shape[1], difference)
    grads = [torch.zeros_like(t) for t in (Vl, Dl, Vr, Dr)]
    if T1 == 0 or T2 == 0:
        return tuple(grads)
    g_vl, g_dl, g_vr, g_dr = grads
    Vr_t, Dr_t = Vr[:, :T2], Dr[:, :T2]
    nl, nr = _seq_norms(Dl[:, :T1], Dr_t, base, difference)

    def rows(w, B):  # sum over (b, t): w[a, b, s, t] B[b, t, :]
        return torch.einsum("abst,btc->asc", w, B)

    def cols(w, A):  # sum over (a, s): w[a, b, s, t] A[a, s, :]
        return torch.einsum("abst,asc->btc", w, A)

    for a0, a1 in _row_blocks(n1, n2, T1, T2):
        Vl_a, Dl_a = Vl[a0:a1, :T1], Dl[a0:a1, :T1]
        norms = None if nl is None else (nl[a0:a1], nr)
        M, P = ic._zz_partials(Vl_a, Dl_a, Vr_t, Dr_t, base, difference,
                               norms, dots=_pair_dots)
        Mbar = _levels_vjp(M, ct[:, a0:a1], num_levels, order)
        if nl is not None:  # the dead-step mask
            Mbar = Mbar * ((norms[0] > 0) & (nr > 0)).to(Mbar.dtype)
        W_A, W_01, W_10, W_xx, W_nx, W_ny = (None if p is None else Mbar * p
                                             for p in P)
        gd_l = ic._contract([(rows, W_10, Vr_t), (rows, W_xx, Dr_t)], Dl_a)
        gd_r = ic._contract([(cols, W_01, Vl_a), (cols, W_xx, Dl_a)], Dr_t)
        if nl is not None:
            gd_l = ic._norm_chain(gd_l, Dl_a, torch.sum(W_nx, dim=(1, 3)),
                                  norms[0][:, 0, :, 0])
            gd_r = ic._norm_chain(gd_r, Dr_t, torch.sum(W_ny, dim=(0, 2)),
                                  nr[0, :, 0])
        g_vl[a0:a1, :T1] += ic._contract([(rows, W_A, Vr_t),
                                          (rows, W_01, Dr_t)], Vl_a)
        g_dl[a0:a1, :T1] += gd_l
        g_vr[:, :T2] += ic._contract([(cols, W_A, Vl_a),
                                      (cols, W_10, Dl_a)], Vr_t)
        g_dr[:, :T2] += gd_r
    return g_vl, g_dl, g_vr, g_dr


# ---------------------------------------------------------------------------
# K5 and K6
# ---------------------------------------------------------------------------


def _k5_plan(T_in: int, d2: int) -> tuple[int, int, int]:
    """(G, cpl, chunks) of K5 with ``T_in`` steps on its inner axis: two
    steps a lane where the rows fit in registers (else one), the group
    width G the least power of two that holds the sequence, at most 32,
    and chunks of G cpl steps past that.  The main path's plans: G = 2
    for the 4-step inducing sequences (Kzz, Kzx), G = 32 in two chunks
    for the 92-step data of a full Kxx."""
    cpl = 2 if d2 <= _K5_REG_D2 else 1
    T = max(T_in, 1)
    G = 1
    while G < 32 and G * cpl < T:
        G *= 2
    return G, cpl, -(-T // (G * cpl))


def _k6_plan(T_in: int) -> tuple[int, int, int]:
    """(G, cpl, chunks) of K6 with ``T_in`` steps on its inner axis: one
    chunk of G cpl steps up to ``_K6_CHUNK`` (G the power of two >= the
    steps, at most 32), else chunks of 32 cpl steps, cpl <= 4."""
    T = max(T_in, 1)
    if T <= _K6_CHUNK:
        G = 1
        while G < min(T, 32):
            G *= 2
        return G, -(-T // G), 1
    nc = -(-T // _K6_CHUNK)
    return 32, -(-T // (32 * nc)), nc


def seq_fwd(Vl, Dl, Vr, Dr, *, num_levels: int, base: str, difference: bool,
            symmetric: bool = False, order: int = 1):
    """K5 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_fwd`` (``gpsig_tpu/ops/signature_pallas.py:436``).
    Bound on the H100: instruction issue -- per increment entry 4 dots of
    d2 and 4 accurate transcendentals.  Design: a group of G lanes per pair
    holds the inner rows in registers, each lane a contiguous run of steps,
    and sweeps the outer steps (staged in shared memory, read as
    broadcasts), carrying each level's column sums; a level's prefix is an
    in-lane prefix plus one scan of the lane totals.  An inner sequence
    longer than a chunk of G cpl steps is taken chunk by chunk with row
    carries, so both sides take any length.  The shorter sequence goes on
    the inner axis; G and cpl come from ``_k5_plan`` (``csrc/seq_fwd.cu``).
    At order > 1 the lanes carry the grid's column sums and scan each
    level's d rows (``csrc/common.cuh::grid_row``); the level sums do not
    depend on which side goes inner (the grid transposes with them)."""
    _check_config(num_levels, base)
    _check_rows("seq_fwd", Vl, Dl, Vr, Dr, symmetric)
    order = _order(order, num_levels)
    if Vl.is_cpu:
        return seq_fwd_plain(Vl, Dl, Vr, Dr, num_levels=num_levels,
                             base=base, difference=difference,
                             symmetric=symmetric, order=order)
    ic._check_cuda("seq_fwd", Vl, Dl, Vr, Dr)
    (n1, L1, d2), (n2, L2, _) = Vl.shape, Vr.shape
    T1, T2 = _steps(L1, difference), _steps(L2, difference)
    swap = not symmetric and T1 < T2  # the shorter sequence inner
    G, cpl, nc = _k5_plan(min(T1, T2), d2)
    outer, inner = ((Vr, Dr), (Vl, Dl)) if swap else ((Vl, Dl), (Vr, Dr))
    ov, od, iv, id_ = (t.contiguous() for t in (*outer, *inner))
    no, ni = ic._step_norms(od, base), ic._step_norms(id_, base)
    (n_out, L_out, _), (n_in, L_in, _) = ov.shape, iv.shape
    # outer sequences a block takes: short ones share the inner rows
    T_out = _steps(L_out, difference)
    orng = max(1, min(_K5_OUTER_RANGE, _K5_OUTER_STEPS // max(T_out, 1)))
    # csrc/seq_fwd.cu: the row carries, in a global scratch past
    # _K5_CARRY_SMEM bytes a block
    per_warp = 2 * T_out * _grid_counts(num_levels, order)[1] * (32 // G)
    gcarry = None
    if nc > 1 and 4 * _WARPS * per_warp > _K5_CARRY_SMEM:
        blocks = -(-n_out // orng) * -(-n_in // (_WARPS * (32 // G)))
        gcarry = torch.empty((blocks * _WARPS * per_warp,),
                             dtype=torch.float32, device=Vl.device)
    out = torch.empty((num_levels + 1, n1, n2), dtype=torch.float32,
                      device=Vl.device)
    ic._launch("gpsig_seq_fwd", num_levels, ov.data_ptr(), od.data_ptr(),
               iv.data_ptr(), id_.data_ptr(), ic._ptr(no), ic._ptr(ni),
               out.data_ptr(),
               0 if gcarry is None else gcarry.data_ptr(), n_out, L_out,
               n_in, L_in, d2, num_levels, order, ic._BASE_IDS[base],
               int(difference), int(symmetric), int(swap), G, cpl, nc, orng,
               ic._stream(Vl), order=order)
    seq_fwd.launches += 1
    return out


seq_fwd.launches = 0


def seq_bwd(Vl, Dl, Vr, Dr, ct, *, num_levels: int, base: str,
            difference: bool, symmetric: bool = False, order: int = 1):
    """K6 on CUDA float32 tensors; the plain version on CPU tensors.

    Replaces ``_kernel_bwd`` (``gpsig_tpu/ops/signature_pallas.py:827``).
    Bound on the H100: per increment entry K5's dots and transcendentals
    twice (the forward and the reverse sweep) and 8 d2 FMAs of weight
    contraction, so FMA issue and the shared-memory traffic of the
    contractions.  Design: one forward and one reverse sweep per pair --
    the shorter sequence on the inner axis, in chunks of at most 128 steps
    with row and suffix carries between them (``_k6_plan``), the longer on
    the outer axis -- and both arguments' gradients from it.  A warp owns a
    set of inner sequences and a range of outer ones: the inner steps'
    gradients accumulate in a per-warp workspace, each outer row's is
    summed over the warp by a shuffle reduce-scatter; the forward sweep
    stores each row's column sums, so the reverse reads P(R) exact, never
    recovered by subtraction.  The
    per-(inner, range) and per-(outer, set) slabs are summed here with
    ``torch.sum`` (no atomics, deterministic; ``csrc/seq_bwd.cu``).  At
    order > 1 the forward stores the grid's column carries, and the reverse
    recomputes each row's grid from them and runs its adjoint, one row at
    a time."""
    _check_config(num_levels, base)
    _check_rows("seq_bwd", Vl, Dl, Vr, Dr, symmetric)
    order = _order(order, num_levels)
    (n1, L1, d2), (n2, L2, _) = Vl.shape, Vr.shape
    if ct.shape != (num_levels + 1, n1, n2):
        raise ValueError(f"seq_bwd: cotangent shape {tuple(ct.shape)}")
    if Vl.is_cpu:
        return seq_bwd_plain(Vl, Dl, Vr, Dr, ct, num_levels=num_levels,
                             base=base, difference=difference,
                             symmetric=symmetric, order=order)
    ic._check_cuda("seq_bwd", Vl, Dl, Vr, Dr, ct)
    T1, T2 = _steps(L1, difference), _steps(L2, difference)
    grads = [torch.zeros_like(t) for t in (Vl, Dl, Vr, Dr)]
    if symmetric:
        ct = ic._fold(ct)
    # the shorter sequence on the inner axis
    swap = not symmetric and T1 < T2
    (ov, od), (iv, id_) = (((Vr, Dr), (Vl, Dl)) if swap
                           else ((Vl, Dl), (Vr, Dr)))
    ov, od, iv, id_, ct = (t.contiguous() for t in (ov, od, iv, id_, ct))
    no, ni = ic._step_norms(od, base), ic._step_norms(id_, base)
    (n_out, L_out, _), (n_in, L_in, _) = ov.shape, iv.shape
    T_out, T_in = _steps(L_out, difference), _steps(L_in, difference)
    G, cpl, nc = _k6_plan(T_in)
    n_sets = -(-n_in // (32 // G))
    # csrc/seq_bwd.cu (seq_bwd_ws_floats, seq_bwd_cs_floats): per warp a
    # workspace of inner rows and gradients and a store of column sums (and
    # with chunks their carries), in shared memory where a block's fit
    ws = 4 * d2 * cpl * 32 * nc  # floats
    n_c, n_s = _grid_counts(num_levels, order)
    cs = T_out * 32 * (n_c * cpl * nc + (n_s * (nc + 1) if nc > 1 else 0))
    if 4 * _WARPS * (ws + cs) <= _K6_SMEM_ALL:  # bytes, a block of 4 warps
        mode, scratch = 0, 0
    elif 4 * _WARPS * ws <= _K6_SMEM_WS:
        mode, scratch = 1, cs
    else:
        mode, scratch = 2, ws + cs
    ranges = max(1, min(n_out, -(-_TARGET_WARPS // n_sets)))
    if scratch:  # at most _K6_SCRATCH bytes of global scratch
        ranges = max(1, min(ranges, _K6_SCRATCH // (4 * scratch * n_sets)))
    if not symmetric:  # no empty range
        ranges = -(-n_out // -(-n_out // ranges))
    dev = Vl.device
    g_out = (torch.zeros if symmetric else torch.empty)(
        (n_out, n_sets, T_out, 2, d2), dtype=torch.float32, device=dev)
    g_in = torch.empty((n_in, ranges, T_in, 2, d2), dtype=torch.float32,
                       device=dev)
    gscratch = torch.empty((max(1, scratch * n_sets * ranges),),
                           dtype=torch.float32, device=dev)
    ic._launch("gpsig_seq_bwd", num_levels, ov.data_ptr(), od.data_ptr(),
               iv.data_ptr(), id_.data_ptr(), ic._ptr(no), ic._ptr(ni),
               ct.data_ptr(), g_out.data_ptr(),
               g_in.data_ptr(), gscratch.data_ptr(), n_out, L_out, n_in,
               L_in, d2, num_levels, order, ic._BASE_IDS[base],
               int(difference), int(symmetric), int(swap), G, cpl, nc, ranges,
               mode, ic._stream(Vl), order=order)
    seq_bwd.launches += 1
    g_out, g_in = torch.sum(g_out, dim=1), torch.sum(g_in, dim=1)
    outer, inner = ((2, 3), (0, 1)) if swap else ((0, 1), (2, 3))
    for (a, b), g, T in ((outer, g_out, T_out), (inner, g_in, T_in)):
        grads[a][:, :T] = g[:, :, 0]
        grads[b][:, :T] = g[:, :, 1]
    return tuple(grads)


seq_bwd.launches = 0


def expm1_probe(args):
    """Test hook of ``csrc/common.cuh``'s expm1 on a CUDA float32 tensor
    args (n, 4) = (a00, d01, d10, dxx) rows: (n, 8) = (expm1_acc(a00),
    expm1f(a00), the rbf slot Gram of the row with expm1_acc -- as K1, K3
    and K5 compute it -- and with expm1f, then its partials dG/d(d01),
    dG/d(d10), dG/d(dxx) with expm1_acc -- K2's weights -- and dG/d(d01)
    with expm1f).  Not a kernel of any path."""
    ic._check_cuda("expm1_probe", args)
    if args.ndim != 2 or args.shape[1] != 4:
        raise ValueError(f"expm1_probe: args of shape {tuple(args.shape)}")
    args = args.contiguous()
    out = torch.empty((args.shape[0], 8), dtype=args.dtype,
                      device=args.device)
    ic._launch("gpsig_expm1_probe", 1, args.data_ptr(), out.data_ptr(),
               args.shape[0], ic._stream(args))
    return out


def m12_probe(args):
    """Test hook of ``csrc/common.cuh``'s matern12 algebra on a CUDA float32
    tensor args (n, 6) = (a00, d01, d10, dxx, nx, ny) rows: (n, 9) =
    (mat12_cross as K1, K3 and K5 evaluate it; its value and six partials
    dM/d(a00, d01, d10, dxx, nx, ny) with expm1_acc, as K2 takes them; the
    value with expm1f, as K4 and K6 take it).  Not a kernel of any path."""
    ic._check_cuda("m12_probe", args)
    if args.ndim != 2 or args.shape[1] != 6:
        raise ValueError(f"m12_probe: args of shape {tuple(args.shape)}")
    padded = torch.zeros((args.shape[0], 8), dtype=args.dtype,
                         device=args.device)
    padded[:, :6] = args
    out = torch.empty((args.shape[0], 9), dtype=args.dtype,
                      device=args.device)
    ic._launch("gpsig_m12_probe", 1, padded.data_ptr(), out.data_ptr(),
               args.shape[0], ic._stream(args))
    return out


# ---------------------------------------------------------------------------
# autograd and the public entry point
# ---------------------------------------------------------------------------


class _SeqFn(torch.autograd.Function):
    """seq x seq level stack over the augmented rows: forward K5, backward
    K6.  Options after the rows: num_levels, base, difference, symmetric
    and, optionally, order (1 if not given)."""

    @staticmethod
    def forward(ctx, Vl, Dl, Vr, Dr, *opts):
        ctx.save_for_backward(Vl, Dl, Vr, Dr)
        ctx.opts = dict(zip(("num_levels", "base", "difference", "symmetric",
                             "order"), opts))
        return seq_fwd(Vl, Dl, Vr, Dr, **ctx.opts)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        grads = seq_bwd(*ctx.saved_tensors, ct.contiguous(), **ctx.opts)
        return (*grads, *(None,) * len(ctx.opts))


def fused_first_order_levels(X, X2=None, *, num_levels: int, base: str = "rbf",
                             difference: bool = True, order: int = 1):
    """(num_levels+1, N1, N2) signature level kernels of scaled sequences
    X (N1, L1, d) against X2 (N2, L2, d), or against X itself when X2 is
    None, at ``order`` (1, or the higher-order grid).  L1 and L2 may
    differ.  The symmetric Gram is
    exactly symmetric (each unordered pair computed once and mirrored);
    the JAX kernel's is symmetric only to rounding, and that is the only
    difference between the two.

    Differentiable: K5 forward, K6 backward.  With ``difference``, level 1
    is the telescoped ``gram.level1_exact_cross`` in torch, as the JAX
    package sets it (``signature_pallas.py:754-762``): autograd gives it its
    gradient and the kernel's own level-1 sum a zero cotangent."""
    _check_config(num_levels, base)
    symmetric = X2 is None
    X2 = X if symmetric else X2
    Vl, Dl = ic._prep_seq(X, base, lhs=True)
    Vr, Dr = ic._prep_seq(X2, base, lhs=False)
    out = _SeqFn.apply(Vl, Dl, Vr, Dr, num_levels, base, difference,
                       symmetric, _order(order, num_levels))
    if not difference:
        return out
    inc_cross, _ = gram.increment_gram_fns(base)
    level1 = gram.level1_exact_cross(inc_cross, X, X2).to(out.dtype)
    if symmetric:
        level1 = ic._mirror(level1)
    return torch.cat([out[:1], level1[None], out[2:]], dim=0)
