"""Cancellation-free increment Grams and batched level recursions.

The subset of ``gpsig_tpu/ops/gram.py`` that the serving slice runs: the
f32 Kxx-diagonal leg (closed-form rbf/linear increment Grams, the level
recursion with exclusive cumsums as triangular-ones matmuls, the telescoped
exact level 1) and the accurate f32 ``exp``/``expm1`` that the plain
versions of the inducing kernels use.

Where the JAX package takes a matmul ``precision`` argument, the port has
none: ``config.py`` keeps every f32 matmul in full f32.
"""

from __future__ import annotations

import torch

_LN2 = 0.6931471805599453
_LN2_HI = 0.693359375  # exact in f32 (10 significant bits)
_LN2_LO = -2.12194440e-4


def _tri_ones(L: int, dtype, device=None) -> torch.Tensor:
    """Strictly-lower-triangular ones: (A @ R)[s] = sum_{s'<s} R[s']."""
    return torch.tril(torch.ones((L, L), dtype=dtype, device=device),
                      diagonal=-1)


def exp_accurate(x: torch.Tensor) -> torch.Tensor:
    """f32 exp with ~2e-7 relative error by ldexp reduction: x = k ln2 + r
    with a two-part ln2, a 7-term Taylor series on r, and 2^k built from
    exponent bits.  Other dtypes use the native exp."""
    if x.dtype != torch.float32:
        return torch.exp(x)
    x = torch.clamp(x, -87.0, 88.0)
    kf = torch.round(x * (1.0 / _LN2))
    r = (x - kf * _LN2_HI) - kf * _LN2_LO
    p = r / 7.0
    for c in (6.0, 5.0, 4.0, 3.0, 2.0):
        p = (1.0 + p) * r / c
    poly = 1.0 + (1.0 + p) * r
    k32 = torch.clamp(kf, -126.0, 127.0).to(torch.int32)
    two_k = torch.bitwise_left_shift(k32 + 127, 23).view(torch.float32)
    return poly * two_k


def _expm1_stable(x: torch.Tensor) -> torch.Tensor:
    """exp(x) - 1, relatively accurate for small f32 arguments (6-term
    Taylor branch below |x| = 0.25); other dtypes use the native expm1."""
    if x.dtype != torch.float32:
        return torch.expm1(x)
    p = x / 6.0
    for k in (5.0, 4.0, 3.0, 2.0):
        p = (1.0 + p) * x / k
    taylor = (1.0 + p) * x
    return torch.where(torch.abs(x) < 0.25, taylor, exp_accurate(x) - 1.0)


# ---------------------------------------------------------------------------
# closed-form increment Grams
# ---------------------------------------------------------------------------


def _linear_increment_cross(Xa, Xb):
    """(A, L1, d), (B, L2, d) -> (A, B, L1-1, L2-1) linear increment Gram."""
    dXa = Xa[:, 1:] - Xa[:, :-1]
    dXb = Xb[:, 1:] - Xb[:, :-1]
    return torch.einsum("asd,btd->abst", dXa, dXb)


def _linear_increment_pair(Xa, Xb):
    """(N, La, d), (N, Lb, d) -> (N, La-1, Lb-1) per-example linear
    increment Grams."""
    dXa = Xa[:, 1:] - Xa[:, :-1]
    dXb = Xb[:, 1:] - Xb[:, :-1]
    return torch.einsum("nsd,ntd->nst", dXa, dXb)


def _linear_increment_diag(X):
    return _linear_increment_pair(X, X)


def _rbf_gaps(Xa, Xb, spec, bcast_a, bcast_b):
    """Cancellation-free rbf corner-exponent geometry ``(A00, d01, d10,
    dxx)`` with A(x,y) = -|x-y|^2/2 at the base corner, d01 = A(x,y') -
    A(x,y) = <x,dy> - d(|y|^2)/2 (d10 symmetric) and dxx = <dx,dy>; every
    gap is a small quantity computed from difference vectors."""
    Xa0, dXa = Xa[:, :-1], Xa[:, 1:] - Xa[:, :-1]
    Xb0, dXb = Xb[:, :-1], Xb[:, 1:] - Xb[:, :-1]
    dna = bcast_a(-0.5 * torch.sum((Xa[:, 1:] + Xa[:, :-1]) * dXa, dim=-1))
    dnb = bcast_b(-0.5 * torch.sum((Xb[:, 1:] + Xb[:, :-1]) * dXb, dim=-1))
    na = bcast_a(-0.5 * torch.sum(torch.square(Xa0), dim=-1))
    nb = bcast_b(-0.5 * torch.sum(torch.square(Xb0), dim=-1))

    def mm(A, B):
        return torch.einsum(spec, A, B)

    A00 = mm(Xa0, Xb0) + na + nb
    d01 = mm(Xa0, dXb) + dnb
    d10 = mm(dXa, Xb0) + dna
    dxx = mm(dXa, dXb)
    return A00, d01, d10, dxx


_EXP_CLIP = 40.0  # |gap| clip for the identity branch's exponentials


def bracket_second_diff(A00, a01, a10, da, *, exp=exp_accurate,
                        expm1=_expm1_stable):
    """Robust exponential second difference
    ``e^{A11} - e^{A01} - e^{A10} + e^{A00}`` with A01 = A00 + a01,
    A10 = A00 + a10, A11 = A00 + a01 + a10 + da and every corner <= 0.

    Per entry it picks the identity ``e^{A00} expm1(a01) expm1(a10) +
    e^{A00+a01+a10} expm1(da)`` (eps-relative while its two groups stay
    within the corner scale M) or the naive corner sum with exponents
    clipped to <= 0 (eps*M absolute, eps-relative exactly when the groups
    exceed M); see ``gpsig_tpu/ops/gram.py`` for the derivation."""
    c = _EXP_CLIP
    a01s = torch.clamp(a01, -c, c)
    a10s = torch.clamp(a10, -c, c)
    das = torch.clamp(da, -c, c)
    eA = exp(A00)
    g1 = expm1(a01s) * expm1(a10s)
    sum_s = torch.clamp(A00 + a01s + a10s, max=c)
    g2 = exp(sum_s) * expm1(das)
    ident = eA * g1 + g2

    t1 = torch.abs(g1)
    t2 = exp(torch.clamp(a01s + a10s, max=c)) * torch.abs(expm1(das))
    M = torch.clamp(
        torch.maximum(
            exp(torch.clamp(torch.maximum(a01, a10), max=c)),
            exp(torch.clamp(a01 + a10 + da, max=c)),
        ),
        min=1.0,
    )
    ok = (
        (torch.maximum(t1, t2) <= 2.0 * M)
        & (torch.abs(a01) < c) & (torch.abs(a10) < c) & (torch.abs(da) < c)
    ).detach()

    def corner(t):
        return exp(torch.clamp(t, max=0.0))

    naive = (corner(A00 + a01 + a10 + da) - corner(A00 + a01)
             - corner(A00 + a10) + eA)
    return torch.where(ok, ident, naive)


def _rbf_increment_cross(Xa, Xb):
    """(A, L1, d), (B, L2, d) -> (A, B, L1-1, L2-1) rbf increment Gram."""
    return bracket_second_diff(*_rbf_gaps(
        Xa, Xb, "asd,btd->abst",
        lambda v: v[:, None, :, None], lambda v: v[None, :, None, :],
    ))


def _rbf_increment_pair(Xa, Xb):
    """(N, La, d), (N, Lb, d) -> (N, La-1, Lb-1) per-example rbf increment
    Grams."""
    return bracket_second_diff(*_rbf_gaps(
        Xa, Xb, "nsd,ntd->nst",
        lambda v: v[:, :, None], lambda v: v[:, None, :],
    ))


def _rbf_increment_diag(X):
    return _rbf_increment_pair(X, X)


INCREMENT_GRAMS = {
    "linear": (_linear_increment_cross, _linear_increment_diag,
               _linear_increment_pair),
    "rbf": (_rbf_increment_cross, _rbf_increment_diag, _rbf_increment_pair),
}


def increment_gram_fns(base: str):
    """(cross_fn, diag_fn) closed-form increment Grams for ``base``, or
    (None, None) where the port has none."""
    fns = INCREMENT_GRAMS.get(base)
    return (fns[0], fns[1]) if fns else (None, None)


def level1_exact_diag(increment_diag_fn, X):
    """(N,) exact level-1 diagonal from endpoints only: the level-1 double
    sum telescopes to the increment formula on the 2-point path
    (x_0, x_L)."""
    ends = X[:, [0, X.shape[1] - 1], :]
    return increment_diag_fn(ends)[:, 0, 0]


def first_order_levels_batched(M, num_levels: int, *,
                               difference: bool = True):
    """First-order level stack for a batch of ``(..., L1, L2)`` Grams.

    Same math as ``signature.signature_kern_first_order``, with the double
    exclusive cumsum evaluated as ``A @ R @ A^T``.
    Returns ``(num_levels+1, ...)``."""
    if difference:
        M = (M[..., 1:, 1:] + M[..., :-1, :-1]
             - M[..., :-1, 1:] - M[..., 1:, :-1])
    L1, L2 = M.shape[-2], M.shape[-1]
    A1 = _tri_ones(L1, M.dtype, M.device)
    A2 = _tri_ones(L2, M.dtype, M.device)
    batch_shape = M.shape[:-2]
    M = M.reshape((-1, L1, L2))
    K = [torch.ones(batch_shape, dtype=M.dtype, device=M.device),
         torch.sum(M, dim=(-2, -1)).reshape(batch_shape)]
    R = M
    for _ in range(2, num_levels + 1):
        R = M * torch.matmul(torch.matmul(A1, R), A2.T)
        K.append(torch.sum(R, dim=(-2, -1)).reshape(batch_shape))
    return torch.stack(K, dim=0)
