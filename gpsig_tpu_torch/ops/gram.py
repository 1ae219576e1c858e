"""Cancellation-free increment Grams and batched level recursions.

The subset of ``gpsig_tpu/ops/gram.py`` that the port runs: the f32
Kxx-diagonal leg (closed-form rbf/linear/matern12 increment Grams, the
level recursion with exclusive cumsums as triangular-ones matmuls, the
telescoped exact level 1 of a diagonal and of a cross Gram), the
higher-order (order > 1) level grid on batched Grams and the
tensor-vs-sequence levels from closed-form slot Grams (the order > 1 Kzx,
which has no kernel), the accurate
f32 ``exp``/``expm1`` that the plain versions of the kernels use, and the
dots-level matern12 closed forms with their explicit partials, the same
formulas as ``csrc/common.cuh``'s.

Where the JAX package takes a matmul ``precision`` argument, the port has
none: ``config.py`` keeps every f32 matmul in full f32.
"""

from __future__ import annotations

import torch

from .signature import grid_next

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


# ---------------------------------------------------------------------------
# matern12 (exp(-r)): cancellation-free corner-distance algebra
# ---------------------------------------------------------------------------

_TINY = 1e-30  # floor of every denominator (``radius_gaps_from_dots``)


def _max(a, b):
    """``maximum`` of a tensor and a tensor or number; its gradient splits
    at a tie, as JAX's does."""
    return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype,
                                            device=a.device))


def radius_gaps_from_dots(A00, d01, d10, dxx, ndx, ndy, *, tiny_sq):
    """Cancellation-free corner-distance geometry ``(r00, g01, g10,
    delta)`` from the four corner inner-product gaps (``A00 = -r00^2/2``,
    ``d01``/``d10`` the one-step gaps, ``dxx = <dx, dy>``) and the step
    norms ``ndx``/``ndy`` as triangle-inequality floors on the
    denominators:

        g01 = -2 d01 / (r01 + r00)          g10 = -2 d10 / (r10 + r00)
        u   = 2 (d01 + dxx) / (r10 + r11) + 2 d01 / (r00 + r01)
        delta = -2 dxx / (r11 + r01) - 2 d10 u / ((r11 + r01)(r10 + r00))

    (``gpsig_tpu/ops/gram.py:279``)."""
    r00sq = _max(-2.0 * A00, 0.0)
    r00 = torch.sqrt(_max(r00sq, tiny_sq))

    def radius(s):
        return torch.sqrt(_max(r00sq + s, tiny_sq))

    r01 = radius(-2.0 * d01)
    r10 = radius(-2.0 * d10)
    r11 = radius(-2.0 * (d01 + d10 + dxx))

    def over(num, den, floor):
        return num / _max(den, _max(floor, _TINY))

    g01 = over(-2.0 * d01, r01 + r00, ndy)
    g10 = over(-2.0 * d10, r10 + r00, ndx)
    u = (over(2.0 * (d01 + dxx), r10 + r11, ndy)
         + over(2.0 * d01, r00 + r01, ndy))
    delta = (over(-2.0 * dxx, r11 + r01, ndx)
             - over(2.0 * d10, r10 + r00, ndx) * over(u, r11 + r01, ndx))
    return r00, g01, g10, delta


def mat12_cross_from_dots(A00, d01, d10, dxx, ndx, ndy, *, exp=exp_accurate,
                          expm1=_expm1_stable, tiny_sq=1e-36):
    """matern12 second-difference increment Gram from corner dots:
    ``exp(-r00) (exp(-(g01 + g10)) expm1(-delta) + expm1(-g01)
    expm1(-g10))`` (``gpsig_tpu/ops/gram.py:318``)."""
    r00, g01, g10, delta = radius_gaps_from_dots(
        A00, d01, d10, dxx, ndx, ndy, tiny_sq=tiny_sq)
    return exp(-r00) * (exp(-(g01 + g10)) * expm1(-delta)
                        + expm1(-g01) * expm1(-g10))


def mat12_onesided_from_dots(A00, d10, ndx, *, exp=exp_accurate,
                             expm1=_expm1_stable, tiny_sq=1e-36):
    """One-sided matern12 difference ``k(x', y) - k(x, y)`` from dots:
    ``exp(-r00) expm1(-g10)``, ``g10 = -2 d10 / (r10 + r00)`` floored by
    the step norm (``gpsig_tpu/ops/gram.py:332``)."""
    r00sq = _max(-2.0 * A00, 0.0)
    r00 = torch.sqrt(_max(r00sq, tiny_sq))
    r10 = torch.sqrt(_max(r00sq - 2.0 * d10, tiny_sq))
    g10 = -2.0 * d10 / _max(r10 + r00, _max(ndx, _TINY))
    return exp(-r00) * expm1(-g10)


def mat12_plain_from_dots(A00, *, exp=exp_accurate, tiny_sq=1e-36):
    """Plain matern12 Gram entry ``exp(-r00)`` from ``A00 = -r00^2/2``
    (``gpsig_tpu/ops/gram.py:346``)."""
    r00 = torch.sqrt(_max(_max(-2.0 * A00, 0.0), tiny_sq))
    return exp(-r00)


def _max_w(a, b):
    """Weight of ``a`` in ``maximum(a, b)``'s gradient: 1 where it wins,
    1/2 at a tie, 0 where it loses."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


def mat12_cross_partials(A00, d01, d10, dxx, ndx, ndy, *, tiny_sq=1e-36):
    """``mat12_cross_from_dots`` and its six partials dM/d(A00, d01, d10,
    dxx, ndx, ndy), written out: the reverse sweep of the forward's
    quotients, denominators, radii and floors, with a tie of a ``maximum``
    split in halves as JAX's VJP splits it.  The same formulas as
    ``csrc/common.cuh::mat12_cross_partials``; f32 uses the accurate exp and
    the Taylor expm1, other dtypes the native ones."""
    exp, expm1 = exp_accurate, _expm1_stable
    x0 = -2.0 * A00
    r00sq = _max(x0, 0.0)
    s00, s01 = r00sq, r00sq + -2.0 * d01
    s10, s11 = r00sq + -2.0 * d10, r00sq + -2.0 * (d01 + d10 + dxx)
    r00, r01, r10, r11 = (torch.sqrt(_max(s, tiny_sq))
                          for s in (s00, s01, s10, s11))
    fx, fy = _max(ndx, _TINY), _max(ndy, _TINY)
    n1, n2, n3, n5 = r01 + r00, r10 + r00, r10 + r11, r11 + r01
    D1, D2, D3, D5 = (torch.maximum(n, f) for n, f in
                      ((n1, fy), (n2, fx), (n3, fy), (n5, fx)))
    g01, q2 = -2.0 * d01 / D1, 2.0 * d10 / D2
    g10 = -2.0 * d10 / D2
    ua, ub = 2.0 * (d01 + dxx) / D3, 2.0 * d01 / D1
    u = ua + ub
    qd1, qu = -2.0 * dxx / D5, u / D5
    delta = qd1 - q2 * qu
    E0, eg = exp(-r00), exp(-(g01 + g10))
    em_d, e1, e2 = expm1(-delta), expm1(-g01), expm1(-g10)
    M = E0 * (eg * em_d + e1 * e2)
    # dM/d(g01, g10, delta); dM/dr00 has M's own -M
    Gg01 = -E0 * (eg * em_d + (e1 + 1.0) * e2)
    Gg10 = -E0 * (eg * em_d + (e2 + 1.0) * e1)
    Gd = -E0 * eg * (em_d + 1.0)
    dq2, dqu = -Gd * qu, -Gd * q2  # delta = qd1 - q2 qu
    du = dqu / D5
    dD5 = -(dqu * qu + Gd * qd1) / D5
    dD3 = -du * ua / D3
    dD1 = -(du * ub + Gg01 * g01) / D1
    dD2 = -(Gg10 * g10 + dq2 * q2) / D2
    dd01 = 2.0 * du / D3 + (2.0 * du - 2.0 * Gg01) / D1
    dd10 = (2.0 * dq2 - 2.0 * Gg10) / D2
    ddxx = 2.0 * du / D3 - 2.0 * Gd / D5
    # denominators: to the radii where the sum wins, to the floors else
    w1, w2, w3, w5 = (_max_w(n, f) for n, f in
                      ((n1, fy), (n2, fx), (n3, fy), (n5, fx)))
    dr00 = -M + dD1 * w1 + dD2 * w2
    dr01 = dD1 * w1 + dD5 * w5
    dr10 = dD2 * w2 + dD3 * w3
    dr11 = dD3 * w3 + dD5 * w5
    dfx = dD2 * _max_w(fx, n2) + dD5 * _max_w(fx, n5)
    dfy = dD1 * _max_w(fy, n1) + dD3 * _max_w(fy, n3)
    # radii r = sqrt(max(s, tiny_sq))
    ds00, ds01, ds10, ds11 = (dr * 0.5 / r * _max_w(s, tiny_sq) for dr, r, s in
                              ((dr00, r00, s00), (dr01, r01, s01),
                               (dr10, r10, s10), (dr11, r11, s11)))
    dr00sq = ds00 + ds01 + ds10 + ds11
    return M, (-2.0 * dr00sq * _max_w(x0, 0.0), dd01 - 2.0 * (ds01 + ds11),
               dd10 - 2.0 * (ds10 + ds11), ddxx - 2.0 * ds11,
               dfx * _max_w(ndx, _TINY), dfy * _max_w(ndy, _TINY))


def mat12_onesided_partials(A00, d10, ndx, *, tiny_sq=1e-36):
    """``mat12_onesided_from_dots`` and its partials dM/d(A00, d10, ndx),
    written out as ``mat12_cross_partials`` (``csrc/common.cuh``)."""
    exp, expm1 = exp_accurate, _expm1_stable
    x0 = -2.0 * A00
    r00sq = _max(x0, 0.0)
    s10 = r00sq - 2.0 * d10
    r00, r10 = torch.sqrt(_max(r00sq, tiny_sq)), torch.sqrt(_max(s10, tiny_sq))
    fx = _max(ndx, _TINY)
    n2 = r10 + r00
    D2 = torch.maximum(n2, fx)
    g10 = -2.0 * d10 / D2
    E0, e2 = exp(-r00), expm1(-g10)
    M = E0 * e2
    Gg10 = -E0 * (e2 + 1.0)
    dD2 = -Gg10 * g10 / D2
    w2 = _max_w(n2, fx)
    ds10 = dD2 * w2 * 0.5 / r10 * _max_w(s10, tiny_sq)
    dr00sq = (dD2 * w2 - M) * 0.5 / r00 * _max_w(r00sq, tiny_sq) + ds10
    return M, (-2.0 * dr00sq * _max_w(x0, 0.0),
               -2.0 * Gg10 / D2 - 2.0 * ds10,
               dD2 * _max_w(fx, n2) * _max_w(ndx, _TINY))


def mat12_plain_partials(A00, *, tiny_sq=1e-36):
    """``mat12_plain_from_dots`` and dM/dA00."""
    x0 = -2.0 * A00
    r00sq = _max(x0, 0.0)
    r00 = torch.sqrt(_max(r00sq, tiny_sq))
    M = exp_accurate(-r00)
    return M, (M / r00 * _max_w(r00sq, tiny_sq) * _max_w(x0, 0.0),)


def _radius_gaps(Xa, Xb, spec, bcast_a, bcast_b):
    """Corner-distance geometry ``(r00, g01, g10, delta)`` of the steps of
    Xa against those of Xb (``gpsig_tpu/ops/gram.py:352``): the
    ``_rbf_gaps`` inner-product terms and the guarded step norms, through
    ``radius_gaps_from_dots``.  Zero steps (repeat padding) make every
    numerator exactly 0.  The norms' sqrt guard is a normal float of the
    dtype: 1e-40 is subnormal in f32, and sqrt's VJP through it blows up."""
    tiny_sq = 1e-40 if Xa.dtype == torch.float64 else 1e-36
    dXa = Xa[:, 1:] - Xa[:, :-1]
    dXb = Xb[:, 1:] - Xb[:, :-1]
    ndx = bcast_a(torch.sqrt(_max(torch.sum(torch.square(dXa), dim=-1),
                                  tiny_sq)))
    ndy = bcast_b(torch.sqrt(_max(torch.sum(torch.square(dXb), dim=-1),
                                  tiny_sq)))
    A00, d01, d10, dxx = _rbf_gaps(Xa, Xb, spec, bcast_a, bcast_b)
    return radius_gaps_from_dots(A00, d01, d10, dxx, ndx, ndy,
                                 tiny_sq=tiny_sq)


def _matern12_increment_core(Xa, Xb, spec, bcast_a, bcast_b):
    """Cancellation-free matern12 increment Gram ``exp(-r00) (exp(-(g01 +
    g10)) expm1(-delta) + expm1(-g01) expm1(-g10))`` over the
    ``_radius_gaps`` geometry (``gpsig_tpu/ops/gram.py:407``)."""
    r00, g01, g10, delta = _radius_gaps(Xa, Xb, spec, bcast_a, bcast_b)
    return exp_accurate(-r00) * (
        exp_accurate(-(g01 + g10)) * _expm1_stable(-delta)
        + _expm1_stable(-g01) * _expm1_stable(-g10))


def _matern12_increment_cross(Xa, Xb):
    """(A, L1, d), (B, L2, d) -> (A, B, L1-1, L2-1) matern12 increment
    Gram."""
    return _matern12_increment_core(
        Xa, Xb, "asd,btd->abst",
        lambda v: v[:, None, :, None], lambda v: v[None, :, None, :])


def _matern12_increment_pair(Xa, Xb):
    """(N, La, d), (N, Lb, d) -> (N, La-1, Lb-1) per-example matern12
    increment Grams."""
    return _matern12_increment_core(
        Xa, Xb, "nsd,ntd->nst", lambda v: v[:, :, None],
        lambda v: v[:, None, :])


def _matern12_increment_diag(X):
    return _matern12_increment_pair(X, X)


INCREMENT_GRAMS = {
    "linear": (_linear_increment_cross, _linear_increment_diag,
               _linear_increment_pair),
    "rbf": (_rbf_increment_cross, _rbf_increment_diag, _rbf_increment_pair),
    "matern12": (_matern12_increment_cross, _matern12_increment_diag,
                 _matern12_increment_pair),
}


def increment_gram_fns(base: str):
    """(cross_fn, diag_fn) closed-form increment Grams for ``base``, or
    (None, None) where the port has none."""
    fns = INCREMENT_GRAMS.get(base)
    return (fns[0], fns[1]) if fns else (None, None)


def level1_exact_cross(increment_fn, X, X2):
    """(N1, N2) exact level-1 kernel from endpoints only: the level-1
    double sum telescopes to the increment formula on the 2-point paths
    (x_0, x_L), (y_0, y_L), so its f32 error is ~2e-7 relative whatever L,
    where summing the (L-1)^2 increments random-walks."""
    ends = X[:, [0, X.shape[1] - 1], :]
    ends2 = X2[:, [0, X2.shape[1] - 1], :]
    return increment_fn(ends, ends2)[:, :, 0, 0]


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


def higher_order_levels_batched(M, num_levels: int, order: int, *,
                                difference: bool = True):
    """Higher-order level stack for a batch of ``(..., L1, L2)`` Grams: the
    (order x order) grid of ``signature.signature_kern_higher_order``, with
    the exclusive cumsums as triangular-ones matmuls.
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
    R = {(0, 0): M}
    for i in range(2, num_levels + 1):
        R = grid_next(M, R, min(i, order), lambda t: torch.matmul(A1, t),
                      lambda t: torch.matmul(t, A2.T))
        K.append(torch.sum(sum(R.values()), dim=(-2, -1)).reshape(
            batch_shape))
    return torch.stack(K, dim=0)


def tens_vs_seq_slot_grams(increment_fn, Z, X):
    """(lt, nZ, N, L-1) cancellation-free Kzx slot Grams, pre-differenced
    over time, of incremental inducing tensors Z (lt, nZ, 2, d) against
    sequences X (N, L, d): each slot pair is a 2-point path."""
    lt, nZ = Z.shape[0], Z.shape[1]
    G = increment_fn(Z.reshape(lt * nZ, 2, Z.shape[-1]), X)
    return G[:, :, 0, :].reshape(lt, nZ, X.shape[0], X.shape[1] - 1)


def tens_vs_seq_levels_mxu(M, num_levels: int, order: int = 1):
    """(M+1, nZ, N) tensor-vs-sequence level kernels from pre-differenced
    slot Grams M (lt, nZ, N, Lm): ``signature_kern_tens_vs_seq_*`` with
    ``difference=False``, the exclusive time cumsum a strictly-triangular
    ones matmul (``gpsig_tpu/ops/gram.py:1139``)."""
    A = _tri_ones(M.shape[-1], M.dtype, M.device).T

    def cum(R):
        return torch.matmul(R, A)

    K = [torch.ones(M.shape[1:3], dtype=M.dtype, device=M.device)]
    k = 0
    for i in range(1, num_levels + 1):
        R = [M[k]]
        k += 1
        for j in range(1, i):
            R_next = [M[k] * cum(sum(R))]
            for l in range(1, min(j + 1, order)):
                R_next.append((1.0 / (l + 1)) * M[k] * R[l - 1])
            R = R_next
            k += 1
        K.append(torch.sum(sum(R), dim=-1))
    return torch.stack(K, dim=0)
