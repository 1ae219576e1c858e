"""Cancellation-free increment Grams and batched level recursions.

The port of ``gpsig_tpu/ops/gram.py``: the closed-form increment Grams of
every base (rbf, linear, matern12/32/52, cosine, and, from the constrained
parameters, mix, integer-degree poly and the spectral families), the level
recursion with exclusive cumsums as triangular-ones matmuls, the
telescoped exact level 1 of a diagonal and of a cross Gram, the
higher-order (order > 1) level grid on batched Grams, the Kzz and Kzx slot
Grams of incremental inducing tensors from the closed forms, the
tensor-vs-sequence levels, and the seq x seq Gram blocked over example
tiles (``blocked_first_order_levels``, the route of the bases without a
hand kernel).  Also the accurate f32 ``exp``/``expm1`` that the plain
versions of the kernels use, and the dots-level matern12 closed forms with
their explicit partials, the same formulas as ``csrc/common.cuh``'s.

Where the JAX package takes a matmul ``precision`` argument, the port has
none: ``config.py`` keeps every f32 matmul in full f32.  JAX's
``jax.vmap`` over spectral components is a loop here, its ``lax.map`` over
example tiles a Python loop, and its ``stop_gradient`` on a regime
selector ``.detach()``.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

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


def _start(X):
    """The first point of each step of (..., L, d) paths: (..., L-1, d)."""
    return X[..., :-1, :]


def _step(X):
    """The steps of (..., L, d) paths: (..., L-1, d)."""
    return X[..., 1:, :] - X[..., :-1, :]


def _linear_increment_core(Xa, Xb, spec, bcast_a, bcast_b):
    """The linear increment Gram: the steps' inner products (exact)."""
    return torch.einsum(spec, _step(Xa), _step(Xb))


def _rbf_gaps(Xa, Xb, spec, bcast_a, bcast_b):
    """Cancellation-free rbf corner-exponent geometry ``(A00, d01, d10,
    dxx)`` with A(x,y) = -|x-y|^2/2 at the base corner, d01 = A(x,y') -
    A(x,y) = <x,dy> - d(|y|^2)/2 (d10 symmetric) and dxx = <dx,dy>; every
    gap is a small quantity computed from difference vectors."""
    Xa0, dXa = _start(Xa), _step(Xa)
    Xb0, dXb = _start(Xb), _step(Xb)
    dna = bcast_a(-0.5 * torch.sum((Xa[..., 1:, :] + Xa0) * dXa, dim=-1))
    dnb = bcast_b(-0.5 * torch.sum((Xb[..., 1:, :] + Xb0) * dXb, dim=-1))
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


def _rbf_increment_core(Xa, Xb, spec, bcast_a, bcast_b):
    """The rbf increment Gram: ``bracket_second_diff`` of the
    ``_rbf_gaps`` geometry."""
    return bracket_second_diff(*_rbf_gaps(Xa, Xb, spec, bcast_a, bcast_b))


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
    dXa, dXb = _step(Xa), _step(Xb)
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


# ---------------------------------------------------------------------------
# matern32/52, cosine, mix, poly and spectral closed forms
# ---------------------------------------------------------------------------


def _matern_poly_increment_core(Xa, Xb, spec, bcast_a, bcast_b, *, s,
                                half: bool):
    """Cancellation-free matern32/52 increment Gram
    (``gpsig_tpu/ops/gram.py:434``).  Both are a polynomial P in the
    distance times exp(-s r); with the corners at r00 + h, h in {0, g01,
    g10, G = g01 + g10 + delta} (``_radius_gaps``), the second difference
    factors through exp(-s r00) and each monomial of P(h) = c0 + c1 h +
    c2 h^2 has its own expm1 factorization:

        h^0: expm1(-s g01) expm1(-s g10) + e^{-s(g01+g10)} expm1(-s delta)
        h^1: g01 e^{-s g01} expm1(-s(g10+delta))
             + g10 e^{-s g10} expm1(-s(g01+delta)) + delta e^{-s G}
        h^2: the same with g01^2, g10^2 and
             (delta^2 + 2 g01 g10 + 2 delta (g01+g10)) e^{-s G}

    so every term is a product of small gap quantities.  ``half``:
    matern32 (P = 1 + s r), else matern52 (P = 1 + s r + s^2 r^2 / 3)."""
    r00, g01, g10, delta = _radius_gaps(Xa, Xb, spec, bcast_a, bcast_b)
    sg01, sg10, sdel = s * g01, s * g10, s * delta
    e01, e10 = exp_accurate(-sg01), exp_accurate(-sg10)
    eG = exp_accurate(-(sg01 + sg10 + sdel))
    em_10d = _expm1_stable(-(sg10 + sdel))
    em_01d = _expm1_stable(-(sg01 + sdel))
    t0 = (_expm1_stable(-sg01) * _expm1_stable(-sg10)
          + exp_accurate(-(sg01 + sg10)) * _expm1_stable(-sdel))
    t1 = g01 * e01 * em_10d + g10 * e10 * em_01d + delta * eG
    if half:
        bracket = (1.0 + s * r00) * t0 + s * t1
    else:
        ss3 = s * s / 3.0
        c0 = 1.0 + s * r00 + ss3 * torch.square(r00)
        c1 = s + 2.0 * ss3 * r00
        t2 = (torch.square(g01) * e01 * em_10d
              + torch.square(g10) * e10 * em_01d
              + (torch.square(delta) + 2.0 * g01 * g10
                 + 2.0 * delta * (g01 + g10)) * eG)
        bracket = c0 * t0 + c1 * t1 + ss3 * t2
    return exp_accurate(-s * r00) * bracket


def _matern32_increment_core(Xa, Xb, spec, bcast_a, bcast_b):
    return _matern_poly_increment_core(Xa, Xb, spec, bcast_a, bcast_b,
                                       s=math.sqrt(3.0), half=True)


def _matern52_increment_core(Xa, Xb, spec, bcast_a, bcast_b):
    return _matern_poly_increment_core(Xa, Xb, spec, bcast_a, bcast_b,
                                       s=math.sqrt(5.0), half=False)


def _unit_steps(X):
    """Unit-normalized observations and their cancellation-free steps:
    cosine's second difference is the linear increment Gram of the unit
    points, and

        d(x_hat) = (|x| dx - x (|x'| - |x|)) / (|x| |x'|),
        |x'| - |x| = <x' + x, dx> / (|x'| + |x|)

    keeps every factor a small-quantity product (``gpsig_tpu/ops/gram.py:
    123``).  Norm guards in the f32-normal range (1e-36)."""
    n = torch.sqrt(torch.clamp(torch.sum(torch.square(X), dim=-1),
                               min=1e-36))
    X0, dX = _start(X), _step(X)
    n0, n1 = n[..., :-1], n[..., 1:]
    dn = torch.sum((X[..., 1:, :] + X0) * dX, dim=-1) / (n0 + n1)
    dXh = (n0[..., None] * dX - X0 * dn[..., None]) / (n0 * n1)[..., None]
    return X / n[..., None], dXh


def _cosine_increment_core(Xa, Xb, spec, bcast_a, bcast_b):
    """The cosine increment Gram (see ``_unit_steps``)."""
    return torch.einsum(spec, _unit_steps(Xa)[1], _unit_steps(Xb)[1])


def _core_variants(core):
    """The variants of an increment core ``core(Xa, Xb, spec, bcast_a,
    bcast_b)``, which differ only in the einsum subscripts and where the
    per-side terms broadcast:

    * cross: (A, L1, d), (B, L2, d) -> (A, B, L1-1, L2-1);
    * diag: (N, L, d) -> (N, L-1, L-1), each example against itself;
    * pair: (N, La, d), (N, Lb, d) -> (N, La-1, Lb-1), example by example;
    * slots: (S, n, L, d) -> (S, n, n, L-1, L-1), the cross Gram of each
      of S sets against itself in one batched call (the Kzz slots of
      inducing tensors; JAX maps the cross Gram over them)."""

    def cross(Xa, Xb):
        return core(Xa, Xb, "asd,btd->abst", lambda v: v[:, None, :, None],
                    lambda v: v[None, :, None, :])

    def pair(Xa, Xb):
        return core(Xa, Xb, "nsd,ntd->nst", lambda v: v[:, :, None],
                    lambda v: v[:, None, :])

    def diag(X):
        return pair(X, X)

    def slots(Z):
        return core(Z, Z, "kasd,kbtd->kabst",
                    lambda v: v[:, :, None, :, None],
                    lambda v: v[:, None, :, None, :])

    return cross, diag, pair, slots


INCREMENT_GRAMS = {
    "linear": _core_variants(_linear_increment_core),
    "rbf": _core_variants(_rbf_increment_core),
    "matern12": _core_variants(_matern12_increment_core),
    "matern32": _core_variants(_matern32_increment_core),
    "matern52": _core_variants(_matern52_increment_core),
    "cosine": _core_variants(_cosine_increment_core),
}


def _mix_increment_maker(params):
    """mix = mixing rbf + (1 - mixing) linear is linear in the base Gram,
    so its increment Gram is that convex combination of the two closed
    forms."""
    mixing = params["mixing"]

    def core(Xa, Xb, spec, bcast_a, bcast_b):
        rbf_part = _rbf_increment_core(Xa, Xb, spec, bcast_a, bcast_b)
        lin = _linear_increment_core(Xa, Xb, spec, bcast_a, bcast_b)
        return mixing * rbf_part + (1.0 - mixing) * lin

    return _core_variants(core)


_POLY_MAX_DEGREE = 16


def _poly_increment_maker(params):
    """Cancellation-free poly ((<x,y> + gamma)^p) increment Gram
    (``gpsig_tpu/ops/gram.py:609``): with corner inner products I00 + {0,
    h01, h10, h01 + h10 + dl}, the second difference expands binomially
    around c = I00 + gamma,

        D = sum_{k=1..p} C(p,k) c^{p-k} S_k,
        S_k = sum_{a+b+e=k} k!/(a! b! e!) h01^a h10^b dl^e
              without the (k,0,0) and (0,k,0) monomials,

    every surviving monomial a product of >= 2 small factors.  Needs a
    static integer degree in [1, 16]; otherwise None (naive differencing,
    exact at f64)."""
    degree = params.get("poly_degree")
    if degree is None:
        return None
    try:
        p = float(degree)
    except (TypeError, ValueError, RuntimeError):
        return None
    if not p.is_integer() or not (1 <= p <= _POLY_MAX_DEGREE):
        return None
    p = int(p)
    gamma = params["poly_gamma"]

    def core(Xa, Xb, spec, bcast_a, bcast_b):
        Xa0, dXa = _start(Xa), _step(Xa)
        Xb0, dXb = _start(Xb), _step(Xb)

        def mm(A, B):
            return torch.einsum(spec, A, B)

        c = mm(Xa0, Xb0) + gamma
        h01, h10, dl = mm(Xa0, dXb), mm(dXa, Xb0), mm(dXa, dXb)
        out = None
        for k in range(1, p + 1):
            Sk = None
            for a in range(k + 1):
                for b in range(k + 1 - a):
                    e = k - a - b
                    if (a == k and b == 0) or (b == k and a == 0):
                        continue
                    coef = (math.factorial(k)
                            // (math.factorial(a) * math.factorial(b)
                                * math.factorial(e)))
                    term = float(coef) * (h01 ** a) * (h10 ** b) * (dl ** e)
                    Sk = term if Sk is None else Sk + term
            term = float(math.comb(p, k)) * c ** (p - k) * Sk
            out = term if out is None else out + term
        return out

    return _core_variants(core)


def _cexpm1(a, b):
    """Relatively accurate complex ``exp(a + ib) - 1`` as (re, im):
    ``re = expm1(a) cos(b) - 2 sin(b/2)^2``, ``im = exp(a) sin(b)``."""
    re = _expm1_stable(a) * torch.cos(b) - 2.0 * torch.square(
        torch.sin(0.5 * b))
    return re, exp_accurate(a) * torch.sin(b)


def _spectral_component(Xa, Xb, spec, bcast_a, bcast_b, alpha_q, omega_q,
                        gamma_q, exp_family: bool):
    """One mixture component ``alpha_q Re exp(A_q + i B_q)`` of the
    spectral increment Gram (``gpsig_tpu/ops/gram.py:680``): the complex
    matern12 factorization over the rbf (``_rbf_gaps``) or half-radius
    (``_radius_gaps``) envelope gaps of the gamma_q-scaled inputs, and the
    single-step phases of the separable B (its second difference is 0).
    Regime-split per entry like ``bracket_second_diff``: the identity where
    its two group magnitudes stay within 4 M, the corner scale, else the
    naive corner sum with exponents clipped <= 0; the selector carries no
    gradient."""
    two_pi = 2.0 * math.pi
    Xaq, Xbq = Xa * gamma_q, Xb * gamma_q
    if exp_family:
        r00, g01, g10, dlt = _radius_gaps(Xaq, Xbq, spec, bcast_a, bcast_b)
        A00, a01, a10, da = -0.5 * r00, -0.5 * g01, -0.5 * g10, -0.5 * dlt
    else:
        A00, a01, a10, da = _rbf_gaps(Xaq, Xbq, spec, bcast_a, bcast_b)
    B00 = (bcast_a(two_pi * torch.matmul(_start(Xa), omega_q))
           - bcast_b(two_pi * torch.matmul(_start(Xb), omega_q)))
    b01 = bcast_b(-two_pi * torch.matmul(_step(Xb), omega_q))
    b10 = bcast_a(two_pi * torch.matmul(_step(Xa), omega_q))
    c = _EXP_CLIP
    a01s = torch.clamp(a01, -c, c)
    a10s = torch.clamp(a10, -c, c)
    das = torch.clamp(da, -c, c)
    eA = exp_accurate(A00)
    e01re, e01im = _cexpm1(a01s, b01)
    e10re, e10im = _cexpm1(a10s, b10)
    Zre = eA * (e01re * e10re - e01im * e10im)
    Zim = eA * (e01re * e10im + e01im * e10re)
    # + e^{A00+a01+a10} expm1(delta), delta real; the exponent is summed
    # before exp
    es = exp_accurate(A00 + a01s + a10s) * _expm1_stable(das)
    bsum = b01 + b10
    Zre = Zre + es * torch.cos(bsum)
    Zim = Zim + es * torch.sin(bsum)
    ident = torch.cos(B00) * Zre - torch.sin(B00) * Zim

    t1 = torch.sqrt((e01re * e01re + e01im * e01im)
                    * (e10re * e10re + e10im * e10im))
    t2 = exp_accurate(torch.clamp(a01s + a10s, max=c)) * torch.abs(
        _expm1_stable(das))
    Mcs = torch.clamp(
        torch.maximum(
            exp_accurate(torch.clamp(torch.maximum(a01, a10), max=c)),
            exp_accurate(torch.clamp(a01 + a10 + da, max=c)),
        ),
        min=1.0,
    )
    ok = ((torch.maximum(t1, t2) <= 4.0 * Mcs)
          & (torch.abs(a01) < c) & (torch.abs(a10) < c)
          & (torch.abs(da) < c)).detach()

    def corner(t, ph):
        return exp_accurate(torch.clamp(t, max=0.0)) * torch.cos(B00 + ph)

    naive = (corner(A00 + a01 + a10 + da, bsum)
             - corner(A00 + a01, b01) - corner(A00 + a10, b10)
             + eA * torch.cos(B00))
    return alpha_q * torch.where(ok, ident, naive)


def _spectral_increment_maker(family: str):
    """Maker of the spectral increment Grams over the constrained mixture
    (``alpha`` (Q,), ``omega`` and ``spec_gamma`` (Q, d)); 'mixed' splits
    the components rbf / exp at Q//2 as ``base_kernels.spectral``.  The
    components are summed one after the other, in JAX's order.

    Under autograd each component is recomputed in the backward pass
    (``torch.utils.checkpoint``) instead of holding its temporaries: they
    take ~900 bytes an entry at float32, ~20 GB a component at the
    benchmark's Kzx slot Grams (5,000 slots x 50 examples x 92 steps), so
    Q = 5 would hold ~100 GB.  The recomputation gives the same numbers."""

    def maker(params):
        alpha, omega, gamma = (params["alpha"], params["omega"],
                               params["spec_gamma"])
        Q = alpha.shape[0]
        split = Q // 2 if family == "mixed" else (0 if family == "exp" else Q)

        def core(Xa, Xb, spec, bcast_a, bcast_b):
            parts = []
            for lo, hi, exp_family in ((0, split, False), (split, Q, True)):
                out = None
                for q in range(lo, hi):
                    args = (Xa, Xb, spec, bcast_a, bcast_b, alpha[q],
                            omega[q], gamma[q], exp_family)
                    t = (checkpoint(_spectral_component, *args,
                                    use_reentrant=False)
                         if torch.is_grad_enabled()
                         else _spectral_component(*args))
                    out = t if out is None else out + t
                if out is not None:
                    parts.append(out)
            return parts[0] if len(parts) == 1 else parts[0] + parts[1]

        return _core_variants(core)

    return maker


# the closed forms that need the kernel's constrained parameters (mixing
# weight, poly gamma and degree, spectral mixture)
PARAM_INCREMENT_GRAMS = {
    "mix": _mix_increment_maker,
    "poly": _poly_increment_maker,
    "spectral_rbf": _spectral_increment_maker("rbf"),
    "spectral_exp": _spectral_increment_maker("exp"),
    "spectral_mixed": _spectral_increment_maker("mixed"),
}


def _resolve_increment_grams(base: str, params):
    fns = INCREMENT_GRAMS.get(base)
    if fns is not None:
        return fns
    maker = PARAM_INCREMENT_GRAMS.get(base)
    if maker is not None and params is not None:
        return maker(params)
    return None


def increment_gram_fns(base: str, params=None):
    """(cross_fn, diag_fn) closed-form increment Grams for ``base``, or
    (None, None) without one (callers then take the naive second
    difference, exact at f64).  ``params`` (constrained and static)
    unlocks mix, integer-degree poly and the spectral families."""
    fns = _resolve_increment_grams(base, params)
    return (fns[0], fns[1]) if fns else (None, None)


def increment_gram_pair_fn(base: str, params=None):
    """Per-example two-view increment Gram ``f(Xa, Xb) -> (N, La-1,
    Lb-1)`` for ``base``, or None without a closed form."""
    fns = _resolve_increment_grams(base, params)
    return fns[2] if fns else None


def increment_gram_slots_fn(base: str, params=None):
    """Slot-batched cross increment Gram ``f(Z) -> (S, n, n, L-1, L-1)``
    of (S, n, L, d) sets for ``base``, or None without a closed form."""
    fns = _resolve_increment_grams(base, params)
    return fns[3] if fns else None


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


def _levels(G, num_levels: int, order: int, difference: bool):
    """The level stack of a batch of Grams at ``order``."""
    if order == 1:
        return first_order_levels_batched(G, num_levels,
                                          difference=difference)
    return higher_order_levels_batched(G, num_levels, order,
                                       difference=difference)


def _with_level1(K, level1):
    """``K`` with its level 1 replaced (out of place, for autograd)."""
    return torch.cat([K[:1], level1[None], K[2:]], dim=0)


def _pad_examples(X, block: int):
    """X padded with zero examples to whole blocks, and the block count."""
    N = X.shape[0]
    n_blocks = -(-N // block)
    pad = n_blocks * block - N
    if pad:
        X = torch.cat([X, X.new_zeros((pad,) + tuple(X.shape[1:]))], dim=0)
    return X, n_blocks


def blocked_first_order_levels(base_kern, X, X2=None, *, num_levels: int,
                               order: int = 1, difference: bool = True,
                               block_size: int = 16, increment_fn=None):
    """(M+1, N1, N2) per-level seq x seq kernels over (block, block)
    example tiles, so that the peak intermediate is a (block, L1, block,
    L2) Gram whatever N (``gpsig_tpu/ops/gram.py:990``), at any order.

    Args:
      base_kern: ``k(A, B) -> Gram`` over flat observation matrices.
      X: ``(N1, L1, d)`` scaled sequences; X2: ``(N2, L2, d)`` or None.
      block_size: examples a tile on each side, at most that side's count
        (a side of 50 is not padded to a block of 300).
      increment_fn: optional cancellation-free ``f(Xi, Xj) -> (B, B, L1-1,
        L2-1)`` (``increment_gram_fns``), used with ``difference``; level 1
        is then the exact telescoped one (``level1_exact_cross``).
    """
    if X2 is None:
        X2 = X
    N1, L1, d = X.shape
    N2, L2, _ = X2.shape
    B1, B2 = min(block_size, N1), min(block_size, N2)
    Xp, nb1 = _pad_examples(X, B1)
    X2p, nb2 = _pad_examples(X2, B2)
    use_inc = difference and increment_fn is not None
    rows = []
    for i in range(nb1):
        Xi = Xp[i * B1:(i + 1) * B1]
        tiles = []
        for j in range(nb2):
            Xj = X2p[j * B2:(j + 1) * B2]
            if use_inc:
                G = increment_fn(Xi, Xj)  # pre-differenced
            else:
                G = base_kern(Xi.reshape(B1 * L1, d), Xj.reshape(
                    B2 * L2, d)).reshape(B1, L1, B2, L2)
                G = G.permute(0, 2, 1, 3)  # (B1, B2, L1, L2)
            tiles.append(_levels(G, num_levels, order,
                                 difference and not use_inc))
        rows.append(torch.cat(tiles, dim=-1))
    K = torch.cat(rows, dim=-2)[:, :N1, :N2]
    if use_inc:
        K = _with_level1(K, level1_exact_cross(increment_fn, X, X2))
    return K


def blocked_first_order_levels_diag(base_kern, X, *, num_levels: int,
                                    order: int = 1, difference: bool = True,
                                    block_size: int = 64,
                                    increment_diag_fn=None):
    """(M+1, N) per-level diagonals, blocked over examples
    (``gpsig_tpu/ops/gram.py:1056``)."""
    N = X.shape[0]
    B = min(block_size, N)
    Xp, nb = _pad_examples(X, B)
    use_inc = difference and increment_diag_fn is not None
    tiles = []
    for i in range(nb):
        Xi = Xp[i * B:(i + 1) * B]
        G = increment_diag_fn(Xi) if use_inc else base_kern(Xi)
        tiles.append(_levels(G, num_levels, order,
                             difference and not use_inc))
    K = torch.cat(tiles, dim=-1)[:, :N]
    if use_inc:
        K = _with_level1(K, level1_exact_diag(increment_diag_fn, X))
    return K


def tens_closed_form_ok(base: str) -> bool:
    """Whether the closed forms serve the Kzz slot Grams of incremental
    inducing tensors.  Not for the spectral family: learned inducing
    increments drift to pair geometry where the oscillatory kernel leaves
    nothing to cancel and the quotient algebra only adds conditioning
    error (JAX measured 80x the naive graph's error against f64,
    ``gpsig_tpu/ops/gram.py:1104``), so spectral Kzz keeps the naive
    graph."""
    return not base.startswith("spectral")


def tens_slot_grams(slots_fn, Z):
    """(lt, nZ, nZ) cancellation-free Kzz slot Grams of incremental
    inducing tensors Z (lt, nZ, 2, d): each slot pair is a 2-point path,
    so each slot's Gram is the cross increment Gram of its pairs, all slots
    in one batched call of ``slots_fn`` (``increment_gram_slots_fn``)."""
    return slots_fn(Z)[..., 0, 0]


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
