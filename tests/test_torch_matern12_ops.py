"""The matern12 (exp(-r)) base of the port against the JAX package: the base
Gram, the dots-level closed forms, the array-level increment Grams and the
exact level 1 at float64, and the explicit partials that the plain versions
and the CUDA kernels share (``gram.mat12_*_partials``, the formulas of
``csrc/common.cuh``) against ``torch.autograd`` of the closed forms.

Tolerances: <= 1e-10 * max(scale, 1) against JAX at float64 (the same
algebra), except at coincident points -- the diagonal of a same-path Gram,
a repeated point -- where r = sqrt(|x - y|^2) of a rounding-level |x -
y|^2 is sqrt(eps)-limited in both packages (1.5e-8 at float64; their
matmuls round differently): there <= 1e-7 (``KINK``).  The partials
within 1e-12 of autograd relative to max(|entry|, 1), entry by entry, also
where a floor wins (zero steps, coincident points) and at ties of a
``maximum``, which both split in halves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import base_kernels as jbk
from gpsig_tpu.ops import gram as jgram
from gpsig_tpu_torch.ops import base_kernels as tbk
from gpsig_tpu_torch.ops import gram as tgram

TOL, KINK = 1e-10, 1e-7


def _close(j, t, kink=None):
    """Within TOL of JAX at the scale, KINK where ``kink`` (a boolean mask
    of the coincident points) is set."""
    j = np.asarray(j, dtype=np.float64)
    t = t.detach().numpy().astype(np.float64)
    assert j.shape == t.shape
    scale = max(float(np.max(np.abs(j))), 1.0)
    tol = np.full(j.shape, TOL) if kink is None else np.where(kink, KINK, TOL)
    assert bool(np.all(np.abs(j - t) <= tol * scale))


def _corner_dots(n=400, d=4, seed=0, degenerate=False):
    """(a00, d01, d10, dxx, nx, ny) of n corner pairs from points x, y and
    steps dx, dy through the norm augmentation the kernels use; with
    ``degenerate`` a quarter of the pairs coincide, and among those some
    steps are zero (the floors win) or both are."""
    rng = np.random.RandomState(seed)
    x, y = rng.randn(n, d) * 0.5, rng.randn(n, d) * 0.5
    size = rng.choice([1e-3, 0.1, 1.0], (2, n, 1))
    dx, dy = rng.randn(n, d) * size[0], rng.randn(n, d) * size[1]
    if degenerate:
        q = n // 4
        y[:q] = x[:q]
        dy[: q // 3] = 0.0
        dx[q // 3: 2 * q // 3] = 0.0
        dx[2 * q // 3: q] = dy[2 * q // 3: q] = 0.0

    def aug(v, lhs):
        nv = -0.5 * np.sum(v * v, 1, keepdims=True)
        one = np.ones_like(nv)
        return np.concatenate([v, nv, one] if lhs else [v, one, nv], 1)

    def aug_d(v, dv, lhs):
        dn = -0.5 * np.sum((2 * v + dv) * dv, 1, keepdims=True)
        zero = np.zeros_like(dn)
        return np.concatenate([dv, dn, zero] if lhs else [dv, zero, dn], 1)

    vl, dl = aug(x, True), aug_d(x, dx, True)
    vr, dr = aug(y, False), aug_d(y, dy, False)
    return [np.sum(a * b, 1) for a, b in ((vl, vr), (vl, dr), (dl, vr),
                                           (dl, dr))] + [
        np.linalg.norm(dx, axis=1), np.linalg.norm(dy, axis=1)]


def test_base_gram_and_euclid_dist():
    rng = np.random.RandomState(1)
    X, X2 = rng.randn(7, 3), rng.randn(5, 3)
    X2[0] = X[0]  # a coincident pair: the sqrt guard
    jfn = jax.jit(lambda a, b: (jbk.matern12({}, a), jbk.matern12({}, a, b),
                                jbk.euclid_dist(a, b)))
    same = np.zeros((7, 5), bool)
    same[0, 0] = True
    kinks = (np.eye(7, dtype=bool), same, same)
    for j, t, k in zip(jfn(jnp.asarray(X), jnp.asarray(X2)),
                       (tbk.get("matern12")({}, torch.from_numpy(X)),
                        tbk.matern12({}, torch.from_numpy(X),
                                     torch.from_numpy(X2)),
                        tbk.euclid_dist(torch.from_numpy(X),
                                        torch.from_numpy(X2))), kinks):
        _close(j, t, k)
    assert tbk.init_params("matern12") == ({}, {})


@pytest.mark.parametrize("degenerate", [False, True])
def test_closed_forms_from_dots(degenerate):
    a00, d01, d10, dxx, nx, ny = _corner_dots(degenerate=degenerate)

    def jfns(a00, d01, d10, dxx, nx, ny):
        return (jgram.mat12_cross_from_dots(a00, d01, d10, dxx, nx, ny,
                                            exp=jnp.exp, expm1=jnp.expm1),
                jgram.mat12_onesided_from_dots(a00, d10, nx, exp=jnp.exp,
                                               expm1=jnp.expm1),
                jgram.mat12_plain_from_dots(a00, exp=jnp.exp),
                jgram.radius_gaps_from_dots(a00, d01, d10, dxx, nx, ny,
                                            tiny_sq=1e-36))

    want = jax.jit(jfns)(*map(jnp.asarray, (a00, d01, d10, dxx, nx, ny)))
    t = [torch.from_numpy(a) for a in (a00, d01, d10, dxx, nx, ny)]
    got = (tgram.mat12_cross_from_dots(*t),
           tgram.mat12_onesided_from_dots(t[0], t[2], t[4]),
           tgram.mat12_plain_from_dots(t[0]),
           tgram.radius_gaps_from_dots(*t, tiny_sq=1e-36))
    for j, g in zip(want[:3], got[:3]):
        _close(j, g)
    for j, g in zip(want[3], got[3]):
        _close(j, g)


def test_increment_grams_and_exact_level1():
    rng = np.random.RandomState(2)
    Xa = (rng.randn(3, 6, 2) * 0.4).cumsum(1)
    Xb = (rng.randn(2, 8, 2) * 0.4).cumsum(1)
    Xb[:, 3] = Xb[:, 2]  # a repeated observation: a zero step
    jc, jd = jgram.increment_gram_fns("matern12")
    hp = jax.lax.Precision.HIGHEST
    want = jax.jit(lambda a, b: (
        jc(a, b, hp), jd(a, hp), jgram.increment_gram_pair_fn("matern12")(
            a[:2], b, hp), jgram.level1_exact_cross(jc, a, b, hp),
        jgram.level1_exact_diag(jd, a, hp)))(jnp.asarray(Xa), jnp.asarray(Xb))
    tc, td = tgram.increment_gram_fns("matern12")
    ta, tb = torch.from_numpy(Xa), torch.from_numpy(Xb)
    got = (tc(ta, tb), td(ta), tgram.INCREMENT_GRAMS["matern12"][2](ta[:2], tb),
           tgram.level1_exact_cross(tc, ta, tb),
           tgram.level1_exact_diag(td, ta))
    # a same-path Gram meets its own points on and beside its diagonal
    near = np.abs(np.subtract.outer(np.arange(5), np.arange(5))) <= 1
    kinks = (None, np.broadcast_to(near, (3, 5, 5)), None, None,
             np.ones(3, bool))
    for j, g, k in zip(want, got, kinks):
        _close(j, g, k)


def _entrywise(want, got, tol=1e-12):
    want, got = want.detach(), got.detach()
    assert bool(torch.all((want - got).abs()
                          <= tol * torch.clamp(want.abs(), min=1.0)))


@pytest.mark.parametrize("degenerate", [False, True])
def test_cross_partials_match_autograd(degenerate):
    """The six explicit partials dM/d(a00, d01, d10, dxx, nx, ny) of the
    dots-level matern12 cross form equal autograd's, away from the floors
    and (``degenerate``) where a step norm or the 1e-30 floor wins a
    denominator and where the radius guard wins at coincident points."""
    args = [torch.from_numpy(a) for a in _corner_dots(
        degenerate=degenerate, seed=3)]
    leaves = [a.clone().requires_grad_() for a in args]
    M = tgram.mat12_cross_from_dots(*leaves)
    want = torch.autograd.grad(M.sum(), leaves)
    got_M, got = tgram.mat12_cross_partials(*args)
    _entrywise(M, got_M)
    for w, g in zip(want, got):
        _entrywise(w, g)


def test_onesided_plain_partials_and_ties_match_autograd():
    """The one-sided and plain forms' partials, and the cross form at exact
    ties of its ``maximum``s (a00 = 0: max(-2 a00, 0); a zero step and a
    zero gap: the floors), which autograd and the partials split in
    halves."""
    a00, d01, d10, dxx, nx, ny = (torch.from_numpy(a)
                                  for a in _corner_dots(seed=4,
                                                        degenerate=True))
    leaves = [a.clone().requires_grad_() for a in (a00, d10, nx)]
    M = tgram.mat12_onesided_from_dots(*leaves)
    want = torch.autograd.grad(M.sum(), leaves)
    got_M, got = tgram.mat12_onesided_partials(a00, d10, nx)
    _entrywise(M, got_M)
    for w, g in zip(want, got):
        _entrywise(w, g)
    leaf = a00.clone().requires_grad_()
    M = tgram.mat12_plain_from_dots(leaf)
    (want,) = torch.autograd.grad(M.sum(), leaf)
    got_M, (got,) = tgram.mat12_plain_partials(a00)
    _entrywise(M, got_M)
    _entrywise(want, got)
    f64 = torch.float64
    ties = [torch.zeros(2, dtype=f64),
            torch.tensor([-0.1, 0.0], dtype=f64),
            torch.tensor([-0.2, 0.0], dtype=f64),
            torch.tensor([0.3, 0.0], dtype=f64),
            torch.tensor([1.0, 0.0], dtype=f64),
            torch.tensor([0.5, 0.0], dtype=f64)]
    leaves = [t.clone().requires_grad_() for t in ties]
    M = tgram.mat12_cross_from_dots(*leaves)
    want = torch.autograd.grad(M.sum(), leaves)
    _, got = tgram.mat12_cross_partials(*ties)
    for w, g in zip(want, got):
        _entrywise(w, g)
