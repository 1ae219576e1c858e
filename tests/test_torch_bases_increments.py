"""The closed-form increment Grams of the eight bases without a hand
kernel (``ops/gram.py``: cosine, mix, poly, matern32/52, spectral
rbf/exp/mixed) against ``gpsig_tpu``'s, on the same numpy inputs and
constrained parameters.

Mirrors ``tests/test_matern_poly_increments.py``,
``test_param_base_increments.py`` and ``test_spectral_increments.py``.
Tolerances:

* float64, port against JAX: cross, pair and diag Grams and the gradients
  of a cotangent-weighted sum, <= 1e-10 relative to the largest entry;
  except, as ``test_torch_matern12_ops.py`` holds matern12, on and beside
  the diagonal of a same-path (diag) Gram, where the exp family's r =
  sqrt(|x - y|^2) of a rounding-level |x - y|^2 is sqrt(eps)-limited in
  both packages: there <= 1e-7 (``KINK``);
* float32: port and JAX each against the float64 closed form (the
  oracle), the port within the bound of the JAX test it mirrors (5e-5
  absolute for matern32/52, cosine, mix and poly at L=512, and below the
  naive second difference for the three; spectral: 1e-4 relative, and
  below 0.2x the naive second difference in the smooth regime, 5x in the
  oscillatory one);
* repeat padding gives exact zeros.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import base_kernels as jbk
from gpsig_tpu.ops import gram as jgram
from gpsig_tpu_torch.ops import base_kernels as tbk
from gpsig_tpu_torch.ops import gram as tgram
from test_torch_ops import HIGHEST, RNG

FAMILIES = {
    "param": ("cosine", "mix", "poly"),
    "matern": ("matern32", "matern52"),
    "spectral": ("spectral_rbf", "spectral_exp", "spectral_mixed"),
}
NEW_BASES = sum(FAMILIES.values(), ())


def base_params(base, d=3, Q=5, seed=0, scale=1.0):
    """Constrained parameters of ``base`` as numpy values (a float for the
    static poly degree); ``scale`` shrinks the spectral frequencies and
    scales (the smooth regime)."""
    rng = np.random.RandomState(seed)
    if base == "mix":
        return {"mixing": np.float64(0.3)}
    if base == "poly":
        return {"poly_gamma": np.float64(1.2), "poly_degree": 3.0}
    if base.startswith("spectral"):
        return {"alpha": rng.rand(Q) + 0.2,
                "omega": np.exp(rng.randn(Q, d) * 0.5) * scale,
                "spec_gamma": (rng.rand(Q, d) + 0.3) * scale}
    return {}


def as_jax(params, dtype=np.float64):
    return {k: (v if isinstance(v, float) else jnp.asarray(v, dtype))
            for k, v in params.items()}


def as_torch(params, dtype=torch.float64, requires_grad=False):
    return {k: (v if isinstance(v, float) else torch.tensor(
        np.asarray(v), dtype=dtype, requires_grad=requires_grad))
        for k, v in params.items()}


def paths(n, L, d, shift=0.5, rng=RNG):
    # offset random walks: keeps cosine away from its zero-vector guard
    return rng.randn(n, L, d).cumsum(axis=1) / np.sqrt(L) + shift


TOL, KINK = 1e-10, 1e-7


def rel_err(want, got, kink=None):
    """Largest entry error relative to the largest entry; with a boolean
    ``kink`` mask, those entries' error counts at TOL / KINK of it."""
    want = np.asarray(want, dtype=np.float64)
    got = (got.detach().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got)).astype(np.float64)
    assert want.shape == got.shape
    err = np.abs(want - got)
    if kink is not None:
        err = np.where(kink, err * (TOL / KINK), err)
    return float(np.max(err)) / max(float(np.max(np.abs(want))), 1e-300)


def near_diagonal(n, L):
    """(n, L-1, L-1) mask of a same-path increment Gram's entries on and
    beside its diagonal, where its steps share a point."""
    idx = np.arange(L - 1)
    return np.broadcast_to(np.abs(np.subtract.outer(idx, idx)) <= 1,
                           (n, L - 1, L - 1))


def naive_cross_torch(base, params, X, Y):
    """The naive second difference of the port's base Gram (exact at
    float64)."""
    kf = tbk.get(base)
    A, L1, d = X.shape
    B, L2, _ = Y.shape
    G = kf(params, X.reshape(A * L1, d), Y.reshape(B * L2, d)).reshape(
        A, L1, B, L2).permute(0, 2, 1, 3)
    return (G[:, :, 1:, 1:] + G[:, :, :-1, :-1]
            - G[:, :, :-1, 1:] - G[:, :, 1:, :-1])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cross_pair_diag_match_jax_f64(family):
    X, Y = paths(3, 12, 3), paths(4, 9, 3, shift=-0.4)
    Xp, Yp = paths(3, 10, 3), paths(3, 7, 3, shift=-0.3)
    for base in FAMILIES[family]:
        p = base_params(base)
        jc, jd = jgram.increment_gram_fns(base, as_jax(p))
        jp = jgram.increment_gram_pair_fn(base, as_jax(p))
        tc, td = tgram.increment_gram_fns(base, as_torch(p))
        tp = tgram.increment_gram_pair_fn(base, as_torch(p))
        assert None not in (tc, td, tp), base
        want = jax.jit(lambda x, y, a, b: (
            jc(x, y, HIGHEST), jp(a, b, HIGHEST), jd(x, HIGHEST)))(
            X, Y, Xp, Yp)
        got = (tc(torch.from_numpy(X), torch.from_numpy(Y)),
               tp(torch.from_numpy(Xp), torch.from_numpy(Yp)),
               td(torch.from_numpy(X)))
        kinks = (None, None, near_diagonal(*X.shape[:2]))
        for w, g, k in zip(want, got, kinks):
            assert rel_err(w, g, k) <= TOL, base


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gradients_match_jax_f64(family):
    """The VJP of a cotangent-weighted cross Gram, to both inputs and to
    the constrained parameters (mix, poly gamma, the spectral mixture)."""
    X, Y = paths(2, 8, 3), paths(3, 6, 3, shift=-0.4)
    ct = RNG.randn(2, 3, 7, 5)
    for base in FAMILIES[family]:
        p = base_params(base)
        train = [k for k, v in p.items() if not isinstance(v, float)]

        def jf(x, y, *leaves, base=base, p=p, train=train):
            q = dict(as_jax(p), **dict(zip(train, leaves)))
            cross, _ = jgram.increment_gram_fns(base, q)
            return jnp.sum(cross(x, y, HIGHEST) * ct)

        want = jax.jit(jax.grad(jf, argnums=tuple(range(2 + len(train)))))(
            X, Y, *(as_jax(p)[k] for k in train))
        tp = as_torch(p, requires_grad=True)
        tX, tY = (torch.tensor(v, requires_grad=True) for v in (X, Y))
        cross, _ = tgram.increment_gram_fns(base, tp)
        got = torch.autograd.grad(
            torch.sum(cross(tX, tY) * torch.from_numpy(ct)),
            [tX, tY] + [tp[k] for k in train])
        for w, g in zip(want, got):
            assert rel_err(w, g) <= TOL, base


@functools.lru_cache(maxsize=None)
def _jax_cross(base, static):
    """JAX's cross increment Gram of ``base``, jitted once with the array
    parameters as arguments (``static``: the float ones, as pairs)."""
    def cross(p, x, y):
        fn, _ = jgram.increment_gram_fns(base, {**p, **dict(static)})
        return fn(x, y, HIGHEST)

    return jax.jit(cross)


def _f32_errors(base, params, L=512, d=3, shift=0.0, naive=True):
    """(port, JAX, naive) f32 errors against the f64 closed form (the
    largest absolute entry error), and the oracle's largest entry."""
    rng = np.random.RandomState(57)
    X64 = paths(2, L, d, shift=shift, rng=rng)
    Y64 = paths(2, L, d, shift=shift, rng=rng)
    static = tuple((k, v) for k, v in params.items() if isinstance(v, float))
    arrays = {k: v for k, v in params.items() if not isinstance(v, float)}
    cross = _jax_cross(base, static)
    oracle = np.asarray(cross(as_jax(arrays), X64, Y64))
    X32, Y32 = X64.astype(np.float32), Y64.astype(np.float32)
    j32 = np.asarray(cross(as_jax(arrays, np.float32), X32, Y32))
    tp32 = as_torch(params, torch.float32)
    tc32, _ = tgram.increment_gram_fns(base, tp32)
    t32 = tc32(torch.from_numpy(X32), torch.from_numpy(Y32)).numpy()
    errs = [float(np.max(np.abs(a.astype(np.float64) - oracle)))
            for a in (t32, j32)]
    if naive:
        n32 = naive_cross_torch(base, tp32, torch.from_numpy(X32),
                                torch.from_numpy(Y32)).numpy()
        errs.append(float(np.max(np.abs(n32.astype(np.float64) - oracle))))
    return errs, float(np.max(np.abs(oracle)))


@pytest.mark.parametrize("family", ["param", "matern"])
def test_f32_against_f64_oracle(family):
    """cosine, mix, poly (``test_param_base_increments.py``): 5e-5 and
    below the naive second difference; matern32/52
    (``test_matern_poly_increments.py``): 5e-5."""
    for base in FAMILIES[family]:
        (port, jx, naive), _ = _f32_errors(
            base, base_params(base), shift=1.0 if family == "param" else 0.0)
        assert port < 5e-5 and jx < 5e-5, (base, port, jx)
        if family == "param":
            assert port < naive, (base, port, naive)
