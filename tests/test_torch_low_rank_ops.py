"""The port's low-rank machinery (``gpsig_tpu_torch/ops/low_rank.py``)
against ``gpsig_tpu/ops/low_rank.py`` on the same numpy inputs and JAX's
own draws: the Nystrom map (and its spectral floor), the exact, sparse-JL
('sqrt', 'log'), dense ('rademacher', 'gauss') and subsampled ('lin')
Hadamard products, row-chunked = unchunked, the dispatcher, and the
sequence and inducing-tensor feature maps in every sparsity mode; and the
port's drawing step on a ``torch.Generator``.

torch and ``jax.random`` draw different streams, so ``jax_draws`` replays
JAX's key splits with ``jax.random`` and hands the draws to the port's
plain functions.  A Nystrom basis is an ``eigh``, whose eigenvector signs
each library picks its own way; where a result depends on them, the test
first asserts that both packages' ``eigh`` agree on that Gram.

Tolerance: 1e-8 relative to the largest entry, at float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import base_kernels as jbk
from gpsig_tpu.ops import low_rank as jlr
from gpsig_tpu_torch.ops import base_kernels as tbk
from gpsig_tpu_torch.ops import low_rank as tlr

TOL = 1e-8
SPARSITIES = ("sqrt", "log", "lin", "exact", "rademacher", "gauss")


def _close(want, got, tol=TOL):
    want = np.asarray(want, dtype=np.float64)
    got = (got.detach().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got)).astype(np.float64)
    assert want.shape == got.shape
    assert float(np.max(np.abs(want - got))) <= tol * max(
        float(np.max(np.abs(want))), 1e-300)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _projection(key, D, C, sparsity, dtype):
    """JAX's draw of one depth's projection, as ``lr_hadamard_prod_*``
    make it from ``key`` (``gpsig_tpu/ops/low_rank.py:83-198``)."""
    if sparsity == "exact":
        return None
    if sparsity == "lin":
        kp, kr = jax.random.split(key)
        sel = jax.random.permutation(kp, D)[:C]
        u = jax.random.uniform(kr, (C,), dtype=dtype)
        return None, sel, jnp.where(u <= 0.5, 1.0, -1.0).astype(dtype)
    if sparsity == "rademacher":
        u = jax.random.uniform(key, (D, C), dtype=dtype)
        return jnp.where(u <= 0.5, 1.0, -1.0).astype(dtype), None, None
    if sparsity == "gauss":
        return jax.random.normal(key, (D, C), dtype=dtype), None, None
    s = jnp.sqrt(float(D)) if sparsity == "sqrt" else D / jnp.log(float(D))
    return jlr._sparse_gaussian_matrix(key, D, C, jnp.asarray(s, dtype),
                                       dtype), None, None


def _to_projection(p):
    if p is None:
        return None
    sel = None if p[1] is None else _t(p[1]).long()
    return tlr.Projection(_t(p[0]), sel, _t(p[2]))


@functools.partial(jax.jit, static_argnames=(
    "num_points", "C", "rank_bound", "M", "sparsity", "joint"))
def _jax_draws(key, num_points, C, rank_bound, M, sparsity, joint):
    if joint:  # landmarks from the union of two point sets
        k_s, key = jax.random.split(key)
        idx = jlr.draw_indices(k_s, num_points, C)[0]
    k_nys, k_proj = jax.random.split(key)
    kidx, kjit = jax.random.split(k_nys)
    if not joint:
        idx = jlr.draw_indices(kidx, num_points, C)[0]
    keys = jax.random.split(k_proj, max(M - 1, 1))
    projections = [
        _projection(keys[j - 1], C * (C if j == 1 else rank_bound),
                    rank_bound, sparsity, jnp.float64)
        for j in range(1, max(M - 1, 1) + 1)]
    return idx, jax.random.uniform(kjit, (C,), dtype=jnp.float64), projections


def jax_draws(key, num_points, *, C, rank_bound, M, sparsity, joint=False):
    """Every draw JAX makes from ``key`` in one low-rank covariance call
    (``gpsig_tpu/kernels.py:540-576, 805``), as the port's
    ``LowRankDraws``: with ``joint`` the call's landmarks come from the
    union of two point sets (``k_s``), else from one (``kidx``)."""
    idx, u, projections = _jax_draws(key, num_points, C, rank_bound, M,
                                     sparsity, joint)
    return tlr.LowRankDraws(_t(idx).long(), _t(u),
                            [_to_projection(p) for p in projections])


def assert_eigh_agrees(W):
    """Both packages' ``eigh`` give the same eigenbasis of W (the sign
    of each eigenvector is each library's own choice)."""
    W = W.detach() if isinstance(W, torch.Tensor) else torch.from_numpy(W)
    Sj, Uj = jax.jit(jnp.linalg.eigh)(W.numpy())
    St, Ut = torch.linalg.eigh(0.5 * (W + W.T))
    _close(Sj, St, 1e-10)
    assert float(np.max(np.abs(np.asarray(Uj) - Ut.numpy()))) <= 1e-8, (
        "eigenvector signs differ between jax and torch on this Gram")


def _rbf(ls=0.9):
    cp = {"lengthscales": None}
    return (lambda A, B=None: jbk.get("rbf")(cp, A / ls, None if B is None
                                             else B / ls),
            lambda A, B=None: tbk.get("rbf")(cp, A / ls, None if B is None
                                             else B / ls))


def test_nystrom_map_and_its_spectral_floor():
    """JAX's landmarks and jitter uniforms into the plain ``nystrom_map``;
    then landmarks with a repeated point (a singular Gram), where the
    floor zeroes the directions below max(S) * 1e-12."""
    rng = np.random.RandomState(0)
    X = rng.randn(30, 2)
    jk, tk = _rbf()
    key = jax.random.PRNGKey(1)
    want = jax.jit(lambda x: jlr.nystrom_map(key, x, jk,
                                             num_components=3))(X)
    kidx, kjit = jax.random.split(key)
    idx = np.asarray(jlr.draw_indices(kidx, 30, 3)[0])
    u = _t(jax.random.uniform(kjit, (3,), dtype=jnp.float64))
    lm = torch.from_numpy(X[idx])
    assert_eigh_agrees(tk(lm, lm) + torch.diag(1e-6 * u))
    _close(want, tlr.nystrom_map(torch.from_numpy(X), tk, lm, u))
    # explicit landmarks with a repeat: the Gram has a null direction
    nys = X[[0, 1, 1]]
    want = jax.jit(lambda x: jlr.nystrom_map(key, x, jk,
                                             nys_samples=nys))(X)
    U, inv_sqrt = tlr.nystrom_basis(torch.from_numpy(nys), tk, u, 1e-6)
    assert int((inv_sqrt == 0).sum()) == 1
    lm = torch.from_numpy(nys)
    assert_eigh_agrees(tk(lm, lm) + torch.diag(1e-6 * u))
    _close(want, tlr.nystrom_map(torch.from_numpy(X), tk, lm, u))


@pytest.mark.parametrize("sparsity", ["sqrt", "log"])
def test_sparse_jl_product_chunked_and_not(sparsity):
    rng = np.random.RandomState(1)
    A, B = rng.randn(5, 6, 4), rng.randn(5, 6, 3)
    key = jax.random.PRNGKey(2)
    f = jax.jit(lambda a, b, rows: jlr.lr_hadamard_prod_sparse(
        key, a, b, 7, sparsity, chunk_rows=rows), static_argnums=2)
    R = _t(_projection(jax.random.PRNGKey(2), 12, 7, sparsity,
                       jnp.float64)[0])
    assert 0 < int((R != 0).sum()) < R.numel()
    for rows in (1 << 15, 7):  # one chunk, and 30 rows in chunks of 7
        got = tlr.lr_hadamard_prod_sparse(torch.from_numpy(A),
                                          torch.from_numpy(B), R, sparsity,
                                          chunk_rows=rows)
        _close(f(A, B, rows), got)
    _close(f(A, B, 1 << 15), tlr.lr_hadamard_prod_sparse(
        torch.from_numpy(A), torch.from_numpy(B), R, sparsity, chunk_rows=4))


@pytest.mark.parametrize("distribution", ["rademacher", "gauss"])
def test_dense_jl_product_chunked_and_not(distribution):
    rng = np.random.RandomState(2)
    A, B = rng.randn(4, 5, 3), rng.randn(4, 5, 4)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda a, b: jlr.lr_hadamard_prod_dense(
        key, a, b, 6, distribution))(A, B)
    R = _t(_projection(key, 12, 6, distribution, jnp.float64)[0])
    for rows in (1 << 15, 3):
        _close(want, tlr.lr_hadamard_prod_dense(
            torch.from_numpy(A), torch.from_numpy(B), R, chunk_rows=rows))


def test_subsampled_product_and_the_dispatcher():
    """'lin' keeps C index pairs with random signs; the dispatcher routes
    every mode, 'exact' to the full outer product."""
    rng = np.random.RandomState(3)
    A, B = rng.randn(3, 4, 3), rng.randn(3, 4, 5)
    key = jax.random.PRNGKey(4)
    for sparsity in SPARSITIES:
        want = jax.jit(lambda a, b: jlr.lr_hadamard_prod_rand(
            key, a, b, 6, sparsity))(A, B)
        proj = _to_projection(_projection(key, 15, 6, sparsity, jnp.float64))
        _close(want, tlr.lr_hadamard_prod_rand(
            torch.from_numpy(A), torch.from_numpy(B), proj, sparsity))
    _close(np.asarray(jlr.lr_hadamard_prod(A, B)), tlr.lr_hadamard_prod(
        torch.from_numpy(A), torch.from_numpy(B)))


def _depth_draws(key, M, C, rank_bound, sparsity):
    keys = jax.random.split(key, max(M - 1, 1))
    return [_to_projection(_projection(
        keys[j - 1], C * (C if j == 1 else rank_bound), rank_bound,
        sparsity, jnp.float64)) for j in range(1, max(M - 1, 1) + 1)]


def test_sequence_features_every_sparsity():
    """``signature_kern_lr_feature`` at 4 levels, with and without
    ``difference``, each level's factor (levels >= 2 sum the projected P,
    JAX's fix of the reference)."""
    rng = np.random.RandomState(4)
    U = rng.randn(3, 6, 4)
    key = jax.random.PRNGKey(5)
    for sparsity, difference in zip(SPARSITIES * 2, [True] * 6 + [False] * 6):
        want = jax.jit(lambda u: jlr.signature_kern_lr_feature(
            key, u, 4, 5, sparsity, difference=difference))(U)
        got = tlr.signature_kern_lr_feature(
            torch.from_numpy(U), 4, _depth_draws(key, 4, 4, 5, sparsity),
            sparsity, difference=difference)
        assert len(got) == 5
        for w, g in zip(want, got):
            _close(w, g)


def test_tensor_features_every_sparsity():
    """``tensor_kern_lr_feature`` at 4 levels: slot depth j takes depth
    j's projection at every level."""
    rng = np.random.RandomState(5)
    U = rng.randn(10, 3, 4)
    key = jax.random.PRNGKey(6)
    for sparsity in SPARSITIES:
        want = jax.jit(lambda u: jlr.tensor_kern_lr_feature(
            key, u, 4, 5, sparsity))(U)
        got = tlr.tensor_kern_lr_feature(
            torch.from_numpy(U), 4, _depth_draws(key, 4, 4, 5, sparsity),
            sparsity)
        for w, g in zip(want, got):
            _close(w, g)


def test_drawing_step():
    """``draw_low_rank`` on a ``torch.Generator``: a seed gives the same
    draws; landmarks distinct; each mode's projection shaped (C * C or
    C * rank_bound, rank_bound) with its own law."""
    def draws(sparsity, seed=0):
        return tlr.draw_low_rank(
            torch.Generator().manual_seed(seed), 500, num_components=20,
            rank_bound=30, num_levels=3, sparsity=sparsity,
            dtype=torch.float64)

    a, b = draws("sqrt"), draws("sqrt")
    assert torch.equal(a.landmarks, b.landmarks)
    assert torch.equal(a.jitter, b.jitter)
    assert all(torch.equal(p.R, q.R) for p, q in zip(a.projections,
                                                     b.projections))
    assert not torch.equal(a.landmarks, draws("sqrt", 1).landmarks)
    assert len(set(a.landmarks.tolist())) == 20
    assert bool(((a.jitter >= 0) & (a.jitter < 1)).all())
    assert [tuple(p.R.shape) for p in a.projections] == [(400, 30),
                                                         (600, 30)]
    density = float((a.projections[1].R != 0).double().mean())
    p = 1.0 / np.sqrt(600)
    assert abs(density - p) <= 5 * np.sqrt(p * (1 - p) / 600 / 30)
    assert draws("exact").projections == [None, None]
    lin = draws("lin").projections[0]
    assert len(set(lin.sel.tolist())) == 30 and int(lin.sel.max()) < 400
    assert set(lin.signs.tolist()) <= {-1.0, 1.0}
    R = draws("rademacher").projections[1].R
    assert set(R.unique().tolist()) == {-1.0, 1.0}
    assert tuple(draws("gauss").projections[1].R.shape) == (600, 30)
