"""Every low-rank entry point of the port's ``SignatureKernel`` against
``gpsig_tpu``'s with JAX's draws (d=2, M=3, num_components=3,
rank_bound=4, sparsity 'sqrt' unless named): ``K`` symmetric and cross,
``Kdiag``, ``K_tens``, ``K_tens_vs_seq``, ``K_tens_n_seq_covs`` and
``K_seq_n_seq_covs`` (full and diagonal data covariances), normalized and
not; the refusals copied from JAX; and the draws of a call -- the default
(seed 0, per call), and one draw shared by both sides.

Each test first asserts that both packages' ``eigh`` agree on the
Nystrom Gram of its call (eigenvector signs are each library's own
choice; the Gram of levels >= 2 depends on them).

Tolerance: 1e-8 relative to the largest entry, at float64.
"""

import jax
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from test_torch_low_rank_ops import _close, assert_eigh_agrees, jax_draws

D, M, C, RB = 2, 3, 3, 4
N, L, N2, L2, NZ = 4, 6, 3, 5, 5
LS = np.array([0.8, 1.3])


def _data():
    rng = np.random.RandomState(7)
    X = rng.randn(N, L, D).cumsum(axis=1) * 0.4
    X2 = rng.randn(N2, L2, D).cumsum(axis=1) * 0.4
    Z = rng.randn(M * (M + 1) // 2, NZ, 2, D) * 0.5
    return X, X2, Z


def _kernels(normalization=True, sparsity="sqrt", **kw):
    opts = dict(low_rank=True, num_components=C, rank_bound=RB,
                sparsity=sparsity, lengthscales=LS,
                normalization=normalization, **kw)
    jk = G.kernels.SignatureRBF(D, M, **opts)
    params = jk.init_params()
    params["variances"] = params["variances"] + np.linspace(-0.4, 0.5, M + 1)
    tk = T.kernels.SignatureRBF(D, M, dtype=torch.float64, device="cpu",
                                **opts)
    with torch.no_grad():
        tk.variances.copy_(torch.from_numpy(np.array(params["variances"])))
    return jk, params, tk


def _draws(tk, key, *point_sets, sparsity="sqrt"):
    """JAX's draws of a call over the union of ``point_sets`` (scaled, as
    the kernels see them), after asserting that both ``eigh`` agree on
    its Nystrom Gram."""
    points = torch.cat([p.reshape(-1, D) for p in point_sets])
    draws = jax_draws(key, points.shape[0], C=C, rank_bound=RB, M=M,
                      sparsity=sparsity, joint=len(point_sets) > 1)
    with torch.no_grad():
        lm = points[draws.landmarks]
        W = tk._base_kern(tk.constrain())(lm, lm)
        assert_eigh_agrees(W + torch.diag(1e-6 * draws.jitter))
    return draws


def _scaled(tk, X=None, Z=None):
    cp = tk.constrain()
    with torch.no_grad():
        if Z is not None:
            return tk._scale_tensors(cp, torch.from_numpy(Z))
        return tk._scale_sequences(cp, torch.from_numpy(X))


@pytest.mark.parametrize("normalization", [True, False])
def test_K_symmetric_cross_and_Kdiag(normalization):
    jk, p, tk = _kernels(normalization)
    X, X2, _ = _data()
    key = jax.random.PRNGKey(0)
    Xt, X2t = torch.from_numpy(X), torch.from_numpy(X2)
    with torch.no_grad():
        want = jax.jit(lambda p, x: jk.K(p, x, return_levels=True,
                                         key=key))(p, X)
        _close(want, tk.K(Xt, return_levels=True,
                          generator=_draws(tk, key, _scaled(tk, X))))
        want = jax.jit(lambda p, x, x2: jk.K(p, x, x2, return_levels=True,
                                             key=key))(p, X, X2)
        got = tk.K(Xt, X2t, return_levels=True, generator=_draws(
            tk, key, _scaled(tk, X), _scaled(tk, X2)))
        _close(want, got)
        want = jax.jit(lambda p, x: jk.Kdiag(p, x, return_levels=True,
                                             key=key))(p, X)
        _close(want, tk.Kdiag(Xt, return_levels=True,
                              generator=_draws(tk, key, _scaled(tk, X))))


@pytest.mark.parametrize("increments", [True, False])
def test_K_tens_and_K_tens_vs_seq(increments):
    jk, p, tk = _kernels()
    X, _, Z = _data()
    if not increments:
        Z = Z[:, :, 0]
    key = jax.random.PRNGKey(5)
    Xt, Zt = torch.from_numpy(X), torch.from_numpy(Z)
    with torch.no_grad():
        want = jax.jit(lambda p, z: jk.K_tens(
            p, z, increments=increments, return_levels=True, key=key))(p, Z)
        _close(want, tk.K_tens(Zt, increments=increments, return_levels=True,
                               generator=_draws(tk, key, _scaled(tk, Z=Z))))
        want = jax.jit(lambda p, z, x: jk.K_tens_vs_seq(
            p, z, x, increments=increments, return_levels=True,
            key=key))(p, Z, X)
        got = tk.K_tens_vs_seq(Zt, Xt, increments=increments,
                               return_levels=True, generator=_draws(
                                   tk, key, _scaled(tk, Z=Z), _scaled(tk, X)))
        _close(want, got)


@pytest.mark.parametrize("full_X_cov", [True, False])
def test_K_tens_n_seq_covs(full_X_cov):
    """The model's covariances: Kzz, Kzx and Kxx from one call's draws,
    normalized (with a 'lin' kernel, unnormalized, too)."""
    X, _, Z = _data()
    key = jax.random.PRNGKey(2)
    for normalization, sparsity in ((True, "sqrt"), (False, "lin")):
        jk, p, tk = _kernels(normalization, sparsity)
        want = jax.jit(lambda p, z, x: jk.K_tens_n_seq_covs(
            p, z, x, full_X_cov=full_X_cov, increments=True,
            return_levels=True, key=key))(p, Z, X)
        with torch.no_grad():
            got = tk.K_tens_n_seq_covs(
                torch.from_numpy(Z), torch.from_numpy(X),
                full_X_cov=full_X_cov, increments=True, return_levels=True,
                generator=_draws(tk, key, _scaled(tk, Z=Z), _scaled(tk, X),
                                 sparsity=sparsity))
        for w, g in zip(want, got):
            _close(w, g)


def test_K_seq_n_seq_covs():
    """Inducing sequences: Kzz, Kzx and Kxx (full and diagonal)."""
    jk, p, tk = _kernels()
    X, X2, _ = _data()
    key = jax.random.PRNGKey(3)
    for full in (True, False):
        want = jax.jit(lambda p, a, b: jk.K_seq_n_seq_covs(
            p, a, b, full_X2_cov=full, return_levels=True, key=key))(p, X2, X)
        with torch.no_grad():
            got = tk.K_seq_n_seq_covs(
                torch.from_numpy(X2), torch.from_numpy(X), full_X2_cov=full,
                return_levels=True, generator=_draws(
                    tk, key, _scaled(tk, X2), _scaled(tk, X)))
        for w, g in zip(want, got):
            _close(w, g)


def test_refusals_copied_from_jax():
    """order > 1, an unknown sparsity, a non-positive num_components or
    rank_bound, and ``K_blocked`` on a low-rank kernel raise as in JAX."""
    for mod, kw in ((G.kernels, {}), (T.kernels, dict(device="cpu"))):
        with pytest.raises(NotImplementedError, match="order == 1"):
            mod.SignatureRBF(D, M, order=2, low_rank=True, **kw)
        with pytest.raises(ValueError, match="unknown sparsity"):
            mod.SignatureRBF(D, M, low_rank=True, sparsity="dense", **kw)
        with pytest.raises(ValueError, match="num_components"):
            mod.SignatureRBF(D, M, low_rank=True, num_components=0, **kw)
        with pytest.raises(ValueError, match="rank_bound"):
            mod.SignatureRBF(D, M, low_rank=True, rank_bound=-1, **kw)
    _, p, tk = _kernels()
    X = torch.from_numpy(_data()[0])
    with pytest.raises(ValueError, match="use K"):
        tk.K_blocked(X)
    with pytest.raises(ValueError, match="use K"):
        G.kernels.SignatureRBF(D, M, low_rank=True).K_blocked(p, _data()[0])
    assert tk.rank_bound == RB
    assert T.kernels.SignatureRBF(D, M, low_rank=True, num_components=7,
                                  device="cpu").rank_bound == 7


def test_draws_default_and_shared():
    """``generator=None`` draws from a generator seeded with 0, made per
    call: each call gives the same Gram, bit for bit, as one seeded with 0
    by hand, and another seed another Gram.  One call's draws serve both
    sides: its cross Gram of X with itself is the symmetric Gram of X
    (landmarks from the union, one Nystrom basis, one projection a
    depth)."""
    _, _, tk = _kernels(normalization=False)
    X, _, Z = _data()
    Xt, Zt = torch.from_numpy(X), torch.from_numpy(Z)
    with torch.no_grad():
        a = tk.K_tens_n_seq_covs(Zt, Xt, increments=True)
        b = tk.K_tens_n_seq_covs(Zt, Xt, increments=True)
        c = tk.K_tens_n_seq_covs(Zt, Xt, increments=True,
                                 generator=torch.Generator().manual_seed(0))
        d = tk.K_tens_n_seq_covs(Zt, Xt, increments=True,
                                 generator=torch.Generator().manual_seed(1))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(torch.equal(x, y) for x, y in zip(a, c))
        assert not torch.equal(a[1], d[1])
        draws = tk._lr_draws(torch.Generator().manual_seed(5), 2 * N * L,
                             Xt)
        draws.landmarks = draws.landmarks % (N * L)  # all from X's points
        cross = tk.K(Xt, Xt, return_levels=True, generator=draws)
        sym = tk.K(Xt, return_levels=True, generator=draws)
    _close(sym.numpy(), cross, 1e-12)
