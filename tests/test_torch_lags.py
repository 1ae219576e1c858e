"""Lags in the port against ``gpsig_tpu``: ``ops/lags.py`` and a
``SignatureKernel`` with ``num_lags`` (d=2, M=2, 6 inducing tensors or
sequences of length 3, 5 examples of 7 steps).

Tolerances at float64: <= 1e-12 * max(|ref|, 1) for the interpolation
(the port contracts a weight matrix where the JAX package gathers, another
rounding order); <= 1e-9 * max(|ref|, 1) for the covariances (the port's
Kzz/Kzx take the kernel algebra, JAX's reference graph another order).
Inputs come from a numpy seed; the lags and gamma are moved off their
initial values in the JAX parameters and copied into the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu.ops import lags as jlags
from gpsig_tpu_torch import convert
from gpsig_tpu_torch.ops import lags as tlags

D, M, NZ, C = 2, 2, 6, 3


def _close(j, t, tol):
    j = np.asarray(j, dtype=np.float64)
    t = t.detach().numpy().astype(np.float64)
    assert j.shape == t.shape
    scale = max(float(np.max(np.abs(j))), 1.0)
    assert float(np.max(np.abs(j - t))) <= tol * scale


def _paths(n, L, seed):
    return np.random.RandomState(seed).randn(n, L, D).cumsum(axis=1) * 0.3


def test_lin_interp():
    """Times and query times shared by the sequences, then per sequence;
    queries outside the sample range are clamped."""
    rng = np.random.RandomState(0)
    X = rng.randn(4, 9, 3)
    for times, query in (
            (np.sort(rng.rand(9)), rng.uniform(-0.2, 1.2, 6)),
            (np.sort(rng.rand(4, 9), axis=1), rng.uniform(-0.2, 1.2, (4, 6)))):
        want = jax.jit(jlags.lin_interp)(X, times, query)
        got = tlags.lin_interp(torch.from_numpy(X), torch.from_numpy(times),
                               torch.from_numpy(query))
        _close(want, got, 1e-12)


def test_lin_interp_uniform_and_its_gradients():
    rng = np.random.RandomState(1)
    X = rng.randn(3, 11, 2)
    q = rng.rand(11, 2)
    ct = rng.randn(3, 11, 2, 2)
    want, vjp = jax.vjp(jlags.lin_interp_uniform, jnp.asarray(X),
                        jnp.asarray(q))
    gX, gq = vjp(jnp.asarray(ct))
    tX = torch.from_numpy(X).requires_grad_()
    tq = torch.from_numpy(q).requires_grad_()
    got = tlags.lin_interp_uniform(tX, tq)
    got.backward(torch.from_numpy(ct))
    _close(want, got, 1e-12)
    _close(gX, tX.grad, 1e-12)
    _close(gq, tq.grad, 1e-12)


@pytest.mark.parametrize("num_lags", [1, 2])
def test_add_lags_to_sequences_and_its_gradients(num_lags):
    rng = np.random.RandomState(2 + num_lags)
    X = rng.randn(3, 8, 2)
    lags = rng.uniform(0.05, 0.6, num_lags)
    ct = rng.randn(3, 8, num_lags + 1, 2)

    def f(x, lg):
        return jlags.add_lags_to_sequences(x, lg)

    want, vjp = jax.vjp(f, jnp.asarray(X), jnp.asarray(lags))
    gX, gl = vjp(jnp.asarray(ct))
    tX = torch.from_numpy(X).requires_grad_()
    tl = torch.from_numpy(lags).requires_grad_()
    got = tlags.add_lags_to_sequences(tX, tl)
    got.backward(torch.from_numpy(ct))
    _close(want, got, 1e-12)
    _close(gX, tX.grad, 1e-12)
    _close(gl, tl.grad, 1e-12)


def _kernels(num_lags, X):
    ls = G.utils.suggest_initial_lengthscales(X)
    jk = G.kernels.SignatureRBF(D, M, lengthscales=ls, num_lags=num_lags)
    tk = T.kernels.SignatureRBF(D, M, lengthscales=ls, num_lags=num_lags,
                                dtype=torch.float64, device="cpu")
    raw = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                       jk.init_params())
    raw["lags"] = raw["lags"] + 0.4
    raw["gamma"] = raw["gamma"] + 0.2 * np.arange(num_lags + 1)
    with torch.no_grad():
        for name, p in tk.named_parameters():
            p.copy_(torch.from_numpy(np.array(raw[name])))
    return jk, raw, tk


@pytest.mark.parametrize("num_lags", [1, 2])
@pytest.mark.parametrize("kind", ["tensors", "sequences"])
def test_lagged_covariances(kind, num_lags):
    """``K`` (symmetric and cross) and the fused covariances with lags."""
    X = _paths(20, 7, 0)
    Xq = X[:5]
    jk, raw, tk = _kernels(num_lags, X)
    tXq = torch.from_numpy(Xq)
    _close(jax.jit(lambda p, x: jk.K(p, x))(raw, Xq), tk.K(tXq), 1e-9)
    if kind == "tensors":
        Z = G.utils.suggest_initial_inducing_tensors(
            X, M, NZ, increments=True, num_lags=num_lags, seed=0)
        want = jax.jit(lambda p, z, x: jk.K_tens_n_seq_covs(
            p, z, x, increments=True))(raw, Z, Xq)
        got = tk.K_tens_n_seq_covs(torch.from_numpy(Z), tXq, increments=True)
    else:
        Z = G.utils.suggest_initial_inducing_sequences(X, NZ, M + 1, seed=0)
        _close(jax.jit(lambda p, z, x: jk.K(p, z, x))(raw, Z, Xq),
               tk.K(torch.from_numpy(Z), tXq), 1e-9)
        want = jax.jit(lambda p, z, x: jk.K_seq_n_seq_covs(p, z, x))(
            raw, Z, Xq)
        got = tk.K_seq_n_seq_covs(torch.from_numpy(Z), tXq)
    for w, g in zip(want, got):
        _close(w, g, 1e-9)


def test_lag_leaves_and_their_initial_values():
    """``kern/lags`` (sigmoid) and ``kern/gamma`` (positive) exist with
    the JAX package's initial values; ``num_lags`` is validated."""
    jk = G.kernels.SignatureRBF(D, M, num_lags=2)
    tk = T.kernels.SignatureRBF(D, M, num_lags=2, dtype=torch.float64,
                                device="cpu")
    assert tk.bijectors == jk.bijectors
    want = jk.init_params(dtype=jnp.float64)
    got = {n: p.detach().numpy() for n, p in tk.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=1e-15, atol=0)
    cp = {k: v.detach().numpy() for k, v in tk.constrain().items()}
    np.testing.assert_allclose(cp["lags"], [0.1, 0.2])
    np.testing.assert_allclose(cp["gamma"], np.array([1, 1 / 2, 1 / 3])
                               / (11 / 6))
    assert T.kernels.SignatureRBF(D, M, num_lags=0,
                                  device="cpu").num_lags == 0
    with pytest.raises(ValueError, match="num_lags"):
        T.kernels.SignatureRBF(D, M, num_lags=-1, device="cpu")
    tree = convert.to_numpy_tree(T.SVGP(
        tk, T.InducingTensors(np.zeros((3, 4, 2, 3 * D)), M, increments=True,
                              dtype=torch.float64, device="cpu"),
        T.likelihoods.MultiClass(C), num_latent=C, device="cpu"))
    assert {"lags", "gamma"} <= set(tree["kern"])
