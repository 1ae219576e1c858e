"""The seq x seq modules of the port against ``gpsig_tpu`` at small width
(d=2, M=2, 6 inducing sequences of length 3, C=3, N=5, L=7): ``K()`` with
and without X2, normalized or not, ``Kdiag``, ``K_seq_n_seq_covs``, an
``InducingSequences`` SVGP's loss, every leaf's gradient and ``predict_y``,
``predict_f(full_cov=True)`` for both inducing kinds, the inducing-sequence
initialization, and the bucketed ``Predictor`` and ``training.optimize`` on
an ``InducingSequences`` model.  Parameters come from a JAX
``SVGP.init_params()``, perturbed, carried by ``convert.load_jax_params``.

Tolerances, as ``tests/test_torch_training.py`` holds the tensor model:
<= 1e-9 at float64 (the port runs K5/K6's plain algebra, JAX its reference
graph), relative to the largest entry (for gradients, of any leaf:
``kern/sigma``'s is a cancellation); <= 1e-4 for the port at float32
against JAX at float64; <= 1e-10 bucketed vs direct; <= 1e-8 relative for
a loss history of optimizer steps at float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu_torch import convert

D, M, NZ, LZ, C, N, L = 2, 2, 6, 3, 3, 5, 7


def _data(n=N, seed=0, length=L):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, length, D).cumsum(axis=1) * 0.3
    Y = (np.arange(n) % C).astype(np.float64)[:, None]
    return X, Y


def _setup(tdt=torch.float64, *, learn_weights=False, whiten=True,
           normalization=True, fused="auto", num_data=None):
    """JAX InducingSequences SVGP with perturbed float64 parameters, and the
    port's model at ``tdt`` carrying them."""
    X, Y = _data(20)
    rng = np.random.RandomState(1)
    Z = G.utils.suggest_initial_inducing_sequences(
        X, NZ, LZ, labels=Y[:, 0].astype(int), seed=0)
    ls = G.utils.suggest_initial_lengthscales(X)
    kopts = dict(lengthscales=ls, normalization=normalization)
    opts = dict(num_latent=C, num_data=num_data, whiten=whiten)
    jmodel = G.SVGP(G.kernels.SignatureRBF(D, M, **kopts),
                    G.InducingSequences(Z, M, learn_weights=learn_weights),
                    G.likelihoods.MultiClass(C), **opts)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["ind"]["Z"] = params["ind"]["Z"] + rng.randn(*Z.shape) * 0.05
    params["kern"]["variances"] = jnp.asarray(rng.randn(M + 1) * 0.3)
    if learn_weights:
        params["ind"]["W"] = params["ind"]["W"] + rng.randn(M, NZ, NZ) * 0.1
    params["q_mu"] = jnp.asarray(rng.randn(NZ, C) * 0.7)
    params["q_sqrt"] = jnp.asarray(
        np.tril(rng.randn(C, NZ, NZ)) * 0.1 + 0.6 * np.eye(NZ))
    tmodel = T.SVGP(
        T.kernels.SignatureRBF(D, M, fused=fused, dtype=tdt, device="cpu",
                               **kopts),
        T.InducingSequences(Z, M, learn_weights=learn_weights, dtype=tdt,
                            device="cpu"),
        T.likelihoods.MultiClass(C), device="cpu", **opts)
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


def _close(want, got, tol):
    want = np.asarray(want, dtype=np.float64)
    got = (got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got)).astype(np.float64)
    assert want.shape == got.shape
    assert float(np.max(np.abs(want - got))) <= tol * max(
        float(np.max(np.abs(want))), 1e-300)


def _leaf(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return np.asarray(tree, dtype=np.float64)


@pytest.mark.parametrize("normalization", [True, False])
def test_K_and_Kdiag(normalization):
    jmodel, params, tmodel = _setup(normalization=normalization)
    jk, kp = jmodel.kern, params["kern"]
    X, _ = _data()
    X2, _ = _data(4, seed=2, length=9)  # L1 != L2
    tk = tmodel.kern
    with torch.no_grad():
        pairs = [
            (jax.jit(lambda p, x: jk.K(p, x, return_levels=True))(
                kp, X), tk.K(torch.from_numpy(X), return_levels=True)),
            (jax.jit(lambda p, x, y: jk.K(p, x, y))(kp, X, X2),
             tk.K(torch.from_numpy(X), torch.from_numpy(X2))),
            (jax.jit(jk.Kdiag)(kp, X), tk.Kdiag(torch.from_numpy(X))),
        ]
    for want, got in pairs:
        _close(want, got, 1e-9)
    K = pairs[0][1]
    assert torch.equal(K, K.transpose(1, 2))


@pytest.mark.parametrize("full", [True, False])
def test_K_seq_n_seq_covs(full):
    jmodel, params, tmodel = _setup()
    X, _ = _data()
    want, jkuu = jax.jit(lambda p, x: (
        jmodel.kern.K_seq_n_seq_covs(p["kern"], p["ind"]["Z"], x,
                                     full_X2_cov=full, return_levels=True),
        jmodel.ind.Kuu_Kuf_Kff(p["ind"], jmodel.kern, p["kern"], x,
                               jitter=1e-6, full_f_cov=full)))(params, X)
    with torch.no_grad():
        got = tmodel.kern.K_seq_n_seq_covs(tmodel.ind.Z, torch.from_numpy(X),
                                           full_X2_cov=full,
                                           return_levels=True)
        kuu = tmodel.ind.Kuu_Kuf_Kff(tmodel.kern, torch.from_numpy(X),
                                     jitter=1e-6, full_f_cov=full)
    for a, b in zip(want, got):
        _close(a, b, 1e-9)
    for a, b in zip(jkuu, kuu):
        _close(a, b, 1e-9)
    with torch.no_grad():
        _close(jkuu[0], tmodel.ind.Kuu(tmodel.kern, jitter=1e-6), 1e-9)
        _close(jkuu[1], tmodel.ind.Kuf(tmodel.kern, torch.from_numpy(X)),
               1e-9)


def _tensor_model():
    X, Y = _data(20)
    rng = np.random.RandomState(3)
    Z = G.utils.suggest_initial_inducing_tensors(
        X, M, NZ, labels=Y[:, 0].astype(int), increments=True, seed=0)
    ls = G.utils.suggest_initial_lengthscales(X)
    jmodel = G.SVGP(G.kernels.SignatureRBF(D, M, lengthscales=ls),
                    G.InducingTensors(Z, M, increments=True),
                    G.likelihoods.MultiClass(C), num_latent=C)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["q_mu"] = jnp.asarray(rng.randn(NZ, C) * 0.7)
    params["q_sqrt"] = jnp.asarray(
        np.tril(rng.randn(C, NZ, NZ)) * 0.1 + 0.6 * np.eye(NZ))
    tmodel = T.SVGP(
        T.kernels.SignatureRBF(D, M, lengthscales=ls, dtype=torch.float64,
                               device="cpu"),
        T.InducingTensors(Z, M, increments=True, dtype=torch.float64,
                          device="cpu"),
        T.likelihoods.MultiClass(C), num_latent=C, device="cpu")
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


@pytest.mark.parametrize("kind", ["sequences", "tensors"])
def test_predict_f_full_cov(kind):
    jmodel, params, tmodel = _setup() if kind == "sequences" else (
        _tensor_model())
    X, _ = _data()
    want = jax.jit(lambda p, x: jmodel.predict_f(p, x, full_cov=True))(
        params, X)
    with torch.no_grad():
        mean, cov = tmodel.predict_f(torch.from_numpy(X), full_cov=True)
        _, var = tmodel.predict_f(torch.from_numpy(X))
    assert cov.shape == (C, N, N)
    _close(want[0], mean, 1e-9)
    _close(want[1], cov, 1e-9)
    # the covariance's diagonal is the marginal variance
    assert float((torch.diagonal(cov, dim1=1, dim2=2).T - var).abs().max()
                 ) <= 1e-10


@pytest.mark.parametrize("labels", [True, False])
def test_suggest_initial_inducing_sequences(labels):
    X, Y = _data(30, length=12)
    X[3, 8:] = np.nan  # windows end before the first NaN
    y = Y[:, 0].astype(int) if labels else None
    want = G.utils.suggest_initial_inducing_sequences(X, 11, 4, labels=y,
                                                      seed=5)
    got = T.utils.suggest_initial_inducing_sequences(X, 11, 4, labels=y,
                                                     seed=5)
    np.testing.assert_array_equal(got, want)
