"""The rest of the model API on the port against ``gpsig_tpu`` (d=2, M=3,
6 inducing tensors or sequences, N=5, L=6, float64): Gaussian regression
with a fixed or trainable noise variance and each mean function (``Zero``,
``Constant``, ``Linear``) -- the loss, every leaf's gradient (``lik/variance``
and ``mean/*`` included, carried by ``convert``), ``predict_y`` and
``predict_log_density``; the Gaussian likelihood's own methods; the public
``K_tens`` / ``K_tens_vs_seq`` and ``InducingTensors.Kuu`` / ``Kuf``; and
``predict_f_samples``: its shape, its samples replayed from the same
generator, and their moments.

Tolerance: 1e-8 relative against JAX (the loss to itself, gradients to the
largest leaf's, the rest to their largest entry); sample moments within 5
standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu_torch import convert
from test_torch_inducing_sequences import _leaf
from test_torch_low_rank_ops import _close

D, M, NZ, LZ, N, L = 2, 3, 6, 4, 5, 6
TOL = 1e-8


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, L, D).cumsum(axis=1) * 0.3
    Y = np.sin(X[:, -1, :1] * 2.0) + 0.1 * rng.randn(n, 1)
    return X, Y


def _mean_functions(name):
    if name == "zero":
        return G.mean_functions.Zero(), T.mean_functions.Zero()
    if name == "constant":
        return (G.mean_functions.Constant(value=0.3),
                T.mean_functions.Constant(value=0.3, dtype=torch.float64,
                                          device="cpu"))
    return (G.mean_functions.Linear(L * D),
            T.mean_functions.Linear(L * D, dtype=torch.float64, device="cpu"))


def _setup(kind="tensors", mean="linear", trainable=True):
    """A Gaussian-likelihood SVGP in both packages with perturbed float64
    parameters (noise variance 0.3), the mean function ``mean``."""
    X, _ = _data(20)
    rng = np.random.RandomState(1)
    if kind == "tensors":
        Z = G.utils.suggest_initial_inducing_tensors(X, M, NZ,
                                                     increments=True, seed=0)
        jind = G.InducingTensors(Z, M, increments=True)
        tind = T.InducingTensors(Z, M, increments=True, dtype=torch.float64,
                                 device="cpu")
    else:
        Z = G.utils.suggest_initial_inducing_sequences(X, NZ, LZ, seed=0)
        jind = G.InducingSequences(Z, M)
        tind = T.InducingSequences(Z, M, dtype=torch.float64, device="cpu")
    ls = G.utils.suggest_initial_lengthscales(X)
    jmean, tmean = _mean_functions(mean)
    jmodel = G.SVGP(G.kernels.SignatureRBF(D, M, lengthscales=ls), jind,
                    G.likelihoods.Gaussian(0.3, trainable=trainable),
                    num_latent=1, num_data=40, mean_function=jmean)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["ind"]["Z"] = params["ind"]["Z"] + rng.randn(*Z.shape) * 0.05
    params["q_mu"] = jnp.asarray(rng.randn(NZ, 1) * 0.7)
    params["q_sqrt"] = jnp.asarray(np.tril(rng.randn(1, NZ, NZ)) * 0.1
                                   + 0.6 * np.eye(NZ))
    if "mean" in params:
        params["mean"] = {k: v + rng.randn(*v.shape) * 0.1
                          for k, v in params["mean"].items()}
    tmodel = T.SVGP(T.kernels.SignatureRBF(D, M, lengthscales=ls,
                                           dtype=torch.float64, device="cpu"),
                    tind, T.likelihoods.Gaussian(
                        0.3, trainable=trainable, dtype=torch.float64,
                        device="cpu"),
                    num_latent=1, num_data=40, mean_function=tmean,
                    device="cpu")
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


@pytest.mark.parametrize("kind,mean,trainable", [
    ("tensors", "linear", True), ("sequences", "constant", False),
    ("tensors", "zero", True)])
def test_gaussian_regression_loss_gradients_and_predictions(kind, mean,
                                                            trainable):
    jmodel, params, tmodel = _setup(kind, mean, trainable)
    leaves = convert.named_leaves(tmodel)
    assert ("lik/variance" in leaves) == trainable
    assert {n for n in leaves if n.startswith("mean/")} == {
        "mean/" + k for k in params.get("mean", {})}
    tree = convert.to_numpy_tree(tmodel)
    for name in leaves:
        np.testing.assert_array_equal(_leaf(tree, name), _leaf(params, name))
    X, Y = _data()
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(params, X, Y)
    tmodel.zero_grad(set_to_none=True)
    tloss = tmodel.loss(torch.from_numpy(X), torch.from_numpy(Y))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL * abs(float(jloss))
    scale = max(float(np.max(np.abs(_leaf(jgrads, n)))) for n in leaves)
    for name, p in leaves.items():
        assert np.any(p.grad.numpy() != 0), name
        assert float(np.max(np.abs(p.grad.numpy() - _leaf(jgrads, name)))) <= (
            TOL * scale), name
    with torch.no_grad():
        ty = tmodel.predict_y(torch.from_numpy(X))
        tlp = tmodel.predict_log_density(torch.from_numpy(X),
                                         torch.from_numpy(Y))
    for a, b in zip(jax.jit(jmodel.predict_y)(params, X), ty):
        _close(a, b)
    _close(jax.jit(jmodel.predict_log_density)(params, X, Y), tlp)


def test_gaussian_likelihood_methods():
    """Fixed and trainable noise: ``init_params``, ``variance_of``,
    ``bind`` and the three closed forms against JAX's."""
    rng = np.random.RandomState(2)
    Fmu, Fvar, Y = rng.randn(4, 2), rng.rand(4, 2) + 0.1, rng.randn(4, 2)
    for trainable in (False, True):
        jl = G.likelihoods.Gaussian(0.4, num_latent=2, trainable=trainable)
        tl = T.likelihoods.Gaussian(0.4, num_latent=2, trainable=trainable,
                                    dtype=torch.float64, device="cpu")
        jp = jl.init_params(dtype=jnp.float64)
        tp = tl.init_params(torch.float64, "cpu")
        assert set(jp) == set(tp) == ({"variance"} if trainable else set())
        for k in jp:
            _close(jp[k], tp[k])
        raw = {"variance": np.array(-0.3)} if trainable else {}
        jb = jl.bind({k: jnp.asarray(v) for k, v in raw.items()})
        tb = tl.bind({k: torch.from_numpy(v) for k, v in raw.items()})
        f64 = dict(dtype=torch.float64)
        _close(jl.variance_of(jp), torch.as_tensor(tl.variance_of(), **f64))
        _close(jb.variance_of({}), torch.as_tensor(tb.variance_of(), **f64))
        for j, t in ((jl, tl), (jb, tb)):
            args = [torch.from_numpy(a) for a in (Fmu, Fvar)]
            _close(j.variational_expectations(Fmu, Fvar, Y),
                   t.variational_expectations(*args, torch.from_numpy(Y)))
            for a, b in zip(j.predict_mean_and_var(Fmu, Fvar),
                            t.predict_mean_and_var(*args)):
                _close(a, torch.as_tensor(b, **f64).expand(4, 2))
            _close(j.predict_log_density(Fmu, Fvar, Y),
                   t.predict_log_density(*args, torch.from_numpy(Y)))


def test_public_K_tens_and_K_tens_vs_seq():
    """Full rank, with and without increments and normalization: the
    public covariances of inducing tensors (K1 and K3 on the card; their
    plain versions here)."""
    X, _ = _data()
    rng = np.random.RandomState(3)
    for increments in (True, False):
        Z = rng.randn(M * (M + 1) // 2, NZ, *((2,) if increments else ()), D)
        for normalization in (True, False):
            jk = G.kernels.SignatureRBF(D, M, normalization=normalization,
                                        lengthscales=[0.7, 1.2])
            p = jk.init_params()
            tk = T.kernels.SignatureRBF(D, M, normalization=normalization,
                                        lengthscales=[0.7, 1.2],
                                        dtype=torch.float64, device="cpu")
            want = jax.jit(lambda p, z, x: (
                jk.K_tens(p, z, increments=increments, return_levels=True),
                jk.K_tens_vs_seq(p, z, x, increments=increments)))(p, Z, X)
            with torch.no_grad():
                got = (tk.K_tens(torch.from_numpy(Z), increments=increments,
                                 return_levels=True),
                       tk.K_tens_vs_seq(torch.from_numpy(Z),
                                        torch.from_numpy(X),
                                        increments=increments))
            for a, b in zip(want, got):
                _close(a, b)


@pytest.mark.parametrize("learn_weights", [False, True])
def test_inducing_tensors_Kuu_and_Kuf(learn_weights):
    X, _ = _data()
    Z = G.utils.suggest_initial_inducing_tensors(_data(20)[0], M, NZ,
                                                 increments=True, seed=0)
    jind = G.InducingTensors(Z, M, increments=True,
                             learn_weights=learn_weights)
    tind = T.InducingTensors(Z, M, increments=True,
                             learn_weights=learn_weights,
                             dtype=torch.float64, device="cpu")
    jk = G.kernels.SignatureRBF(D, M, lengthscales=[0.9, 1.1])
    tk = T.kernels.SignatureRBF(D, M, lengthscales=[0.9, 1.1],
                                dtype=torch.float64, device="cpu")
    ip = jind.init_params(dtype=jnp.float64)
    if learn_weights:
        ip["W"] = ip["W"] + np.random.RandomState(4).randn(M, NZ, NZ) * 0.1
        with torch.no_grad():
            tind.W.copy_(torch.from_numpy(np.array(ip["W"])))
    kp = jk.init_params()
    want = jax.jit(lambda ip, kp, x: (
        jind.Kuu(ip, jk, kp, jitter=1e-6), jind.Kuf(ip, jk, kp, x),
        jind.Kuu_Kuf_Kff(ip, jk, kp, x, jitter=1e-6)))(ip, kp, X)
    with torch.no_grad():
        Xt = torch.from_numpy(X)
        got = (tind.Kuu(tk, jitter=1e-6), tind.Kuf(tk, Xt),
               tind.Kuu_Kuf_Kff(tk, Xt, jitter=1e-6))
    _close(want[0], got[0])
    _close(want[1], got[1])
    for a, b in zip(want[2], got[2]):
        _close(a, b)
    _close(want[2][0], got[0])  # Kuu is Kuu_Kuf_Kff's Kzz
    _close(want[2][1], got[1])


@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_f_samples(full_cov):
    """(S, N, P) samples: replayed from a generator seeded alike, they are
    JAX's predictive mean plus its marginal standard deviation (or the
    Cholesky factor of its jittered covariance) times the generator's
    normals; their mean and (co)variance lie within 5 standard errors of
    ``predict_f``'s.  A call without a ``torch.Generator`` raises, as
    JAX's without a key does."""
    jmodel, params, tmodel = _setup("tensors", "linear", True)
    X, _ = _data()
    S = 20000
    with torch.no_grad():
        got = tmodel.predict_f_samples(
            torch.from_numpy(X), num_samples=S, full_cov=full_cov,
            generator=torch.Generator().manual_seed(7))
        with pytest.raises(ValueError, match="torch.Generator"):
            tmodel.predict_f_samples(torch.from_numpy(X))
    assert tuple(got.shape) == (S, N, 1)
    jmean, jvar = jax.jit(lambda p, x: jmodel.predict_f(
        p, x, full_cov=full_cov))(params, X)
    jmean, jvar = np.asarray(jmean), np.asarray(jvar)
    g = torch.Generator().manual_seed(7)
    if full_cov:
        eps = torch.randn((S, 1, N), generator=g, dtype=torch.float64)
        chol = np.linalg.cholesky(jvar + 1e-6 * np.eye(N))  # (P, N, N)
        want = np.einsum("pnm,spm->snp", chol, eps.numpy()) + jmean[None]
        _close(want, got)
        cov = np.cov(got.numpy()[:, :, 0].T)
        var = np.diagonal(jvar[0])
        # the standard error of a sample covariance
        se = np.sqrt((np.outer(var, var) + jvar[0] ** 2) / S)
        assert np.all(np.abs(cov - jvar[0] - 1e-6 * np.eye(N)) <= 5 * se)
    else:
        eps = torch.randn((S, N, 1), generator=g, dtype=torch.float64)
        _close(jmean[None] + np.sqrt(jvar)[None] * eps.numpy(), got)
        var = jvar[:, 0]
        sample_var = got.numpy()[:, :, 0].var(axis=0, ddof=1)
        assert np.all(np.abs(sample_var - var) <= 5 * var * np.sqrt(2 / S))
    sample_mean = got.numpy()[:, :, 0].mean(axis=0)
    assert np.all(np.abs(sample_mean - jmean[:, 0]) <= 5 * np.sqrt(var / S))
