"""The serving slice of the port against ``gpsig_tpu`` at small width
(d=3, M=3, nZ=12, C=4, N=5, L=20): parameters from a JAX
``SVGP.init_params()`` with perturbed Z / q_mu / q_sqrt, loaded through
``convert.load_jax_params``; then covariance levels, ``Kuu_Kuf_Kff``,
``predict_f`` and ``predict_y``; and the bucketed ``Predictor``.

Tolerances: <= 1e-9 at float64 against JAX (both run the reference
algebra; the port's Kzz/Kzx take the kernel algebra); <= 1e-4 at float32
against JAX's f32 closed-form graph (different exp/expm1 and summation
orders, amplified by the Cholesky solves); <= 1e-10 bucketed vs direct at
float64 (padding is exact).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu_torch import convert

RNG = np.random.RandomState(11)
D, M, NZ, C, N, L = 3, 3, 12, 4, 5, 20
TOL = {np.float64: 1e-9, np.float32: 1e-4}


def _setup(dtype, *, fused="auto", learn_weights=False, normalization=True,
           difference=True):
    rng = np.random.RandomState(0)
    X = rng.randn(30, L, D).cumsum(axis=1) * 0.3
    y = np.arange(30) % C
    Z = G.utils.suggest_initial_inducing_tensors(
        X, M, NZ, labels=y, increments=True, seed=0)
    ls = G.utils.suggest_initial_lengthscales(X)
    opts = dict(lengthscales=ls, normalization=normalization,
                difference=difference)
    jkern = G.kernels.SignatureRBF(D, M, **opts)
    jind = G.InducingTensors(Z, M, increments=True,
                             learn_weights=learn_weights)
    jmodel = G.SVGP(jkern, jind, G.likelihoods.MultiClass(C), num_latent=C)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    params = jax.tree.map(lambda a: jnp.asarray(a, jdt),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["ind"]["Z"] = params["ind"]["Z"] + jnp.asarray(
        rng.randn(*Z.shape) * 0.05, jdt)
    if learn_weights:
        params["ind"]["W"] = params["ind"]["W"] + jnp.asarray(
            rng.randn(M, NZ, NZ) * 0.1, jdt)
    params["q_mu"] = jnp.asarray(rng.randn(NZ, C) * 0.7, jdt)
    params["q_sqrt"] = jnp.asarray(
        np.tril(rng.randn(C, NZ, NZ)) * 0.1 + 0.6 * np.eye(NZ), jdt)

    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tkern = T.kernels.SignatureRBF(D, M, fused=fused, dtype=tdt,
                                   device="cpu", **opts)
    tind = T.InducingTensors(Z, M, increments=True,
                             learn_weights=learn_weights, dtype=tdt,
                             device="cpu")
    tmodel = T.SVGP(tkern, tind, T.likelihoods.MultiClass(C), num_latent=C,
                    device="cpu")
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel, X[:N].astype(dtype)


def _close(j, t, tol):
    j = np.asarray(j, dtype=np.float64)
    t = t.detach().cpu().numpy().astype(np.float64)
    assert j.shape == t.shape
    assert float(np.max(np.abs(j - t))) <= tol * max(np.max(np.abs(j)), 1.0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_covariance_levels_and_kuu_kuf_kff(dtype):
    jmodel, params, tmodel, Xq = _setup(dtype)
    # JAX through one jax.jit program: eager JAX compiles every op
    jl, jk = jax.jit(lambda p, X: (
        jmodel.kern.K_tens_n_seq_covs(p["kern"], p["ind"]["Z"], X,
                                      increments=True, return_levels=True),
        jmodel.ind.Kuu_Kuf_Kff(p["ind"], jmodel.kern, p["kern"], X,
                               jitter=1e-6)))(params, jnp.asarray(Xq))
    with torch.no_grad():
        tl = tmodel.kern.K_tens_n_seq_covs(
            tmodel.ind.Z, torch.from_numpy(Xq), increments=True,
            return_levels=True)
        tk = tmodel.ind.Kuu_Kuf_Kff(tmodel.kern, torch.from_numpy(Xq),
                                    jitter=1e-6)
    for a, b in zip(jl, tl):
        _close(a, b, TOL[dtype])
    for a, b in zip(jk, tk):
        _close(a, b, TOL[dtype])


def test_fused_auto_matches_off_and_on_raises_on_cpu():
    _, _, auto, Xq = _setup(np.float64)
    _, _, off, _ = _setup(np.float64, fused="off")
    Xt = torch.from_numpy(Xq)
    with torch.no_grad():
        for a, b in zip(auto.predict_y(Xt), off.predict_y(Xt)):
            assert float((a - b).abs().max()) <= 1e-9
    _, _, on, _ = _setup(np.float32, fused="on")
    with pytest.raises(ValueError, match="fused='on'"):
        on.predict_y(torch.from_numpy(Xq.astype(np.float32)))


def test_outside_the_slice_raises():
    """Every base, ``K_blocked``, low-rank features and mean functions are
    ported now; what is left raises as the JAX package does: low-rank
    features at order > 1, an unknown sparsity, and ``K_blocked`` on a
    low-rank kernel."""
    with pytest.raises(NotImplementedError, match="order == 1"):
        T.kernels.SignatureRBF(D, M, order=2, low_rank=True, device="cpu")
    with pytest.raises(ValueError, match="unknown sparsity"):
        T.kernels.SignatureRBF(D, M, low_rank=True, sparsity="dense",
                               device="cpu")
    _, _, tmodel, Xq = _setup(np.float64)
    kern = T.kernels.SignatureRBF(D, M, low_rank=True, dtype=torch.float64,
                                  device="cpu")
    with pytest.raises(ValueError, match="use K"):
        kern.K_blocked(torch.from_numpy(Xq))


def test_converter_round_trip():
    jmodel, params, tmodel, _ = _setup(np.float64)
    tree = convert.to_numpy_tree(tmodel)
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(leaf), flat_t[path])
    # JAX's fresh init and the port's agree leaf by leaf
    fresh_j = jmodel.init_params()
    fresh_t = jax.tree.map(lambda t: t.numpy(),
                           tmodel.init_params(torch.float64, "cpu"))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(fresh_j),
                                 jax.tree_util.tree_leaves_with_path(fresh_t)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-15, atol=0,
                                   err_msg=str(path))
    bad = dict(tree, extra=np.zeros(1))
    with pytest.raises(ValueError, match="parameter trees differ"):
        convert.load_jax_params(tmodel, bad)


class TestPredictor:
    def test_bucketed_matches_direct_across_two_buckets(self):
        _, _, tmodel, _ = _setup(np.float64)
        rng = np.random.RandomState(5)
        pred = T.serving.Predictor(tmodel, len_buckets=(12, 24),
                                   batch_buckets=(2, 8), device="cpu")
        pred.warmup(D)
        for n, l in ((1, 9), (3, 20), (6, 12)):  # two length buckets
            Xq = rng.randn(n, l, D).cumsum(axis=1) * 0.3
            mean, var = pred.predict_y(Xq)
            with torch.no_grad():
                ref_mean, ref_var = tmodel.predict_y(torch.from_numpy(Xq))
            assert mean.shape == (n, C)
            assert float((mean - ref_mean).abs().max()) <= 1e-10
            assert float((var - ref_var).abs().max()) <= 1e-10
            fmean, _ = pred.predict_f(Xq)
            with torch.no_grad():
                ref_f, _ = tmodel.predict_f(torch.from_numpy(Xq))
            assert float((fmean - ref_f).abs().max()) <= 1e-10
            assert torch.equal(pred.predict_classes(Xq),
                               torch.argmax(ref_mean, dim=1))

    def test_shape_guards(self):
        _, _, tmodel, Xq = _setup(np.float64)
        pred = T.serving.Predictor(tmodel, max_len=L, batch_buckets=(2,),
                                   device="cpu")
        with pytest.raises(ValueError, match="exceeds the largest"):
            pred.predict_y(Xq)  # 5 rows > bucket 2
        with pytest.raises(ValueError, match="exceeds the largest"):
            pred.predict_y(np.concatenate([Xq[:1]] * 2, axis=1))
