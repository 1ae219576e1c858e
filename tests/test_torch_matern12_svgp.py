"""The matern12 slice as a whole: a small ``SignatureMatern12`` SVGP of the
port (d=2, M=2, 6 inducing tensors or 6 inducing sequences of length 3,
MultiClass C=3) against ``gpsig_tpu`` with the same numpy-seeded weights,
carried by ``convert.load_jax_params``: the loss, every leaf's gradient and
``predict_y``; the bucketed ``Predictor`` (repeat padding, no lags); the
variant's aliases and the parameter layout.

Tolerances against JAX at float64, (loss relative, each leaf's gradient
relative to the largest, predictions relative to their largest) = ``TOL``:
the port's covariances take the kernels' closed forms, JAX's reference
graphs the naive second difference, and Kzz's self-pairs sit at the |.|
kink of exp(-r), where both are sqrt(eps)-limited (1.5e-8 at float64,
3.5e-4 at float32) before the Cholesky solves amplify it.  Read: at
float64 2e-11 / 8e-9 (ind/Z) / 2e-9, at float32 2e-6 / 2.2e-4 (ind/Z) /
4.2e-5.  The Predictor's answers within 1e-10 of the model's at float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu_torch import convert
from test_torch_inducing_sequences import _close, _leaf

D, M, NZ, LZ, C, N, L = 2, 2, 6, 3, 3, 5, 7
TOL = {torch.float64: (1e-9, 5e-8, 1e-8), torch.float32: (1e-5, 5e-4, 1e-4)}


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, L, D).cumsum(axis=1) * 0.3
    return X, (np.arange(n) % C).astype(np.float64)[:, None]


def _setup(kind, tdt=torch.float64):
    """JAX SignatureMatern12 SVGP with inducing ``kind`` ('tensors' or
    'sequences') and perturbed float64 parameters, and the port's model at
    ``tdt`` carrying them."""
    X, Y = _data(20)
    labels = Y[:, 0].astype(int)
    rng = np.random.RandomState(1)
    if kind == "tensors":
        Z = G.utils.suggest_initial_inducing_tensors(
            X, M, NZ, labels=labels, increments=True, seed=0)
        jind = G.InducingTensors(Z, M, increments=True)
        tind = T.InducingTensors(Z, M, increments=True, dtype=tdt,
                                 device="cpu")
    else:
        Z = G.utils.suggest_initial_inducing_sequences(
            X, NZ, LZ, labels=labels, seed=0)
        jind = G.InducingSequences(Z, M)
        tind = T.InducingSequences(Z, M, dtype=tdt, device="cpu")
    ls = G.utils.suggest_initial_lengthscales(X)
    jmodel = G.SVGP(G.kernels.SignatureMatern12(D, M, lengthscales=ls), jind,
                    G.likelihoods.MultiClass(C), num_latent=C)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["ind"]["Z"] = params["ind"]["Z"] + rng.randn(*Z.shape) * 0.05
    params["kern"]["variances"] = jnp.asarray(rng.randn(M + 1) * 0.3)
    params["q_mu"] = jnp.asarray(rng.randn(NZ, C) * 0.7)
    params["q_sqrt"] = jnp.asarray(
        np.tril(rng.randn(C, NZ, NZ)) * 0.1 + 0.6 * np.eye(NZ))
    tmodel = T.SVGP(T.kernels.SignatureMatern12(D, M, lengthscales=ls,
                                                dtype=tdt, device="cpu"),
                    tind, T.likelihoods.MultiClass(C), num_latent=C,
                    device="cpu")
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


@functools.lru_cache(maxsize=None)
def _jax_reference(kind):
    """JAX's loss, leaf gradients and predict_y at float64; the float64 and
    float32 cases of the port share one compile."""
    jmodel, params, _ = _setup(kind)
    X, Y = _data()
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(params, X, Y)
    jf = jax.jit(jmodel.predict_f)(params, X)
    return jloss, jgrads, jmodel.likelihood.predict_mean_and_var(*jf)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["tensors", "sequences"])
def test_loss_leaf_gradients_and_predict_y(kind, dtype):
    tol_loss, tol, tol_y = TOL[dtype]
    _, _, tmodel = _setup(kind, dtype)
    X, Y = _data()
    jloss, jgrads, jy = _jax_reference(kind)
    tloss = tmodel.loss(torch.from_numpy(X).to(dtype),
                        torch.from_numpy(Y).to(dtype))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= tol_loss * abs(float(jloss))
    leaves = convert.named_leaves(tmodel)
    scale = max(float(np.max(np.abs(_leaf(jgrads, n)))) for n in leaves)
    for name, p in leaves.items():
        got = p.grad.numpy().astype(np.float64)
        assert np.any(got != 0), name
        assert float(np.max(np.abs(got - _leaf(jgrads, name)))) <= (
            tol * scale), name
    with torch.no_grad():
        ty = tmodel.predict_y(torch.from_numpy(X).to(dtype))
    for a, b in zip(jy, ty):
        _close(a, b, tol_y)


@pytest.mark.parametrize("kind", ["tensors", "sequences"])
def test_predictor_repeat_padding_is_exact(kind):
    """Requests padded to a (length, batch) bucket by repeating their last
    observation answer as the unpadded model does."""
    _, _, tmodel = _setup(kind)
    pred = T.serving.Predictor(tmodel, len_buckets=(8, 16),
                               batch_buckets=(2, 8), device="cpu")
    rng = np.random.RandomState(4)
    for n, length in ((1, 5), (3, 12), (7, 8)):
        Xq = rng.randn(n, length, D).cumsum(axis=1) * 0.3
        mean, var = pred.predict_y(Xq)
        with torch.no_grad():
            want = tmodel.predict_y(torch.from_numpy(Xq))
        for a, b in zip(want, (mean, var)):
            assert float((a - b).abs().max()) <= 1e-10


def test_variant_aliases_and_parameter_layout():
    """SignatureMatern12 answers to SignatureLaplace and
    SignatureExponential, as in the JAX package; the base adds no leaf, so
    a JAX tree loads unchanged and round-trips."""
    assert T.kernels.SignatureLaplace is T.kernels.SignatureMatern12
    assert T.kernels.SignatureExponential is T.kernels.SignatureMatern12
    kern = T.kernels.SignatureExponential(D, M, device="cpu")
    assert kern.base == "matern12"
    assert set(dict(kern.named_parameters())) == {"variances", "sigma",
                                                  "lengthscales"}
    _, params, tmodel = _setup("tensors")
    tree = convert.to_numpy_tree(tmodel)
    flat = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat:
        keys = [p.key for p in path]
        got = tree
        for k in keys:
            got = got[k]
        np.testing.assert_array_equal(got, np.asarray(leaf))
