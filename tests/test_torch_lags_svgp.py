"""An SVGP with lags, the port against ``gpsig_tpu`` (d=2, M=2, C=3, 6
inducing tensors or sequences, 8 examples of 7 steps): the loss and the
gradient of every leaf, ``kern/lags`` and ``kern/gamma`` included, the
lag-tiled inducing tensors of the init heuristic, and serving.

Tolerances: the loss (relative) and each leaf's gradient (relative to the
largest gradient of any leaf) <= 1e-9 at float64 and <= 1e-4 for the port
at float32 against JAX at float64, as ``test_torch_training.py``; served
means <= 1e-9 at float64 against the JAX ``Predictor`` at the same
(length, batch) bucket.

With lags, time padding is not exact in either package: the lagged copies
are interpolated on the grid of the padded length, so a repeat-padded
request gets other features (ROADMAP Queue 3, reference behaviours).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu.serving import Predictor as JPredictor
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import utils as tutils

D, M, NZ, C, N, L = 2, 2, 6, 3, 8, 7


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, L, D).cumsum(axis=1) * 0.3
    Y = (np.arange(n) % C).astype(np.float64)[:, None]
    return X, Y


def _setup(kind, num_lags, tdt=torch.float64):
    """JAX model and perturbed float64 parameters with lags, and the port's
    model at ``tdt`` carrying them."""
    X, Y = _data(20)
    rng = np.random.RandomState(1 + num_lags)
    labels = Y[:, 0].astype(int)
    ls = G.utils.suggest_initial_lengthscales(X)
    if kind == "tensors":
        Z = G.utils.suggest_initial_inducing_tensors(
            X, M, NZ, labels=labels, increments=True, num_lags=num_lags,
            seed=0)
        jind = G.InducingTensors(Z, M, increments=True)
        tind = T.InducingTensors(Z, M, increments=True, dtype=tdt,
                                 device="cpu")
    else:
        Z = G.utils.suggest_initial_inducing_sequences(X, NZ, M + 1,
                                                       labels=labels, seed=0)
        jind = G.InducingSequences(Z, M)
        tind = T.InducingSequences(Z, M, dtype=tdt, device="cpu")
    jkern = G.kernels.SignatureRBF(D, M, lengthscales=ls, num_lags=num_lags)
    jmodel = G.SVGP(jkern, jind, G.likelihoods.MultiClass(C), num_latent=C)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["ind"]["Z"] = params["ind"]["Z"] + rng.randn(*Z.shape) * 0.05
    params["kern"]["lags"] = params["kern"]["lags"] + rng.randn(num_lags)
    params["kern"]["gamma"] = params["kern"]["gamma"] + rng.rand(
        num_lags + 1)
    params["q_mu"] = jnp.asarray(rng.randn(NZ, C) * 0.7)
    params["q_sqrt"] = jnp.asarray(
        np.tril(rng.randn(C, NZ, NZ)) * 0.1 + 0.6 * np.eye(NZ))
    tkern = T.kernels.SignatureRBF(D, M, lengthscales=ls, num_lags=num_lags,
                                   dtype=tdt, device="cpu")
    tmodel = T.SVGP(tkern, tind, T.likelihoods.MultiClass(C), num_latent=C,
                    device="cpu")
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


def _leaf(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return np.asarray(tree, dtype=np.float64)


@pytest.mark.parametrize("kind,num_lags,tdt", [
    ("tensors", 1, torch.float64), ("tensors", 2, torch.float64),
    ("sequences", 1, torch.float64), ("sequences", 2, torch.float64),
    ("tensors", 1, torch.float32), ("sequences", 1, torch.float32)])
def test_lagged_loss_and_leaf_gradients(kind, num_lags, tdt):
    tol = 1e-9 if tdt == torch.float64 else 1e-4
    jmodel, params, tmodel = _setup(kind, num_lags, tdt)
    X, Y = _data()
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        params, jnp.asarray(X), jnp.asarray(Y))
    tloss = tmodel.loss(torch.from_numpy(X).to(tdt),
                        torch.from_numpy(Y).to(tdt))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= tol * abs(float(jloss))
    leaves = convert.named_leaves(tmodel)
    assert {"kern/lags", "kern/gamma"} <= set(leaves)
    scale = max(float(np.max(np.abs(_leaf(jgrads, n)))) for n in leaves)
    for name, p in leaves.items():
        want = _leaf(jgrads, name)
        got = p.grad.numpy().astype(np.float64)
        assert np.any(got != 0), name
        assert float(np.max(np.abs(got - want))) <= tol * scale, name


def test_lag_tiled_inducing_tensors_draw_for_draw():
    """The heuristic's lag tiling (the recipe's ``num_lags=1`` with
    increments, and without labels) equals the JAX package's exactly."""
    X = np.random.RandomState(4).randn(30, 9, 3)
    labels = np.arange(30) % 3
    for kw in (dict(increments=True, labels=labels),
               dict(increments=True, labels=None)):
        a = G.utils.suggest_initial_inducing_tensors(X, 3, 11, num_lags=1,
                                                     seed=2, **kw)
        b = tutils.suggest_initial_inducing_tensors(X, 3, 11, num_lags=1,
                                                    seed=2, **kw)
        assert a.shape == (6, 11, 2, 6)
        np.testing.assert_array_equal(a, b)


def test_lagged_serving_matches_the_jax_predictor_at_the_same_bucket():
    jmodel, params, tmodel = _setup("tensors", 1)
    buckets = dict(len_buckets=(6, 9), batch_buckets=(2, 4))
    jpred = JPredictor(jmodel, params, dtype=jnp.float64, **buckets)
    tpred = T.serving.Predictor(tmodel, device="cpu", **buckets)
    rng = np.random.RandomState(6)
    for n, l in ((1, 5), (3, 9)):
        Xq = rng.randn(n, l, D).cumsum(axis=1) * 0.3
        for a, b in zip(jpred.predict_y(Xq), tpred.predict_y(Xq)):
            assert b.shape == (n, C)
            assert float(np.max(np.abs(np.asarray(a) - b.numpy()))) <= 1e-9


def test_lagged_padding_changes_predictions_in_both_packages():
    """Repeat-padding a request to a longer bucket changes its lagged
    features, so its prediction: in the JAX ``Predictor`` and in the
    port's alike (without lags both are exact, ``test_torch_svgp_serving``)."""
    jmodel, params, tmodel = _setup("tensors", 1)
    Xq = np.random.RandomState(7).randn(2, 6, D).cumsum(axis=1) * 0.3
    outs = {}
    for lb in (6, 9):
        jpred = JPredictor(jmodel, params, len_buckets=(lb,),
                           batch_buckets=(2,), dtype=jnp.float64)
        tpred = T.serving.Predictor(tmodel, len_buckets=(lb,),
                                    batch_buckets=(2,), device="cpu")
        outs[lb] = (np.asarray(jpred.predict_f(Xq)[0]),
                    tpred.predict_f(Xq)[0].numpy())
    for pkg in (0, 1):
        gap = float(np.max(np.abs(outs[6][pkg] - outs[9][pkg])))
        assert gap > 1e-6, (pkg, gap)
    np.testing.assert_allclose(outs[9][1], outs[9][0], rtol=0, atol=1e-9)
