"""``likelihoods.Bernoulli`` and ``metrics`` of the port against
``gpsig_tpu`` at float64.

Tolerances: <= 1e-12 * max(|ref|, 1) for the Bernoulli formulas (the same
algebra); <= 1e-9 for a Bernoulli ``SVGP.loss`` (relative) and each leaf's
gradient (relative to the largest), and for ``metrics.accuracy`` / ``nlpp``
of a MultiClass and a Bernoulli model (the covariances run the kernel
algebra in the port, the reference graph in JAX).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu import metrics as jmetrics
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import metrics as tmetrics

D, M, NZ, N, L = 2, 2, 6, 12, 7


def _close(j, t, tol):
    j = np.asarray(j, dtype=np.float64)
    t = t.detach().numpy().astype(np.float64)
    assert j.shape == t.shape
    scale = max(float(np.max(np.abs(j))), 1.0)
    assert float(np.max(np.abs(j - t))) <= tol * scale


def _data(n, classes, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, L, D).cumsum(axis=1) * 0.3
    return X, (np.arange(n) % classes).astype(np.float64)


def _models(classes):
    """JAX and port SVGPs on 6 inducing tensors with the recipe's
    likelihood for ``classes`` and the same perturbed float64 parameters."""
    X, y = _data(20, classes)
    rng = np.random.RandomState(2)
    P = 1 if classes == 2 else classes
    Z = G.utils.suggest_initial_inducing_tensors(
        X, M, NZ, labels=y.astype(int), increments=True, seed=0)
    ls = G.utils.suggest_initial_lengthscales(X)
    jlik, tlik = ((G.likelihoods.Bernoulli(), T.likelihoods.Bernoulli())
                  if classes == 2 else (G.likelihoods.MultiClass(classes),
                                        T.likelihoods.MultiClass(classes)))
    jmodel = G.SVGP(G.kernels.SignatureRBF(D, M, lengthscales=ls),
                    G.InducingTensors(Z, M, increments=True), jlik,
                    num_latent=P, num_data=50)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jmodel.init_params())
    params["q_mu"] = jnp.asarray(rng.randn(NZ, P))
    params["q_sqrt"] = jnp.asarray(
        np.tril(rng.randn(P, NZ, NZ)) * 0.2 + 0.5 * np.eye(NZ))
    tmodel = T.SVGP(
        T.kernels.SignatureRBF(D, M, lengthscales=ls, dtype=torch.float64,
                               device="cpu"),
        T.InducingTensors(Z, M, increments=True, dtype=torch.float64,
                          device="cpu"),
        tlik, num_latent=P, num_data=50, device="cpu")
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


class _Jitted:
    """A JAX model's prediction methods through one ``jax.jit`` each (the
    JAX metrics call them eagerly, one compile per op)."""

    def __init__(self, model):
        self.predict_y = jax.jit(model.predict_y)
        self.predict_log_density = jax.jit(model.predict_log_density)


def test_bernoulli_formulas():
    rng = np.random.RandomState(0)
    Fmu = rng.randn(40, 1) * 2.0
    Fvar = rng.rand(40, 1) * 3.0 + 1e-3
    Y = (rng.rand(40, 1) > 0.5).astype(np.float64)
    jlik, tlik = G.likelihoods.Bernoulli(), T.likelihoods.Bernoulli()
    tFmu, tFvar, tY = (torch.from_numpy(a) for a in (Fmu, Fvar, Y))
    assert tlik.num_gh == jlik.num_gh == 20 and tlik.num_latent == 1
    _close(jlik.variational_expectations(Fmu, Fvar, Y),
           tlik.variational_expectations(tFmu, tFvar, tY), 1e-12)
    for a, b in zip(jlik.predict_mean_and_var(Fmu, Fvar),
                    tlik.predict_mean_and_var(tFmu, tFvar)):
        _close(a, b, 1e-12)
    _close(jlik.predict_log_density(Fmu, Fvar, Y),
           tlik.predict_log_density(tFmu, tFvar, tY), 1e-12)
    # the probit is clipped away from {0, 1} by 1e-3 (GPflow's)
    p, _ = tlik.predict_mean_and_var(torch.tensor([[-40.0], [40.0]]),
                                     torch.zeros(2, 1))
    np.testing.assert_allclose(p.numpy()[:, 0], [1e-3, 1 - 1e-3])


def test_bernoulli_loss_and_leaf_gradients():
    jmodel, params, tmodel = _models(2)
    X, y = _data(N, 2, seed=3)
    Y = y[:, None]
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        params, jnp.asarray(X), jnp.asarray(Y))
    tloss = tmodel.loss(torch.from_numpy(X), torch.from_numpy(Y))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-9 * abs(float(jloss))
    leaves = convert.named_leaves(tmodel)
    assert tmodel.q_mu.shape == (NZ, 1)

    def leaf(tree, name):
        for key in name.split("/"):
            tree = tree[key]
        return np.asarray(tree)

    scale = max(float(np.max(np.abs(leaf(jgrads, n)))) for n in leaves)
    for name, p in leaves.items():
        err = float(np.max(np.abs(p.grad.numpy() - leaf(jgrads, name))))
        assert err <= 1e-9 * scale, name


@pytest.mark.parametrize("classes", [3, 2])
def test_metrics_match_the_jax_package(classes):
    """``accuracy`` / ``nlpp`` and the batched helpers, over minibatches
    that do not divide the data (the 0.5 threshold with one latent)."""
    jmodel, params, tmodel = _models(classes)
    jmodel = _Jitted(jmodel)
    X, y = _data(N, classes, seed=5)
    kw = dict(batch_size=5)
    np.testing.assert_array_equal(
        jmetrics.batch_predict_classes(jmodel, params, X, **kw),
        tmetrics.batch_predict_classes(tmodel, X, **kw))
    np.testing.assert_allclose(
        tmetrics.batch_predict_log_density(tmodel, X, y, **kw),
        jmetrics.batch_predict_log_density(jmodel, params, X, y, **kw),
        rtol=1e-9, atol=1e-12)
    assert abs(tmetrics.accuracy(tmodel, X, y, **kw)
               - jmetrics.accuracy(jmodel, params, X, y, **kw)) <= 1e-9
    want = jmetrics.nlpp(jmodel, params, X, y, **kw)
    assert abs(tmetrics.nlpp(tmodel, X, y, **kw) - want) <= 1e-9 * abs(want)
    # float32 numpy inputs go to the model's float64 parameters
    assert np.isfinite(tmetrics.nlpp(tmodel, X.astype(np.float32), y, **kw))


def test_jsonl_logger(tmp_path, capsys):
    path = tmp_path / "metrics.jsonl"
    log = tmetrics.JsonlLogger(str(path), echo=True)
    log.log(event="val", acc=0.5)
    log.log(event="test", nlpp=1.25, wall_time=3.0)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0]["event"] == "val" and recs[0]["acc"] == 0.5
    assert "wall_time" in recs[0] and recs[1]["wall_time"] == 3.0
    assert capsys.readouterr().out.count("\n") == 2
