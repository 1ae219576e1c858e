"""An ``InducingSequences`` SVGP of the port against ``gpsig_tpu``: its
loss, every leaf's gradient and ``predict_y``, the fused routes and the
bucketed ``Predictor``, and ``training.optimize``.

Split from ``test_torch_inducing_sequences.py`` (its set-up and
tolerances: <= 1e-9 at float64, <= 1e-4 at float32, <= 1e-10 bucketed vs
direct, <= 1e-8 relative for the loss history), so that no port test file
queues ahead of the suite's long JAX files under xdist's ``loadfile``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import gpsig_tpu_torch as T
from gpsig_tpu import training as jtraining
from gpsig_tpu_torch import convert, training
from test_torch_inducing_sequences import D, _close, _data, _leaf, _setup


@functools.lru_cache(maxsize=None)
def _jax_loss_grads_predict_y(learn_weights: bool):
    """JAX's loss, leaf gradients and predict_y on the test batch; the
    float64 and float32 variants of the port share one compile."""
    jmodel, params, _ = _setup(learn_weights=learn_weights)
    X, Y = _data()
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(params, X, Y)
    jf = jax.jit(jmodel.predict_f)(params, X)
    return jloss, jgrads, jmodel.likelihood.predict_mean_and_var(*jf)


@pytest.mark.parametrize("variant", ["whiten", "learn_weights", "f32"])
def test_loss_leaf_gradients_and_predict_y(variant):
    learn_weights = variant == "learn_weights"
    tdt = torch.float32 if variant == "f32" else torch.float64
    tol = 1e-4 if variant == "f32" else 1e-9
    _, _, tmodel = _setup(tdt, learn_weights=learn_weights)
    X, Y = _data()
    jloss, jgrads, jy = _jax_loss_grads_predict_y(learn_weights)
    tloss = tmodel.loss(torch.from_numpy(X).to(tdt),
                        torch.from_numpy(Y).to(tdt))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= tol * abs(float(jloss))
    leaves = convert.named_leaves(tmodel)
    scale = max(float(np.max(np.abs(_leaf(jgrads, n)))) for n in leaves)
    for name, p in leaves.items():
        got = p.grad.numpy().astype(np.float64)
        assert np.any(got != 0), name
        assert float(np.max(np.abs(got - _leaf(jgrads, name)))) <= (
            tol * scale), name
    with torch.no_grad():
        ty = tmodel.predict_y(torch.from_numpy(X).to(tdt))
    for a, b in zip(jy, ty):
        _close(a, b, tol)


def test_fused_routes_and_predictor():
    """'auto' (the kernels' plain versions) and 'off' (the reference
    graph) agree; 'on' on a CPU tensor raises; the bucketed Predictor
    answers as the model does."""
    _, _, auto = _setup()
    _, _, off = _setup(fused="off")
    X, _ = _data()
    Xt = torch.from_numpy(X)
    with torch.no_grad():
        for a, b in zip(auto.predict_y(Xt), off.predict_y(Xt)):
            assert float((a - b).abs().max()) <= 1e-9
    _, _, on = _setup(torch.float32, fused="on")
    with pytest.raises(ValueError, match="fused='on'"):
        on.predict_y(Xt.float())
    pred = T.serving.Predictor(auto, len_buckets=(8, 16),
                               batch_buckets=(2, 8), device="cpu")
    pred.warmup(D)
    rng = np.random.RandomState(4)
    for n, length in ((1, 5), (3, 12), (7, 8)):
        Xq = rng.randn(n, length, D).cumsum(axis=1) * 0.3
        mean, var = pred.predict_y(Xq)
        with torch.no_grad():
            ref_mean, ref_var = auto.predict_y(torch.from_numpy(Xq))
        assert float((mean - ref_mean).abs().max()) <= 1e-10
        assert float((var - ref_var).abs().max()) <= 1e-10


def test_optimize_matches_the_jax_loop():
    """Three NAdam steps under the reference's phase-2 mask on an
    InducingSequences model: the loss history of ``training.optimize``
    equals ``gpsig_tpu.training.optimize``'s and ``kern/variances`` keeps
    its bits."""
    jmodel, params, tmodel = _setup(num_data=12)
    X, Y = _data(12)
    mask = lambda n: n != "kern/variances"  # noqa: E731
    frozen = tmodel.kern.variances.detach().clone()
    jhist = jtraining.optimize(
        lambda p, xb, yb: jmodel.loss(p, xb, yb), params,
        jtraining.nadam(1e-2), max_iter=3,
        data_iter=jtraining.BatchIterator(
            jtraining.MinibatchStream(12, 4, seed_or_rng=3), X, Y),
        trainable=mask, save_freq=1, print_freq=100, log_fn=lambda *_: None)
    thist = training.optimize(
        lambda m, xb, yb: m.loss(xb, yb), tmodel, training.nadam(1e-2),
        max_iter=3,
        data_iter=training.BatchIterator(
            training.MinibatchStream(12, 4, seed_or_rng=3), X, Y,
            device="cpu"),
        trainable=mask, save_freq=1, print_freq=100, log_fn=lambda *_: None)
    for it in (1, 2, 3):
        a, b = jhist[it]["loss"], thist[it]["loss"]
        assert abs(a - b) <= 1e-8 * abs(a)
    assert torch.equal(tmodel.kern.variances, frozen)
    assert not np.array_equal(tmodel.ind.Z.detach().numpy(),
                              np.asarray(params["ind"]["Z"]))
