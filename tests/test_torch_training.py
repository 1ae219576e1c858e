"""The training slice of the port against ``gpsig_tpu`` at small width
(d=2, M=2, nZ=6, C=3, N=8, L=7): ``gauss_kl`` in its four forms, the
MultiClass training terms, ``SVGP.loss`` and the gradient of every leaf
(parameters from a JAX ``SVGP.init_params()``, perturbed, carried by
``convert.load_jax_params``), ``NAdam`` against ``optax.nadam``, and
``optimize`` against ``gpsig_tpu.training.optimize``; then the default
device.

Tolerances: <= 1e-12 for gauss_kl / MultiClass and NAdam at float64 (the
same formulas); for the loss (relative) and each leaf's gradient (relative
to the largest gradient of any leaf: ``kern/sigma``'s gradient is a
cancellation, ~1e-5 of the others), <= 1e-9 at float64 (the port's Kzz/Kzx
take the kernel algebra, the JAX reference graph another order) and <= 1e-4
for the port at float32 against JAX at float64 (f32 exp/expm1 and sums,
amplified by the Cholesky solves); <= 1e-8 relative for the loss history
of six optimizer steps at float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu import training as jtraining
from gpsig_tpu_torch import config as tcfg
from gpsig_tpu_torch import convert, training

RNG = np.random.RandomState(29)
D, M, NZ, C, N, L = 2, 2, 6, 3, 8, 7


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, L, D).cumsum(axis=1) * 0.3
    Y = (np.arange(n) % C).astype(np.float64)[:, None]
    return X, Y


def _setup(tdt=torch.float64, *, whiten=True, q_diag=False,
           learn_weights=False, num_data=None):
    """JAX model and perturbed float64 parameters, and the port's model at
    ``tdt`` carrying the same parameters."""
    X, Y = _data(20)
    rng = np.random.RandomState(1)
    Z = G.utils.suggest_initial_inducing_tensors(
        X, M, NZ, labels=Y[:, 0].astype(int), increments=True, seed=0)
    ls = G.utils.suggest_initial_lengthscales(X)
    jkern = G.kernels.SignatureRBF(D, M, lengthscales=ls)
    jind = G.InducingTensors(Z, M, increments=True,
                             learn_weights=learn_weights)
    opts = dict(num_latent=C, num_data=num_data, whiten=whiten,
                q_diag=q_diag)
    jmodel = G.SVGP(jkern, jind, G.likelihoods.MultiClass(C), **opts)
    jdt = jnp.float64
    params = jax.tree.map(lambda a: jnp.asarray(a, jdt),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["ind"]["Z"] = params["ind"]["Z"] + jnp.asarray(
        rng.randn(*Z.shape) * 0.05, jdt)
    params["kern"]["variances"] = jnp.asarray(
        rng.randn(M + 1) * 0.3, jdt)
    if learn_weights:
        params["ind"]["W"] = params["ind"]["W"] + jnp.asarray(
            rng.randn(M, NZ, NZ) * 0.1, jdt)
    params["q_mu"] = jnp.asarray(rng.randn(NZ, C) * 0.7, jdt)
    if q_diag:
        params["q_sqrt"] = jnp.asarray(0.5 + rng.rand(NZ, C), jdt)
    else:
        params["q_sqrt"] = jnp.asarray(
            np.tril(rng.randn(C, NZ, NZ)) * 0.1 + 0.6 * np.eye(NZ), jdt)

    tkern = T.kernels.SignatureRBF(D, M, lengthscales=ls, dtype=tdt,
                                   device="cpu")
    tind = T.InducingTensors(Z, M, increments=True,
                             learn_weights=learn_weights, dtype=tdt,
                             device="cpu")
    tmodel = T.SVGP(tkern, tind, T.likelihoods.MultiClass(C), device="cpu",
                    **opts)
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


def _leaf(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return np.asarray(tree, dtype=np.float64)


@pytest.mark.parametrize("variant", ["whiten", "non_whiten", "q_diag",
                                     "learn_weights", "f32"])
def test_loss_and_leaf_gradients(variant):
    kw = {"whiten": {}, "non_whiten": {"whiten": False},
          "q_diag": {"q_diag": True, "num_data": 50},
          "learn_weights": {"learn_weights": True},
          "f32": {}}[variant]
    tdt = torch.float32 if variant == "f32" else torch.float64
    tol = 1e-4 if variant == "f32" else 1e-9
    jmodel, params, tmodel = _setup(tdt, **kw)
    X, Y = _data()
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        params, jnp.asarray(X), jnp.asarray(Y))
    tloss = tmodel.loss(torch.from_numpy(X).to(tdt),
                        torch.from_numpy(Y).to(tdt))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= tol * abs(float(jloss))
    leaves = convert.named_leaves(tmodel)
    scale = max(float(np.max(np.abs(_leaf(jgrads, n)))) for n in leaves)
    for name, p in leaves.items():
        want = _leaf(jgrads, name)
        got = p.grad.numpy().astype(np.float64)
        assert np.any(got != 0), name
        assert float(np.max(np.abs(got - want))) <= tol * scale, name


def test_predict_log_density():
    jmodel, params, tmodel = _setup()
    X, Y = _data(seed=3)
    want = jax.jit(jmodel.predict_log_density)(params, jnp.asarray(X),
                                               jnp.asarray(Y))
    with torch.no_grad():
        got = tmodel.predict_log_density(torch.from_numpy(X),
                                         torch.from_numpy(Y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)


def test_optimize_matches_the_jax_loop(tmp_path):
    jmodel, params, tmodel = _setup(num_data=12)
    X, Y = _data(12)
    Xv, Yv = _data(6, seed=7)
    scripted = [5.0, 3.0, 4.0, 3.5, 4.0, 4.0]

    def scorer(nlpp):
        calls = []

        def score(*_):
            calls.append(1)
            return [nlpp(), scripted[len(calls) - 1]]
        return score

    jhist = jtraining.optimize(
        lambda p, xb, yb: jmodel.loss(p, xb, yb), params,
        jtraining.nadam(1e-2), max_iter=6,
        data_iter=jtraining.BatchIterator(
            jtraining.MinibatchStream(12, 4, seed_or_rng=3), X, Y),
        trainable=lambda n: n != "kern/variances",
        val_scorer=scorer(lambda: 0.0), save_best_params=True,
        lower_is_better=True, patience=2, save_freq=1, print_freq=100,
        log_fn=lambda *_: None)
    thist = training.optimize(
        lambda m, xb, yb: m.loss(xb, yb), tmodel, training.nadam(1e-2),
        max_iter=6,
        data_iter=training.BatchIterator(
            training.MinibatchStream(12, 4, seed_or_rng=3), X, Y,
            device="cpu"),
        trainable=lambda n: n != "kern/variances",
        val_scorer=scorer(lambda: -tmodel.predict_log_density(
            torch.from_numpy(Xv), torch.from_numpy(Yv)).mean().item()),
        save_best_params=True, lower_is_better=True, patience=2,
        save_freq=1, print_freq=100, log_fn=lambda *_: None)
    iters = [k for k in jhist if isinstance(k, int)]
    assert iters == [k for k in thist if isinstance(k, int)] == [1, 2, 3, 4,
                                                                  5]
    for it in iters:
        a, b = jhist[it]["loss"], thist[it]["loss"]
        assert abs(a - b) <= 1e-8 * abs(a)
    assert jhist["best"]["iter"] == thist["best"]["iter"] == 2
    # restore_best loads the best snapshot into the model
    training.restore_best(tmodel, thist)
    for name, p in convert.named_leaves(tmodel).items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _leaf(thist["best"]["params"], name))
    np.testing.assert_allclose(_leaf(thist["best"]["params"], "ind/Z"),
                               _leaf(jhist["best"]["params"], "ind/Z"),
                               rtol=1e-8, atol=1e-12)
    # checkpointing is ported (test_torch_checkpoint.py): a phase writes one
    path = tmp_path / "x.ckpt"
    training.optimize(lambda m: m.loss(torch.from_numpy(X),
                                       torch.from_numpy(Y)), tmodel,
                      training.nadam(), max_iter=1, checkpoint_path=str(path),
                      log_fn=lambda *_: None)
    assert path.exists()


def test_modules_default_to_the_card():
    assert tcfg.default_device() == torch.device("cuda")
    if torch.cuda.is_available():
        kern = T.kernels.SignatureRBF(D, M)
        assert kern.variances.device.type == "cuda"
        return
    # no card here: torch's own error, and nothing falls back to the CPU
    with pytest.raises((AssertionError, RuntimeError)):
        T.kernels.SignatureRBF(D, M)
    with pytest.raises((AssertionError, RuntimeError)):
        T.InducingTensors(np.zeros((3, 4, 2, D)), M, increments=True)
    old = tcfg.default_device()
    tcfg.set_default_device("cpu")
    try:
        assert T.kernels.SignatureRBF(D, M).sigma.device.type == "cpu"
    finally:
        tcfg.set_default_device(old)
