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
import optax
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu import linalg as jlinalg
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


@pytest.mark.parametrize("whitened", [True, False])
@pytest.mark.parametrize("diag", [True, False])
def test_gauss_kl(whitened, diag):
    q_mu = RNG.randn(5, 3)
    q_sqrt = (0.5 + RNG.rand(5, 3)) if diag else (
        np.tril(RNG.randn(3, 5, 5)) * 0.3 + np.eye(5))
    K = None
    if not whitened:
        A = RNG.randn(5, 5)
        K = A @ A.T + 5 * np.eye(5)
    want = jlinalg.gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_sqrt),
                            None if K is None else jnp.asarray(K))
    got = T.linalg.gauss_kl(torch.from_numpy(q_mu), torch.from_numpy(q_sqrt),
                            None if K is None else torch.from_numpy(K))
    assert abs(float(got) - float(want)) <= 1e-12 * max(abs(float(want)), 1)


def test_multiclass_training_terms():
    Fmu = RNG.randn(7, 4)
    Fvar = 0.1 + RNG.rand(7, 4)
    Y = (np.arange(7) % 4).astype(np.float64)[:, None]
    jl, tl = G.likelihoods.MultiClass(4), T.likelihoods.MultiClass(4)
    args_j = tuple(map(jnp.asarray, (Fmu, Fvar, Y)))
    args_t = tuple(map(torch.from_numpy, (Fmu, Fvar, Y)))
    for name in ("variational_expectations", "predict_log_density"):
        want = np.asarray(getattr(jl, name)(*args_j))
        got = getattr(tl, name)(*args_t).numpy()
        assert got.shape == want.shape
        assert float(np.max(np.abs(got - want))) <= 1e-12


def test_nadam_equals_optax_nadam():
    p0 = {"a": RNG.randn(3, 4), "b": RNG.randn(5)}
    grads = [{k: RNG.randn(*v.shape) for k, v in p0.items()}
             for _ in range(5)]
    opt = optax.nadam(1e-3)
    jp = jax.tree.map(jnp.asarray, p0)
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = training.nadam(1e-3)(list(tp.values()))
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0,
                                       atol=1e-12)


def test_masked_nadam_freezes_the_masked_leaves():
    """The reference's phase 2: everything trains but kern/variances,
    which keeps its bits and gets no optimizer moments."""
    _, _, tmodel = _setup()
    X, Y = map(torch.from_numpy, _data())
    mask = training.path_mask(tmodel, lambda n: n != "kern/variances")
    assert not mask["kern/variances"] and mask["ind/Z"]
    opts = training.masked_optimizer(training.nadam(1e-2), tmodel, mask)
    before = {n: p.detach().clone()
              for n, p in convert.named_leaves(tmodel).items()}
    for _ in range(2):
        tmodel.zero_grad()
        tmodel.loss(X, Y).backward()
        for o in opts:
            o.step()
    for n, p in convert.named_leaves(tmodel).items():
        if n == "kern/variances":
            assert torch.equal(p, before[n])
            assert all(p not in o.state for o in opts)
        else:
            assert not torch.equal(p, before[n]), n


def test_optimize_matches_the_jax_loop():
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
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 6"):
        training.optimize(lambda m: m.loss(X, Y), tmodel,
                          training.nadam(), max_iter=1,
                          checkpoint_path="x.ckpt")


def test_minibatch_stream_state_round_trip():
    a = training.MinibatchStream(10, 3, seed_or_rng=4)
    b = jtraining.MinibatchStream(10, 3, seed_or_rng=4)
    for _ in range(4):
        np.testing.assert_array_equal(next(a), next(b))
    state = a.state()
    ahead = [next(a) for _ in range(3)]
    a.set_state(state)
    for want in ahead:
        np.testing.assert_array_equal(next(a), want)


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
