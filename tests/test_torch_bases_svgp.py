"""SVGPs over the bases without a hand kernel, the port against
``gpsig_tpu`` with JAX's raw leaves carried across by
``convert.load_jax_params``: one base of each family -- cosine, poly
(degree 3), mix, matern32, spectral mixed -- at small width (d=2, M=2, 6
incremental inducing tensors, MultiClass C=3, 5 examples of 7 steps), and
the matern32 and spectral inducing-sequences models: the loss, the
gradient of every leaf (the base's own leaves included) and
``predict_y``.

Tolerances, as ``test_torch_training.py`` holds the rbf model: the loss
(relative) and each leaf's gradient (relative to the largest of any leaf)
<= 1e-9 for the port at float64 against JAX at float64, <= 1e-4 for the
port at float32 (the closed forms) against JAX at float64; predictions
the same.  One exception, held as ``test_torch_matern12_svgp.py`` holds
matern12: the exp family's exp(-r/2) has matern12's |.| kink at r = 0,
where an inducing-sequences Kzz meets its self-pairs.  Both packages are
sqrt(eps)-limited there at float32 before the Cholesky solves amplify it
(the spectral-mixed sequences model reads 3.5e-4 on ``ind/Z`` for the
port, 3.6e-5 for JAX's own float32; off the self-pairs both read ~1e-6),
so its gradients at float32 are held to matern12's 5e-4 (``KINK32``).
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
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
KINK32 = 5e-4
FAMILY_VARIANTS = {  # one base of each family: (variant, keyword arguments)
    "cosine": ("SignatureCosine", {}),
    "poly": ("SignaturePoly", {"degree": 3}),
    "mix": ("SignatureMix", {}),
    "matern32": ("SignatureMatern32", {}),
    "spectral_mixed": ("SignatureSpectral", {"family": "mixed", "Q": 4}),
    "spectral_rbf": ("SignatureSpectral", {"family": "rbf", "Q": 3}),
}
FAMILIES = ("cosine", "poly", "mix", "matern32", "spectral_mixed")


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, L, D).cumsum(axis=1) * 0.3 + 0.5
    return X, (np.arange(n) % C).astype(np.float64)[:, None]


def setup(base, kind="tensors", tdt=torch.float64):
    """JAX SVGP over ``base`` with inducing ``kind`` and perturbed float64
    parameters, and the port's model at ``tdt`` carrying them."""
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
    variant, kwargs = FAMILY_VARIANTS[base]
    if not variant.startswith("SignatureSpectral"):
        kwargs = dict(kwargs, lengthscales=G.utils.suggest_initial_lengthscales(
            X))
    jmodel = G.SVGP(getattr(G.kernels, variant)(D, M, **kwargs), jind,
                    G.likelihoods.MultiClass(C), num_latent=C)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["ind"]["Z"] = params["ind"]["Z"] + rng.randn(*Z.shape) * 0.05
    params["kern"]["variances"] = jnp.asarray(rng.randn(M + 1) * 0.3)
    for leaf in ("mixing", "poly_gamma", "alpha", "omega", "spec_gamma"):
        if leaf in params["kern"]:
            v = params["kern"][leaf]
            params["kern"][leaf] = v + rng.randn(*v.shape) * 0.2
    params["q_mu"] = jnp.asarray(rng.randn(NZ, C) * 0.7)
    params["q_sqrt"] = jnp.asarray(
        np.tril(rng.randn(C, NZ, NZ)) * 0.1 + 0.6 * np.eye(NZ))
    tmodel = T.SVGP(getattr(T.kernels, variant)(D, M, dtype=tdt,
                                                device="cpu", **kwargs),
                    tind, T.likelihoods.MultiClass(C), num_latent=C,
                    device="cpu")
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


@functools.lru_cache(maxsize=None)
def jax_reference(base, kind):
    """JAX's float64 loss, leaf gradients and predict_y."""
    jmodel, params, _ = setup(base, kind)
    X, Y = _data()
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(params, X, Y)
    jf = jax.jit(jmodel.predict_f)(params, X)
    return jloss, jgrads, jmodel.likelihood.predict_mean_and_var(*jf)


def check_model(base, kind, grad_tol32=TOL[torch.float32]):
    jloss, jgrads, jy = jax_reference(base, kind)
    X, Y = _data()
    for dtype, tol in TOL.items():
        grad_tol = grad_tol32 if dtype == torch.float32 else tol
        _, _, tmodel = setup(base, kind, dtype)
        tloss = tmodel.loss(torch.from_numpy(X).to(dtype),
                            torch.from_numpy(Y).to(dtype))
        tloss.backward()
        assert abs(tloss.item() - float(jloss)) <= tol * abs(float(jloss))
        leaves = convert.named_leaves(tmodel)
        scale = max(float(np.max(np.abs(_leaf(jgrads, n)))) for n in leaves)
        for name, p in leaves.items():
            got = p.grad.numpy().astype(np.float64)
            assert np.any(got != 0), name
            assert float(np.max(np.abs(got - _leaf(jgrads, name)))) <= (
                grad_tol * scale), (name, dtype)
        with torch.no_grad():
            ty = tmodel.predict_y(torch.from_numpy(X).to(dtype))
        for a, b in zip(jy, ty):
            _close(a, b, tol)


@pytest.mark.parametrize("base", FAMILIES)
def test_tensors_model_loss_gradients_predict(base):
    check_model(base, "tensors")


@pytest.mark.parametrize("base", ["matern32", "spectral_rbf",
                                  "spectral_mixed"])
def test_sequences_model_loss_gradients_predict(base):
    """The seq x seq Grams take the blocked closed forms at float32; the
    spectral-mixed Kzz's self-pairs sit at the kink (``KINK32``)."""
    check_model(base, "sequences",
                KINK32 if base == "spectral_mixed" else TOL[torch.float32])
