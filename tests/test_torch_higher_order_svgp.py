"""The order > 1 slice as a whole: small ``SignatureRBF(order=2)`` SVGPs of
the port (d=2, M=3, 6 inducing tensors or 6 inducing sequences of length
4, MultiClass C=3) against ``gpsig_tpu`` with the same numpy-seeded
weights, carried by ``convert.load_jax_params``: the loss, every leaf's
gradient, ``predict_y`` and ``predict_f(full_cov=True)``; the order-M
(full grid) sequences model; ``K`` / ``Kdiag`` unnormalized; the bucketed
``Predictor`` (repeat padding); and the order > 1 Kzx, which has no
kernel: ``fused='on'`` raises as JAX does, ``'auto'`` takes torch ops.

Tolerances against JAX at float64 (loss relative, each leaf's gradient
relative to the largest, predictions and covariances relative to their
largest): 1e-9 -- the port's seq x seq Grams take the kernels' closed
forms (K5/K6's plain versions), JAX's its reference graphs.  The
Predictor's answers within 1e-10 of the model's.
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

D, M, NZ, LZ, C, N, L = 2, 3, 6, 4, 3, 5, 7
TOL = 1e-9


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, L, D).cumsum(axis=1) * 0.3
    return X, (np.arange(n) % C).astype(np.float64)[:, None]


@functools.lru_cache(maxsize=None)
def _setup(kind, order=2):
    """JAX SignatureRBF(order) SVGP with inducing ``kind`` and perturbed
    float64 parameters, and the port's model carrying them."""
    X, Y = _data(20)
    labels = Y[:, 0].astype(int)
    rng = np.random.RandomState(2)
    if kind == "tensors":
        Z = G.utils.suggest_initial_inducing_tensors(
            X, M, NZ, labels=labels, increments=True, seed=0)
        jind = G.InducingTensors(Z, M, increments=True)
        tind = T.InducingTensors(Z, M, increments=True,
                                 dtype=torch.float64, device="cpu")
    else:
        Z = G.utils.suggest_initial_inducing_sequences(
            X, NZ, LZ, labels=labels, seed=0)
        jind = G.InducingSequences(Z, M)
        tind = T.InducingSequences(Z, M, dtype=torch.float64, device="cpu")
    ls = G.utils.suggest_initial_lengthscales(X)
    jmodel = G.SVGP(G.kernels.SignatureRBF(D, M, order=order,
                                           lengthscales=ls),
                    jind, G.likelihoods.MultiClass(C), num_latent=C)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["ind"]["Z"] = params["ind"]["Z"] + rng.randn(*Z.shape) * 0.05
    params["kern"]["variances"] = jnp.asarray(rng.randn(M + 1) * 0.3)
    params["q_mu"] = jnp.asarray(rng.randn(NZ, C) * 0.7)
    params["q_sqrt"] = jnp.asarray(
        np.tril(rng.randn(C, NZ, NZ)) * 0.1 + 0.6 * np.eye(NZ))
    tmodel = T.SVGP(T.kernels.SignatureRBF(D, M, order=order,
                                           lengthscales=ls,
                                           dtype=torch.float64,
                                           device="cpu"),
                    tind, T.likelihoods.MultiClass(C), num_latent=C,
                    device="cpu")
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


@pytest.mark.parametrize("kind,order", [("tensors", 2), ("sequences", 2),
                                        ("sequences", M)])
def test_loss_leaf_gradients_and_predictions(kind, order):
    jmodel, params, tmodel = _setup(kind, order)
    assert tmodel.kern.order == order
    X, Y = _data()
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(params, X, Y)
    tmodel.zero_grad(set_to_none=True)
    tloss = tmodel.loss(torch.from_numpy(X), torch.from_numpy(Y))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL * abs(float(jloss))
    leaves = convert.named_leaves(tmodel)
    scale = max(float(np.max(np.abs(_leaf(jgrads, n)))) for n in leaves)
    for name, p in leaves.items():
        got = p.grad.numpy()
        assert np.any(got != 0), name
        assert float(np.max(np.abs(got - _leaf(jgrads, name)))) <= (
            TOL * scale), name
    jf = jax.jit(jmodel.predict_f)(params, X)
    with torch.no_grad():
        ty = tmodel.predict_y(torch.from_numpy(X))
        tmean, tcov = tmodel.predict_f(torch.from_numpy(X), full_cov=True)
    for a, b in zip(jmodel.likelihood.predict_mean_and_var(*jf), ty):
        _close(a, b, TOL)
    jmean, jcov = jax.jit(lambda p, x: jmodel.predict_f(
        p, x, full_cov=True))(params, X)
    _close(jmean, tmean, TOL)
    _close(jcov, tcov, TOL)


def test_unnormalized_K_and_Kdiag():
    """``K`` (the seq x seq Gram through K5's plain version at order 2 and
    at the full grid) and ``Kdiag`` (``higher_order_levels_batched`` at
    float32, the reference graph at float64) without normalization."""
    X, _ = _data(4, seed=3)
    X2, _ = _data(3, seed=4)
    for order in (2, M):
        jk = G.kernels.SignatureRBF(D, M, order=order, normalization=False)
        tk = T.kernels.SignatureRBF(D, M, order=order, normalization=False,
                                    dtype=torch.float64, device="cpu")
        kp = jk.init_params()
        for a, b in ((jk.K(kp, X, X2), tk.K(torch.from_numpy(X),
                                              torch.from_numpy(X2))),
                     (jk.K(kp, X), tk.K(torch.from_numpy(X))),
                     (jk.Kdiag(kp, X), tk.Kdiag(torch.from_numpy(X)))):
            _close(a, b.detach(), TOL)
        tk32 = T.kernels.SignatureRBF(D, M, order=order,
                                      normalization=False, device="cpu")
        _close(jk.Kdiag(kp, X), tk32.Kdiag(torch.from_numpy(X).float())
               .detach(), 1e-5)


@pytest.mark.parametrize("kind", ["tensors", "sequences"])
def test_predictor_repeat_padding_is_exact(kind):
    """Requests padded to a (length, batch) bucket by repeating their last
    observation answer as the unpadded order-2 model does."""
    _, _, tmodel = _setup(kind)
    pred = T.serving.Predictor(tmodel, len_buckets=(8, 16),
                               batch_buckets=(2, 8), device="cpu")
    rng = np.random.RandomState(5)
    for n, length in ((1, 5), (3, 12), (7, 8)):
        Xq = rng.randn(n, length, D).cumsum(axis=1) * 0.3
        mean, var = pred.predict_y(Xq)
        with torch.no_grad():
            want = tmodel.predict_y(torch.from_numpy(Xq))
        for a, b in zip(want, (mean, var)):
            assert float((a - b).abs().max()) <= 1e-10


def test_order_two_kzx_has_no_kernel():
    """As in JAX (``tests/test_inducing_pallas.py:155-163``): under
    ``fused='on'`` the order-2 Kzx raises ("order=1 only"), never a silent
    detour (on a CPU tensor 'on' raises first, for want of the card); under
    ``'auto'`` it is computed with torch ops and equals ``'off'``."""
    _, params, _ = _setup("tensors")
    Z = np.array(params["ind"]["Z"])
    X, _ = _data()
    kern = T.kernels.SignatureRBF(D, M, order=2, fused="on", device="cpu")
    with pytest.raises(ValueError, match="fused='on'"):
        kern._K_tens_vs_seq(kern.constrain(), torch.from_numpy(Z).float(),
                            torch.from_numpy(X).float(), True)
    kern._kernel_route = lambda t: True  # as on a CUDA tensor
    with pytest.raises(ValueError, match="order=1 only"):
        kern._K_tens_vs_seq(kern.constrain(), torch.from_numpy(Z).float(),
                            torch.from_numpy(X).float(), True)
    outs = []
    for fused in ("auto", "off"):
        k = T.kernels.SignatureRBF(D, M, order=2, fused=fused,
                                   dtype=torch.float64, device="cpu")
        outs.append(k._K_tens_vs_seq(k.constrain(), torch.from_numpy(Z),
                                     torch.from_numpy(X), True))
    _close(outs[1].numpy(), outs[0], TOL)
