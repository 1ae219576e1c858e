"""The low-rank slice as a whole: small low-rank SVGPs of the port (d=2,
M=3, num_components=3, rank_bound=4, 6 inducing tensors or 6 inducing
sequences of length 4, MultiClass C=3) against ``gpsig_tpu`` with the
same numpy-seeded weights and JAX's draws: the loss, every leaf's
gradient (through the Nystrom ``eigh``) and ``predict_y``; JAX's float32
NaN when the features' rank is below the number of inducing tensors, where
the port raises; and the recipe with ``low_rank=True`` on the CPU.

Each comparison first asserts that both packages' ``eigh`` agree on the
call's Nystrom Gram.  Tolerance against JAX at float64: 1e-8 relative
(the loss to itself, each gradient to the largest leaf's, predictions to
their largest entry).
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu_torch import convert
from test_torch_inducing_sequences import _leaf
from test_torch_low_rank_ops import _close, assert_eigh_agrees, jax_draws

D, M, C, RB, NZ, LZ, K, N, L = 2, 3, 3, 4, 6, 4, 3, 5, 6
TOL = 1e-8


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, L, D).cumsum(axis=1) * 0.3
    return X, (np.arange(n) % K).astype(np.float64)[:, None]


def _models(kind, *, nz=NZ, levels=M, rank_bound=RB):
    """JAX's low-rank SVGP with perturbed float64 parameters, and the
    port's carrying them."""
    X, Y = _data(20)
    labels = Y[:, 0].astype(int)
    rng = np.random.RandomState(2)
    if kind == "tensors":
        Z = G.utils.suggest_initial_inducing_tensors(
            X, levels, nz, labels=labels, increments=True, seed=0)
        jind = G.InducingTensors(Z, levels, increments=True)
        tind = T.InducingTensors(Z, levels, increments=True,
                                 dtype=torch.float64, device="cpu")
    else:
        Z = G.utils.suggest_initial_inducing_sequences(
            X, nz, LZ, labels=labels, seed=0)
        jind = G.InducingSequences(Z, levels)
        tind = T.InducingSequences(Z, levels, dtype=torch.float64,
                                   device="cpu")
    opts = dict(low_rank=True, num_components=C, rank_bound=rank_bound,
                lengthscales=G.utils.suggest_initial_lengthscales(X))
    jmodel = G.SVGP(G.kernels.SignatureRBF(D, levels, **opts), jind,
                    G.likelihoods.MultiClass(K), num_latent=K)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    params["ind"]["Z"] = params["ind"]["Z"] + rng.randn(*Z.shape) * 0.05
    params["kern"]["variances"] = jnp.asarray(rng.randn(levels + 1) * 0.3)
    params["q_mu"] = jnp.asarray(rng.randn(nz, K) * 0.7)
    params["q_sqrt"] = jnp.asarray(
        np.tril(rng.randn(K, nz, nz)) * 0.1 + 0.6 * np.eye(nz))
    tmodel = T.SVGP(T.kernels.SignatureRBF(D, levels, dtype=torch.float64,
                                           device="cpu", **opts),
                    tind, T.likelihoods.MultiClass(K), num_latent=K,
                    device="cpu")
    convert.load_jax_params(tmodel, params)
    return jmodel, params, tmodel


def _model_draws(tmodel, key, X, *, levels=M, rank_bound=RB):
    """JAX's draws of the model's covariance call, after asserting that
    both ``eigh`` agree on its Nystrom Gram."""
    kern, ind = tmodel.kern, tmodel.ind
    with torch.no_grad():
        cp = kern.constrain()
        Z = (kern._scale_tensors(cp, ind.Z) if hasattr(ind, "increments")
             else kern._scale_sequences(cp, ind.Z))
        points = torch.cat([Z.reshape(-1, D), kern._scale_sequences(
            cp, torch.as_tensor(X, dtype=Z.dtype)).reshape(-1, D)])
        draws = jax_draws(key, points.shape[0], C=C, rank_bound=rank_bound,
                          M=levels, sparsity="sqrt", joint=True)
        lm = points[draws.landmarks].double()
        W = kern._base_kern({k: v.double() for k, v in cp.items()})(lm, lm)
        assert_eigh_agrees(W + torch.diag(1e-6 * draws.jitter))
    return draws


@pytest.mark.parametrize("kind", ["tensors", "sequences"])
def test_loss_leaf_gradients_and_predict_y(kind):
    jmodel, params, tmodel = _models(kind)
    X, Y = _data()
    key = jax.random.PRNGKey(0)
    draws = _model_draws(tmodel, key, X)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, x, y: jmodel.loss(p, x, y, key=key)))(params, X, Y)
    tmodel.zero_grad(set_to_none=True)
    tloss = tmodel.loss(torch.from_numpy(X), torch.from_numpy(Y),
                        generator=draws)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL * abs(float(jloss))
    leaves = convert.named_leaves(tmodel)
    scale = max(float(np.max(np.abs(_leaf(jgrads, n)))) for n in leaves)
    for name, p in leaves.items():
        got = p.grad.numpy()
        assert np.any(got != 0), name
        assert float(np.max(np.abs(got - _leaf(jgrads, name)))) <= (
            TOL * scale), name
    want = jax.jit(lambda p, x: jmodel.predict_y(p, x, key=key))(params, X)
    with torch.no_grad():
        got = tmodel.predict_y(torch.from_numpy(X), generator=draws)
    for a, b in zip(want, got):
        _close(a, b)


def test_rank_below_the_inducing_count_is_nan_in_jax_and_raises_here():
    """400 inducing tensors, features of rank <= 1 + 3 + 3 = 7 (M=2): Kzz
    is singular up to its jitter.  At float64 the loss is finite; at
    float32 JAX's Cholesky gives NaN and the port's raises (no retry, no
    extra jitter)."""
    jmodel, params, tmodel = _models("tensors", nz=400, levels=2,
                                     rank_bound=3)
    X, Y = _data(6)
    key = jax.random.PRNGKey(0)
    draws = _model_draws(tmodel, key, X, levels=2, rank_bound=3)
    loss = jax.jit(lambda p, x, y: jmodel.loss(p, x, y, key=key))
    with torch.no_grad():
        Kzz = tmodel.ind.Kuu(tmodel.kern, generator=draws)
        t64 = tmodel.loss(torch.from_numpy(X), torch.from_numpy(Y),
                          generator=draws).item()
    assert int(torch.linalg.matrix_rank(Kzz, hermitian=True)) <= 7
    assert np.isfinite(t64)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    assert np.isnan(float(loss(p32, X.astype(np.float32),
                               Y.astype(np.float32))))
    tmodel = copy.deepcopy(tmodel).float()
    with pytest.raises(torch.linalg.LinAlgError, match="positive-definite"):
        tmodel.loss(torch.from_numpy(X).float(), torch.from_numpy(Y).float(),
                    generator=draws.to(dtype=torch.float32))


def test_recipe_with_low_rank_features(tmp_path):
    """``train_gpsig_classifier(low_rank=True)``: the kernel JAX's recipe
    builds (``SignatureRBF(..., low_rank=True)``, 50 components), all four
    phases on the CPU at float32, results finite."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "benchmarks", "datasets"))
    from make_synthetic import write_mat

    write_mat(str(tmp_path / "SyntheticLibras.mat"), num_classes=3,
              per_class_train=8, per_class_test=4, length=16, seed=0)
    res = T.recipes.train_gpsig_classifier(
        "SyntheticLibras", num_levels=2, num_inducing=12, minibatch_size=12,
        max_len=16, val_split=0.2, data_dir=str(tmp_path),
        save_dir=str(tmp_path / "out"), epochs_cap=1, low_rank=True,
        device="cpu")
    assert all(np.isfinite(v) for v in res.values())
    assert 0.0 <= res["test_acc"] <= 1.0
