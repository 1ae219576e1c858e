"""The training slice's pieces against ``gpsig_tpu``: ``gauss_kl`` in its
four forms, the MultiClass training terms, ``NAdam`` against
``optax.nadam`` (masked as in the reference's phase 2) and the minibatch
stream.

Split from ``test_torch_training.py`` (its helpers and tolerances: <= 1e-12
for gauss_kl / MultiClass and NAdam at float64), so that no port test file
queues ahead of the suite's long JAX files under xdist's ``loadfile``.
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
from gpsig_tpu_torch import convert, training
from test_torch_training import RNG, _data, _setup


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
