"""Two faults of the port against the reference, held on the CPU.

* ``serving.Predictor`` leaves the caller's module as it found it -- its
  dtype, device, train/eval mode and parameter storage -- and answers from
  the parameters it was given at construction, as JAX's ``Predictor``
  answers from its ``params`` (``gpsig_tpu/serving.py:100-113``).
* ``kern/lags``' gradient at float32 on a small lagged MultiClass model
  (one seed) with white-noise data, the kind of data on which the card
  reads 1.28e-3 of its norm (PERF.md): the port's float32 error is at most
  twice JAX's own float32 error plus 1e-6, both read as relative L2 errors
  against JAX at float64.  On white noise the leaf is a nearly cancelling
  sum, and one minibatch's reading at float32 is one draw of rounding:
  over 20 minibatches each package's reading spans from below 1e-8 to
  2e-4, and a single minibatch puts either package past twice the other's
  plus 1e-6 (the port past JAX on 5 of 20, JAX past the port on 6).  So each
  package's error is its median over the same 20 minibatches (seeds 0-19).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gpsig_tpu_torch as T
from gpsig_tpu_torch import convert
from test_torch_lags_svgp import _leaf, _setup

C, N, L, D = 3, 8, 7, 2


def test_predictor_leaves_the_callers_module_alone():
    _, _, model = _setup("tensors", 1, torch.float32)
    model.train()
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pred = T.serving.Predictor(model, len_buckets=(8,), batch_buckets=(4,),
                               device="cpu", dtype=torch.float64)
    assert pred.model is not model and not pred.model.training
    assert model.training
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.device.type == "cpu", n
        assert p.data_ptr() == ptrs[n] and torch.equal(p, before[n]), n
    assert all(p.dtype == torch.float64 for p in pred.model.parameters())
    Xq = np.random.RandomState(5).randn(3, 6, D)
    mean, _ = pred.predict_y(Xq)
    with torch.no_grad():  # later changes to the caller's module stay out
        model.q_mu.add_(1.0)
    again, _ = pred.predict_y(Xq)
    assert mean.dtype == torch.float64 and torch.equal(mean, again)


def _white_noise(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(N, L, D), (np.arange(N) % C).astype(np.float64)[:, None]


def test_kern_lags_f32_gradient_against_jax():
    jmodel, params, _ = _setup("tensors", 1)
    _, _, tmodel = _setup("tensors", 1, torch.float32)
    grad = jax.jit(jax.grad(jmodel.loss))
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    errs = []
    for seed in range(20):
        X, Y = _white_noise(seed)
        want = _leaf(grad(params, X, Y), "kern/lags")
        jax32 = _leaf(grad(p32, X.astype(np.float32), Y.astype(np.float32)),
                      "kern/lags")
        tmodel.zero_grad()
        tmodel.loss(torch.from_numpy(X).float(),
                    torch.from_numpy(Y).float()).backward()
        port32 = convert.named_leaves(tmodel)["kern/lags"].grad.double()
        norm = float(np.linalg.norm(want))
        errs.append((float(np.linalg.norm(jax32 - want)) / norm,
                     float(np.linalg.norm(port32.numpy() - want)) / norm))
    err_jax, err_port = np.median(np.array(errs), axis=0)
    print(f"kern/lags f32 relative L2 error, median of 20 minibatches: "
          f"port {err_port:.3e}, JAX {err_jax:.3e}")
    assert err_port <= 2.0 * err_jax + 1e-6, (err_port, err_jax)
