"""The lagged width and the recipe's training on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` and skip elsewhere.
Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda_recipe.py --noconftest -o addopts='' -q

* K1-K6 at the lagged width (d=14, ``num_lags=1``: d2 = 30) against their
  plain versions, on rows scaled as ``SignatureKernel`` scales them, under
  ``test_torch_cuda_kernels.py``'s bounds (forward <= 1e-5 * max(scale, 1)
  against the f32 plain version, backward <= 1e-4 * max(scale, 1); the
  seq x seq kernels against the f64 plain version);
* a lagged training step's gradients against the f64 CPU path: each
  leaf's L2 error <= 1e-3 of the larger of its norm and 1e-3 of the
  largest leaf's (``chip_smoke.py``'s rule; ``kern/sigma`` against
  ``kern/variances``' norm);
* a training run killed between two checkpoints and resumed by a fresh
  model, optimizer and stream ends bit for bit where the uninterrupted run
  ends.
"""

import numpy as np
import pytest
import torch

import gpsig_tpu_torch as T
from gpsig_tpu_torch import convert, training
from gpsig_tpu_torch.ops import inducing_cuda as ic
from gpsig_tpu_torch.ops import signature_cuda as sc

pytestmark = pytest.mark.cuda

D, M, NZ, N, L, LAGS = 14, 3, 48, 8, 30, 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lagged_rows(dtype):
    """Inducing tensors, inducing sequences and data scaled and lagged by a
    ``SignatureKernel(num_lags=1)``, as augmented rows on the card."""
    rng = np.random.RandomState(0)
    X = rng.randn(N + 40, L, D).cumsum(axis=1) / np.sqrt(L)
    kern = T.kernels.SignatureRBF(
        D, M, lengthscales=T.utils.suggest_initial_lengthscales(X),
        num_lags=LAGS, dtype=dtype, device="cuda")
    Z = T.utils.suggest_initial_inducing_tensors(X, M, NZ, increments=True,
                                                 num_lags=LAGS, seed=0)
    S = T.utils.suggest_initial_inducing_sequences(X, NZ, M + 1, seed=0)
    with torch.no_grad():
        cp = kern.constrain()
        Zt = kern._scale_tensors(cp, torch.as_tensor(Z, dtype=dtype,
                                                     device="cuda"))
        Xt = kern._scale_sequences(cp, torch.as_tensor(X[:N], dtype=dtype,
                                                       device="cuda"))
        St = kern._scale_sequences(cp, torch.as_tensor(S, dtype=dtype,
                                                       device="cuda"))
    zz = (*ic._prep_tensors(Zt, "rbf", True, lhs=True),
          *ic._prep_tensors(Zt, "rbf", True, lhs=False))
    zx = (*zz[:2], *ic._prep_seq(Xt, "rbf"))
    sx = (*ic._prep_seq(St, "rbf", lhs=True), *ic._prep_seq(Xt, "rbf"))
    assert zx[2].shape[-1] == (LAGS + 1) * D + 2
    cz, cx = (torch.as_tensor(rng.randn(M + 1, NZ, n), dtype=dtype,
                              device="cuda") for n in (NZ, N))
    return zz, zx, sx, cz, cx


def _within(out, ref, bound):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        scale = max(float(r.abs().max()), 1.0)
        assert float((o.double() - r.double()).abs().max()) <= bound * scale


def test_kernels_at_the_lagged_width(cuda):
    (zz, zx, sx, cz, cx), (zz64, zx64, sx64, cz64, cx64) = (
        _lagged_rows(torch.float32), _lagged_rows(torch.float64))
    kw = dict(num_levels=M, base="rbf", increments=True)
    kwz, kwx = dict(kw, symmetric=True), dict(kw, difference=True)
    kws = dict(num_levels=M, base="rbf", difference=True, symmetric=False)
    out = ic.kzz_fwd(*zz, **kwz)
    assert torch.equal(out, out.transpose(1, 2))
    _within(out, ic.kzz_fwd_plain(*zz, **kwz), 1e-5)
    _within(ic.kzx_fwd(*zx, **kwx), ic.kzx_fwd_plain(*zx, **kwx), 1e-5)
    _within(sc.seq_fwd(*sx, **kws), sc.seq_fwd_plain(*sx64, **kws), 1e-4)
    for fn, plain, rows, ct, kwa in (
            (ic.kzz_bwd, ic.kzz_bwd_plain, zz, cz, kwz),
            (ic.kzx_bwd, ic.kzx_bwd_plain, zx, cx, kwx),
            (sc.seq_bwd, sc.seq_bwd_plain, sx, cx, kws)):
        grads = fn(*rows, ct, **kwa)
        assert all(torch.equal(a, b)
                   for a, b in zip(grads, fn(*rows, ct, **kwa)))
        _within(grads, plain(*rows, ct, **kwa), 1e-4)


def _lagged_model(dtype, device, fused="auto"):
    rng = np.random.RandomState(1)
    X = rng.randn(60, L, D).cumsum(axis=1) / np.sqrt(L)
    y = np.arange(60) % 3
    Z = T.utils.suggest_initial_inducing_tensors(
        X, M, NZ, labels=y, increments=True, num_lags=LAGS, seed=0)
    model = T.SVGP(
        T.kernels.SignatureRBF(
            D, M, lengthscales=T.utils.suggest_initial_lengthscales(X),
            num_lags=LAGS, fused=fused, dtype=dtype, device=device),
        T.InducingTensors(Z, M, increments=True, dtype=dtype, device=device),
        T.likelihoods.MultiClass(3), num_latent=3, num_data=60,
        device=device)
    tree = convert.to_numpy_tree(model)
    tree["q_mu"] = rng.randn(NZ, 3) * 0.5
    tree["q_sqrt"] = (np.tril(rng.randn(3, NZ, NZ)) * 0.05
                      + 0.5 * np.eye(NZ)[None])
    tree["kern"]["lags"] = tree["kern"]["lags"] + 0.5
    convert.load_jax_params(model, tree)
    return model, X, y[:, None].astype(np.float64)


def test_lagged_step_gradients_against_the_f64_cpu_path(cuda):
    grads = {}
    for dtype, device, fused in ((torch.float32, "cuda", "on"),
                                 (torch.float64, "cpu", "auto")):
        model, X, Y = _lagged_model(dtype, device, fused)
        loss = model.loss(torch.as_tensor(X[:16], dtype=dtype, device=device),
                          torch.as_tensor(Y[:16], dtype=dtype, device=device))
        loss.backward()
        grads[device] = {n: p.grad.detach().double().cpu()
                         for n, p in convert.named_leaves(model).items()}
    ref = grads["cpu"]
    assert {"kern/lags", "kern/gamma"} <= set(ref)
    top = max(float(g.norm()) for g in ref.values())
    for name, want in ref.items():
        floor = float(ref["kern/variances"].norm()) if name == "kern/sigma" \
            else 0.0
        denom = max(float(want.norm()), 1e-3 * top, floor)
        assert float((grads["cuda"][name] - want).norm()) <= 1e-3 * denom, name


def test_kill_and_resume_is_bit_identical_on_the_card(cuda, tmp_path):
    class Killed(Exception):
        pass

    class KillAt:
        def __init__(self, it, n):
            self.it, self.n = it, n

        def __next__(self):
            if self.n == 0:
                raise Killed
            self.n -= 1
            return next(self.it)

        def state(self):
            return self.it.state()

        def set_state(self, state):
            self.it.set_state(state)

    def run(path, seed, kill=None, resume=False):
        model, X, Y = _lagged_model(torch.float32, "cuda", "on")
        data = training.BatchIterator(training.MinibatchStream(60, 10, seed),
                                      X.astype(np.float32),
                                      Y.astype(np.float32), device="cuda")
        training.optimize(
            lambda m, xb, yb: m.loss(xb, yb), model, training.nadam(1e-2),
            max_iter=12, data_iter=data if kill is None else KillAt(data, kill),
            save_freq=4, print_freq=100, checkpoint_path=str(path),
            resume_from=str(path) if resume else None,
            log_fn=lambda *_: None)
        return model

    whole = run(tmp_path / "a.ckpt", 3)
    with pytest.raises(Killed):
        run(tmp_path / "b.ckpt", 3, kill=6)  # between the checkpoints at 4, 8
    resumed = run(tmp_path / "b.ckpt", 99, resume=True)
    a, b = convert.named_leaves(whole), convert.named_leaves(resumed)
    for name in a:
        assert torch.equal(a[name], b[name]), name
