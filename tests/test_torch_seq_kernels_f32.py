"""The seq x seq Gram of the port at float32 against the Pallas kernel in
interpret mode, and the plain versions' own checks: ``_SeqFn`` against
autograd of the plain forward, short sequences and the plain blocking.

Split from ``test_torch_seq_kernels.py`` (its helpers and tolerances: the
levels within 5e-5 of the largest and the gradients within 1e-4 at
float32), so that no port test file queues ahead of the suite's long JAX
files under xdist's ``loadfile``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import signature_pallas as sp
from gpsig_tpu_torch.ops import inducing_cuda as ic
from gpsig_tpu_torch.ops import signature_cuda as sc
from test_torch_seq_kernels import (M_LVL, RNG, _close, _inputs, _port)


def _pallas(base, diff, sym):
    def levels(X, X2=None):
        return sp.fused_first_order_levels(
            X, None if sym else X2, num_levels=M_LVL, base=base,
            difference=diff, block_i=4, block_j=2, fast_math=False,
            interpret=True)
    return levels


@pytest.mark.parametrize("base,diff,sym,shape,with_grad", [
    ("rbf", True, False, (3, 6, 2, 9), True),
    ("rbf", True, True, (3, 7, 3, 7), False),
    ("rbf", False, False, (2, 6, 3, 4), False),
    ("linear", True, False, (3, 9, 2, 6), False),
    ("linear", False, True, (3, 5, 3, 5), False),
])
def test_f32_against_the_pallas_kernel_in_interpret_mode(base, diff, sym,
                                                          shape, with_grad):
    X, X2 = _inputs(*shape, np.float32)
    fn = jax.jit(_pallas(base, diff, sym))
    args = (jnp.asarray(X),) if sym else (jnp.asarray(X), jnp.asarray(X2))
    if with_grad:
        ref, vjp = jax.vjp(fn, *args)
        ct = RNG.randn(*ref.shape).astype(np.float32)
        out, grads = _port(X, X2, base, diff, sym, ct)
        for want, got in zip(vjp(jnp.asarray(ct)), grads):
            _close(want, got, 1e-4)
    else:
        ref = fn(*args)
        out, _ = _port(X, X2, base, diff, sym)
    _close(ref, out, 5e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_function_path_equals_autograd_of_the_plain_forward(dtype):
    """``_SeqFn`` on CPU (plain forward, plain backward) gives the
    gradients autograd takes through ``seq_fwd_plain`` itself, in both
    modes; no kernel is launched."""
    X = torch.tensor(RNG.randn(3, 6, 2) * 0.4, dtype=dtype,
                     requires_grad=True)
    X2 = torch.tensor(RNG.randn(2, 8, 2) * 0.4, dtype=dtype,
                      requires_grad=True)
    launches = (sc.seq_fwd.launches, sc.seq_bwd.launches)
    kw = dict(num_levels=M_LVL, base="rbf", difference=True)
    for sym in (False, True):
        Y = X if sym else X2

        def rows():
            return (*ic._prep_seq(X, "rbf", lhs=True),
                    *ic._prep_seq(Y, "rbf", lhs=False))

        ct = torch.tensor(RNG.randn(M_LVL + 1, 3, Y.shape[0]), dtype=dtype)
        got = torch.autograd.grad(
            torch.sum(sc._SeqFn.apply(*rows(), *kw.values(), sym) * ct),
            (X, X2), allow_unused=True)
        want = torch.autograd.grad(
            torch.sum(sc.seq_fwd_plain(*rows(), symmetric=sym, **kw) * ct),
            (X, X2), allow_unused=True)
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            scale = max(float(w.abs().max()), 1.0)
            assert float((g - w).abs().max()) <= tol * scale
    assert (sc.seq_fwd.launches, sc.seq_bwd.launches) == launches


def test_short_sequences_and_plain_blocking(monkeypatch):
    """One observation (no step) gives zero levels past 0; the plain
    versions' blocking over sequences changes nothing."""
    X, X2 = _inputs(3, 1, 2, 5, np.float64)
    out, _ = _port(X, X2, "rbf", True, False)
    assert np.array_equal(out[0], np.ones((3, 2)))
    assert not np.any(out[1:])
    X, X2 = _inputs(4, 6, 3, 7, np.float64)
    rows = (*ic._prep_seq(torch.from_numpy(X), "rbf", lhs=True),
            *ic._prep_seq(torch.from_numpy(X2), "rbf"))
    kw = dict(num_levels=M_LVL, base="rbf", difference=True)
    whole = sc.seq_fwd_plain(*rows, **kw)
    ct = torch.from_numpy(RNG.randn(M_LVL + 1, 4, 3))
    g_whole = sc.seq_bwd_plain(*rows, ct, **kw)
    monkeypatch.setattr(sc, "_PLAIN_BLOCK", 1)
    blocked = sc.seq_fwd_plain(*rows, **kw)
    g_blocked = sc.seq_bwd_plain(*rows, ct, **kw)
    assert float((whole - blocked).abs().max()) <= 1e-14
    for a, b in zip(g_whole, g_blocked):
        assert float((a - b).abs().max()) <= 1e-12
