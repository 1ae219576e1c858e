"""The seq x seq Gram of the port (``ops/signature_cuda``: K5/K6's plain
versions behind ``_SeqFn`` on CPU tensors) against the JAX package.

At float64 against the JAX reference graph (base Gram +
``signature.signature_kern_first_order``) and ``jax.vjp`` of it: the levels
within 1e-10 and the gradients within 1e-9 of the largest entry.  At
float32 against the Pallas kernel in interpret mode (``fast_math=False``):
the levels within 5e-5 of the largest (``tests/test_pallas.py``'s bound)
and, on the cross case with L1 != L2, its VJP within 1e-4 of the largest
(the gradients sum many more terms in another order; the symmetric mode's
gradients are held at float64).  Shapes: d=2, M=3, N <= 4, L <= 9, with L1 != L2 and
the symmetric mode; JAX is called through ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import base_kernels
from gpsig_tpu.ops import signature as sig_ops
from gpsig_tpu.ops import signature_pallas as sp
from gpsig_tpu_torch.ops import inducing_cuda as ic
from gpsig_tpu_torch.ops import signature_cuda as sc

RNG = np.random.RandomState(31)
M_LVL = 3


def _ref(base, diff, sym):
    kf = base_kernels.get(base)

    def levels(X, X2):
        X2 = X if sym else X2
        (n1, l1, d), (n2, l2, _) = X.shape, X2.shape
        G = kf({}, X.reshape(-1, d), X2.reshape(-1, d)).reshape(n1, l1, n2,
                                                               l2)
        return sig_ops.signature_kern_first_order(G, M_LVL, difference=diff)
    return levels


def _inputs(n1, l1, n2, l2, dtype, scale=0.5):
    X = (RNG.randn(n1, l1, 2) * scale / np.sqrt(l1)).cumsum(1).astype(dtype)
    X2 = (RNG.randn(n2, l2, 2) * scale / np.sqrt(l2)).cumsum(1).astype(dtype)
    return X, X2


def _port(X, X2, base, diff, sym, grad_ct=None):
    """Levels (and, given a cotangent, the gradients) from the port."""
    xs = [torch.from_numpy(X).requires_grad_()]
    if not sym:
        xs.append(torch.from_numpy(X2).requires_grad_())
    out = sc.fused_first_order_levels(xs[0], None if sym else xs[1],
                                      num_levels=M_LVL, base=base,
                                      difference=diff)
    if grad_ct is None:
        return out.detach().numpy(), None
    grads = torch.autograd.grad(out, xs, torch.from_numpy(grad_ct))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(ref, out, tol):
    ref = np.asarray(ref, dtype=np.float64)
    out = np.asarray(out, dtype=np.float64)
    assert ref.shape == out.shape
    assert float(np.max(np.abs(ref - out))) <= tol * float(
        np.max(np.abs(ref)))


CASES = [  # base, difference, symmetric, (n1, l1, n2, l2)
    ("rbf", True, False, (3, 6, 2, 9)),
    ("rbf", True, True, (4, 7, 4, 7)),
    ("rbf", False, False, (3, 6, 2, 9)),
    ("rbf", False, True, (3, 5, 3, 5)),
    ("linear", True, False, (3, 9, 2, 6)),
    ("linear", True, True, (3, 5, 3, 5)),
    ("linear", False, False, (2, 4, 3, 7)),
]


@pytest.mark.parametrize("base,diff,sym,shape", CASES)
def test_levels_and_gradients_f64(base, diff, sym, shape):
    X, X2 = _inputs(*shape, np.float64)
    ref_fn = _ref(base, diff, sym)
    args = (jnp.asarray(X),) if sym else (jnp.asarray(X), jnp.asarray(X2))
    ref, vjp = jax.vjp(jax.jit(ref_fn if not sym else
                               (lambda x: ref_fn(x, None))), *args)
    ct = RNG.randn(*ref.shape)
    out, grads = _port(X, X2, base, diff, sym, ct)
    _close(ref, out, 1e-10)
    for want, got in zip(vjp(jnp.asarray(ct)), grads):
        _close(want, got, 1e-9)
    if sym:
        assert np.array_equal(out, np.swapaxes(out, 1, 2))


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


def test_wrappers_check_their_inputs():
    V = torch.zeros(3, 5, 4)
    with pytest.raises(ValueError, match="cotangent"):
        sc.seq_bwd(V, V, V, V, torch.zeros(M_LVL + 1, 3, 2),
                   num_levels=M_LVL, base="rbf", difference=True)
    with pytest.raises(ValueError, match="symmetric"):
        sc.seq_fwd(V, V, V[:2], V[:2], num_levels=M_LVL, base="rbf",
                   difference=True, symmetric=True)
    with pytest.raises(NotImplementedError, match="Queue 1, item 2"):
        sc.seq_fwd(V, V, V, V, num_levels=M_LVL, base="matern12",
                   difference=True)
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        sc.fused_first_order_levels(torch.zeros(2, 4, 2), num_levels=M_LVL,
                                    order=2)
    meta = torch.zeros(3, 5, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sc.seq_fwd(meta, meta, meta, meta, num_levels=M_LVL, base="rbf",
                   difference=True)
