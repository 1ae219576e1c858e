"""K5/K6 under the matern12 base on CPU tensors (their plain versions behind
``signature_cuda.fused_first_order_levels``) against the JAX package: the
Pallas kernel in interpret mode at float32 (``fast_math=False``), the JAX
reference graph (base Gram + ``signature.signature_kern_first_order``) at
float64; repeat padding; and a duplicated observation inside an inducing
sequence, where the dead-step mask of the backward decides the gradient.

Tolerances: at float32 the levels within 5e-5 of each level's largest
(``tests/test_pallas.py``'s bound) and the gradients within 1e-4 of the
largest; in the symmetric mode a sequence meets itself, and at its own
steps (r = 0, the |.| kink of exp(-r)) JAX's own matern12 bounds apply
(``tests/test_inducing_pallas.py:52-53``): 2e-3 forward and 5e-3 gradient.
At float64: 1e-9 of the largest.  Repeat padding: the padded and the
unpadded levels and gradients within 1e-12 at float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import signature_pallas as sp
from gpsig_tpu_torch.ops import signature_cuda as sc
from test_torch_seq_kernels import M_LVL, _ref

KINK_FWD, KINK_BWD = 2e-3, 5e-3  # tests/test_inducing_pallas.py:52-53


def _inputs(n1, l1, n2, l2, dtype, seed):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n1, l1, 2) * 0.5 / np.sqrt(l1)).cumsum(1).astype(dtype)
    X2 = (rng.randn(n2, l2, 2) * 0.5 / np.sqrt(l2)).cumsum(1).astype(dtype)
    return X, X2, rng


def _close(ref, out, tol, levels=False):
    """Within tol of the largest entry (of each level with ``levels``)."""
    ref = np.asarray(ref, dtype=np.float64)
    out = np.asarray(out, dtype=np.float64)
    assert ref.shape == out.shape
    for r, o in (zip(ref, out) if levels else ((ref, out),)):
        assert float(np.max(np.abs(r - o))) <= tol * max(
            float(np.max(np.abs(r))), 1.0)


def _pallas(sym):
    def levels(*xs):
        return sp.fused_first_order_levels(
            xs[0], None if sym else xs[1], num_levels=M_LVL, base="matern12",
            difference=True, block_i=4, block_j=2, fast_math=False,
            interpret=True)
    return levels


def _port(xs, sym, ct=None):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = sc.fused_first_order_levels(ts[0], None if sym else ts[1],
                                      num_levels=M_LVL, base="matern12")
    if ct is None:
        return out.detach().numpy(), None
    grads = torch.autograd.grad(out, ts, torch.from_numpy(ct))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax(fn, xs, ct):
    """Levels and VJP of fn at xs under ct, each one jax.jit program."""
    args = [jnp.asarray(x) for x in xs]
    ref = jax.jit(fn)(*args)
    grads = jax.jit(lambda c, *a: jax.vjp(fn, *a)[1](c))(jnp.asarray(ct),
                                                          *args)
    return np.asarray(ref), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("sym", [False, True])
def test_f32_against_the_pallas_kernel_in_interpret_mode(sym):
    X, X2, rng = _inputs(3, 6, 2, 9, np.float32, seed=1)
    xs = [X] if sym else [X, X2]
    n2 = 3 if sym else 2
    ct = rng.randn(M_LVL + 1, 3, n2).astype(np.float32)
    ref, g_ref = _jax(_pallas(sym), xs, ct)
    out, g_out = _port(xs, sym, ct)
    if sym:  # distinct sequences at phase 2's bounds, all at the kink's
        off = ~np.eye(3, dtype=bool)
        _close(ref[:, off], out[:, off], 5e-5, levels=True)
        _close(ref, out, KINK_FWD, levels=True)
        for r, o in zip(g_ref, g_out):
            _close(r, o, KINK_BWD)
    else:
        _close(ref, out, 5e-5, levels=True)
        for r, o in zip(g_ref, g_out):
            _close(r, o, 1e-4)


def test_f64_against_the_reference_graph():
    X, X2, rng = _inputs(3, 7, 2, 5, np.float64, seed=2)
    ct = rng.randn(M_LVL + 1, 3, 2)
    kf = _ref("matern12", True, False)
    ref, g_ref = _jax(kf, [X, X2], ct)
    out, g_out = _port([X, X2], False, ct)
    _close(ref, out, 1e-9, levels=True)
    for r, o in zip(g_ref, g_out):
        _close(r, o, 1e-9)


def test_repeat_padding_is_exact():
    """Inducing sequences against data padded by repeating the last
    observation (``serving.Predictor``'s buckets, no lags): the padded steps
    are zero steps, whose increment entries are exactly 0, so the levels,
    the inducing sequences' gradient and the data's gradient (summed over
    the copies of the last observation) equal the unpadded ones; at
    float32 the padded call equals the Pallas kernel's on the same padded
    input."""
    Zs, X, rng = _inputs(4, 5, 3, 9, np.float64, seed=3)
    pad = 4
    Xp = np.concatenate([X, np.repeat(X[:, -1:], pad, 1)], 1)
    ct = rng.randn(M_LVL + 1, 4, 3)
    out, (gz, gx) = _port([Zs, X], False, ct)
    outp, (gzp, gxp) = _port([Zs, Xp], False, ct)
    gxp = np.concatenate([gxp[:, :-pad - 1],
                          gxp[:, -pad - 1:].sum(1, keepdims=True)], 1)
    for a, b in ((out, outp), (gz, gzp), (gx, gxp)):
        _close(a, b, 1e-12)
    xs = [Zs.astype(np.float32), Xp.astype(np.float32)]
    ref, g_ref = _jax(_pallas(False), xs, ct.astype(np.float32))
    out32, g_out32 = _port(xs, False, ct.astype(np.float32))
    _close(ref, out32, 5e-5, levels=True)
    for r, o in zip(g_ref, g_out32):
        _close(r, o, 1e-4)


def test_duplicated_observation_in_an_inducing_sequence():
    """An inducing sequence that repeats an observation has a genuine zero
    step.  Its increment entries are 0 exactly, and the backward masks their
    cotangent (``_kernel_bwd``'s dead-step mask, ``signature_pallas.py``
    :991-1017): the port's gradient equals the Pallas kernel's in interpret
    mode.  Autograd of the naive graph at float64 gives the repeated
    observation's copies gradients that the mask drops (the |.| kink's
    one-sided derivatives); at this input the port's gradient of the
    inducing sequences reads 1.75e-2 of its largest entry off the float64
    autograd one at both copies of the repeated observation, and within
    4e-7 of it elsewhere (the data's gradient within 5e-7)."""
    Zs, X, rng = _inputs(3, 5, 2, 8, np.float32, seed=4)
    Zs[1, 3] = Zs[1, 2]  # observation 2 repeated: step 2 of sequence 1 is 0
    ct = rng.randn(M_LVL + 1, 3, 2).astype(np.float32)
    ref, g_ref = _jax(_pallas(False), [Zs, X], ct)
    out, g_out = _port([Zs, X], False, ct)
    _close(ref, out, 5e-5, levels=True)
    for r, o in zip(g_ref, g_out):
        _close(r, o, 1e-4)
    _, g64 = _jax(_ref("matern12", True, False),
                  [Zs.astype(np.float64), X.astype(np.float64)],
                  ct.astype(np.float64))
    gap = np.abs(g64[0] - g_out[0]) / np.max(np.abs(g64[0]))
    assert float(np.max(np.delete(gap, 1, axis=0))) < 1e-4
    assert float(np.max(gap[1, 2:4])) > 1e-2
