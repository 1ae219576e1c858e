"""K5/K6 at order > 1 on CPU tensors (their plain versions behind
``signature_cuda.fused_first_order_levels``) against the JAX package.

* At float32 against the Pallas kernel in interpret mode at the shape of
  ``tests/test_pallas.py:165-197`` (N1=4, N2=3, L=12, d=2, M=4; orders 2
  and 4, ``fast_math=False``), under that test's bounds: the levels within
  1e-4 * max(scale, 1), the gradient within 2e-3 * max(scale, 1).
* At float64 against the JAX reference graph (base Gram +
  ``signature.signature_kern_higher_order``) and ``jax.vjp`` of it: levels
  and gradients within 1e-10 of the largest, for rbf, linear and matern12
  (cross pairs; matern12's symmetric mode meets the |.| kink of exp(-r),
  where f64 autograd of the naive graph is no reference: its test file
  holds it), the symmetric mode, both argument orders (the grid transposes
  with the roles) and L1 != L2.
* The explicit VJP of the grid (``signature_cuda._levels_vjp``, written as
  ``_pair_levels_bwd``: what K6 computes) against torch autograd of the
  plain forward, within 1e-12 of the largest at float64.
* Repeat padding exact: a sequence repeated at its last observation gives
  the same levels and gradients (the repeats' summed into the last
  step's), within 1e-12.
JAX is called through ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import base_kernels as jbk
from gpsig_tpu.ops import signature as jsig
from gpsig_tpu.ops import signature_pallas as sp
from gpsig_tpu_torch.ops import signature_cuda as sc

M_LVL = 4


def _close(ref, out, tol):
    ref = np.asarray(ref, dtype=np.float64)
    out = np.asarray(out, dtype=np.float64)
    assert ref.shape == out.shape
    assert float(np.max(np.abs(ref - out))) <= tol * max(
        float(np.max(np.abs(ref))), 1.0)


def _paths(rng, n, length, dtype=np.float64):
    return (rng.randn(n, length, 2) * 0.5 / np.sqrt(length)).cumsum(
        1).astype(dtype)


def _port(X, X2, order, base="rbf", ct=None, sym=False):
    xs = [torch.from_numpy(X).requires_grad_()]
    if not sym:
        xs.append(torch.from_numpy(X2).requires_grad_())
    out = sc.fused_first_order_levels(xs[0], None if sym else xs[1],
                                      num_levels=M_LVL, base=base,
                                      order=order)
    if ct is None:
        return out.detach().numpy(), None
    return out.detach().numpy(), [g.numpy() for g in torch.autograd.grad(
        out, xs, torch.from_numpy(ct))]


@pytest.mark.parametrize("order", [2, 4])
def test_f32_against_the_pallas_kernel_in_interpret_mode(order):
    rng = np.random.RandomState(40 + order)
    N1, N2, L, d = 4, 3, 12, 2
    X = (rng.randn(N1, L, d) / 3).astype(np.float32)
    X2 = (rng.randn(N2, L, d) / 3).astype(np.float32)

    def pallas(a, b):
        return sp.fused_first_order_levels(
            a, b, num_levels=M_LVL, order=order, base="rbf", block_i=4,
            block_j=2, fast_math=False, interpret=True)

    ref, vjp = jax.vjp(jax.jit(pallas), jnp.asarray(X), jnp.asarray(X2))
    ct = rng.randn(*ref.shape).astype(np.float32)
    out, grads = _port(X, X2, order, ct=ct)
    _close(ref, out, 1e-4)
    for want, got in zip(vjp(jnp.asarray(ct)), grads):
        _close(want, got, 2e-3)


def _reference(base, order, sym):
    kf = jbk.get(base)

    def levels(X, X2=None):
        X2 = X if sym else X2
        (n1, l1, d), (n2, l2, _) = X.shape, X2.shape
        G = kf({}, X.reshape(-1, d), X2.reshape(-1, d)).reshape(n1, l1, n2,
                                                               l2)
        return jsig.signature_kern_higher_order(G, M_LVL, order=order)
    return levels


@pytest.mark.parametrize("base,order,sym,shape", [
    ("rbf", 2, False, (3, 6, 2, 9)),
    ("rbf", 3, False, (2, 9, 3, 6)),
    ("rbf", 4, True, (4, 7, 4, 7)),
    ("linear", 2, False, (3, 9, 2, 6)),
    ("matern12", 4, False, (3, 6, 2, 9)),
])
def test_levels_and_gradients_f64(base, order, sym, shape):
    rng = np.random.RandomState(50 + order)
    X, X2 = _paths(rng, *shape[:2]), _paths(rng, *shape[2:])
    ref_fn = _reference(base, order, sym)
    args = (jnp.asarray(X),) if sym else (jnp.asarray(X), jnp.asarray(X2))
    ref, vjp = jax.vjp(jax.jit(ref_fn), *args)
    ct = rng.randn(*ref.shape)
    out, grads = _port(X, X2, order, base, ct, sym)
    _close(ref, out, 1e-10)
    for want, got in zip(vjp(jnp.asarray(ct)), grads):
        _close(want, got, 1e-10)
    if sym:
        assert np.array_equal(out, np.swapaxes(out, 1, 2))
    else:  # the other argument order: the transpose, and the same grads
        out_t, grads_t = _port(X2, X, order, base,
                               np.ascontiguousarray(np.swapaxes(ct, 1, 2)))
        _close(out, np.swapaxes(out_t, 1, 2), 1e-12)
        for a, b in zip(grads, grads_t[::-1]):
            _close(a, b, 1e-12)


def test_explicit_vjp_against_autograd_of_the_plain_forward():
    """``_levels_vjp`` at orders 2, 3 and 4 (the adjoint K6 runs: the
    double suffix, Tbar, Ubar and the pointwise terms) against autograd
    through ``_levels``; at order 1 too."""
    gen = torch.Generator().manual_seed(60)
    M = torch.randn(3, 2, 6, 8, dtype=torch.float64, generator=gen) * 0.5
    for order in (1, 2, 3, 4):
        Mg = M.clone().requires_grad_()
        lv = sc._levels(Mg, M_LVL, order)
        ct = torch.randn(lv.shape, dtype=torch.float64, generator=gen)
        want, = torch.autograd.grad(lv, Mg, ct)
        _close(want.numpy(), sc._levels_vjp(M, ct, M_LVL, order).numpy(),
               1e-12)


def test_repeat_padding_is_exact():
    """dx = 0 at the repeated steps zeroes every tile of the grid there:
    the levels and the gradients at the true steps do not change."""
    rng = np.random.RandomState(61)
    X, X2 = _paths(rng, 3, 6), _paths(rng, 2, 9)
    Xp = np.concatenate([X, np.repeat(X[:, -1:], 4, axis=1)], axis=1)
    for order in (2, 4):
        ct = rng.randn(M_LVL + 1, 3, 2)
        out, grads = _port(X, X2, order, ct=ct)
        outp, gradsp = _port(Xp, X2, order, ct=ct)
        _close(out, outp, 1e-12)
        # the last observation and its repeats are one point: their
        # gradients sum to the unpadded last step's
        g_pad = np.concatenate([gradsp[0][:, :5],
                                gradsp[0][:, 5:].sum(1, keepdims=True)], 1)
        _close(grads[0], g_pad, 1e-12)
        _close(grads[1], gradsp[1], 1e-12)
