"""The order > 1 recursions of the port against ``gpsig_tpu`` at float64:
``ops/signature.signature_kern_higher_order`` and
``signature_kern_tens_vs_seq_higher_order`` (the reference graphs),
``ops/gram.higher_order_levels_batched``, ``tens_vs_seq_slot_grams`` and
``tens_vs_seq_levels_mxu``, at orders 2, 3 and M (the full grid), with the
time difference on and off.  The same numpy-seeded inputs go to both
packages; each level stack within 1e-10 of its largest entry (the same
sums in another order).  Shapes: d=2, M=4, a few sequences of <= 9 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import base_kernels as jbk
from gpsig_tpu.ops import gram as jgram
from gpsig_tpu.ops import signature as jsig
from gpsig_tpu_torch.ops import gram as tgram
from gpsig_tpu_torch.ops import signature as tsig

M_LVL, D = 4, 2
TOL = 1e-10
ORDERS = [2, 3, M_LVL]


def _close(ref, out, tol=TOL):
    ref = np.asarray(ref, dtype=np.float64)
    out = np.asarray(out, dtype=np.float64)
    assert ref.shape == out.shape
    assert float(np.max(np.abs(ref - out))) <= tol * float(
        np.max(np.abs(ref)))


def _paths(rng, n, length):
    return (rng.randn(n, length, D) * 0.6 / np.sqrt(length)).cumsum(axis=1)


def _gram(X, X2):
    (n1, l1, _), (n2, l2, _) = X.shape, X2.shape
    return np.array(jbk.get("rbf")(
        {}, jnp.asarray(X.reshape(-1, D)),
        jnp.asarray(X2.reshape(-1, D)))).reshape(n1, l1, n2, l2)


@pytest.mark.parametrize("order", ORDERS)
def test_signature_kern_higher_order(order):
    """The (order x order) grid on a cross Gram (L1 != L2) and on a batch
    of square Grams (the Kxx diagonal's shape), difference on and off."""
    rng = np.random.RandomState(order)
    G = _gram(_paths(rng, 3, 6), _paths(rng, 2, 9))
    Gd = np.stack([_gram(x[None], x[None])[0, :, 0] for x in
                   _paths(rng, 3, 7)])
    ref_fn = jax.jit(jsig.signature_kern_higher_order,
                     static_argnums=(1, 2, 3))
    for M, diff in ((G, True), (G, False), (Gd, True), (Gd, False)):
        ref = ref_fn(jnp.asarray(M), M_LVL, order, diff)
        out = tsig.signature_kern_higher_order(
            torch.from_numpy(M), M_LVL, order=order, difference=diff)
        _close(ref, out)


@pytest.mark.parametrize("order", ORDERS)
def test_tens_vs_seq_higher_order_and_levels_mxu(order):
    """Tensors vs sequences at order > 1: the reference graph on slot Grams
    (difference on and off) and the triangular-matmul recursion on
    pre-differenced slot Grams."""
    rng = np.random.RandomState(10 + order)
    lt = M_LVL * (M_LVL + 1) // 2
    Ms = rng.randn(lt, 5, 3, 8) * 0.5
    ref_fn = jax.jit(jsig.signature_kern_tens_vs_seq_higher_order,
                     static_argnums=(1, 2, 3))
    for diff in (True, False):
        _close(ref_fn(jnp.asarray(Ms), M_LVL, order, diff),
               tsig.signature_kern_tens_vs_seq_higher_order(
                   torch.from_numpy(Ms), M_LVL, order=order,
                   difference=diff))
    mxu = jax.jit(jgram.tens_vs_seq_levels_mxu, static_argnums=(1, 2))
    ref = mxu(jnp.asarray(Ms), M_LVL, order)
    _close(ref, tgram.tens_vs_seq_levels_mxu(torch.from_numpy(Ms), M_LVL,
                                             order=order))
    # the same function as the reference graph on pre-differenced Grams
    _close(ref, tsig.signature_kern_tens_vs_seq_higher_order(
        torch.from_numpy(Ms), M_LVL, order=order, difference=False))


@pytest.mark.parametrize("order", [2, M_LVL])
def test_higher_order_levels_batched(order):
    """The batched grid with triangular-ones cumsums, on (A, B, L1, L2)
    Grams, difference on and off; equal to the reference graph."""
    rng = np.random.RandomState(20 + order)
    G = _gram(_paths(rng, 3, 6), _paths(rng, 2, 9))
    Gb = np.ascontiguousarray(np.transpose(G, (0, 2, 1, 3)))
    for diff in (True, False):
        ref = jax.jit(lambda g, dif=diff: jgram.higher_order_levels_batched(
            g, M_LVL, order, difference=dif))(jnp.asarray(Gb))
        out = tgram.higher_order_levels_batched(
            torch.from_numpy(Gb), M_LVL, order, difference=diff)
        _close(ref, out)
        _close(tsig.signature_kern_higher_order(
            torch.from_numpy(G), M_LVL, order=order, difference=diff), out)


def test_tens_vs_seq_slot_grams():
    """Closed-form Kzx slot Grams of incremental inducing tensors (each slot
    a 2-point path) against sequences, rbf, linear and matern12."""
    from gpsig_tpu_torch.ops import gram

    rng = np.random.RandomState(30)
    lt = M_LVL * (M_LVL + 1) // 2
    Z = rng.randn(lt, 5, 2, D) * 0.4
    X = _paths(rng, 3, 8)
    for base in ("rbf", "linear", "matern12"):
        jfn = jgram.increment_gram_fns(base, {})[0]
        ref = jax.jit(lambda z, x, f=jfn: jgram.tens_vs_seq_slot_grams(
            f, z, x))(jnp.asarray(Z), jnp.asarray(X))
        out = tgram.tens_vs_seq_slot_grams(
            gram.increment_gram_fns(base)[0], torch.from_numpy(Z),
            torch.from_numpy(X))
        _close(ref, out)
