"""The port past the shapes its first kernels took: both sequences longer
than one inner chunk of K5/K6, nine signature levels (past the main
library's eight), and the launch plans that cover a long inner axis in
chunks.

On CPU tensors the wrappers run the kernels' plain versions (K1-K6's
``*_plain``); they are held against the JAX package's reference graphs at
float64 and ``jax.vjp`` of them: the levels and the gradients within 1e-9
of the largest entry.  JAX is called through one ``jax.jit`` per
comparison.  The kernels themselves run at these shapes on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import base_kernels
from gpsig_tpu.ops import signature as sig_ops
from gpsig_tpu_torch.ops import inducing_cuda as ic
from gpsig_tpu_torch.ops import signature_cuda as sc

RNG = np.random.RandomState(61)
TOL = 1e-9


def _close(ref, out):
    ref = np.asarray(ref, dtype=np.float64)
    out = np.asarray(out, dtype=np.float64)
    assert ref.shape == out.shape
    assert float(np.max(np.abs(ref - out))) <= TOL * max(
        float(np.max(np.abs(ref))), 1.0)


def _ref_and_vjp(fn, arrays, ct):
    """fn at the arrays and its VJP under ct, as one jax.jit program."""
    def both(c, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(c)
    return jax.jit(both)(jnp.asarray(ct), *(jnp.asarray(a) for a in arrays))


def _check(port_fn, ref_fn, arrays):
    """The port's levels and autograd gradients (the plain backward
    kernels) against the JAX graph's at float64."""
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = port_fn(*xs)
    ct = RNG.randn(*out.shape)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(ct))
    ref, ref_grads = _ref_and_vjp(ref_fn, arrays, ct)
    _close(ref, out.detach().numpy())
    for want, got in zip(ref_grads, grads):
        _close(want, got.numpy())


def _seq_ref(num_levels, symmetric):
    kf = base_kernels.get("rbf")

    def levels(X, X2=None):
        X2 = X if symmetric else X2
        (n1, l1, d), (n2, l2, _) = X.shape, X2.shape
        G = kf({}, X.reshape(-1, d), X2.reshape(-1, d)).reshape(n1, l1, n2,
                                                               l2)
        return sig_ops.signature_kern_first_order(G, num_levels,
                                                  difference=True)
    return levels


def _paths(n, L, d=2):
    return (RNG.randn(n, L, d) * 0.5 / np.sqrt(L)).cumsum(1)


@pytest.mark.parametrize("symmetric", [False, True])
def test_seq_kernels_with_both_sides_past_128_steps(symmetric):
    """K5 and K6 (plain) with 140 and 150 steps on the two sides, past the
    128 inner steps the first kernels held and past one K6 chunk."""
    if symmetric:
        arrays = (_paths(2, 151),)
    else:
        arrays = (_paths(2, 141), _paths(3, 151))
    _check(lambda *x: sc.fused_first_order_levels(*x, num_levels=3),
           _seq_ref(3, symmetric), arrays)


def test_inducing_kernels_at_nine_levels():
    """K1-K4 (plain) at num_levels = 9: Kzz and Kzx of incremental
    inducing tensors, forward and gradients to Z and X."""
    m = 9
    lt = m * (m + 1) // 2
    Z = RNG.randn(lt, 3, 2, 2) * 0.5
    X = _paths(2, 6)
    kf = base_kernels.get("rbf")

    def ref(Z, X):
        nZ, d = Z.shape[1], Z.shape[-1]
        N, L, _ = X.shape
        Gz = kf({}, Z.reshape(lt, 2 * nZ, d)).reshape(lt, nZ, 2, nZ, 2)
        Mz = (Gz[:, :, 1, :, 1] + Gz[:, :, 0, :, 0]
              - Gz[:, :, 1, :, 0] - Gz[:, :, 0, :, 1])
        Gx = kf({}, Z.reshape(lt * nZ * 2, d),
                X.reshape(N * L, d)).reshape(lt, nZ, 2, N, L)
        zx = sig_ops.signature_kern_tens_vs_seq_first_order(
            Gx[:, :, 1] - Gx[:, :, 0], m, difference=True)
        return jnp.concatenate([sig_ops.tensor_kern(Mz, m), zx], axis=-1)

    def port(Z, X):
        return torch.cat([ic.fused_tensor_levels(Z, num_levels=m),
                          ic.fused_tens_vs_seq_levels(Z, X, num_levels=m)],
                         dim=-1)

    _check(port, ref, (Z, X))


def test_seq_kernels_at_nine_levels():
    """K5 and K6 (plain) at num_levels = 9."""
    _check(lambda *x: sc.fused_first_order_levels(*x, num_levels=9),
           _seq_ref(9, False), (_paths(2, 6), _paths(2, 8)))


def test_launch_plans_cover_every_inner_step_once():
    """For every inner length 1..2,000, K5's plan (rows in registers and
    not) and K6's chunks of G cpl steps cover the inner sequence, the last
    chunk holds at least one of its steps, and G and cpl are what the
    kernels take (the C entry points refuse a plan that covers too few
    steps; the chunk boundaries run on the card,
    ``test_torch_cuda_kernels.py``)."""
    for T in range(1, 2001):
        for (G, cpl, nc), max_cpl in ((sc._k5_plan(T, 16), 2),
                                      (sc._k5_plan(T, 72), 1),
                                      (sc._k6_plan(T), 4)):
            assert G in (1, 2, 4, 8, 16, 32) and 1 <= cpl <= max_cpl
            assert (nc - 1) * G * cpl < T <= nc * G * cpl
