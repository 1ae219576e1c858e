"""K1-K4 under the matern12 base on CPU tensors (their plain versions
behind the public ``fused_tensor_levels`` / ``fused_tens_vs_seq_levels``)
against the JAX package: forward levels and the gradients that reach Z and
X under a random cotangent.

At float32 against the Pallas kernels in interpret mode (``fast_math=False``
for Kzx): the levels within 1e-5 * max(scale, 1), the gradients within 1e-4
* max(scale, 1) (they sum many terms in another order), both at each
level's or gradient's own scale.  Kzz's self-pairs (z_i against z_i) sit
at r = 0, the |.| kink of exp(-r): there the f32 closed form is
sqrt(eps)-limited whatever the order of its sums, and JAX's own matern12
bounds apply (``tests/test_inducing_pallas.py:49-53``): 2e-3 forward and
5e-3 gradient, relative to max(scale, 1).  At float64 against ``jax.vjp``
of the JAX reference graphs (base Gram, second difference, recursion):
<= 1e-9 * max(scale, 1), where the same kink leaves ~1e-8 at the self-pairs
of Kzz (``test_torch_matern12_ops``) and ~7e-8 in the gradient they reach:
there 1e-7 forward and 1e-6 gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import inducing_pallas as ip
from gpsig_tpu_torch.ops import inducing_cuda as ic
from test_torch_inducing_grads import M_LVL as M_REF
from test_torch_inducing_grads import _ref_tens, _ref_zx, _torch_grads, _vjp

# levels against the Pallas kernels (interpret mode costs a few seconds a
# slot); the reference graphs of test_torch_inducing_grads take M_REF
M_LVL = 2
KINK_FWD, KINK_BWD = 2e-3, 5e-3  # tests/test_inducing_pallas.py:52-53


def _inputs(nZ, N, L, d, inc, dtype, seed, m=M_LVL):
    rng = np.random.RandomState(seed)
    lt = m * (m + 1) // 2
    shape = (lt, nZ, 2, d) if inc else (lt, nZ, d)
    Z = (rng.randn(*shape) * 0.5).astype(dtype)
    X = (rng.randn(N, L, d) * 0.5 / np.sqrt(L)).cumsum(1).astype(dtype)
    return Z, X, rng


def _close(ref, out, tol, axis0=True):
    """Each part (level, or the whole gradient) within tol * max(its scale,
    1)."""
    ref = np.asarray(ref, dtype=np.float64)
    out = out.detach().numpy().astype(np.float64)
    assert ref.shape == out.shape
    for r, o in (zip(ref, out) if axis0 else ((ref, out),)):
        scale = max(float(np.max(np.abs(r))), 1.0)
        assert float(np.max(np.abs(r - o))) <= tol * scale


@pytest.mark.parametrize("inc", [True, False])
def test_kzz_f32_against_pallas_interpret(inc):
    Z, _, rng = _inputs(9, 1, 2, 3, inc, np.float32, seed=1)
    ct = rng.randn(M_LVL + 1, 9, 9).astype(np.float32)

    def pallas(z):
        return ip.fused_tensor_levels(z, num_levels=M_LVL, base="matern12",
                                      increments=inc, interpret=True)

    def port(z):
        return ic.fused_tensor_levels(z, num_levels=M_LVL, base="matern12",
                                      increments=inc)

    ref = jax.jit(pallas)(jnp.asarray(Z))
    (g_ref,) = _vjp(pallas, [Z], ct)
    out = port(torch.from_numpy(Z))
    (g_out,) = _torch_grads(port, [Z], ct)
    # off the diagonal the pairs are distinct tensors: phase 2's bounds
    off = ~np.eye(9, dtype=bool)
    _close(np.asarray(ref)[:, off], out[:, torch.from_numpy(off)], 1e-5)
    _close(ref, out, KINK_FWD)
    _close(g_ref, g_out, KINK_BWD, axis0=False)


@pytest.mark.parametrize("inc,diff", [(True, True), (True, False),
                                      (False, True), (False, False)])
def test_kzx_f32_against_pallas_interpret(inc, diff):
    Z, X, rng = _inputs(7, 3, 11, 3, inc, np.float32, seed=2)
    ct = rng.randn(M_LVL + 1, 7, 3).astype(np.float32)

    def pallas(z, x):
        return ip.fused_tens_vs_seq_levels(
            z, x, num_levels=M_LVL, base="matern12", increments=inc,
            difference=diff, fast_math=False, interpret=True)

    def port(z, x):
        return ic.fused_tens_vs_seq_levels(
            z, x, num_levels=M_LVL, base="matern12", increments=inc,
            difference=diff)

    ref = jax.jit(pallas)(jnp.asarray(Z), jnp.asarray(X))
    g_ref = _vjp(pallas, [Z, X], ct)
    out = port(torch.from_numpy(Z), torch.from_numpy(X))
    g_out = _torch_grads(port, [Z, X], ct)
    _close(ref, out, 1e-5)
    for r, o in zip(g_ref, g_out):
        _close(r, o, 1e-4, axis0=False)


def test_kzz_kzx_f64_against_the_reference_graphs():
    Z, X, rng = _inputs(6, 3, 9, 2, True, np.float64, seed=3, m=M_REF)
    ct_zz = rng.randn(M_REF + 1, 6, 6)
    ct_zx = rng.randn(M_REF + 1, 6, 3)
    kw = dict(num_levels=M_REF, base="matern12", increments=True)
    with torch.no_grad():
        out_zz = ic.fused_tensor_levels(torch.from_numpy(Z), **kw)
        out_zx = ic.fused_tens_vs_seq_levels(torch.from_numpy(Z),
                                             torch.from_numpy(X), **kw)
    ref_zz = jax.jit(lambda z: _ref_tens(z, "matern12", True))(
        jnp.asarray(Z))
    ref_zx = jax.jit(lambda z, x: _ref_zx(z, x, "matern12", True, True))(
        jnp.asarray(Z), jnp.asarray(X))
    off = ~np.eye(6, dtype=bool)
    _close(np.asarray(ref_zz)[:, off], out_zz[:, torch.from_numpy(off)],
           1e-9)
    _close(ref_zz, out_zz, 1e-7)
    _close(ref_zx, out_zx, 1e-9)
    # the self-pairs' kink: 1e-6 with them (~7e-8 read), 1e-9 without
    for ct, tol in ((ct_zz, 1e-6), (ct_zz * off, 1e-9)):
        (g_ref,) = _vjp(lambda z: _ref_tens(z, "matern12", True), [Z], ct)
        (g_out,) = _torch_grads(lambda z: ic.fused_tensor_levels(z, **kw),
                                [Z], ct)
        _close(g_ref, g_out, tol, axis0=False)
    g_ref = _vjp(lambda z, x: _ref_zx(z, x, "matern12", True, True), [Z, X],
                 ct_zx)
    g_out = _torch_grads(lambda z, x: ic.fused_tens_vs_seq_levels(z, x, **kw),
                         [Z, X], ct_zx)
    for r, o in zip(g_ref, g_out):
        _close(r, o, 1e-9, axis0=False)
