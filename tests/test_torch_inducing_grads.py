"""The backward of the inducing kernels on CPU tensors against the JAX
package: the gradients that reach Z and X through the port's public
wrappers (``_KzzFn`` / ``_KzxFn`` with ``kzz_bwd_plain`` / ``kzx_bwd_plain``
and the torch-autograd prep) under a random cotangent.

At float64 against ``jax.vjp`` of the JAX reference graphs (base Gram +
``signature.tensor_kern`` / the tens-vs-seq recursion, as in
``tests/test_torch_inducing_kernels.py``): <= 1e-10 * max(scale, 1).  At
float32, for the benchmark case only (rbf, increments, difference), against
the VJP of the Pallas kernels in interpret mode (``fast_math=False``):
<= 1e-4 * max(scale, 1), because the gradients sum many terms in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import base_kernels
from gpsig_tpu.ops import inducing_pallas as ip
from gpsig_tpu.ops import signature as sig_ops
from gpsig_tpu_torch.ops import inducing_cuda as ic

RNG = np.random.RandomState(23)
M_LVL = 3
LT = M_LVL * (M_LVL + 1) // 2
TOL = {np.float32: 1e-4, np.float64: 1e-10}


def _ref_tens(Z, base, inc):
    kf = base_kernels.get(base)
    nZ, d = Z.shape[1], Z.shape[-1]
    if inc:
        G = kf({}, Z.reshape(LT, 2 * nZ, d)).reshape(LT, nZ, 2, nZ, 2)
        Mm = (G[:, :, 1, :, 1] + G[:, :, 0, :, 0]
              - G[:, :, 1, :, 0] - G[:, :, 0, :, 1])
    else:
        Mm = kf({}, Z)
    return sig_ops.tensor_kern(Mm, M_LVL)


def _ref_zx(Z, X, base, inc, diff):
    kf = base_kernels.get(base)
    nZ, d = Z.shape[1], Z.shape[-1]
    N, L, _ = X.shape
    Xf = X.reshape(N * L, d)
    if inc:
        G = kf({}, Z.reshape(LT * nZ * 2, d), Xf).reshape(LT, nZ, 2, N, L)
        Mm = G[:, :, 1] - G[:, :, 0]
    else:
        Mm = kf({}, Z.reshape(LT * nZ, d), Xf).reshape(LT, nZ, N, L)
    return sig_ops.signature_kern_tens_vs_seq_first_order(
        Mm, M_LVL, difference=diff)


def _inputs(nZ, N, L, d, inc, dtype):
    shape = (LT, nZ, 2, d) if inc else (LT, nZ, d)
    Z = (RNG.randn(*shape) * 0.5).astype(dtype)
    X = (RNG.randn(N, L, d) / np.sqrt(L)).astype(dtype)
    return Z, X


def _close(ref, out, dtype):
    ref = np.asarray(ref, dtype=np.float64)
    out = out.detach().numpy().astype(np.float64)
    assert ref.shape == out.shape
    scale = max(float(np.max(np.abs(ref))), 1.0)
    assert float(np.max(np.abs(ref - out))) <= TOL[dtype] * scale


def _vjp(fn, arrays, ct):
    """jax.vjp of fn at the arrays under ct, as one jax.jit program (eager
    JAX compiles every op on its own)."""
    return jax.jit(lambda c, *a: jax.vjp(fn, *a)[1](c))(
        jnp.asarray(ct), *(jnp.asarray(a) for a in arrays))


def _torch_grads(fn, arrays, ct):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, torch.from_numpy(ct))


@pytest.mark.parametrize("base,inc", [("rbf", True), ("rbf", False),
                                      ("linear", True), ("linear", False)])
def test_kzz_backward_f64(base, inc):
    Z, _ = _inputs(6, 1, 2, 2, inc, np.float64)
    ct = RNG.randn(M_LVL + 1, 6, 6)
    (ref,) = _vjp(lambda z: _ref_tens(z, base, inc), [Z], ct)
    (out,) = _torch_grads(lambda z: ic.fused_tensor_levels(
        z, num_levels=M_LVL, base=base, increments=inc), [Z], ct)
    _close(ref, out, np.float64)


def test_kzz_backward_f32_against_pallas_interpret():
    Z, _ = _inputs(9, 1, 2, 2, True, np.float32)
    ct = RNG.randn(M_LVL + 1, 9, 9).astype(np.float32)
    (ref,) = _vjp(lambda z: ip.fused_tensor_levels(
        z, num_levels=M_LVL, interpret=True), [Z], ct)
    (out,) = _torch_grads(lambda z: ic.fused_tensor_levels(
        z, num_levels=M_LVL), [Z], ct)
    _close(ref, out, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_function_path_equals_autograd_of_the_plain_forward(dtype):
    """The autograd.Function route on CPU (plain forward, plain backward)
    gives the gradients autograd takes through the plain forward itself;
    no kernel is launched."""
    Z = torch.tensor(RNG.randn(LT, 5, 2, 2) * 0.5, dtype=dtype,
                     requires_grad=True)
    X = torch.tensor(RNG.randn(3, 9, 2) / 3, dtype=dtype, requires_grad=True)
    ct_zz = torch.tensor(RNG.randn(M_LVL + 1, 5, 5), dtype=dtype)
    ct_zx = torch.tensor(RNG.randn(M_LVL + 1, 5, 3), dtype=dtype)
    kw = dict(num_levels=M_LVL, base="rbf", increments=True)

    def loss_fn(route):
        return (torch.sum(route(Z, None) * ct_zz)
                + torch.sum(route(Z, X) * ct_zx))

    def function_route(z, x):
        if x is None:
            return ic.fused_tensor_levels(z, **kw)
        return ic.fused_tens_vs_seq_levels(z, x, **kw)

    def plain_route(z, x):
        Vl, Dl = ic._prep_tensors(z, "rbf", True, lhs=True)
        if x is None:
            Vr, Dr = ic._prep_tensors(z, "rbf", True, lhs=False)
            return ic.kzz_fwd_plain(Vl, Dl, Vr, Dr, **kw)
        Xv, Xd = ic._prep_seq(x, "rbf")
        return ic.kzx_fwd_plain(Vl, Dl, Xv, Xd, difference=True, **kw)

    launches = (ic.kzz_bwd.launches, ic.kzx_bwd.launches)
    got = torch.autograd.grad(loss_fn(function_route), (Z, X))
    want = torch.autograd.grad(loss_fn(plain_route), (Z, X))
    assert (ic.kzz_bwd.launches, ic.kzx_bwd.launches) == launches
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= tol * scale


def test_backward_wrappers_check_their_inputs():
    V = torch.zeros(LT, 4, 4)
    with pytest.raises(ValueError, match="cotangent"):
        ic.kzz_bwd(V, V, V, V, torch.zeros(M_LVL + 1, 4, 3),
                   num_levels=M_LVL, base="rbf", increments=True)
    with pytest.raises(ValueError, match="cotangent"):
        ic.kzx_bwd(V, V, torch.zeros(2, 5, 4), torch.zeros(2, 5, 4),
                   torch.zeros(M_LVL + 1, 4, 3), num_levels=M_LVL,
                   base="rbf", increments=True, difference=True)
    meta = torch.zeros(LT, 3, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ic.kzz_bwd(meta, meta, meta, meta,
                   torch.zeros(M_LVL + 1, 3, 3, device="meta"),
                   num_levels=M_LVL, base="rbf", increments=True)
