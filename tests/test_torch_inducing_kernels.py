"""The inducing kernels' plain versions and public wrappers on CPU tensors
against the JAX package: at float32 against the Pallas kernels run in
interpret mode (``fast_math=False``), at float64 against the JAX reference
graphs (base Gram + ``signature.tensor_kern`` / tens-vs-seq recursion, as
in ``tests/test_inducing_pallas.py``).

Tolerances: <= 1e-5 * max(scale, 1) at float32 (different exp/expm1
evaluations and summation orders), <= 1e-10 * max(scale, 1) at float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpsig_tpu.ops import base_kernels
from gpsig_tpu.ops import inducing_pallas as ip
from gpsig_tpu.ops import signature as sig_ops
from gpsig_tpu_torch.ops import inducing_cuda as ic

RNG = np.random.RandomState(17)
M_LVL = 3
LT = M_LVL * (M_LVL + 1) // 2
TOL = {np.float32: 1e-5, np.float64: 1e-10}


def _close(ref, out, dtype):
    ref = np.asarray(ref, dtype=np.float64)
    out = out.numpy().astype(np.float64)
    assert ref.shape == out.shape
    scale = max(float(np.max(np.abs(ref))), 1.0)
    assert float(np.max(np.abs(ref - out))) <= TOL[dtype] * scale


def _ref_tens(Z, base, inc, nZ, d):
    kf = base_kernels.get(base)
    if inc:
        G = kf({}, Z.reshape(LT, 2 * nZ, d)).reshape(LT, nZ, 2, nZ, 2)
        Mm = (G[:, :, 1, :, 1] + G[:, :, 0, :, 0]
              - G[:, :, 1, :, 0] - G[:, :, 0, :, 1])
    else:
        Mm = kf({}, Z)
    return sig_ops.tensor_kern(Mm, M_LVL)


def _ref_zx(Z, X, base, inc, diff, nZ, N, L, d):
    kf = base_kernels.get(base)
    Xf = X.reshape(N * L, d)
    if inc:
        G = kf({}, Z.reshape(LT * nZ * 2, d), Xf).reshape(LT, nZ, 2, N, L)
        Mm = G[:, :, 1] - G[:, :, 0]
    else:
        Mm = kf({}, Z.reshape(LT * nZ, d), Xf).reshape(LT, nZ, N, L)
    return sig_ops.signature_kern_tens_vs_seq_first_order(
        Mm, M_LVL, difference=diff)


def _Z(nZ, d, inc, dtype):
    shape = (LT, nZ, 2, d) if inc else (LT, nZ, d)
    return (RNG.randn(*shape) * 0.5).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("base,inc", [("rbf", True), ("rbf", False),
                                      ("linear", True), ("linear", False)])
def test_kzz_plain_and_wrapper(base, inc, dtype):
    nZ, d = 9, 2
    Z = _Z(nZ, d, inc, dtype)
    if dtype == np.float32:
        ref = ip.fused_tensor_levels(jnp.asarray(Z), num_levels=M_LVL,
                                     base=base, increments=inc,
                                     interpret=True)
    else:
        ref = _ref_tens(jnp.asarray(Z), base, inc, nZ, d)
    Zt = torch.from_numpy(Z)
    out = ic.fused_tensor_levels(Zt, num_levels=M_LVL, base=base,
                                 increments=inc)
    _close(ref, out, dtype)
    # the wrapper on a CPU tensor is exactly its plain version
    Vl, Dl = ic._prep_tensors(Zt, base, inc, lhs=True)
    Vr, Dr = ic._prep_tensors(Zt, base, inc, lhs=False)
    plain = ic.kzz_fwd_plain(Vl, Dl, Vr, Dr, num_levels=M_LVL, base=base,
                             increments=inc, symmetric=True)
    assert torch.equal(plain, out)


KZX_CASES = [  # base, increments, difference
    ("rbf", True, True),    # the benchmark configuration
    ("rbf", False, False),
    ("rbf", True, False),
    ("rbf", False, True),
    ("linear", True, True),
    ("linear", False, False),
]


def _check_kzx(base, inc, diff, dtype):
    """test_kzx_plain_and_wrapper's case (test_torch_inducing_kzx32.py and
    test_torch_inducing_kzx64.py)."""
    nZ, N, L, d = 7, 3, 18, 2
    Z = _Z(nZ, d, inc, dtype)
    X = (RNG.randn(N, L, d) / np.sqrt(L)).astype(dtype)
    if dtype == np.float32:
        ref = ip.fused_tens_vs_seq_levels(
            jnp.asarray(Z), jnp.asarray(X), num_levels=M_LVL, base=base,
            increments=inc, difference=diff, fast_math=False,
            interpret=True)
    else:
        ref = _ref_zx(jnp.asarray(Z), jnp.asarray(X), base, inc, diff, nZ,
                      N, L, d)
    Zt, Xt = torch.from_numpy(Z), torch.from_numpy(X)
    out = ic.fused_tens_vs_seq_levels(Zt, Xt, num_levels=M_LVL, base=base,
                                      increments=inc, difference=diff)
    _close(ref, out, dtype)
    Vl, Dl = ic._prep_tensors(Zt, base, inc, lhs=True)
    Xv, Xd = ic._prep_seq(Xt, base)
    plain = ic.kzx_fwd_plain(Vl, Dl, Xv, Xd, num_levels=M_LVL, base=base,
                             increments=inc, difference=diff)
    assert torch.equal(plain, out)


def test_repeat_padding_is_exact():
    """Repeating the last observation adds zero time increments: Kzx on a
    repeat-padded sequence equals Kzx on the raw one."""
    Z = torch.from_numpy(_Z(5, 2, True, np.float64))
    X = torch.from_numpy(RNG.randn(2, 11, 2) * 0.3)
    Xp = torch.cat([X, X[:, -1:].expand(-1, 6, -1)], dim=1)
    a = ic.fused_tens_vs_seq_levels(Z, X, num_levels=M_LVL)
    b = ic.fused_tens_vs_seq_levels(Z, Xp, num_levels=M_LVL)
    assert float((a - b).abs().max()) <= 1e-14
