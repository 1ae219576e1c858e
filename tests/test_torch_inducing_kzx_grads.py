"""The backward of the Kzx kernel (K4's plain version behind ``_KzxFn``) on
CPU tensors against the JAX package: at float64 against ``jax.vjp`` of the
reference graph, at float32 against the VJP of the Pallas kernel in
interpret mode.

Split from ``test_torch_inducing_grads.py`` (its helpers and tolerances:
<= 1e-10 * max(scale, 1) at float64, <= 1e-4 at float32), so that no port
test file queues ahead of the suite's long JAX files under xdist's
``loadfile``.
"""

import numpy as np
import pytest

from gpsig_tpu.ops import inducing_pallas as ip
from gpsig_tpu_torch.ops import inducing_cuda as ic
from test_torch_inducing_grads import (M_LVL, RNG, _close, _inputs, _ref_zx,
                                       _torch_grads, _vjp)


@pytest.mark.parametrize("base,inc,diff", [
    ("rbf", True, True),    # the benchmark configuration
    ("rbf", False, False),
    ("rbf", True, False),
    ("rbf", False, True),
    ("linear", True, True),
    ("linear", False, False),
])
def test_kzx_backward_f64(base, inc, diff):
    Z, X = _inputs(5, 3, 9, 2, inc, np.float64)
    ct = RNG.randn(M_LVL + 1, 5, 3)
    refs = _vjp(lambda z, x: _ref_zx(z, x, base, inc, diff), [Z, X], ct)
    outs = _torch_grads(lambda z, x: ic.fused_tens_vs_seq_levels(
        z, x, num_levels=M_LVL, base=base, increments=inc,
        difference=diff), [Z, X], ct)
    for ref, out in zip(refs, outs):
        _close(ref, out, np.float64)


@pytest.mark.parametrize("L", [1, 2])
def test_kzx_backward_f64_short_sequences(L):
    """One and two observations: the difference sweep has no step or one."""
    Z, X = _inputs(5, 2, L, 2, True, np.float64)
    ct = RNG.randn(M_LVL + 1, 5, 2)
    refs = _vjp(lambda z, x: _ref_zx(z, x, "rbf", True, True), [Z, X], ct)
    outs = _torch_grads(lambda z, x: ic.fused_tens_vs_seq_levels(
        z, x, num_levels=M_LVL), [Z, X], ct)
    for ref, out in zip(refs, outs):
        _close(ref, out, np.float64)


def test_kzx_backward_f32_against_pallas_interpret():
    Z, X = _inputs(7, 3, 18, 2, True, np.float32)
    ct = RNG.randn(M_LVL + 1, 7, 3).astype(np.float32)
    refs = _vjp(lambda z, x: ip.fused_tens_vs_seq_levels(
        z, x, num_levels=M_LVL, fast_math=False, interpret=True), [Z, X], ct)
    outs = _torch_grads(lambda z, x: ic.fused_tens_vs_seq_levels(
        z, x, num_levels=M_LVL), [Z, X], ct)
    for ref, out in zip(refs, outs):
        _close(ref, out, np.float32)
