"""Symmetric mode of the Kzz plain versions (K1's and K2's), on CPU tensors.

``fused_tensor_levels`` builds both sides from one set of inducing tensors
and runs K1 and K2 in symmetric mode: each unordered pair computed once and
mirrored, the cotangent folded onto the upper triangle.  The plain versions
define what the kernels compute in that mode:

* ``kzz_fwd_plain(symmetric=True)`` is exactly symmetric and equals the
  all-pairs version within float64 rounding (<= 1e-13 * max(scale, 1): the
  two halves of an unordered pair sum the same products in another order);
* ``kzz_bwd_plain(symmetric=True)`` is the VJP of
  ``kzz_fwd_plain(symmetric=True)``: against torch autograd of it under a
  non-symmetric cotangent, per row gradient, <= 1e-12 * max(scale, 1).
"""

import numpy as np
import pytest
import torch

from gpsig_tpu_torch.ops import inducing_cuda as ic

M_LVL = 3
LT = M_LVL * (M_LVL + 1) // 2
CASES = [("rbf", True), ("linear", False)]


def _rows(base, inc, nz=11, d=3, seed=31):
    rng = np.random.RandomState(seed)
    shape = (LT, nz, 2, d) if inc else (LT, nz, d)
    Z = torch.tensor(rng.randn(*shape) * 0.5, dtype=torch.float64)
    return (*ic._prep_tensors(Z, base, inc, lhs=True),
            *ic._prep_tensors(Z, base, inc, lhs=False))


def _close(out, ref, tol):
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("base,inc", CASES)
def test_symmetric_forward_is_exactly_symmetric(base, inc):
    rows = _rows(base, inc)
    kw = dict(num_levels=M_LVL, base=base, increments=inc)
    out = ic.kzz_fwd_plain(*rows, symmetric=True, **kw)
    assert torch.equal(out, out.transpose(1, 2))
    _close(out, ic.kzz_fwd_plain(*rows, **kw), 1e-13)
    # the wrapper on CPU tensors is its plain version
    assert torch.equal(ic.kzz_fwd(*rows, symmetric=True, **kw), out)


@pytest.mark.parametrize("base,inc", CASES)
def test_symmetric_backward_is_the_vjp_of_the_forward(base, inc):
    rows = [t.clone().requires_grad_() for t in _rows(base, inc)]
    kw = dict(num_levels=M_LVL, base=base, increments=inc)
    ct = torch.tensor(np.random.RandomState(32).randn(M_LVL + 1, 11, 11))
    want = torch.autograd.grad(
        ic.kzz_fwd_plain(*rows, symmetric=True, **kw), rows, ct,
        allow_unused=True, materialize_grads=True)
    rows = [t.detach() for t in rows]
    got = ic.kzz_bwd_plain(*rows, ct, symmetric=True, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, 1e-12)
    assert all(torch.equal(a, b) for a, b in zip(
        ic.kzz_bwd(*rows, ct, symmetric=True, **kw), got))
