"""The hand-written CUDA kernels against their plain versions on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` and skip elsewhere.
Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -o addopts='' -q

(``--noconftest``: the suite's conftest configures JAX, which that machine
does not have.)

Tolerance: <= 1e-5 * max(scale, 1) against the f32 plain version (CUDA's
expf / expm1f against ``exp_accurate`` / the Taylor expm1, and another
summation order).
"""

import numpy as np
import pytest
import torch

from gpsig_tpu_torch.ops import inducing_cuda as ic

pytestmark = pytest.mark.cuda

M_LVL = 3
LT = M_LVL * (M_LVL + 1) // 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(cuda, base, inc, nz=37, n=3, L=18, d=5, seed=0):
    rng = np.random.RandomState(seed)
    shape = (LT, nz, 2, d) if inc else (LT, nz, d)
    Z = torch.as_tensor(rng.randn(*shape) * 0.5, dtype=torch.float32,
                        device=cuda)
    X = torch.as_tensor(rng.randn(n, L, d) / np.sqrt(L), dtype=torch.float32,
                        device=cuda)
    Vl, Dl = ic._prep_tensors(Z, base, inc, lhs=True)
    Vr, Dr = ic._prep_tensors(Z, base, inc, lhs=False)
    Xv, Xd = ic._prep_seq(X, base)
    return (Vl, Dl, Vr, Dr), (Vl, Dl, Xv, Xd)


def _bound(out, ref):
    scale = max(float(ref.abs().max()), 1.0)
    return float((out - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("base,inc", [("rbf", True), ("rbf", False),
                                      ("linear", True), ("linear", False)])
def test_kzz_kernel_matches_plain(cuda, base, inc):
    zz, _ = _inputs(cuda, base, inc)
    before = ic.kzz_fwd.launches
    out = ic.kzz_fwd(*zz, num_levels=M_LVL, base=base, increments=inc)
    torch.cuda.synchronize()
    assert ic.kzz_fwd.launches == before + 1
    assert _bound(out, ic.kzz_fwd_plain(*zz, num_levels=M_LVL, base=base,
                                        increments=inc))


@pytest.mark.parametrize("base,inc,diff", [
    ("rbf", True, True), ("rbf", False, False), ("rbf", True, False),
    ("rbf", False, True), ("linear", True, True), ("linear", False, False)])
def test_kzx_kernel_matches_plain(cuda, base, inc, diff):
    _, zx = _inputs(cuda, base, inc)
    before = ic.kzx_fwd.launches
    out = ic.kzx_fwd(*zx, num_levels=M_LVL, base=base, increments=inc,
                     difference=diff)
    torch.cuda.synchronize()
    assert ic.kzx_fwd.launches == before + 1
    assert _bound(out, ic.kzx_fwd_plain(*zx, num_levels=M_LVL, base=base,
                                        increments=inc, difference=diff))


def test_float64_on_the_card_raises(cuda):
    zz, zx = _inputs(cuda, "rbf", True)
    with pytest.raises(TypeError, match="float32"):
        ic.kzz_fwd(*(t.double() for t in zz), num_levels=M_LVL, base="rbf",
                   increments=True)
    with pytest.raises(TypeError, match="float32"):
        ic.kzx_fwd(*(t.double() for t in zx), num_levels=M_LVL, base="rbf",
                   increments=True, difference=True)
