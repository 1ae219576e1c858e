"""The hand-written CUDA kernels against their plain versions on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` and skip elsewhere.
Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -o addopts='' -q

(``--noconftest``: the suite's conftest configures JAX, which that machine
does not have.)

Tolerance: <= 1e-5 * max(scale, 1) for the forward kernels against the
f32 plain version (CUDA's expf / expm1f against ``exp_accurate`` / the
Taylor expm1, and another summation order); <= 1e-4 * max(scale, 1) for
the backward kernels, whose gradients sum many more terms in another order.
The seq x seq kernels K5/K6 are held against the f64 plain version, with
the same bounds as ``chip_smoke.py``'s (1e-4 * max(scale, 1)): their level
sums over 100s of steps carry f32 rounding of the plain version as well.
"""

import numpy as np
import pytest
import torch

from gpsig_tpu_torch.ops import inducing_cuda as ic
from gpsig_tpu_torch.ops import signature_cuda as sc

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


def _grads_close(out, ref):
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        scale = max(float(r.abs().max()), 1.0)
        assert float((o - r).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("base,inc", [("rbf", True), ("rbf", False),
                                      ("linear", True), ("linear", False)])
def test_kzz_bwd_kernel_matches_plain(cuda, base, inc):
    zz, _ = _inputs(cuda, base, inc)
    ct = torch.randn((M_LVL + 1, 37, 37), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    before = ic.kzz_bwd.launches
    out = ic.kzz_bwd(*zz, ct, num_levels=M_LVL, base=base, increments=inc)
    torch.cuda.synchronize()
    assert ic.kzz_bwd.launches == before + 1
    _grads_close(out, ic.kzz_bwd_plain(*zz, ct, num_levels=M_LVL, base=base,
                                       increments=inc))


@pytest.mark.parametrize("base,inc,diff", [
    ("rbf", True, True), ("rbf", False, False), ("rbf", True, False),
    ("rbf", False, True), ("linear", True, True), ("linear", False, False)])
def test_kzx_bwd_kernel_matches_plain(cuda, base, inc, diff):
    _, zx = _inputs(cuda, base, inc)
    ct = torch.randn((M_LVL + 1, 37, 3), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(2))
    before = ic.kzx_bwd.launches
    out = ic.kzx_bwd(*zx, ct, num_levels=M_LVL, base=base, increments=inc,
                     difference=diff)
    torch.cuda.synchronize()
    assert ic.kzx_bwd.launches == before + 1
    _grads_close(out, ic.kzx_bwd_plain(*zx, ct, num_levels=M_LVL, base=base,
                                       increments=inc, difference=diff))


@pytest.mark.parametrize("L", [1, 2])
def test_kzx_kernels_on_short_sequences(cuda, L):
    """The difference sweep has no step (L=1) or one (L=2)."""
    _, zx = _inputs(cuda, "rbf", True, L=L)
    kw = dict(num_levels=M_LVL, base="rbf", increments=True, difference=True)
    ct = torch.randn((M_LVL + 1, 37, 3), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(3))
    assert _bound(ic.kzx_fwd(*zx, **kw), ic.kzx_fwd_plain(*zx, **kw))
    _grads_close(ic.kzx_bwd(*zx, ct, **kw), ic.kzx_bwd_plain(*zx, ct, **kw))


def test_autograd_on_the_card_runs_the_backward_kernels(cuda):
    """Gradients through the public wrappers reach Z and X on the card."""
    rng = np.random.RandomState(3)
    Z = torch.tensor(rng.randn(LT, 37, 2, 5) * 0.5, dtype=torch.float32,
                     device=cuda, requires_grad=True)
    X = torch.tensor(rng.randn(3, 18, 5) / 4, dtype=torch.float32,
                     device=cuda, requires_grad=True)
    before = (ic.kzz_bwd.launches, ic.kzx_bwd.launches)
    loss = (ic.fused_tensor_levels(Z, num_levels=M_LVL).square().sum()
            + ic.fused_tens_vs_seq_levels(Z, X, num_levels=M_LVL).sum())
    gZ, gX = torch.autograd.grad(loss, (Z, X))
    assert (ic.kzz_bwd.launches, ic.kzx_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    Zc = Z.detach().cpu().requires_grad_()
    Xc = X.detach().cpu().requires_grad_()
    loss_c = (ic.fused_tensor_levels(Zc, num_levels=M_LVL).square().sum()
              + ic.fused_tens_vs_seq_levels(Zc, Xc, num_levels=M_LVL).sum())
    _grads_close((gZ.cpu(), gX.cpu()), torch.autograd.grad(loss_c, (Zc, Xc)))


def test_float64_on_the_card_raises(cuda):
    zz, zx = _inputs(cuda, "rbf", True)
    with pytest.raises(TypeError, match="float32"):
        ic.kzz_fwd(*(t.double() for t in zz), num_levels=M_LVL, base="rbf",
                   increments=True)
    with pytest.raises(TypeError, match="float32"):
        ic.kzx_fwd(*(t.double() for t in zx), num_levels=M_LVL, base="rbf",
                   increments=True, difference=True)
    ct_zz = torch.zeros((M_LVL + 1, 37, 37), dtype=torch.float64, device=cuda)
    ct_zx = torch.zeros((M_LVL + 1, 37, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ic.kzz_bwd(*(t.double() for t in zz), ct_zz, num_levels=M_LVL,
                   base="rbf", increments=True)
    with pytest.raises(TypeError, match="float32"):
        ic.kzx_bwd(*(t.double() for t in zx), ct_zx, num_levels=M_LVL,
                   base="rbf", increments=True, difference=True)


def _seq_rows(cuda, base, n1=7, L1=11, n2=5, L2=18, sym=False, seed=4):
    rng = np.random.RandomState(seed)
    X = torch.as_tensor(rng.randn(n1, L1, 5) / np.sqrt(L1), dtype=torch.float32,
                        device=cuda)
    X2 = X if sym else torch.as_tensor(rng.randn(n2, L2, 5) / np.sqrt(L2),
                                       dtype=torch.float32, device=cuda)
    return (*ic._prep_seq(X, base, lhs=True), *ic._prep_seq(X2, base))


@pytest.mark.parametrize("base,diff,sym,L1,L2", [
    ("rbf", True, False, 11, 18), ("rbf", True, False, 18, 11),
    ("rbf", False, False, 11, 18), ("linear", True, False, 11, 18),
    ("linear", False, False, 11, 18), ("rbf", True, True, 9, 9),
    ("linear", True, True, 9, 9), ("rbf", True, False, 1, 7)])
def test_seq_kernels_match_plain(cuda, base, diff, sym, L1, L2):
    rows = _seq_rows(cuda, base, L1=L1, L2=L2, sym=sym,
                     n2=7 if sym else 5)
    kw = dict(num_levels=M_LVL, base=base, difference=diff, symmetric=sym)
    ct = torch.randn((M_LVL + 1, 7, 7 if sym else 5), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5))
    before = (sc.seq_fwd.launches, sc.seq_bwd.launches)
    out = sc.seq_fwd(*rows, **kw)
    grads = sc.seq_bwd(*rows, ct, **kw)
    torch.cuda.synchronize()
    assert (sc.seq_fwd.launches, sc.seq_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    rows64 = [t.double() for t in rows]
    ref = sc.seq_fwd_plain(*rows64, **kw)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out.double() - ref).abs().max()) <= 1e-4 * scale
    if sym:
        assert torch.equal(out, out.transpose(1, 2))
    _grads_close([g.double() for g in grads],
                 sc.seq_bwd_plain(*rows64, ct.double(), **kw))


def test_seq_autograd_on_the_card_runs_k5_and_k6(cuda):
    rng = np.random.RandomState(6)
    X = torch.tensor(rng.randn(4, 12, 5) / 4, dtype=torch.float32,
                     device=cuda, requires_grad=True)
    X2 = torch.tensor(rng.randn(3, 20, 5) / 4, dtype=torch.float32,
                      device=cuda, requires_grad=True)
    before = (sc.seq_fwd.launches, sc.seq_bwd.launches)
    loss = (sc.fused_first_order_levels(X, num_levels=M_LVL).square().sum()
            + sc.fused_first_order_levels(X, X2, num_levels=M_LVL).sum())
    gX, gX2 = torch.autograd.grad(loss, (X, X2))
    assert (sc.seq_fwd.launches, sc.seq_bwd.launches) == (before[0] + 2,
                                                          before[1] + 2)
    Xc = X.detach().cpu().double().requires_grad_()
    X2c = X2.detach().cpu().double().requires_grad_()
    loss_c = (sc.fused_first_order_levels(Xc, num_levels=M_LVL).square().sum()
              + sc.fused_first_order_levels(Xc, X2c, num_levels=M_LVL).sum())
    _grads_close((gX.cpu().double(), gX2.cpu().double()),
                 torch.autograd.grad(loss_c, (Xc, X2c)))


def test_seq_kernels_raise_on_the_card(cuda):
    rows = _seq_rows(cuda, "rbf")
    with pytest.raises(TypeError, match="float32"):
        sc.seq_fwd(*(t.double() for t in rows), num_levels=M_LVL,
                   base="rbf", difference=True)
    long_rows = _seq_rows(cuda, "rbf", L1=140, L2=140)
    with pytest.raises(ValueError, match="at most 128 steps"):
        sc.seq_fwd(*long_rows, num_levels=M_LVL, base="rbf", difference=True)
