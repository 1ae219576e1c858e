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
The matern12 cases keep these bounds on distinct pairs and take JAX's
matern12 bounds at the |.| kink of a symmetric Gram's diagonal pairs (the
block before them says how).
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


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("base,inc", [("rbf", True), ("rbf", False),
                                      ("linear", True), ("linear", False)])
def test_kzz_kernel_matches_plain(cuda, base, inc, sym):
    zz, _ = _inputs(cuda, base, inc)
    before = ic.kzz_fwd.launches
    out = ic.kzz_fwd(*zz, num_levels=M_LVL, base=base, increments=inc,
                     symmetric=sym)
    torch.cuda.synchronize()
    assert ic.kzz_fwd.launches == before + 1
    assert _bound(out, ic.kzz_fwd_plain(*zz, num_levels=M_LVL, base=base,
                                        increments=inc, symmetric=sym))
    if sym:
        assert torch.equal(out, out.transpose(1, 2))


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


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("base,inc", [("rbf", True), ("rbf", False),
                                      ("linear", True), ("linear", False)])
def test_kzz_bwd_kernel_matches_plain(cuda, base, inc, sym):
    zz, _ = _inputs(cuda, base, inc)
    ct = torch.randn((M_LVL + 1, 37, 37), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    before = ic.kzz_bwd.launches
    out = ic.kzz_bwd(*zz, ct, num_levels=M_LVL, base=base, increments=inc,
                     symmetric=sym)
    torch.cuda.synchronize()
    assert ic.kzz_bwd.launches == before + 1
    _grads_close(out, ic.kzz_bwd_plain(*zz, ct, num_levels=M_LVL, base=base,
                                       increments=inc, symmetric=sym))


@pytest.mark.parametrize("sym", [False, True])
def test_kzz_kernels_at_the_main_shape(cuda, sym):
    """K1 and K2 at the main path's shape (500 inducing tensors, 4 levels,
    d = 14) in both modes, against their f64 plain versions; K1's symmetric
    output exactly symmetric; more than one range of strips for K2 at nZ =
    1,100 (35 strips, 2 a range)."""
    m = 4
    lt = m * (m + 1) // 2
    rng = np.random.RandomState(27)
    for nz in (500, 1100):
        Z = torch.as_tensor(rng.randn(lt, nz, 2, 14) * 0.3, device=cuda)
        rows64 = (*ic._prep_tensors(Z, "rbf", True, lhs=True),
                  *ic._prep_tensors(Z, "rbf", True, lhs=False))
        rows = [t.float() for t in rows64]
        ct64 = torch.as_tensor(rng.randn(m + 1, nz, nz), device=cuda)
        kw = dict(num_levels=m, base="rbf", increments=True, symmetric=sym)
        out = ic.kzz_fwd(*rows, **kw)
        grads = ic.kzz_bwd(*rows, ct64.float(), **kw)
        torch.cuda.synchronize()
        if sym:
            assert torch.equal(out, out.transpose(1, 2))
        _fwd_close(out, ic.kzz_fwd_plain(*rows64, **kw))
        _grads_close([g.double() for g in grads],
                     ic.kzz_bwd_plain(*rows64, ct64, **kw))


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


def _long_rows(cuda, n1, L1, n2, L2, dtype, seed=7):
    rng = np.random.RandomState(seed)
    X = torch.as_tensor(rng.randn(n1, L1, 14) / np.sqrt(L1), dtype=dtype,
                        device=cuda)
    X2 = torch.as_tensor(rng.randn(n2, L2, 14) / np.sqrt(L2), dtype=dtype,
                         device=cuda)
    return (*ic._prep_seq(X, "rbf", lhs=True), *ic._prep_seq(X2, "rbf"))


@pytest.mark.parametrize("n1,L1,n2,L2", [
    (500, 5, 50, 205), (50, 205, 500, 5), (7, 5, 5, 300), (5, 300, 7, 5)])
def test_seq_bwd_takes_a_long_outer_sequence(cuda, n1, L1, n2, L2):
    """K6 puts the shorter sequence on its inner axis, so one side may be
    longer than 128 steps (CharacterTrajectories' longest is 205), as K5
    allows; held against the f32 and the f64 plain versions."""
    kw = dict(num_levels=M_LVL, base="rbf", difference=True)
    rows = _long_rows(cuda, n1, L1, n2, L2, torch.float32)
    ct = torch.randn((M_LVL + 1, n1, n2), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(8))
    before = sc.seq_bwd.launches
    grads = sc.seq_bwd(*rows, ct, **kw)
    torch.cuda.synchronize()
    assert sc.seq_bwd.launches == before + 1
    _grads_close(grads, sc.seq_bwd_plain(*rows, ct, **kw))
    rows64 = [t.double() for t in rows]
    _grads_close([g.double() for g in grads],
                 sc.seq_bwd_plain(*rows64, ct.double(), **kw))


def _fwd_close(out, ref):
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out.double() - ref.double()).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("n1,L1,n2,L2,sym", [
    (7, 140, 5, 300, False), (5, 300, 7, 140, False), (6, 300, 6, 300, True),
    (3, 1918, 2, 600, False)])
def test_seq_kernels_take_both_sides_past_128_steps(cuda, n1, L1, n2, L2,
                                                    sym):
    """K5 and K6 with both sequences longer than one inner chunk (up to
    WalkvsRun's 1,918 observations): the inner axis is taken in chunks with
    carries; held against the f32 and the f64 plain versions."""
    kw = dict(num_levels=M_LVL, base="rbf", difference=True, symmetric=sym)
    rows = _long_rows(cuda, n1, L1, n2, L2, torch.float32)
    if sym:
        rows = (*rows[:2], *ic._prep_seq(
            torch.as_tensor(np.random.RandomState(7).randn(n1, L1, 14)
                            / np.sqrt(L1), dtype=torch.float32, device=cuda),
            "rbf"))
    ct = torch.randn((M_LVL + 1, n1, n2), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(13))
    before = (sc.seq_fwd.launches, sc.seq_bwd.launches)
    out = sc.seq_fwd(*rows, **kw)
    grads = sc.seq_bwd(*rows, ct, **kw)
    torch.cuda.synchronize()
    assert (sc.seq_fwd.launches, sc.seq_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    if sym:
        assert torch.equal(out, out.transpose(1, 2))
    rows64 = [t.double() for t in rows]
    _fwd_close(out, sc.seq_fwd_plain(*rows, **kw))
    _fwd_close(out, sc.seq_fwd_plain(*rows64, **kw))
    _grads_close(grads, sc.seq_bwd_plain(*rows, ct, **kw))
    _grads_close([g.double() for g in grads],
                 sc.seq_bwd_plain(*rows64, ct.double(), **kw))


def test_kzx_kernels_past_65535_examples(cuda):
    """K3 and K4 at 70,000 examples in one call (the grid's y limit was
    65,535), against the plain versions on slices of the examples."""
    n, nz = 70_000, 32
    _, zx = _inputs(cuda, "rbf", True, nz=nz, n=n, L=6)
    kw = dict(num_levels=M_LVL, base="rbf", increments=True, difference=True)
    ct = torch.randn((M_LVL + 1, nz, n), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(14))
    before = (ic.kzx_fwd.launches, ic.kzx_bwd.launches)
    out = ic.kzx_fwd(*zx, **kw)
    g_vl, g_dl, g_xv, g_xd = ic.kzx_bwd(*zx, ct, **kw)
    torch.cuda.synchronize()
    assert (ic.kzx_fwd.launches, ic.kzx_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    Vl, Dl, Xv, Xd = zx
    ref_vl, ref_dl = torch.zeros_like(Vl), torch.zeros_like(Dl)
    for a in range(0, n, 10_000):
        b = min(n, a + 10_000)
        part = (Vl, Dl, Xv[a:b], Xd[a:b])
        assert _bound(out[:, :, a:b], ic.kzx_fwd_plain(*part, **kw))
        p_vl, p_dl, p_xv, p_xd = ic.kzx_bwd_plain(*part, ct[:, :, a:b], **kw)
        _grads_close((g_xv[a:b], g_xd[a:b]), (p_xv, p_xd))
        ref_vl += p_vl
        ref_dl += p_dl
    _grads_close((g_vl, g_dl), (ref_vl, ref_dl))


def _all_kernels_at(cuda, m):
    """K1-K6 at m levels against their plain versions (K1 and K2 in both
    modes)."""
    rng = np.random.RandomState(15)
    lt = m * (m + 1) // 2
    Z = torch.as_tensor(rng.randn(lt, 20, 2, 3) * 0.3, dtype=torch.float32,
                        device=cuda)
    X = torch.as_tensor(rng.randn(4, 12, 3) / 4, dtype=torch.float32,
                        device=cuda)
    zz = (*ic._prep_tensors(Z, "rbf", True, lhs=True),
          *ic._prep_tensors(Z, "rbf", True, lhs=False))
    zx = (*zz[:2], *ic._prep_seq(X, "rbf"))
    kw = dict(num_levels=m, base="rbf", increments=True)
    kwx = dict(kw, difference=True)
    assert _bound(ic.kzx_fwd(*zx, **kwx), ic.kzx_fwd_plain(*zx, **kwx))
    cz = torch.randn((m + 1, 20, 20), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(16))
    cx = torch.randn((m + 1, 20, 4), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(17))
    for sym in (False, True):
        kwz = dict(kw, symmetric=sym)
        assert _bound(ic.kzz_fwd(*zz, **kwz), ic.kzz_fwd_plain(*zz, **kwz))
        _grads_close(ic.kzz_bwd(*zz, cz, **kwz),
                     ic.kzz_bwd_plain(*zz, cz, **kwz))
    _grads_close(ic.kzx_bwd(*zx, cx, **kwx),
                 ic.kzx_bwd_plain(*zx, cx, **kwx))
    rows = _long_rows(cuda, 5, 14, 3, 40, torch.float32)
    kws = dict(num_levels=m, base="rbf", difference=True)
    cs = torch.randn((m + 1, 5, 3), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(18))
    _fwd_close(sc.seq_fwd(*rows, **kws), sc.seq_fwd_plain(*rows, **kws))
    _grads_close(sc.seq_bwd(*rows, cs, **kws),
                 sc.seq_bwd_plain(*rows, cs, **kws))


def test_kernels_at_nine_levels(cuda):
    """num_levels = 9, past the main library's 8: K1-K6 from the library
    built for that level count, against their plain versions."""
    _all_kernels_at(cuda, 9)


def test_kernels_at_ten_levels(cuda):
    """num_levels = 10: K3's eight range states no longer fit in shared
    memory beside the block's, so they are chained four at a time; K1-K6
    against their plain versions.  Past 16 levels K3 takes its serial
    path."""
    _all_kernels_at(cuda, 10)
    m = 17
    _, zx = _inputs(cuda, "rbf", True, nz=4, n=2, L=5, d=2)
    zx = [t[:1].expand(m * (m + 1) // 2, *t.shape[1:]) if i < 2 else t
          for i, t in enumerate(zx)]
    kw = dict(num_levels=m, base="rbf", increments=True, difference=True)
    assert _bound(ic.kzx_fwd(*zx, **kw), ic.kzx_fwd_plain(*zx, **kw))


def test_kernels_at_seventeen_levels(cuda):
    """num_levels = 17: K3 past its chained states (the serial path), K2
    at d2 = 42 (past what a K2 holding a level's rows in shared memory
    could take at that level count); K1-K6 against their plain versions."""
    _all_kernels_at(cuda, 17)
    m, lt = 17, 17 * 18 // 2
    rng = np.random.RandomState(28)
    Z = torch.as_tensor(rng.randn(lt, 20, 2, 40) * 0.15, dtype=torch.float32,
                        device=cuda)
    zz = (*ic._prep_tensors(Z, "rbf", True, lhs=True),
          *ic._prep_tensors(Z, "rbf", True, lhs=False))
    cz = torch.randn((m + 1, 20, 20), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(29))
    kw = dict(num_levels=m, base="rbf", increments=True, symmetric=True)
    _grads_close(ic.kzz_bwd(*zz, cz, **kw), ic.kzz_bwd_plain(*zz, cz, **kw))


@pytest.mark.parametrize("T_in", [63, 64, 65, 127, 128, 129, 256, 257])
def test_seq_kernels_at_chunk_boundaries(cuda, T_in):
    """K5 and K6 with the inner sequence one step short of, at and one past
    a chunk boundary (K5: chunks of 64 steps; K6: one chunk up to 128, then
    chunks of 32 cpl), against the f64 plain versions."""
    kw = dict(num_levels=M_LVL, base="rbf", difference=True)
    rows = _long_rows(cuda, 3, 301, 2, T_in + 1, torch.float32)
    ct = torch.randn((M_LVL + 1, 3, 2), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(20))
    out = sc.seq_fwd(*rows, **kw)
    grads = sc.seq_bwd(*rows, ct, **kw)
    torch.cuda.synchronize()
    rows64 = [t.double() for t in rows]
    _fwd_close(out, sc.seq_fwd_plain(*rows64, **kw))
    _grads_close([g.double() for g in grads],
                 sc.seq_bwd_plain(*rows64, ct.double(), **kw))


def _paths(rng, n, l, d, v, cuda):
    """Paths from 0 to a shared direction v (|v| ~ 1) plus a random walk
    of half its size: at any width |x_t|^2 stays O(1), and the increments
    of any two paths correlate, so that the levels are O(1)."""
    t = np.linspace(0.0, 1.0, l)[:, None]
    walk = np.cumsum(rng.randn(n, l, d), 1) / np.sqrt(l * d)
    return torch.as_tensor(t * v + 0.5 * walk, dtype=torch.float32,
                           device=cuda)


def test_kernels_at_pems_width(cuda):
    """PEMS's 963 features: K5 and K6 (inner rows past shared memory, read
    through L1) on the Kzz of length-5 inducing sequences and their Kzx
    against 144-step data, and K1-K4 on inducing tensors (K1 and K2 in both
    modes), against the plain versions (K2 the f64 one)."""
    d, rng = 963, np.random.RandomState(21)
    v = rng.randn(d) / np.sqrt(d)
    Z, X = _paths(rng, 6, 5, d, v, cuda), _paths(rng, 3, 145, d, v, cuda)
    kws = dict(num_levels=M_LVL, base="rbf", difference=True)
    for A, B, sym in ((Z, Z, True), (Z, X, False)):
        rows = (*ic._prep_seq(A, "rbf", lhs=True), *ic._prep_seq(B, "rbf"))
        ct = torch.randn((M_LVL + 1, A.shape[0], B.shape[0]), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(22))
        out = sc.seq_fwd(*rows, symmetric=sym, **kws)
        grads = sc.seq_bwd(*rows, ct, symmetric=sym, **kws)
        rows64 = [t.double() for t in rows]
        _fwd_close(out, sc.seq_fwd_plain(*rows64, symmetric=sym, **kws))
        _grads_close([g.double() for g in grads], sc.seq_bwd_plain(
            *rows64, ct.double(), symmetric=sym, **kws))
    Zt = torch.as_tensor(rng.randn(LT, 20, 2, d) / np.sqrt(d),
                         dtype=torch.float32, device=cuda)
    zz = (*ic._prep_tensors(Zt, "rbf", True, lhs=True),
          *ic._prep_tensors(Zt, "rbf", True, lhs=False))
    zx = (*zz[:2], *ic._prep_seq(X, "rbf"))
    kw = dict(num_levels=M_LVL, base="rbf", increments=True)
    kwx = dict(kw, difference=True)
    assert _bound(ic.kzx_fwd(*zx, **kwx), ic.kzx_fwd_plain(*zx, **kwx))
    cx = torch.randn((M_LVL + 1, 20, 3), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(23))
    _grads_close(ic.kzx_bwd(*zx, cx, **kwx),
                 ic.kzx_bwd_plain(*zx, cx, **kwx))
    cz = torch.randn((M_LVL + 1, 20, 20), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(24))
    zz64 = [t.double() for t in zz]
    for sym in (False, True):
        kwz = dict(kw, symmetric=sym)
        assert _bound(ic.kzz_fwd(*zz, **kwz), ic.kzz_fwd_plain(*zz, **kwz))
        _grads_close([g.double() for g in ic.kzz_bwd(*zz, cz, **kwz)],
                     ic.kzz_bwd_plain(*zz64, cz.double(), **kwz))


def test_short_expm1_against_float64(cuda):
    """common.cuh's expm1_acc, which K1, K2, K3 and K5 call in place of
    CUDA's expm1f: within 5 ulp of float64 expm1 on a dense grid of [-1,
    1], at the switch at +-0.41 and near 0; and the rbf slot Gram exp(a)
    (expm1(d01 + d10 + dxx) - expm1(d01) - expm1(d10)), whose terms cancel,
    and its partials (K2's weights), within 16 float32 epsilons of the sum
    of their terms' magnitudes."""
    x = np.concatenate([np.linspace(-1, 1, 1 << 20),
                        0.41 + np.linspace(-1e-3, 1e-3, 1 << 12),
                        -0.41 + np.linspace(-1e-3, 1e-3, 1 << 12),
                        np.geomspace(1e-9, 0.1, 1 << 12),
                        -np.geomspace(1e-9, 0.1, 1 << 12)]).astype(np.float32)
    rng = np.random.RandomState(25)
    k = 1 << 18
    combo = np.stack([rng.uniform(-1, 0.5, k), rng.uniform(-0.6, 0.6, k),
                      rng.uniform(-0.6, 0.6, k),
                      rng.uniform(-0.05, 0.05, k)], 1).astype(np.float32)
    args = np.concatenate([np.stack([x, *np.zeros((3, len(x)))], 1),
                           combo]).astype(np.float32)
    out = sc.expm1_probe(torch.as_tensor(args, device=cuda)).cpu().numpy()
    want = np.expm1(x.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert float(np.max(np.abs(out[:len(x), 0] - want) / ulp)) <= 5
    a, d01, d10, dxx = combo.astype(np.float64).T
    es, e01, e10 = np.expm1(d01 + d10 + dxx), np.expm1(d01), np.expm1(d10)
    ea, eps = np.exp(a), 2.0 ** -23
    c = out[len(x):]
    # the partials' terms include those of s = d01 + d10 + dxx, summed in
    # float32 (chip_smoke.expm1_checks)
    s_terms = np.exp(d01 + d10 + dxx) * (np.abs(d01) + np.abs(d10)
                                         + np.abs(dxx))
    for col, value, terms in (
            (2, es - e01 - e10, np.abs(es) + np.abs(e01) + np.abs(e10)),
            (4, es - e01, np.abs(es) + np.abs(e01) + s_terms),
            (5, es - e10, np.abs(es) + np.abs(e10) + s_terms),
            (6, es + 1.0, np.abs(es) + 1.0 + s_terms)):
        assert float(np.max(np.abs(c[:, col] - ea * value)
                            / (ea * terms * eps))) <= 16


@pytest.mark.parametrize("kernel", ["kzx_bwd", "seq_bwd", "seq_bwd_chunks",
                                    "kzz_bwd"])
def test_backward_kernels_are_deterministic(cuda, kernel):
    """Two launches on the same inputs give bit-identical gradients (K6 also
    on pairs whose inner side spans three chunks; K2 in symmetric mode with
    more than one range of strips)."""
    if kernel == "kzz_bwd":
        zz, _ = _inputs(cuda, "rbf", True, nz=1100)
        ct = torch.randn((M_LVL + 1, 1100, 1100), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(9))

        def run():
            return ic.kzz_bwd(*zz, ct, num_levels=M_LVL, base="rbf",
                              increments=True, symmetric=True)
    elif kernel == "kzx_bwd":
        _, zx = _inputs(cuda, "rbf", True, nz=70, n=5, L=40)
        ct = torch.randn((M_LVL + 1, 70, 5), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(9))

        def run():
            return ic.kzx_bwd(*zx, ct, num_levels=M_LVL, base="rbf",
                              increments=True, difference=True)
    else:
        n1, L1, n2, L2 = ((60, 5, 9, 150) if kernel == "seq_bwd"
                          else (4, 300, 3, 400))
        rows = _long_rows(cuda, n1, L1, n2, L2, torch.float32)
        ct = torch.randn((M_LVL + 1, n1, n2), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(9))

        def run():
            return sc.seq_bwd(*rows, ct, num_levels=M_LVL, base="rbf",
                              difference=True)
    first, second = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_forward_kernels_at_wide_rows(cuda):
    """Rows wider than the fast paths hold: K3 with d2 > 16 reads the
    inducing rows through L1 in two channel blocks, and K5 with d2 > 16
    keeps its inner rows in shared memory; both against their f32 plain
    versions."""
    _, zx = _inputs(cuda, "rbf", True, nz=40, n=3, L=12, d=20)
    kw = dict(num_levels=M_LVL, base="rbf", increments=True, difference=True)
    assert _bound(ic.kzx_fwd(*zx, **kw), ic.kzx_fwd_plain(*zx, **kw))
    rng = np.random.RandomState(19)
    X = torch.as_tensor(rng.randn(3, 40, 70) / 40, dtype=torch.float32,
                        device=cuda)
    X2 = torch.as_tensor(rng.randn(2, 100, 70) / 40, dtype=torch.float32,
                         device=cuda)
    rows = (*ic._prep_seq(X, "rbf", lhs=True), *ic._prep_seq(X2, "rbf"))
    kws = dict(num_levels=M_LVL, base="rbf", difference=True)
    _fwd_close(sc.seq_fwd(*rows, **kws), sc.seq_fwd_plain(*rows, **kws))


def test_backward_kernels_at_wide_rows(cuda):
    """Rows wider than the fast paths hold: K4 with d2 > 16 reads the
    inducing rows through L1 instead of staging them, and K6 with a wide
    inner sequence keeps its per-warp workspace in global memory; both
    against their f32 plain versions."""
    _, zx = _inputs(cuda, "rbf", True, nz=40, n=3, L=12, d=20)
    kw = dict(num_levels=M_LVL, base="rbf", increments=True, difference=True)
    ct = torch.randn((M_LVL + 1, 40, 3), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(10))
    _grads_close(ic.kzx_bwd(*zx, ct, **kw), ic.kzx_bwd_plain(*zx, ct, **kw))
    rng = np.random.RandomState(11)
    X = torch.as_tensor(rng.randn(3, 93, 70) / 40, dtype=torch.float32,
                        device=cuda)
    X2 = torch.as_tensor(rng.randn(2, 100, 70) / 40, dtype=torch.float32,
                         device=cuda)
    rows = (*ic._prep_seq(X, "rbf", lhs=True), *ic._prep_seq(X2, "rbf"))
    kws = dict(num_levels=M_LVL, base="rbf", difference=True)
    ct = torch.randn((M_LVL + 1, 3, 2), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(12))
    _grads_close(sc.seq_bwd(*rows, ct, **kws),
                 sc.seq_bwd_plain(*rows, ct, **kws))


# ---------------------------------------------------------------------------
# matern12: K1-K6 under the exp(-r) base.  Phase 2's bounds where the pairs
# are distinct; a symmetric Gram's diagonal pairs meet their own points at
# r = 0, the |.| kink of exp(-r), where float32 is sqrt(eps)-limited against
# any reference: there the forward is held to JAX's own matern12 bound, 2e-3
# relative to max(scale, 1) (tests/test_inducing_pallas.py:52-53), against
# the f32 plain version (f64 is no reference there: its self-pair
# derivative is 1/r00 of f64 rounding).  A self-pair's a00 partial is
# M / r00 with r00 the square root of the rounding of -2 a00, or 0 where
# that rounding is negative: two f32 evaluations of it differ by O(1) (it
# read 79,023 against a scale of 91,081 on 9-step sequences), so the
# gradients of a full cotangent are held finite and bit-identical, and the
# gradients of the distinct pairs (a zero-diagonal cotangent) at phase 2's
# bounds.
# ---------------------------------------------------------------------------

KINK_FWD = 2e-3


def _close(out, ref, bound):
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        scale = max(float(r.abs().max()), 1.0)
        assert float((o.double() - r.double()).abs().max()) <= bound * scale


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("inc", [True, False])
def test_matern12_kzz_kernels_match_plain(cuda, inc, sym):
    zz, _ = _inputs(cuda, "matern12", inc)
    kw = dict(num_levels=M_LVL, base="matern12", increments=inc,
              symmetric=sym)
    off = ~torch.eye(37, dtype=torch.bool, device=cuda)
    ct = torch.randn((M_LVL + 1, 37, 37), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(11))
    before = (ic.kzz_fwd.launches, ic.kzz_bwd.launches)
    out = ic.kzz_fwd(*zz, **kw)
    grads = ic.kzz_bwd(*zz, ct * off, **kw)
    torch.cuda.synchronize()
    assert (ic.kzz_fwd.launches, ic.kzz_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    ref = ic.kzz_fwd_plain(*zz, **kw)
    _close(out[:, off], ref[:, off], 1e-5)
    _close(out, ref, KINK_FWD)
    if sym:
        assert torch.equal(out, out.transpose(1, 2))
    _close(grads, ic.kzz_bwd_plain(*zz, ct * off, **kw), 1e-4)
    full = ic.kzz_bwd(*zz, ct, **kw)
    assert all(torch.equal(a, b) for a, b in zip(full,
                                                 ic.kzz_bwd(*zz, ct, **kw)))
    assert all(bool(torch.isfinite(g).all()) for g in full)


@pytest.mark.parametrize("inc,diff", [(True, True), (True, False),
                                      (False, True), (False, False)])
def test_matern12_kzx_kernels_match_plain(cuda, inc, diff):
    _, zx = _inputs(cuda, "matern12", inc)
    kw = dict(num_levels=M_LVL, base="matern12", increments=inc,
              difference=diff)
    ct = torch.randn((M_LVL + 1, 37, 3), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(12))
    out = ic.kzx_fwd(*zx, **kw)
    grads = ic.kzx_bwd(*zx, ct, **kw)
    torch.cuda.synchronize()
    assert _bound(out, ic.kzx_fwd_plain(*zx, **kw))
    _grads_close(grads, ic.kzx_bwd_plain(*zx, ct, **kw))
    assert all(torch.equal(a, b) for a, b in zip(grads,
                                                 ic.kzx_bwd(*zx, ct, **kw)))


@pytest.mark.parametrize("sym,L1,L2", [(False, 11, 18), (False, 18, 11),
                                       (True, 9, 9), (False, 140, 131),
                                       (True, 130, 130)])
def test_matern12_seq_kernels_match_plain(cuda, sym, L1, L2):
    """K5/K6 against the f64 plain version, also past one inner chunk (K5:
    64 steps, K6: 128)."""
    rows = _seq_rows(cuda, "matern12", L1=L1, L2=L2, sym=sym,
                     n2=7 if sym else 5)
    kw = dict(num_levels=M_LVL, base="matern12", difference=True,
              symmetric=sym)
    n2 = 7 if sym else 5
    ct = torch.randn((M_LVL + 1, 7, n2), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(13))
    out = sc.seq_fwd(*rows, **kw)
    rows64 = [t.double() for t in rows]
    ref = sc.seq_fwd_plain(*rows64, **kw)
    if sym:  # the kink against the f32 plain version: f64 is none there
        off = ~torch.eye(7, dtype=torch.bool, device=cuda)
        assert torch.equal(out, out.transpose(1, 2))
        _close(out[:, off], ref[:, off], 1e-4)
        _close(out, sc.seq_fwd_plain(*rows, **kw), KINK_FWD)
        assert all(bool(torch.isfinite(g).all())
                   for g in sc.seq_bwd(*rows, ct, **kw))
        ct = ct * off
    else:
        _close(out, ref, 1e-4)
    grads = sc.seq_bwd(*rows, ct, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads,
                                                 sc.seq_bwd(*rows, ct, **kw)))
    _grads_close([g.double() for g in grads],
                 sc.seq_bwd_plain(*rows64, ct.double(), **kw))


def test_matern12_device_algebra_against_float64(cuda):
    """common.cuh's matern12 closed form and its six partials (the probe)
    against ``gram.mat12_cross_partials`` at float64 on the same float32
    corner dots, each column within 1e-4 of max(its largest, 1)."""
    from gpsig_tpu_torch.ops import gram

    rng = np.random.RandomState(14)
    n, d = 1 << 14, 5
    x, y = rng.randn(n, d) * 0.5, rng.randn(n, d) * 0.5
    size = 10.0 ** rng.uniform(-3, 0, (2, n, 1))
    dx, dy = rng.randn(n, d) * size[0], rng.randn(n, d) * size[1]
    a00 = np.sum(x * y, 1) - 0.5 * np.sum(x * x, 1) - 0.5 * np.sum(y * y, 1)
    d01 = np.sum(x * dy, 1) - 0.5 * np.sum((2 * y + dy) * dy, 1)
    d10 = np.sum(dx * y, 1) - 0.5 * np.sum((2 * x + dx) * dx, 1)
    args = np.stack([a00, d01, d10, np.sum(dx * dy, 1),
                     np.linalg.norm(dx, axis=1), np.linalg.norm(dy, axis=1)],
                    1).astype(np.float32)
    out = sc.m12_probe(torch.as_tensor(args, device=cuda)).double().cpu()
    M, P = gram.mat12_cross_partials(*torch.as_tensor(args).double().T)
    for k, want in enumerate([M, M, *P, M]):
        assert float((out[:, k] - want).abs().max()) <= 1e-4 * max(
            float(want.abs().max()), 1.0)


def test_matern12_svgp_serves_and_trains_on_the_card(cuda):
    """A small SignatureMatern12 SVGP with inducing tensors and one with
    inducing sequences: predict_y on the card within 1e-3 of the same model
    at float64 on the CPU (the plain versions), K1-K4 (K5/K6) launched; then
    ten NAdam steps, every loss finite and the last below the first."""
    import gpsig_tpu_torch as T
    from gpsig_tpu_torch import convert, training

    rng = np.random.RandomState(15)
    d, m, nz, c, n, L = 3, 2, 24, 3, 40, 12
    X = rng.randn(n, L, d).cumsum(axis=1) * 0.3
    y = (np.arange(n) % c).astype(np.float64)[:, None]
    ls = T.utils.suggest_initial_lengthscales(X)
    for kind in ("tensors", "sequences"):
        if kind == "tensors":
            Z = T.utils.suggest_initial_inducing_tensors(
                X, m, nz, increments=True, seed=0)
        else:
            Z = T.utils.suggest_initial_inducing_sequences(X, nz, m + 1,
                                                           seed=0)

        def build(dtype, device):
            ind = (T.InducingTensors(Z, m, increments=True, dtype=dtype,
                                     device=device) if kind == "tensors"
                   else T.InducingSequences(Z, m, dtype=dtype,
                                            device=device))
            return T.SVGP(T.kernels.SignatureMatern12(
                d, m, lengthscales=ls, dtype=dtype, device=device), ind,
                T.likelihoods.MultiClass(c), num_latent=c, num_data=n,
                device=device)

        model, ref = build(torch.float32, "cuda"), build(torch.float64,
                                                         "cpu")
        tree = convert.to_numpy_tree(model)
        tree["q_mu"] = rng.randn(nz, c) * 0.5
        for mod in (model, ref):
            convert.load_jax_params(mod, tree)
        names = (("kzz_fwd", "kzx_fwd") if kind == "tensors"
                 else ("seq_fwd",))
        before = {k: getattr(ic if k.startswith("kz") else sc, k).launches
                  for k in names}
        with torch.no_grad():
            mean, _ = model.predict_y(torch.as_tensor(X[:8], device=cuda,
                                                      dtype=torch.float32))
            want, _ = ref.predict_y(torch.as_tensor(X[:8]))
        for k in names:
            assert getattr(ic if k.startswith("kz") else sc,
                           k).launches > before[k]
        assert float((mean.double().cpu() - want).abs().max()) <= 1e-3
        opt = training.NAdam(list(model.parameters()), lr=1e-2)
        Xt = torch.as_tensor(X, device=cuda, dtype=torch.float32)
        yt = torch.as_tensor(y, device=cuda, dtype=torch.float32)
        losses = []
        for _ in range(10):
            model.zero_grad(set_to_none=True)
            loss = model.loss(Xt, yt)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# order > 1: K5/K6 from the library built for (levels, order), the (order x
# order) grid against the plain versions (``signature_cuda._levels`` /
# ``_levels_vjp`` at that order) under the bounds above; symmetric outputs
# exactly symmetric, K6 twice bit-identical.  matern12's symmetric case
# holds its distinct pairs (a zero-diagonal cotangent) as the block above
# does.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels,order", [(4, 2), (4, 4), (9, 3)])
@pytest.mark.parametrize("base,diff,sym,L1,L2", [
    ("rbf", True, False, 11, 18), ("rbf", True, False, 18, 11),
    ("rbf", False, False, 11, 18), ("linear", True, False, 11, 18),
    ("matern12", True, False, 11, 18), ("rbf", True, True, 9, 9),
    ("matern12", True, True, 9, 9), ("rbf", True, False, 140, 131),
    ("rbf", True, True, 130, 130)])
def test_higher_order_seq_kernels_match_plain(cuda, levels, order, base,
                                              diff, sym, L1, L2):
    n2 = 7 if sym else 5
    rows = _seq_rows(cuda, base, L1=L1, L2=L2, sym=sym, n2=n2)
    kw = dict(num_levels=levels, base=base, difference=diff, symmetric=sym,
              order=order)
    ct = torch.randn((levels + 1, 7, n2), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(21))
    if sym and base == "matern12":
        ct = ct * ~torch.eye(7, dtype=torch.bool, device=cuda)
    before = (sc.seq_fwd.launches, sc.seq_bwd.launches)
    out = sc.seq_fwd(*rows, **kw)
    grads = sc.seq_bwd(*rows, ct, **kw)
    again = sc.seq_bwd(*rows, ct, **kw)
    torch.cuda.synchronize()
    assert (sc.seq_fwd.launches, sc.seq_bwd.launches) == (before[0] + 1,
                                                          before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    rows64 = [t.double() for t in rows]
    ref = sc.seq_fwd_plain(*rows64, **kw)
    if sym:
        assert torch.equal(out, out.transpose(1, 2))
    if sym and base == "matern12":
        off = ~torch.eye(7, dtype=torch.bool, device=cuda)
        _close(out[:, off], ref[:, off], 1e-4)
        _close(out, sc.seq_fwd_plain(*rows, **kw), KINK_FWD)
    else:
        _close(out, ref, 1e-4)
    _grads_close([g.double() for g in grads],
                 sc.seq_bwd_plain(*rows64, ct.double(), **kw))


def test_higher_order_levels_do_not_depend_on_the_argument_order(cuda):
    """K5/K6 put the shorter sequence inner, which transposes the grid's
    roles: K(X, Y) = K(Y, X)^T, and the gradients through either agree, to
    rounding."""
    rng = np.random.RandomState(22)
    X, X2 = (torch.tensor(rng.randn(n, L, 5) / np.sqrt(L),
                          dtype=torch.float32, device=cuda,
                          requires_grad=True)
             for n, L in ((7, 11), (5, 18)))
    ct = torch.randn((5, 7, 5), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(22))
    kw = dict(num_levels=4, order=2)
    out = sc.fused_first_order_levels(X, X2, **kw)
    out_t = sc.fused_first_order_levels(X2, X, **kw)
    _close(out.detach(), out_t.detach().transpose(1, 2), 1e-5)
    g = torch.autograd.grad(out, (X, X2), ct)
    g_t = torch.autograd.grad(out_t, (X, X2), ct.transpose(1, 2))
    _grads_close(g, g_t)


def test_higher_order_autograd_on_the_card_runs_k5_and_k6(cuda):
    rng = np.random.RandomState(23)
    X = torch.tensor(rng.randn(4, 12, 5) / 4, dtype=torch.float32,
                     device=cuda, requires_grad=True)
    X2 = torch.tensor(rng.randn(3, 20, 5) / 4, dtype=torch.float32,
                      device=cuda, requires_grad=True)

    def loss_of(a, b):
        return (sc.fused_first_order_levels(a, num_levels=4, order=2)
                .square().sum()
                + sc.fused_first_order_levels(a, b, num_levels=4,
                                              order=4).sum())

    before = (sc.seq_fwd.launches, sc.seq_bwd.launches)
    gX, gX2 = torch.autograd.grad(loss_of(X, X2), (X, X2))
    assert (sc.seq_fwd.launches, sc.seq_bwd.launches) == (before[0] + 2,
                                                          before[1] + 2)
    Xc = X.detach().cpu().double().requires_grad_()
    X2c = X2.detach().cpu().double().requires_grad_()
    _grads_close((gX.cpu().double(), gX2.cpu().double()),
                 torch.autograd.grad(loss_of(Xc, X2c), (Xc, X2c)))
