"""The eleven bases of the port's ``ops/base_kernels.py`` and their routing
in ``kernels.py`` against ``gpsig_tpu``: the registry, each base Gram on
the same numpy inputs and constrained parameters, the parameter layout
(leaves, shapes, bijectors, the static poly degree), the capability
dispatch (``fused='on'`` raises for a base without a kernel; ``'auto'``
launches nothing) and ``K_blocked``.  The variants' keyword routing is in
``test_torch_bases_variants.py``.

Tolerances: base Grams <= 1e-10 relative to the largest entry at float64
and <= 1e-6 at float32 (the two frameworks round in other orders), but on
a symmetric Gram's diagonal <= 1e-7 at float64 (``KINK``: matern12's r =
sqrt(|x - x|^2) of a rounding-level square is sqrt(eps)-limited in both
packages, as ``test_torch_matern12_ops.py`` holds it); ``K_blocked``
against JAX's and against ``K`` (the naive graph, exact at float64) <=
1e-7 relative, the same sqrt(eps) limit at the same-path diagonals that
normalize it (JAX's own test holds K_blocked to K at 1e-6), gradients <=
1e-6 relative to the largest (JAX's: 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpsig_tpu as G
import gpsig_tpu_torch as T
from gpsig_tpu.ops import base_kernels as jbk
from gpsig_tpu_torch.ops import base_kernels as tbk
from gpsig_tpu_torch.ops import inducing_cuda as ic
from gpsig_tpu_torch.ops import signature_cuda as sc
from test_torch_bases_increments import (KINK, NEW_BASES, as_jax,
                                         as_torch, base_params, rel_err)

RNG = np.random.RandomState(11)


def test_registry_has_the_same_eleven_bases():
    assert list(tbk.BASE_KERNELS) == list(jbk.BASE_KERNELS)
    assert len(tbk.BASE_KERNELS) == 11
    with pytest.raises(ValueError, match="Unknown base"):
        tbk.get("nope")
    with pytest.raises(ValueError, match="Unknown base"):
        T.kernels.SignatureKernel(2, 2, base="nope", device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_base_grams_match_jax(dtype):
    X = RNG.randn(7, 3).astype(dtype) + 0.3
    X2 = RNG.randn(5, 3).astype(dtype) - 0.2
    tol = 1e-10 if dtype == np.float64 else 1e-6
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    for base in tbk.BASE_KERNELS:
        p = base_params(base)
        jf, tf = jbk.get(base), tbk.get(base)
        jp, tp = as_jax(p, dtype), as_torch(p, tdt)
        for args, kink in (((X,), np.eye(7, dtype=bool)), ((X, X2), None)):
            want = jax.jit(jf)(jp, *args)
            got = tf(tp, *(torch.from_numpy(a) for a in args))
            assert got.dtype == tdt, base
            assert rel_err(want, got, kink) <= tol, base


def test_parameter_layout_matches_jax():
    """Leaves, shapes, dtypes and bijectors of every base, at the width
    the kernel gives it (features x (lags + 1)); the static poly degree;
    the spectral draws from the generator, deterministic for a seed."""
    for base in tbk.BASE_KERNELS:
        opts = {"Q": 4} if base.startswith("spectral") else {}
        jraw, jbij = jbk.init_params(base, jax.random.PRNGKey(0),
                                     num_features=6, dtype=jnp.float64,
                                     **opts)
        traw, tbij = tbk.init_params(base, num_features=6,
                                     dtype=torch.float64, **opts)
        assert tbij == jbij, base
        assert {k: tuple(v.shape) for k, v in traw.items()} == {
            k: tuple(v.shape) for k, v in jraw.items()}, base
        assert tbk.static_params(base, poly_degree=4) == jbk.static_params(
            base, poly_degree=4), base
    raw = tbk.init_params("mix", dtype=torch.float64)[0]
    assert abs(float(T.params.positive(raw["mixing"])) - 0.5) < 1e-12
    draws = [tbk.init_params("spectral_exp", torch.Generator().manual_seed(
        s), num_features=3, dtype=torch.float32)[0]["omega"]
        for s in (5, 5, 6)]
    assert draws[0].dtype == torch.float32
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    kern = T.kernels.SignatureSpectral(2, 2, num_lags=1, Q=3, device="cpu")
    assert kern.omega.shape == (3, 4) and "lengthscales" not in dict(
        kern.named_parameters())


def test_fused_on_raises_and_auto_launches_no_kernel():
    """For each base without a kernel, ``fused='on'`` raises naming the
    supported bases (a 'meta' tensor stands in for a CUDA one: the check
    comes before any launch), and ``'auto'`` at float32 computes the
    model's covariances with torch ops: no launch counter moves."""
    Z = torch.randn(3, 4, 2, 2)
    X = torch.randn(2, 5, 2)
    counters = (ic.kzz_fwd, ic.kzx_fwd, ic.kzz_bwd, ic.kzx_bwd, sc.seq_fwd,
                sc.seq_bwd)
    for base in NEW_BASES:
        on = T.kernels.SignatureKernel(2, 2, base=base, fused="on",
                                       device="cpu")
        meta = T.kernels.SignatureKernel(2, 2, base=base, fused="on",
                                         device="meta")
        for kern, args in ((on, (Z, X)), (meta, (Z.to("meta"),
                                                 X.to("meta")))):
            with pytest.raises(ValueError, match="rbf"):
                kern.K_tens_n_seq_covs(*args, increments=True)
        with pytest.raises(ValueError, match="has no CUDA kernel"):
            meta.K(X.to("meta"))
        auto = T.kernels.SignatureKernel(2, 2, base=base, device="cpu")
        before = [f.launches for f in counters]
        out = auto.K_tens_n_seq_covs(Z, X, increments=True, full_X_cov=True)
        auto.K(X).sum().backward()
        sum(o.sum() for o in out).backward()
        assert [f.launches for f in counters] == before, base
        assert all(bool(torch.isfinite(o).all()) for o in out), base


@pytest.mark.parametrize("base", ["cosine", "spectral_mixed"])
def test_K_blocked_matches_K_and_jax(base):
    """``K_blocked`` (method 'xla': the closed forms over 4-example tiles)
    against ``K`` (the naive graph at float64) and JAX's ``K_blocked``,
    forward and gradient, at order 1 and 2; 'pallas' takes K5's plain
    version for rbf and the blocked path for the other bases, as JAX."""
    X, X2 = RNG.randn(6, 8, 2) + 0.5, RNG.randn(5, 7, 2) + 0.5
    for order in (1, 2):
        jk = G.kernels.SignatureKernel(2, 3, base=base, order=order,
                                       base_options={"Q": 4})
        params = jk.init_params(jax.random.PRNGKey(2))
        tk = T.kernels.SignatureKernel(2, 3, base=base, order=order,
                                       base_options={"Q": 4},
                                       dtype=torch.float64, device="cpu")
        with torch.no_grad():
            for k, v in params.items():
                getattr(tk, k).copy_(torch.from_numpy(np.array(v)))
        want = jax.jit(lambda p, x, y: jk.K_blocked(p, x, y, block_size=4))(
            params, X, X2)
        Xt = torch.tensor(X, requires_grad=True)
        got = tk.K_blocked(Xt, torch.from_numpy(X2), block_size=4)
        direct = tk.K(Xt, torch.from_numpy(X2))
        assert rel_err(want, got) <= KINK
        assert rel_err(direct.detach().numpy(), got) <= KINK
        g_blk, = torch.autograd.grad(got.sum(), Xt)
        g_dir, = torch.autograd.grad(direct.sum(), Xt)
        assert rel_err(g_dir.numpy(), g_blk) <= 1e-6
        sym = tk.K_blocked(Xt, block_size=4, method="pallas")
        assert rel_err(tk.K(Xt).detach().numpy(), sym) <= KINK
    rbf = T.kernels.SignatureRBF(2, 3, dtype=torch.float64, device="cpu")
    Xt = torch.from_numpy(X)
    with torch.no_grad():
        assert rel_err(rbf.K(Xt).numpy(), rbf.K_blocked(
            Xt, method="pallas", fast_math=True)) <= 1e-10
    with pytest.raises(ValueError, match="method"):
        rbf.K_blocked(Xt, method="nope")
