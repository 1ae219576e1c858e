"""The port's tensor ops (``gpsig_tpu_torch.ops``) against their
``gpsig_tpu`` counterparts on the same numpy inputs.

Tolerances: <= 1e-12 * max(|ref|, 1) at float64; <= 1e-6 * max(|ref|, 1) at
float32 (the two frameworks round in different orders, and XLA may fuse
multiply-adds that torch keeps separate).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from gpsig_tpu.ops import base_kernels as jbk
from gpsig_tpu.ops import gram as jgram
from gpsig_tpu.ops import signature as jsig
from gpsig_tpu_torch.ops import base_kernels as tbk
from gpsig_tpu_torch.ops import gram as tgram
from gpsig_tpu_torch.ops import signature as tsig

RNG = np.random.RandomState(3)
DTYPES = [np.float64, np.float32]
TOL = {np.float64: 1e-12, np.float32: 1e-6}
HIGHEST = lax.Precision.HIGHEST


def _close(j, t, dtype):
    j = np.asarray(j, dtype=np.float64)
    t = t.detach().numpy().astype(np.float64)
    assert j.shape == t.shape
    scale = max(float(np.max(np.abs(j))), 1.0)
    assert float(np.max(np.abs(j - t))) <= TOL[dtype] * scale


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _paths(dtype, N=3, L=9, d=2, step=0.3):
    return (RNG.randn(N, L, d).cumsum(axis=1) * step).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("base", ["rbf", "linear"])
def test_base_kernels(base, dtype):
    X, X2 = RNG.randn(7, 3).astype(dtype), RNG.randn(5, 3).astype(dtype)
    (jX, tX), (jX2, tX2) = _both(X), _both(X2)
    _close(jbk.get(base)({}, jX), tbk.get(base)({}, tX), dtype)
    _close(jbk.get(base)({}, jX, jX2), tbk.get(base)({}, tX, tX2), dtype)


def test_unported_bases_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbk.get("matern12")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbk.init_params("spectral_rbf")
    with pytest.raises(ValueError, match="Unknown base"):
        tbk.get("nope")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cumsum_exclusive(dtype):
    x = RNG.randn(4, 6, 5).astype(dtype)
    jx, tx = _both(x)
    for axis in (0, 1, 2):
        _close(jsig.cumsum_exclusive(jx, axis), tsig.cumsum_exclusive(tx, axis),
               dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tensor_kern(dtype):
    M = RNG.randn(6, 5, 4).astype(dtype)
    jM, tM = _both(M)
    _close(jsig.tensor_kern(jM, 3), tsig.tensor_kern(tM, 3), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("difference", [True, False])
def test_tens_vs_seq_first_order(dtype, difference):
    M = (RNG.randn(6, 4, 3, 10) * 0.5).astype(dtype)
    jM, tM = _both(M)
    _close(jsig.signature_kern_tens_vs_seq_first_order(jM, 3, difference),
           tsig.signature_kern_tens_vs_seq_first_order(tM, 3, difference),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("difference", [True, False])
def test_signature_kern_first_order(dtype, difference):
    X = _paths(dtype)
    jX, tX = _both(X)
    jG = jbk.rbf({}, jX)  # (N, L, L) per-example Grams
    tG = tbk.rbf({}, tX)
    _close(jsig.signature_kern_first_order(jG, 4, difference),
           tsig.signature_kern_first_order(tG, 4, difference), dtype)
    X2 = _paths(dtype, N=2)
    jX2, tX2 = _both(X2)
    N, L, d = X.shape
    jG = jbk.rbf({}, jX.reshape(-1, d), jX2.reshape(-1, d)).reshape(N, L, 2, L)
    tG = tbk.rbf({}, tX.reshape(-1, d), tX2.reshape(-1, d)).reshape(N, L, 2, L)
    _close(jsig.signature_kern_first_order(jG, 3, difference),
           tsig.signature_kern_first_order(tG, 3, difference), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_exp_accurate_and_expm1(dtype):
    x = np.concatenate([RNG.randn(200) * 20, RNG.randn(200) * 0.2,
                        [0.0, 0.24999, 0.25, -0.25, 88.0, -87.0, 100.0,
                         -100.0]]).astype(dtype)
    jx, tx = _both(x)
    j, t = np.asarray(jgram.exp_accurate(jx)), tgram.exp_accurate(tx)
    # relative: exp spans many decades
    rel = np.abs(j - t.numpy()) / np.maximum(np.abs(j), 1e-30)
    assert float(rel.max()) <= TOL[dtype]
    _close(jgram._expm1_stable(jx), tgram._expm1_stable(tx), dtype)
    small = x[np.abs(x) < 0.25]
    js, ts = _both(small)
    rel = (np.abs(np.asarray(jgram._expm1_stable(js))
                  - tgram._expm1_stable(ts).numpy())
           / np.maximum(np.abs(small), 1e-30))
    assert float(rel.max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_bracket_second_diff(dtype):
    n = 300
    A00 = -np.abs(RNG.randn(n) * 3)
    a01, a10 = RNG.randn(n) * 0.1, RNG.randn(n) * 0.1
    da = RNG.randn(n) * 0.01
    # far-pair regime (large gaps), which takes the naive corner lane
    a01[:50], a10[:50], da[:50] = 30.0, 30.0, -70.0
    args = [a.astype(dtype) for a in (A00, a01, a10, da)]
    j = jgram.bracket_second_diff(*(jnp.asarray(a) for a in args))
    t = tgram.bracket_second_diff(*(torch.from_numpy(a) for a in args))
    _close(j, t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("base", ["rbf", "linear"])
def test_increment_grams_and_level1(base, dtype):
    X, X2 = _paths(dtype), _paths(dtype, N=2, L=7)
    (jX, tX), (jX2, tX2) = _both(X), _both(X2)
    jc, jd = jgram.increment_gram_fns(base)
    tc, td = tgram.increment_gram_fns(base)
    _close(jd(jX, HIGHEST), td(tX), dtype)
    _close(jc(jX, jX2, HIGHEST), tc(tX, tX2), dtype)
    _close(jgram.level1_exact_diag(jd, jX, HIGHEST),
           tgram.level1_exact_diag(td, tX), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("difference", [True, False])
def test_first_order_levels_batched(dtype, difference):
    G = (RNG.randn(3, 8, 8) * 0.3).astype(dtype)
    jG, tG = _both(G)
    _close(jgram.first_order_levels_batched(jG, 4, difference=difference),
           tgram.first_order_levels_batched(tG, 4, difference=difference),
           dtype)


def test_unsupported_base_has_no_closed_form():
    assert tgram.increment_gram_fns("cosine") == (None, None)
