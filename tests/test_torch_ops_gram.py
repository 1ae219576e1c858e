"""The port's closed-form increment Grams (``ops/gram.py``) against
``gpsig_tpu``'s.

Split from ``test_torch_ops.py`` (its helpers and tolerances: <= 1e-12 *
max(|ref|, 1) at float64, <= 1e-6 at float32), so that no port test file
queues ahead of the suite's long JAX files under xdist's ``loadfile``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpsig_tpu.ops import gram as jgram
from gpsig_tpu_torch.ops import gram as tgram
from test_torch_ops import DTYPES, HIGHEST, RNG, TOL, _both, _close, _paths


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
    # JAX through one jax.jit program: eager JAX compiles every op
    want = jax.jit(lambda x, x2: (
        jd(x, HIGHEST), jc(x, x2, HIGHEST),
        jgram.level1_exact_diag(jd, x, HIGHEST)))(jX, jX2)
    _close(want[0], td(tX), dtype)
    _close(want[1], tc(tX, tX2), dtype)
    _close(want[2], tgram.level1_exact_diag(td, tX), dtype)


def test_unsupported_base_has_no_closed_form():
    """Every base has a closed form now; those of poly and the spectral
    family need the constrained parameters, and without them there is
    none, as in JAX."""
    for base in ("poly", "spectral_rbf", "mix"):
        assert tgram.increment_gram_fns(base) == (None, None)
        assert jgram.increment_gram_fns(base) == (None, None)
