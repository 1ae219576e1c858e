"""The spectral family's closed-form increment Grams at float32 against
the float64 oracle, for the port and for ``gpsig_tpu``
(``tests/test_spectral_increments.py:112`` and ``:134``); and, for the
eight bases without a hand kernel, exact zeros under repeat padding, the
poly maker's gates, the 'mixed' split and the Kzz slot dispatch.

Split from ``test_torch_bases_increments.py`` (its helpers), so that each
test takes a few seconds and no file holds more than 9 tests.
"""

import numpy as np
import pytest
import torch

from gpsig_tpu.ops import gram as jgram
from gpsig_tpu_torch.ops import base_kernels as tbk
from gpsig_tpu_torch.ops import gram as tgram
from test_torch_bases_increments import (FAMILIES, NEW_BASES, _f32_errors,
                                         as_torch, base_params, paths)


@pytest.mark.parametrize("regime", ["smooth", "oscillatory"])
@pytest.mark.parametrize("base", FAMILIES["spectral"])
def test_spectral_f32_against_f64_oracle(base, regime):
    """1e-4 relative, and 0.2x (smooth: frequencies and scales x0.1) or 5x
    (oscillatory) the naive second difference."""
    params = base_params(base, seed=57,
                         scale=0.1 if regime == "smooth" else 1.0)
    (port, jx, naive), scale = _f32_errors(base, params)
    port, jx, naive = port / scale, jx / scale, naive / scale
    assert port < 1e-4 and jx < 1e-4, (port, jx)
    if regime == "smooth":
        assert port < 0.2 * naive, (port, naive)
    else:
        assert port < 5.0 * max(naive, 1e-7), (port, naive)


def test_repeat_padding_increments_exactly_zero():
    X = paths(2, 6, 2)
    Xp = torch.from_numpy(np.concatenate(
        [X, np.repeat(X[:, -1:], 3, axis=1)], axis=1))
    for base in NEW_BASES:
        cross, _ = tgram.increment_gram_fns(base, as_torch(
            base_params(base, d=2)))
        M = cross(Xp, Xp)
        assert float(M[:, :, 5:, :].abs().max()) == 0.0, base
        assert float(M[:, :, :, 5:].abs().max()) == 0.0, base


def test_poly_gates_mix_split_and_slot_dispatch():
    """The poly maker's gates are JAX's (no degree, non-integer, past 16:
    None); degree 1 is the linear increment Gram; spectral 'mixed' is rbf
    on the first Q//2 components plus exp on the rest; only spectral keeps
    the naive Kzz graph."""
    for p in (None, {"poly_gamma": 1.0, "poly_degree": 2.5},
              {"poly_gamma": 1.0, "poly_degree": 40.0},
              {"poly_gamma": 1.0, "poly_degree": 17.0}):
        assert tgram.increment_gram_fns("poly", p) == (None, None)
        assert jgram.increment_gram_fns("poly", p) == (None, None)
    assert tgram.increment_gram_pair_fn(
        "poly", {"poly_gamma": 1.0, "poly_degree": 2.5}) is None
    assert tgram.increment_gram_fns("poly", {
        "poly_gamma": torch.tensor(1.0), "poly_degree": 16.0})[0] is not None
    X, Y = (torch.from_numpy(paths(2, 8, 2)) for _ in range(2))
    deg1, _ = tgram.increment_gram_fns("poly", {
        "poly_gamma": torch.tensor(2.0, dtype=torch.float64),
        "poly_degree": 1.0})
    lin = tgram.INCREMENT_GRAMS["linear"][0](X, Y)
    assert float((deg1(X, Y) - lin).abs().max()) <= 1e-12
    p = as_torch(base_params("spectral_mixed", d=2, Q=4))
    mixed, _ = tgram.increment_gram_fns("spectral_mixed", p)
    rbf, _ = tgram.increment_gram_fns("spectral_rbf",
                                      {k: v[:2] for k, v in p.items()})
    exp, _ = tgram.increment_gram_fns("spectral_exp",
                                      {k: v[2:] for k, v in p.items()})
    assert float((mixed(X, Y) - rbf(X, Y) - exp(X, Y)).abs().max()) <= 1e-12
    for base in tbk.BASE_KERNELS:
        assert tgram.tens_closed_form_ok(base) == jgram.tens_closed_form_ok(
            base)
