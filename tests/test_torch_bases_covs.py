"""The covariances of the bases without a hand kernel, the port against
``gpsig_tpu`` on the models of ``test_torch_bases_svgp.py`` (JAX's raw
leaves carried across): ``K_tens_n_seq_covs`` of incremental inducing
tensors (Kzz, Kzx and Kxx's diagonal, or the full Kxx) for one base of
each family, and ``K_seq_n_seq_covs`` of inducing sequences, level by
level.

Tolerances: each output <= 1e-9 relative to its largest entry for the port
at float64 against JAX at float64, <= 1e-4 for the port at float32 (the
closed forms; spectral Kzz on the naive graph) against JAX at float64.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_bases_svgp import FAMILIES, TOL, _data, setup
from test_torch_inducing_sequences import _close


def _jax_covs(jmodel, params, X, kind, full):
    kern, Z = jmodel.kern, params["ind"]["Z"]
    if kind == "tensors":
        return jax.jit(lambda p, z, x: kern.K_tens_n_seq_covs(
            p, z, x, increments=True, full_X_cov=full,
            return_levels=True))(params["kern"], Z, X)
    return jax.jit(lambda p, z, x: kern.K_seq_n_seq_covs(
        p, z, x, full_X2_cov=full, return_levels=True))(params["kern"], Z, X)


def check_covs(base, kind):
    jmodel, params, _ = setup(base, kind)
    X, _ = _data()
    for full in (False, True):
        want = _jax_covs(jmodel, params, X, kind, full)
        for dtype, tol in TOL.items():
            tmodel = setup(base, kind, dtype)[2]
            Xt = torch.from_numpy(X).to(dtype)
            with torch.no_grad():
                if kind == "tensors":
                    got = tmodel.kern.K_tens_n_seq_covs(
                        tmodel.ind.Z, Xt, increments=True, full_X_cov=full,
                        return_levels=True)
                else:
                    got = tmodel.kern.K_seq_n_seq_covs(
                        tmodel.ind.Z, Xt, full_X2_cov=full,
                        return_levels=True)
            for w, g in zip(want, got):
                _close(w, g, tol)


@pytest.mark.parametrize("base", FAMILIES)
def test_tens_n_seq_covs(base):
    check_covs(base, "tensors")


@pytest.mark.parametrize("base", ["matern32", "spectral_rbf"])
def test_seq_n_seq_covs(base):
    check_covs(base, "sequences")
