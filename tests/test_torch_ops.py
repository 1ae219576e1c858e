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
from gpsig_tpu.ops import signature as jsig
from gpsig_tpu_torch import InducingTensors, SVGP
from gpsig_tpu_torch.kernels import SignatureKernel
from gpsig_tpu_torch.likelihoods import MultiClass
from gpsig_tpu_torch.ops import base_kernels as tbk
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
    """Every base, low-rank features and mean functions are ported now;
    what is left raises as the JAX package does: low-rank features at
    order > 1, ``predict_f_samples`` without a generator (JAX's without a
    key), an unknown base."""
    with pytest.raises(NotImplementedError, match="order == 1"):
        SignatureKernel(2, 3, order=2, low_rank=True, device="cpu")
    model = SVGP(SignatureKernel(2, 2, device="cpu"),
                 InducingTensors(np.zeros((3, 4, 2, 2)), 2, increments=True,
                                 device="cpu"),
                 MultiClass(3), num_latent=3, device="cpu")
    with pytest.raises(ValueError, match="torch.Generator"):
        model.predict_f_samples(torch.zeros(1, 4, 2), num_samples=2)
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
