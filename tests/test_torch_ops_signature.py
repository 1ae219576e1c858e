"""The port's first-order signature recursions against ``gpsig_tpu``'s.

Split from ``test_torch_ops.py`` (its helpers and tolerances: <= 1e-12 *
max(|ref|, 1) at float64, <= 1e-6 at float32), so that no port test file
queues ahead of the suite's long JAX files under xdist's ``loadfile``.
"""

import jax
import pytest

from gpsig_tpu.ops import base_kernels as jbk
from gpsig_tpu.ops import signature as jsig
from gpsig_tpu_torch.ops import base_kernels as tbk
from gpsig_tpu_torch.ops import signature as tsig
from test_torch_ops import DTYPES, RNG, _both, _close, _paths


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("difference", [True, False])
def test_tens_vs_seq_first_order(dtype, difference):
    M = (RNG.randn(6, 4, 3, 10) * 0.5).astype(dtype)
    jM, tM = _both(M)
    want = jax.jit(lambda m: jsig.signature_kern_tens_vs_seq_first_order(
        m, 3, difference))(jM)
    _close(want,
           tsig.signature_kern_tens_vs_seq_first_order(tM, 3, difference),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("difference", [True, False])
def test_signature_kern_first_order(dtype, difference):
    X = _paths(dtype)
    jX, tX = _both(X)
    X2 = _paths(dtype, N=2)
    jX2, tX2 = _both(X2)
    N, L, d = X.shape

    def jax_levels(x, x2):  # one jax.jit program: eager JAX compiles every op
        G1 = jbk.rbf({}, x)  # (N, L, L) per-example Grams
        G2 = jbk.rbf({}, x.reshape(-1, d), x2.reshape(-1, d)).reshape(
            N, L, 2, L)
        return (jsig.signature_kern_first_order(G1, 4, difference),
                jsig.signature_kern_first_order(G2, 3, difference))

    want = jax.jit(jax_levels)(jX, jX2)
    tG = tbk.rbf({}, tX)
    _close(want[0], tsig.signature_kern_first_order(tG, 4, difference), dtype)
    tG = tbk.rbf({}, tX.reshape(-1, d), tX2.reshape(-1, d)).reshape(N, L, 2, L)
    _close(want[1], tsig.signature_kern_first_order(tG, 3, difference), dtype)
