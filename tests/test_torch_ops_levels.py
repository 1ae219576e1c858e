"""The port's batched first-order level sums against ``gpsig_tpu``'s.

Split from ``test_torch_ops.py`` (its helpers and tolerances: <= 1e-12 *
max(|ref|, 1) at float64, <= 1e-6 at float32), so that no port test file
queues ahead of the suite's long JAX files under xdist's ``loadfile``.
"""

import pytest

from gpsig_tpu.ops import gram as jgram
from gpsig_tpu_torch.ops import gram as tgram
from test_torch_ops import DTYPES, RNG, _both, _close


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("difference", [True, False])
def test_first_order_levels_batched(dtype, difference):
    G = (RNG.randn(3, 8, 8) * 0.3).astype(dtype)
    jG, tG = _both(G)
    _close(jgram.first_order_levels_batched(jG, 4, difference=difference),
           tgram.first_order_levels_batched(tG, 4, difference=difference),
           dtype)
