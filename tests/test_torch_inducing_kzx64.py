"""Kzx, forward: the plain version and the public wrapper on CPU tensors
against the JAX package at float64, against its reference graph.

Split from ``test_torch_inducing_kernels.py`` (its cases, helpers and
tolerances), so that no port test file queues ahead of the suite's long JAX
files under xdist's ``loadfile``.
"""

import numpy as np
import pytest

from test_torch_inducing_kernels import KZX_CASES, _check_kzx


@pytest.mark.parametrize("dtype", [np.float64])
@pytest.mark.parametrize("base,inc,diff", KZX_CASES)
def test_kzx_plain_and_wrapper(base, inc, diff, dtype):
    _check_kzx(base, inc, diff, dtype)
