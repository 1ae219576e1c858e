"""Kzx, forward: the plain version and the public wrapper on CPU tensors
against the JAX package at float32, against the Pallas kernel in
interpret mode.

Split from ``test_torch_inducing_kernels.py`` (its cases, helpers and
tolerances), so that no port test file queues ahead of the suite's long JAX
files under xdist's ``loadfile``.
"""

import numpy as np
import pytest
import torch

from gpsig_tpu_torch.ops import inducing_cuda as ic
from test_torch_inducing_kernels import (KZX_CASES, LT, M_LVL, RNG, _Z,
                                         _check_kzx)


@pytest.mark.parametrize("dtype", [np.float32])
@pytest.mark.parametrize("base,inc,diff", KZX_CASES)
def test_kzx_plain_and_wrapper(base, inc, diff, dtype):
    _check_kzx(base, inc, diff, dtype)


def test_cpu_runs_count_no_launch_and_bad_inputs_raise():
    Z = torch.from_numpy(_Z(4, 2, True, np.float32))
    X = torch.from_numpy(RNG.randn(2, 6, 2).astype(np.float32))
    before = (ic.kzz_fwd.launches, ic.kzx_fwd.launches)
    ic.fused_tensor_levels(Z, num_levels=M_LVL)
    ic.fused_tens_vs_seq_levels(Z, X, num_levels=M_LVL)
    assert (ic.kzz_fwd.launches, ic.kzx_fwd.launches) == before
    with pytest.raises(ValueError, match="no inducing kernel"):
        ic.fused_tensor_levels(Z, num_levels=M_LVL, base="cosine")
    with pytest.raises(ValueError, match="levels"):
        ic.fused_tensor_levels(Z, num_levels=2)
    with pytest.raises(ValueError, match="CUDA"):
        ic.kzz_fwd(*(torch.zeros(LT, 3, 4, device="meta"),) * 4,
                   num_levels=M_LVL, base="rbf", increments=True)
