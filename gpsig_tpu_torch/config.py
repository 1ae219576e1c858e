"""Global numerics policy for the PyTorch port.

Mirrors ``gpsig_tpu/config.py``: a default float type for newly built
parameters and the jitter added to diagonals before Cholesky and level
normalization.  Computations follow the dtype of the tensors they are given.

It is also the one place that pins full-f32 matrix products on the card.
The JAX package pins ``Precision.HIGHEST`` for every base-kernel contraction
(``gpsig_tpu/ops/base_kernels.py:24-30``) because GP numerics do not survive
reduced-precision Grams; the CUDA counterpart of that switch is to keep
TF32 off for both cuBLAS matmuls and cuDNN.  Importing the package sets it.
"""

from __future__ import annotations

import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class NumericsConfig:
    #: default dtype for newly built parameters; None = torch's default dtype
    default_float: torch.dtype | None = None
    #: jitter added to diagonals before Cholesky / normalization
    jitter: float = 1e-6


_CONFIG = NumericsConfig()


def default_float() -> torch.dtype:
    if _CONFIG.default_float is not None:
        return _CONFIG.default_float
    return torch.get_default_dtype()


def jitter() -> float:
    return _CONFIG.jitter


def set_default_float(dtype: torch.dtype) -> None:
    _CONFIG.default_float = dtype


def set_jitter(value: float) -> None:
    _CONFIG.jitter = float(value)
