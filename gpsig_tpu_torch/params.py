"""Bijectors between raw (unconstrained) leaves and constrained values.

The same transforms as ``gpsig_tpu/params.py``, so a raw value means the
same constrained value in both packages and parameters carry over
unchanged (see ``convert.py``).
"""

from __future__ import annotations

import torch

_POSITIVE_LOWER = 1e-12


def positive(raw: torch.Tensor) -> torch.Tensor:
    """raw -> positive: softplus(raw) + 1e-12.

    ``logaddexp(raw, 0)`` is the exact softplus at every argument (torch's
    ``F.softplus`` switches to the identity above its threshold)."""
    return torch.logaddexp(raw, torch.zeros_like(raw)) + _POSITIVE_LOWER


def positive_inverse(value: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(value - _POSITIVE_LOWER, min=1e-20)
    # softplus^{-1}(x) = x + log(1 - exp(-x)), stable for both tails
    return x + torch.log(-torch.expm1(-x))


def sigmoid(raw: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(raw)


def sigmoid_inverse(value: torch.Tensor) -> torch.Tensor:
    value = torch.clamp(value, 1e-12, 1.0 - 1e-12)
    return torch.log(value) - torch.log1p(-value)


def identity(raw: torch.Tensor) -> torch.Tensor:
    return raw


def identity_inverse(value: torch.Tensor) -> torch.Tensor:
    return value


BIJECTORS = {
    "positive": (positive, positive_inverse),
    "sigmoid": (sigmoid, sigmoid_inverse),
    "identity": (identity, identity_inverse),
}


def raw_init(value, bijector: str, dtype: torch.dtype,
             device=None) -> torch.Tensor:
    """Raw initial value for a constrained parameter."""
    _, inv = BIJECTORS[bijector]
    return inv(torch.as_tensor(value, dtype=dtype, device=device))


def constrain(raw: torch.Tensor, bijector: str) -> torch.Tensor:
    fwd, _ = BIJECTORS[bijector]
    return fwd(raw)
