"""Static base kernels as pure functions (``gpsig_tpu/ops/base_kernels.py``).

The port carries the two bases its hand kernels cover, rbf and linear.  The
other nine bases of the JAX package raise ``NotImplementedError`` naming the
ROADMAP item that ports them.  Contractions run in full f32 on the card:
``config.py`` keeps TF32 off.

All kernels take ``X: (..., n, d)`` and ``X2: (..., m, d)`` (or None for the
symmetric case) and return ``(..., n, m)``.
"""

from __future__ import annotations

import torch

_OTHER_BASES = "ROADMAP Queue 1, item 6 (the other base kernels)"
_NOT_PORTED = {
    "matern12": "ROADMAP Queue 1, item 2 (matern12 in K1-K6)",
    **{name: _OTHER_BASES for name in (
        "cosine", "poly", "mix", "matern32", "matern52", "spectral_rbf",
        "spectral_exp", "spectral_mixed")},
}


def _inner(X, X2):
    return torch.matmul(X, X2.transpose(-1, -2))


def square_dist(X, X2=None):
    """Pairwise squared Euclidean distance, clamped at 0."""
    Xs = torch.sum(torch.square(X), dim=-1)
    if X2 is None:
        d = Xs[..., :, None] + Xs[..., None, :] - 2.0 * _inner(X, X)
    else:
        X2s = torch.sum(torch.square(X2), dim=-1)
        d = Xs[..., :, None] + X2s[..., None, :] - 2.0 * _inner(X, X2)
    return torch.clamp(d, min=0.0)


def linear(params, X, X2=None):
    return _inner(X, X if X2 is None else X2)


def rbf(params, X, X2=None):
    return torch.exp(-square_dist(X, X2) / 2.0)


BASE_KERNELS = {"linear": linear, "rbf": rbf}


def _check(name: str) -> None:
    if name in BASE_KERNELS:
        return
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"base kernel {name!r} is not ported to PyTorch yet: "
            f"{_NOT_PORTED[name]}"
        )
    raise ValueError(
        f"Unknown base kernel {name!r}; available: {sorted(BASE_KERNELS)}"
    )


def get(name: str):
    _check(name)
    return BASE_KERNELS[name]


def init_params(name: str, *, dtype=None, device=None):
    """(raw_params, bijectors) of a base kernel; rbf and linear have none."""
    _check(name)
    return {}, {}


def static_params(name: str) -> dict:
    """Non-trainable base-kernel configuration; rbf and linear have none."""
    _check(name)
    return {}
