"""Static base kernels as pure functions (``gpsig_tpu/ops/base_kernels.py``).

The port carries the three bases its hand kernels cover: rbf, linear and
matern12 (exp(-r)).  The other eight bases of the JAX package raise
``NotImplementedError`` naming the ROADMAP item that ports them.
Contractions run in full f32 on the card: ``config.py`` keeps TF32 off.

All kernels take ``X: (..., n, d)`` and ``X2: (..., m, d)`` (or None for the
symmetric case) and return ``(..., n, m)``.
"""

from __future__ import annotations

import torch

_NOT_PORTED = {name: "ROADMAP Queue 1, item 6 (the other base kernels)"
               for name in ("cosine", "poly", "mix", "matern32", "matern52",
                            "spectral_rbf", "spectral_exp",
                            "spectral_mixed")}


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


def euclid_dist(X, X2=None):
    """Pairwise Euclidean distance; the sqrt guard is a normal f32 (1e-40
    is subnormal), so sqrt's VJP at coincident points stays finite."""
    return torch.sqrt(torch.clamp(square_dist(X, X2), min=1e-36))


def linear(params, X, X2=None):
    return _inner(X, X if X2 is None else X2)


def rbf(params, X, X2=None):
    return torch.exp(-square_dist(X, X2) / 2.0)


def matern12(params, X, X2=None):
    return torch.exp(-euclid_dist(X, X2))


BASE_KERNELS = {"linear": linear, "rbf": rbf, "matern12": matern12}


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
    """(raw_params, bijectors) of a base kernel; rbf, linear and matern12
    have none."""
    _check(name)
    return {}, {}


def static_params(name: str) -> dict:
    """Non-trainable base-kernel configuration; rbf, linear and matern12
    have none."""
    _check(name)
    return {}
