"""Static base kernels as pure functions (``gpsig_tpu/ops/base_kernels.py``).

All eleven bases of the JAX package: linear, cosine, poly, rbf, mix,
matern12/32/52 and the spectral mixture with families rbf, exp and mixed.
Each is ``k(params, X, X2) -> Gram`` over the constrained parameter dict.
The hand kernels cover rbf, linear and matern12 (``inducing_cuda``,
``signature_cuda``); the other bases run as torch ops, as JAX runs them
through XLA.  Contractions run in full f32 on the card: ``config.py``
keeps TF32 off.

All kernels take ``X: (..., n, d)`` and ``X2: (..., m, d)`` (or None for
the symmetric case) and return ``(..., n, m)``.
"""

from __future__ import annotations

import math

import torch

from .. import config as cfg
from .. import params as pm


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


def cosine(params, X, X2=None):
    """Inner product of the unit-normalized points; the norm guards sit in
    the f32-normal range, as ``euclid_dist``'s."""
    Xn = torch.sqrt(torch.clamp(torch.sum(torch.square(X), dim=-1),
                                min=1e-36))
    if X2 is None:
        X2, X2n = X, Xn
    else:
        X2n = torch.sqrt(torch.clamp(torch.sum(torch.square(X2), dim=-1),
                                     min=1e-36))
    return _inner(X, X2) / (Xn[..., :, None] * X2n[..., None, :])


def poly(params, X, X2=None):
    """(<x, y> + gamma)^degree: trainable ``poly_gamma``, static
    ``poly_degree`` (``static_params``)."""
    return ((_inner(X, X if X2 is None else X2) + params["poly_gamma"])
            ** params["poly_degree"])


def rbf(params, X, X2=None):
    return torch.exp(-square_dist(X, X2) / 2.0)


def mix(params, X, X2=None):
    """mixing * rbf + (1 - mixing) * linear, trainable ``mixing``."""
    inner = _inner(X, X if X2 is None else X2)
    mixing = params["mixing"]
    return (mixing * torch.exp(-square_dist(X, X2) / 2.0)
            + (1.0 - mixing) * inner)


def matern12(params, X, X2=None):
    return torch.exp(-euclid_dist(X, X2))


def matern32(params, X, X2=None):
    r = euclid_dist(X, X2)
    s3 = math.sqrt(3.0)
    return (1.0 + s3 * r) * torch.exp(-s3 * r)


def matern52(params, X, X2=None):
    r = euclid_dist(X, X2)
    s5 = math.sqrt(5.0)
    return (1.0 + s5 * r + (5.0 / 3.0) * torch.square(r)) * torch.exp(-s5 * r)


def spectral(params, X, X2=None, *, family: str = "rbf"):
    """Spectral-mixture base kernel: ``sum_q alpha_q exp(A_q) cos(B_q)``
    with ``B_q = 2 pi <omega_q, x - y>`` and ``A_q = -|gamma_q (x - y)|^2
    / 2`` (family 'rbf') or ``-|gamma_q (x - y)| / 2`` ('exp'); 'mixed'
    takes rbf for the first Q//2 components and exp for the rest.

    params: ``alpha (Q,)``, ``omega (Q, d)``, ``spec_gamma (Q, d)``.  The
    per-component sums over features are two matmuls of the (..., n, m, d)
    differences against (d, Q) weights (squares against gamma^2), the same
    sums as JAX's, without its (..., Q, n, m, d) temporaries."""
    if X2 is None:
        X2 = X
    alpha, omega, gamma = params["alpha"], params["omega"], params["spec_gamma"]
    Q = alpha.shape[0]
    diff = X[..., :, None, :] - X2[..., None, :, :]  # (..., n, m, d)
    sq = torch.movedim(torch.matmul(torch.square(diff),
                                    torch.square(gamma).T), -1, -3)
    phase = torch.movedim(torch.matmul(diff, omega.T), -1, -3)  # (..., Q, n, m)
    spectral_term = torch.cos(2.0 * math.pi * phase)
    if family == "exp":
        kern_term = torch.exp(-torch.sqrt(torch.clamp(sq, min=1e-36)) / 2.0)
    elif family == "rbf":
        kern_term = torch.exp(-sq / 2.0)
    elif family == "mixed":
        Q1 = Q // 2
        rbf_term = torch.exp(-sq[..., :Q1, :, :] / 2.0)
        exp_term = torch.exp(
            -torch.sqrt(torch.clamp(sq[..., Q1:, :, :], min=1e-36)) / 2.0)
        kern_term = torch.cat([rbf_term, exp_term], dim=-3)
    else:
        raise ValueError(f"Unrecognized spectral family: {family}")
    return torch.sum(kern_term * spectral_term * alpha[:, None, None], dim=-3)


def _spectral_family(family: str):
    def fn(params, X, X2=None):
        return spectral(params, X, X2, family=family)

    fn.__name__ = f"spectral_{family}"
    return fn


BASE_KERNELS = {
    "linear": linear,
    "cosine": cosine,
    "poly": poly,
    "rbf": rbf,
    "mix": mix,
    "matern12": matern12,
    "matern32": matern32,
    "matern52": matern52,
    "spectral_rbf": _spectral_family("rbf"),
    "spectral_exp": _spectral_family("exp"),
    "spectral_mixed": _spectral_family("mixed"),
}


def get(name: str):
    try:
        return BASE_KERNELS[name]
    except KeyError:
        raise ValueError(
            f"Unknown base kernel {name!r}; available: {sorted(BASE_KERNELS)}"
        ) from None


def init_params(name: str, generator: torch.Generator | None = None, *,
                num_features: int | None = None, poly_gamma: float = 1.0,
                poly_degree: float = 3.0, Q: int = 5, dtype=None,
                device=None):
    """(raw_params, bijectors) of a base kernel, the JAX package's leaves,
    shapes and bijectors: ``poly_gamma`` and ``mixing`` positive; the
    spectral ``alpha`` (Q,), ``omega`` and ``spec_gamma`` (Q, num_features),
    positive, each exp(N(0, 1)) drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 if None).  torch and jax.random draw
    different streams: carry JAX's leaves across with
    ``convert.load_jax_params``.  ``poly_degree`` is static
    (``static_params``)."""
    get(name)
    dtype = dtype or cfg.default_float()
    if name == "poly":
        return ({"poly_gamma": pm.raw_init(poly_gamma, "positive", dtype,
                                           device)},
                {"poly_gamma": "positive"})
    if name == "mix":
        return ({"mixing": pm.raw_init(0.5, "positive", dtype, device)},
                {"mixing": "positive"})
    if name.startswith("spectral"):
        if num_features is None:
            raise ValueError("spectral bases need num_features")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        raw = {
            leaf: pm.raw_init(torch.exp(torch.randn(
                shape, generator=generator, dtype=dtype)), "positive", dtype,
                device)
            for leaf, shape in (("alpha", (Q,)), ("omega", (Q, num_features)),
                                ("spec_gamma", (Q, num_features)))
        }
        return raw, dict.fromkeys(raw, "positive")
    return {}, {}


def static_params(name: str, *, poly_degree: float = 3.0, **_unused) -> dict:
    """Non-trainable base-kernel configuration, joined to the constrained
    parameters at use time so that no optimizer touches it: the poly degree
    (the reference pins it with trainable=False)."""
    if name == "poly":
        return {"poly_degree": float(poly_degree)}
    return {}
