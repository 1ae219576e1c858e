"""Lag augmentation of sequences by linear interpolation
(``gpsig_tpu/ops/lags.py``).

Each sequence gets ``num_lags`` time-lagged copies of itself; a fractional
lag is evaluated by piecewise-linear interpolation on the uniform grid
``t_k = k / (L-1)``.  The left bracketing index is ``floor(t * (L-1))``, as
in the JAX package, and the gradient reaches the lags through the
fractional weight.

On the uniform grid the interpolation is applied as an ``(L, num_lags, L)``
weight matrix contracted with the sequences, not as a gather: the backward
of a gather with repeated indices accumulates by scatter, which the card
may do with atomics in any order, while the contraction's backward is
another contraction with a fixed summation order.  Training with lags then
stays bit-reproducible, and a resumed run matches the uninterrupted one.
"""

from __future__ import annotations

import torch


def lin_interp(X, times, query_times):
    """Piecewise-linear interpolation at arbitrary increasing sample times.

    Args:
      X: ``(N, L, d)`` sequence values.
      times: ``(L,)`` or ``(N, L)`` increasing sample times.
      query_times: ``(Q,)`` or ``(N, Q)`` query times, clamped to the
        sample range.

    Returns: ``(N, Q, d)`` interpolated values.
    """
    N, L, d = X.shape
    times = torch.as_tensor(times, dtype=X.dtype, device=X.device)
    times = times.expand(N, L).contiguous()
    query_times = torch.as_tensor(query_times, dtype=X.dtype,
                                  device=X.device)
    query_times = query_times.expand(N, query_times.shape[-1]).contiguous()
    left = torch.clamp(
        torch.searchsorted(times, query_times, right=True) - 1, 0, L - 2)
    t0 = torch.gather(times, 1, left)
    t1 = torch.gather(times, 1, left + 1)
    frac = torch.clamp((query_times - t0) / torch.clamp(t1 - t0, min=1e-30),
                       0.0, 1.0)
    idx = left[:, :, None].expand(-1, -1, d)
    x0 = torch.gather(X, 1, idx)
    x1 = torch.gather(X, 1, idx + 1)
    return x0 + frac[:, :, None] * (x1 - x0)


def _interp_weights(time_query, L: int):
    """``(Q, num_lags, L)`` weights of linear interpolation on the uniform
    grid of L points: ``1 - frac`` at the left bracketing index, ``frac``
    at the next one."""
    pos = time_query * (L - 1)  # fractional index
    left = torch.clamp(torch.floor(pos), 0, L - 2).long()
    frac = (pos - left.to(pos.dtype))[..., None]
    grid = torch.arange(L, device=pos.device)
    at_left = (grid == left[..., None]).to(pos.dtype)
    at_right = (grid == left[..., None] + 1).to(pos.dtype)
    return at_left * (1.0 - frac) + at_right * frac


def lin_interp_uniform(X, time_query):
    """Linearly interpolate sequences sampled on a uniform [0, 1] grid.

    Args:
      X: ``(N, L, d)`` sequence values at times ``t_k = k / (L-1)``.
      time_query: ``(L, num_lags)`` query times in [0, 1].

    Returns: ``(N, L, num_lags, d)`` interpolated values.
    """
    W = _interp_weights(time_query.to(X.dtype), X.shape[-2])
    return torch.einsum("tks,nsd->ntkd", W, X)


def add_lags_to_sequences(X, lags):
    """Append lagged copies of each sequence as extra channel groups.

    Args:
      X: ``(N, L, d)`` sequences.
      lags: ``(num_lags,)`` lag values in (0, 1).

    Returns: ``(N, L, num_lags + 1, d)``, the original first.
    """
    L = X.shape[-2]
    time = torch.arange(L, dtype=X.dtype, device=X.device) / (L - 1)
    time_lags = torch.clamp(time[:, None] - lags[None, :], min=0.0)
    X_lags = lin_interp_uniform(X, time_lags)
    return torch.cat((X[:, :, None, :], X_lags), dim=2)
