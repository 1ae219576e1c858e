"""Initialization heuristics for inducing tensors and lengthscales.

Pure numpy, with the semantics of ``gpsig_tpu/utils/init_heuristics.py``
(same draws from the same seed), so the port can build a model without
importing the JAX package.
"""

from __future__ import annotations

import numpy as np


def _sample_tensors_from(sequences, num_inducing, num_levels, increments, rng):
    """Packed rank-1 tensors from observed subsequences: for level m, pick m
    sorted observation indices per inducing element; with increments, use
    (x_i, x_{i+1}) pairs."""
    chosen = sequences[rng.choice(sequences.shape[0], size=num_inducing,
                                  replace=True)]
    L = chosen.shape[1]
    parts = []
    for m in range(1, num_levels + 1):
        if increments:
            idx = np.stack(
                [np.sort(rng.choice(L - 1, size=m, replace=False))
                 for _ in range(num_inducing)], axis=0,
            )[..., None]  # (n, m, 1)
            obs1 = np.take_along_axis(chosen, idx, axis=1)
            obs2 = np.take_along_axis(chosen, idx + 1, axis=1)
            parts.append(
                np.concatenate((obs1[:, :, None, :], obs2[:, :, None, :]),
                               axis=2)
            )  # (n, m, 2, d)
        else:
            idx = np.stack(
                [np.sort(rng.choice(L, size=m, replace=False))
                 for _ in range(num_inducing)], axis=0,
            )[..., None]
            parts.append(np.take_along_axis(chosen, idx, axis=1))  # (n, m, d)
    return np.concatenate(parts, axis=1)  # (n, len_tensors, [2,] d)


def suggest_initial_inducing_tensors(sequences, num_levels: int,
                                     num_inducing: int, *, labels=None,
                                     increments: bool = False,
                                     num_lags: int | None = None,
                                     seed: int | None = None):
    """Initial packed inducing tensors, class-stratified when ``labels`` is
    given, with 0.4-sigma jitter.

    Returns ``(len_tensors, num_inducing, [2,] d*(num_lags+1))`` with
    ``len_tensors = num_levels*(num_levels+1)/2``.
    """
    rng = np.random.RandomState(seed)
    sequences = np.asarray(sequences)

    chunks = []
    if labels is not None:
        labels = np.asarray(labels)
        for c in np.unique(labels):
            frac = np.mean(labels == c)
            n_c = int(np.floor(frac * num_inducing))
            if n_c > 0:
                chunks.append(
                    _sample_tensors_from(sequences[labels == c], n_c,
                                         num_levels, increments, rng)
                )
    remaining = num_inducing - sum(z.shape[0] for z in chunks)
    if remaining > 0:
        chunks.append(
            _sample_tensors_from(sequences, remaining, num_levels,
                                 increments, rng)
        )
    Z = np.concatenate(chunks, axis=0)  # (num_inducing, len_tensors, [2,] d)

    # move the packed-slot axis first
    if increments:
        Z = Z.transpose(1, 0, 2, 3)  # (len_tensors, n, 2, d)
    else:
        Z = Z.transpose(1, 0, 2)  # (len_tensors, n, d)

    if num_lags is not None and num_lags > 0:
        reps = num_lags + 1
        Z = np.tile(Z[..., None, :], (1,) * (Z.ndim - 1) + (reps, 1))
        Z = Z.reshape(*Z.shape[:-2], reps * Z.shape[-1])

    return Z + 0.4 * rng.randn(*Z.shape)


def suggest_initial_lengthscales(X, num_samples: int | None = None,
                                 seed: int | None = None):
    """Per-dimension lengthscales: sqrt(mean pairwise squared distance per
    dimension * d), floored at 1."""
    rng = np.random.RandomState(seed)
    X = np.asarray(X).reshape(-1, np.asarray(X).shape[-1])
    X = X[~np.any(np.isnan(X), axis=1)]
    if num_samples is not None and num_samples < X.shape[0]:
        X = X[rng.choice(X.shape[0], size=num_samples, replace=False)]
    sq = np.square(X)
    # E_{i,j} (x_i - x_j)^2 per dim = 2 E x^2 - 2 (E x)^2
    mean_sq_dist = (
        sq.mean(axis=0) + sq.mean(axis=0)
        - 2.0 * np.square(X.mean(axis=0))
    )
    l_init = np.sqrt(mean_sq_dist * X.shape[1])
    return np.maximum(l_init, 1.0)
