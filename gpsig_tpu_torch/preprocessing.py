"""Host-side sequence preprocessing (numpy), the port's copy of
``gpsig_tpu/preprocessing.py``: ragged-list tabulation with
signature-invariant padding, and time / natural-parametrization channels.
Repeat-last-observation padding leaves signatures exactly unchanged (a
constant path appended), so variable-length data go to fixed shapes.
"""

from __future__ import annotations

import numpy as np


def pad_sequence(seq: np.ndarray, max_length: int, *, pre: bool = False,
                 pad_with=None) -> np.ndarray:
    """Pad a (L, d) sequence to (max_length, d).

    pad_with=None repeats the first/last observation (signature-invariant);
    otherwise pads with the given constant (e.g. 0 for masking RNNs, NaN for
    the kconv model; cf. `preprocessing.py:5-17,49-55`).
    """
    seq = np.asarray(seq)
    n_pad = max_length - seq.shape[0]
    if n_pad <= 0:
        return seq
    if pad_with is None:
        block = np.tile(seq[0] if pre else seq[-1], (n_pad, 1))
    else:
        block = np.full((n_pad, seq.shape[1]), float(pad_with))
    return np.concatenate((block, seq) if pre else (seq, block), axis=0)


def tabulate_list_of_sequences(sequences_list, *, orient_ax: int = 0,
                               pad_with=None, pre: bool = False) -> np.ndarray:
    """Ragged list of (L_i, d) arrays -> (N, max L_i, d) array
    (<- `preprocessing.py:20-61`)."""
    seqs = [np.asarray(s) for s in sequences_list]
    if not all(s.ndim == 2 for s in seqs):
        raise ValueError("every sequence must be 2-D (length, features)")
    if orient_ax == 1:
        seqs = [s.T for s in seqs]
    d = {s.shape[1] for s in seqs}
    if len(d) != 1:
        raise ValueError(
            "sequences have inconsistent feature dimensions: "
            f"{sorted(d)}"
        )
    max_len = max(s.shape[0] for s in seqs)
    return np.stack(
        [pad_sequence(s, max_len, pre=pre, pad_with=pad_with) for s in seqs],
        axis=0,
    )


def _num_trailing_repeats(seq: np.ndarray) -> int:
    """Number of trailing rows equal to the last row (repeat-padding tail)."""
    n = 1
    while n < seq.shape[0] and np.array_equal(seq[-1 - n], seq[-1]):
        n += 1
    return n - 1


def add_time_to_sequence(seq: np.ndarray) -> np.ndarray:
    """Prepend a normalized-time channel, repeat-padding-aware
    (<- `preprocessing.py:63-80`): time runs over the unique prefix and stays
    constant over the repeated tail so padding remains signature-invariant."""
    seq = np.asarray(seq)
    L = seq.shape[0]
    n_rep = _num_trailing_repeats(seq)
    unique_len = L - n_rep
    time = np.arange(unique_len, dtype=np.float64) / max(unique_len - 1, 1)
    time = np.concatenate((time, np.full(n_rep, time[-1])))
    return np.concatenate((time[:, None], seq), axis=1)


def add_time_to_table(sequences_array: np.ndarray,
                      num_features: int | None = None) -> np.ndarray:
    """(N, L, d) or (N, L*d) table -> (N, L, d+1) with time channel
    (<- `preprocessing.py:82-102`)."""
    arr = np.asarray(sequences_array)
    if arr.ndim == 3:
        num_features = num_features or arr.shape[2]
    else:
        num_features = num_features or 1
    arr = arr.reshape(arr.shape[0], -1, num_features)
    return np.stack([add_time_to_sequence(s) for s in arr], axis=0)


def add_time_to_list(sequences_list):
    """List of (L_i, d) -> list of (L_i, d+1) with a leading time channel
    running over (0, 1] (<- `preprocessing.py:132-143`)."""
    out = []
    for s in sequences_list:
        s = np.asarray(s)
        time = np.arange(1, s.shape[0] + 1, dtype=np.float64)[:, None] / s.shape[0]
        out.append(np.concatenate((time, s), axis=1))
    return out


def _natural_param_channel(seq: np.ndarray) -> np.ndarray:
    """Cumulative arc length, starting at 0."""
    steps = np.linalg.norm(np.diff(seq, axis=0), axis=1)
    return np.concatenate(([0.0], np.cumsum(steps)))


def add_natural_parametrization_to_table(sequences_array: np.ndarray,
                                         num_features: int | None = None
                                         ) -> np.ndarray:
    """Prepend cumulative-arc-length channel to a table
    (<- `preprocessing.py:104-130`)."""
    arr = np.asarray(sequences_array)
    if arr.ndim == 3:
        num_features = num_features or arr.shape[2]
    else:
        num_features = num_features or 1
    arr = arr.reshape(arr.shape[0], -1, num_features)
    nat = np.stack([_natural_param_channel(s) for s in arr], axis=0)
    return np.concatenate((nat[:, :, None], arr), axis=2)


def add_natural_parametrization_to_list(sequences_list):
    """List version (<- `preprocessing.py:145-156`)."""
    return [
        np.concatenate(
            (_natural_param_channel(np.asarray(s))[:, None], np.asarray(s)),
            axis=1,
        )
        for s in sequences_list
    ]


def mean_pool_to_max_len(seq: np.ndarray, max_len: int) -> np.ndarray:
    """Mean-pool consecutive observations so the length is <= max_len
    (<- `benchmarks/utils/datasets.py:39-46`)."""
    seq = np.asarray(seq)
    L = seq.shape[0]
    if L <= max_len:
        return seq
    stride = int(np.ceil(L / max_len))
    n_out = int(np.ceil(L / stride))
    return np.stack(
        [seq[i * stride:min((i + 1) * stride, L)].mean(axis=0)
         for i in range(n_out)],
        axis=0,
    )
