"""UEA-style benchmark dataset loading (host-side numpy), the port's copy
of ``gpsig_tpu/datasets.py``: the same float64 arrays for the same files
and seed.  It loads the ``.mat`` archives (ragged object arrays
``X_train/y_train/X_test/y_test``) or the UEA ``.ts`` text files,
optionally adds a time channel, mean-pools long sequences to ``max_len``,
makes stratified val/test splits with a 2-per-class floor, standardizes
per channel on the train split, pads per model family, and re-indexes
labels to 0..C-1.

Padding per model family (`benchmarks/utils/datasets.py:97-120`):
  'sig'   -> repeat-last-observation (signature invariant)
  'nn'    -> zero pre-padding (masked RNNs)
  'kconv' -> NaN padding (Conv1D kernel masks NaN windows)
"""

from __future__ import annotations

import os

import numpy as np

from . import preprocessing as prep

DEFAULT_DATA_DIR = os.environ.get(
    "GPSIG_TPU_DATA_DIR", os.path.join(os.path.dirname(__file__), os.pardir,
                                       "benchmarks", "datasets")
)


def _stratified_split(X_list, y, size, rng):
    """Stratified holdout of ``size`` examples (>=1 per represented class
    proportionally; mirrors sklearn's train_test_split(stratify=y))."""
    y = np.asarray(y)
    n = len(y)
    classes, counts = np.unique(y, return_counts=True)
    # proportional allocation, largest remainders
    quota = size * counts / n
    take = np.floor(quota).astype(int)
    rem = size - take.sum()
    if rem > 0:
        order = np.argsort(-(quota - take))
        take[order[:rem]] += 1
    hold_idx = []
    for c, t in zip(classes, take):
        idx_c = np.flatnonzero(y == c)
        rng.shuffle(idx_c)
        hold_idx.extend(idx_c[:t])
    hold_idx = np.asarray(sorted(hold_idx))
    mask = np.zeros(n, dtype=bool)
    mask[hold_idx] = True
    keep = [X_list[i] for i in np.flatnonzero(~mask)]
    hold = [X_list[i] for i in hold_idx]
    return keep, y[~mask], hold, y[mask]


def _parse_ts_file(path: str):
    """Parse a UEA/sktime ``.ts`` text file into (list of (L, d) float64
    arrays, labels ndarray).

    Format (today's canonical UEA archive distribution, which replaced the
    reference's dead Dropbox ``.mat`` bundle): ``#`` comment lines, ``@``
    header lines (``@problemName``, ``@classLabel true <labels...>``,
    ``@data``), then one case per line — dimensions separated by ``:``,
    values comma-separated within a dimension, the trailing field being the
    class label; ``?`` marks a missing value (NaN here).  Per-case ragged
    lengths are allowed; ``@timeStamps true`` files (explicit (t, v) pairs)
    are not supported.
    """
    X, y = [], []
    in_data = False
    has_labels = None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if not in_data:
                low = line.lower()
                if low.startswith("@timestamps") and "true" in low:
                    raise ValueError(
                        f"{path}: @timeStamps true (.ts files with explicit "
                        "time tuples) is not supported"
                    )
                if low.startswith("@classlabel"):
                    toks = low.split()
                    has_labels = len(toks) > 1 and toks[1] == "true"
                if low.startswith("@data"):
                    if has_labels is None:
                        # never guess: silently eating the last dimension
                        # as a label would corrupt label-less files
                        raise ValueError(
                            f"{path}: no @classLabel header before @data"
                        )
                    in_data = True
                continue
            parts = line.split(":")
            if has_labels:
                parts, label = parts[:-1], parts[-1].strip()
                y.append(label)
            dims = []
            for dim in parts:
                vals = [float("nan") if v.strip() == "?" else float(v)
                        for v in dim.split(",") if v.strip() != ""]
                dims.append(vals)
            L = max(len(v) for v in dims)
            arr = np.full((L, len(dims)), np.nan)
            for j, vals in enumerate(dims):
                arr[:len(vals), j] = vals
            X.append(arr)
    labels = np.asarray(y) if has_labels else np.zeros(len(X))
    try:  # numeric labels stay numeric (matches the .mat loader)
        labels = labels.astype(np.float64)
    except ValueError:
        pass
    return X, labels


def _impute_missing(x: np.ndarray) -> np.ndarray:
    """Per-channel forward-fill then backward-fill of NaNs (from ``?``
    markers or within-case ragged dimension lengths in ``.ts`` files);
    channels with no finite value at all become 0.  Downstream families
    other than 'kconv' have no NaN masking — one surviving NaN would
    silently poison normalization stats and every Gram touching it."""
    if not np.isnan(x).any():
        return x
    x = x.copy()
    n = x.shape[0]
    for j in range(x.shape[1]):
        col = x[:, j]
        ok = np.isfinite(col)
        if not ok.any():
            x[:, j] = 0.0
            continue
        idx = np.where(ok, np.arange(n), -1)
        np.maximum.accumulate(idx, out=idx)          # forward fill
        filled = col[np.maximum(idx, 0)]
        lead = idx < 0                               # leading NaNs remain
        if lead.any():
            first = np.flatnonzero(ok)[0]
            filled[lead] = col[first]                # backward fill head
        x[:, j] = filled
    return x


def _load_ts_split(data_dir: str, name: str, split: str):
    """Find ``{name}_{split}.ts`` either flat in ``data_dir`` or under the
    standard UEA layout ``data_dir/{name}/{name}_{split}.ts``."""
    for p in (os.path.join(data_dir, f"{name}_{split}.ts"),
              os.path.join(data_dir, name, f"{name}_{split}.ts")):
        if os.path.exists(p):
            return _parse_ts_file(p)
    return None


def load_dataset(dataset_name: str, *, normalize_data: bool = False,
                 add_time: bool = False, max_len: int | None = None,
                 val_split=None, test_split=None,
                 data_dir: str | None = None, seed: int = 0):
    """Load and preprocess a UEA dataset from ``.mat`` (the reference's
    format, `benchmarks/utils/datasets.py:16-25`) or, when no ``.mat`` is
    present, from the UEA archive's native ``.ts`` text format
    (``{name}_TRAIN.ts`` / ``{name}_TEST.ts``, flat or in a ``{name}/``
    subdirectory).

    Returns (X_train, y_train, X_val, y_val, X_test, y_test) with X arrays
    of shape (N, L_max, d), shorter sequences padded by repeating their
    last step (the signature models' padding), and integer labels 0..C-1;
    X_val/y_val are None when no validation split is requested.
    """
    data_dir = data_dir or DEFAULT_DATA_DIR
    path = os.path.join(data_dir, f"{dataset_name}.mat")
    if os.path.exists(path):
        from scipy.io import loadmat

        data = loadmat(path)
        X_train = [np.asarray(x, dtype=np.float64)
                   for x in np.squeeze(data["X_train"])]
        X_test = [np.asarray(x, dtype=np.float64)
                  for x in np.squeeze(data["X_test"])]
        y_train = np.squeeze(data["y_train"])
        y_test = np.squeeze(data["y_test"])
    else:
        train = _load_ts_split(data_dir, dataset_name, "TRAIN")
        test = _load_ts_split(data_dir, dataset_name, "TEST")
        if train is None or test is None:
            raise FileNotFoundError(
                f"neither {path} nor {dataset_name}_TRAIN/TEST.ts found in "
                f"{data_dir}; download the UEA archive there "
                "(see benchmarks/README.md)"
            )
        X_train, y_train = train
        X_test, y_test = test
        n_missing = sum(int(np.isnan(x).sum()) for x in X_train + X_test)
        if n_missing:
            import warnings

            warnings.warn(
                f"{dataset_name}: imputed {n_missing} missing values "
                "('?' / ragged dims) by per-channel forward/backward fill",
                stacklevel=2,
            )
            X_train = [_impute_missing(x) for x in X_train]
            X_test = [_impute_missing(x) for x in X_test]

    if add_time:
        X_train = prep.add_time_to_list(X_train)
        X_test = prep.add_time_to_list(X_test)

    if max_len is not None:
        X_train = [prep.mean_pool_to_max_len(x, max_len) for x in X_train]
        X_test = [prep.mean_pool_to_max_len(x, max_len) for x in X_test]

    # no int cast: .ts class labels may be strings (e.g. BasicMotions)
    num_classes = np.unique(y_train).size
    rng = np.random.RandomState(seed)

    def _norm_split(split):
        # fraction -> count, with a 2-per-class floor (`datasets.py:50-60`)
        if split is None:
            return None
        n = len(X_train)
        count = int(np.ceil(split * n)) if split < 1.0 else int(split)
        return max(count, 2 * num_classes)

    val_n = _norm_split(val_split)
    test_n = _norm_split(test_split)

    X_val = y_val = None
    if test_n is not None:
        # carve the test set out of the training data instead
        X_train, y_train, X_test, y_test = _stratified_split(
            X_train, y_train, test_n, rng
        )
    if val_n is not None:
        X_train, y_train, X_val, y_val = _stratified_split(
            X_train, y_train, val_n, rng
        )

    if normalize_data:
        flat = np.concatenate(X_train, axis=0)
        mean, std = flat.mean(axis=0), flat.std(axis=0)
        std = np.where(std == 0, 1.0, std)
        X_train = [(x - mean) / std for x in X_train]
        X_test = [(x - mean) / std for x in X_test]
        if X_val is not None:
            X_val = [(x - mean) / std for x in X_val]

    all_seqs = list(X_train) + (list(X_val) if X_val is not None else []) + list(X_test)
    tab = prep.tabulate_list_of_sequences(all_seqs)
    n_train = len(X_train)
    n_val = len(X_val) if X_val is not None else 0
    X_train = tab[:n_train]
    X_val = tab[n_train:n_train + n_val] if n_val else None
    X_test = tab[n_train + n_val:]

    label_map = {v: i for i, v in enumerate(np.unique(y_train))}
    y_train = np.asarray([label_map[v] for v in y_train])
    y_test = np.asarray([label_map[v] for v in y_test])
    if y_val is not None:
        y_val = np.asarray([label_map[v] for v in y_val])

    return X_train, y_train, X_val, y_val, X_test, y_test
