"""Checkpoint / resume of training state trees (``gpsig_tpu/checkpoint.py``).

A checkpoint is ``torch.save`` of a nested dict (lists allowed) whose
leaves are tensors and Python scalars, so ``torch.load`` reads it back with
its default ``weights_only=True``.  ``save`` turns numpy leaves into
tensors (unsigned integers wider than 8 bits, such as the MT19937 key
array of a ``MinibatchStream``, go as int64) and writes atomically, by
write and rename.  ``restore`` casts each leaf back to the type, dtype and
device of the matching leaf of ``like``.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _storable(x):
    if isinstance(x, dict):
        return {k: _storable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_storable(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        if a.dtype.kind == "u" and a.dtype.itemsize > 1:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a))
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot store a {type(x).__name__} in a checkpoint")


def save(path: str, state: dict) -> None:
    """Write a state tree to ``path`` atomically."""
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_storable(state), tmp)
    os.replace(tmp, path)


def _restore(like, got, where: str):
    if isinstance(like, dict):
        found = (sorted(map(str, got)) if isinstance(got, dict)
                 else type(got).__name__)
        if not isinstance(got, dict) or set(got) != set(like):
            raise ValueError(f"{where}: keys {sorted(map(str, like))} "
                             f"expected, found {found}")
        return {k: _restore(v, got[k], f"{where}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(got, list) or len(got) != len(like):
            raise ValueError(f"{where}: a list of {len(like)} expected")
        return type(like)(_restore(v, g, f"{where}/{i}")
                          for i, (v, g) in enumerate(zip(like, got)))
    if isinstance(like, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"{where}: a tensor expected")
        return got.to(dtype=like.dtype, device=like.device)
    if isinstance(like, (np.ndarray, np.generic)):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"{where}: an array expected")
        return np.asarray(got.numpy(), dtype=np.asarray(like).dtype)
    if isinstance(like, (bool, int, float)):
        if isinstance(got, torch.Tensor):
            got = got.item()
        if not isinstance(got, (bool, int, float)):
            raise ValueError(f"{where}: a number expected")
        return type(like)(got)
    return got


def restore(path: str, like: dict, *, fill_missing: bool = False) -> dict:
    """Load a state tree saved by :func:`save`; ``like`` gives its structure
    and each leaf's type, dtype and device.  Keys of the file that ``like``
    lacks are ignored at the top level; any other difference in structure
    raises ``ValueError``.

    ``fill_missing=True`` tolerates files written by an older build whose
    top-level state lacked keys ``like`` has (e.g. without the best-on-val /
    early-stop fields): those entries keep ``like``'s value.  Only the top
    level fills."""
    got = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(got, dict):
        raise ValueError(f"{path}: not a state tree")
    missing = [k for k in like if k not in got]
    if missing and not fill_missing:
        raise ValueError(f"{path}: missing {sorted(missing)}")
    return {k: (_restore(v, got[k], k) if k in got else v)
            for k, v in like.items()}


def exists(path: str) -> bool:
    return os.path.exists(path)
