"""Serving: bucketed fixed-shape prediction over an SVGP on one device.

The port of ``gpsig_tpu/serving.py::Predictor`` with the same bucket
policy.  A request of n sequences of length l runs on the smallest batch
bucket >= n and the smallest length bucket >= l, so a server sees a small
fixed set of shapes.  Padding:

* time axis: repeating the last observation appends zero increments, which
  the signature recursions ignore exactly -- without lags.  With
  ``num_lags`` the lagged copies are interpolated on the grid
  ``arange(L) / (L - 1)`` of the padded length (``ops/lags.py``), so a
  padded request gets other lagged features than the same request unpadded
  and its prediction differs; the JAX ``Predictor`` behaves the same way;
* batch axis: SVGP prediction is row-independent, so rows padded with
  copies of the last example are sliced away exactly.

Prediction runs under ``torch.inference_mode()`` on the device the
Predictor was given.  ``export_predict`` / ``save_exported`` /
``load_exported`` wait for ROADMAP Queue 1, item 5.
"""

from __future__ import annotations

import copy

import torch

from . import config as cfg


def _pad_batch(X: torch.Tensor, batch: int, seq_len: int) -> torch.Tensor:
    """Pad (n, l, d) observations to (batch, seq_len, d) by repeating the
    last observation (time) and the last example (batch)."""
    n, l = X.shape[0], X.shape[1]
    if l > seq_len:
        raise ValueError(f"sequence length {l} exceeds bucket {seq_len}")
    if n > batch:
        raise ValueError(f"batch {n} exceeds bucket {batch}")
    if l < seq_len:
        X = torch.cat([X, X[:, -1:].expand(-1, seq_len - l, -1)], dim=1)
    if n < batch:
        X = torch.cat([X, X[-1:].expand(batch - n, -1, -1)], dim=0)
    return X


def _pick_bucket(n: int, buckets, kind: str = "batch") -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"{kind} {n} exceeds the largest serving bucket {max(buckets)}; "
        "split the request or construct the Predictor with larger buckets"
    )


class Predictor:
    """Bucketed predictor over an SVGP model on one explicit device.

    Args:
      model: a ``gpsig_tpu_torch.SVGP``.  The Predictor answers from a
        copy of it, taken at construction, on ``device`` at ``dtype`` and
        in eval mode; the caller's module keeps its dtype, device, mode and
        parameter storage, and later changes to it do not reach the
        Predictor (as JAX's answers from the parameters it was given).
      max_len: shorthand for ``len_buckets=(max_len,)``.
      len_buckets: ascending padded sequence lengths.
      batch_buckets: ascending padded batch sizes.
      device: where prediction runs; defaults to
        ``config.default_device()``, the card.
      dtype: working float type; defaults to the model's.
    """

    def __init__(self, model, *, max_len: int | None = None,
                 len_buckets=None, batch_buckets=(1, 8, 32), device=None,
                 dtype=None):
        if len_buckets is None:
            if max_len is None:
                raise ValueError("pass max_len or len_buckets")
            len_buckets = (max_len,)
        self.device = torch.device(device or cfg.default_device())
        self.dtype = dtype or next(model.parameters()).dtype
        self.model = copy.deepcopy(model).to(device=self.device,
                                             dtype=self.dtype).eval()
        self.len_buckets = tuple(sorted(int(x) for x in len_buckets))
        self.max_len = self.len_buckets[-1]
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))

    def _run(self, what: str, X):
        X = torch.as_tensor(X).to(device=self.device, dtype=self.dtype)
        n, l = X.shape[0], X.shape[1]
        b = _pick_bucket(n, self.batch_buckets)
        lb = _pick_bucket(l, self.len_buckets, kind="sequence length")
        fn = self.model.predict_y if what == "y" else self.model.predict_f
        with torch.inference_mode():
            out = fn(_pad_batch(X, b, lb))
        return tuple(o[:n] for o in out)

    def warmup(self, num_features: int, *, what: str = "y") -> None:
        """Run one call per (length, batch) bucket before taking traffic."""
        for lb in self.len_buckets:
            for b in self.batch_buckets:
                self._run(what, torch.zeros((b, lb, int(num_features))))

    def predict_y(self, X):
        """Predictive mean and variance of observables, shapes (n, P)."""
        return self._run("y", X)

    def predict_f(self, X):
        """Latent q(f*) mean and variance, shapes (n, P)."""
        return self._run("f", X)

    def predict_classes(self, X) -> torch.Tensor:
        """Argmax class ids under the predictive mean, shape (n,)."""
        pmean, _ = self.predict_y(X)
        return torch.argmax(pmean, dim=1)
