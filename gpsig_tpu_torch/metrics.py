"""Metrics, batched prediction helpers and structured logging
(``gpsig_tpu/metrics.py``).

The helpers take the model, whose parameters it holds, where the JAX
package's take ``(model, params)``.  Each minibatch goes to the device and
float type of the model's parameters, and prediction runs under
``torch.inference_mode()``; results come back as float64 numpy arrays.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def _placement(model):
    p = next(model.parameters())
    return dict(device=p.device, dtype=p.dtype)


def batch_predict_classes(model, X, *, batch_size: int = 50):
    """Hard class predictions in minibatches: the predictive mean above 0.5
    with one latent (Bernoulli), else its argmax."""
    at = _placement(model)
    n = X.shape[0]
    out = np.zeros(n)
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            pmean, _ = model.predict_y(torch.as_tensor(X[i:i + batch_size],
                                                       **at))
            if pmean.shape[1] == 1:
                pred = (pmean[:, 0] > 0.5).double()
            else:
                pred = torch.argmax(pmean, dim=1).double()
            out[i:i + batch_size] = pred.cpu().numpy()
    return out


def batch_predict_log_density(model, X, y, *, batch_size: int = 50):
    """log p(y*|x*) of each example, in minibatches."""
    at = _placement(model)
    n = X.shape[0]
    out = np.zeros(n)
    y = np.asarray(y).reshape(n, -1)
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            ld = model.predict_log_density(
                torch.as_tensor(X[i:i + batch_size], **at),
                torch.as_tensor(y[i:i + batch_size], **at))
            out[i:i + batch_size] = ld.double().cpu().numpy()
    return out


def accuracy(model, X, y, *, batch_size: int = 50) -> float:
    pred = batch_predict_classes(model, X, batch_size=batch_size)
    return float(np.mean(pred == np.asarray(y)))


def nlpp(model, X, y, *, batch_size: int = 50) -> float:
    """Negative log predictive probability (mean)."""
    ld = batch_predict_log_density(model, X, y, batch_size=batch_size)
    return float(-np.mean(ld))


class JsonlLogger:
    """Append-only JSONL metric stream (one record per event)."""

    def __init__(self, path: str | None = None, *, echo: bool = True):
        self.path = path
        self.echo = echo
        self._t0 = time.time()

    def log(self, **record):
        record.setdefault("wall_time", round(time.time() - self._t0, 3))
        line = json.dumps(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line)
