"""Mean functions of the SVGP predictive mean
(``gpsig_tpu/mean_functions.py``).

``SVGP.predict_f`` adds ``mean_function(X)`` (N, P) to the conditional
mean, as the reference does (``gpsig/models.py:67``).  Each mean function
is an nn.Module whose trainable leaves are its parameters, under the JAX
pytree's names (``mean/c``; ``mean/A``, ``mean/b``).  ``X`` arrives as
sequences (N, L, d) or flattened (N, L*d); ``Constant`` ignores it and
``Linear`` acts on the flattened representation, as stock GPflow does
with this model's 2-D inputs, so its ``input_dim`` is L*d.
"""

from __future__ import annotations

import torch
from torch import nn

from . import config as cfg


def _flat(X: torch.Tensor) -> torch.Tensor:
    return X.reshape(X.shape[0], -1) if X.ndim == 3 else X


class _MeanFunction(nn.Module):
    """Leaves from ``init_params`` as parameters, at ``dtype`` on
    ``device`` (``config.default_device()``, the card, unless given)."""

    def __init__(self, num_latent: int, dtype, device):
        super().__init__()
        self.num_latent = int(num_latent)
        for name, value in self.init_params(dtype, device).items():
            self.register_parameter(name, nn.Parameter(value))

    def init_params(self, dtype=None, device=None) -> dict:
        return {}


class Zero(_MeanFunction):
    """No mean (the reference benchmarks' default)."""

    def __init__(self, num_latent: int = 1):
        super().__init__(num_latent, None, None)

    def forward(self, X):
        return torch.zeros((X.shape[0], self.num_latent), dtype=X.dtype,
                           device=X.device)


class Constant(_MeanFunction):
    """A trainable constant c (P,), broadcast over the examples."""

    def __init__(self, num_latent: int = 1, value: float = 0.0, *,
                 dtype=None, device=None):
        self.value = float(value)
        super().__init__(num_latent, dtype, device)

    def init_params(self, dtype=None, device=None) -> dict:
        return {"c": torch.full((self.num_latent,), self.value,
                                dtype=dtype or cfg.default_float(),
                                device=device or cfg.default_device())}

    def forward(self, X):
        return self.c[None, :].expand(X.shape[0], -1)


class Linear(_MeanFunction):
    """A trainable affine map A^T x + b of the flattened input, A
    (input_dim, P) and b (P,), both zero at first."""

    def __init__(self, input_dim: int, num_latent: int = 1, *, dtype=None,
                 device=None):
        self.input_dim = int(input_dim)
        super().__init__(num_latent, dtype, device)

    def init_params(self, dtype=None, device=None) -> dict:
        at = dict(dtype=dtype or cfg.default_float(),
                  device=device or cfg.default_device())
        return {"A": torch.zeros((self.input_dim, self.num_latent), **at),
                "b": torch.zeros((self.num_latent,), **at)}

    def forward(self, X):
        return _flat(X) @ self.A + self.b[None, :]
