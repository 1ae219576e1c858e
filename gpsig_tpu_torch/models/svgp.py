"""Sparse variational GP with signature covariances, for prediction.

The port of ``gpsig_tpu/models/svgp.py``.  Parameters live on the
submodules under the JAX pytree's names::

    kern.{variances, sigma, lengthscales}   ind.{Z, [W]}
    q_mu (M, P)                             q_sqrt (P, M, M), or (M, P) if q_diag

The ELBO and its KL term come with the training slice (ROADMAP Queue 1,
item 1); full predictive covariances need the seq x seq kernel (item 3).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import config as cfg
from ..linalg import base_conditional


class SVGP(nn.Module):
    """Sparse variational GP, whitened by default.

    ``dtype`` / ``device`` default to those of the inducing tensors."""

    def __init__(self, kern, ind, likelihood, *, num_latent: int,
                 num_data: int | None = None, whiten: bool = True,
                 q_diag: bool = False, mean_function=None, dtype=None,
                 device=None):
        super().__init__()
        if mean_function is not None:
            raise NotImplementedError(
                "mean functions are not ported yet: ROADMAP Queue 1, item 6")
        self.kern = kern
        self.ind = ind
        self.likelihood = likelihood
        self.num_latent = int(num_latent)
        self.num_data = num_data
        self.whiten = bool(whiten)
        self.q_diag = bool(q_diag)
        dtype = dtype or ind.Z.dtype
        device = device or ind.Z.device
        for name, value in self._init_q(dtype, device).items():
            self.register_parameter(name, nn.Parameter(value))

    def _init_q(self, dtype, device) -> dict:
        M, P = len(self.ind), self.num_latent
        q = {"q_mu": torch.zeros((M, P), dtype=dtype, device=device)}
        if self.q_diag:
            q["q_sqrt"] = torch.ones((M, P), dtype=dtype, device=device)
        else:
            eye = torch.eye(M, dtype=dtype, device=device)
            q["q_sqrt"] = eye[None].repeat(P, 1, 1)
        return q

    def init_params(self, dtype=None, device=None) -> dict:
        """Fresh raw parameters in the JAX pytree layout."""
        dtype = dtype or cfg.default_float()
        return {"kern": self.kern.init_params(dtype, device),
                "ind": self.ind.init_params(dtype, device),
                **self._init_q(dtype, device)}

    def _q_sqrt(self):
        return self.q_sqrt if self.q_diag else torch.tril(self.q_sqrt)

    def predict_f(self, X, *, full_cov: bool = False):
        """q(f*) mean and variance at new sequences, (N, P) each."""
        if full_cov:
            raise NotImplementedError(
                "full_cov=True needs the seq x seq kernel (K5): ROADMAP "
                "Queue 1, item 3")
        Kzz, Kzx, Kxx = self.ind.Kuu_Kuf_Kff(
            self.kern, X, jitter=cfg.jitter(), full_f_cov=False)
        return base_conditional(Kzx, Kzz, Kxx, self.q_mu,
                                q_sqrt=self._q_sqrt(), white=self.whiten)

    def predict_y(self, X):
        """Predictive mean and variance of observables."""
        fmean, fvar = self.predict_f(X)
        return self.likelihood.predict_mean_and_var(fmean, fvar)
