"""Sparse variational GP with signature covariances: the ELBO and prediction.

The port of ``gpsig_tpu/models/svgp.py``.  Parameters live on the
submodules under the JAX pytree's names::

    kern.{variances, sigma, lengthscales}   ind.{Z, [W]}
    q_mu (M, P)                             q_sqrt (P, M, M), or (M, P) if q_diag

``ind`` is an ``InducingTensors`` or an ``InducingSequences``.  ``loss``
(the negative ELBO) is what ``training.optimize`` minimizes; its gradients
reach Kzz and Kzx through the kernels' autograd Functions
(``ops/inducing_cuda.py``, ``ops/signature_cuda.py``).
``predict_f(full_cov=True)`` gives the (P, N, N) predictive covariance from
the full Kxx (K5).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import config as cfg
from ..linalg import base_conditional, gauss_kl


class SVGP(nn.Module):
    """Sparse variational GP, whitened by default.

    ``dtype`` defaults to the inducing tensors' and ``device`` to
    ``config.default_device()``, the card."""

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
        device = device or cfg.default_device()
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
        device = device or cfg.default_device()
        return {"kern": self.kern.init_params(dtype, device),
                "ind": self.ind.init_params(dtype, device),
                **self._init_q(dtype, device)}

    def _q_sqrt(self):
        return self.q_sqrt if self.q_diag else torch.tril(self.q_sqrt)

    def predict_f(self, X, *, full_cov: bool = False,
                  return_Kzz: bool = False):
        """q(f*) mean (N, P) and variance (N, P), or covariance (P, N, N)
        with ``full_cov``, at new sequences; and the jittered Kzz with
        ``return_Kzz``."""
        Kzz, Kzx, Kxx = self.ind.Kuu_Kuf_Kff(
            self.kern, X, jitter=cfg.jitter(), full_f_cov=full_cov)
        fmean, fvar = base_conditional(Kzx, Kzz, Kxx, self.q_mu,
                                       q_sqrt=self._q_sqrt(),
                                       white=self.whiten, full_cov=full_cov)
        if return_Kzz:
            return fmean, fvar, Kzz
        return fmean, fvar

    def elbo(self, X, Y):
        """Evidence lower bound on a (mini)batch.

        ``num_data`` (the total N) scales the expected-likelihood term for
        minibatching; it defaults to the batch size."""
        batch = X.shape[0]
        if self.whiten:
            fmean, fvar = self.predict_f(X)
            KL = gauss_kl(self.q_mu, self._q_sqrt())
        else:
            fmean, fvar, Kzz = self.predict_f(X, return_Kzz=True)
            KL = gauss_kl(self.q_mu, self._q_sqrt(), K=Kzz)
        var_exp = self.likelihood.variational_expectations(fmean, fvar, Y)
        num_data = self.num_data if self.num_data is not None else batch
        return torch.sum(var_exp) * (num_data / batch) - KL

    def loss(self, X, Y):
        return -self.elbo(X, Y)

    def predict_y(self, X):
        """Predictive mean and variance of observables."""
        fmean, fvar = self.predict_f(X)
        return self.likelihood.predict_mean_and_var(fmean, fvar)

    def predict_log_density(self, X, Y):
        """log p(Y*|X*) under the predictive (nlpp = -mean of this)."""
        fmean, fvar = self.predict_f(X)
        return self.likelihood.predict_log_density(fmean, fvar, Y)
