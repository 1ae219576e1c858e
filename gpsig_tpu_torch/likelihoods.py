"""Likelihoods (``gpsig_tpu/likelihoods.py``), for prediction and training:
the reference recipe takes ``Bernoulli`` for two classes and
``MultiClass`` otherwise (``train_gpsig.py:90-95``); ``Gaussian`` is for
regression.

* ``Gaussian``: noise variance fixed, or trainable (``trainable=True``):
  then the raw variance is the leaf ``lik/variance`` under the positive
  transform, as in the JAX pytree.  Its expectations and predictions are
  in closed form.  ``Y`` is ``(N, P)``.
* ``Bernoulli``: the probit inverse link clipped away from {0, 1} by 1e-3
  (GPflow's), one latent; ``variational_expectations`` by 20-point
  Gauss-Hermite quadrature, predictions in closed form.  Labels ``Y`` are
  ``(N, 1)`` in {0, 1}.
* ``MultiClass``: RobustMax, p(y=c|f) = 1-eps if c == argmax(f) else
  eps/(C-1); p(argmax f = c) by 1-D Gauss-Hermite quadrature over the
  candidate latent, with 100 points by default (the JAX package's
  documented divergence from GPflow's 20).  Labels ``Y`` are ``(N, 1)``
  class indices.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import config as cfg
from . import params as pm


def _gh_points(n: int, dtype, device):
    x, w = np.polynomial.hermite.hermgauss(n)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(w, dtype=dtype, device=device))


def _normal_cdf(x):
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))


class Gaussian(nn.Module):
    """Gaussian likelihood, its noise variance fixed or trainable.

    With ``trainable=True`` the module holds the raw variance as its
    parameter ``variance`` (at ``dtype`` on ``device``, the card unless
    given), the model's leaf ``lik/variance``."""

    def __init__(self, variance=1.0, num_latent: int = 1,
                 trainable: bool = False, *, dtype=None, device=None):
        super().__init__()
        # a float, or a tensor for a bound likelihood (``bind``)
        self.init_variance = (variance if isinstance(variance, torch.Tensor)
                              else float(variance))
        self.num_latent = int(num_latent)
        self.trainable = bool(trainable)
        for name, value in self.init_params(dtype, device).items():
            self.register_parameter(name, nn.Parameter(value))

    def init_params(self, dtype=None, device=None) -> dict:
        """Fresh raw leaves: {} when the variance is fixed."""
        if not self.trainable:
            return {}
        return {"variance": pm.raw_init(
            self.init_variance, "positive", dtype or cfg.default_float(),
            device or cfg.default_device())}

    def variance_of(self, params: dict | None = None):
        """The noise variance: of the raw leaves ``params`` if given, else
        of this module's own leaf (trainable) or the fixed value."""
        if not self.trainable:
            return self.init_variance
        return pm.positive((params or {"variance": self.variance})[
            "variance"])

    def bind(self, params: dict) -> "Gaussian":
        """A fixed-variance likelihood at the variance of the raw leaves
        ``params`` (gradients flow to them)."""
        if not self.trainable or not params:
            return self
        return Gaussian(self.variance_of(params), self.num_latent)

    def variational_expectations(self, Fmu, Fvar, Y):
        """(N, P) E_q[log N(y | f, variance)]."""
        v = self.variance_of()
        return (-0.5 * torch.log(2.0 * math.pi * torch.as_tensor(
            v, dtype=Fmu.dtype, device=Fmu.device))
            - 0.5 * (torch.square(Y - Fmu) + Fvar) / v)

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance_of()

    def predict_log_density(self, Fmu, Fvar, Y):
        """(N,) log p(y*|x*) under the predictive."""
        v = Fvar + self.variance_of()
        return torch.sum(-0.5 * torch.log(2.0 * math.pi * v)
                         - 0.5 * torch.square(Y - Fmu) / v, dim=-1)


class Bernoulli(nn.Module):
    """Bernoulli likelihood with the probit inverse link."""

    def __init__(self, num_gh: int = 20):
        super().__init__()
        self.num_gh = int(num_gh)
        self.num_latent = 1

    @staticmethod
    def _invlink(F):
        return _normal_cdf(F) * (1.0 - 2e-3) + 1e-3

    @staticmethod
    def _log_bernoulli(p, Y):
        return torch.where(Y > 0.5, torch.log(p), torch.log1p(-p))

    def variational_expectations(self, Fmu, Fvar, Y):
        """(N, 1) E_q[log p(y|f)], f = mu + sqrt(2 var) x at the GH points."""
        x, w = _gh_points(self.num_gh, Fmu.dtype, Fmu.device)
        F = Fmu[..., None] + torch.sqrt(2.0 * Fvar[..., None]) * x
        lp = self._log_bernoulli(self._invlink(F), Y[..., None])
        return torch.sum(lp * w, dim=-1) / math.sqrt(math.pi)

    def predict_mean_and_var(self, Fmu, Fvar):
        p = self._invlink(Fmu / torch.sqrt(1.0 + Fvar))
        return p, p - torch.square(p)

    def predict_log_density(self, Fmu, Fvar, Y):
        """(N,) log p(y*|x*) under the predictive."""
        p, _ = self.predict_mean_and_var(Fmu, Fvar)
        return torch.sum(self._log_bernoulli(p, Y), dim=-1)


class MultiClass(nn.Module):
    def __init__(self, num_classes: int, epsilon: float = 1e-3,
                 num_gh: int = 100):
        super().__init__()
        self.num_classes = int(num_classes)
        self.epsilon = float(epsilon)
        self.num_gh = int(num_gh)

    def _prob_is_largest(self, Y, Fmu, Fvar):
        """(N,) p(argmax f = y) for each row's own label."""
        gh_x, gh_w = _gh_points(self.num_gh, Fmu.dtype, Fmu.device)
        oh = torch.nn.functional.one_hot(
            Y[:, 0].long(), self.num_classes).to(Fmu.dtype)  # (N, C)
        mu_sel = torch.sum(oh * Fmu, dim=1)
        var_sel = torch.sum(oh * Fvar, dim=1)
        X = mu_sel[:, None] + gh_x[None, :] * torch.sqrt(
            torch.clamp(2.0 * var_sel, min=1e-10))[:, None]  # (N, G)
        dist = (X[:, :, None] - Fmu[:, None, :]) / torch.sqrt(
            torch.clamp(Fvar[:, None, :], min=1e-10))  # (N, G, C)
        cdfs = _normal_cdf(dist) * (1.0 - 2e-4) + 1e-4
        # the selected latent contributes a factor of 1
        cdfs = cdfs * (1.0 - oh)[:, None, :] + oh[:, None, :]
        probs = torch.prod(cdfs, dim=2)  # (N, G)
        return probs @ (gh_w / math.sqrt(math.pi))

    def variational_expectations(self, Fmu, Fvar, Y):
        """(N, 1) E_q[log p(y|f)] under the RobustMax link."""
        p = self._prob_is_largest(Y, Fmu, Fvar)
        eps = self.epsilon
        ve = p * math.log(1.0 - eps) + (1.0 - p) * math.log(
            eps / (self.num_classes - 1))
        return ve[:, None]

    def predict_log_density(self, Fmu, Fvar, Y):
        """(N,) log p(y*|x*) under the predictive."""
        p = self._prob_is_largest(Y, Fmu, Fvar)
        return torch.log(p * (1.0 - self.epsilon) + (1.0 - p) * (
            self.epsilon / (self.num_classes - 1)))

    def _prob_is_largest_all(self, Fmu, Fvar):
        """(N, C) p(argmax f = c) for every class in one (N, C, G, C)
        product-reduce."""
        gh_x, gh_w = _gh_points(self.num_gh, Fmu.dtype, Fmu.device)
        C = self.num_classes
        X = Fmu[:, :, None] + gh_x[None, None, :] * torch.sqrt(
            torch.clamp(2.0 * Fvar, min=1e-10))[:, :, None]  # (N, C, G)
        dist = (X[:, :, :, None] - Fmu[:, None, None, :]) / torch.sqrt(
            torch.clamp(Fvar[:, None, None, :], min=1e-10)
        )  # (N, C_sel, G, C_other)
        cdfs = _normal_cdf(dist) * (1.0 - 2e-4) + 1e-4
        eye = torch.eye(C, dtype=Fmu.dtype, device=Fmu.device)
        cdfs = cdfs * (1.0 - eye)[None, :, None, :] + eye[None, :, None, :]
        probs = torch.prod(cdfs, dim=3)  # (N, C, G)
        return probs @ (gh_w / math.sqrt(math.pi))

    def predict_mean_and_var(self, Fmu, Fvar):
        C = self.num_classes
        ps = self._prob_is_largest_all(Fmu, Fvar)
        mean = ps * (1.0 - self.epsilon) + (1.0 - ps) * (
            self.epsilon / (C - 1))
        return mean, mean - torch.square(mean)
