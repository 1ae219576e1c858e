"""MultiClass likelihood with the RobustMax inverse link
(``gpsig_tpu/likelihoods.py::MultiClass``), for prediction.

p(y=c|f) = 1-eps if c == argmax(f) else eps/(C-1); p(argmax f = c) is
evaluated by 1-D Gauss-Hermite quadrature over each candidate latent, with
100 points by default (the JAX package's documented divergence from
GPflow's 20).  ``variational_expectations`` and the Gaussian and Bernoulli
likelihoods come with the training slice (ROADMAP Queue 1, item 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def _gh_points(n: int, dtype, device):
    x, w = np.polynomial.hermite.hermgauss(n)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(w, dtype=dtype, device=device))


def _normal_cdf(x):
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))


class MultiClass(nn.Module):
    def __init__(self, num_classes: int, epsilon: float = 1e-3,
                 num_gh: int = 100):
        super().__init__()
        self.num_classes = int(num_classes)
        self.epsilon = float(epsilon)
        self.num_gh = int(num_gh)

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
