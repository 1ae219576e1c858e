"""Inducing variables for signature-kernel sparse GPs, as nn.Modules.

The port of ``gpsig_tpu/inducing.py``:

* ``InducingTensors``: Z is packed ``(len_tensors, num_tensors, [2,] d)``
  with ``len_tensors = M(M+1)/2``; with ``increments`` each slot holds a
  pair whose kernel-feature difference is used.  Its covariances run K1-K4.
* ``InducingSequences``: short sequences ``(num_inducing, len_inducing,
  d)`` as inducing locations.  Its covariances are seq x seq Grams (K5/K6).
* ``learn_weights`` adds a per-level mixing matrix W applied to levels
  1..M while level 0 passes through.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import config as cfg


def _mix_gram(W, K_lvls):
    """K[0] + sum_m W_m K_lvls[m] W_m^T (both-sided mixing)."""
    return K_lvls[0] + torch.einsum("mij,mjk,mlk->il", W, K_lvls[1:], W)


def _mix_cross(W, K_lvls):
    """K[0] + sum_m W_m K_lvls[m] (left mixing)."""
    return K_lvls[0] + torch.einsum("mij,mjn->in", W, K_lvls[1:])


def _jittered(Kzz, Kzx, Kxx, jitter: float, full_f_cov: bool):
    """Kzz + jitter I, Kzx, and Kxx + jitter I (full) or + jitter (diag)."""
    def eye(n):
        return torch.eye(n, dtype=Kzz.dtype, device=Kzz.device)

    Kzz = Kzz + jitter * eye(Kzz.shape[-1])
    if full_f_cov:
        Kxx = Kxx + jitter * eye(Kxx.shape[-1])
    else:
        Kxx = Kxx + jitter
    return Kzz, Kzx, Kxx


class _SignatureInducing(nn.Module):
    """Z (and W with ``learn_weights``) as parameters, and the level
    mixing."""

    def __init__(self, Z, num_levels: int, learn_weights: bool, dtype,
                 device):
        super().__init__()
        self.num_levels = int(num_levels)
        self.learn_weights = bool(learn_weights)
        self._Z_init = Z
        for name, value in self.init_params(dtype, device).items():
            self.register_parameter(name, nn.Parameter(value))

    def init_params(self, dtype=None, device=None) -> dict:
        dtype = dtype or cfg.default_float()
        device = device or cfg.default_device()
        params = {"Z": torch.as_tensor(self._Z_init, dtype=dtype,
                                       device=device)}
        if self.learn_weights:
            eye = torch.eye(len(self), dtype=dtype, device=device)
            params["W"] = eye[None].repeat(self.num_levels, 1, 1)
        return params

    def _gram(self, K_lvls):
        return (_mix_gram(self.W, K_lvls) if self.learn_weights
                else torch.sum(K_lvls, dim=0))

    def _cross(self, K_lvls):
        return (_mix_cross(self.W, K_lvls) if self.learn_weights
                else torch.sum(K_lvls, dim=0))


class InducingTensors(_SignatureInducing):
    """Sparse inducing tensors (inter-domain features in the tensor algebra).

    Args:
      Z: ``(len_tensors, num_tensors, d)`` or, with ``increments``,
        ``(len_tensors, num_tensors, 2, d)``.
      dtype, device: where the parameters live; ``device`` defaults to
        ``config.default_device()``, the card.
    """

    def __init__(self, Z, num_levels: int, increments: bool = False,
                 learn_weights: bool = False, *, dtype=None, device=None):
        len_tensors = num_levels * (num_levels + 1) // 2
        Z = np.asarray(Z)
        if Z.shape[0] != len_tensors:
            raise ValueError(
                f"Z.shape[0]={Z.shape[0]} != num_levels(num_levels+1)/2="
                f"{len_tensors}"
            )
        if increments and (Z.ndim != 4 or Z.shape[2] != 2):
            raise ValueError(
                "with increments=True, Z must be (len_tensors, num_tensors, 2, d)"
            )
        self.len_tensors = len_tensors
        self.increments = bool(increments)
        super().__init__(Z, num_levels, learn_weights, dtype, device)

    def __len__(self):
        return self._Z_init.shape[1]

    def Kuu_Kuf_Kff(self, kern, X, *, jitter: float = 0.0,
                    full_f_cov: bool = False):
        """Kzz, Kzx and Kxx (diagonal, or full with ``full_f_cov``) in one
        kernel call."""
        Kzz_lvls, Kzx_lvls, Kxx_lvls = kern.K_tens_n_seq_covs(
            self.Z, X, full_X_cov=full_f_cov, increments=self.increments,
            return_levels=True,
        )
        return _jittered(self._gram(Kzz_lvls), self._cross(Kzx_lvls),
                         torch.sum(Kxx_lvls, dim=0), jitter, full_f_cov)


class InducingSequences(_SignatureInducing):
    """Inducing sequences (standard SVGP features over short sequences).

    Args:
      Z: ``(num_inducing, len_inducing, d)``.
      dtype, device: where the parameters live; ``device`` defaults to
        ``config.default_device()``, the card.
    """

    def __init__(self, Z, num_levels: int, learn_weights: bool = False, *,
                 dtype=None, device=None):
        Z = np.asarray(Z)
        if Z.ndim != 3:
            raise ValueError("Z must be (num_inducing, len_inducing, d)")
        self.len_inducing = Z.shape[1]
        super().__init__(Z, num_levels, learn_weights, dtype, device)

    def __len__(self):
        return self._Z_init.shape[0]

    def Kuu(self, kern, *, jitter: float = 0.0):
        Kzz = self._gram(kern.K(self.Z, return_levels=True))
        return Kzz + jitter * torch.eye(len(self), dtype=Kzz.dtype,
                                        device=Kzz.device)

    def Kuf(self, kern, X):
        return self._cross(kern.K(self.Z, X, return_levels=True))

    def Kuu_Kuf_Kff(self, kern, X, *, jitter: float = 0.0,
                    full_f_cov: bool = False):
        """Kzz, Kzx and Kxx (diagonal, or full with ``full_f_cov``) in one
        kernel call."""
        Kzz_lvls, Kzx_lvls, Kxx_lvls = kern.K_seq_n_seq_covs(
            self.Z, X, full_X2_cov=full_f_cov, return_levels=True)
        return _jittered(self._gram(Kzz_lvls), self._cross(Kzx_lvls),
                         torch.sum(Kxx_lvls, dim=0), jitter, full_f_cov)
