"""Inducing tensors for signature-kernel sparse GPs, as an nn.Module.

The port of ``gpsig_tpu/inducing.py::InducingTensors``: Z is packed
``(len_tensors, num_tensors, [2,] d)`` with ``len_tensors = M(M+1)/2``; with
``increments`` each slot holds a pair whose kernel-feature difference is
used.  ``learn_weights`` adds a per-level mixing matrix W applied to levels
1..M while level 0 passes through.  ``InducingSequences`` waits for the
seq x seq kernel (ROADMAP Queue 1, item 3).
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


class InducingTensors(nn.Module):
    """Sparse inducing tensors (inter-domain features in the tensor algebra).

    Args:
      Z: ``(len_tensors, num_tensors, d)`` or, with ``increments``,
        ``(len_tensors, num_tensors, 2, d)``.
    """

    def __init__(self, Z, num_levels: int, increments: bool = False,
                 learn_weights: bool = False, *, dtype=None, device=None):
        super().__init__()
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
        self.num_levels = int(num_levels)
        self.len_tensors = len_tensors
        self.increments = bool(increments)
        self.learn_weights = bool(learn_weights)
        self._Z_init = Z
        for name, value in self.init_params(dtype, device).items():
            self.register_parameter(name, nn.Parameter(value))

    def __len__(self):
        return self._Z_init.shape[1]

    def init_params(self, dtype=None, device=None) -> dict:
        dtype = dtype or cfg.default_float()
        params = {"Z": torch.as_tensor(self._Z_init, dtype=dtype,
                                       device=device)}
        if self.learn_weights:
            eye = torch.eye(len(self), dtype=dtype, device=device)
            params["W"] = eye[None].repeat(self.num_levels, 1, 1)
        return params

    def Kuu_Kuf_Kff(self, kern, X, *, jitter: float = 0.0,
                    full_f_cov: bool = False):
        """Kzz, Kzx and the Kxx diagonal in one kernel call."""
        Kzz_lvls, Kzx_lvls, Kxx_lvls = kern.K_tens_n_seq_covs(
            self.Z, X, full_X_cov=full_f_cov, increments=self.increments,
            return_levels=True,
        )
        if self.learn_weights:
            Kzz = _mix_gram(self.W, Kzz_lvls)
            Kzx = _mix_cross(self.W, Kzx_lvls)
        else:
            Kzz = torch.sum(Kzz_lvls, dim=0)
            Kzx = torch.sum(Kzx_lvls, dim=0)
        Kxx = torch.sum(Kxx_lvls, dim=0) + jitter
        Kzz = Kzz + jitter * torch.eye(len(self), dtype=Kzz.dtype,
                                       device=Kzz.device)
        return Kzz, Kzx, Kxx
