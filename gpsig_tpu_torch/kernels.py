"""SignatureKernel: signature covariances over sequences, as an nn.Module.

The port of ``gpsig_tpu/kernels.py``.  The module holds the same raw
(unconstrained) leaves as the JAX pytree, under the same names
(``variances``, ``sigma``, ``lengthscales``), with the same bijectors, so
raw values carry over unchanged (``convert.load_jax_params``).

Dispatch follows the JAX ``fused`` / ``fast_math`` contract
(``gpsig_tpu/kernels.py:366-425``) with "TPU backend" read as "CUDA tensor,
float32":

* ``'off'`` runs the reference-shaped torch graphs (``ops/signature.py``);
* ``'auto'`` and ``'on'`` send Kzz and Kzx of inducing tensors through the
  kernel wrappers of ``ops/inducing_cuda.py`` and the seq x seq Grams (with
  ``difference``) through ``ops/signature_cuda.py``: on a CPU tensor a
  wrapper runs its plain version, on a CUDA tensor it launches the kernel,
  or raises for float64;
* ``'on'`` on a CPU tensor raises.
* ``fast_math`` is accepted; every value means full f32 on the card.

No fallback is silent: the kernels tile through any feature width, and the
seq x seq kernels take up to ``signature_cuda.MAX_STEPS`` steps on their
inner axis and raise past it.  Without ``difference`` the seq x seq Gram
takes the reference graph, as the JAX package does.  The Kxx-diagonal leg
keeps JAX's ``_closed_form_fns`` dispatch: cancellation-free closed forms
at f32, the naive graph at f64 or under ``'off'``.

Outside the port so far -- ``order > 1``, lags, low-rank features,
``K_blocked`` and the public ``K_tens`` / ``K_tens_vs_seq`` -- the module
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import config as cfg
from . import params as pm
from .ops import base_kernels, gram
from .ops import inducing_cuda as ic
from .ops import signature as sig_ops
from .ops import signature_cuda as sc


def _as_sequences(X: torch.Tensor, num_features: int) -> torch.Tensor:
    """Accept (N, L, d) or flattened (N, L*d) and return (N, L, d)."""
    if X.ndim == 2:
        if X.shape[-1] % num_features != 0:
            raise ValueError(
                f"flattened input width {X.shape[-1]} is not a multiple of "
                f"num_features={num_features}"
            )
        X = X.reshape(X.shape[0], -1, num_features)
    elif X.ndim != 3:
        raise ValueError(f"sequences must be rank 2 or 3, got rank {X.ndim}")
    return X


class SignatureKernel(nn.Module):
    """Truncated signature covariance over sequences.

    Args mirror ``gpsig_tpu.kernels.SignatureKernel``; ``dtype`` and
    ``device`` place the parameters (``device`` defaults to
    ``config.default_device()``, the card).  ``fused`` selects the covariance path
    ('auto' | 'on' | 'off', see the module docstring); ``fast_math`` is
    accepted for the JAX signature and means full f32 at every value.
    """

    def __init__(self, num_features: int, num_levels: int, *, order: int = 1,
                 normalization: bool = True, difference: bool = True,
                 variances=1.0, lengthscales=1.0, num_lags: int | None = None,
                 low_rank: bool = False, base: str = "rbf",
                 fused: str = "auto", fast_math="high", dtype=None,
                 device=None):
        super().__init__()
        self.num_features = int(num_features)
        self.num_levels = int(num_levels)
        self.order = (self.num_levels
                      if (order <= 0 or order >= self.num_levels)
                      else int(order))
        if self.order != 1:
            raise NotImplementedError(
                "order > 1 is not ported yet: ROADMAP Queue 1, item 6")
        if num_lags:
            raise NotImplementedError(
                "lags are not ported yet: ROADMAP Queue 1, item 5")
        if low_rank:
            raise NotImplementedError(
                "low-rank features are not ported yet: ROADMAP Queue 1, "
                "item 5")
        self.normalization = bool(normalization)
        self.difference = bool(difference)
        self.base = base
        if fused not in ("auto", "on", "off"):
            raise ValueError(f"fused must be 'auto'|'on'|'off', got {fused!r}")
        self.fused = fused
        self.fast_math = fast_math

        self._init_variances = np.broadcast_to(
            np.asarray(variances, dtype=np.float64), (self.num_levels + 1,)
        ).copy()
        self._init_lengthscales = (
            None if lengthscales is None else np.broadcast_to(
                np.asarray(lengthscales, dtype=np.float64),
                (self.num_features,)).copy()
        )
        self.bijectors: dict[str, str] = {"variances": "positive",
                                          "sigma": "positive"}
        if self._init_lengthscales is not None:
            self.bijectors["lengthscales"] = "positive"
        _, base_bij = base_kernels.init_params(self.base)
        self.bijectors.update(base_bij)
        for name, raw in self.init_params(dtype, device).items():
            self.register_parameter(name, nn.Parameter(raw))

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    def init_params(self, dtype=None, device=None) -> dict:
        """Fresh raw (unconstrained) parameters, as the JAX pytree holds
        them."""
        dtype = dtype or cfg.default_float()
        device = device or cfg.default_device()
        raw = {
            "variances": pm.raw_init(self._init_variances, "positive", dtype,
                                     device),
            "sigma": pm.raw_init(1.0, "positive", dtype, device),
        }
        if self._init_lengthscales is not None:
            raw["lengthscales"] = pm.raw_init(self._init_lengthscales,
                                              "positive", dtype, device)
        base_raw, _ = base_kernels.init_params(self.base, dtype=dtype,
                                               device=device)
        raw.update(base_raw)
        return raw

    def constrain(self) -> dict:
        cp = {name: pm.constrain(p, self.bijectors.get(name, "identity"))
              for name, p in self.named_parameters()}
        cp.update(base_kernels.static_params(self.base))
        return cp

    def _base_kern(self, cp: dict):
        fn = base_kernels.get(self.base)
        return lambda A, B=None: fn(cp, A, B)

    # ------------------------------------------------------------------
    # scaling
    # ------------------------------------------------------------------

    def _scale_sequences(self, cp: dict, X):
        if "lengthscales" in cp:
            X = X / cp["lengthscales"].to(X.dtype)
        return X

    def _scale_tensors(self, cp: dict, Z):
        if "lengthscales" in cp:
            Z = Z / cp["lengthscales"].to(Z.dtype)
        return Z

    # ------------------------------------------------------------------
    # unnormalized level computations
    # ------------------------------------------------------------------

    def _closed_form_fns(self, dtype):
        """(inc_cross, inc_diag) closed forms in the f32 regime, unless
        ``fused='off'`` pins the reference-shaped graphs."""
        if self.fused == "off" or dtype != torch.float32:
            return None, None
        return gram.increment_gram_fns(self.base)

    def _kernel_route(self, t: torch.Tensor) -> bool:
        """Whether the covariances go through the kernel wrappers."""
        if self.fused == "off":
            return False
        if self.fused == "on" and t.device.type != "cuda":
            raise ValueError(
                "fused='on' launches the CUDA kernels and needs CUDA "
                f"float32 tensors, got a {t.device.type} tensor; use "
                "fused='auto' to run their plain versions on the CPU"
            )
        return True

    def _K_seq(self, cp: dict, X, X2=None):
        """(M+1, N1, N2) unnormalized per-level kernels; exactly symmetric
        when X2 is None.  With ``difference`` and the kernel route, K5/K6
        (``signature_cuda``); else the reference graph on the full base
        Gram (``gpsig_tpu/kernels.py:306-318``)."""
        if self.difference and self._kernel_route(X):
            return sc.fused_first_order_levels(
                X, X2, num_levels=self.num_levels, base=self.base,
                difference=True)
        kern = self._base_kern(cp)
        N1, L1, d = X.shape
        if X2 is None:
            M = kern(X.reshape(N1 * L1, d)).reshape(N1, L1, N1, L1)
        else:
            N2, L2, _ = X2.shape
            M = kern(X.reshape(N1 * L1, d),
                     X2.reshape(N2 * L2, d)).reshape(N1, L1, N2, L2)
        return sig_ops.signature_kern_first_order(
            M, self.num_levels, difference=self.difference)

    def _K_seq_diag(self, cp: dict, X):
        """(M+1, N) unnormalized per-level diagonals."""
        if self.difference:
            _, inc_diag = self._closed_form_fns(X.dtype)
            if inc_diag is not None:
                G = inc_diag(X)  # (N, L-1, L-1), pre-differenced
                lvls = gram.first_order_levels_batched(
                    G, self.num_levels, difference=False)
                lvls[1] = gram.level1_exact_diag(inc_diag, X)
                return lvls
        M = self._base_kern(cp)(X)  # (N, L, L)
        return sig_ops.signature_kern_first_order(
            M, self.num_levels, difference=self.difference)

    def _K_tens(self, cp: dict, Z, increments: bool):
        if self._kernel_route(Z):
            return ic.fused_tensor_levels(
                Z, num_levels=self.num_levels, base=self.base,
                increments=increments)
        kern = self._base_kern(cp)
        lt, n_Z, d = Z.shape[0], Z.shape[1], Z.shape[-1]
        if increments:
            M = kern(Z.reshape(lt, 2 * n_Z, d)).reshape(lt, n_Z, 2, n_Z, 2)
            M = (M[:, :, 1, :, 1] + M[:, :, 0, :, 0]
                 - M[:, :, 1, :, 0] - M[:, :, 0, :, 1])
        else:
            M = kern(Z)
        return sig_ops.tensor_kern(M, self.num_levels)

    def _K_tens_vs_seq(self, cp: dict, Z, X, increments: bool):
        if self._kernel_route(Z):
            return ic.fused_tens_vs_seq_levels(
                Z, X, num_levels=self.num_levels, base=self.base,
                increments=increments, difference=self.difference,
                fast_math=self.fast_math)
        kern = self._base_kern(cp)
        lt, n_Z, d = Z.shape[0], Z.shape[1], Z.shape[-1]
        N, L, _ = X.shape
        X_flat = X.reshape(N * L, d)
        if increments:
            M = kern(Z.reshape(lt * n_Z * 2, d), X_flat).reshape(
                lt, n_Z, 2, N, L)
            M = M[:, :, 1] - M[:, :, 0]
        else:
            M = kern(Z.reshape(lt * n_Z, d), X_flat).reshape(lt, n_Z, N, L)
        return sig_ops.signature_kern_tens_vs_seq_first_order(
            M, self.num_levels, difference=self.difference)

    def _level_scale(self, cp: dict, K_lvls):
        w = (cp["sigma"] * cp["variances"]).to(K_lvls.dtype)
        return K_lvls * w.reshape((-1,) + (1,) * (K_lvls.ndim - 1))

    # ------------------------------------------------------------------
    # public covariance API
    # ------------------------------------------------------------------

    def _normalize_sym(self, K_lvls):
        """A symmetric level stack over its own jittered diagonal; returns
        (normalized, sqrt of the jittered diagonal)."""
        n = K_lvls.shape[-1]
        K_lvls = K_lvls + cfg.jitter() * torch.eye(
            n, dtype=K_lvls.dtype, device=K_lvls.device)
        d = torch.sqrt(torch.diagonal(K_lvls, dim1=-2, dim2=-1))
        return K_lvls / (d[:, :, None] * d[:, None, :]), d

    def _diag_sqrt(self, cp: dict, X):
        """sqrt of the jittered diagonal a cross Gram is normalized by."""
        return torch.sqrt(self._K_seq_diag(cp, X) + cfg.jitter())

    def _data_cov(self, cp: dict, X, full: bool):
        """The data side's level stack -- the full Gram, or its diagonal --
        normalized and level-scaled, and the sqrt-diagonal the cross Gram
        is divided by (None without normalization)."""
        if full:
            K_lvls, d = self._K_seq(cp, X), None
            if self.normalization:
                K_lvls, d = self._normalize_sym(K_lvls)
            return self._level_scale(cp, K_lvls), d
        if not self.normalization:
            return self._level_scale(cp, self._K_seq_diag(cp, X)), None
        sig_var = (cp["sigma"] * cp["variances"]).to(X.dtype)
        return sig_var[:, None].expand(-1, X.shape[0]), self._diag_sqrt(cp, X)

    def _finalize(self, K_lvls, return_levels: bool):
        return K_lvls if return_levels else torch.sum(K_lvls, dim=0)

    def K(self, X, X2=None, *, return_levels: bool = False):
        """Signature kernel matrix between sequences (N1, N2), or its
        (M+1, N1, N2) levels.  A symmetric Gram is normalized by its own
        jittered diagonal, a cross Gram by the two diagonals
        (``_K_seq_diag``)."""
        cp = self.constrain()
        X = self._scale_sequences(cp, _as_sequences(X, self.num_features))
        if X2 is None:
            K_lvls = self._K_seq(cp, X)
            if self.normalization:
                K_lvls, _ = self._normalize_sym(K_lvls)
        else:
            X2 = self._scale_sequences(
                cp, _as_sequences(X2, self.num_features))
            K_lvls = self._K_seq(cp, X, X2)
            if self.normalization:
                d1, d2 = self._diag_sqrt(cp, X), self._diag_sqrt(cp, X2)
                K_lvls = K_lvls / (d1[:, :, None] * d2[:, None, :])
        return self._finalize(self._level_scale(cp, K_lvls), return_levels)

    def Kdiag(self, X, *, return_levels: bool = False):
        """Diagonal of ``K(X)``: exactly sigma * variances per level when
        normalized."""
        cp = self.constrain()
        X = _as_sequences(X, self.num_features)
        if self.normalization:
            sig_var = cp["sigma"] * cp["variances"]
            lvls = sig_var[:, None].expand(-1, X.shape[0])
            return self._finalize(lvls.to(X.dtype), return_levels)
        K_lvls = self._K_seq_diag(cp, self._scale_sequences(cp, X))
        return self._finalize(self._level_scale(cp, K_lvls), return_levels)

    def K_blocked(self, *args, **kwargs):
        raise NotImplementedError(
            "K_blocked is not ported yet: ROADMAP Queue 1, item 6")

    def K_tens_n_seq_covs(self, Z, X, *, full_X_cov: bool = False,
                          increments: bool = False,
                          return_levels: bool = False):
        """Kzz, Kzx and Kxx (its diagonal, or the full Gram with
        ``full_X_cov``) in one call, sharing the scaled inputs and the Kxx
        normalization between Kzx and Kxx."""
        cp = self.constrain()
        Z = self._scale_tensors(cp, Z)
        X_scaled = self._scale_sequences(
            cp, _as_sequences(X, self.num_features))
        Kzz_lvls = self._K_tens(cp, Z, increments)
        Kzx_lvls = self._K_tens_vs_seq(cp, Z, X_scaled, increments)
        Kxx_lvls, d = self._data_cov(cp, X_scaled, full_X_cov)
        if d is not None:
            Kzx_lvls = Kzx_lvls / d[:, None, :]
        out = (self._level_scale(cp, Kzz_lvls),
               self._level_scale(cp, Kzx_lvls), Kxx_lvls)
        if return_levels:
            return out
        return tuple(torch.sum(o, dim=0) for o in out)

    def K_seq_n_seq_covs(self, X, X2, *, full_X2_cov: bool = False,
                         return_levels: bool = False):
        """Kxx, Kxx2 and Kx2x2 (its diagonal, or the full Gram with
        ``full_X2_cov``) for inducing sequences X against data X2: the
        symmetric Grams normalized by their own jittered diagonals, the
        cross Gram by both (``gpsig_tpu/kernels.py:947-1017``)."""
        cp = self.constrain()
        Xs = self._scale_sequences(cp, _as_sequences(X, self.num_features))
        X2s = self._scale_sequences(cp, _as_sequences(X2, self.num_features))
        Kxx_lvls = self._K_seq(cp, Xs)
        Kxx2_lvls = self._K_seq(cp, Xs, X2s)
        if self.normalization:
            Kxx_lvls, d1 = self._normalize_sym(Kxx_lvls)
            Kxx2_lvls = Kxx2_lvls / d1[:, :, None]
        Kx2_lvls, d2 = self._data_cov(cp, X2s, full_X2_cov)
        if d2 is not None:
            Kxx2_lvls = Kxx2_lvls / d2[:, None, :]
        out = (self._level_scale(cp, Kxx_lvls),
               self._level_scale(cp, Kxx2_lvls), Kx2_lvls)
        if return_levels:
            return out
        return tuple(torch.sum(o, dim=0) for o in out)


def _variant(name: str, base: str):
    def ctor(num_features, num_levels, **kwargs):
        return SignatureKernel(num_features, num_levels, base=base, **kwargs)

    ctor.__name__ = name
    ctor.__qualname__ = name
    ctor.__doc__ = f"SignatureKernel with the {base!r} state-space embedding."
    return ctor


SignatureLinear = _variant("SignatureLinear", "linear")
SignatureRBF = _variant("SignatureRBF", "rbf")
SignatureGauss = SignatureRBF
