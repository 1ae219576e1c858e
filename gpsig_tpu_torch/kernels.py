"""SignatureKernel: signature covariances over sequences, as an nn.Module.

The port of ``gpsig_tpu/kernels.py``.  The module holds the same raw
(unconstrained) leaves as the JAX pytree, under the same names
(``variances``, ``sigma``, ``lengthscales``), with the same bijectors, so
raw values carry over unchanged (``convert.load_jax_params``).

Dispatch follows the JAX ``fused`` / ``fast_math`` contract
(``gpsig_tpu/kernels.py:366-425``) with "TPU backend" read as "CUDA tensor,
float32", and is decided by capability, as JAX's ``_fused_supported``:
the hand kernels exist for the bases in ``inducing_cuda.SUPPORTED_BASES``
(rbf, linear, matern12), as JAX's Pallas kernels do
(``gpsig_tpu/ops/signature_pallas.py:73``).

* ``'off'`` runs the reference-shaped torch graphs (``ops/signature.py``);
* ``'auto'`` and ``'on'`` send, for those bases, Kzz and Kzx of inducing
  tensors through the kernel wrappers of ``ops/inducing_cuda.py`` and the
  seq x seq Grams (with ``difference``) through ``ops/signature_cuda.py``:
  on a CPU tensor a wrapper runs its plain version, on a CUDA tensor it
  launches the kernel, or raises for float64;
* ``'auto'`` runs the other eight bases (cosine, poly, mix, matern32/52,
  spectral rbf/exp/mixed) as torch ops and launches no kernel of the port.
  That is no hidden fallback: JAX has no kernel for them either and runs
  them through XLA, by the same route -- at f32 the cancellation-free
  closed-form increment Grams (``gram.increment_gram_fns``; the seq x seq
  Grams blocked over example tiles, ``gram.blocked_first_order_levels``;
  spectral Kzz on the naive graph, ``gram.tens_closed_form_ok``), at f64
  the reference graphs;
* ``'on'`` raises for those eight bases, and on a CPU tensor.
* ``fast_math`` is accepted; every value means full f32 on the card.

No fallback is silent: the kernels take any sequence lengths, any feature
width and any number of levels (K3 past 16 levels on a slower serial
path).  With ``num_lags`` the sequences are lag-augmented
(``ops/lags.py``) and each of the ``num_lags + 1`` channel groups is
divided by the lengthscales and weighted by ``gamma``; the kernels take the
``(num_lags + 1) * d`` features unchanged.  Kzz of inducing tensors runs
K1 and K2 in symmetric mode: each unordered pair once, mirrored, so it is
exactly symmetric.  Without ``difference`` the seq x seq Gram takes the
reference graph, as the JAX package does.  The Kxx-diagonal leg keeps
JAX's ``_closed_form_fns`` dispatch: cancellation-free closed forms at
f32, the naive graph at f64 or under ``'off'``.

``order > 1`` (the reference's discretization; at ``order >= num_levels``
the full grid) runs the seq x seq Grams through K5/K6 at that order and
the Kxx diagonal through ``gram.higher_order_levels_batched``.  Kzx of
inducing tensors has no kernel past order 1, in JAX as here: ``'on'``
raises, otherwise it takes the closed-form slot Grams and
``gram.tens_vs_seq_levels_mxu`` at f32, the reference graph else
(``gpsig_tpu/kernels.py:468-538``).  Kzz of inducing tensors does not
depend on the order and keeps K1/K2.

``K_blocked`` evaluates the seq x seq Gram over example tiles
(``method='xla'``: the blocked torch path with the closed forms), or
through K5 (``method='pallas'``, for the kernels' bases).

``low_rank=True`` replaces every covariance by inner products of low-rank
feature maps (``ops/low_rank.py``, ``gpsig_tpu/kernels.py:540-591``):
Nystrom features of the base kernel on ``num_components`` landmarks, and
randomized Hadamard products of at most ``rank_bound`` features a level
(``sparsity``).  It launches no kernel: JAX runs it through XLA, with no
Pallas kernel either.  Every draw of one call -- the landmarks (from the
union of both sides' points), the Nystrom jitter, each depth's projection
-- is made once and serves both sides, so a cross Gram is an inner product
of one feature map.  ``generator`` (a ``torch.Generator``, or a
``low_rank.LowRankDraws`` holding the draws) makes them; None draws from a
generator seeded with 0 on the inputs' device, created per call, as JAX's
``PRNGKey(0)``.  ``K_blocked`` refuses a low-rank kernel, as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import config as cfg
from . import params as pm
from .ops import base_kernels, gram, lags
from .ops import inducing_cuda as ic
from .ops import low_rank as low_rank_ops
from .ops import signature as sig_ops
from .ops import signature_cuda as sc


def _auto_gram_block(N: int, L1: int, L2: int,
                     budget_bytes: int = 128 * 2**20) -> int:
    """Example-block size of the blocked seq x seq path: the largest block
    whose (B, B, L1-1, L2-1) f32 increment tile fits the budget, floored at
    8.  JAX's rule (``gpsig_tpu/kernels.py:60``) also caps it at 64 and
    counts the longer length twice, an XLA choice; here each tile is a
    Python-looped batch of torch launches, so the port takes as few tiles
    as the budget allows (the inducing-sequences model's 500 x 500 Kzz is
    one tile, not 64).  The tiles' entries do not depend on the block."""
    per_pair = 4 * max(L1 - 1, 1) * max(L2 - 1, 1)
    bs = int(np.sqrt(max(budget_bytes // per_pair, 1)))
    return max(8, min(int(N), bs))


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
    ``config.default_device()``, the card).  ``base`` names one of the 11
    bases of ``ops/base_kernels.BASE_KERNELS``, ``base_options`` its static
    options (``poly_gamma`` / ``poly_degree``, the spectral ``Q``), and
    ``generator`` (a CPU ``torch.Generator``) draws the spectral mixture's
    initial values.  ``fused`` selects the covariance path ('auto' | 'on' |
    'off', see the module docstring); ``fast_math`` is accepted for the JAX
    signature and means full f32 at every value.
    """

    def __init__(self, num_features: int, num_levels: int, *, order: int = 1,
                 normalization: bool = True, difference: bool = True,
                 variances=1.0, lengthscales=1.0, num_lags: int | None = None,
                 low_rank: bool = False, num_components: int = 50,
                 rank_bound: int | None = None, sparsity: str = "sqrt",
                 base: str = "rbf",
                 base_options: dict | None = None, fused: str = "auto",
                 fast_math="high", dtype=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_features = int(num_features)
        self.num_levels = int(num_levels)
        self.order = (self.num_levels
                      if (order <= 0 or order >= self.num_levels)
                      else int(order))
        if num_lags is None:
            self.num_lags = 0
        elif isinstance(num_lags, (int, np.integer)) and num_lags >= 0:
            self.num_lags = int(num_lags)
        else:
            raise ValueError("num_lags must be a nonnegative integer or None")
        if low_rank:
            if self.order != 1:
                raise NotImplementedError(
                    "low-rank mode requires order == 1 "
                    "(matches reference `kernels.py:59-60`)")
            if sparsity not in low_rank_ops.SPARSITIES:
                raise ValueError(f"unknown sparsity {sparsity!r}")
            if num_components is None or num_components <= 0:
                raise ValueError("num_components must be a positive integer")
            if rank_bound is not None and rank_bound <= 0:
                raise ValueError("rank_bound must be None or positive")
        self.low_rank = bool(low_rank)
        self.num_components = int(num_components)
        self.rank_bound = (int(rank_bound) if rank_bound
                           else self.num_components)
        self.sparsity = sparsity
        self.normalization = bool(normalization)
        self.difference = bool(difference)
        base_kernels.get(base)
        self.base = base
        self.base_options = dict(base_options or {})
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
        if self.num_lags > 0:
            self.bijectors["lags"] = "sigmoid"
            self.bijectors["gamma"] = "positive"
        _, base_bij = self._base_init(dtype, None, None)
        self.bijectors.update(base_bij)
        for name, raw in self.init_params(dtype, device, generator).items():
            self.register_parameter(name, nn.Parameter(raw))

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    def _base_init(self, dtype, device, generator):
        return base_kernels.init_params(
            self.base, generator,
            num_features=self.num_features * (self.num_lags + 1),
            dtype=dtype, device=device, **self.base_options)

    def init_params(self, dtype=None, device=None,
                    generator: torch.Generator | None = None) -> dict:
        """Fresh raw (unconstrained) parameters, as the JAX pytree holds
        them; the spectral mixture's draws come from ``generator`` (seed 0
        if None)."""
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
        if self.num_lags > 0:
            gamma = 1.0 / np.arange(1, self.num_lags + 2)
            raw["lags"] = pm.raw_init(0.1 * np.arange(1, self.num_lags + 1),
                                      "sigmoid", dtype, device)
            raw["gamma"] = pm.raw_init(gamma / gamma.sum(), "positive", dtype,
                                       device)
        raw.update(self._base_init(dtype, device, generator)[0])
        return raw

    def constrain(self) -> dict:
        cp = {name: pm.constrain(p, self.bijectors.get(name, "identity"))
              for name, p in self.named_parameters()}
        cp.update(base_kernels.static_params(self.base, **self.base_options))
        return cp

    def _base_kern(self, cp: dict):
        fn = base_kernels.get(self.base)
        return lambda A, B=None: fn(cp, A, B)

    # ------------------------------------------------------------------
    # scaling and lags (``gpsig_tpu/kernels.py:228-252``)
    # ------------------------------------------------------------------

    def _scale_groups(self, cp: dict, X):
        """Divide each of the ``num_lags + 1`` channel groups on the
        second-to-last axis by the lengthscales and weight it by gamma."""
        if "lengthscales" in cp:
            X = X / cp["lengthscales"].to(X.dtype)
        if self.num_lags > 0:
            X = X * cp["gamma"].to(X.dtype)[:, None]
        return X

    def _scale_sequences(self, cp: dict, X):
        """(N, L, d) -> (N, L, (num_lags+1)*d) scaled, lag-augmented."""
        N, L, _ = X.shape
        if self.num_lags > 0:
            X = lags.add_lags_to_sequences(X, cp["lags"].to(X.dtype))
        else:
            X = X[:, :, None, :]
        return self._scale_groups(cp, X).reshape(
            N, L, (self.num_lags + 1) * self.num_features)

    def _scale_tensors(self, cp: dict, Z):
        """Scale packed inducing tensors (lt, n_Z, [2,] (num_lags+1)*d)
        group by group."""
        shape = Z.shape
        Z = Z.reshape(*shape[:-1], self.num_lags + 1, self.num_features)
        return self._scale_groups(cp, Z).reshape(shape)

    # ------------------------------------------------------------------
    # unnormalized level computations
    # ------------------------------------------------------------------

    def _closed_form_fns(self, cp: dict, dtype):
        """(inc_cross, inc_diag) closed forms in the f32 regime, unless
        ``fused='off'`` pins the reference-shaped graphs; ``cp`` (the
        constrained and static parameters) gives mix, poly and the spectral
        families theirs."""
        if self.fused == "off" or dtype != torch.float32:
            return None, None
        return gram.increment_gram_fns(self.base, cp)

    def _kernel_route(self, t: torch.Tensor) -> bool:
        """Whether the covariances go through the kernel wrappers: for the
        bases that have kernels, unless ``fused='off'``."""
        if self.fused == "off":
            return False
        if self.base not in ic.SUPPORTED_BASES:
            if self.fused == "on":
                raise ValueError(
                    f"fused='on' but base {self.base!r} has no CUDA kernel "
                    "(neither has the JAX package a Pallas one); the "
                    f"kernels support the bases {ic.SUPPORTED_BASES}; use "
                    "fused='auto' to compute it with torch ops")
            return False
        if self.fused == "on" and t.device.type != "cuda":
            raise ValueError(
                "fused='on' launches the CUDA kernels and needs CUDA "
                f"float32 tensors, got a {t.device.type} tensor; use "
                "fused='auto' to run their plain versions on the CPU"
            )
        return True

    def _levels_of(self, M):
        """The reference recursion at this kernel's order on a base Gram."""
        if self.order == 1:
            return sig_ops.signature_kern_first_order(
                M, self.num_levels, difference=self.difference)
        return sig_ops.signature_kern_higher_order(
            M, self.num_levels, order=self.order, difference=self.difference)

    def _K_seq(self, cp: dict, X, X2=None):
        """(M+1, N1, N2) unnormalized per-level kernels; exactly symmetric
        when X2 is None.  With ``difference`` and the kernel route, K5/K6
        (``signature_cuda``) at this order; else the reference graph on the
        full base Gram (``gpsig_tpu/kernels.py:306-321``)."""
        if self.difference and self._kernel_route(X):
            return sc.fused_first_order_levels(
                X, X2, num_levels=self.num_levels, base=self.base,
                difference=True, order=self.order)
        if self.difference:
            # a base without a kernel: closed-form increment Grams over
            # example tiles, so the (N1, L1, N2, L2) Gram is never whole
            inc_cross, _ = self._closed_form_fns(cp, X.dtype)
            if inc_cross is not None:
                N2, L2 = (X.shape[0], X.shape[1]) if X2 is None else (
                    X2.shape[0], X2.shape[1])
                return gram.blocked_first_order_levels(
                    self._base_kern(cp), X, X2, num_levels=self.num_levels,
                    order=self.order, block_size=_auto_gram_block(
                        max(X.shape[0], N2), X.shape[1], L2),
                    increment_fn=inc_cross)
        kern = self._base_kern(cp)
        N1, L1, d = X.shape
        if X2 is None:
            M = kern(X.reshape(N1 * L1, d)).reshape(N1, L1, N1, L1)
        else:
            N2, L2, _ = X2.shape
            M = kern(X.reshape(N1 * L1, d),
                     X2.reshape(N2 * L2, d)).reshape(N1, L1, N2, L2)
        return self._levels_of(M)

    def _K_seq_diag(self, cp: dict, X):
        """(M+1, N) unnormalized per-level diagonals."""
        if self.difference:
            _, inc_diag = self._closed_form_fns(cp, X.dtype)
            if inc_diag is not None:
                G = inc_diag(X)  # (N, L-1, L-1), pre-differenced
                if self.order == 1:
                    lvls = gram.first_order_levels_batched(
                        G, self.num_levels, difference=False)
                else:
                    lvls = gram.higher_order_levels_batched(
                        G, self.num_levels, self.order, difference=False)
                lvls[1] = gram.level1_exact_diag(inc_diag, X)
                return lvls
        return self._levels_of(self._base_kern(cp)(X))  # (N, L, L) Grams

    def _K_tens(self, cp: dict, Z, increments: bool):
        if self._kernel_route(Z):
            return ic.fused_tensor_levels(
                Z, num_levels=self.num_levels, base=self.base,
                increments=increments)
        if increments:
            # each slot pair is a 2-point path: the closed forms apply,
            # except where tens_closed_form_ok keeps the naive graph
            inc_cross, _ = self._closed_form_fns(cp, Z.dtype)
            if inc_cross is not None and gram.tens_closed_form_ok(self.base):
                return sig_ops.tensor_kern(gram.tens_slot_grams(
                    gram.increment_gram_slots_fn(self.base, cp), Z),
                    self.num_levels)
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
            if self.order == 1:
                return ic.fused_tens_vs_seq_levels(
                    Z, X, num_levels=self.num_levels, base=self.base,
                    increments=increments, difference=self.difference,
                    fast_math=self.fast_math)
            # the Kzx kernel is order-1 only, as JAX's fused one is: no
            # silent detour under 'on'
            if self.fused == "on":
                raise ValueError(
                    "fused='on' but the fused Kzx kernel supports order=1 "
                    f"only (this kernel has order={self.order}); use "
                    "fused='auto' to compute it with torch ops")
        if increments and self.difference:
            # closed-form slot Grams of the 2-point slot paths, then the
            # time recursion as triangular matmuls (any order)
            inc_cross, _ = self._closed_form_fns(cp, X.dtype)
            if inc_cross is not None:
                M = gram.tens_vs_seq_slot_grams(inc_cross, Z, X)
                return gram.tens_vs_seq_levels_mxu(M, self.num_levels,
                                                   order=self.order)
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
        if self.order == 1:
            return sig_ops.signature_kern_tens_vs_seq_first_order(
                M, self.num_levels, difference=self.difference)
        return sig_ops.signature_kern_tens_vs_seq_higher_order(
            M, self.num_levels, order=self.order, difference=self.difference)

    def _level_scale(self, cp: dict, K_lvls):
        w = (cp["sigma"] * cp["variances"]).to(K_lvls.dtype)
        return K_lvls * w.reshape((-1,) + (1,) * (K_lvls.ndim - 1))

    # ------------------------------------------------------------------
    # low-rank feature maps (``gpsig_tpu/kernels.py:540-591, 805-810``)
    # ------------------------------------------------------------------

    def _lr_draws(self, generator, num_points: int | None,
                  like: torch.Tensor):
        """Every draw of one low-rank call, the landmarks among
        ``num_points`` points: ``generator``'s own if it is a
        ``LowRankDraws``, else drawn from it (None: seed 0 on ``like``'s
        device, per call)."""
        if isinstance(generator, low_rank_ops.LowRankDraws):
            return generator.to(like.device)
        if generator is None:
            generator = torch.Generator(device=like.device).manual_seed(0)
        return low_rank_ops.draw_low_rank(
            generator, num_points, num_components=self.num_components,
            rank_bound=self.rank_bound, num_levels=self.num_levels,
            sparsity=self.sparsity, dtype=like.dtype).to(like.device)

    def _lr_feature_map(self, cp: dict, landmarks, draws):
        """Nystrom features on ``landmarks`` (C, d): one eigenbasis for
        every point set the call maps."""
        kern = self._base_kern(cp)
        basis = low_rank_ops.nystrom_basis(landmarks, kern, draws.jitter,
                                           cfg.jitter())
        return lambda P: low_rank_ops.nystrom_features(P, kern, landmarks,
                                                       basis)

    def _lr_maps(self, cp: dict, generator, *point_sets):
        """The feature map and the draws of one call, the landmarks drawn
        from the union of ``point_sets`` (each (n, d))
        (``_joint_nystrom_samples``)."""
        points = (point_sets[0] if len(point_sets) == 1
                  else torch.cat(point_sets, dim=0))
        draws = self._lr_draws(generator, points.shape[0], points)
        landmarks = torch.index_select(points, 0, draws.landmarks)
        return self._lr_feature_map(cp, landmarks, draws), draws

    def _K_seq_lr_feat(self, X, feature_map, draws):
        """(M+1) factors (N, C_m) of the sequences X (N, L, d)."""
        N, L, d = X.shape
        U = feature_map(X.reshape(N * L, d)).reshape(N, L, -1)
        return low_rank_ops.signature_kern_lr_feature(
            U, self.num_levels, draws.projections, self.sparsity,
            difference=self.difference)

    def _K_tens_lr_feat(self, Z, increments: bool, feature_map, draws):
        """(M+1) factors (n_Z, C_m) of packed inducing tensors; with
        ``increments`` each slot's feature is that of its second point
        less its first."""
        U = feature_map(Z.reshape(-1, Z.shape[-1]))
        if increments:
            U = U.reshape(*Z.shape[:2], 2, -1)
            U = U[:, :, 1] - U[:, :, 0]
        else:
            U = U.reshape(*Z.shape[:2], -1)
        return low_rank_ops.tensor_kern_lr_feature(
            U, self.num_levels, draws.projections, self.sparsity)

    def _lr_seq_factors(self, cp: dict, generator, *Xs):
        """Factors of each sequence set, on landmarks from their union."""
        fmap, draws = self._lr_maps(
            cp, generator, *(X.reshape(-1, X.shape[-1]) for X in Xs))
        return [self._K_seq_lr_feat(X, fmap, draws) for X in Xs]

    def _lr_tens_seq_factors(self, cp: dict, generator, Z, X,
                             increments: bool):
        """Factors of the inducing tensors and of the sequences, on
        landmarks from the union of their points."""
        fmap, draws = self._lr_maps(cp, generator, Z.reshape(-1, Z.shape[-1]),
                                    X.reshape(-1, X.shape[-1]))
        return (self._K_tens_lr_feat(Z, increments, fmap, draws),
                self._K_seq_lr_feat(X, fmap, draws))

    @staticmethod
    def _lr_gram(Phi_lvls, Phi2_lvls=None):
        Phi2_lvls = Phi_lvls if Phi2_lvls is None else Phi2_lvls
        return torch.stack([P @ P2.T for P, P2 in zip(Phi_lvls, Phi2_lvls)])

    @staticmethod
    def _lr_diag(Phi_lvls):
        return torch.stack([torch.sum(torch.square(P), dim=-1)
                            for P in Phi_lvls])

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

    def _data_cov(self, cp: dict, full: bool, gram, diag, n: int):
        """The data side's level stack -- the full Gram ``gram()``, or its
        diagonal ``diag()`` -- normalized and level-scaled, and the
        sqrt-diagonal the cross Gram is divided by (None without
        normalization)."""
        if full:
            K_lvls, d = gram(), None
            if self.normalization:
                K_lvls, d = self._normalize_sym(K_lvls)
            return self._level_scale(cp, K_lvls), d
        if not self.normalization:
            return self._level_scale(cp, diag()), None
        d = torch.sqrt(diag() + cfg.jitter())
        sig_var = (cp["sigma"] * cp["variances"]).to(d.dtype)
        return sig_var[:, None].expand(-1, n), d

    def _finalize(self, K_lvls, return_levels: bool):
        return K_lvls if return_levels else torch.sum(K_lvls, dim=0)

    def K(self, X, X2=None, *, return_levels: bool = False, generator=None):
        """Signature kernel matrix between sequences (N1, N2), or its
        (M+1, N1, N2) levels.  A symmetric Gram is normalized by its own
        jittered diagonal, a cross Gram by the two diagonals
        (``_K_seq_diag``, or the low-rank factors')."""
        cp = self.constrain()
        X = self._scale_sequences(cp, _as_sequences(X, self.num_features))
        if X2 is None:
            K_lvls = (self._lr_gram(*self._lr_seq_factors(cp, generator, X))
                      if self.low_rank else self._K_seq(cp, X))
            if self.normalization:
                K_lvls, _ = self._normalize_sym(K_lvls)
            return self._finalize(self._level_scale(cp, K_lvls),
                                  return_levels)
        X2 = self._scale_sequences(cp, _as_sequences(X2, self.num_features))
        if self.low_rank:
            Phi, Phi2 = self._lr_seq_factors(cp, generator, X, X2)
            K_lvls = self._lr_gram(Phi, Phi2)
            if self.normalization:
                d1, d2 = (torch.sqrt(self._lr_diag(P) + cfg.jitter())
                          for P in (Phi, Phi2))
        else:
            K_lvls = self._K_seq(cp, X, X2)
            if self.normalization:
                d1, d2 = self._diag_sqrt(cp, X), self._diag_sqrt(cp, X2)
        if self.normalization:
            K_lvls = K_lvls / (d1[:, :, None] * d2[:, None, :])
        return self._finalize(self._level_scale(cp, K_lvls), return_levels)

    def Kdiag(self, X, *, return_levels: bool = False, generator=None):
        """Diagonal of ``K(X)``: exactly sigma * variances per level when
        normalized."""
        cp = self.constrain()
        X = _as_sequences(X, self.num_features)
        if self.normalization:
            sig_var = cp["sigma"] * cp["variances"]
            lvls = sig_var[:, None].expand(-1, X.shape[0])
            return self._finalize(lvls.to(X.dtype), return_levels)
        X = self._scale_sequences(cp, X)
        K_lvls = (self._lr_diag(*self._lr_seq_factors(cp, generator, X))
                  if self.low_rank else self._K_seq_diag(cp, X))
        return self._finalize(self._level_scale(cp, K_lvls), return_levels)

    def K_blocked(self, X, X2=None, *, block_size: int = 16,
                  diag_block_size: int = 64, return_levels: bool = False,
                  fast_math=False, method: str = "xla"):
        """``K`` over (block, block) example tiles: peak memory
        O(block^2 L^2) instead of O(N^2 L^2) (``gpsig_tpu/kernels.py:656``).

        method:
          'xla'    -- the blocked torch path (``gram.blocked_first_order_
                      levels``) with the closed-form increment Grams of
                      every base that has one, at any dtype; differentiable.
          'pallas' -- K5/K6 (``signature_cuda``) for the kernels' bases
                      (rbf, linear, matern12); a symmetric Gram is
                      normalized by its own diagonal, a cross Gram by the
                      blocked diagonals.  Other bases take 'xla', as JAX's
                      do.
        ``fast_math`` is accepted; every value means full f32.
        """
        if self.low_rank:
            raise ValueError("use K() for the low-rank path")
        if method == "pallas" and self.base not in ic.SUPPORTED_BASES:
            method = "xla"
        if method not in ("xla", "pallas"):
            raise ValueError(f"unknown method {method!r}")
        cp = self.constrain()
        Xs = self._scale_sequences(cp, _as_sequences(X, self.num_features))
        X2s = None if X2 is None else self._scale_sequences(
            cp, _as_sequences(X2, self.num_features))
        kern = self._base_kern(cp)
        inc_cross, inc_diag = gram.increment_gram_fns(self.base, cp)
        if method == "pallas":
            K_lvls = sc.fused_first_order_levels(
                Xs, X2s, num_levels=self.num_levels, base=self.base,
                difference=self.difference, order=self.order)
        else:
            K_lvls = gram.blocked_first_order_levels(
                kern, Xs, X2s, num_levels=self.num_levels, order=self.order,
                difference=self.difference, block_size=block_size,
                increment_fn=inc_cross)
        if self.normalization:
            if X2s is None:
                K_lvls, _ = self._normalize_sym(K_lvls)
            else:
                d1, d2 = (torch.sqrt(gram.blocked_first_order_levels_diag(
                    kern, V, num_levels=self.num_levels, order=self.order,
                    difference=self.difference, block_size=diag_block_size,
                    increment_diag_fn=inc_diag) + cfg.jitter())
                    for V in (Xs, X2s))
                K_lvls = K_lvls / (d1[:, :, None] * d2[:, None, :])
        return self._finalize(self._level_scale(cp, K_lvls), return_levels)

    def K_tens(self, Z, *, increments: bool = False,
               return_levels: bool = False, generator=None):
        """Covariance of inducing tensors (n_Z, n_Z), unnormalized, or its
        levels (``gpsig_tpu/kernels.py:833``): K1 for the kernels' bases."""
        cp = self.constrain()
        Z = self._scale_tensors(cp, Z)
        if self.low_rank:
            fmap, draws = self._lr_maps(cp, generator,
                                        Z.reshape(-1, Z.shape[-1]))
            K_lvls = self._lr_gram(self._K_tens_lr_feat(Z, increments, fmap,
                                                        draws))
        else:
            K_lvls = self._K_tens(cp, Z, increments)
        return self._finalize(self._level_scale(cp, K_lvls), return_levels)

    def K_tens_vs_seq(self, Z, X, *, increments: bool = False,
                      return_levels: bool = False, generator=None):
        """Cross-covariance of inducing tensors and sequences (n_Z, N), or
        its levels, normalized on the sequences' side
        (``gpsig_tpu/kernels.py:846``): K3 for the kernels' bases."""
        cp = self.constrain()
        Z = self._scale_tensors(cp, Z)
        X = self._scale_sequences(cp, _as_sequences(X, self.num_features))
        if self.low_rank:
            Phi_Z, Phi_X = self._lr_tens_seq_factors(cp, generator, Z, X,
                                                     increments)
            Kzx_lvls = self._lr_gram(Phi_Z, Phi_X)
            diag = lambda: self._lr_diag(Phi_X)  # noqa: E731
        else:
            Kzx_lvls = self._K_tens_vs_seq(cp, Z, X, increments)
            diag = lambda: self._K_seq_diag(cp, X)  # noqa: E731
        if self.normalization:
            Kzx_lvls = Kzx_lvls / torch.sqrt(diag() + cfg.jitter())[:, None]
        return self._finalize(self._level_scale(cp, Kzx_lvls), return_levels)

    def K_tens_n_seq_covs(self, Z, X, *, full_X_cov: bool = False,
                          increments: bool = False,
                          return_levels: bool = False, generator=None):
        """Kzz, Kzx and Kxx (its diagonal, or the full Gram with
        ``full_X_cov``) in one call, sharing the scaled inputs, the Kxx
        normalization between Kzx and Kxx, and a low-rank call's draws."""
        cp = self.constrain()
        Z = self._scale_tensors(cp, Z)
        X_scaled = self._scale_sequences(
            cp, _as_sequences(X, self.num_features))
        if self.low_rank:
            Phi_Z, Phi_X = self._lr_tens_seq_factors(cp, generator, Z,
                                                     X_scaled, increments)
            Kzz_lvls = self._lr_gram(Phi_Z)
            Kzx_lvls = self._lr_gram(Phi_Z, Phi_X)
            Kxx_lvls, d = self._data_cov(
                cp, full_X_cov, lambda: self._lr_gram(Phi_X),
                lambda: self._lr_diag(Phi_X), X_scaled.shape[0])
        else:
            Kzz_lvls = self._K_tens(cp, Z, increments)
            Kzx_lvls = self._K_tens_vs_seq(cp, Z, X_scaled, increments)
            Kxx_lvls, d = self._data_cov(
                cp, full_X_cov, lambda: self._K_seq(cp, X_scaled),
                lambda: self._K_seq_diag(cp, X_scaled), X_scaled.shape[0])
        if d is not None:
            Kzx_lvls = Kzx_lvls / d[:, None, :]
        out = (self._level_scale(cp, Kzz_lvls),
               self._level_scale(cp, Kzx_lvls), Kxx_lvls)
        if return_levels:
            return out
        return tuple(torch.sum(o, dim=0) for o in out)

    def K_seq_n_seq_covs(self, X, X2, *, full_X2_cov: bool = False,
                         return_levels: bool = False, generator=None):
        """Kxx, Kxx2 and Kx2x2 (its diagonal, or the full Gram with
        ``full_X2_cov``) for inducing sequences X against data X2: the
        symmetric Grams normalized by their own jittered diagonals, the
        cross Gram by both (``gpsig_tpu/kernels.py:947-1017``)."""
        cp = self.constrain()
        Xs = self._scale_sequences(cp, _as_sequences(X, self.num_features))
        X2s = self._scale_sequences(cp, _as_sequences(X2, self.num_features))
        if self.low_rank:
            Phi, Phi2 = self._lr_seq_factors(cp, generator, Xs, X2s)
            Kxx_lvls, Kxx2_lvls = self._lr_gram(Phi), self._lr_gram(Phi, Phi2)
            gram2 = lambda: self._lr_gram(Phi2)  # noqa: E731
            diag2 = lambda: self._lr_diag(Phi2)  # noqa: E731
        else:
            Kxx_lvls = self._K_seq(cp, Xs)
            Kxx2_lvls = self._K_seq(cp, Xs, X2s)
            gram2 = lambda: self._K_seq(cp, X2s)  # noqa: E731
            diag2 = lambda: self._K_seq_diag(cp, X2s)  # noqa: E731
        if self.normalization:
            Kxx_lvls, d1 = self._normalize_sym(Kxx_lvls)
            Kxx2_lvls = Kxx2_lvls / d1[:, :, None]
        Kx2_lvls, d2 = self._data_cov(cp, full_X2_cov, gram2, diag2,
                                      X2s.shape[0])
        if d2 is not None:
            Kxx2_lvls = Kxx2_lvls / d2[:, None, :]
        out = (self._level_scale(cp, Kxx_lvls),
               self._level_scale(cp, Kxx2_lvls), Kx2_lvls)
        if return_levels:
            return out
        return tuple(torch.sum(o, dim=0) for o in out)


_SPECTRAL_FAMILIES = {"exp": "exp", "exponential": "exp", "gauss": "rbf",
                      "gaussian": "rbf", "rbf": "rbf", "mix": "mixed",
                      "mixed": "mixed"}


def _variant(name: str, base: str, **default_opts):
    """A named constructor with JAX's keyword routing
    (``gpsig_tpu/kernels.py:1025``): ``gamma`` and ``degree`` go to the
    poly options, ``Q`` to the spectral ones, and ``family`` (or an alias)
    picks the spectral base, whose lengthscales default to None."""

    def ctor(num_features, num_levels, **kwargs):
        opts = dict(default_opts)
        opts.update(kwargs.pop("base_options", None) or {})
        for key, opt in (("gamma", "poly_gamma"), ("degree", "poly_degree"),
                         ("Q", "Q"), ("family", "family")):
            if key in kwargs:
                opts[opt] = kwargs.pop(key)
        b = base
        if base == "spectral":
            family = opts.pop("family", "rbf")
            fam = _SPECTRAL_FAMILIES.get(family)
            if fam is None:
                raise ValueError(f"Unrecognized spectral family {family!r}")
            b = f"spectral_{fam}"
            kwargs.setdefault("lengthscales", None)
        return SignatureKernel(num_features, num_levels, base=b,
                               base_options=opts, **kwargs)

    ctor.__name__ = name
    ctor.__qualname__ = name
    ctor.__doc__ = f"SignatureKernel with the {base!r} state-space embedding."
    return ctor


SignatureLinear = _variant("SignatureLinear", "linear")
SignatureCosine = _variant("SignatureCosine", "cosine")
SignaturePoly = _variant("SignaturePoly", "poly")
SignatureRBF = _variant("SignatureRBF", "rbf")
SignatureGauss = SignatureRBF
SignatureMix = _variant("SignatureMix", "mix")
SignatureSpectral = _variant("SignatureSpectral", "spectral")
SignatureMatern12 = _variant("SignatureMatern12", "matern12")
SignatureLaplace = SignatureMatern12
SignatureExponential = SignatureMatern12
SignatureMatern32 = _variant("SignatureMatern32", "matern32")
SignatureMatern52 = _variant("SignatureMatern52", "matern52")
