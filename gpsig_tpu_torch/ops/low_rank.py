"""Low-rank signature features: Nystrom maps and randomized Hadamard
products (``gpsig_tpu/ops/low_rank.py``).

Each random function of the JAX module is split in two here:

* a plain function that takes its draws as tensors -- ``nystrom_map``
  (landmarks and the diagonal jitter's uniforms), ``lr_hadamard_prod_*``
  (a depth's projection matrix, or its subsample indices and signs),
  ``signature_kern_lr_feature`` / ``tensor_kern_lr_feature`` (one draw per
  depth);
* a drawing step that takes an explicit ``torch.Generator``:
  ``draw_indices``, ``draw_projection`` and ``draw_low_rank``, which makes
  every draw of one covariance call (a ``LowRankDraws``).

torch and ``jax.random`` draw different streams, so the tests replay
JAX's key splits with ``jax.random`` and pass JAX's draws into the plain
functions.  The products are ``torch.matmul``, full f32 on the card
(``config.py`` keeps TF32 off), as JAX computes them outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .signature import cumsum_exclusive

SPARSITIES = ("sqrt", "log", "lin", "exact", "rademacher", "gauss")


@dataclasses.dataclass
class Projection:
    """One depth's random projection of a (k1 * k2)-wide outer product:
    the (D, C) matrix ``R`` (sparse JL, Rademacher or Gaussian), or, for
    'lin', the C flat indices ``sel`` of the kept pairs and their
    ``signs``."""

    R: torch.Tensor | None = None
    sel: torch.Tensor | None = None
    signs: torch.Tensor | None = None

    def to(self, device=None, dtype=None) -> "Projection":
        def move(t, floating=True):
            return None if t is None else t.to(
                device=device, dtype=dtype if floating else None)
        return Projection(move(self.R), move(self.sel, False),
                          move(self.signs))


@dataclasses.dataclass
class LowRankDraws:
    """Every draw of one low-rank covariance call: the landmark indices
    into the points they are drawn from (None with explicit landmarks), the
    uniforms of the Nystrom diagonal jitter, and one ``Projection`` per
    depth 1..M-1 (None for 'exact').  Depth j projects a level-j feature
    against a level-1 one, on both the sequence and the tensor side, so one
    draw serves both: their Grams are inner products of one feature
    map."""

    landmarks: torch.Tensor | None
    jitter: torch.Tensor
    projections: list

    def to(self, device=None, dtype=None) -> "LowRankDraws":
        """The same draws on ``device``, the real ones at ``dtype``."""
        return LowRankDraws(
            None if self.landmarks is None else self.landmarks.to(device),
            self.jitter.to(device=device, dtype=dtype),
            [None if p is None else p.to(device, dtype)
             for p in self.projections])


def draw_indices(generator: torch.Generator, n: int, l: int):
    """``l`` of 0..n-1 without replacement, and the rest
    (``gpsig_tpu/ops/low_rank.py:28``)."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    return perm[:l], perm[l:]


def jl_sparsity(D: int, sparsity: str, dtype) -> torch.Tensor:
    """The sparse JL's s: a nonzero w.p. 1/s (``'log'``: D / log D,
    ``'sqrt'``: sqrt D), a host scalar at the features' dtype as JAX casts
    it."""
    if sparsity == "log":
        s = D / math.log(float(D))
    elif sparsity == "sqrt":
        s = math.sqrt(float(D))
    else:
        raise ValueError(f"Unknown sparsity {sparsity!r}")
    return torch.tensor(s, dtype=dtype)


def _host(x: torch.Tensor) -> float:
    """A host scalar as a Python float: exact at its dtype, so a tensor of
    that dtype takes it unrounded."""
    return float(x.item())


def draw_projection(generator: torch.Generator, D: int, num_components: int,
                    sparsity: str, dtype) -> Projection | None:
    """One depth's draw for ``lr_hadamard_prod_rand`` on (k1 * k2 = D)-wide
    outer products, on the generator's device."""
    dev = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype, device=dev)

    if sparsity == "exact":
        return None
    if sparsity == "lin":
        sel = torch.randperm(D, generator=generator, device=dev)
        sel = sel[:num_components]
        signs = torch.where(uniform(num_components) <= 0.5, 1.0, -1.0)
        return Projection(sel=sel, signs=signs.to(dtype))
    if sparsity == "rademacher":
        R = torch.where(uniform(D, num_components) <= 0.5, 1.0, -1.0)
        return Projection(R=R.to(dtype))
    if sparsity == "gauss":
        return Projection(R=torch.randn((D, num_components),
                                        generator=generator, dtype=dtype,
                                        device=dev))
    mask = uniform(D, num_components) <= _host(
        1.0 / jl_sparsity(D, sparsity, dtype))
    vals = torch.randn((D, num_components), generator=generator, dtype=dtype,
                       device=dev)
    return Projection(R=torch.where(mask, vals, torch.zeros_like(vals)))


def draw_low_rank(generator: torch.Generator, num_points: int | None, *,
                  num_components: int, rank_bound: int, num_levels: int,
                  sparsity: str, dtype) -> LowRankDraws:
    """The draws of one covariance call, in this order: landmarks among
    ``num_points`` (none if None: explicit landmarks), the jitter's
    uniforms, then each depth's projection.  Depth 1 projects
    num_components**2 features, deeper ones num_components * rank_bound."""
    landmarks = None
    if num_points is not None:
        landmarks, _ = draw_indices(generator, num_points, num_components)
    jitter = torch.rand((num_components,), generator=generator, dtype=dtype,
                        device=generator.device)
    projections = [
        draw_projection(generator, num_components * (
            num_components if depth == 1 else rank_bound), rank_bound,
            sparsity, dtype)
        for depth in range(1, max(num_levels - 1, 1) + 1)]
    return LowRankDraws(landmarks, jitter, projections)


def nystrom_basis(landmarks, kern_fn, jitter_u, jitter: float = 1e-6):
    """The eigenbasis of the landmarks' jittered Gram, (U, S^-1/2) with the
    directions below JAX's spectral floor zeroed
    (``gpsig_tpu/ops/low_rank.py:35-70``).

    W + diag(jitter * u) is symmetrized as ``jnp.linalg.eigh`` does before
    ``eigh``; an eigenvalue counts if above max(max(S) * rel_eps, jitter),
    rel_eps 1e-6 at float32 and 1e-12 otherwise: below it, it is rounding
    noise that 1 / sqrt(S) would amplify."""
    W = kern_fn(landmarks, landmarks)
    W = W + torch.diag(jitter * jitter_u.to(W.dtype))
    S, U = torch.linalg.eigh(0.5 * (W + W.transpose(-1, -2)))
    rel_eps = 1e-6 if S.dtype == torch.float32 else 1e-12
    floor = torch.clamp(torch.max(S) * rel_eps, min=jitter)
    inv_sqrt = torch.where(S > floor, 1.0 / torch.sqrt(torch.maximum(
        S, floor)), torch.zeros_like(S))
    return U, inv_sqrt


def nystrom_features(X, kern_fn, landmarks, basis):
    """(n, C) features of ``X`` in a ``nystrom_basis``: Phi Phi^T ~=
    kern(X, X)."""
    U, inv_sqrt = basis
    return torch.matmul(kern_fn(X, landmarks), U) * inv_sqrt[None, :]


def nystrom_map(X, kern_fn, landmarks, jitter_u, jitter: float = 1e-6):
    """Nystrom features of ``X`` (n, d) on the given (C, d) landmarks with
    the diagonal jitter's uniforms ``jitter_u`` (C,)."""
    return nystrom_features(X, kern_fn, landmarks,
                            nystrom_basis(landmarks, kern_fn, jitter_u,
                                          jitter))


def lr_hadamard_prod(A, B):
    """Exact low-rank Hadamard product, the features' outer product:
    (..., k1), (..., k2) -> (..., k1 * k2)."""
    C = A[..., :, None] * B[..., None, :]
    return C.reshape(*C.shape[:-2], C.shape[-2] * C.shape[-1])


def _project_chunked(A, B, R, chunk_rows: int):
    """(n, k1 * k2) outer products of A's and B's rows times R, built
    ``chunk_rows`` rows at a time so the intermediate stays bounded."""
    k1, k2 = A.shape[-1], B.shape[-1]
    Af, Bf = A.reshape(-1, k1), B.reshape(-1, k2)

    def project(a, b):
        return torch.matmul((a[:, :, None] * b[:, None, :]).reshape(
            -1, k1 * k2), R)

    n = Af.shape[0]
    if n <= chunk_rows:
        out = project(Af, Bf)
    else:
        out = torch.cat([project(Af[i:i + chunk_rows], Bf[i:i + chunk_rows])
                         for i in range(0, n, chunk_rows)])
    return out.reshape(*A.shape[:-1], R.shape[-1])


def lr_hadamard_prod_sparse(A, B, R, sparsity: str = "sqrt", *,
                            chunk_rows: int = 1 << 15):
    """Randomized Hadamard product by a Very-Sparse-JL matrix ``R`` (D, C)
    (``draw_projection``): (..., k1), (..., k2) -> (..., C), scaled by
    sqrt(s / C) (``gpsig_tpu/ops/low_rank.py:91``)."""
    s = jl_sparsity(A.shape[-1] * B.shape[-1], sparsity, A.dtype)
    return _host(torch.sqrt(s / R.shape[-1])) * _project_chunked(
        A, B, R, chunk_rows)


def lr_hadamard_prod_dense(A, B, R, *, chunk_rows: int = 1 << 15):
    """Randomized Hadamard product by a dense Rademacher or Gaussian matrix
    ``R`` (D, C), scaled by 1 / sqrt(C) (``gpsig_tpu/ops/low_rank.py:139``)."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(R.shape[-1]), dtype=A.dtype))
    return _host(scale) * _project_chunked(A, B, R, chunk_rows)


def lr_hadamard_prod_subsample(A, B, sel, signs):
    """Randomized Hadamard product by C kept index pairs (flat indices
    ``sel`` into k1 * k2) with Rademacher ``signs`` ('lin',
    ``gpsig_tpu/ops/low_rank.py:186``)."""
    k2 = B.shape[-1]
    C = (torch.index_select(A, -1, torch.div(sel, k2, rounding_mode="floor"))
         * torch.index_select(B, -1, sel % k2))
    return C * signs


def lr_hadamard_prod_rand(A, B, projection: Projection | None,
                          sparsity: str = "sqrt"):
    """Dispatch on ``sparsity`` (``gpsig_tpu/ops/low_rank.py:201``): 'exact'
    (the full outer product, no draw), 'lin', 'rademacher' / 'gauss', or
    the sparse JL ('sqrt' / 'log')."""
    if sparsity == "exact":
        return lr_hadamard_prod(A, B)
    if sparsity == "lin":
        return lr_hadamard_prod_subsample(A, B, projection.sel,
                                          projection.signs)
    if sparsity in ("rademacher", "gauss"):
        return lr_hadamard_prod_dense(A, B, projection.R)
    return lr_hadamard_prod_sparse(A, B, projection.R, sparsity)


def signature_kern_lr_feature(U, num_levels: int, projections,
                              sparsity: str = "sqrt",
                              difference: bool = True):
    """Low-rank feature maps of first-order sequence signatures
    (``gpsig_tpu/ops/low_rank.py:219``).

    ``U`` (N, L, C): low-rank features of the embedded observations;
    ``projections[j - 1]``: depth j's draw.  Returns ``num_levels + 1``
    factors (N, C_m) with Phi_m Phi_m^T ~= K_m.  Levels >= 2 append
    ``sum_t P``, JAX's fix of the reference's ``sum_t U``
    (``signature_algs.py:191``)."""
    Phi = [torch.ones((U.shape[0], 1), dtype=U.dtype, device=U.device)]
    if difference:
        U = U[:, 1:, :] - U[:, :-1, :]
    Phi.append(torch.sum(U, dim=1))
    P = U
    for i in range(2, num_levels + 1):
        P = lr_hadamard_prod_rand(U, cumsum_exclusive(P, dim=1),
                                  projections[i - 2], sparsity)
        Phi.append(torch.sum(P, dim=1))
    return Phi


def tensor_kern_lr_feature(U, num_levels: int, projections,
                           sparsity: str = "sqrt"):
    """Low-rank feature maps of rank-1 inducing tensors
    (``gpsig_tpu/ops/low_rank.py:253``).

    ``U`` (M(M+1)/2, num_tensors, C): features of the packed slots.  Slot
    depth j takes ``projections[j - 1]`` at every level, as the reference
    reuses its seed j-1 (``signature_algs.py:219``), so the tensors' and
    the sequences' level features share each depth's projection."""
    Phi = [torch.ones((U.shape[1], 1), dtype=U.dtype, device=U.device)]
    k = 0
    for i in range(1, num_levels + 1):
        R = U[k]
        k += 1
        for j in range(1, i):
            R = lr_hadamard_prod_rand(U[k], R, projections[j - 1], sparsity)
            k += 1
        Phi.append(R)
    return Phi
