"""GP linear algebra: the sparse conditional (``gpsig_tpu/linalg.py``).

``gauss_kl`` comes with the training slice (ROADMAP Queue 1, item 1).
"""

from __future__ import annotations

import torch


def base_conditional(Kmn, Kmm, Knn, f, *, q_sqrt=None, white: bool = False,
                     full_cov: bool = False):
    """Sparse GP conditional q(f*) given inducing outputs u ~ N(f, q_sqrt^2).

    Args:
      Kmn: (M, N) inducing-vs-data covariance.
      Kmm: (M, M) inducing covariance (jitter already added by caller).
      Knn: (N,) diag or (N, N) full data covariance.
      f: (M, P) variational means (whitened if ``white``).
      q_sqrt: None, (M, P) diagonal factors, or (P, M, M) lower factors.
      white: whitened parameterization (u = L v).

    Returns: mean (N, P), var (N, P) or (P, N, N) if full_cov.
    """
    Lm = torch.linalg.cholesky(Kmm)
    A = torch.linalg.solve_triangular(Lm, Kmn, upper=False)  # (M, N)

    if full_cov:
        fvar = Knn - A.T @ A
    else:
        fvar = Knn - torch.sum(torch.square(A), dim=0)

    if not white:
        A = torch.linalg.solve_triangular(Lm.T, A, upper=True)

    fmean = A.T @ f  # (N, P)
    P = f.shape[-1]

    if q_sqrt is not None:
        if q_sqrt.ndim == 2:  # (M, P) diagonal
            LTA = q_sqrt.T[:, :, None] * A[None, :, :]  # (P, M, N)
        elif q_sqrt.ndim == 3:  # (P, M, M) lower-triangular
            LTA = torch.matmul(torch.tril(q_sqrt).transpose(-1, -2), A[None])
        else:
            raise ValueError("q_sqrt must have rank 2 or 3")
        if full_cov:
            fvar = fvar[None] + torch.matmul(LTA.transpose(-1, -2), LTA)
        else:
            fvar = fvar[None] + torch.sum(torch.square(LTA), dim=1)  # (P, N)

    if full_cov:
        if fvar.ndim == 2:
            fvar = fvar[None].expand((P,) + fvar.shape)
    elif fvar.ndim == 1:
        fvar = fvar[:, None].expand(fvar.shape + (P,))
    else:
        fvar = fvar.T  # (N, P)
    return fmean, fvar
