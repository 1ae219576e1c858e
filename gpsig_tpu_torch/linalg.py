"""GP linear algebra (``gpsig_tpu/linalg.py``): the sparse conditional and
the Gaussian KL of the ELBO.  Cholesky factors and triangular solves go to
``torch.linalg``, whose backward is torch autograd.
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


def gauss_kl(q_mu, q_sqrt, K=None):
    """KL[q(u) || p(u)] for q = N(q_mu, q_sqrt q_sqrt^T).

    p(u) = N(0, I) if K is None (the whitened case), else N(0, K).

    Args:
      q_mu: (M, P); q_sqrt: (M, P) diagonal or (P, M, M) lower.
    """
    M, P = q_mu.shape
    diag = q_sqrt.ndim == 2
    if diag:
        logdet_q = torch.sum(torch.log(torch.square(q_sqrt)))
    else:
        Lq = torch.tril(q_sqrt)
        logdet_q = 2.0 * torch.sum(torch.log(torch.abs(
            torch.diagonal(Lq, dim1=-2, dim2=-1))))

    if K is None:
        mahalanobis = torch.sum(torch.square(q_mu))
        trace = torch.sum(torch.square(q_sqrt if diag else Lq))
        return 0.5 * (mahalanobis + trace - M * P - logdet_q)

    L = torch.linalg.cholesky(K)
    alpha = torch.linalg.solve_triangular(L, q_mu, upper=False)  # (M, P)
    mahalanobis = torch.sum(torch.square(alpha))
    logdet_p = 2.0 * P * torch.sum(torch.log(torch.diagonal(L)))
    if diag:
        eye = torch.eye(M, dtype=K.dtype, device=K.device)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        trace = torch.sum(torch.square(q_sqrt)
                          * torch.sum(torch.square(Linv), dim=0)[:, None])
    else:
        LiLq = torch.linalg.solve_triangular(L[None], Lq, upper=False)
        trace = torch.sum(torch.square(LiLq))
    return 0.5 * (mahalanobis + trace - M * P - logdet_q + logdet_p)
