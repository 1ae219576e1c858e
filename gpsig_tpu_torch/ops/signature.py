"""Reference-shaped signature recursions (``gpsig_tpu/ops/signature.py``).

These are the port's ``fused='off'`` leg and its f64 Kxx-diagonal path:
the truncated-signature inner products evaluated from a base-kernel Gram by
elementwise products and exclusive cumulative sums.
"""

from __future__ import annotations

import torch


def cumsum_exclusive(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exclusive cumulative sum along ``dim`` (an empty axis stays empty:
    a one-step sequence has no increments)."""
    if x.shape[dim] == 0:
        return x
    out = torch.cumsum(x, dim=dim)
    return torch.cat(
        [torch.zeros_like(out.narrow(dim, 0, 1)),
         out.narrow(dim, 0, x.shape[dim] - 1)],
        dim=dim,
    )


def second_order_difference(M: torch.Tensor) -> torch.Tensor:
    """Square "difference" of a seq-vs-seq base Gram over its time axes
    (dims 1 and -1)."""
    return (
        M[:, 1:, ..., 1:]
        + M[:, :-1, ..., :-1]
        - M[:, :-1, ..., 1:]
        - M[:, 1:, ..., :-1]
    )


def signature_kern_first_order(M: torch.Tensor, num_levels: int,
                               difference: bool = True) -> torch.Tensor:
    """First-order signature kernel from a base Gram.

    Args:
      M: ``(N1, L1, N2, L2)`` cross Gram or ``(N, L, L)`` batch of
        per-example square Grams.
    Returns ``(num_levels+1, N1, N2)`` or ``(num_levels+1, N)``.
    """
    batch_shape = (M.shape[0], M.shape[2]) if M.ndim == 4 else (M.shape[0],)
    if difference:
        M = second_order_difference(M)
    K = [torch.ones(batch_shape, dtype=M.dtype, device=M.device),
         torch.sum(M, dim=(1, -1))]
    R = M
    for _ in range(2, num_levels + 1):
        R = M * cumsum_exclusive(cumsum_exclusive(R, dim=1), dim=-1)
        K.append(torch.sum(R, dim=(1, -1)))
    return torch.stack(K, dim=0)


def tensor_kern(M: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Gram between rank-1 inducing tensors from packed slot Grams
    ``M: (lt, n1, n2)`` (level m uses slots m(m-1)/2 .. m(m-1)/2+m-1).

    Returns ``(num_levels+1, n1, n2)``."""
    K = [torch.ones(M.shape[1:], dtype=M.dtype, device=M.device)]
    k = 0
    for i in range(1, num_levels + 1):
        R = M[k]
        k += 1
        for _ in range(1, i):
            R = M[k] * R
            k += 1
        K.append(R)
    return torch.stack(K, dim=0)


def signature_kern_tens_vs_seq_first_order(M: torch.Tensor, num_levels: int,
                                           difference: bool = True
                                           ) -> torch.Tensor:
    """Inducing tensors vs first-order sequence signatures.

    Args:
      M: ``(lt, num_tensors, N, L)`` base-kernel evaluations between packed
        tensor slots and sequence observations.
    Returns ``(num_levels+1, num_tensors, N)``.
    """
    if difference:
        M = M[..., 1:] - M[..., :-1]
    K = [torch.ones(M.shape[1:3], dtype=M.dtype, device=M.device)]
    k = 0
    for i in range(1, num_levels + 1):
        R = M[k]
        k += 1
        for _ in range(1, i):
            R = M[k] * cumsum_exclusive(R, dim=2)
            k += 1
        K.append(torch.sum(R, dim=2))
    return torch.stack(K, dim=0)


def grid_next(M, R: dict, d: int, cum_rows, cum_cols) -> dict:
    """Level i's (d x d) grid of partial tensors from level i-1's, d =
    min(i, order): tile (0, 0) over the 2-D exclusive prefix of all tiles,
    (0, j-1) and (j-1, 0) over one-axis exclusive prefixes with 1/j, and
    (j-1, k-1) pointwise with 1/(jk) (``signature_algs.py:60-72``)."""
    Rn = {(0, 0): M * cum_rows(cum_cols(sum(R.values())))}
    for j in range(2, d + 1):
        row = sum(R[(a, j - 2)] for a in range(d) if (a, j - 2) in R)
        col = sum(R[(j - 2, b)] for b in range(d) if (j - 2, b) in R)
        Rn[(0, j - 1)] = (1.0 / j) * M * cum_rows(row)
        Rn[(j - 1, 0)] = (1.0 / j) * M * cum_cols(col)
        for k in range(2, d + 1):
            Rn[(j - 1, k - 1)] = (1.0 / (j * k)) * M * R[(j - 2, k - 2)]
    return Rn


def signature_kern_higher_order(M: torch.Tensor, num_levels: int,
                                order: int = 2,
                                difference: bool = True) -> torch.Tensor:
    """Higher-order signature kernel from a base Gram: an ``(order x
    order)`` grid of running partial tensors with ``1/j``, ``1/k``
    scalings (``gpsig_tpu/ops/signature.py:91``).  Shapes as
    ``signature_kern_first_order``."""
    batch_shape = (M.shape[0], M.shape[2]) if M.ndim == 4 else (M.shape[0],)
    if difference:
        M = second_order_difference(M)
    K = [torch.ones(batch_shape, dtype=M.dtype, device=M.device),
         torch.sum(M, dim=(1, -1))]
    R = {(0, 0): M}
    for i in range(2, num_levels + 1):
        R = grid_next(M, R, min(i, order),
                       lambda t: cumsum_exclusive(t, dim=1),
                       lambda t: cumsum_exclusive(t, dim=-1))
        K.append(torch.sum(sum(R.values()), dim=(1, -1)))
    return torch.stack(K, dim=0)


def signature_kern_tens_vs_seq_higher_order(M: torch.Tensor,
                                            num_levels: int, order: int = 2,
                                            difference: bool = True
                                            ) -> torch.Tensor:
    """Inducing tensors vs higher-order sequence signatures
    (``gpsig_tpu/ops/signature.py:181``); shapes as the first-order
    version."""
    if difference:
        M = M[..., 1:] - M[..., :-1]
    K = [torch.ones(M.shape[1:3], dtype=M.dtype, device=M.device)]
    k = 0
    for i in range(1, num_levels + 1):
        R = [M[k]]
        k += 1
        for j in range(1, i):
            R_next = [M[k] * cumsum_exclusive(sum(R), dim=2)]
            for l in range(1, min(j + 1, order)):
                R_next.append((1.0 / (l + 1)) * M[k] * R[l - 1])
            R = R_next
            k += 1
        K.append(torch.sum(sum(R), dim=2))
    return torch.stack(K, dim=0)
