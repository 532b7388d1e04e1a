"""Low-rank approximation of covariance matrices: pivoted Cholesky and friends.

Counterpart of ``multigridmc_tpu/ops/lowrank_approx.py`` (after the reference
prototype ``python/pivoted_cholesky.py``, Harbrecht, Peters & Schneider 2012):
Crout Cholesky, LDL^T, the *pivoted* Cholesky with greedy diagonal pivoting
and its error trace, and the truncated-SVD error curve for comparison.  Plain
PyTorch on the matrix's device: each step updates a whole row or column with
one vector operation, and the pivot is chosen on the device, so a
factorisation runs without a host round trip until its error trace is read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def cholesky_crout(A: torch.Tensor) -> torch.Tensor:
    """Unpivoted Crout Cholesky ``A = L L^T``; returns the lower factor.  Row
    ``m`` of ``L^T`` is ``(A[m, :] - L[:, m]^T L^T) / L[m, m]`` beyond the
    diagonal."""
    n = A.shape[0]
    U = torch.zeros_like(A)  # rows of the upper factor L^T
    diag = torch.diagonal(A).clone()
    idx = torch.arange(n, device=A.device)
    for m in range(n):
        lmm = torch.sqrt(diag[m])
        row = torch.where(idx > m, (A[m, :] - U[:, m] @ U) / lmm, 0.0)
        row[m] = lmm
        U[m, :] = row
        diag = diag - torch.where(idx > m, row ** 2, 0.0)
    return U.T.contiguous()


def cholesky_crout_ldlt(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpivoted ``A = L D L^T``; returns ``(L, D)``, ``L`` unit lower."""
    n = A.shape[0]
    U = torch.zeros_like(A)
    D = torch.zeros(n, dtype=A.dtype, device=A.device)
    diag = torch.diagonal(A).clone()
    idx = torch.arange(n, device=A.device)
    for m in range(n):
        d = diag[m]
        row = torch.where(idx > m, (A[m, :] - (U[:, m] * D) @ U) / d, 0.0)
        row[m] = 1.0
        U[m, :] = row
        D[m] = d
        diag = diag - d * torch.where(idx > m, row ** 2, 0.0)
    return U.T.contiguous(), D


def pivoted_cholesky(A: torch.Tensor, tolerance: float = 0.0,
                     max_rank: Optional[int] = None) -> Tuple[torch.Tensor, np.ndarray]:
    """Pivoted Cholesky low-rank approximation.

    Greedy diagonal pivoting; stops when the trace of the residual drops below
    ``tolerance * trace(A)`` or after ``max_rank`` steps.  Returns ``(L,
    rel_error)``: ``L`` of shape ``(n, rank)`` on ``A``'s device such that ``L
    L^T ~= A``, and the relative trace error after each step (``rel_error[0]
    = 1``) on the host."""
    n = A.shape[0]
    kmax = n if max_rank is None else min(max_rank, n)
    L = torch.zeros((n, kmax), dtype=A.dtype, device=A.device)
    diag = torch.diagonal(A).clone()
    err = torch.zeros(kmax + 1, dtype=A.dtype, device=A.device)
    err[0] = diag.sum()
    for m in range(kmax):
        p = torch.argmax(diag)  # chosen rows are 0; a tensor index: no host sync
        lpp = torch.sqrt(diag[p])
        col = torch.where(diag > 0, (A[p, :] - L @ L[p, :]) / lpp, 0.0)
        col[p] = lpp
        L[:, m] = col
        diag = diag - col ** 2
        diag[p] = 0.0
        diag = torch.clamp(diag, min=0.0)
        err[m + 1] = diag.sum()
    err = err.cpu().numpy()
    rel = err / err[0]
    # truncate at the first step meeting the tolerance
    hits = np.nonzero(rel[1:] < tolerance)[0]
    rank = int(hits[0]) + 1 if len(hits) else kmax
    return L[:, :rank], rel[: rank + 1]


def truncated_svd_error(A: torch.Tensor) -> np.ndarray:
    """Relative Frobenius error of the rank-``j`` truncated SVD of ``A`` for
    ``j = 0 .. n-1``: ``||A - A_j||_F / ||A||_F``, from the singular values
    (``||A - A_j||_F^2`` is the sum of the squares of those after the ``j``
    largest), on ``A``'s device."""
    s = torch.linalg.svdvals(A)
    tail = torch.flip(torch.cumsum(torch.flip(s ** 2, (0,)), 0), (0,))
    errors = torch.sqrt(tail).cpu().numpy()
    return errors / errors[0]
