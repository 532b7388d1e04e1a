"""Intergrid transfer operators: d-linear prolongation and its transpose.

Counterpart of ``multigridmc_tpu/ops/intergrid.py``.  Both transfers are
tensor-product matrix contractions: per dimension a banded ``(n_c, n_f)``
matrix ``R1`` with row i = {0.5, 1, 0.5} centred at fine index ``2 i + 1``, so

    restrict    f_c = R1 . r . R1^T        (one contraction per dimension)
    prolongate  x_f = R1^T . x_c . R1

This is the plain path (``torch.matmul`` in full float32, outside any kernel);
the fused level-visit kernels compute the same {0.5, 1, 0.5} stencils directly.
The matrix entries and their per-dimension products are exact powers of two, so
only the summation order differs between the two.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import runtime  # noqa: F401  (sets the matmul precision policy)


@functools.lru_cache(maxsize=None)
def _restrict_matrix_1d(n_fine: int, dtype_name: str = "float64") -> np.ndarray:
    """Banded ``(n_coarse, n_fine)`` full-weighting matrix for one dimension.

    Row i holds weights {0.5, 1, 0.5} at fine indices ``2 i + 1 + {-1, 0, 1}``
    (out-of-range entries dropped: zero-Dirichlet boundary).  A host numpy
    constant.
    """
    n_coarse = len(range(1, n_fine, 2))
    R = np.zeros((n_coarse, n_fine), dtype=dtype_name)
    for i in range(n_coarse):
        c = 2 * i + 1
        R[i, c] = 1.0
        if c - 1 >= 0:
            R[i, c - 1] = 0.5
        if c + 1 < n_fine:
            R[i, c + 1] = 0.5
    return R


@functools.lru_cache(maxsize=None)
def _restrict_tensor_1d(n_fine: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`_restrict_matrix_1d` as a tensor, cached per (size, dtype,
    device) so the composed cycle uploads each matrix once."""
    return torch.as_tensor(_restrict_matrix_1d(n_fine), dtype=dtype, device=device)


def _contract_last_dims(x: torch.Tensor, mats) -> torch.Tensor:
    """Contract each of the trailing ``len(mats)`` axes of x with axis 1 of
    its matrix."""
    dim = len(mats)
    for d, M in enumerate(mats):
        ax = x.ndim - dim + d
        x = torch.movedim(torch.matmul(torch.movedim(x, ax, -1), M.T), -1, ax)
    return x


def prolongate(x_coarse: torch.Tensor, fine_vshape: Tuple[int, ...]) -> torch.Tensor:
    """``P x_c``: d-linear interpolation from the coarse to the fine grid
    (one ``R1^T`` contraction per dimension)."""
    mats = [
        _restrict_tensor_1d(int(n), x_coarse.dtype, x_coarse.device).T
        for n in fine_vshape
    ]
    return _contract_last_dims(x_coarse, mats)


def restrict(x_fine: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``R x_f`` with ``R = P^T``: full-weighting gather onto coarse vertices,
    ``(R x)[i] = sum_off w(off) x[2 i + 1 + off]`` per dimension."""
    dim = x_fine.ndim if dim is None else dim
    mats = [
        _restrict_tensor_1d(int(x_fine.shape[x_fine.ndim - dim + d]),
                            x_fine.dtype, x_fine.device)
        for d in range(dim)
    ]
    return _contract_last_dims(x_fine, mats)


def prolongate_add(
    alpha: float, x_coarse: torch.Tensor, x_fine: torch.Tensor,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """``x_f + alpha * P x_c`` (a new tensor; ``x_fine`` is not modified)."""
    dim = x_fine.ndim if dim is None else dim
    return x_fine + alpha * prolongate(x_coarse, tuple(x_fine.shape[x_fine.ndim - dim:]))
