"""State carried across from the JAX package: build the port's operators from
plain numpy arrays.

The parity tests call ``np.asarray`` on a JAX operator's ``coeffs``,
``lowrank.B`` and ``lowrank.Sigma_diag`` and pass ``offsets`` and
``lattice.shape``, so both sides run on identical operators.  Nothing here
imports the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .lattice import Lattice
from .ops.stencil import LowRank, StencilOperator
from .solvers.multigrid import MultigridHierarchy
from .utils.runtime import resolve_device, resolve_dtype


def operator_from_numpy(
    coeffs,
    offsets,
    lattice_shape,
    B=None,
    Sigma_diag=None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> StencilOperator:
    """A :class:`StencilOperator` from ``coeffs (n_offsets, *vshape)``, the
    offset tuples, the lattice's cell counts and, optionally, the low-rank
    factor ``B (m, *vshape)`` with ``Sigma_diag (m,)``.  The arrays are copied."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    lattice = Lattice(tuple(int(n) for n in lattice_shape))
    coeffs = np.asarray(coeffs)
    if coeffs.shape[1:] != lattice.vshape or coeffs.shape[0] != len(offsets):
        raise ValueError(
            f"coeffs {coeffs.shape} do not match {len(offsets)} offsets on "
            f"vertex shape {lattice.vshape}")
    if (B is None) != (Sigma_diag is None):
        raise ValueError("B and Sigma_diag are given together or not at all")
    lowrank = None
    if B is not None:
        B = np.asarray(B)
        if B.shape[1:] != lattice.vshape or B.shape[0] != len(np.asarray(Sigma_diag)):
            raise ValueError(f"B {B.shape} does not match the lattice / Sigma_diag")
        lowrank = LowRank(
            B=torch.tensor(B, dtype=dtype, device=device),
            Sigma_diag=torch.tensor(np.asarray(Sigma_diag), dtype=dtype, device=device))
    return StencilOperator(
        coeffs=torch.tensor(coeffs, dtype=dtype, device=device),
        offsets=tuple(tuple(int(o) for o in off) for off in offsets),
        lattice=lattice, lowrank=lowrank)


def hierarchy_from_numpy(levels: Sequence[dict], device=None, dtype=None) -> MultigridHierarchy:
    """A :class:`MultigridHierarchy` from one keyword dictionary per level, each
    holding the arguments of :func:`operator_from_numpy` (finest first)."""
    ops = [operator_from_numpy(device=device, dtype=dtype, **lv) for lv in levels]
    return MultigridHierarchy(ops[0], len(ops), operators=ops)
