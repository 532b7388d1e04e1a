"""Assembly of the prior precision operator as a lattice stencil.

Counterpart of ``multigridmc_tpu/models/prior.py``.  This slice ports the
finite-difference shifted Laplacian; the FEM and squared-FD operators belong to
a later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..lattice import Lattice
from ..ops.stencil import StencilOperator
from ..utils.runtime import resolve_device, resolve_dtype
from .correlation import CorrelationLengthModel


def _axis_offset(lattice: Lattice, ref_dim: int, o: int) -> Tuple[int, ...]:
    """Unit offset ``o`` along reference dimension ``ref_dim`` in array-axis order."""
    off = [0] * lattice.dim
    off[lattice.dim - 1 - ref_dim] = o
    return tuple(off)


def _phi(alpha: Tuple[int, ...], xhat: np.ndarray) -> float:
    """Multilinear basis function on the reference cell (used by the
    radius-R measurement vectors)."""
    v = 1.0
    for a, xh in zip(alpha, xhat):
        v *= xh if a == 1 else (1.0 - xh)
    return v


def shiftedlaplace_fd(
    lattice: Lattice, model: CorrelationLengthModel, device=None, dtype=None
) -> StencilOperator:
    """Finite-difference discretisation of ``-Laplace(u) + kappa^2(x) u``.

    5-point (2d) / 7-point (3d) stencil with homogeneous Dirichlet BCs:
    off-diagonal ``-V / h_d^2``, diagonal ``V (kappa^2(x) + sum_d 2/h_d^2)``.
    The coefficients are assembled in float64 on the host and cast once.
    """
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    V = lattice.cell_volume
    hinv2 = [1.0 / h**2 for h in lattice.h]
    kappa2 = np.asarray(model.kappa_sq(lattice.vertex_coordinates()), dtype=np.float64)

    offsets = [(0,) * lattice.dim]
    planes = [V * kappa2 + sum(2.0 * V * hi for hi in hinv2) * np.ones(lattice.vshape)]
    for d in range(lattice.dim):
        for o in (-1, 1):
            offsets.append(_axis_offset(lattice, d, o))
            planes.append(np.full(lattice.vshape, -V * hinv2[d]))
    coeffs = torch.as_tensor(np.stack(planes), dtype=dtype, device=device)
    return StencilOperator(
        coeffs=coeffs, offsets=tuple(offsets), lattice=lattice
    ).normalized()


def _later_slice(name):
    def build(lattice, model, device=None, dtype=None):
        raise NotImplementedError(
            f"PDE model '{name}' is not ported yet: the FEM and squared "
            "finite-difference operators belong to a later slice of the port")

    return build


_PDE_MODELS = {
    "shiftedlaplace_fd": shiftedlaplace_fd,
    "shiftedlaplace_fem": _later_slice("shiftedlaplace_fem"),
    "squared_shiftedlaplace_fd": _later_slice("squared_shiftedlaplace_fd"),
}


def prior_operator(
    pdemodel: str, lattice: Lattice, model: CorrelationLengthModel,
    device=None, dtype=None,
) -> StencilOperator:
    """Dispatch by the PDE model's name, as the configuration files give it."""
    try:
        build = _PDE_MODELS[pdemodel]
    except KeyError:
        raise ValueError(f"unknown PDE model '{pdemodel}'") from None
    return build(lattice, model, device=device, dtype=dtype)
