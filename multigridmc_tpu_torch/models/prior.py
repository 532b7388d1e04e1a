"""Assembly of the prior precision operators as lattice stencils.

Counterpart of ``multigridmc_tpu/models/prior.py``:

* :func:`shiftedlaplace_fd` - the 5-point (2d) / 7-point (3d) finite-difference
  shifted Laplacian;
* :func:`shiftedlaplace_fem` - its multilinear FEM discretisation, a 3^d box;
* :func:`squared_shiftedlaplace_fd` - the square of the FD operator (2d only), a
  13-point diamond of reach 2.

Every operator is assembled in float64 on the host from whole coordinate grids
and cast once to the asked device and dtype.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from ..lattice import Lattice
from ..ops.quadrature import gauss_legendre
from ..ops.stencil import StencilOperator
from ..utils.runtime import resolve_device, resolve_dtype
from .correlation import CorrelationLengthModel


def _axis_offset(lattice: Lattice, ref_dim: int, o: int) -> Tuple[int, ...]:
    """Unit offset ``o`` along reference dimension ``ref_dim`` in array-axis order."""
    off = [0] * lattice.dim
    off[lattice.dim - 1 - ref_dim] = o
    return tuple(off)


def _ref_offset_to_array(off_ref: Tuple[int, ...]) -> Tuple[int, ...]:
    """Reference (x, y, z) offset -> array-axis (z, y, x) offset."""
    return tuple(reversed(off_ref))


def _phi(alpha: Tuple[int, ...], xhat: np.ndarray) -> float:
    """Multilinear basis function on the reference cell (the FEM operator and
    the radius-R measurement vectors)."""
    v = 1.0
    for a, xh in zip(alpha, xhat):
        v *= xh if a == 1 else (1.0 - xh)
    return v


def _operator(planes, offsets, lattice, device, dtype) -> StencilOperator:
    """The stencil of the float64 host planes, cast once."""
    coeffs = torch.as_tensor(np.stack(planes), dtype=dtype, device=device)
    return StencilOperator(coeffs=coeffs, offsets=tuple(offsets), lattice=lattice).normalized()


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
    return _operator(planes, offsets, lattice, device, dtype)


def squared_shiftedlaplace_fd(
    lattice: Lattice, model: CorrelationLengthModel, device=None, dtype=None
) -> StencilOperator:
    """Finite-difference discretisation of ``(-Laplace + kappa^2(x))^2`` (2d only).

    13-point diamond stencil (reach 2) with Neumann-style folding of the
    out-of-range distance-2 entries onto the diagonal wherever the distance-1
    neighbour in that direction leaves the grid.
    """
    if lattice.dim != 2:
        raise ValueError("squared_shiftedlaplace_fd is only implemented for d=2")
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    V = lattice.cell_volume
    hx2, hy2 = (1.0 / h**2 for h in lattice.h)  # hinv2 for ref dims x (0) and y (1)
    # the stencils of the Laplacian and of its square, by (|j|, |k|), j along x
    lap = {(0, 0): -2.0 * (hx2 + hy2), (1, 0): hx2, (0, 1): hy2}
    sq = {
        (0, 0): 6.0 * (hx2 * hx2 + hy2 * hy2) + 8.0 * hx2 * hy2,
        (1, 0): -4.0 * hx2 * (hx2 + hy2),
        (0, 1): -4.0 * hy2 * (hx2 + hy2),
        (2, 0): hx2 * hx2,
        (0, 2): hy2 * hy2,
        (1, 1): 2.0 * hx2 * hy2,
    }
    alpha = np.asarray(model.kappa_sq(lattice.vertex_coordinates()), dtype=np.float64)
    vshape = lattice.vshape  # (ny-1, nx-1): axis 0 = y, axis 1 = x
    diag = (alpha * alpha - 2.0 * alpha * lap[(0, 0)] + sq[(0, 0)]) * V

    offsets, planes = [(0, 0)], [None]  # the diagonal, filled in below
    for j in range(-2, 3):  # reference x offset
        for k in range(-2, 3):  # reference y offset
            if abs(j) + abs(k) > 2 or (j == 0 and k == 0):
                continue
            coeff = np.full(vshape, sq[(abs(j), abs(k))])
            if abs(j) + abs(k) == 1:
                coeff = coeff - 2.0 * alpha * lap[(abs(j), abs(k))]
            offsets.append((k, j))  # array order (y, x)
            planes.append(coeff * V)
    # a distance-1 neighbour in +-x / +-y outside the grid folds the
    # distance-2 coefficient of that direction onto the diagonal
    ny1, nx1 = vshape
    for j, k in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        outside = np.zeros(vshape)
        if k == 0:  # x direction: a boundary column
            outside[:, 0 if j < 0 else nx1 - 1] = 1.0
            fold = sq[(2, 0)]
        else:  # y direction: a boundary row
            outside[0 if k < 0 else ny1 - 1, :] = 1.0
            fold = sq[(0, 2)]
        diag = diag + outside * (fold * V)
    planes[0] = diag
    return _operator(planes, offsets, lattice, device, dtype)


def _grad_phi(alpha: Tuple[int, ...], xhat: np.ndarray) -> np.ndarray:
    """Gradient of the multilinear basis function with respect to the
    reference coordinates."""
    dim = len(alpha)
    g = np.empty(dim)
    for k in range(dim):
        v = 1.0
        for j, (a, xh) in enumerate(zip(alpha, xhat)):
            if j == k:
                v *= 1.0 if a == 1 else -1.0
            else:
                v *= xh if a == 1 else (1.0 - xh)
        g[k] = v
    return g


def shiftedlaplace_fem(
    lattice: Lattice, model: CorrelationLengthModel, device=None, dtype=None
) -> StencilOperator:
    """Multilinear FEM discretisation of ``-div(grad u) + kappa^2(x) u``.

    3^d stencil assembled cell by cell with order-1 Gauss-Legendre quadrature:
    kappa^2 on every quadrature point of every cell at once, contracted with
    the basis-pair tables into per-cell local matrices, which are then
    slice-accumulated into the vertex stencil.
    """
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    dim = lattice.dim
    V = lattice.cell_volume
    hinv2 = np.array([1.0 / h**2 for h in lattice.h])
    points, weights = gauss_legendre(dim, order=1)
    nq = len(weights)
    corners = list(itertools.product((0, 1), repeat=dim))  # reference dim order

    phi_tab = np.array([[_phi(a, points[q]) for q in range(nq)] for a in corners])
    gphi_tab = np.array([[[_grad_phi(a, points[q]) @ (hinv2 * _grad_phi(b, points[q]))
                           for q in range(nq)] for b in corners] for a in corners])

    # kappa^2 at quadrature point q of every cell: x = h (cell index + xhat_q)
    kappa2_q = []
    for q in range(nq):
        axes = [(np.arange(n, dtype=np.float64) + points[q][d]) / n
                for d, n in enumerate(lattice.shape)]
        grids = np.meshgrid(*reversed(axes), indexing="ij")
        x = np.stack(list(reversed(grids)), axis=-1)  # (*cshape, dim), x first
        kappa2_q.append(np.asarray(model.kappa_sq(x), dtype=np.float64))
    kappa2_q = np.stack(kappa2_q)  # (nq, *cshape)

    # per-cell local matrices K[a, b] = sum_q (kappa^2 phi phi + grad grad) w_q V
    K = np.einsum("aq,bq,q,q...->ab...", phi_tab, phi_tab, weights, kappa2_q) + np.einsum(
        "abq,q->ab", gphi_tab, weights)[(...,) + (None,) * dim]
    K = K * V

    # the pair (a, b) adds K[a, b](cell) to the coefficient that couples vertex
    # cell + a with its neighbour at offset b - a: for the vertex of array
    # index i the cell is i + (1 - a) per axis
    offsets = sorted(itertools.product((-1, 0, 1), repeat=dim))
    acc = {off: np.zeros(lattice.vshape) for off in offsets}
    for ia, a in enumerate(corners):
        a_arr = tuple(reversed(a))
        for ib, b in enumerate(corners):
            off = _ref_offset_to_array(tuple(bb - aa for aa, bb in zip(a, b)))
            sl = tuple(slice(1 - aa, 1 - aa + (n - 1)) for aa, n in zip(a_arr, lattice.cshape))
            acc[off] += K[ia, ib][sl]
    return _operator([acc[off] for off in offsets], offsets, lattice, device, dtype)


_PDE_MODELS = {
    "shiftedlaplace_fd": shiftedlaplace_fd,
    "shiftedlaplace_fem": shiftedlaplace_fem,
    "squared_shiftedlaplace_fd": squared_shiftedlaplace_fd,
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
