"""Posterior precision operators from point measurements.

Counterpart of ``multigridmc_tpu/models/posterior.py``.  Given a prior precision
Q (a stencil operator) and m measurements ``y = B^T x + e`` with
``e ~ N(0, Sigma)``, the posterior precision is ``Q_post = Q + B Sigma^{-1} B^T``.

Each column of B is a measurement vector on the lattice: radius 0 is a delta at
the vertex nearest to the measurement location; radius R is the indicator of
the R-ball around x0, normalised by the sphere volume and integrated against
the multilinear FEM basis with order-1 quadrature; optionally a global-average
measurement appends a dense column of cell_volume.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from ..lattice import Lattice
from ..ops.quadrature import gauss_legendre
from ..ops.stencil import LowRank, StencilOperator, _to_numpy
from .prior import _phi

#: largest lattice for which the exact-moment diagnostics densify the prior
DENSE_SOLVE_MAX_N = 4096


@dataclasses.dataclass
class MeasurementParameters:
    """Mirrors ``MeasurementParameters`` of the reference's parameter file."""

    measurement_locations: np.ndarray  # (m, dim)
    mean: np.ndarray  # (m,)
    variance: np.ndarray  # (m,)
    radius: float = 0.0
    variance_scaling: float = 1.0
    sample_location: Optional[np.ndarray] = None
    measure_global: bool = False
    mean_global: float = 0.0
    variance_global: float = 0.0

    @property
    def n(self) -> int:
        return len(self.mean)

    def y(self) -> np.ndarray:
        """Measured values incl. the optional global mean."""
        if self.measure_global:
            return np.concatenate([np.asarray(self.mean), [self.mean_global]])
        return np.asarray(self.mean)


def v_sphere(radius: float, dim: int) -> float:
    """Volume of the R-sphere: V_0=1, V_1=2R, V_d = 2 pi/d R^2 V_{d-2}."""
    if dim == 0:
        return 1.0
    if dim == 1:
        return 2.0 * radius
    return 2.0 * np.pi / dim * radius * radius * v_sphere(radius, dim - 2)


def measurement_vector(lattice: Lattice, x0, radius: float) -> np.ndarray:
    """Measurement vector as a grid field (numpy float64)."""
    x0 = np.asarray(x0, dtype=np.float64)
    dim = lattice.dim
    w = np.zeros(lattice.vshape)
    if radius < 1e-12:
        coords = lattice.vertex_coordinates()  # (*vshape, dim)
        dist = np.linalg.norm(coords - x0, axis=-1)
        idx = np.unravel_index(np.argmin(dist), lattice.vshape)
        w[idx] = 1.0
        return w
    V = lattice.cell_volume
    norm = 1.0 / v_sphere(radius, dim)
    points, weights = gauss_legendre(dim, order=1)
    corners = list(itertools.product((0, 1), repeat=dim))
    for q in range(len(weights)):
        # physical coordinates of quadrature point q in every cell
        axes = [
            (np.arange(n, dtype=np.float64) + points[q][d]) / n
            for d, n in enumerate(lattice.shape)
        ]
        grids = np.meshgrid(*reversed(axes), indexing="ij")
        x = np.stack(list(reversed(grids)), axis=-1)  # (*cshape, dim), x first
        inside = (np.linalg.norm(x - x0, axis=-1) / radius) < 1.0
        for alpha in corners:
            contrib = inside * (_phi(alpha, points[q]) * weights[q] * V * norm)
            # scatter to vertex cell + alpha (interior only): vertex array index
            # i = cell + (alpha - 1) per axis -> slice cells from 1 - alpha
            a_arr = tuple(reversed(alpha))
            sl = tuple(
                slice(1 - aa, 1 - aa + (n - 1)) for aa, n in zip(a_arr, lattice.cshape)
            )
            w += contrib[sl]
    return w


def _default_stencil_solve(op: StencilOperator):
    """Solver for the *stencil* (prior) part: dense Cholesky on the host.

    The JAX package switches to its CG solver above 4096 unknowns; the
    iterative solvers are not part of this slice of the port."""
    n = op.lattice.nvertex
    if n > DENSE_SOLVE_MAX_N:
        raise NotImplementedError(
            f"exact posterior moments for {n} > {DENSE_SOLVE_MAX_N} unknowns "
            "need the CG solver (solvers/loop.py), which a later slice of the "
            "port brings; pass solve= or use a lattice with n <= 4096")
    factor = scipy.linalg.cho_factor(op.to_dense_stencil())
    return lambda v: scipy.linalg.cho_solve(
        factor, _to_numpy(v).astype(np.float64).reshape(-1)
    ).reshape(op.lattice.vshape)


def _lowrank_numpy(op: StencilOperator):
    m = op.m_lowrank
    B = _to_numpy(op.lowrank.B).astype(np.float64).reshape(m, -1)  # (m, n)
    Sigma = np.diag(_to_numpy(op.lowrank.Sigma_diag).astype(np.float64))
    return m, B, Sigma


def posterior_mean(op: StencilOperator, xbar, y, solve=None) -> np.ndarray:
    """Exact posterior mean
    ``x|y = xbar + Q^{-1} B (Sigma + B^T Q^{-1} B)^{-1} (y - B^T xbar)``
    (Q is the *prior* stencil part).  Host float64."""
    if op.lowrank is None:
        return _to_numpy(xbar)
    solve = solve or _default_stencil_solve(op)
    vshape = op.lattice.vshape
    m, B, Sigma = _lowrank_numpy(op)
    Bbar = np.stack(
        [np.asarray(solve(B[k].reshape(vshape))).reshape(-1) for k in range(m)]
    )  # (m, n)
    S = Sigma + B @ Bbar.T
    xbar = _to_numpy(xbar).astype(np.float64).reshape(-1)
    rhs = np.asarray(y) - B @ xbar
    coef = np.linalg.solve(S, rhs)
    return (xbar + Bbar.T @ coef).reshape(vshape)


def observed_mean_and_variance(op: StencilOperator, xbar, y, b_obs, solve=None):
    """Exact mean and variance of the observation ``z = b^T x`` under the
    posterior.  Host float64."""
    solve = solve or _default_stencil_solve(op)
    b_obs = _to_numpy(b_obs).astype(np.float64)
    b_bar = np.asarray(solve(b_obs))  # Q^{-1} b
    xbar = _to_numpy(xbar).astype(np.float64)
    mean = float(np.vdot(b_obs, xbar))
    variance = float(np.vdot(b_obs, b_bar))
    if op.lowrank is not None:
        vshape = op.lattice.vshape
        m, B, Sigma = _lowrank_numpy(op)
        Bbar = np.stack(
            [np.asarray(solve(B[k].reshape(vshape))).reshape(-1) for k in range(m)]
        )
        S_inv = np.linalg.inv(Sigma + B @ Bbar.T)
        Bt_bbar = B @ b_bar.reshape(-1)
        rhs = np.asarray(y) - B @ xbar.reshape(-1)
        mean += float(Bt_bbar @ S_inv @ rhs)
        variance -= float(Bt_bbar @ S_inv @ Bt_bbar)
    return mean, variance


def measured_operator(
    prior: StencilOperator, params: MeasurementParameters, dtype=None
) -> StencilOperator:
    """Posterior precision ``Q_post = Q_prior + B Sigma^{-1} B^T`` on the
    prior's device (and in its dtype unless ``dtype`` is given)."""
    lattice = prior.lattice
    dtype = dtype or prior.coeffs.dtype
    device = prior.coeffs.device
    cols = [
        measurement_vector(lattice, x0, params.radius)
        for x0 in np.asarray(params.measurement_locations).reshape(-1, lattice.dim)
    ]
    sigma = list(params.variance_scaling * np.asarray(params.variance, dtype=np.float64))
    if params.measure_global:
        cols.append(np.full(lattice.vshape, lattice.cell_volume))
        sigma.append(params.variance_global)
    B = torch.as_tensor(np.stack(cols), dtype=dtype, device=device)
    Sigma_diag = torch.as_tensor(np.asarray(sigma), dtype=dtype, device=device)
    return dataclasses.replace(prior, lowrank=LowRank(B=B, Sigma_diag=Sigma_diag))
