"""Posterior precision operators from point measurements.

Counterpart of ``multigridmc_tpu/models/posterior.py``.  Given a prior precision
Q (a stencil operator) and m measurements ``y = B^T x + e`` with
``e ~ N(0, Sigma)``, the posterior precision is ``Q_post = Q + B Sigma^{-1} B^T``.

Each column of B is a measurement vector on the lattice: radius 0 is a delta at
the vertex nearest to the measurement location; radius R is the indicator of
the R-ball around x0, normalised by the sphere volume and integrated against
the multilinear FEM basis with order-1 quadrature; optionally a global-average
measurement appends a dense column of cell_volume.

The exact moments (:func:`posterior_mean`, :func:`observed_mean_and_variance`)
solve the prior's stencil in float64: densely up to 4096 unknowns, by a band
Cholesky above that on 1d and 2d lattices, by CG that must converge on 3d
lattices.  The JAX package solves every lattice above 4096 unknowns by CG and
keeps the result where CG stops unconverged (the squared shifted-Laplace
stencil at 255^2 does); there the port's moments are the exact ones and the
JAX package's are not.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from ..lattice import Lattice
from ..ops.band import band_factor, band_solve
from ..ops.quadrature import gauss_legendre
from ..ops.stencil import LowRank, StencilOperator, _to_numpy
from .prior import _phi

#: largest lattice for which the exact-moment diagnostics densify the prior;
#: above it they solve by a band Cholesky (1d, 2d) or by CG (3d)
DENSE_SOLVE_MAX_N = 4096
#: the exact moments' CG on 3d lattices: the relative residual it must reach
#: and the iterations it may take before it raises
CG_RTOL = 1e-12
CG_MAXITER = 10_000


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
    """Solver for the *stencil* (prior) part, in float64 whatever the
    operator's dtype: dense Cholesky on the host up to
    :data:`DENSE_SOLVE_MAX_N` unknowns; above it, on 1d and 2d lattices a band
    Cholesky on the host (``ops.band``: the stencil's band, factored once), on
    3d lattices unpreconditioned CG on the operator's device, which raises
    ``RuntimeError`` where it does not reach :data:`CG_RTOL` within
    :data:`CG_MAXITER` iterations (a band at 63^3 would take 7.9 GB).  The
    returned ``solve(v)`` takes a field or a stack of fields ``(k, *vshape)``
    and returns a numpy array of the same shape."""
    n = op.lattice.nvertex
    vshape = op.lattice.vshape
    if n <= DENSE_SOLVE_MAX_N:
        factor = scipy.linalg.cho_factor(op.to_dense_stencil())

        def solve_dense(v):
            v = _to_numpy(v).astype(np.float64)
            return scipy.linalg.cho_solve(factor, v.reshape(-1, n).T).T.reshape(v.shape)

        return solve_dense
    if len(vshape) < 3:
        cb, _ = band_factor(op)

        def solve_band(v):
            v = _to_numpy(v).astype(np.float64)
            return band_solve(cb, v.reshape(-1, n).T).T.reshape(v.shape)

        return solve_band
    from ..solvers.loop import CGSolver, IterativeSolverParameters

    stencil_only = dataclasses.replace(op, lowrank=None).to(dtype=torch.float64)
    solver = CGSolver(stencil_only, params=IterativeSolverParameters(
        rtol=CG_RTOL, atol=1e-30, maxiter=CG_MAXITER))

    def solve_cg(v):
        v = torch.as_tensor(_to_numpy(v), dtype=torch.float64, device=stencil_only.device)
        result = solver.solve(v, batched=v.ndim > len(vshape))
        if not result.converged:
            k = v.reshape(-1, n).shape[0]
            r = (v - stencil_only.apply(result.x)).reshape(k, n)
            rel = torch.linalg.vector_norm(r, dim=1) / torch.linalg.vector_norm(
                v.reshape(k, n), dim=1)
            raise RuntimeError(
                f"exact moments: CG on the {vshape} stencil stopped after {result.niter} "
                f"iterations with a largest relative residual of {float(rel.max()):.3e}, "
                f"above its rtol {CG_RTOL}")
        return _to_numpy(result.x)

    return solve_cg


def _lowrank_numpy(op: StencilOperator):
    m = op.m_lowrank
    B = _to_numpy(op.lowrank.B).astype(np.float64).reshape(m, -1)  # (m, n)
    Sigma = np.diag(_to_numpy(op.lowrank.Sigma_diag).astype(np.float64))
    return m, B, Sigma


def _solve_columns(op: StencilOperator, solve, B: np.ndarray) -> np.ndarray:
    """``Q^{-1} B_k`` for all columns, shape ``(m, n)``.  The default solvers
    take the whole stack at once; a solver given by the caller is called
    column by column."""
    m = B.shape[0]
    vshape = op.lattice.vshape
    if solve is None:
        return np.asarray(_default_stencil_solve(op)(B.reshape((m,) + vshape))).reshape(m, -1)
    return np.stack([np.asarray(solve(B[k].reshape(vshape))).reshape(-1) for k in range(m)])


def posterior_mean(op: StencilOperator, xbar, y, solve=None) -> np.ndarray:
    """Exact posterior mean
    ``x|y = xbar + Q^{-1} B (Sigma + B^T Q^{-1} B)^{-1} (y - B^T xbar)``
    (Q is the *prior* stencil part).  Float64, returned on the host."""
    if op.lowrank is None:
        return _to_numpy(xbar)
    vshape = op.lattice.vshape
    m, B, Sigma = _lowrank_numpy(op)
    Bbar = _solve_columns(op, solve, B)  # (m, n)
    S = Sigma + B @ Bbar.T
    xbar = _to_numpy(xbar).astype(np.float64).reshape(-1)
    rhs = np.asarray(y) - B @ xbar
    coef = np.linalg.solve(S, rhs)
    return (xbar + Bbar.T @ coef).reshape(vshape)


def observed_mean_and_variance(op: StencilOperator, xbar, y, b_obs, solve=None):
    """Exact mean and variance of the observation ``z = b^T x`` under the
    posterior.  Float64 on the host."""
    b_obs = _to_numpy(b_obs).astype(np.float64)
    xbar = _to_numpy(xbar).astype(np.float64)
    cols = b_obs.reshape(1, -1)
    if op.lowrank is not None:
        m, B, Sigma = _lowrank_numpy(op)
        cols = np.concatenate([cols, B])
    solved = _solve_columns(op, solve, cols)  # Q^{-1} b, then Q^{-1} B_k
    b_bar = solved[0]
    mean = float(np.vdot(b_obs, xbar))
    variance = float(np.vdot(b_obs, b_bar))
    if op.lowrank is not None:
        Bbar = solved[1:]
        S_inv = np.linalg.inv(Sigma + B @ Bbar.T)
        Bt_bbar = B @ b_bar
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
