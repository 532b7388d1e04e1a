"""The drivers' exact moments above the dense limit (``models/posterior.py``).

Above ``DENSE_SOLVE_MAX_N`` = 4096 unknowns the port solves the prior's
stencil by a float64 band Cholesky on 1d and 2d lattices and by CG on 3d
lattices, where CG that does not converge raises.  The JAX package solves
every such lattice by CG and keeps an unconverged result; where its CG
converges the two agree to solver precision.  Here, on the CPU in float64:

* the band route on a squared shifted-Laplace (biharmonic) posterior of 65^2
  unknowns against a dense float64 solve (``rtol = 1e-10``), its residual;
* the band route on a 65^2 FD posterior against the JAX package's CG
  (``rtol = 1e-8``);
* the 3d CG route against a dense solve at 17^3 (``rtol = 1e-9``), and CG
  that stops before its tolerance raising.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models import posterior as jposterior
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConstant
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshiftedlaplace_fd

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models import posterior
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd, squared_shiftedlaplace_fd
from multigridmc_tpu_torch.ops.band import band_factor, band_solve

from test_torch_common import CPU, measurement_params, to_port


def moments_inputs(op, n_meas, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=op.vshape), rng.normal(size=n_meas), rng.normal(size=op.vshape)


def dense_solve(op):
    """A solver of the stencil part by its dense float64 inverse."""
    dense = np.linalg.inv(op.to_dense_stencil())
    return lambda v: (dense @ np.asarray(v).reshape(-1)).reshape(op.vshape)


def dense_moments(op, xbar, y, w):
    """``observed_mean_and_variance`` with the stencil solved densely."""
    return posterior.observed_mean_and_variance(op, xbar, y, w, solve=dense_solve(op))


def test_band_moments_of_the_squared_operator_match_a_dense_solve():
    """66x66 lattice, 65^2 = 4225 unknowns: the band route (bandwidth 2 x 65)."""
    prior = squared_shiftedlaplace_fd(Lattice((66, 66)), ConstantCorrelationLengthModel(0.2),
                                      device=CPU, dtype=torch.float64)
    op = posterior.measured_operator(prior, measurement_params(n_meas=4, variance="near_exact"))
    assert op.lattice.nvertex > posterior.DENSE_SOLVE_MAX_N
    cb, b = band_factor(op)
    assert b == 2 * 65
    B = op.lowrank.B.numpy().reshape(4, -1)
    X = band_solve(cb, B.T)
    A = op.to_dense_stencil()
    rel = np.linalg.norm(B.T - A @ X, axis=0) / np.linalg.norm(B.T, axis=0)
    assert rel.max() <= 1e-10
    xbar, y, w = moments_inputs(op, 4, seed=8)
    np.testing.assert_allclose(posterior.observed_mean_and_variance(op, xbar, y, w),
                               dense_moments(op, xbar, y, w), rtol=1e-10)
    want = posterior.posterior_mean(op, xbar, y, solve=dense_solve(op))
    np.testing.assert_allclose(posterior.posterior_mean(op, xbar, y), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_band_moments_match_the_jax_cg_where_it_converges():
    """65^2 FD posterior: the JAX package's CG converges there."""
    prior = jshiftedlaplace_fd(JLattice((66, 66)), JConstant(0.2), dtype=jnp.float64)
    a = jposterior.measured_operator(prior, measurement_params(n_meas=5, seed=9,
                                                               variance="near_exact"))
    b = to_port(a)
    assert b.lattice.nvertex > posterior.DENSE_SOLVE_MAX_N
    xbar, y, w = moments_inputs(b, 5, seed=10)
    np.testing.assert_allclose(posterior.observed_mean_and_variance(b, xbar, y, w),
                               jposterior.observed_mean_and_variance(a, xbar, y, w), rtol=1e-8)
    np.testing.assert_allclose(posterior.posterior_mean(b, xbar, y),
                               np.asarray(jposterior.posterior_mean(a, xbar, y)),
                               rtol=1e-8, atol=1e-10)


def fd_3d(n):
    prior = shiftedlaplace_fd(Lattice((n, n, n)), ConstantCorrelationLengthModel(0.3),
                              device=CPU, dtype=torch.float64)
    return posterior.measured_operator(prior, measurement_params(n_meas=3, seed=11, dim=3))


def test_3d_moments_by_converged_cg_match_a_dense_solve():
    """18^3 lattice, 17^3 = 4913 unknowns: CG (a 3d band would be large)."""
    op = fd_3d(18)
    assert op.lattice.nvertex > posterior.DENSE_SOLVE_MAX_N
    xbar, y, w = moments_inputs(op, 3, seed=12)
    np.testing.assert_allclose(posterior.observed_mean_and_variance(op, xbar, y, w),
                               dense_moments(op, xbar, y, w), rtol=1e-9)


def test_3d_cg_that_does_not_converge_raises(monkeypatch):
    op = fd_3d(18)
    monkeypatch.setattr(posterior, "CG_MAXITER", 3)
    xbar, y, w = moments_inputs(op, 3, seed=13)
    with pytest.raises(RuntimeError, match=r"stopped after 3 iterations .*relative residual"):
        posterior.observed_mean_and_variance(op, xbar, y, w)
    with pytest.raises(RuntimeError, match="CG"):
        posterior.posterior_mean(op, xbar, y)
