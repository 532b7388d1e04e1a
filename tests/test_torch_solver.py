"""The deterministic solver of the port against the JAX package, on the CPU in
float64: the dense Cholesky solver, one multigrid cycle
(``MultigridPreconditioner.apply``: SOR and SSOR, V and W, single and batched
right-hand sides; composed path and fused levels through the visit kernels'
plain versions) elementwise at ``rtol = 1e-10, atol = 1e-12`` (summation order
only), the Richardson and CG iterations to ``rtol = 1e-13`` within the JAX
iteration count +-1, and the exact posterior moments by the CG route (above
4096 unknowns) at ``rtol = 1e-8``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models import posterior as jposterior
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConstant
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshiftedlaplace_fd
from multigridmc_tpu.solvers.cholesky import DenseCholeskySolver as JDenseCholeskySolver
from multigridmc_tpu.solvers.loop import CGSolver as JCGSolver
from multigridmc_tpu.solvers.loop import IterativeSolverParameters as JParams
from multigridmc_tpu.solvers.loop import LoopSolver as JLoopSolver
from multigridmc_tpu.solvers.multigrid import MultigridPreconditioner as JPreconditioner

from multigridmc_tpu_torch.convert import preconditioner_from_numpy
from multigridmc_tpu_torch.models import posterior
from multigridmc_tpu_torch.solvers.cholesky import DenseCholeskySolver
from multigridmc_tpu_torch.solvers.loop import (CGSolver, IterativeSolverParameters, LoopSolver,
                                                SolveResult)
from multigridmc_tpu_torch.solvers.multigrid import MultigridHierarchy, MultigridPreconditioner

from test_torch_common import CPU, F64, assert_close, jax_operator, measurement_params, to_port, tt


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_dense_cholesky_solver_matches_jax(lowrank):
    a = jax_operator(12, lowrank)
    rng = np.random.default_rng(1)
    b = rng.normal(size=(3,) + a.vshape)
    want = JDenseCholeskySolver(a).apply(jnp.asarray(b))
    solver = DenseCholeskySolver(to_port(a))
    assert_close(solver.apply(tt(b)), want, **F64)
    assert_close(solver.apply(tt(b[0])), want[0], **F64)
    # it solves the full system, low-rank term included
    assert_close(solver.op.apply(solver.apply(tt(b))), b, rtol=1e-9, atol=1e-9)


def _levels(jprecond):
    out = []
    for op in jprecond.hierarchy.operators:
        lr = op.lowrank
        out.append(dict(coeffs=np.asarray(op.coeffs), offsets=op.offsets,
                        lattice_shape=op.lattice.shape,
                        B=None if lr is None else np.asarray(lr.B),
                        Sigma_diag=None if lr is None else np.asarray(lr.Sigma_diag)))
    return out


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)], ids=["single", "batch3", "batch2x2"])
@pytest.mark.parametrize("cycle", [1, 2], ids=["V", "W"])
@pytest.mark.parametrize("smoother", ["SOR", "SSOR"])
def test_preconditioner_apply_matches_jax(smoother, cycle, batch):
    a = jax_operator(16, True)
    kwargs = dict(smoother=smoother, omega=1.1, cycle=cycle, coarse_scaling=0.9)
    jprecond = JPreconditioner(a, 3, distill=False, fused=False, **kwargs)
    b = np.random.default_rng(2).normal(size=batch + a.vshape)
    want = jprecond.apply(jnp.asarray(b))
    # the port's own hierarchy, and the JAX hierarchy carried across
    for precond in (MultigridPreconditioner(to_port(a), 3, **kwargs),
                    preconditioner_from_numpy(_levels(jprecond), device=CPU,
                                              dtype=torch.float64, **kwargs)):
        assert precond.fused_levels == {}
        assert_close(precond.apply(tt(b)), want, **F64)
    # the levels through the fused visits (their plain versions here), noise
    # off: one sweep per visit (SOR) or a forward and a backward one (SSOR)
    fused = MultigridPreconditioner(to_port(a), 3, fused=True, **kwargs)
    assert sorted(fused.fused_levels) == [0, 1]
    assert fused.fused_levels[0].ndir == (2 if smoother == "SSOR" else 1)
    got = fused.apply(tt(b))
    assert got.shape == b.shape
    assert_close(got, want, **F64)


def test_preconditioner_options():
    op = to_port(jax_operator(16, False))
    assert MultigridPreconditioner(op, 2, distill="auto").fused_levels == {}
    # two levels are too shallow to distil; three distil the middle one when asked
    assert MultigridPreconditioner(op, 2, distill=True).distilled is None
    assert MultigridPreconditioner(op, 3, distill=True).distill_level == 1
    assert MultigridPreconditioner(op, 3, distill="auto").distilled is None  # the CPU: off
    with pytest.raises(ValueError, match="invalid distill"):
        MultigridPreconditioner(op, 3, distill="yes")
    with pytest.raises(ValueError, match="unknown smoother"):
        MultigridPreconditioner(op, 2, smoother="Jacobi")
    with pytest.raises(ValueError, match="operators given"):
        MultigridHierarchy(op, 3, operators=[op])


@pytest.mark.parametrize("smoother", ["SOR", "SSOR"])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_loop_solver_converges_like_jax(smoother, lowrank, capsys):
    a = jax_operator(32, lowrank)
    b = np.random.default_rng(3).normal(size=a.vshape)
    jres = JLoopSolver(a, JPreconditioner(a, 3, smoother=smoother, cycle=2, distill=False),
                       JParams(rtol=1e-13, atol=1e-9, maxiter=100)).solve(jnp.asarray(b))
    assert jres.converged
    op = to_port(a)
    precond = MultigridPreconditioner(op, 3, smoother=smoother, cycle=2)
    solver = LoopSolver(op, precond, IterativeSolverParameters(rtol=1e-13, atol=1e-9,
                                                               maxiter=100, verbose=2))
    res = solver.solve(tt(b))
    assert isinstance(res, SolveResult) and res.converged
    assert abs(res.niter - jres.niter) <= 1
    assert res.rnorm / np.linalg.norm(b) < 1e-13
    np.testing.assert_allclose(res.rnorm_history[:5], jres.rnorm_history[:5], rtol=1e-8)
    assert_close(res.x, jres.x, rtol=1e-9, atol=1e-11)
    text = capsys.readouterr().out
    assert "Initial residual ||r_0||" in text and "Solver converged after" in text
    assert len([ln for ln in text.splitlines() if ln.strip()[:1].isdigit()]) == res.niter + 1

    # the production loop: same iterates
    solver.params.verbose = 0
    jit = solver.solve_jit(tt(b))
    assert jit.converged and abs(jit.niter - res.niter) <= 1
    assert_close(jit.x, jres.x, rtol=1e-9, atol=1e-11)


def test_loop_solver_reports_failure(capsys):
    op = to_port(jax_operator(16, False))
    precond = MultigridPreconditioner(op, 2)
    res = LoopSolver(op, precond, IterativeSolverParameters(
        rtol=1e-13, atol=1e-30, maxiter=3, verbose=1)).solve(torch.ones(op.vshape,
                                                                        dtype=torch.float64))
    assert not res.converged and res.niter == 3 and len(res.rnorm_history) == 3
    assert "failed to converge after     3 iterations" in capsys.readouterr().out


@pytest.mark.parametrize("preconditioned", [False, True], ids=["plain", "multigrid"])
def test_cg_solver_converges_like_jax(preconditioned):
    a = jax_operator(32, True)
    b = np.random.default_rng(4).normal(size=a.vshape)
    params = dict(rtol=1e-13, atol=1e-9, maxiter=500)
    jprecond = JPreconditioner(a, 3, smoother="SSOR", distill=False) if preconditioned else None
    jres = JCGSolver(a, jprecond, JParams(**params)).solve(jnp.asarray(b))
    assert jres.converged
    op = to_port(a)
    precond = MultigridPreconditioner(op, 3, smoother="SSOR") if preconditioned else None
    res = CGSolver(op, precond, IterativeSolverParameters(**params)).solve(tt(b))
    assert res.converged and abs(res.niter - jres.niter) <= 1
    assert res.rnorm / np.linalg.norm(b) < 1e-13
    assert_close(res.x, jres.x, rtol=1e-8, atol=1e-10)


def test_batched_cg_solves_independent_systems():
    """``batched=True``: each right-hand side its own step lengths; a system
    that has converged stands still while the others go on."""
    op = to_port(jax_operator(24, False))
    rng = np.random.default_rng(5)
    b = rng.normal(size=(3,) + op.vshape)
    b[1] *= 1e-6  # converges (absolutely) long before the others
    params = IterativeSolverParameters(rtol=1e-12, atol=1e-8, maxiter=1000)
    res = CGSolver(op, None, params).solve(tt(b), batched=True)
    assert res.converged and bool(torch.isfinite(res.x).all())
    for k in range(3):
        single = CGSolver(op, None, params).solve(tt(b[k]))
        np.testing.assert_allclose(res.x[k].numpy(), single.x.numpy(), rtol=1e-7,
                                   atol=1e-9 * np.abs(b[k]).max())
    assert_close(op.apply(res.x), b, rtol=1e-7, atol=1e-8)


def test_exact_moments_by_the_cg_route_match_jax():
    """66x66 lattice (65^2 = 4225 unknowns): 4096 exceeded, so both packages solve with CG
    (``rtol = 1e-12, atol = 1e-30``, no preconditioner); float64 on both sides."""
    prior = jshiftedlaplace_fd(JLattice((66, 66)), JConstant(0.3), dtype=jnp.float64)
    a = jposterior.measured_operator(prior, measurement_params(n_meas=3, variance="small"))
    assert a.lattice.nvertex > posterior.DENSE_SOLVE_MAX_N
    rng = np.random.default_rng(6)
    xbar, y, w = rng.normal(size=a.vshape), rng.normal(size=3), rng.normal(size=a.vshape)
    b = to_port(a)
    np.testing.assert_allclose(posterior.posterior_mean(b, xbar, y),
                               np.asarray(jposterior.posterior_mean(a, xbar, y)),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(posterior.observed_mean_and_variance(b, xbar, y, w),
                               jposterior.observed_mean_and_variance(a, xbar, y, w), rtol=1e-8)
    # float64 moments whatever the sampler's dtype: a float32 operator differs
    # only by the rounding of its coefficients
    b32 = to_port(a, torch.float32)
    np.testing.assert_allclose(posterior.observed_mean_and_variance(b32, xbar, y, w),
                               posterior.observed_mean_and_variance(b, xbar, y, w), rtol=1e-4)
    # a solver given by the caller is used column by column
    calls = []
    dense = np.linalg.inv(b.to_dense_stencil())

    def solve(v):
        calls.append(np.asarray(v).shape)
        return (dense @ np.asarray(v).reshape(-1)).reshape(b.vshape)

    np.testing.assert_allclose(posterior.posterior_mean(b, xbar, y, solve=solve),
                               posterior.posterior_mean(b, xbar, y), rtol=1e-8, atol=1e-10)
    assert calls == [b.vshape] * 3
