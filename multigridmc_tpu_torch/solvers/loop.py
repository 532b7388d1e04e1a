"""Iterative solvers: preconditioned Richardson (LoopSolver) and CG.

Counterpart of ``multigridmc_tpu/solvers/loop.py``.  Two execution modes of the
Richardson iteration:

* :meth:`LoopSolver.solve` - per-iteration residual / contraction-rate
  reporting (the reference's verbose table); the residual norm is read back to
  the host once per iteration;
* :meth:`LoopSolver.solve_jit` - the production loop.  The JAX package runs it
  as one device-resident ``lax.while_loop``; its counterpart here enqueues the
  iterations eagerly and reads the residual norm back once per iteration,
  nothing else crosses to the host and nothing is printed per iteration.  The
  name is kept so that a reader finds it.

The residual convention matches the reference: ``r = A x - b``, update
``x <- x - P r``, converged when ``||r||/||r_0|| < rtol`` and ``||r|| < atol``.

A preconditioned conjugate-gradient solver is provided as well - the natural
companion for SPD lattice systems; the exact posterior moments of large
lattices use it without a preconditioner.

A right-hand side with leading batch dimensions is solved as ONE system by
``LoopSolver`` (one norm over everything, as the JAX package does) and as
independent systems in lockstep by ``CGSolver.solve(..., batched=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class IterativeSolverParameters:
    rtol: float = 1e-12
    atol: float = 1e-15
    maxiter: int = 100
    verbose: int = 0


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    converged: bool
    niter: int
    rnorm: float
    rnorm_history: Optional[list] = None


def _report(p: IterativeSolverParameters, converged: bool, niter: int, r_nrm: float,
            r0_nrm: float) -> None:
    if p.verbose >= 1:
        if converged:
            print(f"Solver converged after {niter:5d} iterations")
            print(f"||r|| = {r_nrm:8.3e}, ||r||/||r_0|| = {r_nrm / r0_nrm:8.3e}")
        else:
            print(f"Solver failed to converge after {p.maxiter:5d} iterations")


class LoopSolver:
    """Preconditioned Richardson iteration."""

    def __init__(self, op, preconditioner, params: IterativeSolverParameters = None):
        self.op = op
        self.preconditioner = preconditioner
        self.params = params or IterativeSolverParameters()

    def solve(self, b: torch.Tensor) -> SolveResult:
        p = self.params
        r0_nrm = float(torch.linalg.vector_norm(b))
        if p.verbose >= 2:
            print(f"Initial residual ||r_0|| = {r0_nrm:12.4f}")
            print(f"{'iter':>5}   {'||r||':>8}   {'||r||/||r_0||':>12}   {'rho':>6}")
        x = torch.zeros_like(b)
        rold_nrm = r0_nrm
        history = []
        converged, niter, r_nrm = False, p.maxiter, r0_nrm
        for k in range(p.maxiter):
            # one operator application + one preconditioner cycle per iteration;
            # r serves both the norm and the update
            r = self.op.apply(x) - b
            r_nrm = float(torch.linalg.vector_norm(r))
            history.append(r_nrm)
            if p.verbose >= 2:
                print(f"{k:5d}   {r_nrm:8.3e}   {r_nrm / r0_nrm:12.3e}   {r_nrm / rold_nrm:6.3f}")
            if r_nrm / r0_nrm < p.rtol and r_nrm < p.atol:
                converged, niter = True, k
                break
            rold_nrm = r_nrm
            x = x - self.preconditioner.apply(r)
        _report(p, converged, niter, r_nrm, r0_nrm)
        return SolveResult(x, converged, niter, r_nrm, history)

    def solve_jit(self, b: torch.Tensor) -> SolveResult:
        """The production loop: one operator application per iteration (the
        residual is carried), the residual norm read back once per iteration."""
        p = self.params
        r0_nrm = float(torch.linalg.vector_norm(b))

        def done(r_nrm):
            return r_nrm / r0_nrm < p.rtol and r_nrm < p.atol

        x = torch.zeros_like(b)
        r = -b  # residual at x = 0
        k, r_nrm = 0, r0_nrm
        while k < p.maxiter and not done(r_nrm):
            x = x - self.preconditioner.apply(r)
            r = self.op.apply(x) - b
            k += 1
            r_nrm = float(torch.linalg.vector_norm(r))
        converged = done(r_nrm)
        _report(p, converged, k, r_nrm, r0_nrm)
        return SolveResult(x, converged, k, r_nrm)


class CGSolver:
    """Preconditioned conjugate gradients for the SPD lattice systems."""

    def __init__(self, op, preconditioner=None, params: IterativeSolverParameters = None):
        self.op = op
        self.preconditioner = preconditioner
        self.params = params or IterativeSolverParameters()

    def solve(self, b: torch.Tensor, batched: bool = False) -> SolveResult:
        """Solve ``A x = b``.  With ``batched=True`` the leading dims of ``b``
        index independent right-hand sides that are solved in lockstep, each
        with its own step lengths, until all have converged; ``rnorm`` is then
        the largest residual norm."""
        p = self.params
        vdim = len(self.op.vshape)
        dims = tuple(range(b.ndim - vdim, b.ndim)) if batched else None

        def dot(u, v):
            return (u * v).sum(dim=dims, keepdim=batched)

        def precond(r):
            return self.preconditioner.apply(r) if self.preconditioner else r

        def norm(r):
            return torch.linalg.vector_norm(r, dim=dims)

        def converged_mask(rn):
            return (rn / r0_nrm < p.rtol) & (rn < p.atol)

        x = torch.zeros_like(b)
        r = b
        z = precond(r)
        d = z
        rz = dot(r, z)
        r0_nrm = norm(b)
        k, rn = 0, r0_nrm
        finished = converged_mask(rn)
        while k < p.maxiter and not bool(finished.all()):
            Ad = self.op.apply(d)
            alpha = rz / dot(d, Ad)
            if batched:  # a system that has converged stands still
                alpha = torch.where(finished.reshape(alpha.shape), torch.zeros_like(alpha), alpha)
            x = x + alpha * d
            r = r - alpha * Ad
            z = precond(r)
            rz_new = dot(r, z)
            d = z + (rz_new / rz) * d
            rz = rz_new
            k += 1
            rn = norm(r)
            finished = converged_mask(rn)
        converged = bool((rn / r0_nrm < p.rtol).all())
        return SolveResult(x, converged, k, float(rn.max()))
