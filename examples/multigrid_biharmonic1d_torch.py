"""Multigrid for the 1d biharmonic equation on the PyTorch port.

Counterpart of ``examples/multigrid_biharmonic1d.py``: the 1d biharmonic
operator is a custom 5-point ``StencilOperator``, and the port's multigrid
stack (multi-colour SSOR smoothers, Galerkin probing, W-cycle, Richardson
loop) takes it unchanged.  In 1d no sweep kernel exists (the kernels take 2d
and 3d fields), so the sweeps are the plain PyTorch version on any device.
The arithmetic is float64, as in the JAX example.

Run: ``python examples/multigrid_biharmonic1d_torch.py [n] [--device cpu]``
(the card by default).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.ops.stencil import StencilOperator
from multigridmc_tpu_torch.solvers.loop import IterativeSolverParameters, LoopSolver
from multigridmc_tpu_torch.solvers.multigrid import MultigridPreconditioner
from multigridmc_tpu_torch.utils.runtime import resolve_device


def biharmonic_1d(n: int, device=None, dtype=torch.float64) -> StencilOperator:
    """u'''' with the 5-point stencil [1, -4, 6, -4, 1] / h^4, entries outside
    the grid dropped."""
    lattice = Lattice((n,))
    m = lattice.nvertex
    h4 = float(n) ** 4
    coeffs = torch.stack([torch.full((m,), c * h4, dtype=dtype, device=device)
                          for c in (1.0, -4.0, 6.0, -4.0, 1.0)])
    return StencilOperator(coeffs=coeffs, offsets=((-2,), (-1,), (0,), (1,), (2,)),
                           lattice=lattice).normalized()


def solve(n: int = 256, device=None, maxiter: int = 30):
    """The example's solve: a 4-level W-cycle with 4 SSOR sweeps before and
    after as the preconditioner of Richardson (at most ``maxiter`` cycles), on
    a normal right-hand side drawn with numpy from seed 0.  Returns the
    solver's result and the contraction rates of the first cycles."""
    device = resolve_device(device)
    op = biharmonic_1d(n, device)
    precond = MultigridPreconditioner(op, nlevel=4, smoother="SSOR", npresmooth=4,
                                      npostsmooth=4, cycle=2, distill=False)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=op.vshape), dtype=torch.float64,
                        device=device)
    solver = LoopSolver(op, precond, IterativeSolverParameters(rtol=1e-10, atol=1e-30,
                                                               maxiter=maxiter, verbose=0))
    result = solver.solve(b)
    h = result.rnorm_history
    rates = [h[k + 1] / h[k] for k in range(1, min(len(h) - 1, 10))]
    return result, rates


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=256)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    result, rates = solve(args.n, args.device)
    print(f"converged={result.converged} after {result.niter} W-cycles, "
          f"contraction rho ~ {np.median(rates):.3f}")
    print("(point-smoother multigrid is a weak solver for the biharmonic operator; "
          "the 2d production path treats (-Lap+k^2)^2 only as a sampling precision "
          "operator)")


if __name__ == "__main__":
    main()
