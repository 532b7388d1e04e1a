"""Deterministic multigrid solve driver.

Counterpart of ``multigridmc_tpu/drivers/mg.py``: build the operator from the
config, solve ``A x = b`` with multigrid-preconditioned Richardson for a random
rhs, and write ``solution.vtk``.

Usage: ``python -m multigridmc_tpu_torch.drivers.mg CONFIGFILE [--device cpu]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..solvers.loop import IterativeSolverParameters, LoopSolver
from ..solvers.multigrid import MultigridPreconditioner
from ..utils.config import echo_config, load_config
from ..utils.runtime import configure_runtime, make_generator
from ..utils.vtk import VTKWriter
from .common import build_operators, parse_command_line, synchronize


def run(config, device, dtype, b=None):
    """Build the operator and the preconditioner of ``config``, solve
    ``A x = b`` and write ``solution.vtk``; returns the ``SolveResult``.
    ``b`` defaults to a random rhs ``N(0, 1)`` per vertex (seed 1482817)."""
    prior, op, mparams = build_operators(config, device, dtype)
    mg = config.multigrid
    t0 = time.perf_counter()
    preconditioner = MultigridPreconditioner(
        op,
        nlevel=mg.nlevel,
        smoother=mg.smoother,
        npresmooth=mg.npresmooth,
        npostsmooth=mg.npostsmooth,
        omega=mg.omega,
        cycle=mg.cycle,
        coarse_scaling=mg.coarse_scaling,
    )
    synchronize(op.device)
    print(f"multigrid setup time = {time.perf_counter() - t0:.3f} s")
    if preconditioner.distilled is not None:
        print(f"distilled deterministic subtree: level {preconditioner.distill_level}")

    it = config.iterative_solver
    solver = LoopSolver(
        op,
        preconditioner,
        IterativeSolverParameters(
            rtol=it.rtol, atol=it.atol, maxiter=it.maxiter, verbose=it.verbose
        ),
    )
    if b is None:
        b = torch.randn(op.vshape, dtype=op.dtype, device=op.device,
                        generator=make_generator(1482817, op.device))
    else:
        if not isinstance(b, torch.Tensor):
            b = torch.tensor(np.asarray(b))
        b = b.to(device=op.device, dtype=op.dtype)

    synchronize(op.device)
    t0 = time.perf_counter()
    # per-iteration reporting only when it was asked for (verbose >= 2 prints
    # the reference's residual / contraction table)
    result = solver.solve(b) if it.verbose >= 2 else solver.solve_jit(b)
    synchronize(op.device)
    print(f"solve time = {time.perf_counter() - t0:.3f} s")

    writer = VTKWriter("solution.vtk", op.lattice, 1)
    writer.add_state(result.x, "solution")
    writer.write()
    return result


def main(argv=None):
    configure_runtime()
    argv = argv if argv is not None else sys.argv[1:]
    path, device, dtype = parse_command_line(
        argv, "python -m multigridmc_tpu_torch.drivers.mg",
        "Multigrid-preconditioned Richardson solve of the configured operator")
    print()
    print("+---------------------------------+")
    print("! Multigrid solver (PyTorch/CUDA) !")
    print("+---------------------------------+")
    print()
    config = load_config(path)
    echo_config(config)
    print(f"device = {device}, dtype = {dtype}")
    run(config, device, dtype)


if __name__ == "__main__":
    main()
