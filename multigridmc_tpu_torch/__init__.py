"""multigridmc_tpu_torch - the PyTorch / CUDA port of ``multigridmc_tpu``.

Multigrid Monte Carlo sampling of lattice Gaussians
``pi(x) ~ exp(-1/2 x^T Q x + f^T x)`` on one NVIDIA Hopper GPU.  The layout
and the names follow the JAX package module for module, so a reader finds the
counterpart of every function; the tensor code is plain PyTorch and the
kernels - the fused level visits, the SOR / Gibbs sweeps, the coarse subtree
in one launch and the shared-memory probe - are CUDA C++ (``csrc/``, built at
first use).  The command-line programs are
``python -m multigridmc_tpu_torch.drivers.mgmc`` and ``...drivers.mg``.

The package imports ``torch``, numpy and scipy only - never ``jax`` and nothing
of ``multigridmc_tpu``.  Entry points that create tensors default to
``device="cuda"`` and ``dtype=torch.float32``; a missing GPU is an error, not a
silent move to the CPU (pass ``device="cpu"`` to ask for it).
"""

from .lattice import Lattice
from .ops.stencil import LowRank, StencilOperator
from .ops.intergrid import prolongate, prolongate_add, restrict
from .ops.coarsen import galerkin_coarsen
from .smoothers import SORSmoother, SSORSmoother
from .solvers.multigrid import MultigridHierarchy, MultigridPreconditioner
from .solvers.loop import CGSolver, IterativeSolverParameters, LoopSolver
from .samplers.base import GeneratorNoise, MeanShiftedSampler, ReplayNoise
from .samplers.sor import SORSampler, SSORSampler
from .samplers.cholesky import BandCholeskySampler, DenseCholeskySampler
from .samplers.mgmc import MultigridMCSampler

__version__ = "0.1.0"

__all__ = [
    "Lattice",
    "LowRank",
    "StencilOperator",
    "prolongate",
    "prolongate_add",
    "restrict",
    "galerkin_coarsen",
    "SORSmoother",
    "SSORSmoother",
    "MultigridHierarchy",
    "MultigridPreconditioner",
    "LoopSolver",
    "CGSolver",
    "IterativeSolverParameters",
    "GeneratorNoise",
    "ReplayNoise",
    "MeanShiftedSampler",
    "SORSampler",
    "SSORSampler",
    "DenseCholeskySampler",
    "BandCholeskySampler",
    "MultigridMCSampler",
]
