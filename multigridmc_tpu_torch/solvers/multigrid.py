"""Multigrid hierarchy.

Counterpart of ``MultigridHierarchy`` in ``multigridmc_tpu/solvers/multigrid.py``:
the level stack of Galerkin-coarsened operators shared by the MGMC sampler and
(in a later slice of the port) the deterministic multigrid preconditioner.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..ops.coarsen import galerkin_coarsen
from ..ops.stencil import StencilOperator


class MultigridHierarchy:
    """Level stack of Galerkin-coarsened operators.  ``operators`` may be given
    ready-made (see :func:`multigridmc_tpu_torch.convert.hierarchy_from_numpy`);
    otherwise level ``l+1`` is ``galerkin_coarsen`` of level ``l``."""

    def __init__(self, op: StencilOperator, nlevel: int, device=None, dtype=None,
                 operators: Optional[Sequence[StencilOperator]] = None):
        if nlevel < 1:
            raise ValueError("nlevel must be >= 1")
        if operators is not None:
            if len(operators) != nlevel:
                raise ValueError(
                    f"{len(operators)} operators given for {nlevel} levels")
            ops: List[StencilOperator] = [o.to(device, dtype) for o in operators]
        else:
            ops = [op.to(device, dtype)]
            for _ in range(1, nlevel):
                ops.append(galerkin_coarsen(ops[-1]))
        self.operators = ops
        self.nlevel = nlevel

    def __len__(self) -> int:
        return self.nlevel
