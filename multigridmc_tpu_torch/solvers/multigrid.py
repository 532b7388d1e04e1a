"""Multigrid hierarchy and the deterministic multigrid preconditioner.

Counterpart of ``multigridmc_tpu/solvers/multigrid.py``: the level stack of
Galerkin-coarsened operators shared by the MGMC sampler and the preconditioner,
and the deterministic V/W-cycle: per level a forward pre-smoother and a
backward post-smoother (SSOR: a forward-backward pair for both), a dense
Cholesky solve on the coarsest level.

On a CUDA device in float32 a level's visit (2d or 3d, SOR or SSOR with one
smoothing step) is one launch of the fused level-visit kernels with the noise
off (:mod:`multigridmc_tpu_torch.ops.kernels.mgmc_visit`); with more steps a
level smooths through the deterministic sweep kernel
(:mod:`multigridmc_tpu_torch.ops.kernels.sor_sweep`) and computes the residual
and the transfers in plain PyTorch.  A single right-hand side is a batch of one.
With ``distill`` the deterministic subtree below the distill level is one matrix
(:mod:`multigridmc_tpu_torch.samplers.distill` with the noise off): one matrix
product per invocation.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.coarsen import galerkin_coarsen
from ..ops.intergrid import prolongate_add, restrict
from ..ops.kernels.mgmc_visit import fused_levels_for
from ..ops.stencil import StencilOperator
from ..smoothers import BACKWARD, FORWARD, SORSmoother, SSORSmoother
from .cholesky import DenseCholeskySolver


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


class MultigridPreconditioner:
    """Deterministic multigrid V/W-cycle preconditioner.

    Parameters mirror the JAX package's: smoother ("SOR" forward-pre /
    backward-post, or "SSOR" both), npresmooth, npostsmooth, cycle (1=V, 2=W),
    coarse_scaling.  ``distill``: ``False`` never, ``True`` on any device,
    ``"auto"`` (default) on a CUDA device, at
    :func:`~multigridmc_tpu_torch.samplers.distill.pick_distill_level`.
    ``fused`` as in :class:`~multigridmc_tpu_torch.samplers.mgmc.MultigridMCSampler`.
    """

    def __init__(
        self,
        op: StencilOperator,
        nlevel: int,
        smoother: str = "SOR",
        npresmooth: int = 1,
        npostsmooth: int = 1,
        omega: float = 1.0,
        cycle: int = 1,
        coarse_scaling: float = 1.0,
        hierarchy: Optional[MultigridHierarchy] = None,
        distill: object = "auto",
        fused: object = "auto",
        fused_min_vertices: Optional[int] = None,
        device=None,
        dtype=None,
    ):
        op = op.to(device, dtype)
        self.hierarchy = hierarchy or MultigridHierarchy(op, nlevel)
        if self.hierarchy.operators[0].device != op.device:
            raise ValueError("hierarchy and operator lie on different devices")
        self.cycle = int(cycle)
        self.coarse_scaling = float(coarse_scaling)
        smoother = smoother.upper()
        self.presmoothers = []
        self.postsmoothers = []
        for level_op in self.hierarchy.operators:
            if smoother == "SOR":
                self.presmoothers.append(SORSmoother(level_op, omega, npresmooth, FORWARD))
                self.postsmoothers.append(SORSmoother(level_op, omega, npostsmooth, BACKWARD))
            elif smoother == "SSOR":
                self.presmoothers.append(SSORSmoother(level_op, omega, npresmooth))
                self.postsmoothers.append(SSORSmoother(level_op, omega, npostsmooth))
            else:
                raise ValueError(f"unknown smoother '{smoother}'")
        self.coarse_solver = DenseCholeskySolver(self.hierarchy.operators[-1])

        # the levels reuse the fused level-visit kernels with the noise off
        # (same gating as the MGMC sampler: one visit is one SOR sweep or one
        # SSOR pair)
        self.fused_levels = {}
        if npresmooth == 1 and npostsmooth == 1:
            self.fused_levels = fused_levels_for(
                self.hierarchy.operators, self.presmoothers, self.postsmoothers,
                self.coarse_scaling,
                0 if fused_min_vertices is None else int(fused_min_vertices),
                force=None if fused == "auto" else bool(fused),
            )
        self._build_distilled(distill)

    def _build_distilled(self, distill) -> None:
        """Distil the deterministic coarse subtree into one matrix (the
        noise-free variant of ``samplers/distill.py``); same gating as the
        sampler."""
        from ..samplers.distill import distill_subtree, resolve_distill_level

        self.distilled = None
        self.distill_level = resolve_distill_level(distill, self.hierarchy.operators)
        li = self.distill_level
        if li is not None:
            self.distilled = distill_subtree(
                self.hierarchy.operators[li:], self.presmoothers[li:], self.postsmoothers[li:],
                self.coarse_solver, self.cycle, self.coarse_scaling, noise=False)

    def _solve(self, level: int, b: torch.Tensor) -> torch.Tensor:
        """Recursive cycle; x is zero-initialised at every level entry."""
        nlevel = self.hierarchy.nlevel
        op = self.hierarchy.operators[level]
        if level == nlevel - 1:
            return self.coarse_solver.apply(b)
        x = torch.zeros_like(b)
        vdim = len(op.vshape)
        fused = self.fused_levels.get(level) if b.ndim == vdim + 1 else None
        ncycle = self.cycle if level > 0 else 1
        for _ in range(ncycle):
            if fused is not None:
                x, b_coarse = fused.descend(None, b, x)
            else:
                x = self.presmoothers[level].apply(b, x)
                r = b - op.apply(x)
                b_coarse = restrict(r, dim=vdim)
            if (self.distilled is not None and level + 1 == self.distill_level
                    and b_coarse.ndim > vdim):
                x_coarse = self.distilled.solve(b_coarse)
            else:
                x_coarse = self._solve(level + 1, b_coarse)
            if fused is not None:
                x = fused.ascend(None, b, x, x_coarse)
            else:
                x = prolongate_add(self.coarse_scaling, x_coarse, x, dim=vdim)
                x = self.postsmoothers[level].apply(b, x)
        return x

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        """One multigrid cycle applied to b (x implicitly zero-initialised)."""
        vshape = self.hierarchy.operators[0].vshape
        vdim = len(vshape)
        if (self.fused_levels and b.ndim != vdim + 1) or (self.distilled is not None
                                                          and b.ndim == vdim):
            # fused kernels take one flat batch axis (a single rhs is a batch of one)
            batch = b.shape[: b.ndim - vdim]
            out = self._solve(0, b.reshape((-1,) + vshape).contiguous())
            return out.reshape(batch + vshape)
        if self.fused_levels:
            b = b.contiguous()
        return self._solve(0, b)
