"""State carried across from the JAX package: build the port's operators,
smoothers, preconditioners and configurations from plain numpy arrays and
dictionaries.

The parity tests call ``np.asarray`` on a JAX operator's ``coeffs``,
``lowrank.B`` and ``lowrank.Sigma_diag`` and pass ``offsets`` and
``lattice.shape``, so both sides run on identical operators; a smoother takes
the JAX smoother's ``B_bar`` (one per sweep direction), a preconditioner the
JAX hierarchy's levels, a ``Config`` the ``dataclasses.asdict`` of the JAX
package's; a distilled subtree takes the JAX package's ``(T, S^T)``, a
subtree kernel the levels, each direction's ``B_bar`` and the coarse Cholesky
factor.  Nothing here imports the JAX package.
"""

from __future__ import annotations

import typing
from typing import Optional, Sequence

import numpy as np
import torch

from .lattice import Lattice
from .ops.kernels.mgmc_subtree import SubtreeKernel
from .ops.stencil import LowRank, StencilOperator
from .samplers.distill import DistilledSubtree
from .smoothers import BACKWARD, FORWARD, SORSmoother, SSORSmoother
from .solvers.multigrid import MultigridHierarchy, MultigridPreconditioner
from .utils import config as config_module
from .utils.runtime import resolve_device, resolve_dtype


def operator_from_numpy(
    coeffs,
    offsets,
    lattice_shape,
    B=None,
    Sigma_diag=None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> StencilOperator:
    """A :class:`StencilOperator` from ``coeffs (n_offsets, *vshape)``, the
    offset tuples, the lattice's cell counts and, optionally, the low-rank
    factor ``B (m, *vshape)`` with ``Sigma_diag (m,)``.  The arrays are copied."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    lattice = Lattice(tuple(int(n) for n in lattice_shape))
    coeffs = np.asarray(coeffs)
    if coeffs.shape[1:] != lattice.vshape or coeffs.shape[0] != len(offsets):
        raise ValueError(
            f"coeffs {coeffs.shape} do not match {len(offsets)} offsets on "
            f"vertex shape {lattice.vshape}")
    if (B is None) != (Sigma_diag is None):
        raise ValueError("B and Sigma_diag are given together or not at all")
    lowrank = None
    if B is not None:
        B = np.asarray(B)
        if B.shape[1:] != lattice.vshape or B.shape[0] != len(np.asarray(Sigma_diag)):
            raise ValueError(f"B {B.shape} does not match the lattice / Sigma_diag")
        lowrank = LowRank(
            B=torch.tensor(B, dtype=dtype, device=device),
            Sigma_diag=torch.tensor(np.asarray(Sigma_diag), dtype=dtype, device=device))
    return StencilOperator(
        coeffs=torch.tensor(coeffs, dtype=dtype, device=device),
        offsets=tuple(tuple(int(o) for o in off) for off in offsets),
        lattice=lattice, lowrank=lowrank)


def hierarchy_from_numpy(levels: Sequence[dict], device=None, dtype=None) -> MultigridHierarchy:
    """A :class:`MultigridHierarchy` from one keyword dictionary per level, each
    holding the arguments of :func:`operator_from_numpy` (finest first)."""
    ops = [operator_from_numpy(device=device, dtype=dtype, **lv) for lv in levels]
    return MultigridHierarchy(ops[0], len(ops), operators=ops)


def _set_B_bar(smoother: SORSmoother, B_bar) -> None:
    op = smoother.op
    if (B_bar is None) != (op.lowrank is None):
        raise ValueError("B_bar is given exactly when the operator has a low-rank term")
    if B_bar is not None:
        B_bar = np.asarray(B_bar)
        if B_bar.shape != tuple(op.lowrank.B.shape):
            raise ValueError(f"B_bar {B_bar.shape} does not match B {tuple(op.lowrank.B.shape)}")
        smoother.B_bar = torch.tensor(B_bar, dtype=op.dtype, device=op.device)


def smoother_from_numpy(op: StencilOperator, omega: float, nsmooth: int = 1,
                        direction: str = FORWARD, B_bar=None) -> SORSmoother:
    """An :class:`SORSmoother` on ``op`` that carries the given Woodbury factor
    ``B_bar (m, *vshape)`` of its sweep direction instead of its own."""
    smoother = SORSmoother(op, omega, nsmooth, direction)
    _set_B_bar(smoother, B_bar)
    return smoother


def ssor_smoother_from_numpy(op: StencilOperator, omega: float, nsmooth: int = 1,
                             B_bar_forward=None, B_bar_backward=None) -> SSORSmoother:
    """An :class:`SSORSmoother` on ``op`` with the Woodbury factors of both
    directions given; each goes to its own direction's sweep."""
    smoother = SSORSmoother(op, omega, nsmooth)
    _set_B_bar(smoother.forward, B_bar_forward)
    _set_B_bar(smoother.backward, B_bar_backward)
    return smoother


def preconditioner_from_numpy(levels: Sequence[dict], device=None, dtype=None,
                              **kwargs) -> MultigridPreconditioner:
    """A :class:`MultigridPreconditioner` over the given levels (as
    :func:`hierarchy_from_numpy` takes them); ``kwargs`` are the
    preconditioner's own (smoother, omega, cycle, ...)."""
    hierarchy = hierarchy_from_numpy(levels, device=device, dtype=dtype)
    return MultigridPreconditioner(hierarchy.operators[0], hierarchy.nlevel,
                                   hierarchy=hierarchy, **kwargs)


def distilled_from_numpy(Tm, S_T, vshape, device=None, dtype=None,
                         precision: Optional[str] = None) -> DistilledSubtree:
    """A :class:`~multigridmc_tpu_torch.samplers.distill.DistilledSubtree` from
    the map's matrices: ``Tm (n, n)`` in the row-vector convention
    ``x = f @ Tm`` and the upper factor ``S_T (n, n)`` (``None`` for a
    deterministic map)."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    Tm = np.asarray(Tm)
    n = int(np.prod(vshape))
    if Tm.shape != (n, n) or (S_T is not None and np.asarray(S_T).shape != (n, n)):
        raise ValueError(f"T and S^T must be ({n}, {n}) for the vertex shape {tuple(vshape)}")
    S = None if S_T is None else torch.tensor(np.asarray(S_T), dtype=dtype, device=device)
    info = dict(n=n, K=None, noise=S_T is not None)
    return DistilledSubtree(torch.tensor(Tm, dtype=dtype, device=device), S,
                            tuple(int(v) for v in vshape), info, precision=precision)


def subtree_kernel_from_numpy(levels: Sequence[dict], B_bar_pre: Sequence, B_bar_post: Sequence,
                              coarse_L, omega: float, cycle: int, coarse_scaling: float,
                              device=None, dtype=None, **kwargs) -> SubtreeKernel:
    """A :class:`~multigridmc_tpu_torch.ops.kernels.mgmc_subtree.SubtreeKernel`
    over the given levels (as :func:`hierarchy_from_numpy` takes them: the
    hierarchy below its finest level, coarsest last), with the forward
    (``B_bar_pre``) and backward (``B_bar_post``) Woodbury factors of every
    level but the last and the coarsest level's Cholesky factor ``coarse_L``."""
    ops = hierarchy_from_numpy(levels, device=device, dtype=dtype).operators
    pre = [smoother_from_numpy(op, omega, 1, FORWARD, bb) for op, bb in zip(ops, B_bar_pre)]
    post = [smoother_from_numpy(op, omega, 1, BACKWARD, bb) for op, bb in zip(ops, B_bar_post)]
    return SubtreeKernel(ops, pre, post, np.asarray(coarse_L), omega, cycle, coarse_scaling,
                         **kwargs)


def config_from_dict(groups: dict) -> config_module.Config:
    """A :class:`~multigridmc_tpu_torch.utils.config.Config` from a nested
    dictionary ``{group: {field: value}}``, e.g. ``dataclasses.asdict`` of a
    parsed configuration.  Every group and every field must be present."""
    classes = typing.get_type_hints(config_module.Config)
    return config_module.Config(
        **{name: cls(**groups[name]) for name, cls in classes.items()})
