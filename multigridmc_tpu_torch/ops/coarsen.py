"""Galerkin coarsening of stencil operators by probing.

Counterpart of ``multigridmc_tpu/ops/coarsen.py``.  ``R A P`` is itself a local
stencil operator: with d-linear transfer (reach 1 fine vertex) and a fine
stencil of reach ``s``, the coarse stencil has reach ``s_c = (s + 2) // 2``
coarse vertices.  The coarse coefficients are extracted *exactly* with
``(2 s_c + 1)^d`` probing vectors: probe ``v_r`` is the indicator of the
sub-lattice ``{ j : j = r mod p }`` with period ``p = 2 s_c + 1`` per dimension,
so ``(R A P v_r)[j] = A_c[j, j + o]`` with ``o = (r - j) mod p`` mapped to
``[-s_c, s_c]``.  The probe axis is just a leading batch dimension here.

The low-rank factor coarsens column-wise: ``B_c = R B``, ``Sigma_c = Sigma``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .intergrid import prolongate, restrict
from .stencil import LowRank, StencilOperator


def _stencil_reach(offsets) -> int:
    return max(max(abs(o) for o in off) for off in offsets)


def galerkin_coarsen(op: StencilOperator) -> StencilOperator:
    """Coarsen ``A -> R A P`` (and ``B -> R B``) onto the next-coarser lattice."""
    fine = op.lattice
    coarse = fine.coarsen()
    dim = fine.dim
    s_c = (_stencil_reach(op.offsets) + 2) // 2
    p = 2 * s_c + 1

    cvshape = coarse.vshape
    dtype, device = op.coeffs.dtype, op.coeffs.device

    # all p^d probe vectors on the coarse grid (one-hot residue classes)
    residues = list(itertools.product(range(p), repeat=dim))
    idx_grids = np.meshgrid(*[np.arange(m) for m in cvshape], indexing="ij")
    probes = []
    for r in residues:
        mask = np.ones(cvshape, dtype=bool)
        for ax in range(dim):
            mask &= (idx_grids[ax] % p) == r[ax]
        probes.append(mask.astype(np.float64))
    probes = torch.as_tensor(np.stack(probes), dtype=dtype, device=device)

    # (p^d, *cvshape): the probe axis rides along as a batch dimension
    W = restrict(op.apply_stencil(prolongate(probes, fine.vshape)), dim=dim)

    # coeff_o[j] = W[class((j + o) mod p)][j]
    offsets = sorted(itertools.product(range(-s_c, s_c + 1), repeat=dim))
    cls_all = []
    for off in offsets:
        cls = np.zeros(cvshape, dtype=np.int64)
        for ax in range(dim):
            cls = cls * p + (idx_grids[ax] + off[ax]) % p
        cls_all.append(cls)
    cls_all = torch.as_tensor(np.stack(cls_all), device=device)  # (n_off, *cvshape)
    coeffs = torch.take_along_dim(W, cls_all, dim=0)

    lowrank = None
    if op.lowrank is not None:
        lowrank = LowRank(B=restrict(op.lowrank.B, dim=dim),
                          Sigma_diag=op.lowrank.Sigma_diag)

    return StencilOperator(
        coeffs=coeffs, offsets=tuple(offsets), lattice=coarse, lowrank=lowrank
    ).normalized()
