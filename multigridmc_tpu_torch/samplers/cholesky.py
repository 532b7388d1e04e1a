"""Direct (exact) sampler via Cholesky factorisation of the precision matrix.

Counterpart of ``DenseCholeskySampler`` in ``multigridmc_tpu/samplers/cholesky.py``.
Given the full precision ``Q = A_stencil + B Sigma^{-1} B^T = L L^T``, a sample
is

    1. xi ~ N(0, I)
    2. solve L g = f
    3. solve L^T x = xi + g

Dense on-device factorisation: the right tool for the (tiny) coarsest
multigrid level.  The factorisation and the triangular solves are library
calls (``torch.linalg``), as they are outside any kernel in the JAX package
too.  The band-Cholesky sampler belongs to a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.stencil import StencilOperator
from .base import NoiseSource, Sampler


class DenseCholeskySampler(Sampler):
    """Densify the full precision (incl. low-rank) in float64 on the host,
    cast to the operator's dtype and factorise once at setup."""

    def __init__(self, op: StencilOperator, device=None, dtype=None):
        op = op.to(device, dtype)
        super().__init__(op)
        Q = torch.as_tensor(op.to_dense(), dtype=op.dtype, device=op.device)
        self.L = torch.linalg.cholesky(Q)  # Q = L L^T
        self._n = int(np.prod(op.vshape))

    def _solve_L(self, v: torch.Tensor) -> torch.Tensor:
        """Solve ``L g = v``; v has shape ``(*batch, n)``."""
        vt = v.reshape(-1, v.shape[-1]).T  # (n, batch)
        g = torch.linalg.solve_triangular(self.L, vt, upper=False)
        return g.T.reshape(v.shape)

    def _solve_LT(self, v: torch.Tensor) -> torch.Tensor:
        """Solve ``L^T x = v``."""
        vt = v.reshape(-1, v.shape[-1]).T
        y = torch.linalg.solve_triangular(self.L.T, vt, upper=True)
        return y.T.reshape(v.shape)

    def apply(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        vdim = len(self.op.vshape)
        n = self._n
        batch = x.shape[: x.ndim - vdim]
        fbatch = f.shape[: f.ndim - vdim]
        xi = noise.normal(batch + (n,), x.dtype, x.device)
        g = self._solve_L(f.reshape(fbatch + (n,)))
        y = self._solve_LT(xi + g)  # g broadcasts over the chain batch
        return y.reshape(x.shape)
