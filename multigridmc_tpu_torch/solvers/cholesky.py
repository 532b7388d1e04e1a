"""Direct Cholesky solver.

Counterpart of ``DenseCholeskySolver`` in ``multigridmc_tpu/solvers/cholesky.py``:
a dense LLT solve of the stencil part plus the precomputed Woodbury low-rank
correction

    B_bar = A^{-1} B (Sigma + B^T A^{-1} B)^{-1},     x = y - B_bar B^T y,   y = A^{-1} b.

Two backends, as for the samplers (:mod:`multigridmc_tpu_torch.samplers.cholesky`):

* :class:`DenseCholeskySolver` - dense on-device factorisation, the right tool
  for the (tiny) coarsest multigrid level;
* :class:`BandCholeskySolver` - the lexicographic band factorisation of the
  stencil part (its exact sparse factor: all fill-in stays inside the band),
  factorised and solved in float64 on the host
  (:class:`~multigridmc_tpu_torch.samplers.cholesky.BandWoodbury`), for large
  standalone systems.

The factorisations and the solves are library calls (``torch.linalg``,
``scipy.linalg``), as they are outside any kernel in the JAX package too.
"""

from __future__ import annotations

import torch

from ..ops.stencil import StencilOperator
from ..samplers.cholesky import BandWoodbury


class DenseCholeskySolver:
    """Dense LLT solve of the stencil part + Woodbury low-rank correction."""

    def __init__(self, op: StencilOperator, device=None, dtype=None):
        op = op.to(device, dtype)
        self.op = op
        A = torch.as_tensor(op.to_dense_stencil(), dtype=op.dtype, device=op.device)
        self.L = torch.linalg.cholesky(A)
        self.B_bar = None
        if op.lowrank is not None:
            B = op.lowrank.B.reshape(op.m_lowrank, -1).T  # (n, m)
            Ainv_B = torch.cholesky_solve(B, self.L)
            S = torch.diag(op.lowrank.Sigma_diag) + B.T @ Ainv_B
            self.B_bar = Ainv_B @ torch.linalg.inv(S)  # (n, m)
            self.B_flat = B.contiguous()

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        """Solve ``A x = b`` for a grid field b, supporting leading batch dims."""
        n = self.L.shape[0]
        bf = b.reshape((-1, n)).T  # (n, nbatch)
        y = torch.cholesky_solve(bf, self.L)
        if self.B_bar is not None:
            y = y - self.B_bar @ (self.B_flat.T @ y)
        return y.T.reshape(b.shape)


class BandCholeskySolver:
    """Band (``"sparse"``) direct solver for large lattice systems: the band
    factor of the stencil part plus the Woodbury correction
    ``x = y - B_bar (B^T y)``, ``y = A^-1 b``, all in float64 on the host
    (:class:`~multigridmc_tpu_torch.samplers.cholesky.BandWoodbury`: with
    near-exact measurements the correction cancels almost completely, which
    float32 cannot resolve); the solution comes back in the operator's dtype on
    its device.  ``B_bar`` is the float64 ``(n, m)`` array."""

    def __init__(self, op: StencilOperator, device=None, dtype=None):
        op = op.to(device, dtype)
        self.op = op
        self.host = BandWoodbury(op)
        self.bandwidth = self.host.bandwidth
        self.B_bar = self.host.W

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        """Solve ``Q x = b`` for a grid field b, supporting leading batch dims."""
        x = self.host.solve(b.reshape(-1, self.host.n), self.op.dtype, self.op.device)
        return x.reshape(b.shape)
