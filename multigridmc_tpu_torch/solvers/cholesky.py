"""Direct Cholesky solver.

Counterpart of ``DenseCholeskySolver`` in ``multigridmc_tpu/solvers/cholesky.py``:
a dense LLT solve of the stencil part plus the precomputed Woodbury low-rank
correction

    B_bar = A^{-1} B (Sigma + B^T A^{-1} B)^{-1},     x = y - B_bar B^T y,   y = A^{-1} b.

Dense on-device factorisation: the right tool for the (tiny) coarsest
multigrid level.  The factorisation and the solves are library calls
(``torch.linalg``), as they are outside any kernel in the JAX package too.  The
band solver for large standalone systems belongs to a later slice of the port
(with the band-Cholesky sampler).
"""

from __future__ import annotations

import torch

from ..ops.stencil import StencilOperator


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
