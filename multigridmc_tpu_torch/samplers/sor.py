"""Multi-colour SOR Gibbs sampler.

Counterpart of ``multigridmc_tpu/samplers/sor.py``.  One stochastic sweep:

    c   = f + sqrt(D (2 - omega) / omega) . xi,      xi ~ N(0, I_n)
    c  += B Sigma^{-1/2} xi',                        xi' ~ N(0, I_m)   [low-rank]
    x  <- SOR_sweep(c, x)   (multi-colour, incl. Woodbury low-rank correction)

with D the diagonal of the stencil part.  This is Gibbs sampling via the matrix
splitting ``M = D/omega + L_c + B Sigma^{-1} B^T`` (Fox & Parker 2017): the
injected noise covariance ``M + M^T - A = D (2-omega)/omega + B Sigma^{-1} B^T``
is exactly reproduced by the two noise terms, so the stationary distribution is
the exact target ``N(A^{-1} f, A^{-1})`` for *any* colour order.

All sweeps take arbitrary leading batch (chain) dimensions.  The SSOR sampler
and the isolated Gibbs sweep kernels belong to a later slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.coloring import Coloring
from ..ops.stencil import StencilOperator
from ..smoothers import FORWARD, SORSmoother
from .base import NoiseSource, Sampler


class SORSampler(Sampler):
    """Forward or backward stochastic SOR (Gibbs) sweep."""

    def __init__(
        self,
        op: StencilOperator,
        omega: float = 1.0,
        nsmooth: int = 1,
        direction: str = FORWARD,
        coloring: Optional[Coloring] = None,
        device=None,
        dtype=None,
    ):
        self.smoother = SORSmoother(op, omega, 1, direction, coloring,
                                    device=device, dtype=dtype)
        op = self.smoother.op
        super().__init__(op)
        self.omega = float(omega)
        self.nsmooth = int(nsmooth)
        self.sqrt_precision_diag = torch.sqrt(
            op.diag_stencil() * (2.0 - self.omega) / self.omega)
        if op.lowrank is not None:
            self.Sigma_inv_sqrt = 1.0 / torch.sqrt(op.lowrank.Sigma_diag)

    def random_rhs(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The noisy right-hand side c.  The batch (chain) shape is taken from
        the chain state x, so an unbatched f broadcasts over many chains with
        *independent* noise per chain.  Draw order: the field, then the
        low-rank scalars."""
        op = self.op
        xi = noise.normal(x.shape, x.dtype, x.device)
        c = f + self.sqrt_precision_diag * xi
        if op.lowrank is not None:
            batch = x.shape[: x.ndim - len(op.vshape)]
            xi_lr = noise.normal(batch + (op.m_lowrank,), x.dtype, x.device)
            c = c + op.lowrank.expand(xi_lr * self.Sigma_inv_sqrt)
        return c

    def apply(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.nsmooth):
            x = self.smoother.apply(self.random_rhs(noise, f, x), x)
        return x
