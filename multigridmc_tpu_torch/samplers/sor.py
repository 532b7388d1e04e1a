"""Multi-colour SOR and SSOR Gibbs samplers.

Counterpart of ``multigridmc_tpu/samplers/sor.py``.  One stochastic sweep:

    c   = f + sqrt(D (2 - omega) / omega) . xi,      xi ~ N(0, I_n)
    x  <- SOR_sweep(c, x)                            (multi-colour, stencil part)
    x  <- x - B_bar (B^T x - Sigma^{1/2} n),         n ~ N(0, I_m)   [low-rank]

with D the diagonal of the stencil part.  This is Gibbs sampling via the matrix
splitting ``M = D/omega + L_c + B Sigma^{-1} B^T`` (Fox & Parker 2017): the
injected noise covariance ``M + M^T - A = D (2-omega)/omega + B Sigma^{-1} B^T``
is exactly reproduced by the two noise terms, so the stationary distribution is
the exact target ``N(A^{-1} f, A^{-1})`` for *any* colour order.

The JAX package adds the low-rank noise to the rhs as ``B Sigma^{-1/2} n``.
The sweep is linear and ``B_bar = Y W`` with ``Y = M^{-1} B``, ``W = (Sigma +
B^T Y)^{-1}``, so carrying ``Sigma^{1/2} n`` into the Woodbury correction gives
the same ``x'`` (``Y (I - W B^T Y) = Y W Sigma``), from the same draws in the
same order.  In float32 the rhs form does not: at a measured vertex with
``Sigma`` about 1e-6 its term is about 1e3 and the correction must cancel it to
about 1e-3.  In float64 the two agree with the JAX package to rounding.

All sweeps take arbitrary leading batch (chain) dimensions.  On a CUDA device
in float32 every 2d or 3d sweep is one launch of the hand-written Gibbs sweep
kernel (:mod:`multigridmc_tpu_torch.ops.kernels.sor_sweep`), which draws the
field noise ``xi`` itself; the low-rank noise term and the Woodbury correction
stay outside the kernel.  A single chain is a batch of one.  Where the kernel
runs, ``apply`` updates the ``x`` it is given in place.

The SSOR sampler is a forward Gibbs sweep followed by a backward one; the two
sweeps draw independent noise (two launch counters of the Philox stream) and
each applies the Woodbury factor of its own direction.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.coloring import Coloring, coloring_for
from ..ops.kernels.sor_sweep import flatten_chains, gibbs_sweep_batched
from ..ops.stencil import StencilOperator
from ..smoothers import BACKWARD, FORWARD, SORSmoother
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
            self.Sigma_sqrt = torch.sqrt(op.lowrank.Sigma_diag)

    def lowrank_shift(self, noise: NoiseSource, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The sweep's low-rank draw ``n`` (``(*batch, m)``, the batch of the
        chain state ``x``) as the Woodbury correction takes it, ``Sigma^{1/2}
        n``; ``None`` without measurements.  Drawn after the field."""
        op = self.op
        if op.lowrank is None:
            return None
        batch = x.shape[: x.ndim - len(op.vshape)]
        return noise.normal(batch + (op.m_lowrank,), x.dtype, x.device) * self.Sigma_sqrt

    def _apply_plain(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One Gibbs sweep in plain PyTorch.  The batch (chain) shape is taken
        from the chain state x, so an unbatched f broadcasts over many chains
        with *independent* noise per chain.  Draw order: the field, then the
        low-rank scalars."""
        sm = self.smoother
        xi = noise.normal(x.shape, x.dtype, x.device)
        shift = self.lowrank_shift(noise, x)
        x = sm.sweep_stencil(f + self.sqrt_precision_diag * xi, x)
        if sm.B_bar is not None:
            x = sm._lowrank_correct(x, shift)
        return x

    def _apply_kernel(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One Gibbs sweep through the sweep kernel: the diagonal noise is
        drawn inside the kernel (or, for a noise source without a Philox
        stream, fed to it as a tensor); the low-rank noise enters the Woodbury
        correction outside.  Draw order as :meth:`_apply_plain`: the field,
        then the low-rank scalars."""
        op, sm = self.op, self.smoother
        philox = noise.philox_stream()
        xi = None if philox is not None else noise.normal(x.shape, x.dtype, x.device)
        shift = self.lowrank_shift(noise, x)
        cf, xf, batch = flatten_chains(op.vshape, f, x)
        if xi is not None:
            xi = xi.reshape(xf.shape).contiguous()
        x = gibbs_sweep_batched(sm.plan, cf, xf, xi=xi, philox=philox)
        x = x.reshape(batch + op.vshape)
        if sm.B_bar is not None:
            x = sm._lowrank_correct(x, shift)
        return x

    def apply(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.nsmooth):
            if self.smoother.plan.on_kernel_device():
                x = self._apply_kernel(noise, f, x)
            else:
                x = self._apply_plain(noise, f, x)
        return x


class SSORSampler(Sampler):
    """Forward Gibbs sweep then backward Gibbs sweep per step."""

    def __init__(
        self,
        op: StencilOperator,
        omega: float = 1.0,
        nsmooth: int = 1,
        coloring: Optional[Coloring] = None,
        device=None,
        dtype=None,
    ):
        op = op.to(device, dtype)
        super().__init__(op)
        self.nsmooth = int(nsmooth)
        coloring = coloring or coloring_for(op.offsets, op.vshape)
        self.forward = SORSampler(op, omega, 1, FORWARD, coloring)
        self.backward = SORSampler(op, omega, 1, BACKWARD, coloring)

    def apply(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.nsmooth):
            x = self.forward.apply(noise, f, x)
            x = self.backward.apply(noise, f, x)
        return x


def sampler_factory(name: str, omega: float, nsmooth: int, direction: str = FORWARD):
    """Returns a callable ``(op, coloring=None) -> sampler`` for per-level
    instantiation."""
    name = name.upper()
    if name == "SOR":
        return lambda op, coloring=None: SORSampler(op, omega, nsmooth, direction, coloring)
    if name == "SSOR":
        return lambda op, coloring=None: SSORSampler(op, omega, nsmooth, coloring)
    raise ValueError(f"unknown sampler '{name}'")
