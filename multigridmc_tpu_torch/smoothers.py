"""Multi-colour SOR smoother.

Counterpart of ``multigridmc_tpu/smoothers.py``.  One sweep in a multi-colour
order (see :mod:`multigridmc_tpu_torch.ops.coloring`) is ``n_colors`` fully
parallel masked stencil applications:

    for colour c in order:
        x <- x + mask_c * omega * (b - A_stencil x) / diag

This is SOR with splitting ``M = D/omega + L_c`` where ``L_c`` is the strictly
block-lower part of ``A_stencil`` under the colour order.

Low-rank operators (posterior precision ``A = A_s + B Sigma^{-1} B^T``) use the
Woodbury-corrected splitting: the sweep runs on the stencil part only, then

    x <- x - B_bar (B^T x - s),        s = 0 (smoother), Sigma^{1/2} n (Gibbs sweep)
    B_bar = M^{-1} B (Sigma + B^T M^{-1} B)^{-1}

with ``M = L_c + D/omega`` (forward) or its transpose (backward) - ``B_bar``
therefore depends on the sweep direction.  ``M^{-1} B`` is computed at setup by
colour-ordered forward substitution, exact because M is block-triangular in the
colour order.

On a CUDA device in float32 every 2d or 3d sweep is one launch of the
hand-written deterministic sweep kernel
(:mod:`multigridmc_tpu_torch.ops.kernels.sor_sweep`), a single field as a batch
of one; the low-rank correction stays outside the kernel.  On the CPU, and in
float64, the sweep is the plain masked stencil loop :func:`sor_sweep`.  Where
the kernel runs, ``apply`` updates the ``x`` it is given in place; callers use
the returned tensor.

The SSOR smoother is a forward sweep followed by a backward sweep, each with
the Woodbury factor of its own direction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ops.coloring import Coloring, coloring_for
from .ops.kernels.sor_sweep import (SweepPlan, flatten_chains, sweep_batched,
                                    sweep_batched_plain)
from .ops.stencil import StencilOperator

FORWARD = "forward"
BACKWARD = "backward"


def color_order(n_colors: int, direction: str) -> Tuple[int, ...]:
    order = tuple(range(n_colors))
    return order if direction == FORWARD else tuple(reversed(order))


def splitting_solve(
    op: StencilOperator,
    masks: torch.Tensor,
    omega: float,
    order: Tuple[int, ...],
    v: torch.Tensor,
) -> torch.Tensor:
    """Solve ``(L_c + D/omega) y = v`` by colour-ordered forward substitution
    (leading batch dims of ``v`` ride along)."""
    diag = op.diag_stencil()
    y = torch.zeros_like(v)
    for c in order:
        s = op.apply_offdiag(y)
        y = y + masks[c] * ((v - s) * omega / diag)
    return y


#: one multi-colour SOR sweep on the stencil part, ``(op, masks, omega, order,
#: b, x) -> x``: the plain version of the deterministic sweep kernel
sor_sweep = sweep_batched_plain


def woodbury_factors(
    op: StencilOperator, masks: torch.Tensor, omega: float, order: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``Y = M^{-1} B`` (shape ``(m, *vshape)``) and
    ``W = (Sigma + B^T M^{-1} B)^{-1}`` (``m x m``) for one sweep direction, so
    that ``B_bar_k = sum_l W[l, k] Y_l``.  ``Y`` keeps the compact support of
    ``B`` (widened by the stencil once per colour), which the fused kernels
    exploit; ``B_bar`` mixes all columns.  The inverse is taken in the
    operator's dtype, as the JAX package does."""
    lr = op.lowrank
    m = lr.m
    Y = splitting_solve(op, masks, omega, order, lr.B)  # B's m axis is a batch dim
    S = torch.diag(lr.Sigma_diag) + lr.B.reshape(m, -1) @ Y.reshape(m, -1).T
    return Y, torch.linalg.inv(S)


def compute_B_bar(
    op: StencilOperator, masks: torch.Tensor, omega: float, order: Tuple[int, ...]
) -> torch.Tensor:
    """The Woodbury correction factor ``B_bar`` for one direction, shape
    ``(m, *vshape)``."""
    Y, W = woodbury_factors(op, masks, omega, order)
    return (W.T @ Y.reshape(op.lowrank.m, -1)).reshape(Y.shape)


class SORSmoother:
    """Deterministic multi-colour SOR smoother, forward or backward."""

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
        op = op.to(device, dtype)
        self.op = op
        self.omega = float(omega)
        self.nsmooth = int(nsmooth)
        self.direction = direction
        self.coloring = coloring or coloring_for(op.offsets, op.vshape)
        self.masks = torch.as_tensor(
            self.coloring.masks(), dtype=op.dtype, device=op.device)
        self.order = color_order(self.coloring.n_colors, direction)
        self.B_bar = (
            compute_B_bar(op, self.masks, self.omega, self.order)
            if op.lowrank is not None
            else None
        )
        #: the sweep kernels' view of this smoother (one direction)
        self.plan = SweepPlan(op, self.coloring, self.omega, self.order, self.masks)

    def sweep_stencil(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One sweep on the stencil part.  On a CUDA device in float32 this is
        one launch of the sweep kernel (``x`` is updated in place)."""
        if self.plan.on_kernel_device():
            bf, xf, batch = flatten_chains(self.op.vshape, b, x)
            return sweep_batched(self.plan, bf, xf).reshape(batch + self.op.vshape)
        return sor_sweep(self.op, self.masks, self.omega, self.order, b, x)

    def _lowrank_correct(self, x: torch.Tensor,
                         shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x - Y u`` with ``u = W (B^T x - shift)``, as ``B_bar`` applied to
        ``B^T x - shift``.  A Gibbs sweep hands its low-rank noise over as
        ``shift = Sigma^{1/2} n`` (``(*batch, m)``) instead of adding ``B
        Sigma^{-1/2} n`` to its rhs: the sweep is linear and ``Y = M^{-1} B``,
        so both give the same ``x'`` (``Y (I - W B^T Y) = Y W Sigma``), and in
        float32 this form does not cancel a term of the size of ``Sigma^{-1/2}``
        at a measured vertex."""
        bt_x = self.op.lowrank.bt(x)  # (*batch, m)
        if shift is not None:
            bt_x = bt_x - shift
        m = bt_x.shape[-1]
        corr = bt_x @ self.B_bar.reshape(m, -1)
        return x - corr.reshape(x.shape)

    def apply(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``nsmooth`` SOR sweeps, each followed by the low-rank correction."""
        for _ in range(self.nsmooth):
            x = self.sweep_stencil(b, x)
            if self.B_bar is not None:
                x = self._lowrank_correct(x)
        return x


class SSORSmoother:
    """Symmetric SOR: one forward then one backward sweep per smoothing step.
    Each direction carries its own Woodbury factor ``B_bar``; one direction's
    factor is never applied to the other's sweep."""

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
        self.nsmooth = int(nsmooth)
        coloring = coloring or coloring_for(op.offsets, op.vshape)
        self.forward = SORSmoother(op, omega, 1, FORWARD, coloring)
        self.backward = SORSmoother(op, omega, 1, BACKWARD, coloring)
        self.op = op

    def apply(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.nsmooth):
            x = self.forward.apply(b, x)
            x = self.backward.apply(b, x)
        return x


def smoother_factory(name: str, omega: float, nsmooth: int, direction: str = FORWARD):
    """Returns a callable ``op -> smoother`` for per-level instantiation."""
    name = name.upper()
    if name == "SOR":
        return lambda op: SORSmoother(op, omega, nsmooth, direction)
    if name == "SSOR":
        return lambda op: SSORSmoother(op, omega, nsmooth)
    raise ValueError(f"unknown smoother '{name}'")
