"""Affine distillation of the MGMC coarse subtree.

Counterpart of ``multigridmc_tpu/samplers/distill.py``.  The recursive cycle
zero-initialises the coarse state at every recursion entry, and every operation
below that point - stochastic SOR/SSOR sweeps, Woodbury corrections, residual,
restriction, prolongation, the coarse Cholesky sample - is *affine* in
``(f, noise)`` with Gaussian noise.  The entire subtree below level ``l`` is
therefore an exact affine-Gaussian map

    x_l = T f_l + N xi,   xi ~ N(0, I_K)   (K = total noise dims drawn below l)

so its conditional law is ``N(T f_l, C)`` with ``C = N^T N``.  Replacing the
recursion by

    x_l = T f_l + S xi',  xi' ~ N(0, I_n),  S = chol(C)

is *distributionally identical* (same Markov transition kernel, hence the same
exact stationary distribution ``N(Q^{-1} f, Q^{-1})``), and costs two matrix
products per invocation instead of one kernel launch per visit and several
library launches per coarse sample.

``T`` and ``N`` are computed once at setup by **basis propagation**: the subtree
recursion runs on a batch of ``n + K`` basis vectors (the f-basis plus one
identity block per noise draw) through the production sweeps and transfers -
on a CUDA device in float32 the whole batch goes through the deterministic
sweep kernel (:mod:`multigridmc_tpu_torch.ops.kernels.sor_sweep`) - with the
noise draws replaced by identity injections, so exactness holds by
construction.  The same machinery with ``noise=False`` distils the
*deterministic* multigrid subtree into a single matrix for the preconditioner.
``C = N^T N`` and its Cholesky factor are computed in float64.

The two products ``x = f @ T + xi @ S^T`` are ``torch.matmul`` (outside any
kernel, as in the JAX package).  Their precision is a correctness question:
the JAX package found that its lowest matrix-unit tier biases the stationary
variance, and TF32 is this card's analogue.  ``precision`` ``None``,
``"highest"`` and ``"high"`` run in full float32 (PyTorch has no three-pass
tier; never less precise than asked); ``"default"`` allows TF32 for these two
products only, through a local context, and stays opt-in.

Applicability gate: storing ``T`` and ``S`` costs ``2 n^2`` floats and each
invocation ``2 C n^2`` multiply-adds, so distillation is restricted to
sub-levels with at most :data:`DEFAULT_DISTILL_MAX_N` vertices.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.intergrid import prolongate_add, restrict
from ..ops.stencil import StencilOperator
from ..utils import runtime  # noqa: F401  (sets the matmul precision policy)

#: largest sub-level vertex count distilled under ``distill="auto"`` (``n^2``
#: matrix storage, ``C n^2`` multiply-adds per product).  4160 admits a
#: 64x64-cell level (63^2 = 3969 vertices) and excludes the 127^2 one.
#: Measured with ``chip_smoke.py`` (phase ``main_path``) on an NVIDIA H100 80GB
#: HBM3, 700.00 W, 256 chains on the 256x256 flagship: with the subtree rooted
#: at 63^2 distilled a step takes 2.5 ms, against 4.3 ms with every level's
#: visit a kernel launch and 3.0-3.5 ms through the subtree kernel, so
#: distillation pays there.  The next level up does not fit the budget by
#: orders of magnitude (127^2: two matrices of 1 GB, 266 GFLOP per step where
#: its four visits take 0.8 ms), so the reference's value stands.  PERF.md
#: holds the numbers.
DEFAULT_DISTILL_MAX_N = 4160

PRECISIONS = (None, "highest", "high", "default")


# ------------------------------------------------------------------ sweep spec
def directed_sweeps(obj) -> List:
    """Flatten a smoother / sampler object into its per-apply list of directed
    sweeps: one :class:`~multigridmc_tpu_torch.smoothers.SORSmoother` (colour
    order, ``B_bar``, sweep kernel plan) per sweep, one noise draw per entry
    when sampling."""
    if hasattr(obj, "smoother"):  # SORSampler wraps one directed SORSmoother
        return directed_sweeps(obj.smoother) * obj.nsmooth
    if hasattr(obj, "order"):  # SORSmoother
        return [obj] * obj.nsmooth
    if hasattr(obj, "forward"):  # SSORSmoother / SSORSampler
        return (directed_sweeps(obj.forward) + directed_sweeps(obj.backward)) * obj.nsmooth
    raise TypeError(f"cannot extract sweeps from {type(obj).__name__}")


# ------------------------------------------------------------------- distiller
class _Cursor:
    """Running offset into the stacked noise basis (rows n..n+K of the
    propagated batch); ``counting=True`` walks the structure without arrays.
    The injections write into the tensor they are given."""

    def __init__(self, noise: bool, counting: bool, n_f: int = 0):
        self.noise = noise
        self.counting = counting
        self.off = n_f

    def field_noise(self, C, scale: torch.Tensor):
        """``c += sqrt(D(2-omega)/omega) xi`` in basis form: the draw's identity
        block scaled per vertex."""
        if not self.noise:
            return C
        nb = int(np.prod(scale.shape))
        off = self.off
        self.off += nb
        if not self.counting:
            C[off:off + nb].reshape(nb, nb).diagonal().add_(scale.reshape(-1))
        return C

    def lowrank_noise(self, X, lowrank):
        """The sweep's low-rank draw in basis form, as the Woodbury
        correction takes it (``Sigma^{1/2} n``, :meth:`SORSampler.lowrank_shift`):
        ``(rows of X, m)``, ``Sigma^{1/2}`` on the draw's rows and zero
        elsewhere; ``None`` where noise is off or nothing is built."""
        if not self.noise:
            return None
        m = lowrank.m
        off = self.off
        self.off += m
        if self.counting:
            return None
        shift = torch.zeros((X.shape[0], m), dtype=X.dtype, device=X.device)
        shift[off:off + m].diagonal().copy_(torch.sqrt(lowrank.Sigma_diag))
        return shift

    def coarse_noise(self, g, nc: int):
        """``xi + g`` of the coarse Cholesky sample."""
        if not self.noise:
            return g
        off = self.off
        self.off += nc
        if not self.counting:
            g[off:off + nc].diagonal().add_(1.0)
        return g


class _SubtreeSpec:
    """Static description of the subtree below (and including) one level:
    per-level operators, directed pre/post sweep lists, the coarse sampler or
    solver, and the cycle parameters - extracted from a slice of a
    ``MultigridMCSampler`` or ``MultigridPreconditioner``."""

    def __init__(self, operators: Sequence[StencilOperator], presamplers, postsamplers,
                 coarse, cycle: int, coarse_scaling: float):
        self.operators = list(operators)
        self.pre = [directed_sweeps(p) for p in presamplers]
        self.post = [directed_sweeps(p) for p in postsamplers]
        self.coarse = coarse  # DenseCholeskySampler / DenseCholeskySolver or a sweep sampler
        self.cycle = int(cycle)
        self.coarse_scaling = float(coarse_scaling)
        self.nlevel = len(self.operators)

    def _visit(self, li: int, sweeps, F, X, cursor: _Cursor):
        op = self.operators[li]
        for sm in sweeps:
            C, shift = F, None
            if cursor.noise:
                C = F if cursor.counting else F.clone()
                C = cursor.field_noise(
                    C, torch.sqrt(op.diag_stencil() * (2.0 - sm.omega) / sm.omega))
                if op.lowrank is not None:
                    shift = cursor.lowrank_noise(C, op.lowrank)
            if not cursor.counting:
                X = sm.sweep_stencil(C, X)  # the sweep kernel where it serves
                if sm.B_bar is not None:
                    X = sm._lowrank_correct(X, shift)
        return X

    def _coarse(self, F, cursor: _Cursor):
        from ..solvers.cholesky import DenseCholeskySolver

        if isinstance(self.coarse, DenseCholeskySolver):
            # deterministic solver: its L factors the stencil part only (the
            # low-rank term rides its Woodbury correction)
            if cursor.noise:
                raise ValueError("a Cholesky *solver* cannot inject noise")
            return None if cursor.counting else self.coarse.apply(F)
        if hasattr(self.coarse, "L"):  # DenseCholeskySampler: full-Q factor
            nc = self.coarse.L.shape[0]
            if cursor.counting:
                cursor.coarse_noise(None, nc)
                return None
            g = self.coarse._solve_L(F.reshape(-1, nc))
            g = cursor.coarse_noise(g, nc)
            return self.coarse._solve_LT(g).reshape(F.shape)
        # SSOR / SOR coarse sampler: sweeps from x = 0
        X = None if cursor.counting else torch.zeros_like(F)
        return self._visit(self.nlevel - 1, directed_sweeps(self.coarse), F, X, cursor)

    def _sample(self, li: int, F, cursor: _Cursor):
        """Mirror of ``MultigridMCSampler._sample`` on a basis batch: every
        level inside the subtree is a level > 0 of the original recursion, so
        it runs ``cycle`` iterations with carried state and zero init."""
        if li == self.nlevel - 1:
            return self._coarse(F, cursor)
        op = self.operators[li]
        dim = op.lattice.dim
        X = None if cursor.counting else torch.zeros_like(F)
        for _ in range(self.cycle):
            X = self._visit(li, self.pre[li], F, X, cursor)
            Fc = None if cursor.counting else restrict(F - op.apply(X), dim=dim)
            Xc = self._sample(li + 1, Fc, cursor)
            if not cursor.counting:
                X = prolongate_add(self.coarse_scaling, Xc, X, dim=dim)
            X = self._visit(li, self.post[li], F, X, cursor)
        return X

    def count_noise(self, noise: bool) -> int:
        cursor = _Cursor(noise=noise, counting=True)
        self._sample(0, None, cursor)
        return cursor.off

    def propagate(self, noise: bool) -> torch.Tensor:
        """Basis propagation: the flat output batch ``X`` of shape
        ``(n + K, n)`` with rows = [f-basis | noise-basis] responses."""
        op = self.operators[0]
        n = int(np.prod(op.vshape))
        K = self.count_noise(noise)
        F0 = torch.zeros((n + K, n), dtype=op.dtype, device=op.device)
        F0[:n].diagonal().fill_(1.0)
        cursor = _Cursor(noise=noise, counting=False, n_f=n)
        X = self._sample(0, F0.reshape((n + K,) + tuple(op.vshape)), cursor)
        if cursor.off != n + K:
            raise RuntimeError("basis propagation consumed another number of noise "
                               f"dimensions ({cursor.off - n}) than it counted ({K})")
        return X.reshape(n + K, n)


@contextlib.contextmanager
def _matmul_precision(precision: Optional[str]):
    """Full float32 unless ``precision == "default"``, which allows TF32 inside
    the context only (the process-wide policy of ``utils/runtime`` stays)."""
    if precision != "default":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class DistilledSubtree:
    """Runtime affine-Gaussian replacement for one subtree invocation:
    ``apply(noise, f) = f @ T + xi @ S^T`` with any leading batch dims."""

    def __init__(self, Tm: torch.Tensor, S_T: Optional[torch.Tensor],
                 vshape: Tuple[int, ...], level_info: dict, precision: Optional[str] = None):
        if precision not in PRECISIONS:
            raise ValueError(f"invalid distill precision '{precision}' "
                             "(None, 'highest', 'high' or 'default')")
        self.Tm = Tm  # (n, n), row-vector convention x = f @ Tm
        self.S_T = S_T  # (n, n) upper factor, None for deterministic maps
        self.vshape = tuple(vshape)
        self.n = Tm.shape[0]
        self.info = level_info
        self.precision = precision

    def apply(self, noise, f: torch.Tensor) -> torch.Tensor:
        batch = f.shape[: f.ndim - len(self.vshape)]
        fl = f.reshape(batch + (self.n,))
        with _matmul_precision(self.precision):
            x = torch.matmul(fl, self.Tm)
            if self.S_T is not None:
                xi = noise.normal(batch + (self.n,), f.dtype, f.device)
                x = x + torch.matmul(xi, self.S_T)
        return x.reshape(f.shape)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Deterministic map only (preconditioner subtree)."""
        return self.apply(None, b)


def _chol_psd(C: torch.Tensor) -> torch.Tensor:
    """float64 Cholesky factor (lower) of the PSD, possibly float32-rounded
    subtree covariance, with an escalating trace-scaled jitter ladder."""
    C = 0.5 * (C + C.T)
    n = C.shape[0]
    base = float(torch.trace(C)) / n
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    for jitter in (0.0, 1e-12, 1e-10, 1e-8, 1e-6):
        L, info = torch.linalg.cholesky_ex(C + (jitter * base) * eye)
        if int(info) == 0:
            return L
    raise RuntimeError("subtree covariance not positive semi-definite after jitter")


def distill_subtree(
    operators: Sequence[StencilOperator],
    presamplers,
    postsamplers,
    coarse,
    cycle: int,
    coarse_scaling: float,
    *,
    noise: bool = True,
    precision: Optional[str] = None,
) -> DistilledSubtree:
    """Distil the subtree spanned by ``operators`` (the ``[level:]`` slice of a
    hierarchy) into its exact affine-Gaussian map.  ``noise=False`` distils the
    deterministic multigrid cycle (preconditioner) instead."""
    spec = _SubtreeSpec(operators, presamplers, postsamplers, coarse, cycle, coarse_scaling)
    op = operators[0]
    n = int(np.prod(op.vshape))
    X = spec.propagate(noise)
    Tm = X[:n].contiguous()
    S_T = None
    if noise:
        Nm = X[n:].double()
        # C = N^T N: the exact output covariance of the subtree's noise stack
        S = _chol_psd(Nm.T @ Nm)
        S_T = S.T.to(Tm.dtype).contiguous()
    info = dict(n=n, K=int(X.shape[0]) - n, noise=noise)
    return DistilledSubtree(Tm, S_T, op.vshape, info, precision=precision)


def pick_distill_level(operators: Sequence[StencilOperator],
                       max_n: Optional[int] = None) -> Optional[int]:
    """Largest (finest) sub-level whose vertex count fits the distillation
    budget (``max_n``, default :data:`DEFAULT_DISTILL_MAX_N`); None if no
    strict sub-level qualifies or the hierarchy is too shallow to benefit
    (distilling only the coarsest level would replace a single Cholesky sample
    with an equal-cost matrix product)."""
    max_n = DEFAULT_DISTILL_MAX_N if max_n is None else max_n
    for li in range(1, len(operators) - 1):
        if operators[li].lattice.nvertex <= max_n:
            return li
    return None


def resolve_distill_level(distill, operators: Sequence[StencilOperator]) -> Optional[int]:
    """The level to distil at for a ``distill`` argument: ``False`` / ``None``
    never; ``True`` at :func:`pick_distill_level` on any device; ``"auto"``
    there too when the operators lie on a CUDA device, and never on the CPU."""
    if distill is False or distill is None:
        return None
    if distill is not True and distill != "auto":
        raise ValueError(f"invalid distill '{distill}' (False, True or 'auto')")
    if distill == "auto" and operators[0].device.type != "cuda":
        return None
    return pick_distill_level(operators)
