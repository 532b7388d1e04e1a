"""Multigrid Monte Carlo sampler - the flagship algorithm.

Counterpart of ``multigridmc_tpu/samplers/mgmc.py`` (Goodman & Sokal 1989): a
stochastic multigrid V/W-cycle whose smoothers are multi-colour SOR/SSOR Gibbs
sweeps and whose coarse-level "solve" is an exact Cholesky (or SSOR Gibbs)
sample.

Per level a Galerkin-coarsened operator, a forward pre-sampler and a backward
post-sampler (SSOR: a forward-backward pair for both); the coarsest level gets
a dense Cholesky or an SSOR sampler.  The recursive cycle:

    sample(level):
        if coarsest:  x_L ~ coarse_sampler(f_L, x_L)
        else, repeated ``cycle`` times on levels > 0:
            x_l  ~ presampler(f_l, x_l)                     (forward Gibbs)
            f_{l+1} = R (f_l - A_l x_l)
            x_{l+1} = 0;  sample(level+1)
            x_l += coarse_scaling * P x_{l+1}
            x_l  ~ postsampler(f_l, x_l)                    (backward Gibbs)

Chain-state semantics: the fine-level x is carried across calls (NOT zeroed),
coarse-level states are zero-initialised at each visit.

The cycle batches over leading chain dimensions, so many independent chains
run in lockstep on one GPU.  On a CUDA device each visit of a float32 level,
2d or 3d, SOR (one directed sweep) or SSOR (a forward and a backward sweep), is
ONE launch of a hand-written fused CUDA kernel
(:mod:`multigridmc_tpu_torch.ops.kernels.mgmc_visit`; a single chain is a batch
of one).  Only levels of more than one smoothing step per visit and levels in
another dtype than float32 run the composed visit, whose Gibbs sweeps are
launches of the sweep kernel (:mod:`multigridmc_tpu_torch.ops.kernels.sor_sweep`)
with the residual and the transfers in plain PyTorch.  ``apply`` may update the
chain state it is given in place.

Two ways to replace the recursion below a level by one call:

* ``distill`` - everything from the distill level down becomes the exact
  affine-Gaussian map ``x = T f + S xi`` of
  :mod:`multigridmc_tpu_torch.samplers.distill`, two matrix products per
  invocation.  The default ``"auto"`` distils on a CUDA device.
* ``subtree=True`` - everything below level 0 is one launch of the subtree
  kernel (:mod:`multigridmc_tpu_torch.ops.kernels.mgmc_subtree`; its reach-2
  build for the squared shifted-Laplace prior's 25-point sub-levels).  It
  excludes distillation.

``sweep_schedule="alternating"`` alternates the sweep directions from step to
step: odd steps run the same hierarchy with the pre- and post-samplers swapped
(their own fused levels, whose Woodbury factors follow the swapped directions,
and their own distilled map); ``apply(..., parity=1)``, ``apply_pair`` and
``apply_indexed`` select it.  It excludes ``subtree=True``.

Not ported (``NotImplementedError``): the subtree kernel on SSOR levels and on
3d levels (the TPU kernel is SOR-only and 2d only too).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.intergrid import prolongate_add, restrict
from ..ops.kernels.mgmc_visit import fused_levels_for
from ..ops.stencil import StencilOperator
from ..smoothers import BACKWARD, FORWARD
from ..solvers.multigrid import MultigridHierarchy
from .base import NoiseSource, Sampler
from .cholesky import DenseCholeskySampler
from .distill import DEFAULT_DISTILL_MAX_N  # noqa: F401  (the other default, kept beside)
from .distill import distill_subtree, resolve_distill_level
from .sor import SORSampler, SSORSampler

#: smallest level (vertex count) that runs as a fused kernel visit on a CUDA
#: device.  0 = every non-coarsest level: measured on an H100 by
#: ``chip_smoke.py`` (PERF.md), fusing all levels beats fusing level 0 only,
#: because the composed visits of the small levels are launch-bound in eager
#: PyTorch.
DEFAULT_FUSED_MIN_VERTICES = 0


class MultigridMCSampler(Sampler):
    """Parameters mirror the JAX package's ``MultigridMCSampler``; ``device``
    and ``dtype`` move the operator (default: where the operator already lies).

    ``fused``: ``"auto"`` fuses level visits when the operator lies on a CUDA
    device, ``True`` builds the fused levels on any device (on the CPU they run
    their plain versions), ``False`` runs the composed recursion everywhere.
    SOR and SSOR levels fuse alike where ``npresmooth`` and ``npostsmooth`` are
    1.  Under ``"auto"`` on a CUDA device only levels in a dtype other than
    float32 run the composed recursion; a float32 level, 2d or 3d, beyond the
    visit kernels' limits raises ``NotImplementedError`` (see
    :func:`~multigridmc_tpu_torch.ops.kernels.mgmc_visit.fused_levels_for`).

    ``distill``: ``False`` never; ``True`` distils the subtree rooted at
    :func:`~multigridmc_tpu_torch.samplers.distill.pick_distill_level` on any
    device; ``"auto"`` (default) does so on a CUDA device and not on the CPU.
    ``distill_precision``: ``None``, ``"highest"`` and ``"high"`` run the two
    products in full float32, ``"default"`` allows TF32 for them (opt-in).

    ``subtree``: ``True`` runs everything below level 0 as one launch of the
    subtree kernel for batched chains (on the CPU: its plain version).  It
    needs SOR with one pre- and one post-sweep, a 2d operator, at least three
    levels and a dense Cholesky coarse sampler, and float32 on a CUDA device;
    anything else raises.  It excludes distillation: ``distill="auto"`` then
    resolves to off and ``distill=True`` raises; with
    ``sweep_schedule="alternating"`` it raises ``ValueError``.  Off by default:
    on an H100 the distilled subtree is faster (``chip_smoke.py``, PERF.md).
    """

    def __init__(
        self,
        op: StencilOperator,
        nlevel: int,
        smoother: str = "SOR",
        coarse_solver: str = "Cholesky",
        npresmooth: int = 1,
        npostsmooth: int = 1,
        ncoarsesmooth: int = 1,
        omega: float = 1.0,
        cycle: int = 1,
        coarse_scaling: float = 1.0,
        cholesky_factorisation: str = "dense",
        hierarchy: Optional[MultigridHierarchy] = None,
        verbose: int = 0,
        distill: object = "auto",
        fused: object = "auto",
        fused_min_vertices: Optional[int] = None,
        sweep_schedule: str = "fixed",
        distill_precision: Optional[str] = None,
        subtree: bool = False,
        device=None,
        dtype=None,
    ):
        op = op.to(device, dtype)
        super().__init__(op)
        sweep_schedule = sweep_schedule.lower()
        if sweep_schedule not in ("fixed", "alternating"):
            raise ValueError(f"invalid sweep_schedule '{sweep_schedule}'")
        self.sweep_schedule = sweep_schedule
        smoother = smoother.upper()
        if smoother not in ("SOR", "SSOR"):
            raise ValueError(f"invalid sampler '{smoother}'")
        if coarse_solver.lower() not in ("cholesky", "ssor"):
            raise ValueError(f"invalid coarse sampler '{coarse_solver}'")
        # the coarse level is tiny and factorised densely on the device
        # whichever factorisation the configuration names
        del cholesky_factorisation
        #: precision tier of the distilled subtree's two matrix products
        self.distill_precision = distill_precision

        self.hierarchy = hierarchy or MultigridHierarchy(op, nlevel)
        if self.hierarchy.operators[0].device != op.device:
            raise ValueError("hierarchy and operator lie on different devices")
        self.nlevel = self.hierarchy.nlevel
        self.cycle = int(cycle)
        self.coarse_scaling = float(coarse_scaling)

        self.presamplers = []
        self.postsamplers = []
        for level_op in self.hierarchy.operators:
            if smoother == "SOR":
                self.presamplers.append(SORSampler(level_op, omega, npresmooth, FORWARD))
                self.postsamplers.append(SORSampler(level_op, omega, npostsmooth, BACKWARD))
            else:
                self.presamplers.append(SSORSampler(level_op, omega, npresmooth))
                self.postsamplers.append(SSORSampler(level_op, omega, npostsmooth))
        coarse_op = self.hierarchy.operators[-1]
        if coarse_solver.lower() == "cholesky":
            self.coarse_sampler = DenseCholeskySampler(coarse_op)
        else:
            self.coarse_sampler = SSORSampler(coarse_op, omega, ncoarsesmooth)

        if verbose > 0:
            for level, level_op in enumerate(self.hierarchy.operators):
                print(f"  level {level} lattice : {level_op.lattice.get_info()}")

        # one fused kernel call = one visit: one directed sweep (SOR) or a
        # forward and a backward sweep (SSOR)
        self._visits_fusable = npresmooth == 1 and npostsmooth == 1
        self._fused_opts = dict(
            min_vertices=(DEFAULT_FUSED_MIN_VERTICES if fused_min_vertices is None
                          else int(fused_min_vertices)),
            force=None if fused == "auto" else bool(fused))
        self.fused_levels = (self._make_fused(self.presamplers, self.postsamplers)
                             if self._visits_fusable else {})
        self._build_subtree(bool(subtree), smoother, npresmooth, npostsmooth)
        self._build_distilled(distill)
        self._build_alternate()

    def _make_fused(self, pre, post) -> dict:
        return fused_levels_for(self.hierarchy.operators, pre, post, self.coarse_scaling,
                                self._fused_opts["min_vertices"],
                                force=self._fused_opts["force"])

    # ------------------------------------------------- the subtree kernel
    def _build_subtree(self, subtree: bool, smoother: str, npresmooth: int,
                       npostsmooth: int) -> None:
        """One kernel launch for the whole coarse subtree (levels 1 ..
        coarsest).  Asked for and not possible raises: the kernel is never
        quietly replaced by the composed path."""
        self.subtree = None
        if not subtree:
            return
        sub_ops = self.hierarchy.operators[1:]
        if smoother != "SOR" or npresmooth != 1 or npostsmooth != 1:
            raise NotImplementedError(
                "subtree=True needs SOR with one pre- and one post-sweep per visit: "
                "the subtree kernel runs no two-sweep (SSOR) visit, as the TPU kernel")
        if not isinstance(self.coarse_sampler, DenseCholeskySampler):
            raise NotImplementedError("subtree=True needs the dense Cholesky coarse sampler")
        if self.nlevel < 3:
            raise ValueError("subtree=True needs at least 3 levels: a level above the "
                             "subtree, a sub-level and the coarsest")
        if any(len(op.vshape) != 2 for op in sub_ops):
            raise NotImplementedError("the subtree kernel is 2d only")
        if self.op.device.type == "cuda" and self.op.dtype != torch.float32:
            raise NotImplementedError("the subtree kernel is float32 only")
        from ..ops.kernels.mgmc_subtree import SubtreeKernel

        self.subtree = SubtreeKernel(
            sub_ops,
            [p.smoother for p in self.presamplers[1:self.nlevel - 1]],
            [p.smoother for p in self.postsamplers[1:self.nlevel - 1]],
            self.coarse_sampler.L, self.presamplers[0].omega, self.cycle,
            self.coarse_scaling)

    # ------------------------------------------------- the distilled subtree
    def _build_distilled(self, distill) -> None:
        """Affine distillation of the coarse subtree: below the distill level
        the recursion is replaced by the subtree's *exact* affine-Gaussian map
        ``x = T f + S xi`` - two matrix products per invocation."""
        self.distilled = None
        self.distill_level = None
        if self.subtree is not None:
            if distill is True:
                raise ValueError("subtree=True already covers the sub-levels: it excludes "
                                 "distill=True")
            return
        li = resolve_distill_level(distill, self.hierarchy.operators)
        if li is None:
            return
        self.distilled = self._make_distilled(li, self.presamplers, self.postsamplers)
        self.distill_level = li

    def _make_distilled(self, li: int, pre, post):
        return distill_subtree(
            self.hierarchy.operators[li:], pre[li:], post[li:], self.coarse_sampler,
            self.cycle, self.coarse_scaling, noise=True, precision=self.distill_precision)

    # ---------------------------------------------- the alternating schedule
    def _build_alternate(self) -> None:
        """The parity-1 engine of ``sweep_schedule="alternating"``: the same
        hierarchy with the pre- and post-samplers swapped (odd steps presample
        backward and postsample forward), with fused levels built for the
        swapped directions - each level's Woodbury factors belong to its own
        sweep orders - and a distilled map of the swapped subtree.  Either
        parity leaves the target invariant, so their composition does too."""
        self._alt = None
        if self.sweep_schedule != "alternating":
            return
        if self.subtree is not None:
            raise ValueError("sweep_schedule='alternating' excludes subtree=True: the "
                             "subtree kernel runs the fixed schedule's directions only")
        alt_fused = (self._make_fused(self.postsamplers, self.presamplers)
                     if self._visits_fusable else {})
        alt_distilled = None
        if self.distilled is not None:
            alt_distilled = self._make_distilled(self.distill_level, self.postsamplers,
                                                 self.presamplers)
        self._alt = dict(presamplers=self.postsamplers, postsamplers=self.presamplers,
                         fused_levels=alt_fused, distilled=alt_distilled)

    def _engine(self, parity: int):
        """``(presamplers, postsamplers, fused_levels, distilled)`` of a step
        parity; parity 1 differs from 0 under the alternating schedule only."""
        if parity and self._alt is not None:
            a = self._alt
            return a["presamplers"], a["postsamplers"], a["fused_levels"], a["distilled"]
        return self.presamplers, self.postsamplers, self.fused_levels, self.distilled

    def _sample(self, level: int, noise: NoiseSource, f: torch.Tensor,
                x: torch.Tensor, parity: int = 0) -> torch.Tensor:
        """Recursive stochastic cycle.  Noise is consumed in the order pre,
        coarse, post per level and cycle index."""
        if level == self.nlevel - 1:
            return self.coarse_sampler.apply(noise, f, x)
        presamplers, postsamplers, fused_levels, distilled = self._engine(parity)
        op = self.hierarchy.operators[level]
        vdim = len(op.vshape)
        # the fused kernels take exactly one chain axis
        fused = fused_levels.get(level) if x.ndim == vdim + 1 else None
        ncycle = self.cycle if level > 0 else 1
        for _ in range(ncycle):
            if fused is not None:
                x, f_coarse = fused.descend(noise, f, x)
            else:
                x = presamplers[level].apply(noise, f, x)
                r = f - op.apply(x)
                f_coarse = restrict(r, dim=vdim)
            if level == 0 and self.subtree is not None and f_coarse.ndim == vdim + 1:
                x_coarse = self.subtree.sample(noise, f_coarse.contiguous())
            elif (distilled is not None and level + 1 == self.distill_level
                  and f_coarse.ndim > vdim):
                x_coarse = distilled.apply(noise, f_coarse)
            else:
                x_coarse = self._sample(level + 1, noise, f_coarse,
                                        torch.zeros_like(f_coarse), parity)
            if fused is not None:
                x = fused.ascend(noise, f, x, x_coarse)
            else:
                x = prolongate_add(self.coarse_scaling, x_coarse, x, dim=vdim)
                x = postsamplers[level].apply(noise, f, x)
        return x

    def apply(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor,
              parity: int = 0) -> torch.Tensor:
        """One MGMC step: chain state x is carried, not zeroed.  ``x`` is
        ``(*batch, *vshape)``; ``f`` is ``vshape`` (shared) or batched like x.
        With fused levels ``x`` may be updated in place; use the return value.
        ``parity`` (0 or 1) selects the sweep directions under
        ``sweep_schedule="alternating"`` and is ignored under the fixed one."""
        parity = int(parity) & 1
        vdim = len(self.op.vshape)
        one_chain_axis = bool(self.fused_levels) or self.subtree is not None
        if self.distilled is not None and x.ndim == vdim:
            one_chain_axis = True  # the distilled map serves batches: one chain is a batch of one
        if one_chain_axis and x.ndim != vdim + 1:
            # fused kernels take one flat chain axis; reshape around the cycle
            # (a single chain is a batch of one)
            batch = x.shape[: x.ndim - vdim]
            xf = x.reshape((-1,) + self.op.vshape).contiguous()
            ff = f
            if f.ndim > vdim:
                ff = torch.broadcast_to(f, x.shape).reshape(xf.shape)
            out = self._sample(0, noise, ff.contiguous(), xf, parity)
            return out.reshape(batch + self.op.vshape)
        if one_chain_axis:
            x = x.contiguous()
            f = f.contiguous()
        return self._sample(0, noise, f, x, parity)

    def apply_pair(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Two MGMC steps, parity 0 then parity 1 (under the fixed schedule two
        ordinary steps), drawing from ``noise`` in that order."""
        return self.apply(noise, f, self.apply(noise, f, x, parity=0), parity=1)

    def apply_indexed(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor,
                      k: int) -> torch.Tensor:
        """One step that sees the step index ``k``: under the alternating
        schedule its parity ``k % 2`` picks the sweep directions (on the host,
        before any launch); under the fixed schedule every step is the same."""
        if self._alt is None:
            return self.apply(noise, f, x)
        return self.apply(noise, f, x, parity=int(k) % 2)
