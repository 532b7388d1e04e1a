"""Chains-data-parallel execution of the single-device MGMC engine.

Counterpart of ``multigridmc_tpu/parallel/data_parallel.py``.  For sampling
across many devices the natural layout is pure data parallelism over chains:
every chain is an independent MCMC chain, the lattice fits one device, and no
halo traffic exists at all.  Each rank of a chains mesh
(:func:`~multigridmc_tpu_torch.parallel.mesh.chains_mesh`) runs the complete
single-device sampler on its own block of chains - on a CUDA device the fused
level-visit kernels, the distilled subtree (whose set-up runs the sweep
kernels) and the composed levels between them, with the same routes as on one
card - and no collective runs inside a step.

Noise per rank: the kernels' Philox key is ``seed ^ PHILOX_KEY_MIX`` and their
counter ``(group, chain, launch, 0)`` with the chain's *local* index, and the
plain path's ``torch.Generator`` is keyed by the seed alone, so two ranks that
shared a seed would draw the same noise and their chains would be copies.  Each
rank therefore draws from ``GeneratorNoise(fold_seed(seed, rank))``
(:func:`~multigridmc_tpu_torch.parallel.mesh.fold_seed`, the counterpart of
``jax.random.fold_in(key, axis_index)``): rank ``r``'s chains are exactly the
single-device sampler's chains under that source.

A rank's stream is kept on the shared source (``GeneratorNoise.stream``), so
that a checkpoint of the rank (:class:`~multigridmc_tpu_torch.utils.checkpoint.ChainState`:
its block of chains and the shared source) saves it, and a run loaded from it
draws on from where the saved one stopped.

Lattice-sharded execution (for problems larger than one device) is the
explicit-halo :class:`~multigridmc_tpu_torch.parallel.cycle.ShardedMGMCSampler`.
"""

from __future__ import annotations

import torch

from ..ops.stencil import StencilOperator
from ..samplers.base import GeneratorNoise
from ..samplers.mgmc import MultigridMCSampler
from .mesh import Mesh, fold_seed, gather_field, scatter_field

#: the name of a rank's stream on the shared source (``GeneratorNoise.stream``)
RANK_STREAM = "rank"


def rank_noise(noise: GeneratorNoise, mesh: Mesh) -> GeneratorNoise:
    """The noise source of this rank's chains: ``noise``'s seed folded with
    the rank's chains index, on the rank's device."""
    return GeneratorNoise(fold_seed(noise.seed, mesh.chains_index), mesh.device)


class DataParallelMGMCSampler:
    """Run a full single-device :class:`MultigridMCSampler` per chains shard.

    ``apply(noise, f, x)`` takes this rank's block of chains ``x``
    (``(C_local, *vshape)``, cut by :meth:`scatter`) and a shared rhs ``f``;
    ``noise`` is a :class:`GeneratorNoise` of the same seed on every rank, from
    which each rank derives its own stream once (:func:`rank_noise`) and keeps
    it for as long as ``noise`` lives.  ``fused`` and ``distill`` default to
    on, as in the JAX package; ``sampler_kwargs`` go to
    :class:`MultigridMCSampler`, built on the rank's device.
    """

    def __init__(self, op: StencilOperator, nlevel: int, mesh: Mesh, *,
                 fused: object = True, distill: object = True, **sampler_kwargs):
        if mesh.lattice_axes:
            raise ValueError("DataParallelMGMCSampler takes a 1d chains mesh; use "
                             "ShardedMGMCSampler for lattice domain decomposition")
        self.mesh = mesh
        self.op = op
        self.sampler = MultigridMCSampler(op, nlevel, fused=fused, distill=distill,
                                          device=mesh.device, **sampler_kwargs)

    def rank_noise(self, noise: GeneratorNoise) -> GeneratorNoise:
        """This rank's stream of ``noise`` (:func:`rank_noise`'s seed), kept on
        ``noise`` as its stream :data:`RANK_STREAM`: made at its first use, or
        the one a loaded checkpoint of this rank restored there."""
        if not isinstance(noise, GeneratorNoise):
            raise TypeError("DataParallelMGMCSampler derives each rank's stream from a "
                            f"GeneratorNoise's seed, not from {type(noise).__name__}")
        return noise.stream(RANK_STREAM, fold_seed(noise.seed, self.mesh.chains_index),
                            self.mesh.device)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``(C, *vshape)`` global chains; a chain count
        that the world does not divide raises ``ValueError``."""
        return scatter_field(x, self.mesh, len(self.op.vshape), lattice=False)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All ranks' chains, in rank order, on every rank."""
        return gather_field(x, self.mesh, len(self.op.vshape), lattice=False)

    def apply(self, noise: GeneratorNoise, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One MGMC step of this rank's chains (updated in place where the
        fused kernels run; use the return value)."""
        vdim = len(self.op.vshape)
        if x.ndim != vdim + 1:
            raise ValueError(f"x is this rank's block of chains (C_local, *vshape), got "
                             f"shape {tuple(x.shape)}")
        return self.sampler.apply(self.rank_noise(noise), f, x)
