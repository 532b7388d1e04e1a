"""Sampler base interface and the noise sources.

Counterpart of ``multigridmc_tpu/samplers/base.py``.  Samplers draw the next
chain state ``x' ~ K(x, .)`` of a Markov chain whose stationary distribution is
``pi(x) ~ exp(-1/2 x^T A x + f^T x)``, i.e. ``N(A^{-1} f, A^{-1})``.

Randomness is explicit.  Where the JAX package threads a ``jax.random`` key
through every ``apply`` and splits it per step, level and sweep, the port hands
every ``apply`` a **noise source**:

* :class:`GeneratorNoise` (production) wraps a ``torch.Generator`` on the
  sampler's device for the plain tensor path, and hands the fused kernels a
  Philox ``(seed, launch counter)`` pair.  The counter is a Python int that
  advances by one per draw (a kernel that makes one draw per launch takes one
  counter, the subtree kernel takes one per sweep, low-rank draw and coarse
  sample of its launch), so every (step, level, visit, sweep) gets its own
  stream without a device-to-host synchronisation; the kernel adds the chain
  and the point index to the Philox counter.
* :class:`ReplayNoise` (tests) returns arrays supplied from outside, in call
  order, so the port can be fed the very normals another implementation drew.

The plain path draws in the order of the JAX composed path: per sweep the field
``xi`` of ``x.shape``, then the ``(*batch, m)`` low-rank scalars; per coarse
visit one ``(*batch, n)`` draw; per level and cycle index pre, coarse, post.

``apply`` may update the chain state it is given in place (the fused kernels
do); callers use the returned tensor and clone an input they want to keep.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.stencil import StencilOperator
from ..utils.runtime import make_generator, resolve_device


class NoiseSource:
    """Source of the standard normals a sampler consumes."""

    def normal(self, shape, dtype: torch.dtype, device) -> torch.Tensor:
        """A fresh ``N(0, 1)`` tensor of ``shape``."""
        raise NotImplementedError

    def philox_stream(self) -> Optional[Tuple[int, int]]:
        """``(seed, launch counter)`` for one kernel launch's in-kernel
        generator, or ``None`` when this source can only supply tensors (the
        kernel is then fed the field noise through :meth:`normal`)."""
        return None

    def philox_streams(self, n: int) -> Optional[Tuple[int, int]]:
        """``(seed, first launch counter)`` of ``n`` consecutive launch
        counters, for a kernel that makes ``n`` draws in one launch (draw ``d``
        uses the counter ``first + d``), or ``None`` as :meth:`philox_stream`."""
        return None


class GeneratorNoise(NoiseSource):
    """Production noise: a seeded ``torch.Generator`` on ``device`` plus the
    Philox ``(seed, counter)`` stream ids of the fused kernels."""

    def __init__(self, seed: int, device=None):
        self.device = resolve_device(device)
        self.seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.generator = make_generator(seed, self.device)
        self.launches = 0
        #: the streams derived from this source, by name (:meth:`stream`)
        self.streams: Dict[str, "GeneratorNoise"] = {}

    def normal(self, shape, dtype, device) -> torch.Tensor:
        return torch.randn(tuple(shape), dtype=dtype, device=device,
                           generator=self.generator)

    def philox_stream(self) -> Tuple[int, int]:
        return self.philox_streams(1)

    def philox_streams(self, n: int) -> Tuple[int, int]:
        if n < 1:
            raise ValueError("a launch takes at least one counter")
        counter = self.launches
        self.launches += int(n)
        return self.seed, counter

    def stream(self, name: str, seed: int, device=None) -> "GeneratorNoise":
        """The stream ``name`` derived from this source, of ``seed`` (on
        ``device``, default this source's): made at its first use and kept
        here, so that it runs on from call to call and a checkpoint of this
        source (``utils.checkpoint.ChainState``) saves and resumes it with
        the source.  A kept stream of that name and another seed (a
        checkpoint of another rank, or of another seed) raises
        ``ValueError``."""
        mine = self.streams.get(name)
        if mine is None:
            mine = self.streams[name] = GeneratorNoise(seed, self.device if device is None
                                                       else device)
        elif mine.seed != int(seed) & 0xFFFFFFFFFFFFFFFF:
            raise ValueError(f"the source's stream {name!r} has the seed {mine.seed}, not "
                             f"{int(seed) & 0xFFFFFFFFFFFFFFFF}: it belongs to another rank "
                             "or seed")
        return mine


class ReplayNoise(NoiseSource):
    """Replays normals recorded elsewhere, in call order.  Every request must
    match the shape of the next recorded array."""

    def __init__(self, draws: Sequence[np.ndarray]):
        self.draws = [np.asarray(d) for d in draws]
        self.position = 0

    def normal(self, shape, dtype, device) -> torch.Tensor:
        if self.position >= len(self.draws):
            raise RuntimeError("replay noise exhausted: more draws requested "
                               f"than the {len(self.draws)} recorded")
        d = self.draws[self.position]
        if tuple(d.shape) != tuple(shape):
            raise RuntimeError(
                f"replay noise draw {self.position} has shape {d.shape}, "
                f"the sampler asked for {tuple(shape)}")
        self.position += 1
        return torch.tensor(d, dtype=dtype, device=device)

    @property
    def exhausted(self) -> bool:
        return self.position == len(self.draws)


class Sampler:
    def __init__(self, op: StencilOperator):
        self.op = op

    def apply(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Draw the next chain state given rhs f and current state x."""
        raise NotImplementedError

    def apply_indexed(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor,
                      k: int) -> torch.Tensor:
        """One chain step that also sees the step index ``k``.  Default: ignore
        it.  Step-schedule-aware samplers override this so that driver loops
        stay one step per iteration."""
        del k
        return self.apply(noise, f, x)

    def fix_rhs(self, f: torch.Tensor) -> None:
        """Cache f-dependent precomputations (no-op by default)."""

    def unfix_rhs(self) -> None:
        """Drop cached f-dependent state (no-op by default)."""


class MeanShiftedSampler(Sampler):
    """Zero-mean float32 protocol as a sampler wrapper.

    Direct-rhs sampling in float32 carries an ``O(cond(Q) * eps32)`` mean bias:
    the Gibbs chain implicitly solves ``Q mu = f`` in float32.  This wrapper
    samples the *fluctuation* ``e ~ N(0, Q^{-1})`` with ``f = 0`` on the device
    and carries the exactly known (host float64) mean separately:

        x' = mean + K_0(x - mean, .)

    Exact in expectation; the covariance is untouched.  The rhs argument of
    ``apply`` is ignored - the wrapper represents the fixed target
    ``N(mean, Q^{-1})`` it was built with.
    """

    def __init__(self, sampler: Sampler, mean):
        super().__init__(sampler.op)
        self.inner = sampler
        op = sampler.op
        if isinstance(mean, torch.Tensor):
            mean = mean.detach().cpu().numpy()
        self.mean = torch.as_tensor(np.asarray(mean), dtype=op.dtype, device=op.device)
        self._zero = torch.zeros(op.vshape, dtype=op.dtype, device=op.device)

    def apply(self, noise: NoiseSource, f, x: torch.Tensor) -> torch.Tensor:
        del f  # the target mean is carried exactly; see class docstring
        e = self.inner.apply(noise, self._zero, x - self.mean)
        return self.mean + e

    def apply_indexed(self, noise: NoiseSource, f, x: torch.Tensor, k: int) -> torch.Tensor:
        del f
        e = self.inner.apply_indexed(noise, self._zero, x - self.mean, k)
        return self.mean + e

    def fix_rhs(self, f) -> None:
        self.inner.fix_rhs(self._zero)

    def unfix_rhs(self) -> None:
        self.inner.unfix_rhs()
