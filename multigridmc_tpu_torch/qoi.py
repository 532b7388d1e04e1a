"""Quantities of interest evaluated on lattice fields.

Counterpart of ``multigridmc_tpu/qoi.py``: the interface plus the two QoIs the
drivers compute, a linear observation ``z = w^T x`` and the domain average.
Fields are tensors with any leading batch (chain) dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

from .lattice import Lattice


class QoI:
    def evaluate(self, x):
        raise NotImplementedError

    def __call__(self, x):
        return self.evaluate(x)


class LinearQoI(QoI):
    """``z = w^T x`` for a fixed weight field w (e.g. a measurement vector).
    ``weights`` is a tensor, or an array together with ``device`` / ``dtype``."""

    def __init__(self, weights, device=None, dtype=None):
        if not isinstance(weights, torch.Tensor):
            weights = torch.as_tensor(np.asarray(weights))
        self.weights = weights.to(device=device, dtype=dtype)

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        d = self.weights.ndim
        batch = x.shape[: x.ndim - d]
        return x.reshape(batch + (-1,)) @ self.weights.reshape(-1)


class DomainAverageQoI(LinearQoI):
    """Average of the field over the domain (cell_volume per vertex)."""

    def __init__(self, lattice: Lattice, device=None, dtype=None):
        super().__init__(np.full(lattice.vshape, lattice.cell_volume), device, dtype)


def qoi_factory(name: str, lattice: Lattice, **kwargs) -> QoI:
    if name == "linear":
        return LinearQoI(kwargs["weights"], kwargs.get("device"), kwargs.get("dtype"))
    if name == "domain_average":
        return DomainAverageQoI(lattice, kwargs.get("device"), kwargs.get("dtype"))
    raise ValueError(f"unknown QoI '{name}'")
