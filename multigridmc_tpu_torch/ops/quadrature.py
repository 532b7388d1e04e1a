"""Tensor-product Gauss-Legendre quadrature on the unit cell [0,1]^d.

Mirrors ``src/auxilliary/quadrature.cc:11-56`` (orders 0-2): 1d points/weights on
[-1,1] mapped to [0,1] with the 1/2 scaling per dimension, then tensor-multiplied.
Returns plain numpy arrays - quadrature tables are tiny setup-time constants.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

_RULES_1D = {
    0: (np.array([0.0]), np.array([2.0])),
    1: (
        np.array([-1.0 / np.sqrt(3.0), 1.0 / np.sqrt(3.0)]),
        np.array([1.0, 1.0]),
    ),
    2: (
        np.array([-np.sqrt(3.0 / 5.0), 0.0, np.sqrt(3.0 / 5.0)]),
        np.array([5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0]),
    ),
}


def gauss_legendre(dim: int, order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return ``(points, weights)`` with shapes ``(nq, dim)`` and ``(nq,)``.

    Points live in [0,1]^d; weights sum to 1 (the volume of the unit cell).
    """
    assert dim > 0 and 0 <= order < 3
    pts1d, wts1d = _RULES_1D[order]
    pts1d = 0.5 * (pts1d + 1.0)  # map [-1,1] -> [0,1]
    wts1d = 0.5 * wts1d
    points, weights = [], []
    for combo in itertools.product(range(len(pts1d)), repeat=dim):
        points.append([pts1d[j] for j in combo])
        weights.append(np.prod([wts1d[j] for j in combo]))
    return np.asarray(points, dtype=np.float64), np.asarray(weights, dtype=np.float64)
