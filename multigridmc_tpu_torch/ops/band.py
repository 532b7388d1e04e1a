"""Band storage of a lattice stencil and its float64 band Cholesky solve on the
host.

A stencil in lexicographic order is banded with bandwidth ``b`` = the largest
lexicographic distance of an offset (the product of the minor extents for a
reach-1 stencil), and its band Cholesky factor holds all fill-in.  The band
sampler and solver (``samplers/cholesky.py``) and the drivers' exact moments
(``models/posterior.py``) build it from here.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from .stencil import StencilOperator, _to_numpy, interior_mask


def band_matrix_stencil(op: StencilOperator):
    """Lower band storage ``ab[k, j] = A[j + k, j]`` of the *stencil part* of
    ``op`` in float64, and its bandwidth ``b``: the largest lexicographic
    distance of an offset (the product of the minor extents for a reach-1
    stencil), whatever the measurements.

    Built from the offsets and coefficients, ``O(n b)`` memory: the entry
    ``A[i, i + d]`` of an offset with lexicographic distance ``d <= 0`` is its
    coefficient at vertex ``i`` where ``i + offset`` lies inside the grid, so
    it lands at ``ab[-d, i + d]``.  No two offsets meet at one entry, and every
    entry of the band no offset reaches stays zero - the same array that the
    JAX package reads off the dense matrix."""
    vshape = tuple(op.vshape)
    n = int(np.prod(vshape))
    strides = np.cumprod([1] + list(reversed(vshape)))[:-1][::-1]  # array order
    dists = [int(np.dot(off, strides)) for off in op.offsets]
    b = max(abs(d) for d in dists)
    coeffs = _to_numpy(op.coeffs).astype(np.float64).reshape(len(op.offsets), n)
    ab = np.zeros((b + 1, n))
    rows = np.arange(n)
    for k, (off, d) in enumerate(zip(op.offsets, dists)):
        if d > 0:
            continue  # the upper triangle: the band stores the lower one
        valid = interior_mask(vshape, off).reshape(n) > 0
        ab[-d, rows[valid] + d] += coeffs[k][valid]
    return ab, b


def band_factor(op: StencilOperator):
    """The lower band Cholesky factor ``cb[k, j] = L[j + k, j]`` of the stencil
    part of ``op``, float64 on the host (``scipy.linalg.cholesky_banded``,
    ``O(n b^2)``), and its bandwidth ``b``."""
    ab, b = band_matrix_stencil(op)
    return scipy.linalg.cholesky_banded(ab, lower=True), b


def band_solve(cb: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Host float64 solve of ``L L^T x = v`` from the lower band factor
    ``cb[k, j] = L[j + k, j]`` (``O(n b)`` per right-hand side; ``v`` is
    ``(n,)`` or ``(n, k)``)."""
    return scipy.linalg.cho_solve_banded((cb, True), v)
