"""Structured lattice geometry (numpy only; copy of ``multigridmc_tpu/lattice.py``).

The reference implementation (``src/lattice/lattice.hh:18-129`` and its 1d/2d/3d
subclasses) exposes linear<->Euclidean index conversion for *interior* vertices of a
d-dimensional cell lattice on [0,1]^d, neighbour shifts, fine/coarse vertex
correspondence, and coarsening.  Linear indices are never materialised: fields
live as dense arrays over the interior-vertex grid, and all index algebra becomes
array slicing.  This module provides the small amount of geometry the rest of the
framework needs (shapes, spacings, coordinates, coarsening rules) plus the
linear-index conventions used only by tests and I/O for parity with the reference.

Array layout convention
-----------------------
``shape = (n_0, n_1, ..., n_{d-1})`` counts *cells* per dimension, with dimension 0
being the reference's x-direction.  Interior-vertex fields are stored as arrays of
shape ``vshape = (n_{d-1}-1, ..., n_1-1, n_0-1)`` - i.e. *reversed*, so that C-order
flattening enumerates vertices with x fastest, matching the reference's
lexicographic ordering (``src/lattice/lattice2d.hh:19-42``).  A vertex with array
index ``(i_{d-1}, ..., i_0)`` sits at coordinates ``x_k = (i_k + 1) * h_k`` with
``h_k = 1 / n_k``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A d-dimensional structured cell lattice on [0,1]^d with interior vertices.

    Mirrors the contract of the reference ``Lattice`` family
    (``src/lattice/lattice1d.hh``, ``lattice2d.hh``, ``lattice3d.hh``) but replaces
    index arithmetic with array geometry.
    """

    #: number of cells per dimension, x first (reference order)
    shape: Tuple[int, ...]

    def __post_init__(self):
        if not all(int(n) >= 2 for n in self.shape):
            raise ValueError(f"need at least 2 cells per dimension, got {self.shape}")
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))

    # ------------------------------------------------------------------ geometry
    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def vshape(self) -> Tuple[int, ...]:
        """Shape of interior-vertex field arrays (reversed dimension order)."""
        return tuple(n - 1 for n in reversed(self.shape))

    @property
    def cshape(self) -> Tuple[int, ...]:
        """Shape of cell field arrays (reversed dimension order)."""
        return tuple(reversed(self.shape))

    @property
    def nvertex(self) -> int:
        """Number of interior vertices (unknowns), cf. ``Lattice::Nvertex``."""
        return int(np.prod(self.vshape))

    @property
    def ncell(self) -> int:
        return int(np.prod(self.shape))

    @property
    def h(self) -> Tuple[float, ...]:
        """Grid spacings per dimension (x first)."""
        return tuple(1.0 / n for n in self.shape)

    @property
    def cell_volume(self) -> float:
        """Volume of a single cell, cf. ``src/lattice/lattice.hh`` cell_volume()."""
        return float(np.prod(self.h))

    # ------------------------------------------------------------- coordinates
    def vertex_coordinates(self) -> np.ndarray:
        """Coordinates of interior vertices, shape ``(*vshape, dim)``.

        The trailing axis is in reference (x, y, z) order, matching
        ``Lattice::vertex_coordinates`` (used for kappa(x) evaluation).
        """
        axes = [
            (np.arange(1, n, dtype=np.float64)) / n  # coordinates h, 2h, ..., (n-1)h
            for n in self.shape
        ]
        # vshape is reversed dim order: build meshgrid accordingly
        grids = np.meshgrid(*reversed(axes), indexing="ij")  # each has shape vshape
        # grids[0] varies along axis 0 = dimension d-1 ... grids[-1] = dimension 0
        coords = np.stack(list(reversed(grids)), axis=-1)  # (..., dim) with x first
        return coords

    def cell_coordinates(self, offset: float = 0.0) -> np.ndarray:
        """Coordinates of cell corners (lower-left + offset*h), shape ``(*cshape, dim)``."""
        axes = [(np.arange(n, dtype=np.float64) + offset) / n for n in self.shape]
        grids = np.meshgrid(*reversed(axes), indexing="ij")
        return np.stack(list(reversed(grids)), axis=-1)

    # ------------------------------------------------------------- coarsening
    @property
    def coarsenable(self) -> bool:
        """True if the lattice can be coarsened (cf. ``lattice2d.hh:198-213``)."""
        return all(n % 2 == 0 and n >= 4 for n in self.shape)

    def coarsen(self) -> "Lattice":
        """Next-coarser lattice with half the cells per dimension."""
        if not self.coarsenable:
            raise ValueError(
                f"lattice with shape {self.shape} cannot be coarsened "
                "(extents must be even and >= 4)"
            )
        return Lattice(tuple(n // 2 for n in self.shape))

    def hierarchy(self, nlevel: int) -> Tuple["Lattice", ...]:
        """The ``nlevel``-deep multigrid hierarchy rooted at this lattice."""
        levels = [self]
        for _ in range(nlevel - 1):
            levels.append(levels[-1].coarsen())
        return tuple(levels)

    # ----------------------------------------------- linear-index parity helpers
    # These mirror the reference index maps exactly; used by tests and I/O only.
    def vertexidx_linear2euclidean(self, ell: int) -> Tuple[int, ...]:
        """Linear interior-vertex index -> Euclidean coords (1-based, x first).

        Matches ``Lattice2d::vertexidx_linear2euclidean`` semantics: coordinate
        ``p_k`` runs from 1 to n_k - 1.
        """
        p = []
        for n in self.shape:
            p.append(ell % (n - 1) + 1)
            ell //= n - 1
        return tuple(p)

    def vertexidx_euclidean2linear(self, p: Tuple[int, ...]) -> int:
        """Euclidean coords (1-based, x first) -> linear interior-vertex index."""
        ell = 0
        for k in reversed(range(self.dim)):
            assert 1 <= p[k] <= self.shape[k] - 1, f"vertex {p} not interior"
            ell = ell * (self.shape[k] - 1) + (p[k] - 1)
        return ell

    def cellidx_linear2euclidean(self, ell: int) -> Tuple[int, ...]:
        """Linear cell index -> Euclidean cell coords (0-based, x first)."""
        p = []
        for n in self.shape:
            p.append(ell % n)
            ell //= n
        return tuple(p)

    def cellidx_euclidean2linear(self, p: Tuple[int, ...]) -> int:
        ell = 0
        for k in reversed(range(self.dim)):
            assert 0 <= p[k] <= self.shape[k] - 1
            ell = ell * self.shape[k] + p[k]
        return ell

    def fine_vertex_idx(self, coarse_array_idx: Tuple[int, ...]) -> Tuple[int, ...]:
        """Array index on the fine grid of a coarse interior vertex.

        A coarse interior vertex with (0-based) array index ``i`` corresponds to
        fine array index ``2 i + 1`` per dimension, the array-layout analogue of
        ``Lattice1d::fine_vertex_idx`` (= 2 ell + 1, ``lattice1d.hh:145-148``).
        """
        return tuple(2 * i + 1 for i in coarse_array_idx)

    def get_info(self) -> str:
        return "x".join(str(n) for n in self.shape)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Lattice({self.get_info()})"
