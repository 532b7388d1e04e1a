"""Stencil linear operators on dense lattice fields.

Counterpart of ``multigridmc_tpu/ops/stencil.py``.  An operator couples each
interior vertex to the vertices at a small fixed set of offsets; it is stored
as a coefficient tensor ``(n_offsets, *grid)`` and applied as a
shift-multiply-accumulate over dense fields.  Homogeneous Dirichlet boundary
conditions are implicit: fields live on interior vertices only and shifted
reads outside the grid return zero.

The optional low-rank term ``A = A_stencil + B Sigma^{-1} B^T`` keeps ``B`` as a
dense ``(m, *grid)`` tensor (m = number of measurements, small).

Every function accepts leading batch (chain) dimensions in front of the grid
dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..lattice import Lattice
from ..utils import runtime  # noqa: F401  (sets the matmul precision policy)

Offset = Tuple[int, ...]


def shift(x: torch.Tensor, offset: Offset) -> torch.Tensor:
    """Return ``z`` with ``z[i] = x[i + offset]``, zero outside the grid.

    ``offset`` is in array-axis order (slowest axis first) and addresses the
    trailing grid axes; leading axes are batch dims.  Pad + slice.
    """
    if all(o == 0 for o in offset):
        return x
    extra = x.ndim - len(offset)
    pads, slices = [], [slice(None)] * extra
    for o, n in zip(offset, x.shape[extra:]):
        if o >= 0:
            pads.append((0, o))
            slices.append(slice(o, o + n))
        else:
            pads.append((-o, 0))
            slices.append(slice(0, n))
    # F.pad lists the LAST dimension first
    flat = [p for pair in reversed(pads) for p in pair]
    return F.pad(x, flat)[tuple(slices)]


def interior_mask(vshape: Tuple[int, ...], offset: Offset) -> np.ndarray:
    """Mask that is 1 where ``i + offset`` is still inside the grid."""
    m = np.ones(vshape, dtype=np.float64)
    for ax, (o, n) in enumerate(zip(offset, vshape)):
        idx = [slice(None)] * len(vshape)
        if o > 0:
            idx[ax] = slice(n - o, n)
            m[tuple(idx)] = 0.0
        elif o < 0:
            idx[ax] = slice(0, -o)
            m[tuple(idx)] = 0.0
    return m


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@dataclasses.dataclass(frozen=True)
class LowRank:
    """Low-rank update ``B Sigma^{-1} B^T`` with B stored as dense grids:
    ``B`` is ``(m, *vshape)``, ``Sigma_diag`` is ``(m,)``."""

    B: torch.Tensor
    Sigma_diag: torch.Tensor

    @property
    def m(self) -> int:
        return self.B.shape[0]

    def bt(self, x: torch.Tensor) -> torch.Tensor:
        """``B^T x`` -> shape ``(*batch, m)``."""
        d = self.B.ndim - 1
        batch = x.shape[: x.ndim - d]
        xf = x.reshape(batch + (-1,))
        return xf @ self.B.reshape(self.m, -1).T

    def expand(self, w: torch.Tensor) -> torch.Tensor:
        """``sum_k w[..., k] B_k`` -> shape ``(*batch, *vshape)``."""
        out = w @ self.B.reshape(self.m, -1)
        return out.reshape(w.shape[:-1] + self.B.shape[1:])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``B Sigma^{-1} B^T x`` for a grid field x (leading batch dims ok)."""
        return self.expand(self.bt(x) / self.Sigma_diag)

    def diag(self) -> torch.Tensor:
        """Diagonal of ``B Sigma^{-1} B^T`` as a grid field."""
        s = self.Sigma_diag.reshape((-1,) + (1,) * (self.B.ndim - 1))
        return (self.B * (self.B / s)).sum(dim=0)

    def to(self, device=None, dtype=None) -> "LowRank":
        return LowRank(B=self.B.to(device=device, dtype=dtype),
                       Sigma_diag=self.Sigma_diag.to(device=device, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Symmetric positive-definite lattice operator
    ``A = A_stencil + B Sigma^{-1} B^T``."""

    coeffs: torch.Tensor  # (n_offsets, *vshape)
    offsets: Tuple[Offset, ...]
    lattice: Lattice
    lowrank: Optional[LowRank] = None

    def __post_init__(self):
        object.__setattr__(
            self, "offsets", tuple(tuple(int(o) for o in off) for off in self.offsets))
        if (0,) * len(self.offsets[0]) not in self.offsets:
            raise ValueError("stencil must contain the zero offset (diagonal)")

    # ------------------------------------------------------------------ basics
    @property
    def vshape(self) -> Tuple[int, ...]:
        return self.lattice.vshape

    @property
    def dim(self) -> int:
        return len(self.offsets[0])

    @property
    def diag_index(self) -> int:
        return self.offsets.index((0,) * self.dim)

    @property
    def m_lowrank(self) -> int:
        return 0 if self.lowrank is None else self.lowrank.m

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    def to(self, device=None, dtype=None) -> "StencilOperator":
        """The same operator on another device and/or in another dtype."""
        if device is None and dtype is None:
            return self
        lr = None if self.lowrank is None else self.lowrank.to(device, dtype)
        return dataclasses.replace(
            self, coeffs=self.coeffs.to(device=device, dtype=dtype), lowrank=lr)

    def diag_stencil(self) -> torch.Tensor:
        """Diagonal of the stencil (sparse) part, as a grid field."""
        return self.coeffs[self.diag_index]

    def diag_full(self) -> torch.Tensor:
        """Diagonal of the full operator including the low-rank term."""
        d = self.diag_stencil()
        if self.lowrank is not None:
            d = d + self.lowrank.diag()
        return d

    # ------------------------------------------------------------------- apply
    def apply_stencil(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A_stencil x`` - shift-multiply-accumulate over offsets."""
        y = None
        for k, off in enumerate(self.offsets):
            t = self.coeffs[k] * shift(x, off)
            y = t if y is None else y + t
        return y

    def apply_offdiag(self, x: torch.Tensor) -> torch.Tensor:
        """``(A_stencil - diag) x`` - used by coloured Gauss-Seidel sweeps."""
        y = None
        for k, off in enumerate(self.offsets):
            if k == self.diag_index:
                continue
            t = self.coeffs[k] * shift(x, off)
            y = t if y is None else y + t
        return y

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x`` including the low-rank term."""
        y = self.apply_stencil(x)
        if self.lowrank is not None:
            y = y + self.lowrank.matvec(x)
        return y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    # -------------------------------------------------------------- validation
    def normalized(self) -> "StencilOperator":
        """Zero out coefficients whose target vertex lies outside the grid
        (they never act; zeroing makes dense conversions exact)."""
        masks = np.stack([interior_mask(self.vshape, off) for off in self.offsets])
        masks = torch.as_tensor(masks, dtype=self.coeffs.dtype, device=self.coeffs.device)
        return dataclasses.replace(self, coeffs=self.coeffs * masks)

    def to_dense_stencil(self) -> np.ndarray:
        """Dense (n, n) float64 matrix of the stencil part, rows/cols in
        lexicographic vertex order.  For validation on small lattices only."""
        vshape = self.vshape
        n = int(np.prod(vshape))
        coeffs = _to_numpy(self.coeffs).astype(np.float64)
        A = np.zeros((n, n))
        idx = np.arange(n).reshape(vshape)
        for k, off in enumerate(self.offsets):
            mask = interior_mask(vshape, off)
            tgt = np.full(vshape, -1, dtype=np.int64)
            slices_dst, slices_src = [], []
            for o, m in zip(off, vshape):
                if o >= 0:
                    slices_dst.append(slice(0, m - o))
                    slices_src.append(slice(o, m))
                else:
                    slices_dst.append(slice(-o, m))
                    slices_src.append(slice(0, m + o))
            tgt[tuple(slices_dst)] = idx[tuple(slices_src)]
            valid = mask > 0
            A[idx[valid], tgt[valid]] += coeffs[k][valid]
        return A

    def to_dense(self) -> np.ndarray:
        """Dense float64 matrix of the full operator (incl. low-rank)."""
        A = self.to_dense_stencil()
        if self.lowrank is not None:
            B = _to_numpy(self.lowrank.B).astype(np.float64).reshape(self.m_lowrank, -1).T
            S = _to_numpy(self.lowrank.Sigma_diag).astype(np.float64)
            A = A + B @ np.diag(1.0 / S) @ B.T
        return A

    def precision(self) -> np.ndarray:
        return self.to_dense()

    def covariance(self) -> np.ndarray:
        """Dense covariance = precision^{-1} (small problems only)."""
        return np.linalg.inv(self.to_dense())
