"""Direct (exact) samplers via Cholesky factorisation of the precision matrix.

Counterpart of ``multigridmc_tpu/samplers/cholesky.py``.  Given the full
precision ``Q = A_stencil + B Sigma^-1 B^T = L L^T``, a sample is

    1. xi ~ N(0, I)
    2. solve L g = f
    3. solve L^T x = xi + g

Two backends:

* :class:`DenseCholeskySampler` - dense on-device factorisation: the right tool
  for the (tiny) coarsest multigrid level and for small standalone problems.
* :class:`BandCholeskySampler` (the ``"sparse"`` factorisation) - a lattice
  stencil in lexicographic order is banded with bandwidth ``b`` = the product of
  the minor extents, and its band Cholesky factor holds all fill-in, so it *is*
  the exact sparse factor.  The band is built straight from the stencil's
  offsets and coefficients (``O(n b)`` memory; ``Q`` is never densified) and
  factorised once on the host in float64 (``scipy.linalg.cholesky_banded``,
  ``O(n b^2)``); the draws' solves run on the device over dense ``b x b``
  blocks (:class:`BandFactor`), the mean ``Q^-1 f`` is solved in float64 on the
  host (:class:`BandWoodbury`).  The low-rank term enters through an exact
  Woodbury correction at sampling time.  This is the exactness baseline the MGMC
  sampler is compared against.

The factorisations, the triangular solves and the block products are library
calls (``torch.linalg``, ``torch.bmm``), as they are outside any kernel in the
JAX package too (``solve_triangular``, ``einsum``, ``lax.scan``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.band import band_factor, band_solve
from ..ops.stencil import StencilOperator, _to_numpy
from ..utils import runtime  # noqa: F401  (sets the matmul precision policy)
from .base import NoiseSource, Sampler


class DenseCholeskySampler(Sampler):
    """Densify the full precision (incl. low-rank) in float64 on the host,
    cast to the operator's dtype and factorise once at setup."""

    def __init__(self, op: StencilOperator, device=None, dtype=None):
        op = op.to(device, dtype)
        super().__init__(op)
        Q = torch.as_tensor(op.to_dense(), dtype=op.dtype, device=op.device)
        self.L = torch.linalg.cholesky(Q)  # Q = L L^T
        self._n = int(np.prod(op.vshape))

    def _solve_L(self, v: torch.Tensor) -> torch.Tensor:
        """Solve ``L g = v``; v has shape ``(*batch, n)``."""
        vt = v.reshape(-1, v.shape[-1]).T  # (n, batch)
        g = torch.linalg.solve_triangular(self.L, vt, upper=False)
        return g.T.reshape(v.shape)

    def _solve_LT(self, v: torch.Tensor) -> torch.Tensor:
        """Solve ``L^T x = v``."""
        vt = v.reshape(-1, v.shape[-1]).T
        y = torch.linalg.solve_triangular(self.L.T, vt, upper=True)
        return y.T.reshape(v.shape)

    def apply(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        vdim = len(self.op.vshape)
        n = self._n
        batch = x.shape[: x.ndim - vdim]
        fbatch = f.shape[: f.ndim - vdim]
        xi = noise.normal(batch + (n,), x.dtype, x.device)
        g = self._solve_L(f.reshape(fbatch + (n,)))
        y = self._solve_LT(xi + g)  # g broadcasts over the chain batch
        return y.reshape(x.shape)


#: device-memory budget (bytes) of the recursive-doubling level tensors; above
#: it ``parallel=None`` takes the sequential block scan.  The environment
#: variable ``MGMC_BAND_PARALLEL_GB`` sets it, as it does for the JAX package.
_PARALLEL_BYTES = int(
    float(os.environ.get("MGMC_BAND_PARALLEL_GB", "4")) * 2**30
)


def _assert_full_float32() -> None:
    """The band solves need full float32 products (the process-wide policy of
    ``utils/runtime``): the doubling's explicit prefix products amplify
    rounding, and TF32 keeps three digits."""
    assert torch.get_float32_matmul_precision() == "highest", \
        "a band solve under TF32: float32 matmul precision must be 'highest'"


class BandFactor:
    """Blocked triangular solves with a banded Cholesky factor on the device.

    The factor ``cb`` (``cb[k, j] = L[j + k, j]``, from
    ``scipy.linalg.cholesky_banded``) is cut into ``nb`` diagonal blocks
    ``Ld_i`` and subdiagonal blocks ``Ls_i`` of ``blk = max(b, 1)`` rows; the
    last block is padded with a unit diagonal.  Two substitution strategies:

    * sequential (``parallel=False``): one block at a time - a triangular solve
      and one subdiagonal product per block; exact but latency bound.
    * recursive doubling (``parallel=True``): ``g_i = M_i g_{i-1} + c_i`` with
      ``M_i = -Ld_i^-1 Ls_i`` and ``c_i = Ld_i^-1 v_i`` is an affine prefix
      whose level products ``M^(l)_i = M^(l-1)_i M^(l-1)_{i-2^(l-1)}`` do not
      depend on the data: they are built once, and a solve is then
      ``ceil(log2 nb)`` batched products ``c_i += M^(l)_i c_{i-2^l}``.  Each
      level tensor is full size with its first ``2^l`` blocks zero, so build
      and solve multiply a rolled operand (the JAX package's aligned form).
      Costs ``2 L nb blk^2`` words of device memory for the levels.

    ``parallel=None`` takes the doubling on a CUDA device where at least 8
    blocks are there and the level tensors fit :data:`_PARALLEL_BYTES`, the
    scan otherwise (the CPU).  Every product runs in full float32 (or the
    factor's float64); a solve under TF32 fails its assert."""

    def __init__(self, cb: np.ndarray, dtype=None, device=None,
                 parallel: Optional[bool] = None):
        device = runtime.resolve_device(device)
        dtype = runtime.resolve_dtype(dtype)
        b, n = cb.shape[0] - 1, cb.shape[1]
        blk = max(b, 1)
        nb = -(-n // blk)
        npad = nb * blk
        cbp = np.zeros((b + 1, npad))
        cbp[:, :n] = cb
        cbp[0, n:] = 1.0  # unit diagonal on the padding
        self.n, self.blk, self.nb = n, blk, nb
        self.dtype, self.device = dtype, device

        r, c = np.meshgrid(np.arange(blk), np.arange(blk), indexing="ij")
        i = np.arange(nb).reshape(-1, 1, 1)
        # diagonal blocks: L[i blk + r, i blk + c] = cbp[r - c, i blk + c]
        k1 = np.clip(r - c, 0, b)
        Ld = np.where(r >= c, cbp[k1, i * blk + c], 0.0)
        # subdiagonal blocks: L[i blk + r, (i-1) blk + c] = cbp[blk + r - c, (i-1) blk + c]
        k2 = np.clip(blk + r - c, 0, b)
        cols = np.maximum(i - 1, 0) * blk + c
        Ls = np.where((blk + r - c <= b) & (i > 0), cbp[k2, cols], 0.0)
        self.Ld = torch.as_tensor(Ld, dtype=dtype, device=device)
        self.Ls = torch.as_tensor(Ls, dtype=dtype, device=device)
        del Ld, Ls, k1, k2, cols
        if parallel is None:
            parallel = self._auto_parallel()
        self.parallel = bool(parallel)
        self.Linv = None
        self._lev_L, self._lev_LT = [], []
        if self.parallel:
            self._build_doubling()

    # ------------------------------------------------ recursive doubling
    @property
    def n_levels(self) -> int:
        """Products of the doubling: ``ceil(log2 nb)``."""
        return (self.nb - 1).bit_length()

    def level_bytes(self) -> int:
        """Device bytes of both directions' level tensors."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 2 * self.n_levels * self.nb * self.blk * self.blk * itemsize

    def _auto_parallel(self) -> bool:
        if self.nb < 8 or self.device.type != "cuda":
            return False  # scan latency negligible, or no device to batch on
        return self.level_bytes() <= _PARALLEL_BYTES

    @staticmethod
    def _doubling_levels(M: torch.Tensor, nb: int):
        """``M^(l)`` for ``l = 0 .. L-1``.  ``M_0 = 0``, and zeros propagate
        through the products: the rolled operand's wrapped-in tail meets the
        zero head blocks, so the first ``2^(l+1)`` blocks of the next level are
        exactly zero."""
        levels = []
        step = 1
        while step < nb:
            levels.append(M)
            if 2 * step < nb:
                M = torch.bmm(M, torch.roll(M, step, dims=0))
            step *= 2
        return levels

    def _build_doubling(self) -> None:
        _assert_full_float32()
        eye = torch.eye(self.blk, dtype=self.dtype, device=self.device)
        Linv = torch.linalg.solve_triangular(
            self.Ld, eye.expand(self.nb, self.blk, self.blk), upper=False)
        # forward: g_i = M_i g_{i-1} + Linv_i v_i, M_i = -Linv_i Ls_i
        self._lev_L = self._doubling_levels(-torch.bmm(Linv, self.Ls), self.nb)
        # backward: x_i = Mb_i x_{i+1} + Ld_i^-T v_i with
        # Mb_i = -(Ls_{i+1} Linv_i)^T; reversing the block index turns it
        # into the same forward recurrence
        Ls_next = torch.cat([self.Ls[1:], torch.zeros_like(self.Ls[:1])], 0)
        Mb = -torch.bmm(Ls_next, Linv).transpose(1, 2)
        self._lev_LT = self._doubling_levels(Mb.flip(0).contiguous(), self.nb)
        self.Linv = Linv

    @staticmethod
    def _doubling_apply(levels, c: torch.Tensor) -> torch.Tensor:
        """The prefix ``c_i += M^(l)_i c_{i-2^l}``, level by level."""
        step = 1
        for M in levels:
            c = c + torch.bmm(torch.roll(c, step, dims=0), M.transpose(1, 2))
            step *= 2
        return c

    # ------------------------------------------------------------ blocks
    def _blocks(self, v: torch.Tensor):
        """``(..., n)`` -> ``(nb, K, blk)`` with K the flattened batch."""
        _assert_full_float32()
        batch = v.shape[:-1]
        vp = torch.nn.functional.pad(v.reshape(-1, self.n),
                                     (0, self.nb * self.blk - self.n))
        return vp.reshape(-1, self.nb, self.blk).transpose(0, 1).contiguous(), batch

    def _unblocks(self, g: torch.Tensor, batch):
        out = g.transpose(0, 1).reshape(-1, self.nb * self.blk)[:, : self.n]
        return out.reshape(tuple(batch) + (self.n,))

    def solve_L(self, v: torch.Tensor) -> torch.Tensor:
        """Solve ``L g = v``; ``v`` of shape ``(..., n)``."""
        vb, batch = self._blocks(v)
        if self.parallel:
            c = torch.bmm(vb, self.Linv.transpose(1, 2))
            return self._unblocks(self._doubling_apply(self._lev_L, c), batch)
        gs = torch.empty_like(vb)
        g = torch.zeros_like(vb[0])
        for i in range(self.nb):
            rhs = vb[i] - g @ self.Ls[i].T
            g = torch.linalg.solve_triangular(self.Ld[i], rhs.T, upper=False).T
            gs[i] = g
        return self._unblocks(gs, batch)

    def solve_LT(self, v: torch.Tensor) -> torch.Tensor:
        """Solve ``L^T x = v`` (reverse block substitution)."""
        vb, batch = self._blocks(v)
        if self.parallel:
            # Ld_i^-T v_i, then the reversed-index forward recurrence
            c = torch.bmm(vb, self.Linv).flip(0)
            x = self._doubling_apply(self._lev_LT, c).flip(0)
            return self._unblocks(x, batch)
        # x_i = Ld_i^-T (v_i - Ls_{i+1}^T x_{i+1})
        xs = torch.empty_like(vb)
        x = torch.zeros_like(vb[0])
        for i in range(self.nb - 1, -1, -1):
            rhs = vb[i] if i == self.nb - 1 else vb[i] - x @ self.Ls[i + 1]
            x = torch.linalg.solve_triangular(self.Ld[i].T, rhs.T, upper=True).T
            xs[i] = x
        return self._unblocks(xs, batch)

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        """Solve ``L L^T x = v``."""
        return self.solve_LT(self.solve_L(v))


class BandWoodbury:
    """The host float64 pieces of ``Q = A + B Sigma^-1 B^T`` shared by the band
    sampler and the band solver: the band Cholesky factor ``cb`` of the stencil
    part ``A`` (``cb[k, j] = L[j + k, j]``, ``O(n b)`` memory, ``Q`` never
    densified), its bandwidth, and the Woodbury pieces ``W = A^-1 B S^-1``,
    ``S = Sigma + B^T A^-1 B``, ``B`` (``(n, m)`` each) and ``Sigma``'s
    diagonal, None without a low-rank term.

    :meth:`solve` gives ``Q^-1 f`` in float64 on the host (``O(n b)`` per
    right-hand side).  Nothing else may: with near-exact measurements the
    Woodbury step ``t - W (B^T t)``, ``t = A^-1 f``, cancels almost
    completely, and in float32 on the device it was off by far more than a
    sampling error (on a 32^2 posterior by 2%, 15 standard errors)."""

    def __init__(self, op: StencilOperator):
        self.cb, self.bandwidth = band_factor(op)
        self.n = self.cb.shape[1]
        self.W = self.B = self.Sigma = None
        if op.lowrank is not None:
            m = op.m_lowrank
            self.B = _to_numpy(op.lowrank.B).astype(np.float64).reshape(m, -1).T.copy()
            Ainv_B = band_solve(self.cb, self.B)  # (n, m)
            self.Sigma = _to_numpy(op.lowrank.Sigma_diag).astype(np.float64)
            S = np.diag(self.Sigma) + self.B.T @ Ainv_B
            self.W = Ainv_B @ np.linalg.inv(S)

    def solve(self, f: torch.Tensor, dtype, device) -> torch.Tensor:
        """``Q^-1 f`` for ``f`` of shape ``(..., n)``, solved in float64 on the
        host and returned in ``dtype`` on ``device``."""
        f64 = _to_numpy(f).astype(np.float64)
        t = band_solve(self.cb, f64.reshape(-1, self.n).T).T
        if self.W is not None:
            t = t - (t @ self.B) @ self.W.T
        return torch.as_tensor(t.reshape(f64.shape), dtype=dtype, device=device)


class BandCholeskySampler(Sampler):
    """Band (``"sparse"``) Cholesky sampler.

    A band factor cannot absorb the dense measurement columns (one dense column
    makes the band full), so only the banded stencil part ``A`` is factorised
    and the rank-m term is corrected exactly at sampling time:

        y   ~ N(0, A^-1)            y = L^-T xi            (band solve)
        eta ~ N(0, Sigma)
        x   = mu + y - W (B^T y + eta),   W = A^-1 B S^-1,
        S   = Sigma + B^T A^-1 B

    so that ``cov(x - mu) = A^-1 - W S W^T = Q^-1`` exactly (Woodbury), with
    ``mu = Q^-1 f`` through the same identity.  The host pieces are a
    :class:`BandWoodbury`; the draw's solve runs on the device
    (:class:`BandFactor`).  ``apply`` draws ``xi`` (``batch + (n,)``), then
    ``eta`` (``batch + (m,)``).

    The mean ``mu`` is solved in float64 on the host
    (:meth:`BandWoodbury.solve`), so that a float32 chain carries no mean
    bias: once by ``fix_rhs`` (what the drivers do), else in every ``apply``
    (a host round trip of ``f``)."""

    def __init__(self, op: StencilOperator, device=None, dtype=None):
        op = op.to(device, dtype)
        super().__init__(op)
        self.host = BandWoodbury(op)
        self.bandwidth = self.host.bandwidth
        self.factor = BandFactor(self.host.cb, op.dtype, op.device)
        self._n = self.factor.n
        self._mu = None
        self.W = None
        if self.host.W is not None:
            kw = dict(dtype=op.dtype, device=op.device)
            self.W = torch.as_tensor(self.host.W, **kw)
            self.B_flat = torch.as_tensor(self.host.B, **kw)
            self.sqrt_Sigma = torch.as_tensor(np.sqrt(self.host.Sigma), **kw)

    def _mean(self, f) -> torch.Tensor:
        """``mu = Q^-1 f`` in float64 on the host, for a grid field ``f``
        with leading batch dims."""
        f = torch.as_tensor(f)
        vdim = len(self.op.vshape)
        f = f.reshape(f.shape[: f.ndim - vdim] + (self._n,))
        return self.host.solve(f, self.op.dtype, self.op.device)

    def fix_rhs(self, f) -> None:
        self._mu = self._mean(f)

    def unfix_rhs(self) -> None:
        self._mu = None

    def apply(self, noise: NoiseSource, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        vdim = len(self.op.vshape)
        batch = x.shape[: x.ndim - vdim]
        dt, dev = self.op.dtype, self.op.device
        xi = noise.normal(batch + (self._n,), dt, dev)
        y = self.factor.solve_LT(xi)  # N(0, A^-1)
        if self.W is not None:
            eta = self.sqrt_Sigma * noise.normal(batch + (self.op.m_lowrank,), dt, dev)
            y = y - (y @ self.B_flat + eta) @ self.W.T
        mu = self._mu if self._mu is not None else self._mean(f)
        return (mu + y).reshape(x.shape)


#: the name of the reference's factorisation switch
SparseCholeskySampler = BandCholeskySampler
