"""Export a multigrid hierarchy to the native CPU baseline's binary format.

Counterpart of ``multigridmc_tpu/utils/baseline_export.py``.
``native/baseline_mgmc.cc`` re-creates the reference's sequential CSR hot path
(lexicographic SOR Gibbs sweeps, the MGMC recursion, a dense coarse Cholesky)
to give a single-core CPU baseline; :func:`export_problem` writes a port
hierarchy for it: per level the CSR operator and its diagonal, the low-rank
factor with the reference's lexicographic Woodbury factors ``B_bar``
(``sor_smoother.cc:17-37``) and ``Sigma^-1/2``, the restriction and
prolongation as CSR, and the coarsest level's dense Cholesky factor.  All of it
is host float64 (numpy, scipy), from the port's operators copied to the host.

``measure_baseline_main`` of the JAX module builds the JAX ``bench.py``
problem and runs the binary on it; its counterpart waits for the port's
benchmark entry point.
"""

from __future__ import annotations

import itertools
import struct
from typing import BinaryIO

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..ops.stencil import StencilOperator, _to_numpy, interior_mask
from ..solvers.multigrid import MultigridHierarchy

MAGIC = 0x4D474D43


def stencil_to_csr(op: StencilOperator) -> sp.csr_matrix:
    """CSR form of the stencil part, rows in lexicographic vertex order."""
    vshape = op.vshape
    n = int(np.prod(vshape))
    strides = np.cumprod([1] + list(reversed(vshape)))[:-1][::-1]
    coeffs = _to_numpy(op.coeffs).astype(np.float64)
    rows, cols, vals = [], [], []
    idx = np.arange(n).reshape(vshape)
    for k, off in enumerate(op.offsets):
        shift = int(np.dot(off, strides))
        mask = interior_mask(vshape, off) > 0
        r = idx[mask]
        rows.append(r)
        cols.append(r + shift)
        vals.append(coeffs[k][mask])
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    return A.tocsr()


def transfer_to_csr(fine_vshape, coarse_vshape) -> sp.csr_matrix:
    """Prolongation P (n_fine x n_coarse) as CSR, d-linear weights: column c
    has entries at the fine vertices ``2c + 1 + o``, ``o in {-1, 0, 1}^d``,
    of weight ``prod_d {0.5, 1, 0.5}[o_d]`` (n_fine = 2 n_coarse + 1 per
    dimension, so all in range)."""
    dim = len(fine_vshape)
    nc = int(np.prod(coarse_vshape))
    nf = int(np.prod(fine_vshape))
    fstrides = np.cumprod([1] + list(reversed(fine_vshape)))[:-1][::-1]
    coarse_coords = np.meshgrid(*[np.arange(m) for m in coarse_vshape], indexing="ij")
    fine_base = sum(
        (2 * coarse_coords[d] + 1) * fstrides[d] for d in range(dim)
    ).reshape(-1)
    cols0 = np.arange(nc)
    rows, cols, vals = [], [], []
    w1d = {-1: 0.5, 0: 1.0, 1: 0.5}
    for off in itertools.product((-1, 0, 1), repeat=dim):
        w = 1.0
        shift = 0
        for d in range(dim):
            w *= w1d[off[d]]
            shift += off[d] * fstrides[d]
        rows.append(fine_base + shift)
        cols.append(cols0)
        vals.append(np.full(nc, w))
    P = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nf, nc),
    )
    return P.tocsr()


def _write_i64(fp: BinaryIO, v: int) -> None:
    fp.write(struct.pack("<q", v))


def _write_f64(fp: BinaryIO, v: float) -> None:
    fp.write(struct.pack("<d", v))


def _write_csr(fp: BinaryIO, A: sp.csr_matrix) -> None:
    A = A.tocsr()
    A.sort_indices()
    _write_i64(fp, A.shape[0])
    _write_i64(fp, A.shape[1])
    _write_i64(fp, A.nnz)
    fp.write(np.asarray(A.indptr, dtype=np.int64).tobytes())
    fp.write(np.asarray(A.indices, dtype=np.int64).tobytes())
    fp.write(np.asarray(A.data, dtype=np.float64).tobytes())


def lexicographic_b_bar(A: sp.csr_matrix, B: np.ndarray, Sigma_diag, omega: float):
    """The reference's Woodbury factors of the forward and the backward sweep
    with *lexicographic* splitting (``sor_smoother.cc:17-37``): ``B_bar = Y
    (Sigma + B^T Y)^-1``, ``Y = M^-1 B``, ``M`` the lower (upper) triangle of
    ``A + (1 - omega) / omega D``."""
    D = sp.diags(A.diagonal())
    A_scaled = (A + (1.0 - omega) / omega * D).tocsr()
    M_fw = sp.tril(A_scaled, format="csr")
    M_bw = sp.triu(A_scaled, format="csr")
    Y_fw = spla.spsolve_triangular(M_fw.tocsr(), B, lower=True)
    Y_bw = spla.spsolve_triangular(M_bw.tocsr(), B, lower=False)
    Sigma = np.diag(np.asarray(Sigma_diag))
    Bbar_fw = Y_fw @ np.linalg.inv(Sigma + B.T @ Y_fw)
    Bbar_bw = Y_bw @ np.linalg.inv(Sigma + B.T @ Y_bw)
    return Bbar_fw, Bbar_bw


def export_problem(hierarchy: MultigridHierarchy, path: str, omega: float = 1.0,
                   cycle: int = 2) -> None:
    """Write ``hierarchy`` (any device and dtype; copied to the host in
    float64) in the format ``native/baseline_mgmc.cc`` reads."""
    ops = hierarchy.operators
    nlevel = hierarchy.nlevel
    with open(path, "wb") as fp:
        _write_i64(fp, MAGIC)
        _write_i64(fp, nlevel)
        _write_i64(fp, cycle)
        _write_f64(fp, omega)
        for level, op in enumerate(ops):
            A = stencil_to_csr(op)
            _write_csr(fp, A)
            fp.write(A.diagonal().astype(np.float64).tobytes())
            m = op.m_lowrank
            _write_i64(fp, m)
            if m:
                B = _to_numpy(op.lowrank.B).astype(np.float64).reshape(m, -1).T  # (n, m)
                Sigma_diag = _to_numpy(op.lowrank.Sigma_diag).astype(np.float64)
                Bbar_fw, Bbar_bw = lexicographic_b_bar(A, B, Sigma_diag, omega)
                fp.write(np.ascontiguousarray(B).tobytes())
                fp.write(np.ascontiguousarray(Bbar_fw).tobytes())
                fp.write(np.ascontiguousarray(Bbar_bw).tobytes())
                fp.write((1.0 / np.sqrt(Sigma_diag)).tobytes())
            if level < nlevel - 1:
                P = transfer_to_csr(op.vshape, ops[level + 1].vshape)
                _write_csr(fp, P.T.tocsr())  # R = P^T
                _write_csr(fp, P)
        coarse = ops[-1]
        Q = coarse.to_dense()
        L = np.linalg.cholesky(Q)
        _write_i64(fp, Q.shape[0])
        fp.write(np.ascontiguousarray(L, dtype=np.float64).tobytes())
