"""The port's exact band samplers against the JAX package, on the CPU.

* Band storage: ``ops.band.band_matrix_stencil`` builds the lower band straight from the
  stencil's offsets and coefficients; it must equal the JAX package's, which
  reads it off the dense matrix, bitwise (1d, 2d and 3d; prior and posterior).
* ``BandFactor``: the three solves, sequential scan and recursive doubling,
  against the JAX package's ``BandFactor`` and scipy in float64 (``1e-12``),
  including one block (nb = 1) and an n that the block size does not divide;
  the float32 doubling residual on the 32^2 FD band (``5e-4``, and at most 50x
  the scan's, as the JAX package gates it).
* ``BandCholeskySampler`` replaying the JAX sampler's recorded ``xi`` and
  ``eta`` (``rtol 1e-9``), with and without ``fix_rhs``, and its moments on the
  reference's 1d operator; ``BandCholeskySolver`` against the JAX package's
  (``1e-12``).
* In float32, on a near-exact 32^2 posterior where the Woodbury step cancels
  almost completely: the solver's solution and the sampler's mean (with and
  without ``fix_rhs``) against a dense float64 solve of the same rhs, within
  ``1e-6`` of the solution's largest entry - the rounding of a float64 solve.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConstant
from multigridmc_tpu.models.posterior import measured_operator as jmeasured
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshiftedlaplace_fd
from multigridmc_tpu.samplers import cholesky as jchol
from multigridmc_tpu.solvers.cholesky import BandCholeskySolver as JBandCholeskySolver

from multigridmc_tpu_torch.ops.band import band_matrix_stencil, band_solve
from multigridmc_tpu_torch.samplers import cholesky as pchol
from multigridmc_tpu_torch.samplers.base import GeneratorNoise, ReplayNoise
from multigridmc_tpu_torch.solvers.cholesky import BandCholeskySolver

from test_sampler import make_operator_1d
from test_torch_common import CPU, assert_close, measurement_params, to_port, tt

#: float64 solves: summation order only
SOLVE = dict(rtol=1e-12, atol=1e-12)
REPLAY = dict(rtol=1e-9, atol=1e-11)


def _jax_op(vshape, lowrank):
    op = jshiftedlaplace_fd(JLattice(vshape), JConstant(0.3), dtype=jnp.float64)
    if lowrank:
        op = jmeasured(op, measurement_params(n_meas=3, dim=len(vshape)))
    return op


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
@pytest.mark.parametrize("vshape", [(9,), (8, 6), (5, 4, 6)], ids=["1d", "2d", "3d"])
def test_band_storage_bitwise(vshape, lowrank):
    a = _jax_op(vshape, lowrank)
    want, b_want = jchol._band_matrix_stencil(a)
    got, b_got = band_matrix_stencil(to_port(a))
    assert b_got == b_want
    np.testing.assert_array_equal(got, want)
    # float32 coefficients too: read as float64, as the JAX package reads them
    got32, _ = band_matrix_stencil(to_port(a, torch.float32))
    want32, _ = jchol._band_matrix_stencil(
        dataclasses.replace(a, coeffs=jnp.asarray(np.asarray(a.coeffs), jnp.float32)))
    np.testing.assert_array_equal(got32, want32)


def _random_band(n, b, rng):
    A = np.zeros((n, n))
    for i in range(n):
        A[i, max(0, i - b):i] = rng.uniform(-0.3, 0.3, size=min(i, b))
        A[i, i] = b + 1.0
    Q = A @ A.T
    ab = np.zeros((b + 1, n))
    for k in range(b + 1):
        ab[k, : n - k] = np.diagonal(Q, -k)
    return scipy.linalg.cholesky_banded(ab, lower=True)


@pytest.mark.parametrize("parallel", [False, True], ids=["scan", "doubling"])
@pytest.mark.parametrize("n,b", [(40, 3), (65, 7), (128, 16), (30, 1), (5, 2), (6, 6)],
                         ids=["40_3", "65_7", "128_16", "30_1", "5_2", "nb1"])
def test_band_factor_solves(n, b, parallel):
    """(65, 7) and (5, 2): n not a multiple of the block; (6, 6): one block,
    a doubling with no level."""
    rng = np.random.default_rng(0)
    cb = _random_band(n, b, rng)
    want = jchol.BandFactor(cb, jnp.float64, parallel=parallel)
    got = pchol.BandFactor(cb, torch.float64, CPU, parallel=parallel)
    assert (got.n, got.blk, got.nb) == (want.n, want.blk, want.nb)
    assert got.parallel == parallel
    v = rng.standard_normal((2, 3, n))
    for name in ("solve_L", "solve_LT", "solve"):
        assert_close(getattr(got, name)(tt(v)), getattr(want, name)(jnp.asarray(v)), **SOLVE)
    bw = cb.shape[0] - 1
    assert_close(got.solve_L(tt(v[0])), scipy.linalg.solve_banded((bw, 0), cb, v[0].T).T, **SOLVE)
    assert_close(got.solve(tt(v[0])), scipy.linalg.cho_solve_banded((cb, True), v[0].T).T,
                 **SOLVE)


def test_band_factor_choice_and_memory(monkeypatch):
    """``parallel=None``: the scan on the CPU (the JAX package picks it off a
    TPU); the doubling's level tensors as counted, ``2 L nb blk^2`` words."""
    cb = _random_band(200, 9, np.random.default_rng(1))
    f = pchol.BandFactor(cb, torch.float64, CPU)
    assert not f.parallel and f.Linv is None
    par = pchol.BandFactor(cb, torch.float32, CPU, parallel=True)
    assert par.n_levels == 5 and len(par._lev_L) == len(par._lev_LT) == 5  # nb = 23
    assert par.level_bytes() == 2 * 5 * 23 * 9 * 9 * 4
    assert all(M.dtype == torch.float32 for M in par._lev_L)
    # the level tensors' head blocks are exactly zero, as the rolled form needs
    for level, M in enumerate(par._lev_L):
        assert not M[: 2 ** level].any()


def test_band_factor_doubling_f32_residual():
    """float32 residual ``||L g - v|| / ||v||`` against the float64 band
    operator on the 32^2 FD prior band (the JAX package's gate, 5e-4), and the
    doubling at most 50x the scan."""
    lattice = JLattice((32, 32))
    a = jshiftedlaplace_fd(lattice, JConstant(0.2))
    ab, b = band_matrix_stencil(to_port(a))
    cb = scipy.linalg.cholesky_banded(ab, lower=True)
    n = ab.shape[1]
    rng = np.random.default_rng(7)
    v = rng.standard_normal((4, n)).astype(np.float32)
    L = np.zeros((n, n))
    for k in range(b + 1):
        L[np.arange(k, n), np.arange(n - k)] = cb[k, : n - k]
    res = {}
    for parallel in (False, True):
        f = pchol.BandFactor(cb.astype(np.float32), torch.float32, CPU, parallel=parallel)
        g = f.solve_L(torch.as_tensor(v)).double().numpy()
        r = np.linalg.norm(g @ L.T - v, axis=1) / np.linalg.norm(v, axis=1)
        assert np.max(r) < 5e-4, (parallel, np.max(r))
        res[parallel] = np.linalg.norm(g @ L.T - v) / np.linalg.norm(v)
    assert res[True] < 50 * max(res[False], 1e-7), res


@pytest.fixture
def recorded_normals(monkeypatch):
    draws = []
    real = jax.random.normal

    def recording(key, shape=(), dtype=None, **kw):
        out = real(key, shape, dtype, **kw) if dtype is not None else real(key, shape, **kw)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "normal", recording)
    return draws


@pytest.mark.parametrize("fixed", [False, True], ids=["rhs_each_call", "fix_rhs"])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_band_sampler_replays_jax_draws(recorded_normals, lowrank, fixed):
    a = _jax_op((10, 9), lowrank)
    rng = np.random.default_rng(2)
    f = rng.normal(size=a.vshape)
    x = rng.normal(size=(3,) + a.vshape)
    jsampler = jchol.BandCholeskySampler(a)
    sampler = pchol.BandCholeskySampler(to_port(a))
    assert sampler.bandwidth == jsampler.bandwidth
    if lowrank:
        assert_close(sampler.W, jsampler.W, **SOLVE)
        assert_close(sampler.sqrt_Sigma, jsampler.sqrt_Sigma, rtol=0, atol=0)
    if fixed:
        jsampler.fix_rhs(jnp.asarray(f))
        sampler.fix_rhs(tt(f))
    want = [jsampler.apply(jax.random.key(3 + i), jnp.asarray(f), jnp.asarray(x))
            for i in range(2)]
    assert len(recorded_normals) == 2 * (2 if lowrank else 1)
    replay = ReplayNoise(recorded_normals)
    got = [sampler.apply(replay, tt(f), tt(x)) for _ in range(2)]
    assert replay.exhausted
    for g, w in zip(got, want):
        assert g.shape == x.shape
        assert_close(g, w, **REPLAY)
    sampler.unfix_rhs()
    assert sampler._mu is None


def test_sparse_name_is_the_band_sampler():
    assert pchol.SparseCholeskySampler is pchol.BandCholeskySampler


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "lowrank"])
def test_band_sampler_1d_moments(lowrank):
    """The reference's 1d operator (tridiag(-1, 6, -1), optionally the rank-2
    update): mean and covariance of 4096 x 30 direct draws within 4e-3, as the
    JAX package's test of its band sampler."""
    op = to_port(make_operator_1d(lowrank))
    sampler = pchol.BandCholeskySampler(op)
    n = op.lattice.nvertex
    rng = np.random.default_rng(1342517)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = tt((Q @ mean_exact).reshape(op.vshape))
    noise = GeneratorNoise(0, CPU)
    nchains, nsteps = 4096, 30
    x = torch.zeros((nchains,) + op.vshape, dtype=torch.float64)
    sx, sxx = np.zeros(n), np.zeros((n, n))
    for _ in range(nsteps):
        x = sampler.apply(noise, f, x)
        xf = x.reshape(nchains, n).numpy()
        sx += xf.sum(axis=0)
        sxx += xf.T @ xf
    total = nchains * nsteps
    Ex = sx / total
    cov = sxx / total - np.outer(Ex, Ex)
    assert np.max(np.abs(Ex - mean_exact)) < 4e-3
    assert np.max(np.abs(cov - np.linalg.inv(Q))) < 4e-3


@pytest.mark.parametrize("batched", [False, True], ids=["one_rhs", "batched"])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_band_solver_matches_jax(lowrank, batched):
    a = _jax_op((12, 11), lowrank)
    rng = np.random.default_rng(4)
    b = rng.normal(size=((3,) if batched else ()) + a.vshape)
    want = JBandCholeskySolver(a).apply(jnp.asarray(b))
    solver = BandCholeskySolver(to_port(a))
    got = solver.apply(tt(b))
    assert got.shape == b.shape
    assert_close(got, want, **SOLVE)
    if lowrank:
        np.testing.assert_allclose(solver.B_bar, np.asarray(JBandCholeskySolver(a).B_bar),
                                   **SOLVE)
    # and the solve itself: Q x = b
    Q = to_port(a).to_dense()
    np.testing.assert_allclose(got.reshape(-1, Q.shape[0]).numpy() @ Q,
                               b.reshape(-1, Q.shape[0]), rtol=1e-10, atol=1e-10)


def test_np_band_solve_matches_jax():
    a = _jax_op((9, 8), False)
    ab, b = band_matrix_stencil(to_port(a))
    cb = scipy.linalg.cholesky_banded(ab, lower=True)
    v = np.random.default_rng(5).normal(size=(ab.shape[1], 4))
    np.testing.assert_allclose(band_solve(cb, v), jchol._np_band_solve(cb, b, v),
                               **SOLVE)


@pytest.mark.parametrize("path", ["solver", "sampler_rhs_each_call", "sampler_fix_rhs"])
def test_band_float32_mean_is_the_float64_solve(path):
    """The float32 entry points solve for ``Q^-1 f`` in float64 (their
    Woodbury step cancels almost completely with near-exact measurements: a
    float32 solve is off by a few % here).  The sampler's mean is read from one
    draw of zero normals."""
    a = jmeasured(jshiftedlaplace_fd(JLattice((32, 32)), JConstant(0.2), dtype=jnp.float64),
                  measurement_params(n_meas=8, variance="near_exact"))
    op = to_port(a, torch.float32)
    Q = to_port(a).to_dense()
    rng = np.random.default_rng(11)
    mu = np.cumsum(np.cumsum(rng.normal(size=a.vshape), 0), 1) / 32  # smooth, O(1)
    f = (Q @ mu.reshape(-1)).astype(np.float32).reshape(a.vshape)
    want = np.linalg.solve(Q, f.reshape(-1).astype(np.float64))
    if path == "solver":
        got = BandCholeskySolver(op).apply(torch.as_tensor(f))
    else:
        sampler = pchol.BandCholeskySampler(op)
        if path == "sampler_fix_rhs":
            sampler.fix_rhs(torch.as_tensor(f))
        zeros = ReplayNoise([np.zeros((1, want.size), np.float32),
                             np.zeros((1, op.m_lowrank), np.float32)])
        got = sampler.apply(zeros, torch.as_tensor(f), torch.zeros((1,) + a.vshape))[0]
    assert got.dtype == torch.float32 and got.shape == a.vshape
    err = np.abs(got.double().numpy().reshape(-1) - want).max()
    assert err < 1e-6 * np.abs(want).max(), (err, np.abs(want).max())
