"""Module-by-module parity of the PyTorch port with the JAX package (CPU,
float64, ``rtol = 1e-10, atol = 1e-12``: only the summation order differs)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import (
    ConstantCorrelationLengthModel as JConst,
    PeriodicCorrelationLengthModel as JPeriodic,
)
from multigridmc_tpu.models import posterior as jposterior
from multigridmc_tpu.models import prior as jprior
from multigridmc_tpu.ops import coloring as jcoloring
from multigridmc_tpu.ops import intergrid as jintergrid
from multigridmc_tpu.ops import quadrature as jquadrature
from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu import smoothers as jsmoothers
from multigridmc_tpu.samplers.cholesky import DenseCholeskySampler as JDenseCholesky
from multigridmc_tpu.solvers.multigrid import MultigridHierarchy as JHierarchy

from multigridmc_tpu_torch.convert import hierarchy_from_numpy
from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import (
    ConstantCorrelationLengthModel,
    PeriodicCorrelationLengthModel,
)
from multigridmc_tpu_torch.models import posterior, prior
from multigridmc_tpu_torch.ops import coloring, intergrid, quadrature
from multigridmc_tpu_torch.ops.coarsen import galerkin_coarsen
from multigridmc_tpu_torch.ops.stencil import shift
from multigridmc_tpu_torch import smoothers
from multigridmc_tpu_torch.samplers.cholesky import DenseCholeskySampler
from multigridmc_tpu_torch.solvers.multigrid import MultigridHierarchy

from test_torch_common import CPU, F64, assert_close, jax_operator, measurement_params, to_port, tt

F64T = torch.float64


# ------------------------------------------------------------ numpy-only copies
@pytest.mark.parametrize("shape", [(8,), (16, 24), (4, 6, 8)])
def test_lattice_equal_field_for_field(shape):
    a, b = JLattice(shape), Lattice(shape)
    for name in ("shape", "vshape", "cshape", "dim", "nvertex", "ncell", "h", "cell_volume"):
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.vertex_coordinates(), b.vertex_coordinates())
    assert a.coarsen().shape == b.coarsen().shape
    assert a.get_info() == b.get_info()


@pytest.mark.parametrize("offsets,vshape", [
    (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)), (15, 15)),
    (tuple((i, j) for i in (-1, 0, 1) for j in (-1, 0, 1)), (7, 9)),
    (((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)), (5, 6, 7)),
], ids=["5point", "9point", "7point3d"])
def test_coloring_equal(offsets, vshape):
    a = jcoloring.coloring_for(offsets, vshape)
    b = coloring.coloring_for(offsets, vshape)
    assert (a.n_colors, a.weights) == (b.n_colors, b.weights)
    np.testing.assert_array_equal(a.field, b.field)
    np.testing.assert_array_equal(a.masks(), b.masks())


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_quadrature_equal(dim):
    for order in (1, 2):
        pa, wa = jquadrature.gauss_legendre(dim, order=order)
        pb, wb = quadrature.gauss_legendre(dim, order=order)
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
        np.testing.assert_array_equal(np.asarray(wa), np.asarray(wb))


def test_correlation_models_equal():
    x = np.random.default_rng(0).uniform(size=(5, 7, 2))
    np.testing.assert_allclose(
        ConstantCorrelationLengthModel(0.3).kappa_sq(x), np.asarray(JConst(0.3).kappa_sq(x)),
        **F64)
    np.testing.assert_allclose(
        PeriodicCorrelationLengthModel(0.1, 0.4).kappa_sq(x),
        np.asarray(JPeriodic(0.1, 0.4).kappa_sq(x)), **F64)


# -------------------------------------------------------------------- operators
@pytest.mark.parametrize("offset", [(0, 0), (1, 0), (0, -1), (-1, 1)])
def test_shift_matches(offset):
    x = np.random.default_rng(1).normal(size=(3, 6, 7))
    from multigridmc_tpu.ops.stencil import shift as jshift

    assert_close(shift(tt(x), offset), jshift(jnp.asarray(x), offset), rtol=0, atol=0)


@pytest.mark.parametrize("model", ["constant", "periodic"])
@pytest.mark.parametrize("shape", [(16, 16), (8, 12), (6, 6, 8)], ids=["2d", "2d_rect", "3d"])
def test_shiftedlaplace_fd_matches(model, shape):
    jm = JConst(0.3) if model == "constant" else JPeriodic(0.1, 0.4)
    pm = (ConstantCorrelationLengthModel(0.3) if model == "constant"
          else PeriodicCorrelationLengthModel(0.1, 0.4))
    a = jprior.shiftedlaplace_fd(JLattice(shape), jm)
    b = prior.prior_operator("shiftedlaplace_fd", Lattice(shape), pm, device=CPU, dtype=F64T)
    assert a.offsets == b.offsets
    assert_close(b.coeffs, a.coeffs, **F64)


@pytest.mark.parametrize("radius", [0.0, 0.12], ids=["delta", "ball"])
@pytest.mark.parametrize("measure_global", [False, True], ids=["points", "global"])
def test_measured_operator_matches(radius, measure_global):
    params = dataclasses.replace(measurement_params(), radius=radius,
                                 measure_global=measure_global, mean_global=0.3,
                                 variance_global=0.7)
    a = jposterior.measured_operator(jax_operator(16, lowrank=False), params)
    pparams = posterior.MeasurementParameters(**dataclasses.asdict(params))
    b = posterior.measured_operator(
        prior.shiftedlaplace_fd(Lattice((16, 16)), ConstantCorrelationLengthModel(0.3),
                                device=CPU, dtype=F64T), pparams)
    assert_close(b.lowrank.B, a.lowrank.B, **F64)
    assert_close(b.lowrank.Sigma_diag, a.lowrank.Sigma_diag, **F64)
    np.testing.assert_allclose(pparams.y(), params.y())


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_operator_apply_and_dense_match(lowrank):
    a = jax_operator(12, lowrank)
    b = to_port(a)
    x = np.random.default_rng(2).normal(size=(3,) + a.vshape)
    assert_close(b.apply(tt(x)), a.apply(jnp.asarray(x)), **F64)
    assert_close(b.apply_offdiag(tt(x)), a.apply_offdiag(jnp.asarray(x)), **F64)
    assert_close(b.diag_full(), a.diag_full(), **F64)
    np.testing.assert_allclose(b.to_dense(), a.to_dense(), **F64)


def test_exact_posterior_moments_match():
    a = jax_operator(16, True)
    b = to_port(a)
    rng = np.random.default_rng(3)
    xbar, y, w = rng.normal(size=a.vshape), rng.normal(size=4), rng.normal(size=a.vshape)
    np.testing.assert_allclose(posterior.posterior_mean(b, xbar, y),
                               np.asarray(jposterior.posterior_mean(a, xbar, y)),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(posterior.observed_mean_and_variance(b, xbar, y, w),
                               jposterior.observed_mean_and_variance(a, xbar, y, w),
                               rtol=1e-9, atol=1e-11)


def test_exact_moments_above_dense_limit_wait_for_cg():
    """Above 4096 unknowns the moments of a 2d lattice come from a band
    Cholesky of the stencil: float64 whatever the operator's dtype."""
    big = prior.shiftedlaplace_fd(Lattice((80, 80)), ConstantCorrelationLengthModel(0.3),
                                  device=CPU, dtype=torch.float64)
    assert big.lattice.nvertex > posterior.DENSE_SOLVE_MAX_N
    w = np.random.default_rng(5).normal(size=big.vshape)
    mean, var = posterior.observed_mean_and_variance(big, np.ones(big.vshape), np.zeros(0), w)
    q_inv_w = np.linalg.solve(big.to_dense_stencil(), w.reshape(-1))
    np.testing.assert_allclose(mean, w.sum(), rtol=1e-12)
    np.testing.assert_allclose(var, w.reshape(-1) @ q_inv_w, rtol=1e-9)
    mean32, var32 = posterior.observed_mean_and_variance(
        big.to(dtype=torch.float32), np.ones(big.vshape), np.zeros(0), w)
    np.testing.assert_allclose(var32, var, rtol=1e-5)  # float32 coefficients, float64 solve


# -------------------------------------------------------------------- intergrid
@pytest.mark.parametrize("vshape", [(15, 15), (23, 11), (7, 7, 7)], ids=["sq", "rect", "3d"])
def test_restrict_prolongate_match_and_adjoint(vshape):
    rng = np.random.default_rng(4)
    dim = len(vshape)
    xf = rng.normal(size=(2,) + vshape)
    vc = tuple(n // 2 for n in vshape)
    xc = rng.normal(size=(2,) + vc)
    r = intergrid.restrict(tt(xf), dim=dim)
    p = intergrid.prolongate(tt(xc), vshape)
    assert_close(r, jintergrid.restrict(jnp.asarray(xf), dim=dim), **F64)
    assert_close(p, jintergrid.prolongate(jnp.asarray(xc), vshape), **F64)
    assert_close(intergrid.prolongate_add(0.7, tt(xc), tt(xf), dim=dim),
                 jintergrid.prolongate_add(0.7, jnp.asarray(xc), jnp.asarray(xf), dim=dim), **F64)
    # <R x_f, x_c> = <x_f, P x_c>
    np.testing.assert_allclose(float((r * tt(xc)).sum()), float((tt(xf) * p).sum()), rtol=1e-12)


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_galerkin_coarsen_matches(lowrank):
    a = jax_operator(32, lowrank)
    b = to_port(a)
    for _ in range(2):  # 5-point -> 9-point -> 9-point
        a, b = jgalerkin(a), galerkin_coarsen(b)
        assert a.offsets == b.offsets and a.lattice.shape == b.lattice.shape
        assert_close(b.coeffs, a.coeffs, **F64)
        if lowrank:
            assert_close(b.lowrank.B, a.lowrank.B, **F64)
            assert_close(b.lowrank.Sigma_diag, a.lowrank.Sigma_diag, **F64)


def test_hierarchy_matches_and_converts():
    a = JHierarchy(jax_operator(32, True), 3)
    b = MultigridHierarchy(to_port(a.operators[0]), 3)
    carried = hierarchy_from_numpy(
        [dict(coeffs=np.asarray(o.coeffs), offsets=o.offsets, lattice_shape=o.lattice.shape,
              B=np.asarray(o.lowrank.B), Sigma_diag=np.asarray(o.lowrank.Sigma_diag))
         for o in a.operators], device=CPU, dtype=F64T)
    assert len(b) == len(carried) == 3
    for ja, pb, pc in zip(a.operators, b.operators, carried.operators):
        assert_close(pb.coeffs, ja.coeffs, **F64)
        assert_close(pc.coeffs, ja.coeffs, rtol=0, atol=0)
        assert pc.offsets == ja.offsets


# --------------------------------------------------------------------- smoothers
@pytest.mark.parametrize("direction", [smoothers.FORWARD, smoothers.BACKWARD])
@pytest.mark.parametrize("level", [0, 1], ids=["5point", "galerkin9point"])
def test_compute_B_bar_matches(direction, level):
    a = JHierarchy(jax_operator(32, True), 2).operators[level]
    b = to_port(a)
    ja = jsmoothers.SORSmoother(a, 0.9, 1, direction)
    pb = smoothers.SORSmoother(b, 0.9, 1, direction)
    assert ja.order == pb.order
    assert_close(pb.B_bar, ja.B_bar, **F64)


@pytest.mark.parametrize("direction", [smoothers.FORWARD, smoothers.BACKWARD])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
@pytest.mark.parametrize("level", [0, 1], ids=["5point", "galerkin9point"])
def test_sor_sweep_and_smoother_match(direction, lowrank, level):
    a = JHierarchy(jax_operator(32, lowrank), 2).operators[level]
    b = to_port(a)
    ja = jsmoothers.SORSmoother(a, 1.1, 2, direction)
    pb = smoothers.SORSmoother(b, 1.1, 2, direction)
    rng = np.random.default_rng(6)
    rhs, x = rng.normal(size=(3,) + a.vshape), rng.normal(size=(3,) + a.vshape)
    assert_close(pb.sweep_stencil(tt(rhs), tt(x)),
                 ja.sweep_stencil(jnp.asarray(rhs), jnp.asarray(x)), **F64)
    assert_close(pb.apply(tt(rhs), tt(x)), ja.apply(jnp.asarray(rhs), jnp.asarray(x)), **F64)
    y = smoothers.splitting_solve(b, pb.masks, 1.1, pb.order, tt(rhs))
    assert_close(y, jsmoothers.splitting_solve(a, ja.masks, 1.1, ja.order, jnp.asarray(rhs)),
                 **F64)


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_dense_cholesky_factor_matches(lowrank):
    a = jax_operator(8, lowrank)
    assert_close(DenseCholeskySampler(to_port(a)).L, JDenseCholesky(a).L, **F64)
