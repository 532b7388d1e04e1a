"""The squared shifted-Laplace (biharmonic) and FEM priors of the port against
the JAX package (CPU, float64 unless stated).

The operators' coefficient planes agree to ``rtol = 1e-12`` (both packages
assemble the same float64 arrays; only the summation order may differ), the
colourings of their stencils and the Galerkin hierarchy of the biharmonic
posterior level for level, the MGMC sampler on the 8x8 biharmonic prior holds
the JAX package's own gate, and both config-file drivers run on either prior
and print the JAX drivers' exact moments.
"""

import re
from pathlib import Path

import numpy as np
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
from multigridmc_tpu.solvers.multigrid import MultigridHierarchy as JHierarchy
from multigridmc_tpu.utils import config as jconfig
from multigridmc_tpu.drivers import common as jcommon
from multigridmc_tpu.drivers import mgmc as jdriver_mgmc

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import (
    ConstantCorrelationLengthModel,
    PeriodicCorrelationLengthModel,
)
from multigridmc_tpu_torch.models import prior
from multigridmc_tpu_torch.ops.coloring import coloring_for
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.solvers.multigrid import MultigridHierarchy

from test_drivers import CONFIG, MEASUREMENTS
from test_torch_common import CPU, measurement_params, to_port
from test_torch_drivers import read_vtk, run_driver
from test_torch_sampler import _mean_covariance_error

F64T = torch.float64
#: the operators' planes: the same float64 arithmetic in both packages
PLANES = dict(rtol=1e-12, atol=0.0)


def _models(kind):
    if kind == "constant":
        return JConst(0.3), ConstantCorrelationLengthModel(0.3)
    return JPeriodic(0.1, 0.4), PeriodicCorrelationLengthModel(0.1, 0.4)


def _assert_planes(port, jax_op):
    assert port.offsets == jax_op.offsets
    a, b = np.asarray(jax_op.coeffs), port.coeffs.numpy()
    np.testing.assert_allclose(b, a, rtol=PLANES["rtol"], atol=PLANES["rtol"] * np.abs(a).max())


@pytest.mark.parametrize("model", ["constant", "periodic"])
@pytest.mark.parametrize("shape", [(12, 12), (10, 14)], ids=["square", "rect"])
def test_squared_shiftedlaplace_fd_matches_jax(model, shape):
    jm, pm = _models(model)
    a = jprior.squared_shiftedlaplace_fd(JLattice(shape), jm)
    b = prior.prior_operator("squared_shiftedlaplace_fd", Lattice(shape), pm, device=CPU,
                             dtype=F64T)
    assert len(b.offsets) == 13 and b.offsets[0] == (0, 0)
    _assert_planes(b, a)


@pytest.mark.parametrize("model", ["constant", "periodic"])
@pytest.mark.parametrize("shape", [(12, 12), (8, 10), (6, 6, 8)], ids=["2d", "2d_rect", "3d"])
def test_shiftedlaplace_fem_matches_jax(model, shape):
    jm, pm = _models(model)
    a = jprior.shiftedlaplace_fem(JLattice(shape), jm)
    b = prior.prior_operator("shiftedlaplace_fem", Lattice(shape), pm, device=CPU, dtype=F64T)
    assert len(b.offsets) == 3 ** len(shape)
    _assert_planes(b, a)


def test_squared_shiftedlaplace_fd_is_2d_only():
    with pytest.raises(ValueError, match="d=2"):
        jprior.squared_shiftedlaplace_fd(JLattice((4, 4, 4)), JConst(0.3))
    with pytest.raises(ValueError, match="d=2"):
        prior.squared_shiftedlaplace_fd(Lattice((4, 4, 4)), ConstantCorrelationLengthModel(0.3),
                                        device=CPU)


def test_float32_operator_is_the_float64_one_cast_once():
    lattice, model = Lattice((16, 16)), ConstantCorrelationLengthModel(0.2)
    for name in ("squared_shiftedlaplace_fd", "shiftedlaplace_fem"):
        a = prior.prior_operator(name, lattice, model, device=CPU, dtype=F64T)
        b = prior.prior_operator(name, lattice, model, device=CPU, dtype=torch.float32)
        assert b.coeffs.dtype == torch.float32
        assert torch.equal(b.coeffs, a.coeffs.to(torch.float32))


# ------------------------------------------------------------------ colourings
DIAMOND = tuple((k, j) for j in range(-2, 3) for k in range(-2, 3) if 0 < abs(j) + abs(k) <= 2)
BOX5 = tuple((i, j) for i in range(-2, 3) for j in range(-2, 3))


@pytest.mark.parametrize("offsets,colours", [(((0, 0),) + DIAMOND, 5), (BOX5, 9)],
                         ids=["13pt", "25pt"])
@pytest.mark.parametrize("vshape", [(11, 11), (7, 13)])
def test_reach2_colourings_match_jax(offsets, colours, vshape):
    a = jcoloring.coloring_for(offsets, vshape)
    b = coloring_for(offsets, vshape)
    assert b.n_colors == a.n_colors == colours
    assert b.weights == a.weights
    np.testing.assert_array_equal(b.field, a.field)
    for off in offsets:  # proper: no offset couples a colour to itself
        if any(off):
            assert sum(w * o for w, o in zip(b.weights, off)) % b.n_colors != 0


def _jax_biharmonic_posterior(nx, seed=5, n_meas=4):
    op = jprior.squared_shiftedlaplace_fd(JLattice((nx, nx)), JConst(0.3), dtype=jnp.float64)
    return jposterior.measured_operator(op, measurement_params(n_meas, seed))


def test_biharmonic_hierarchy_matches_jax():
    """The 24x24 biharmonic posterior's Galerkin levels (13-point, then the
    25-point box) and their colourings (5, then 9 colours), level for level."""
    a = _jax_biharmonic_posterior(24)
    ja = JHierarchy(a, 4)
    pa = MultigridHierarchy(to_port(a), 4, device=CPU, dtype=F64T)
    assert [len(o.offsets) for o in pa.operators] == [13, 25, 25, 25]
    for jop, pop in zip(ja.operators, pa.operators):
        assert pop.offsets == jop.offsets and pop.vshape == jop.vshape
        np.testing.assert_allclose(pop.coeffs.numpy(), np.asarray(jop.coeffs), rtol=1e-10,
                                   atol=1e-12 * float(np.abs(np.asarray(jop.coeffs)).max()))
        np.testing.assert_allclose(pop.lowrank.B.numpy(), np.asarray(jop.lowrank.B),
                                   rtol=1e-12, atol=1e-14)
        jc, pc = jcoloring.coloring_for(jop.offsets, jop.vshape), coloring_for(pop.offsets,
                                                                               pop.vshape)
        assert (pc.n_colors, pc.weights) == (jc.n_colors, jc.weights)
        np.testing.assert_array_equal(pc.field, jc.field)
    assert [coloring_for(o.offsets, o.vshape).n_colors for o in pa.operators] == [5, 9, 9, 9]


# ----------------------------------------------------------------- the sampler
def test_mgmc_sampler_biharmonic_prior_holds_the_jax_gate():
    """MGMC (SSOR, 2 levels, Cholesky) on the 8x8 biharmonic prior: the
    5-colour sweeps and the 5x5-box Galerkin level end to end, with the gate
    of ``tests/test_sampler.py::test_multigridmc_sampler_biharmonic_2d``."""
    op = prior.squared_shiftedlaplace_fd(Lattice((8, 8)), ConstantCorrelationLengthModel(1.0),
                                         device=CPU, dtype=F64T)
    sampler = MultigridMCSampler(op, nlevel=2, smoother="SSOR", coarse_solver="Cholesky",
                                 omega=1.0, cycle=1)
    assert sampler.presamplers[0].forward.smoother.coloring.n_colors == 5
    em, ec = _mean_covariance_error(op, sampler, nchains=512, nwarmup=30, nsteps=80, seed=1342517)
    assert em < 1.5e-2 and ec < 1.5e-2, (em, ec)


@pytest.mark.parametrize("pdemodel", ["squared_shiftedlaplace_fd", "shiftedlaplace_fem"])
def test_fused_and_distilled_samplers_take_both_priors(pdemodel):
    """Float32 on the CPU: every non-coarsest level fused (the kernels' plain
    versions, reach-2 levels included) and the distilled subtree over a
    9-colour 25-point level build and take finite steps."""
    from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise

    rng = np.random.default_rng(3)
    op = measured_operator(
        prior.prior_operator(pdemodel, Lattice((32, 32)), ConstantCorrelationLengthModel(0.2),
                             device=CPU, dtype=torch.float32),
        MeasurementParameters(measurement_locations=rng.uniform(0.1, 0.9, size=(4, 2)),
                              mean=rng.normal(size=4), variance=1e-2 * (1 + rng.uniform(size=4))))
    sampler = MultigridMCSampler(op, nlevel=4, cycle=2, fused=True, fused_min_vertices=0,
                                 distill=True)
    assert sampler.distill_level is not None and sorted(sampler.fused_levels)
    colours = coloring_for(sampler.hierarchy.operators[sampler.distill_level].offsets,
                           sampler.hierarchy.operators[sampler.distill_level].vshape).n_colors
    assert colours == (9 if pdemodel.startswith("squared") else 4)
    x = torch.zeros((4,) + op.vshape)
    for _ in range(3):
        x = sampler.apply(GeneratorNoise(5, CPU), torch.ones(op.vshape), x)
    assert bool(torch.isfinite(x).all()) and float(x.std()) > 0


# ------------------------------------------------------------------ the drivers
@pytest.fixture(scope="module")
def prior_configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_prior_cfg")
    for pdemodel in ("squared_shiftedlaplace_fd", "shiftedlaplace_fem"):
        (d / f"{pdemodel}.cfg").write_text(CONFIG.replace(
            'pdemodel = "shiftedlaplace_fd"', f'pdemodel = "{pdemodel}"'))
    (d / "measurements.cfg").write_text(MEASUREMENTS)
    return d


@pytest.mark.parametrize("pdemodel", ["squared_shiftedlaplace_fd", "shiftedlaplace_fem"])
def test_drivers_run_both_priors_on_the_cpu(prior_configs, tmp_path, pdemodel):
    """``drivers.mgmc`` prints the JAX driver's exact moments for the same
    configuration and its report lines; ``drivers.mg`` converges."""
    cfg = prior_configs / f"{pdemodel}.cfg"
    r = run_driver("multigridmc_tpu_torch.drivers.mgmc", [str(cfg), "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    for label in ("cholesky", "ssor", "multigridmc"):
        assert f"{label} time per sample" in r.stdout
        assert re.search(rf"{label} mean     = +\S+ \+/- +\S+", r.stdout)
        series = np.loadtxt(tmp_path / f"timeseries_{label}.txt")
        assert series.shape == (50,) and np.isfinite(series).all()
    fields = read_vtk(tmp_path / "posterior.vtk")
    assert all(v.shape == (81,) and np.isfinite(v).all() for v in fields.values())

    config = jconfig.load_config(cfg)
    jpr, jop, jparams = jcommon.build_operators(config)
    xbar, y, _, _, vec = jdriver_mgmc.exact_setup(jpr, jop, jparams)
    jmean, jvar = jposterior.observed_mean_and_variance(jop, xbar, y, vec)
    assert set(re.findall(r"exact mean     = +(\S+)", r.stdout)) == {f"{jmean:.4e}"}
    assert set(re.findall(r"exact variance = +(\S+)", r.stdout)) == {f"{jvar:.4e}"}

    r = run_driver("multigridmc_tpu_torch.drivers.mg", [str(cfg), "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "Solver converged" in r.stdout
    solution = read_vtk(tmp_path / "solution.vtk")["solution"]
    assert solution.shape == (81,) and np.isfinite(solution).all()


# ------------------------------------------------------------------ the example
def _example(name):
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: Richardson cycles of the comparison: the JAX W-cycle runs eagerly here (its
#: jit compile takes minutes on the CPU), and the rates are read over the
#: first ten cycles, as the example reads them
EXAMPLE_CYCLES = 12


def test_biharmonic1d_example_converges_as_the_jax_one():
    """The 1d biharmonic W-cycle (SSOR, 4 + 4 sweeps, Richardson) in float64
    on the example's ``n`` = 64 and right-hand side: the same number of
    cycles, the same convergence verdict and contraction rates within 1e-6."""
    import jax

    from multigridmc_tpu.solvers.loop import IterativeSolverParameters as JParams
    from multigridmc_tpu.solvers.loop import LoopSolver as JLoopSolver
    from multigridmc_tpu.solvers.multigrid import MultigridPreconditioner as JPreconditioner

    n = 64
    jex, pex = _example("multigrid_biharmonic1d"), _example("multigrid_biharmonic1d_torch")
    jop = jex.biharmonic_1d(n)
    jprecond = JPreconditioner(jop, nlevel=4, smoother="SSOR", npresmooth=4, npostsmooth=4,
                               cycle=2)
    b = jnp.asarray(np.random.default_rng(0).normal(size=jop.vshape))
    with jax.disable_jit():
        jres = JLoopSolver(jop, jprecond, JParams(rtol=1e-10, atol=1e-30, maxiter=EXAMPLE_CYCLES,
                                                   verbose=0)).solve(b)
    jh = jres.rnorm_history
    jrates = [jh[k + 1] / jh[k] for k in range(1, min(len(jh) - 1, 10))]

    assert pex.biharmonic_1d(n, "cpu").offsets == jop.offsets
    np.testing.assert_array_equal(pex.biharmonic_1d(n, "cpu").coeffs.numpy(),
                                  np.asarray(jop.coeffs))
    res, rates = pex.solve(n, "cpu", maxiter=EXAMPLE_CYCLES)
    assert (res.niter, bool(res.converged)) == (jres.niter, bool(jres.converged))
    assert len(rates) == len(jrates) == 9
    np.testing.assert_allclose(rates, jrates, rtol=0, atol=1e-6)
    assert res.x.dtype == torch.float64
