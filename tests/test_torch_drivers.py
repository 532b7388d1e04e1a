"""The port's two command-line drivers, and the utilities they use, against
the JAX package.

The drivers run in subprocesses with ``--device cpu`` (float64) on the tiny
configuration of ``tests/test_drivers.py``.  Their random streams differ from
the JAX drivers' by construction, so what is compared is: the exact posterior
mean and variance they print (``rtol = 1e-8`` on the values, the same printed
text), the sampled ones against the driver's own error bars, and the solution
of the deterministic solve when both packages are fed the same right-hand side
(``rtol = 1e-8``).  ``utils/vtk`` writes byte-identical files, ``utils/statistics``
and ``qoi`` agree at ``rtol = 1e-12``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu import qoi as jqoi
from multigridmc_tpu.drivers import common as jcommon
from multigridmc_tpu.drivers import mgmc as jdriver_mgmc
from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.solvers.loop import IterativeSolverParameters as JParams
from multigridmc_tpu.solvers.loop import LoopSolver as JLoopSolver
from multigridmc_tpu.solvers.multigrid import MultigridPreconditioner as JPreconditioner
from multigridmc_tpu.utils import config as jconfig
from multigridmc_tpu.utils import statistics as jstatistics
from multigridmc_tpu.utils import vtk as jvtk

from multigridmc_tpu_torch import qoi
from multigridmc_tpu_torch.drivers import common as pcommon
from multigridmc_tpu_torch.drivers import mg as driver_mg
from multigridmc_tpu_torch.drivers import mgmc as driver_mgmc
from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.samplers.base import GeneratorNoise
from multigridmc_tpu_torch.utils import config as pconfig
from multigridmc_tpu_torch.utils import statistics, vtk

from test_drivers import CONFIG, MEASUREMENTS

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def config_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_driver_cfg")
    (d / "params.cfg").write_text(CONFIG)
    (d / "measurements.cfg").write_text(MEASUREMENTS)
    return d


def run_driver(module, args, cwd, timeout=420):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                          cwd=str(cwd), env=env, timeout=timeout)


def read_vtk(path):
    fields, label = {}, None
    for line in Path(path).read_text().splitlines():
        if line.startswith("SCALARS"):
            label = line.split()[1]
            fields[label] = []
        elif label is not None and not line.startswith("LOOKUP_TABLE") and line.strip():
            fields[label].append(float(line))
    return {k: np.asarray(v) for k, v in fields.items()}


def test_driver_mgmc_on_the_cpu(config_dir, tmp_path):
    r = run_driver("multigridmc_tpu_torch.drivers.mgmc",
                   [str(config_dir / "params.cfg"), "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "device = cpu, dtype = torch.float64" in r.stdout
    for label in ("cholesky", "ssor", "multigridmc"):
        assert f"{label} time per sample" in r.stdout
        series = np.loadtxt(tmp_path / f"timeseries_{label}.txt")
        assert series.shape == (50,) and np.isfinite(series).all()
    for label in ("ssor", "multigridmc"):
        table = (tmp_path / f"convergence_{label}.txt").read_text()
        assert "q_k = |E[z^k] - E[z]|" in table and "q_k = |Var[z^k] - Var[z]|" in table
        assert len(re.findall(r"^\s+(?:mean|variance)\s+\d+ :", table, flags=re.M)) == 2 * 5
    fields = read_vtk(tmp_path / "posterior.vtk")
    assert set(fields) == {"mean", "variance", "mean_exact"}
    assert all(v.shape == (81,) and np.isfinite(v).all() for v in fields.values())
    assert (tmp_path / "sample_location.vtk").exists()

    # exact moments: the JAX package's values for the same configuration
    config = jconfig.load_config(config_dir / "params.cfg")
    prior, op, mparams = jcommon.build_operators(config)
    xbar, y, mean_x_exact, f, sample_vec = jdriver_mgmc.exact_setup(prior, op, mparams)
    from multigridmc_tpu.models.posterior import observed_mean_and_variance as jobserved

    jmean, jvar = jobserved(op, xbar, y, sample_vec)
    printed_mean = set(re.findall(r"exact mean     = +(\S+)", r.stdout))
    printed_var = set(re.findall(r"exact variance = +(\S+)", r.stdout))
    assert printed_mean == {f"{jmean:.4e}"} and printed_var == {f"{jvar:.4e}"}
    np.testing.assert_allclose(fields["mean_exact"].reshape(9, 9)[1:-1, 1:-1], mean_x_exact,
                               rtol=1e-8, atol=1e-12)
    # ... and the same values at full precision, in process
    pconf = pconfig.load_config(config_dir / "params.cfg")
    pprior, pop, pparams = pcommon.build_operators(pconf, "cpu", torch.float64)
    pxbar, py, pmean, pf, pvec = driver_mgmc.exact_setup(pprior, pop, pparams)
    from multigridmc_tpu_torch.models.posterior import observed_mean_and_variance

    np.testing.assert_allclose(observed_mean_and_variance(pop, pxbar, py, pvec), (jmean, jvar),
                               rtol=1e-8)
    np.testing.assert_allclose(pmean, mean_x_exact, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(pf.numpy(), np.asarray(f), rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(pvec, sample_vec)

    # sampled moments within their error bars (50 samples: 5 standard errors;
    # the variance of a variance estimate from n normal samples is 2 var^2 / n)
    for label in ("cholesky", "ssor", "multigridmc"):
        mean, err = (float(v) for v in re.search(
            rf"{label} mean     = +(\S+) \+/- +(\S+)", r.stdout).groups())
        var = float(re.search(rf"{label} variance = +(\S+)", r.stdout).group(1))
        assert abs(mean - jmean) < 5 * err * np.sqrt(3.0)  # successive states correlate
        assert abs(var - jvar) < 5 * jvar * np.sqrt(2.0 / 50 * 3.0)


def test_driver_mg_on_the_cpu(config_dir, tmp_path, monkeypatch):
    r = run_driver("multigridmc_tpu_torch.drivers.mg",
                   [str(config_dir / "params.cfg"), "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "Solver converged" in r.stdout and "multigrid setup time" in r.stdout
    solution = read_vtk(tmp_path / "solution.vtk")["solution"]
    assert solution.shape == (81,) and np.isfinite(solution).all()

    # the same right-hand side through both packages: the JAX driver's own
    # b ~ N(0, 1) and its solver, then the function under the port's main
    config = jconfig.load_config(config_dir / "params.cfg")
    prior, op, mparams = jcommon.build_operators(config)
    mg, it = config.multigrid, config.iterative_solver
    jprecond = JPreconditioner(op, nlevel=mg.nlevel, smoother=mg.smoother,
                               npresmooth=mg.npresmooth, npostsmooth=mg.npostsmooth,
                               omega=mg.omega, cycle=mg.cycle, coarse_scaling=mg.coarse_scaling)
    b = jax.random.normal(jax.random.PRNGKey(1482817), op.lattice.vshape)
    jres = JLoopSolver(op, jprecond, JParams(rtol=it.rtol, atol=it.atol, maxiter=it.maxiter,
                                             verbose=0)).solve_jit(b)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    writer = jvtk.VTKWriter(str(jdir / "solution.vtk"), op.lattice, 0)
    writer.add_state(np.asarray(jres.x), "solution")
    writer.write()

    pdir = tmp_path / "port"
    pdir.mkdir()
    monkeypatch.chdir(pdir)
    res = driver_mg.run(pconfig.load_config(config_dir / "params.cfg"), torch.device("cpu"),
                        torch.float64, b=np.asarray(b))
    assert res.converged and abs(res.niter - jres.niter) <= 1
    np.testing.assert_allclose(read_vtk(pdir / "solution.vtk")["solution"],
                               read_vtk(jdir / "solution.vtk")["solution"],
                               rtol=1e-8, atol=1e-12)


def test_drivers_need_a_gpu_unless_the_cpu_is_asked_for(config_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    for module in ("multigridmc_tpu_torch.drivers.mgmc", "multigridmc_tpu_torch.drivers.mg"):
        r = run_driver(module, [str(config_dir / "params.cfg")], tmp_path)
        assert r.returncode != 0 and "CUDA device" in r.stderr
        assert not list(tmp_path.glob("*.vtk")) and not list(tmp_path.glob("timeseries_*"))
    r = run_driver("multigridmc_tpu_torch.drivers.mg", [], tmp_path)
    assert r.returncode != 0 and "CONFIGURATIONFILE" in r.stderr


def test_band_cholesky_names_its_slice(config_dir):
    """``cholesky.factorisation = "sparse"`` (the default) builds the band
    sampler, as the JAX driver does."""
    from multigridmc_tpu_torch.samplers.cholesky import BandCholeskySampler

    config = pconfig.load_config(config_dir / "params.cfg")
    config.cholesky.factorisation = "sparse"
    prior, op, mparams = pcommon.build_operators(config, "cpu", torch.float64)
    samplers = driver_mgmc.make_samplers(config, op)
    assert isinstance(samplers["cholesky"], BandCholeskySampler)
    assert samplers["cholesky"].bandwidth == 7 and not samplers["cholesky"].factor.parallel
    assert pcommon.run_dtype(torch.device("cpu")) is torch.float64
    assert pcommon.run_dtype(torch.device("cuda")) is torch.float32


def test_driver_band_cholesky_and_alternating_schedule(config_dir, tmp_path):
    """A configuration that leaves the factorisation unset (the band sampler)
    and asks for the alternating sweep schedule runs end to end; every time
    series' mean lies within its error bars of the exact one."""
    text = (config_dir / "params.cfg").read_text()
    text = text.replace('cholesky = { factorisation = "dense"; }\n', "")
    text = text.replace("cycle = 2;", 'cycle = 2; sweep_schedule = "alternating";')
    assert "factorisation" not in text and "alternating" in text
    (tmp_path / "params.cfg").write_text(text)
    (tmp_path / "measurements.cfg").write_text(MEASUREMENTS)
    config = pconfig.load_config(tmp_path / "params.cfg")
    assert config.cholesky.factorisation == "sparse"
    assert config.multigrid.sweep_schedule == "alternating"
    r = run_driver("multigridmc_tpu_torch.drivers.mgmc",
                   [str(tmp_path / "params.cfg"), "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "time for Cholesky factorisation" in r.stdout
    jmean = float(re.search(r"exact mean     = +(\S+)", r.stdout).group(1))
    jvar = float(re.search(r"exact variance = +(\S+)", r.stdout).group(1))
    for label in ("cholesky", "ssor", "multigridmc"):
        series = np.loadtxt(tmp_path / f"timeseries_{label}.txt")
        assert series.shape == (50,) and np.isfinite(series).all()
        mean, err = (float(v) for v in re.search(
            rf"{label} mean     = +(\S+) \+/- +(\S+)", r.stdout).groups())
        var = float(re.search(rf"{label} variance = +(\S+)", r.stdout).group(1))
        assert abs(mean - jmean) < 5 * err * np.sqrt(3.0)  # successive states correlate
        assert abs(var - jvar) < 5 * jvar * np.sqrt(2.0 / 50 * 3.0)
    table = (tmp_path / "convergence_multigridmc.txt").read_text()
    assert len(re.findall(r"^\s+(?:mean|variance)\s+\d+ :", table, flags=re.M)) == 2 * 5


@pytest.mark.parametrize("shape", [(6, 4), (4, 6, 5)], ids=["2d", "3d"])
def test_vtk_files_are_byte_identical(shape, tmp_path):
    rng = np.random.default_rng(1)
    lattice, jlattice = Lattice(shape), JLattice(shape)
    a, b = rng.normal(size=lattice.vshape), rng.normal(size=lattice.vshape) * 1e-22
    for mod, lat, name in ((vtk, lattice, "port.vtk"), (jvtk, jlattice, "jax.vtk")):
        w = mod.VTKWriter(str(tmp_path / name), lat, 0)
        w.add_state(a, "alpha")
        w.add_state(b if mod is jvtk else torch.as_tensor(b), "tiny")  # tensors are accepted
        w.write()
    assert (tmp_path / "port.vtk").read_bytes() == (tmp_path / "jax.vtk").read_bytes()
    vtk.write_vtk_circle([0.3, 0.6], 0.1, str(tmp_path / "pc.vtk"))
    jvtk.write_vtk_circle([0.3, 0.6], 0.1, str(tmp_path / "jc.vtk"))
    assert (tmp_path / "pc.vtk").read_bytes() == (tmp_path / "jc.vtk").read_bytes()
    with pytest.raises(ValueError, match="2d and 3d"):
        vtk.VTKWriter("x.vtk", Lattice((8,)))


def test_statistics_match_jax():
    rng = np.random.default_rng(2)
    samples = rng.normal(size=(40, 3)).cumsum(axis=0) * 0.1 + rng.normal(size=(40, 3))
    p, j = statistics.Statistics("q", 8), jstatistics.Statistics("q", 8)
    for s in samples:
        p.record_sample(s)
        j.record_sample(s)
    tol = dict(rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(p.average(), j.average(), **tol)
    np.testing.assert_allclose(p.covariance(), j.covariance(), **tol)
    for cp, cj in zip(p.auto_covariance(), j.auto_covariance()):
        np.testing.assert_allclose(cp, cj, **tol)
    v = np.array([1.0, -0.5, 0.25])
    np.testing.assert_allclose(p.tau_int(v), j.tau_int(v), **tol)
    assert str(p) == str(j) and p.samples() == 40 and p.autocorr_window() == 8

    # the chain accumulator: a deterministic step function so both agree exactly
    x0 = rng.normal(size=(4, 5))
    A = rng.normal(size=(5, 5)) * 0.3
    _, jm, jm2 = jstatistics.chain_statistics_scan(
        lambda key, x: x @ jnp.asarray(A) + 1.0, jnp.asarray(x0),
        jax.random.split(jax.random.key(0), 6))
    xf, pm, pm2 = statistics.chain_statistics_scan(
        lambda noise, x: x @ torch.as_tensor(A) + 1.0, torch.as_tensor(x0), None, 6)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **tol)
    np.testing.assert_allclose(pm2.numpy(), np.asarray(jm2), **tol)
    assert xf.shape == (4, 5)
    # with a noise source: the moments of N(0, 1) draws
    noise = GeneratorNoise(3, "cpu")
    _, m, m2 = statistics.chain_statistics_scan(
        lambda nz, x: nz.normal(x.shape, x.dtype, x.device), torch.zeros(2000, 2), noise, 20,
        observe_fn=lambda x: x)
    assert float(m.abs().max()) < 0.03 and float((m2 - torch.eye(2)).abs().max()) < 0.03


def test_qoi_matches_jax():
    rng = np.random.default_rng(3)
    lattice, jlattice = Lattice((6, 8)), JLattice((6, 8))
    w, x = rng.normal(size=lattice.vshape), rng.normal(size=(3, 2) + lattice.vshape)
    tol = dict(rtol=1e-12, atol=1e-14)
    got = qoi.qoi_factory("linear", lattice, weights=w, dtype=torch.float64)(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jqoi.qoi_factory("linear", jlattice, weights=w)(jnp.asarray(x))), **tol)
    assert got.shape == (3, 2)
    avg = qoi.qoi_factory("domain_average", lattice, dtype=torch.float64)
    assert isinstance(avg, qoi.DomainAverageQoI)
    np.testing.assert_allclose(avg(torch.as_tensor(x[0, 0])).numpy(), np.asarray(
        jqoi.qoi_factory("domain_average", jlattice)(jnp.asarray(x[0, 0]))), **tol)
    with pytest.raises(ValueError, match="unknown QoI"):
        qoi.qoi_factory("nonsense", lattice)
    with pytest.raises(NotImplementedError):
        qoi.QoI()(torch.zeros(1))
