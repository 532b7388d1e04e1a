"""The port's remaining drivers and utilities against the JAX package, on the CPU.

* ``drivers.generate_measurements``: the same text, byte for byte;
* ``drivers.spectrum``: the same ``spectrum.csv`` text as the JAX driver's, and
  the eigenvalues within ``1e-10`` relative of the JAX package's (float64; the
  port takes ``eigvalsh`` of the symmetric covariance, the JAX driver the real
  parts of ``eigvals``);
* ``ops.lowrank_approx``: Crout Cholesky, LDL^T, the pivoted Cholesky and its
  error trace, the truncated-SVD error within ``1e-12`` (float64);
* ``utils.baseline_export``: the exported file byte for byte on the same
  operators, within ``1e-14`` per float where the port coarsens the hierarchy
  itself;
* ``utils.checkpoint.ChainState``: a round trip, and a resumed chain bitwise
  equal to an uninterrupted one on the plain path;
* ``utils.profiling``: ``timed``, ``Timer`` and ``trace``;
* ``examples/posterior_sampling_torch.py`` and the console scripts.
"""

import importlib
import json
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.drivers import common as jcommon
from multigridmc_tpu.drivers import generate_measurements as jgenerate
from multigridmc_tpu.models.posterior import measured_operator as jmeasured
from multigridmc_tpu.models.prior import shiftedlaplace_fem as jfem
from multigridmc_tpu.ops import lowrank_approx as jlowrank
from multigridmc_tpu.solvers.multigrid import MultigridHierarchy as JMultigridHierarchy
from multigridmc_tpu.utils import baseline_export as jexport
from multigridmc_tpu.utils import config as jconfig

from multigridmc_tpu_torch.convert import hierarchy_from_numpy
from multigridmc_tpu_torch.drivers import generate_measurements, spectrum
from multigridmc_tpu_torch.ops import lowrank_approx
from multigridmc_tpu_torch.samplers.base import GeneratorNoise
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.solvers.multigrid import MultigridHierarchy
from multigridmc_tpu_torch.utils import baseline_export, profiling
from multigridmc_tpu_torch.utils import config as pconfig
from multigridmc_tpu_torch.utils.checkpoint import ChainState

from test_drivers import CONFIG, MEASUREMENTS
from test_lowrank_approx import make_covariance
from test_torch_common import CPU, jax_operator, to_port, tt

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def config_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_utilities_cfg")
    (d / "params.cfg").write_text(CONFIG)
    (d / "measurements.cfg").write_text(MEASUREMENTS)
    return d


@pytest.mark.parametrize("args", [[], ["--dim", "3", "--nmeas", "5", "--dmin", "0.15",
                                       "--seed", "7"]], ids=["default", "3d"])
def test_generate_measurements_writes_the_jax_text(args, tmp_path):
    jgenerate.main(args + ["--output", str(tmp_path / "jax.cfg")])
    generate_measurements.main(args + ["--output", str(tmp_path / "port.cfg")])
    assert (tmp_path / "port.cfg").read_bytes() == (tmp_path / "jax.cfg").read_bytes()
    parsed = pconfig.read_config(tmp_path / "port.cfg")
    assert parsed["n"] == (5 if args else 8)


def test_spectrum_matches_the_jax_driver(config_dir, tmp_path):
    """The eigenvalues against the JAX package's (the JAX driver's arithmetic on
    its own operator), and the port driver's file against the JAX driver's."""
    config = jconfig.load_config(str(config_dir / "params.cfg"))
    op = jmeasured(jfem(jcommon.build_lattice(config), jcommon.build_correlation_model(config)),
                   jcommon.measurement_params(config))
    want = np.sort(np.real(np.linalg.eigvals(np.linalg.inv(op.to_dense()))))[::-1]
    got = spectrum.spectrum(pconfig.load_config(str(config_dir / "params.cfg")), CPU)
    assert got.dtype == torch.float64 and got.shape == (49,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)

    env = dict(os.environ, MGMC_PLATFORM="cpu", PYTHONPATH=str(REPO))
    for module, out, extra in (("multigridmc_tpu.drivers.spectrum", "jax", []),
                               ("multigridmc_tpu_torch.drivers.spectrum", "port",
                                ["--device", "cpu"])):
        (tmp_path / out).mkdir()
        r = subprocess.run([sys.executable, "-m", module, str(config_dir / "params.cfg")] + extra,
                           capture_output=True, text=True, cwd=str(tmp_path / out), env=env,
                           timeout=300)
        assert r.returncode == 0, r.stderr
        assert "wrote 49 eigenvalues to spectrum.csv" in r.stdout
    assert ((tmp_path / "port" / "spectrum.csv").read_text()
            == (tmp_path / "jax" / "spectrum.csv").read_text())


def _spd(n, seed):
    M = np.random.default_rng(seed).normal(size=(n, n))
    return M @ M.T + n * np.eye(n)


def test_cholesky_crout_matches_jax():
    A = _spd(20, 0)
    want = np.asarray(jlowrank.cholesky_crout(jnp.asarray(A)))
    got = lowrank_approx.cholesky_crout(tt(A))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_cholesky_crout_ldlt_matches_jax():
    A = _spd(15, 1)
    wL, wD = jlowrank.cholesky_crout_ldlt(jnp.asarray(A))
    L, D = lowrank_approx.cholesky_crout_ldlt(tt(A))
    np.testing.assert_allclose(L.numpy(), np.asarray(wL), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(D.numpy(), np.asarray(wD), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tolerance,max_rank", [(0.0, None), (0.0, 60), (1e-2, None)],
                         ids=["full", "rank60", "tol1e-2"])
def test_pivoted_cholesky_matches_jax(tolerance, max_rank):
    A = make_covariance(n=10, Lambda=0.2) if max_rank or tolerance else _spd(18, 2)
    wL, wrel = jlowrank.pivoted_cholesky(jnp.asarray(A), tolerance=tolerance, max_rank=max_rank)
    L, rel = lowrank_approx.pivoted_cholesky(tt(A), tolerance=tolerance, max_rank=max_rank)
    assert L.shape == wL.shape and rel.shape == wrel.shape
    np.testing.assert_allclose(L.numpy(), wL, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rel, wrel, rtol=1e-12, atol=1e-12)


def test_truncated_svd_error_matches_jax():
    A = make_covariance(n=6, Lambda=0.3)
    want = jlowrank.truncated_svd_error(A)
    got = lowrank_approx.truncated_svd_error(tt(A))
    assert got.shape == want.shape == (36,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _read_f64(path):
    data = Path(path).read_bytes()
    return np.frombuffer(data[:len(data) // 8 * 8], dtype=np.float64)


def test_export_problem_writes_the_jax_file(tmp_path):
    """A 3-level 16x16 posterior: the port's export of the JAX hierarchy's own
    levels byte for byte; of the hierarchy the port coarsens itself within
    1e-14 per float."""
    jop = jax_operator(16, True, variance="small")
    jh = JMultigridHierarchy(jop, 3)
    jexport.export_problem(jh, str(tmp_path / "jax.bin"), omega=1.0, cycle=2)
    levels = [dict(coeffs=np.asarray(o.coeffs), offsets=o.offsets, lattice_shape=o.lattice.shape,
                   B=np.asarray(o.lowrank.B), Sigma_diag=np.asarray(o.lowrank.Sigma_diag))
              for o in jh.operators]
    same = hierarchy_from_numpy(levels, device=CPU, dtype=torch.float64)
    baseline_export.export_problem(same, str(tmp_path / "same.bin"), omega=1.0, cycle=2)
    assert (tmp_path / "same.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    own = MultigridHierarchy(to_port(jop), 3)
    baseline_export.export_problem(own, str(tmp_path / "own.bin"), omega=1.0, cycle=2)
    got, want = _read_f64(tmp_path / "own.bin"), _read_f64(tmp_path / "jax.bin")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14 * np.abs(want).max())


def test_csr_and_transfers_match_jax():
    jop = jax_operator(16, True)
    op = to_port(jop)
    A, wA = baseline_export.stencil_to_csr(op), jexport.stencil_to_csr(jop)
    assert (A != wA).nnz == 0
    P, wP = (m.transfer_to_csr((15, 15), (7, 7)) for m in (baseline_export, jexport))
    assert (P != wP).nnz == 0


def _plain_sampler():
    op = to_port(jax_operator(16, True, variance="small"))
    return MultigridMCSampler(op, 3, smoother="SOR", cycle=2, distill=False), op


def test_chain_state_round_trip(tmp_path):
    rng = np.random.default_rng(9)
    noise = GeneratorNoise(1234, CPU)
    noise.normal((5,), torch.float64, CPU)  # the generator moved on
    noise.philox_streams(3)
    x = tt(rng.normal(size=(4, 7, 7)))
    state = ChainState(x=x, noise=noise, step=42, stats={"sum_x": rng.normal(size=49)})
    state.save(tmp_path / "chain.npz")
    assert not (tmp_path / "chain.npz.tmp").exists()
    restored = ChainState.load(tmp_path / "chain.npz", CPU)
    assert torch.equal(restored.x, x) and restored.x.dtype == torch.float64
    assert restored.step == 42 and restored.noise.launches == 3
    assert restored.noise.seed == 1234
    np.testing.assert_array_equal(restored.stats["sum_x"], state.stats["sum_x"])
    torch.testing.assert_close(restored.noise.normal((6,), torch.float64, CPU),
                               noise.normal((6,), torch.float64, CPU), rtol=0, atol=0)


def test_resumed_chain_equals_the_uninterrupted_chain(tmp_path):
    """Plain path, float64, 3 chains: 3 steps, a save and a load, 3 steps give
    the 6 uninterrupted steps bit for bit."""
    sampler, op = _plain_sampler()
    f = tt(np.random.default_rng(3).normal(size=op.vshape))
    x0 = torch.zeros((3,) + op.vshape, dtype=torch.float64)
    noise = GeneratorNoise(77, CPU)
    whole = x0.clone()
    for _ in range(6):
        whole = sampler.apply(noise, f, whole)
    noise = GeneratorNoise(77, CPU)
    x = x0.clone()
    for _ in range(3):
        x = sampler.apply(noise, f, x)
    ChainState(x, noise, 3).save(tmp_path / "c.npz")
    del x, noise
    state = ChainState.load(tmp_path / "c.npz", CPU)
    x = state.x
    for _ in range(3):
        x = sampler.apply(state.noise, f, x)
    assert state.step == 3 and torch.equal(x, whole)


def test_timed_timer_and_trace(tmp_path, capsys):
    results = {}
    for _ in range(2):
        with profiling.timed("work", results, verbose=True, device=CPU):
            torch.ones(100).sum()
    assert set(results) == {"work"} and results["work"] > 0
    assert capsys.readouterr().out.count("[work]") == 2
    t = profiling.Timer(CPU)
    with t.phase("a"):
        torch.ones(10).sum()
    with t.phase("b"):
        torch.ones(10).sum()
    assert set(t.phases) == {"a", "b"} and "total" in t.report()
    with profiling.trace(str(tmp_path / "prof"), device=CPU) as prof:
        torch.ones(1000).cumsum(0)
    assert prof.key_averages()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_posterior_sampling_example_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sys.path.insert(0, str(REPO / "examples"))
    try:
        example = importlib.import_module("posterior_sampling_torch")
    finally:
        sys.path.remove(str(REPO / "examples"))
    mean, var = example.run(CPU, nx=16, nchains=4, nwarmup=5, nsteps=20,
                            output=str(tmp_path / "posterior_example.vtk"))
    assert mean.shape == var.shape == (15, 15)
    assert np.isfinite(mean).all() and (var >= -1e-12).all()
    assert (tmp_path / "posterior_example.vtk").exists()


def test_console_scripts_name_the_port_drivers():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.endswith("-torch")}
    assert port == {"mgmc-sample-torch": "multigridmc_tpu_torch.drivers.mgmc:main",
                    "mgmc-solve-torch": "multigridmc_tpu_torch.drivers.mg:main",
                    "mgmc-spectrum-torch": "multigridmc_tpu_torch.drivers.spectrum:main",
                    "mgmc-generate-measurements-torch":
                        "multigridmc_tpu_torch.drivers.generate_measurements:main"}
    for target in port.values():
        module, name = target.split(":")
        assert callable(getattr(importlib.import_module(module), name))
