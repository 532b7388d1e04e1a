"""The samplers of the port and the slice as a whole.

Noisy paths: the JAX sampler is run eagerly with ``jax.random.normal`` wrapped
so that every draw is recorded in call order (nothing in the JAX package
changes); the port replays the recording through ``ReplayNoise``.  Both then
do the same arithmetic on the same normals, so they agree in float64 at
``rtol = 1e-9, atol = 1e-11`` (summation order only, accumulated over a whole
W-cycle).  The port runs twice: composed levels, and fused levels through the
kernels' plain versions, which covers ``_sample``'s fused branch on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.samplers.cholesky import DenseCholeskySampler as JDenseCholesky
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler as JMultigridMCSampler
from multigridmc_tpu.samplers.sor import SORSampler as JSORSampler
from multigridmc_tpu.smoothers import BACKWARD, FORWARD

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.posterior import (MeasurementParameters, measured_operator,
                                                    posterior_mean)
from multigridmc_tpu_torch.models.prior import prior_operator, shiftedlaplace_fd
from multigridmc_tpu_torch.samplers.base import (GeneratorNoise, MeanShiftedSampler,
                                                 ReplayNoise)
from multigridmc_tpu_torch.samplers.cholesky import DenseCholeskySampler
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.samplers.sor import SORSampler
from multigridmc_tpu_torch.smoothers import smoother_factory

from test_torch_common import CPU, assert_close, jax_operator, to_port, tt

REPLAY = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture
def recorded_normals(monkeypatch):
    """Every ``jax.random.normal`` draw made while the fixture is active, in
    call order."""
    draws = []
    real = jax.random.normal

    def recording(key, shape=(), dtype=None, **kw):
        out = real(key, shape, dtype, **kw) if dtype is not None else real(key, shape, **kw)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "normal", recording)
    return draws


@pytest.mark.parametrize("direction", [FORWARD, BACKWARD])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_sor_sampler_replays_jax_draws(recorded_normals, direction, lowrank):
    a = jax_operator(16, lowrank)
    rng = np.random.default_rng(1)
    f, x = rng.normal(size=a.vshape), rng.normal(size=(4,) + a.vshape)
    want = JSORSampler(a, 0.9, 2, direction).apply(jax.random.key(3), jnp.asarray(f),
                                                   jnp.asarray(x))
    assert len(recorded_normals) == (4 if lowrank else 2)
    replay = ReplayNoise(recorded_normals)
    got = SORSampler(to_port(a), 0.9, 2, direction).apply(replay, tt(f), tt(x))
    assert replay.exhausted
    assert_close(got, want, **REPLAY)


@pytest.mark.parametrize("f_batched", [False, True], ids=["fshared", "fbatched"])
def test_dense_cholesky_sampler_replays_jax_draws(recorded_normals, f_batched):
    a = jax_operator(8, True)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5,) + a.vshape)
    f = rng.normal(size=((5,) if f_batched else ()) + a.vshape)
    want = JDenseCholesky(a).apply(jax.random.key(4), jnp.asarray(f), jnp.asarray(x))
    replay = ReplayNoise(recorded_normals)
    got = DenseCholeskySampler(to_port(a)).apply(replay, tt(f), tt(x))
    assert replay.exhausted and len(recorded_normals) == 1
    assert_close(got, want, **REPLAY)


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused_plain_versions"])
@pytest.mark.parametrize("chain_shape", [(4,), (2, 2)], ids=["chains4", "chains2x2"])
def test_mgmc_steps_replay_jax_draws(recorded_normals, fused, chain_shape):
    """Two or three full MGMC steps: 3 levels, W-cycle, posterior, 4 chains."""
    a = jax_operator(32, True, variance="small")
    rng = np.random.default_rng(3)
    f, x = rng.normal(size=a.vshape), rng.normal(size=chain_shape + a.vshape)
    jsampler = JMultigridMCSampler(a, nlevel=3, smoother="SOR", cycle=2, coarse_scaling=0.9,
                                   omega=1.0, distill=False)
    assert not jsampler.fused_levels and jsampler.distilled is None  # its composed path
    nsteps = 3 if len(chain_shape) == 1 else 2
    want = jnp.asarray(x)
    for step in range(nsteps):
        want = jsampler.apply(jax.random.key(10 + step), jnp.asarray(f), want)

    sampler = MultigridMCSampler(to_port(a), nlevel=3, smoother="SOR", cycle=2,
                                 coarse_scaling=0.9, omega=1.0, fused=fused)
    assert sorted(sampler.fused_levels) == ([0, 1] if fused else [])
    draws = recorded_normals
    if fused and len(chain_shape) > 1:
        # the fused levels take one flat chain axis: apply() flattens (2, 2) to 4
        draws = [d.reshape((-1,) + d.shape[len(chain_shape):]) for d in draws]
    replay = ReplayNoise(draws)
    got = tt(x)
    for _ in range(nsteps):
        got = sampler.apply(replay, tt(f), got)
    assert replay.exhausted
    assert got.shape == x.shape
    assert_close(got, want, **REPLAY)


def test_mgmc_construction_matches_jax_package():
    """The port's own construction (prior, measurements, Galerkin levels,
    Woodbury factors, Cholesky factor) against the JAX package's."""
    a = jax_operator(32, True)
    jsampler = JMultigridMCSampler(a, nlevel=3, cycle=2, distill=False)
    prior = shiftedlaplace_fd(Lattice((32, 32)), ConstantCorrelationLengthModel(0.3),
                              device=CPU, dtype=torch.float64)
    from test_torch_common import measurement_params
    import dataclasses

    params = MeasurementParameters(**dataclasses.asdict(measurement_params()))
    sampler = MultigridMCSampler(measured_operator(prior, params), nlevel=3, cycle=2)
    tol = dict(rtol=1e-10, atol=1e-12)
    for ja, pb in zip(jsampler.hierarchy.operators, sampler.hierarchy.operators):
        assert_close(pb.coeffs, ja.coeffs, **tol)
        assert_close(pb.lowrank.B, ja.lowrank.B, **tol)
    for jp, pp in zip(jsampler.presamplers + jsampler.postsamplers,
                      sampler.presamplers + sampler.postsamplers):
        assert_close(pp.smoother.B_bar, jp.smoother.B_bar, **tol)
        assert_close(pp.sqrt_precision_diag, jp.sqrt_precision_diag, **tol)
    assert_close(sampler.coarse_sampler.L, jsampler.coarse_sampler.L, **tol)


# ---------------------------------------------------------------- statistics
def _mean_covariance_error(op, sampler, nchains, nwarmup, nsteps, seed):
    """Chain mean against ``Q^{-1} f`` and sample covariance against
    ``Q^{-1}`` in the max norm, over ``nchains`` chains x ``nsteps`` steps."""
    n = op.lattice.nvertex
    rng = np.random.default_rng(seed)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = torch.as_tensor((Q @ mean_exact).reshape(op.vshape), dtype=op.dtype)
    noise = GeneratorNoise(seed, CPU)
    x = torch.zeros((nchains,) + op.vshape, dtype=op.dtype)
    for _ in range(nwarmup):
        x = sampler.apply(noise, f, x)
    sx, sxx = np.zeros(n), np.zeros((n, n))
    for _ in range(nsteps):
        x = sampler.apply(noise, f, x)
        xf = x.reshape(nchains, n).double().numpy()
        sx += xf.sum(axis=0)
        sxx += xf.T @ xf
    total = nchains * nsteps
    Ex = sx / total
    cov = sxx / total - np.outer(Ex, Ex)
    return np.max(np.abs(Ex - mean_exact)), np.max(np.abs(cov - np.linalg.inv(Q)))


def _small_posterior(dtype):
    rng = np.random.default_rng(1212417)
    prior = shiftedlaplace_fd(Lattice((8, 8)), ConstantCorrelationLengthModel(0.4),
                              device=CPU, dtype=dtype)
    params = MeasurementParameters(
        measurement_locations=np.array([[0.25, 0.25], [0.25, 0.75], [0.75, 0.25], [0.75, 0.75]]),
        mean=rng.normal(size=4), variance=1e-2 * (1.0 + 2.0 * rng.uniform(size=4)))
    return measured_operator(prior, params), params


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused_plain_versions"])
def test_mgmc_sampler_statistics(fused):
    """The port alone: 2-level W-cycle MGMC on an 8x8 posterior reproduces mean
    and covariance (tolerance 0.05 at 96k samples; entries of Q^{-1} are O(1))."""
    op, _ = _small_posterior(torch.float64)
    sampler = MultigridMCSampler(op, nlevel=2, cycle=2, fused=fused)
    em, ec = _mean_covariance_error(op, sampler, nchains=512, nwarmup=10, nsteps=188, seed=7)
    scale = np.max(np.abs(np.linalg.inv(op.to_dense())))
    assert em < 0.05 * np.sqrt(scale) and ec < 0.05 * scale, (em, ec, scale)


def test_mean_shifted_sampler_float32():
    """float32 chains carried as fluctuation around the exact (float64) mean:
    the chain mean is the posterior mean and the variance of an observable is
    the exact one."""
    op, params = _small_posterior(torch.float32)
    mean = posterior_mean(op, np.zeros(op.vshape), params.y())
    inner = MultigridMCSampler(op, nlevel=2, cycle=2, fused=True)
    sampler = MeanShiftedSampler(inner, mean)
    assert sampler.mean.dtype == torch.float32
    noise = GeneratorNoise(11, CPU)
    C, steps = 512, 150
    x = sampler.mean.expand((C,) + op.vshape).clone()
    acc = torch.zeros(op.vshape, dtype=torch.float64)
    acc2 = torch.zeros(op.vshape, dtype=torch.float64)
    for k in range(10 + steps):
        x = sampler.apply(noise, None, x)
        assert x.dtype == torch.float32
        if k >= 10:
            acc += x.double().mean(dim=0)
            acc2 += ((x.double() - torch.as_tensor(mean)) ** 2).mean(dim=0)
    var_exact = np.diag(np.linalg.inv(op.to_dense())).reshape(op.vshape)
    scale = var_exact.max()
    assert np.max(np.abs((acc / steps).numpy() - mean)) < 0.05 * np.sqrt(scale)
    assert np.max(np.abs((acc2 / steps).numpy() - var_exact)) < 0.05 * scale


def test_generator_noise_is_reproducible_and_counts_launches():
    a, b = GeneratorNoise(5, CPU), GeneratorNoise(5, CPU)
    torch.testing.assert_close(a.normal((3, 4), torch.float64, CPU),
                               b.normal((3, 4), torch.float64, CPU), rtol=0, atol=0)
    assert [a.philox_stream() for _ in range(3)] == [(5, 0), (5, 1), (5, 2)]
    replay = ReplayNoise([np.zeros((2, 2))])
    assert replay.philox_stream() is None
    with pytest.raises(RuntimeError, match="asked for"):
        replay.normal((3,), torch.float64, CPU)
    replay.normal((2, 2), torch.float64, CPU)
    with pytest.raises(RuntimeError, match="exhausted"):
        replay.normal((2, 2), torch.float64, CPU)


# ---------------------------------------------------------------- negative tests
def test_default_device_without_a_gpu_raises():
    """The entry points run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    lattice, model = Lattice((8, 8)), ConstantCorrelationLengthModel(0.3)
    with pytest.raises(RuntimeError, match="CUDA device"):
        shiftedlaplace_fd(lattice, model)
    with pytest.raises(RuntimeError, match="CUDA device"):
        GeneratorNoise(1)
    op = shiftedlaplace_fd(lattice, model, device=CPU)
    with pytest.raises((RuntimeError, AssertionError)):
        MultigridMCSampler(op, nlevel=2, device="cuda")
    from multigridmc_tpu_torch.convert import operator_from_numpy

    with pytest.raises(RuntimeError, match="CUDA device"):
        operator_from_numpy(op.coeffs.numpy(), op.offsets, (8, 8))


@pytest.mark.parametrize("kwargs,match", [
    (dict(smoother="SSOR"), None),
    (dict(coarse_solver="SSOR"), None),
    (dict(distill=True, nlevel=3), None),
    (dict(distill="auto", nlevel=3), None),
    (dict(sweep_schedule="alternating"), None),
], ids=["ssor", "ssor_coarse", "distill", "distill_auto", "alternating"])
def test_unported_sampler_options_raise(kwargs, match):
    """Options of a later slice raise; SSOR, the distilled subtree and the
    alternating schedule (``match=None``) are ported and must construct and take
    a finite step."""
    op = shiftedlaplace_fd(Lattice((8, 8)), ConstantCorrelationLengthModel(0.3), device=CPU)
    if match is None:
        sampler = MultigridMCSampler(op, **{"nlevel": 2, **kwargs})
        if "distill" in kwargs:  # True distils on any device, "auto" not on the CPU
            assert (sampler.distilled is not None) == (kwargs["distill"] is True)
        x = sampler.apply(GeneratorNoise(1, CPU), torch.zeros(op.vshape),
                          torch.zeros((2,) + op.vshape))
        assert x.shape == (2,) + op.vshape and bool(torch.isfinite(x).all())
        return
    with pytest.raises(NotImplementedError, match=match):
        MultigridMCSampler(op, nlevel=2, **kwargs)


def test_unported_models_and_smoothers_raise():
    lattice, model = Lattice((8, 8)), ConstantCorrelationLengthModel(0.3)
    # every PDE model of the configuration files builds (the FEM and the
    # squared finite-difference priors since the twelfth slice)
    for name, n_offsets in (("shiftedlaplace_fem", 9), ("squared_shiftedlaplace_fd", 13)):
        op = prior_operator(name, lattice, model, device=CPU)
        assert len(op.offsets) == n_offsets and op.vshape == (7, 7)
    with pytest.raises(ValueError, match="unknown PDE model"):
        prior_operator("nonsense", lattice, model, device=CPU)
    from multigridmc_tpu_torch.smoothers import SSORSmoother

    ssor = smoother_factory("SSOR", 1.0, 1)(shiftedlaplace_fd(lattice, model, device=CPU))
    assert isinstance(ssor, SSORSmoother)  # ported with the second slice
    with pytest.raises(ValueError, match="invalid"):
        MultigridMCSampler(shiftedlaplace_fd(lattice, model, device=CPU), 2, smoother="Jacobi")


def test_3d_lattice_runs_through_the_composed_path():
    """On the CPU a 3d hierarchy runs composed unless fused levels are asked
    for; asked for, its levels take the 3d kernels' plain versions, and a step
    draws the same normals and computes the same sample."""
    op = shiftedlaplace_fd(Lattice((8, 8, 8)), ConstantCorrelationLengthModel(0.3),
                           device=CPU, dtype=torch.float64)
    sampler = MultigridMCSampler(op, nlevel=2, cycle=1)
    assert sampler.fused_levels == {}
    f = torch.zeros(op.vshape, dtype=torch.float64)
    x = sampler.apply(GeneratorNoise(1, CPU), f, torch.zeros((3,) + op.vshape,
                                                             dtype=torch.float64))
    assert x.shape == (3, 7, 7, 7) and bool(torch.isfinite(x).all())
    fused = MultigridMCSampler(op, nlevel=2, cycle=1, fused=True)
    assert list(fused.fused_levels) == [0] and fused.fused_levels[0].dim == 3
    got = fused.apply(GeneratorNoise(1, CPU), f, torch.zeros((3,) + op.vshape,
                                                             dtype=torch.float64))
    torch.testing.assert_close(got, x, rtol=1e-12, atol=1e-12)
