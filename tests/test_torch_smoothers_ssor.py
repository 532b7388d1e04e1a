"""SSOR in the port: the smoother, the sampler, and MGMC with SSOR levels or an
SSOR coarse sampler, against the JAX package on the CPU in float64.

Noisy paths replay the JAX package's ``jax.random.normal`` draws in call order
(per directed sweep the field, then the low-rank scalars; forward before
backward), so both sides do the same arithmetic: ``rtol = 1e-9, atol = 1e-11``
(summation order, accumulated over a cycle); deterministic paths
``rtol = 1e-10, atol = 1e-12``.  The statistical test holds ``SSORSampler``
against dense ``Q^-1`` in the class of ``tests/test_sampler.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.samplers.mgmc import MultigridMCSampler as JMultigridMCSampler
from multigridmc_tpu.samplers.sor import SSORSampler as JSSORSampler
from multigridmc_tpu.samplers.sor import sampler_factory as jsampler_factory
from multigridmc_tpu.smoothers import SSORSmoother as JSSORSmoother

from multigridmc_tpu_torch.convert import smoother_from_numpy, ssor_smoother_from_numpy
from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
from multigridmc_tpu_torch.samplers.base import (GeneratorNoise, MeanShiftedSampler, ReplayNoise,
                                                 Sampler)
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.samplers.sor import SORSampler, SSORSampler, sampler_factory
from multigridmc_tpu_torch.smoothers import BACKWARD, FORWARD, SSORSmoother, smoother_factory

from test_torch_common import CPU, F64, assert_close, jax_operator, to_port, tt
from test_torch_sampler import recorded_normals  # noqa: F401  (fixture)

REPLAY = dict(rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_ssor_smoother_matches_jax(lowrank, omega):
    a = jax_operator(16, lowrank)
    rng = np.random.default_rng(1)
    b, x = rng.normal(size=a.vshape), rng.normal(size=(3,) + a.vshape)
    jsm = JSSORSmoother(a, omega, 2)
    want = jsm.apply(jnp.asarray(b), jnp.asarray(x))
    sm = smoother_factory("SSOR", omega, 2)(to_port(a))
    assert isinstance(sm, SSORSmoother)
    assert_close(sm.apply(tt(b), tt(x)), want, **F64)
    if lowrank:
        assert_close(sm.forward.B_bar, jsm.forward.B_bar, **F64)
        assert_close(sm.backward.B_bar, jsm.backward.B_bar, **F64)
        # the two directions' factors differ: one can never stand in for the other
        assert float((sm.forward.B_bar - sm.backward.B_bar).abs().max()) > 1e-6


def test_woodbury_factor_belongs_to_its_direction():
    """Carrying the JAX package's ``B_bar`` across, each to its own direction,
    reproduces its SSOR step; swapping the two does not."""
    a = jax_operator(16, True)
    jsm = JSSORSmoother(a, 1.3, 1)
    rng = np.random.default_rng(2)
    b, x = rng.normal(size=a.vshape), rng.normal(size=(2,) + a.vshape)
    want = jsm.apply(jnp.asarray(b), jnp.asarray(x))
    fwd, bwd = np.asarray(jsm.forward.B_bar), np.asarray(jsm.backward.B_bar)
    right = ssor_smoother_from_numpy(to_port(a), 1.3, 1, fwd, bwd)
    assert_close(right.apply(tt(b), tt(x)), want, **F64)
    wrong = ssor_smoother_from_numpy(to_port(a), 1.3, 1, bwd, fwd)
    assert float((wrong.apply(tt(b), tt(x)) - tt(np.asarray(want))).abs().max()) > 1e-6
    single = smoother_from_numpy(to_port(a), 1.3, 1, BACKWARD, bwd)
    assert_close(single.apply(tt(b), tt(x)), jsm.backward.apply(jnp.asarray(b), jnp.asarray(x)),
                 **F64)
    with pytest.raises(ValueError, match="B_bar"):
        smoother_from_numpy(to_port(a), 1.3, 1, FORWARD, None)
    with pytest.raises(ValueError, match="does not match"):
        smoother_from_numpy(to_port(a), 1.3, 1, FORWARD, fwd[:2])


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_ssor_sampler_replays_jax_draws(recorded_normals, lowrank, omega):  # noqa: F811
    a = jax_operator(16, lowrank)
    rng = np.random.default_rng(3)
    f, x = rng.normal(size=a.vshape), rng.normal(size=(4,) + a.vshape)
    want = JSSORSampler(a, omega, 2).apply(jax.random.key(5), jnp.asarray(f), jnp.asarray(x))
    # per step: forward (field, low-rank), backward (field, low-rank)
    assert len(recorded_normals) == 2 * 2 * (2 if lowrank else 1)
    replay = ReplayNoise(recorded_normals)
    got = SSORSampler(to_port(a), omega, 2).apply(replay, tt(f), tt(x))
    assert replay.exhausted
    assert_close(got, want, **REPLAY)


def test_sampler_factory_and_base_protocol():
    a = to_port(jax_operator(8, True))
    assert isinstance(sampler_factory("sor", 1.0, 1, BACKWARD)(a), SORSampler)
    ssor = sampler_factory("SSOR", 1.2, 3)(a)
    assert isinstance(ssor, SSORSampler) and ssor.nsmooth == 3
    assert ssor.forward.smoother.direction == FORWARD
    assert ssor.backward.smoother.direction == BACKWARD
    assert ssor.forward.smoother.coloring is ssor.backward.smoother.coloring
    with pytest.raises(ValueError, match="unknown sampler"):
        sampler_factory("Jacobi", 1.0, 1)
    assert jsampler_factory("SSOR", 1.2, 3) is not None  # the counterpart exists

    class Counting(Sampler):
        calls = []

        def apply(self, noise, f, x):
            self.calls.append(f)
            return x + 1

        def fix_rhs(self, f):
            self.calls.append(("fix", f))

    inner = Counting(a)
    x = torch.zeros(a.vshape, dtype=torch.float64)
    assert torch.equal(inner.apply_indexed(None, "f", x, 7), x + 1)  # the index is ignored
    shifted = MeanShiftedSampler(inner, np.ones(a.vshape))
    out = shifted.apply_indexed(None, "ignored", x, 3)
    assert torch.equal(out, x + 1)  # mean + ((x - mean) + 1)
    assert inner.calls[-1] is shifted._zero
    shifted.fix_rhs("ignored")
    assert inner.calls[-1][0] == "fix" and inner.calls[-1][1] is shifted._zero
    shifted.unfix_rhs()


@pytest.mark.parametrize("nsteps", [1, 3])
@pytest.mark.parametrize("kwargs", [dict(smoother="SSOR"), dict(coarse_solver="SSOR", ncoarsesmooth=2)],
                         ids=["ssor_levels", "ssor_coarse"])
def test_mgmc_with_ssor_replays_jax_draws(recorded_normals, kwargs, nsteps):  # noqa: F811
    """Whole MGMC steps (3 levels, W-cycle, posterior, 4 chains) with SSOR
    smoothing on every level, and with an SSOR coarse sampler."""
    a = jax_operator(32, True, variance="small")
    rng = np.random.default_rng(4)
    f, x = rng.normal(size=a.vshape), rng.normal(size=(4,) + a.vshape)
    common = dict(nlevel=3, cycle=2, coarse_scaling=0.9, omega=1.1, **kwargs)
    jsampler = JMultigridMCSampler(a, distill=False, **common)
    assert not jsampler.fused_levels and jsampler.distilled is None  # its composed path
    want = jnp.asarray(x)
    for step in range(nsteps):
        want = jsampler.apply_indexed(jax.random.key(20 + step), jnp.asarray(f), want, step)

    sampler = MultigridMCSampler(to_port(a), **common)
    assert sampler.fused_levels == {}  # on the CPU the composed path, as in the JAX package
    replay = ReplayNoise(recorded_normals)
    got = tt(x)
    for step in range(nsteps):
        got = sampler.apply_indexed(replay, tt(f), got, step)
    assert replay.exhausted
    assert_close(got, want, **REPLAY)


def test_mgmc_with_ssor_levels_never_builds_fused_visits():
    """Once SSOR-only-composed (the name is kept from then); the fused visit
    kernels now take two sweeps per visit: with SSOR levels ``fused=True``
    builds a fused level of two directions and ``fused=False`` none, and
    ``npresmooth > 1`` leaves the level to the composed visit."""
    a = to_port(jax_operator(16, True))
    sampler = MultigridMCSampler(a, nlevel=2, smoother="SSOR", fused=True)
    assert sorted(sampler.fused_levels) == [0]
    fused = sampler.fused_levels[0]
    ssor = sampler.presamplers[0]
    assert fused.ndir == 2 and isinstance(ssor, SSORSampler)
    assert fused.pre_orders == (ssor.forward.smoother.order, ssor.backward.smoother.order)
    assert fused.post_orders == fused.pre_orders
    assert MultigridMCSampler(a, nlevel=2, smoother="SSOR", fused=False).fused_levels == {}
    assert MultigridMCSampler(a, nlevel=2, smoother="SSOR", npresmooth=2,
                              fused=True).fused_levels == {}
    sampler = MultigridMCSampler(a, nlevel=2, coarse_solver="SSOR", fused=True)
    assert sorted(sampler.fused_levels) == [0] and isinstance(sampler.coarse_sampler, SSORSampler)


def test_single_chain_is_a_batch_of_one_for_the_fused_visits(recorded_normals):  # noqa: F811
    """A single chain goes through the fused levels as a batch of one and
    matches the JAX package's single-chain step under the same draws."""
    a = jax_operator(16, True)
    rng = np.random.default_rng(6)
    f, x = rng.normal(size=a.vshape), rng.normal(size=a.vshape)
    jsampler = JMultigridMCSampler(a, nlevel=2, cycle=2, distill=False)
    want = jsampler.apply(jax.random.key(1), jnp.asarray(f), jnp.asarray(x))
    sampler = MultigridMCSampler(to_port(a), nlevel=2, cycle=2, fused=True)
    replay = ReplayNoise([d[None] for d in recorded_normals])
    got = sampler.apply(replay, tt(f), tt(x))
    assert replay.exhausted and got.shape == x.shape
    assert_close(got, want, **REPLAY)


def test_ssor_sampler_statistics():
    """``SSORSampler`` alone on an 8x8 posterior: mean and covariance against
    dense ``Q^-1`` (the 2e-3 class of ``tests/test_sampler.py``: tolerance
    0.05 of the largest covariance entry at 800 x 500 thinned-by-nothing
    samples, since successive SSOR states are correlated)."""
    rng = np.random.default_rng(1212417)
    prior = shiftedlaplace_fd(Lattice((8, 8)), ConstantCorrelationLengthModel(0.4),
                              device=CPU, dtype=torch.float64)
    params = MeasurementParameters(
        measurement_locations=np.array([[0.25, 0.25], [0.25, 0.75], [0.75, 0.25], [0.75, 0.75]]),
        mean=rng.normal(size=4), variance=1e-2 * (1.0 + 2.0 * rng.uniform(size=4)))
    op = measured_operator(prior, params)
    n = op.lattice.nvertex
    Q = op.to_dense()
    cov_exact = np.linalg.inv(Q)
    mean_exact = rng.uniform(size=n)
    f = torch.as_tensor((Q @ mean_exact).reshape(op.vshape))
    sampler = SSORSampler(op, 1.3, 1)
    noise = GeneratorNoise(17, CPU)
    C, nwarm, nsteps = 800, 60, 500
    x = torch.zeros((C,) + op.vshape, dtype=torch.float64)
    sx, sxx = np.zeros(n), np.zeros((n, n))
    for k in range(nwarm + nsteps):
        x = sampler.apply(noise, f, x)
        if k >= nwarm:
            xf = x.reshape(C, n).numpy()
            sx += xf.sum(axis=0)
            sxx += xf.T @ xf
    total = C * nsteps
    Ex = sx / total
    cov = sxx / total - np.outer(Ex, Ex)
    scale = np.max(np.abs(cov_exact))
    assert np.max(np.abs(Ex - mean_exact)) < 0.05 * np.sqrt(scale)
    assert np.max(np.abs(cov - cov_exact)) < 0.05 * scale
