"""The alternating sweep schedule of the port's MGMC sampler, on the CPU.

Odd steps run the same hierarchy with the pre- and post-samplers swapped; each
parity leaves the target invariant, so the alternating chain does too.  The
tests hold the port's parity-1 engine against a fixed sampler with its
samplers swapped by hand (bitwise), its dispatch by step index and
``apply_pair``, three parity-1 steps against the JAX package's parity 1 under
replayed normals (``rtol = 1e-9, atol = 1e-11``: summation order only, over a
W-cycle; composed, and the fused levels on their plain versions), and the
alternating chain against the reference's mean / covariance oracle (the JAX
package's gate, 4e-3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.samplers.mgmc import MultigridMCSampler as JMultigridMCSampler

from multigridmc_tpu_torch.samplers.base import GeneratorNoise, ReplayNoise
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

from test_sampler import make_posterior_2d
from test_torch_common import CPU, assert_close, jax_operator, to_port, tt

REPLAY = dict(rtol=1e-9, atol=1e-11)


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


def _fem_posterior():
    return to_port(make_posterior_2d(8))


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused_plain_versions"])
def test_parity1_equals_the_swapped_sampler(fused):
    """Parity 1 is a fixed-schedule sampler whose pre- and post-samplers (and
    its fused levels' directions) are swapped; parity 0 the fixed sampler."""
    op = to_port(jax_operator(16, True, variance="small"))
    kw = dict(nlevel=3, smoother="SOR", cycle=2, fused=fused)
    alt = MultigridMCSampler(op, sweep_schedule="alternating", **kw)
    fixed = MultigridMCSampler(op, **kw)
    swapped = MultigridMCSampler(op, **kw)
    swapped.presamplers, swapped.postsamplers = swapped.postsamplers, swapped.presamplers
    if fused:
        from multigridmc_tpu_torch.ops.kernels.mgmc_visit import fused_levels_for

        swapped.fused_levels = fused_levels_for(swapped.hierarchy.operators,
                                                swapped.presamplers, swapped.postsamplers,
                                                swapped.coarse_scaling, 0, force=True)
        for level, lv in alt._alt["fused_levels"].items():
            # each parity's levels carry their own directions' Woodbury factors
            assert lv.pre_order == alt.fused_levels[level].post_order
            assert torch.equal(lv.Bbar_pre, alt.fused_levels[level].Bbar_post)
            assert torch.equal(lv.Bbar_post, alt.fused_levels[level].Bbar_pre)
    rng = np.random.default_rng(3)
    f, x = tt(rng.normal(size=op.vshape)), tt(rng.normal(size=(4,) + op.vshape))
    for parity, other in ((1, swapped), (0, fixed)):
        got = alt.apply(GeneratorNoise(7, CPU), f, x.clone(), parity=parity)
        want = other.apply(GeneratorNoise(7, CPU), f, x.clone())
        assert torch.equal(got, want), parity
    # the fixed schedule ignores the parity
    assert torch.equal(fixed.apply(GeneratorNoise(7, CPU), f, x.clone(), parity=1),
                       fixed.apply(GeneratorNoise(7, CPU), f, x.clone()))


def test_apply_indexed_dispatch_and_apply_pair():
    op = to_port(jax_operator(16, True, variance="small"))
    rng = np.random.default_rng(5)
    f, x = tt(rng.normal(size=op.vshape)), tt(rng.normal(size=(2,) + op.vshape))
    fixed = MultigridMCSampler(op, nlevel=3, cycle=1)
    assert fixed._alt is None
    assert torch.equal(fixed.apply_indexed(GeneratorNoise(1, CPU), f, x, 3),
                       fixed.apply(GeneratorNoise(1, CPU), f, x))
    alt = MultigridMCSampler(op, nlevel=3, cycle=1, sweep_schedule="Alternating")
    assert alt.sweep_schedule == "alternating" and alt._alt is not None
    for k, parity in ((2, 0), (5, 1), (0, 0), (7, 1)):
        assert torch.equal(alt.apply_indexed(GeneratorNoise(2, CPU), f, x, k),
                           alt.apply(GeneratorNoise(2, CPU), f, x, parity=parity)), k
    # apply_pair: a parity-0 step, then a parity-1 step, from one noise source
    noise = GeneratorNoise(3, CPU)
    want = alt.apply(noise, f, alt.apply(noise, f, x, parity=0), parity=1)
    assert torch.equal(alt.apply_pair(GeneratorNoise(3, CPU), f, x), want)
    assert not torch.equal(want, fixed.apply_pair(GeneratorNoise(3, CPU), f, x))


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused_plain_versions"])
def test_parity1_steps_replay_jax_draws(recorded_normals, fused):
    """Three parity-1 MGMC steps: 3 levels, W-cycle, posterior, 4 chains."""
    a = jax_operator(32, True, variance="small")
    rng = np.random.default_rng(3)
    f, x = rng.normal(size=a.vshape), rng.normal(size=(4,) + a.vshape)
    jsampler = JMultigridMCSampler(a, nlevel=3, smoother="SOR", cycle=2, coarse_scaling=0.9,
                                   omega=1.0, distill=False, sweep_schedule="alternating")
    assert not jsampler.fused_levels and jsampler.distilled is None  # its composed path
    want = jnp.asarray(x)
    for step in range(3):
        want = jsampler.apply(jax.random.key(10 + step), jnp.asarray(f), want, parity=1)

    sampler = MultigridMCSampler(to_port(a), nlevel=3, smoother="SOR", cycle=2,
                                 coarse_scaling=0.9, omega=1.0, fused=fused,
                                 sweep_schedule="alternating")
    assert sorted(sampler._alt["fused_levels"]) == ([0, 1] if fused else [])
    replay = ReplayNoise(recorded_normals)
    got = tt(x)
    for _ in range(3):
        got = sampler.apply(replay, tt(f), got, parity=1)
    assert replay.exhausted
    assert_close(got, want, **REPLAY)


def test_alternating_sampler_statistics():
    """The alternating chain, both parities through ``apply_indexed``, passes
    the reference's mean / covariance oracle on the 2d FEM posterior (the JAX
    package's gate: 1024 chains x 400 steps, 4e-3)."""
    op = _fem_posterior()
    sampler = MultigridMCSampler(op, nlevel=3, smoother="SOR", omega=1.4, cycle=2,
                                 sweep_schedule="alternating")
    n = op.lattice.nvertex
    rng = np.random.default_rng(1342517)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = tt((Q @ mean_exact).reshape(op.vshape))
    noise = GeneratorNoise(1342517, CPU)
    nchains, nwarmup, nsteps = 1024, 20, 400
    x = torch.zeros((nchains,) + op.vshape, dtype=torch.float64)
    for k in range(nwarmup):
        x = sampler.apply_indexed(noise, f, x, k)
    sx, sxx = np.zeros(n), np.zeros((n, n))
    for k in range(nwarmup, nwarmup + nsteps):
        x = sampler.apply_indexed(noise, f, x, k)
        xf = x.reshape(nchains, n).numpy()
        sx += xf.sum(axis=0)
        sxx += xf.T @ xf
    total = nchains * nsteps
    Ex = sx / total
    cov = sxx / total - np.outer(Ex, Ex)
    em = np.max(np.abs(Ex - mean_exact))
    ec = np.max(np.abs(cov - np.linalg.inv(Q)))
    assert em < 4e-3 and ec < 4e-3, (em, ec)


def test_alternating_distilled_engines():
    """``distill=True``: each parity distils its own subtree (the swapped
    directions give another map), and parity 1 equals the swapped sampler."""
    op = to_port(jax_operator(32, True, variance="small"))
    alt = MultigridMCSampler(op, nlevel=4, cycle=2, distill=True, sweep_schedule="alternating")
    assert alt.distilled is not None and alt._alt["distilled"] is not None
    assert not torch.equal(alt.distilled.Tm, alt._alt["distilled"].Tm)
    swapped = MultigridMCSampler(op, nlevel=4, cycle=2, distill=False)
    swapped.presamplers, swapped.postsamplers = swapped.postsamplers, swapped.presamplers
    swapped.distilled = alt._alt["distilled"]
    swapped.distill_level = alt.distill_level
    rng = np.random.default_rng(9)
    f, x = tt(rng.normal(size=op.vshape)), tt(rng.normal(size=(3,) + op.vshape))
    assert torch.equal(alt.apply(GeneratorNoise(4, CPU), f, x.clone(), parity=1),
                       swapped.apply(GeneratorNoise(4, CPU), f, x.clone()))


def test_subtree_excludes_the_alternating_schedule():
    op = to_port(jax_operator(16, True, variance="small"))
    with pytest.raises(ValueError, match="alternating"):
        MultigridMCSampler(op, nlevel=3, subtree=True, sweep_schedule="alternating")
    with pytest.raises(ValueError, match="invalid sweep_schedule"):
        MultigridMCSampler(op, nlevel=3, sweep_schedule="backwards")
