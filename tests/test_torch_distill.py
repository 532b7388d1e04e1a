"""The distilled coarse subtree of the port against the JAX package's.

Both packages distil the same subtree (the port's hierarchy is rebuilt from the
JAX hierarchy's arrays) in float64 on the CPU.  The map ``T`` comes out of the
same arithmetic in another summation order: ``rtol = 1e-10, atol = 1e-12``.  The
noise factor is held through ``S S^T`` at ``rtol = 1e-8`` (relative to the
largest entry): the factor itself is only fixed up to the jitter ladder of the
Cholesky factorisation.  Whole sampler steps replay the JAX package's
``jax.random.normal`` draws through ``ReplayNoise`` and agree at
``rtol = 1e-9, atol = 1e-11``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.samplers.distill import distill_subtree as jdistill_subtree
from multigridmc_tpu.samplers.distill import pick_distill_level as jpick_distill_level
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler as JMultigridMCSampler
from multigridmc_tpu.solvers.multigrid import MultigridPreconditioner as JPreconditioner

from multigridmc_tpu_torch.convert import distilled_from_numpy, hierarchy_from_numpy
from multigridmc_tpu_torch.samplers.base import GeneratorNoise, ReplayNoise
from multigridmc_tpu_torch.samplers.distill import (DEFAULT_DISTILL_MAX_N, DistilledSubtree,
                                                    _SubtreeSpec, distill_subtree,
                                                    pick_distill_level, resolve_distill_level)
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.solvers.loop import IterativeSolverParameters, LoopSolver
from multigridmc_tpu_torch.solvers.multigrid import MultigridPreconditioner

from test_torch_common import CPU, F64, assert_close, jax_operator, to_port, tt
from test_torch_sampler import (_mean_covariance_error, _small_posterior,  # noqa: F401
                                recorded_normals)

REPLAY = dict(rtol=1e-9, atol=1e-11)


def port_hierarchy(jhierarchy):
    """The port's hierarchy from the JAX hierarchy's arrays."""
    levels = []
    for op in jhierarchy.operators:
        lr = op.lowrank
        levels.append(dict(
            coeffs=np.asarray(op.coeffs), offsets=op.offsets, lattice_shape=op.lattice.shape,
            B=None if lr is None else np.asarray(lr.B),
            Sigma_diag=None if lr is None else np.asarray(lr.Sigma_diag)))
    return hierarchy_from_numpy(levels, device=CPU, dtype=torch.float64)


def sampler_pair(nx=16, nlevel=3, distill=False, **kw):
    """The JAX sampler and the port's on the same hierarchy."""
    a = jax_operator(nx, True)
    js = JMultigridMCSampler(a, nlevel=nlevel, distill=distill, **kw)
    hierarchy = port_hierarchy(js.hierarchy)
    ps = MultigridMCSampler(hierarchy.operators[0], nlevel=nlevel, hierarchy=hierarchy,
                            distill=distill, **kw)
    return a, js, ps


def test_pick_distill_level():
    a = jax_operator(32, True)
    js = JMultigridMCSampler(a, nlevel=4, smoother="SOR", distill=False)
    ops = port_hierarchy(js.hierarchy).operators
    assert [o.lattice.nvertex for o in ops] == [961, 225, 49, 9]
    assert DEFAULT_DISTILL_MAX_N == 4160
    assert pick_distill_level(ops) == 1  # largest sub-level within budget
    assert pick_distill_level(ops, max_n=100) == 2
    assert pick_distill_level(ops, max_n=5) is None  # nothing fits
    assert pick_distill_level(ops[:2], max_n=10**6) is None  # only coarsest
    for max_n in (4160, 100, 5):
        assert pick_distill_level(ops, max_n) == jpick_distill_level(js.hierarchy.operators, max_n)


def test_resolve_distill_level_by_device_and_argument():
    ops = MultigridMCSampler(to_port(jax_operator(32, True)), nlevel=4, distill=False
                             ).hierarchy.operators
    assert resolve_distill_level(False, ops) is None
    assert resolve_distill_level(None, ops) is None
    assert resolve_distill_level("auto", ops) is None  # the CPU: off, as the JAX package off a TPU
    assert resolve_distill_level(True, ops) == 1
    with pytest.raises(ValueError, match="invalid distill"):
        resolve_distill_level("always", ops)


@pytest.mark.parametrize("smoother,cycle,coarse", [
    ("SOR", 2, "Cholesky"), ("SSOR", 1, "Cholesky"), ("SOR", 2, "SSOR")],
    ids=["sor_w_cholesky", "ssor_v_cholesky", "sor_w_ssor_coarse"])
def test_distilled_sampler_map_matches_jax(smoother, cycle, coarse):
    """noise=True: T, S S^T and the number of noise dimensions."""
    _, js, ps = sampler_pair(smoother=smoother, cycle=cycle, coarse_solver=coarse)
    li = 1
    want = jdistill_subtree(js.hierarchy.operators[li:], js.presamplers[li:],
                            js.postsamplers[li:], js.coarse_sampler, js.cycle,
                            js.coarse_scaling, noise=True)
    got = distill_subtree(ps.hierarchy.operators[li:], ps.presamplers[li:], ps.postsamplers[li:],
                          ps.coarse_sampler, ps.cycle, ps.coarse_scaling, noise=True)
    assert got.info == want.info and got.info["K"] > got.info["n"]
    spec = _SubtreeSpec(ps.hierarchy.operators[li:], ps.presamplers[li:], ps.postsamplers[li:],
                        ps.coarse_sampler, ps.cycle, ps.coarse_scaling)
    assert spec.count_noise(True) == want.info["K"] and spec.count_noise(False) == 0
    assert_close(got.Tm, want.Tm, **F64)
    C_want = np.asarray(want.S_T).T @ np.asarray(want.S_T)
    C_got = (got.S_T.T @ got.S_T).numpy()
    np.testing.assert_allclose(C_got, C_want, rtol=1e-8, atol=1e-8 * np.abs(C_want).max())
    assert torch.equal(got.S_T, torch.triu(got.S_T))  # the upper factor


@pytest.mark.parametrize("smoother,cycle", [("SOR", 2), ("SSOR", 1)])
def test_distilled_T_matches_deterministic_subtree(smoother, cycle):
    """noise=False with the Cholesky solver: T against the JAX package's, and
    against the port's own composed deterministic recursion to 1e-12; the
    stochastic distillation shares that T."""
    a = jax_operator(16, True)
    jpc = JPreconditioner(a, nlevel=3, smoother=smoother, cycle=cycle, distill=False)
    hierarchy = port_hierarchy(jpc.hierarchy)
    pc = MultigridPreconditioner(hierarchy.operators[0], nlevel=3, smoother=smoother, cycle=cycle,
                                 hierarchy=hierarchy, distill=False)
    li = pick_distill_level(pc.hierarchy.operators)
    assert li == 1
    want = jdistill_subtree(jpc.hierarchy.operators[li:], jpc.presmoothers[li:],
                            jpc.postsmoothers[li:], jpc.coarse_solver, jpc.cycle,
                            jpc.coarse_scaling, noise=False)
    det = distill_subtree(pc.hierarchy.operators[li:], pc.presmoothers[li:],
                          pc.postsmoothers[li:], pc.coarse_solver, pc.cycle, pc.coarse_scaling,
                          noise=False)
    assert det.S_T is None and det.info == want.info
    assert_close(det.Tm, want.Tm, **F64)
    b = tt(np.random.default_rng(3).normal(size=(3,) + pc.hierarchy.operators[li].vshape))
    err = float((pc._solve(li, b) - det.solve(b)).abs().max())
    assert err < 1e-12, err
    s = MultigridMCSampler(hierarchy.operators[0], nlevel=3, smoother=smoother, cycle=cycle,
                           hierarchy=hierarchy, distill=False)
    sto = distill_subtree(s.hierarchy.operators[li:], s.presamplers[li:], s.postsamplers[li:],
                          s.coarse_sampler, s.cycle, s.coarse_scaling, noise=True)
    # the two differ only in the coarse solve (triangular solves against cholesky_solve)
    assert float((sto.Tm - det.Tm).abs().max()) < 1e-13


def test_cholesky_solver_cannot_inject_noise():
    pc = MultigridPreconditioner(to_port(jax_operator(16, True)), nlevel=3, distill=False)
    with pytest.raises(ValueError, match="cannot inject noise"):
        distill_subtree(pc.hierarchy.operators[1:], pc.presmoothers[1:], pc.postsmoothers[1:],
                        pc.coarse_solver, 1, 1.0, noise=True)


def test_distilled_apply_replays_jax_draw(recorded_normals):
    """The JAX package's (T, S) loaded into the port, fed the JAX draw."""
    _, js, _ = sampler_pair(smoother="SOR", cycle=2)
    d = jdistill_subtree(js.hierarchy.operators[1:], js.presamplers[1:], js.postsamplers[1:],
                         js.coarse_sampler, js.cycle, js.coarse_scaling, noise=True)
    f = np.random.default_rng(4).normal(size=(5,) + d.vshape)
    want = d.apply(jax.random.key(8), jnp.asarray(f))
    assert len(recorded_normals) == 1
    port = distilled_from_numpy(np.asarray(d.Tm), np.asarray(d.S_T), d.vshape, device=CPU,
                                dtype=torch.float64)
    replay = ReplayNoise(recorded_normals)
    got = port.apply(replay, tt(f))
    assert replay.exhausted
    assert_close(got, want, rtol=1e-10, atol=1e-12)
    # a deterministic map takes no noise
    det = distilled_from_numpy(np.asarray(d.Tm), None, d.vshape, device=CPU, dtype=torch.float64)
    assert_close(det.solve(tt(f)).reshape(5, -1), np.asarray(f).reshape(5, -1) @ np.asarray(d.Tm), **F64)
    with pytest.raises(ValueError, match=r"must be \(49, 49\)"):
        distilled_from_numpy(np.zeros((3, 3)), None, d.vshape, device=CPU)


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused_plain_versions"])
def test_mgmc_distilled_steps_replay_jax_draws(recorded_normals, fused):
    """Whole steps of ``MultigridMCSampler(distill=True)``: 4 levels, W-cycle,
    posterior, 4 chains; the subtree from level 1 down is distilled by each
    package for itself."""
    a, js, ps = sampler_pair(nx=32, nlevel=4, distill=True, smoother="SOR", cycle=2,
                             coarse_scaling=0.9)
    assert js.distilled is not None and js.distill_level == 1
    if fused:
        ps = MultigridMCSampler(ps.hierarchy.operators[0], nlevel=4, hierarchy=ps.hierarchy,
                                distill=True, smoother="SOR", cycle=2, coarse_scaling=0.9,
                                fused=True)
    assert ps.distilled is not None and ps.distill_level == 1
    assert sorted(ps.fused_levels) == ([0, 1, 2] if fused else [])
    rng = np.random.default_rng(3)
    f, x = rng.normal(size=a.vshape), rng.normal(size=(4,) + a.vshape)
    want = jnp.asarray(x)
    for step in range(3):
        want = js.apply(jax.random.key(20 + step), jnp.asarray(f), want)
    # per step: pre (field, low-rank), the distilled draw, post (field, low-rank)
    assert len(recorded_normals) == 3 * 5
    replay = ReplayNoise(recorded_normals)
    got = tt(x)
    for _ in range(3):
        got = ps.apply(replay, tt(f), got)
    assert replay.exhausted
    assert_close(got, want, **REPLAY)


def test_mgmc_distilled_single_chain_is_a_batch_of_one():
    """The JAX package leaves a single chain to its composed recursion; the
    port runs it through the distilled map as a batch of one."""
    _, _, ps = sampler_pair(nx=32, nlevel=4, distill=True, smoother="SOR", cycle=2)
    rng = np.random.default_rng(5)
    f, x = tt(rng.normal(size=ps.op.vshape)), tt(rng.normal(size=ps.op.vshape))

    class Recording(GeneratorNoise):
        shapes = []

        def normal(self, shape, dtype, device):
            self.shapes.append(tuple(shape))
            return super().normal(shape, dtype, device)

    noise = Recording(3, CPU)
    one = ps.apply(noise, f, x)
    assert one.shape == x.shape and (1, 225) in noise.shapes
    batch = ps.apply(GeneratorNoise(3, CPU), f, x[None])
    torch.testing.assert_close(one, batch[0], rtol=0, atol=0)


def test_mgmc_distilled_statistical_gate():
    """The port alone: MGMC with the subtree distilled reproduces mean and
    covariance of an 8x8 posterior (3 levels 7^2, 3^2, 1; SSOR; the gate of
    ``test_mgmc_sampler_statistics``: 0.05 at 96k samples)."""
    op, _ = _small_posterior(torch.float64)
    sampler = MultigridMCSampler(op, nlevel=3, smoother="SSOR", coarse_solver="Cholesky",
                                 omega=1.0, cycle=2, distill=True)
    assert sampler.distilled is not None and sampler.distill_level == 1
    em, ec = _mean_covariance_error(op, sampler, nchains=512, nwarmup=10, nsteps=188, seed=9)
    scale = np.max(np.abs(np.linalg.inv(op.to_dense())))
    assert em < 0.05 * np.sqrt(scale) and ec < 0.05 * scale, (em, ec, scale)


def test_distilled_preconditioner_matches_jax_and_composed():
    a = jax_operator(16, True)
    jpc = JPreconditioner(a, nlevel=3, smoother="SOR", cycle=2, distill=True)
    assert jpc.distilled is not None
    hierarchy = port_hierarchy(jpc.hierarchy)
    kw = dict(nlevel=3, smoother="SOR", cycle=2, hierarchy=hierarchy)
    pc_off = MultigridPreconditioner(hierarchy.operators[0], distill=False, **kw)
    pc_on = MultigridPreconditioner(hierarchy.operators[0], distill=True, **kw)
    pc_auto = MultigridPreconditioner(hierarchy.operators[0], **kw)
    assert pc_on.distilled is not None and pc_on.distill_level == 1
    assert pc_off.distilled is None and pc_auto.distilled is None  # "auto" on the CPU: off
    b = np.random.default_rng(5).normal(size=(4,) + a.vshape)
    got = pc_on.apply(tt(b))
    assert float((got - pc_off.apply(tt(b))).abs().max()) < 1e-12
    assert_close(got, jpc.apply(jnp.asarray(b)), rtol=1e-10, atol=1e-12)
    # a single right-hand side is a batch of one
    torch.testing.assert_close(pc_on.apply(tt(b[0])), got[0], rtol=1e-12, atol=1e-14)
    solver = LoopSolver(hierarchy.operators[0], pc_on,
                        IterativeSolverParameters(rtol=1e-12, atol=1e-9, maxiter=100))
    res = solver.solve(tt(b))
    assert res.converged, res.rnorm


@pytest.mark.parametrize("precision", [None, "highest", "high", "default"])
def test_distill_precision_tiers(precision):
    """Every tier gives the full-float32 result on the CPU (TF32 exists on the
    card only); "default" allows TF32 inside the two products only."""
    Tm = torch.as_tensor(np.random.default_rng(0).normal(size=(9, 9)), dtype=torch.float32)
    d = DistilledSubtree(Tm, Tm.T.contiguous(), (3, 3), dict(n=9, K=9, noise=True),
                         precision=precision)
    f = torch.ones((2, 3, 3))
    seen = []

    class Probe(GeneratorNoise):
        def normal(self, shape, dtype, device):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return super().normal(shape, dtype, device)

    got = d.apply(Probe(1, CPU), f)
    want = DistilledSubtree(Tm, Tm.T.contiguous(), (3, 3), {}).apply(GeneratorNoise(1, CPU), f)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert seen == [precision == "default"]
    assert torch.backends.cuda.matmul.allow_tf32 is False  # restored


def test_invalid_distill_precision_raises():
    with pytest.raises(ValueError, match="invalid distill precision"):
        DistilledSubtree(torch.eye(4), None, (2, 2), {}, precision="bf16")
    op = to_port(jax_operator(16, True))
    with pytest.raises(ValueError, match="invalid distill precision"):
        MultigridMCSampler(op, nlevel=3, distill=True, distill_precision="low")
