"""Two-sweep (SSOR) fused level visits on the CPU: a forward and a backward
Gibbs sweep per visit, each with its own Woodbury factors and fresh noise.

The kernels (the phase kernels' three builds and the split kernels) cannot
run here; their plain versions and replays of their schedules can:

* the plain SSOR descend / ascend against the JAX package's
  ``FusedVisitLevel`` with ``orders = (forward, backward)`` in Pallas
  interpret mode, as ``tests/test_mgmc_visit.py::test_ssor_visits_match_composed``
  runs it (float32, the JAX kernel's only dtype: ``rtol = atol = 2e-5``, the
  reach-2 residual within 2e-5 of ``max(|f_c|, 1)``), and against the JAX
  package's composed SSOR path in float64 (``rtol = 1e-10, atol = 1e-12``): 2d
  reach 1, reach 2 and 3d, with and without measurements, omega 0.9 and 1;
* the plain SSOR visit against the port's composed ``SSORSampler`` draw for
  draw (float64, 1e-12), and whole MGMC steps with fused SSOR levels against
  the JAX package's composed recursion on its replayed draws;
* the directions' factors: swapped, the visit is another (and the kernels'
  tables hold each direction's own);
* a float64 replay of the phase kernels' two-direction passes and of the
  split kernels' two-direction band schedule against the plain versions;
* the route (SSOR never takes the stream kernels; the split kernels only for
  2d reach-1 levels up to ``SPLIT_MAX_CHAINS`` chains), the tables and the
  barrier counts of two directions.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConst
from multigridmc_tpu.models.posterior import measured_operator as jmeasured
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshifted
from multigridmc_tpu.models.prior import squared_shiftedlaplace_fd as jsquared
from multigridmc_tpu.ops.intergrid import prolongate_add as jprolongate_add
from multigridmc_tpu.ops.intergrid import restrict as jrestrict
from multigridmc_tpu.ops.kernels.mgmc_visit_pallas import FusedVisitLevel as JFusedVisitLevel
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler as JMultigridMCSampler
from multigridmc_tpu.smoothers import SSORSmoother as JSSORSmoother

from multigridmc_tpu_torch.ops.intergrid import prolongate_add, restrict
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.samplers.base import ReplayNoise
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.samplers.sor import SSORSampler
from multigridmc_tpu_torch.smoothers import SSORSmoother

from test_torch_common import (CPU, F32, F64, assert_close, jax_operator, measurement_params,
                               to_port, tt)
from test_torch_sampler import recorded_normals  # noqa: F401  (fixture)
from test_torch_visit_split import _small_level, split_visit_replay
from test_torch_visit_tables import (columns, decode, replay_stencil, replay_sweep,
                                     replay_woodbury)

GAMMA = 0.75
REPLAY = dict(rtol=1e-9, atol=1e-11)
KINDS = ["2d", "reach2", "3d"]


def jax_op(kind, lowrank, dtype=jnp.float64, variance="order_one"):
    """The JAX package's operator of a kind: the 15^2 FD level, the 15^2
    squared-FD (13-point) level, the 7^3 FD level; four (3d: three)
    measurements where ``lowrank``."""
    if kind == "2d":
        return jax_operator(16, lowrank, dtype=dtype, variance=variance)
    if kind == "reach2":
        a = jsquared(JLattice((16, 16)), JConst(0.3), dtype=dtype)
        return jmeasured(a, measurement_params(4, 5, variance=variance)) if lowrank else a
    a = jshifted(JLattice((8, 8, 8)), JConst(0.3), dtype=dtype)
    return jmeasured(a, measurement_params(3, 21, variance=variance, dim=3)) if lowrank else a


def ssor_level(op, omega, swap=False):
    """The port's fused SSOR level of ``op`` from its ``SSORSmoother``
    (``_sweep_spec``: the two orders, the two ``B_bar`` stacked); ``swap``
    stacks the backward factor first, each standing in for the other's."""
    orders, Bbar, coloring, _ = mv._sweep_spec(SSORSmoother(op, omega, 1))
    if swap:
        m = op.m_lowrank
        Bbar = torch.cat([Bbar[m:], Bbar[:m]])
    return mv.FusedVisitLevel(op, coloring, omega, orders, orders, Bbar, Bbar, GAMMA)


def inputs(vshape, seed, C=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=vshape), rng.normal(size=(C,) + vshape),
            rng.normal(size=(C,) + tuple(n // 2 for n in vshape)))


# ------------------------------------------------------------- the JAX package
@pytest.mark.parametrize("omega", [0.9, 1.0])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_ssor_visits_match_the_jax_composed_path_float64(kind, lowrank, omega):
    a = jax_op(kind, lowrank)
    jssor = JSSORSmoother(a, omega, 1)
    port = ssor_level(to_port(a), omega)
    assert port.ndir == 2 and port.pre_orders[1] == tuple(reversed(port.pre_orders[0]))
    dim = len(a.vshape)
    f, x, xc = inputs(a.vshape, seed=7)
    jf, jx, jxc = jnp.asarray(f), jnp.asarray(x), jnp.asarray(xc)
    exp_x = jssor.apply(jf, jx)
    px, pfc = mv.descend_visit(port, tt(f), tt(x))
    assert_close(px, exp_x, **F64)
    assert_close(pfc, jrestrict(jf - a.apply(exp_x), dim=dim), **F64)
    exp_a = jssor.apply(jf, jprolongate_add(GAMMA, jxc, jx, dim=dim))
    assert_close(mv.ascend_visit(port, tt(f), tt(x), tt(xc)), exp_a, **F64)


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_ssor_visits_match_interpreted_pallas_kernels(kind, lowrank):
    a = jax_op(kind, lowrank, dtype=jnp.float32)
    jssor = JSSORSmoother(a, 0.9, 1)
    fw, bw = jssor.forward, jssor.backward
    Bbar = None if a.lowrank is None else jnp.concatenate([fw.B_bar, bw.B_bar], axis=0)
    jfused = JFusedVisitLevel(a, fw.coloring, 0.9, (fw.order, bw.order), (fw.order, bw.order),
                              Bbar, Bbar, coarse_scaling=GAMMA, interpret=True)
    port = ssor_level(to_port(a, torch.float32), 0.9)
    f, x, xc = inputs(a.vshape, seed=9)
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    t32 = lambda v: tt(v, torch.float32)  # noqa: E731
    jx, jfc = jfused.descend(jax.random.key(0), f32(f), f32(x), noise=False)
    px, pfc = mv.descend_visit(port, t32(f), t32(x))
    assert_close(px, jx, **F32)
    if kind == "reach2":  # the residual cancels against a diagonal of order h^-4
        scale = max(float(np.max(np.abs(np.asarray(jfc)))), 1.0)
        assert float(np.max(np.abs(pfc.numpy() - np.asarray(jfc)))) < 2e-5 * scale
    else:
        assert_close(pfc, jfc, **F32)
    ja = jfused.ascend(jax.random.key(0), f32(f), f32(x), f32(xc), noise=False)
    assert_close(mv.ascend_visit(port, t32(f), t32(x), t32(xc)), ja, **F32)


# ------------------------------------------------------ draw for draw, the MGMC
@pytest.mark.parametrize("variance", ["order_one", "near_exact"])
@pytest.mark.parametrize("kind", KINDS)
def test_noisy_plain_ssor_visit_is_the_composed_ssor_sampler(kind, variance):
    """With noise tensors the plain SSOR descend is ``SSORSampler.apply``
    (forward: field, low-rank scalars; backward: field, low-rank scalars)
    followed by the residual and the restriction; the ascend the prolongation
    and ``SSORSampler.apply``: the same draws in the same order."""
    op = to_port(jax_op(kind, True, variance=variance))
    port = ssor_level(op, 1.1)
    f, x, xc = inputs(op.vshape, seed=3)
    rng = np.random.default_rng(4)
    m, C = op.m_lowrank, x.shape[0]
    draws = [rng.normal(size=s) for s in (x.shape, (C, m), x.shape, (C, m))]
    tol = dict(rtol=1e-12, atol=1e-12)
    replay = ReplayNoise(draws)
    got_x, got_fc = port.descend(replay, tt(f), tt(x))
    assert replay.exhausted
    want_x = SSORSampler(op, 1.1, 1).apply(ReplayNoise(draws), tt(f), tt(x))
    torch.testing.assert_close(got_x, want_x, **tol)
    want_fc = restrict(tt(f) - op.apply(want_x), dim=len(op.vshape))
    scale = float(want_fc.abs().max())
    assert float((got_fc - want_fc).abs().max()) <= 1e-10 * max(scale, 1.0)
    got = port.ascend(ReplayNoise(draws), tt(f), tt(x), tt(xc))
    want = SSORSampler(op, 1.1, 1).apply(
        ReplayNoise(draws), tt(f), prolongate_add(GAMMA, tt(xc), tt(x), dim=len(op.vshape)))
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("kwargs", [dict(), dict(coarse_solver="SSOR", ncoarsesmooth=2)],
                         ids=["cholesky_coarse", "ssor_coarse"])
def test_mgmc_with_fused_ssor_levels_replays_jax_draws(recorded_normals, kwargs):  # noqa: F811
    """Whole MGMC steps (3 levels, W-cycle, near-exact posterior, 4 chains)
    with every SSOR level fused (``fused=True``: the plain versions here)
    against the JAX package's composed recursion on its draws."""
    a = jax_operator(32, True, variance="near_exact")
    rng = np.random.default_rng(4)
    f, x = rng.normal(size=a.vshape), rng.normal(size=(4,) + a.vshape)
    common = dict(nlevel=3, cycle=2, coarse_scaling=0.9, omega=1.1, smoother="SSOR", **kwargs)
    jsampler = JMultigridMCSampler(a, distill=False, **common)
    assert not jsampler.fused_levels
    want = jnp.asarray(x)
    for step in range(2):
        want = jsampler.apply_indexed(jax.random.key(30 + step), jnp.asarray(f), want, step)
    sampler = MultigridMCSampler(to_port(a), fused=True, distill=False, **common)
    assert sorted(sampler.fused_levels) == [0, 1]
    assert all(lv.ndir == 2 for lv in sampler.fused_levels.values())
    replay = ReplayNoise(recorded_normals)
    got = tt(x)
    for step in range(2):
        got = sampler.apply_indexed(replay, tt(f), got, step)
    assert replay.exhausted
    assert_close(got, want, **REPLAY)


# ------------------------------------------------------- the directions' factors
def test_woodbury_factors_belong_to_their_direction():
    """Each direction applies its own ``B_bar``: stacked the other way round,
    the visit is another, by far more than rounding, noise off and on."""
    op = to_port(jax_op("2d", True, variance="near_exact"))
    port, swapped = ssor_level(op, 1.0), ssor_level(op, 1.0, swap=True)
    f, x, _ = inputs(op.vshape, seed=5)
    rng = np.random.default_rng(6)
    xi, xi_lr = tt(rng.normal(size=(2,) + x.shape)), tt(rng.normal(size=(3, 2 * op.m_lowrank)))
    for noise in ((None, None), (xi, xi_lr)):
        good = mv.descend_visit_plain(port, tt(f), tt(x), *noise)
        bad = mv.descend_visit_plain(swapped, tt(f), tt(x), *noise)
        assert float((good[0] - bad[0]).abs().max()) > 1e-3
        assert float((good[1] - bad[1]).abs().max()) > 1e-3
    # the kernels' tables: direction d holds the Y (and W) of order d
    f32 = ssor_level(op.to(dtype=torch.float32), 1.0)
    factors = [f32._woodbury[order] for order in f32.pre_orders]
    assert not torch.equal(factors[0][0], factors[1][0])
    for d, (Y, W, ybox) in enumerate(factors):
        tab = decode(f32, f32.pre_orders, d)
        staged = np.concatenate([Y[k][mv.box_slices(box)].numpy().reshape(-1)
                                 for k, box in enumerate(ybox)])
        assert np.array_equal(tab["yval"], staged) and np.array_equal(tab["wm"], W.numpy())


def replay_phase_visit(level, kind, f, x, xc, xi, xi_lr, dirs=(0, 1)):
    """A two-direction phase launch from its passes in float64 (one chain):
    per direction ``d`` of ``dirs`` its tables (``decode``: colour rows, ``Y``
    boxes), its noise and its correction, then the descend's residual."""
    orders = level.orders(kind)
    m = level.op.m_lowrank
    if kind == "ascend":
        H, Wd = x.shape
        up = np.zeros((H + 2, Wd + 2))
        up[2:H:2, 2:Wd:2] = xc
        w = (0.5, 1.0, 0.5)
        x = x + level.coarse_scaling * sum(w[a] * w[b] * up[a:a + H, b:b + Wd]
                                           for a in range(3) for b in range(3))
    t = None
    for step, d in enumerate(dirs):
        tab = decode(level, orders, d)
        Y, W, _ = level._woodbury[orders[d]]
        x = replay_sweep(level, tab, orders[d], f + level.noise_scale.numpy() * xi[step], x)
        t, x = replay_woodbury(level, tab, Y, W, x, xi_lr[step * m:(step + 1) * m])
    if kind == "ascend":
        return x
    r = columns(tab["bbox"], level.B.numpy(), t, -1.0, f - replay_stencil(level, x))
    H, Wd = r.shape
    pad = np.zeros((H + 1, Wd + 1))
    pad[:H, :Wd] = r
    w = (0.5, 1.0, 0.5)
    fc = sum(w[a] * w[b] * pad[a:a + H - 1:2, b:b + Wd - 1:2][:H // 2, :Wd // 2]
             for a in range(3) for b in range(3))
    return x, fc


def test_float64_replay_of_the_two_direction_passes_is_the_plain_visit():
    """The phase kernels' passes with two directions' tables, in float64, are
    the plain SSOR visit (1e-12); the second direction's tables in place of
    the first's are not."""
    op = to_port(jax_op("2d", True, variance="near_exact"))
    level = ssor_level(op, 1.0)
    rng = np.random.default_rng(12)
    H, W = op.vshape
    f, x = rng.normal(size=(2, H, W))
    xc = rng.normal(size=level.vc)
    xi = rng.normal(size=(2, H, W))
    xi_lr = rng.normal(size=2 * op.m_lowrank)
    one = lambda v: torch.as_tensor(v)[None]  # noqa: E731
    two = torch.as_tensor(xi)[:, None]
    got_x, got_fc = replay_phase_visit(level, "descend", f, x, None, xi, xi_lr)
    want_x, want_fc = mv.descend_visit_plain(level, torch.as_tensor(f), one(x), two, one(xi_lr))
    np.testing.assert_allclose(got_x, want_x[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_fc, want_fc[0].numpy(), rtol=0, atol=1e-9)
    got = replay_phase_visit(level, "ascend", f, x, xc, xi, xi_lr)
    want = mv.ascend_visit_plain(level, torch.as_tensor(f), one(x), one(xc), two, one(xi_lr))
    np.testing.assert_allclose(got, want[0].numpy(), rtol=0, atol=1e-12)
    wrong, _ = replay_phase_visit(level, "descend", f, x, None, xi, xi_lr, dirs=(1, 0))
    assert np.abs(wrong - want_x[0].numpy()).max() > 1e-3


@pytest.mark.parametrize("S", [2, 8])
def test_split_replay_of_two_sweeps_is_the_plain_visit(S):
    """The split kernels' band schedule with two directions in one launch
    (each direction's rhs, colour phases and correction on the bands in shared
    memory) is the plain SSOR visit in float64, noise off and on."""
    sor = _small_level()
    op = sor.op
    level = ssor_level(op, 1.2)
    rng = np.random.default_rng(S)
    C = 2
    f = tt(rng.normal(size=(C,) + op.vshape))
    x = tt(rng.normal(size=(C,) + op.vshape))
    xc = tt(rng.normal(size=(C,) + level.vc))
    xi = tt(rng.normal(size=(2, C) + op.vshape))
    xi_lr = tt(rng.normal(size=(C, 2 * op.m_lowrank)))
    tol = dict(rtol=1e-12, atol=1e-12)
    for noise in (dict(), dict(xi=xi, xi_lr=xi_lr)):
        got_x, got_fc = split_visit_replay(level, "descend", S, f, x, **noise)
        want_x, want_fc = mv.descend_visit_plain(level, f, x, noise.get("xi"),
                                                 noise.get("xi_lr"))
        torch.testing.assert_close(got_x, want_x, **tol)
        torch.testing.assert_close(got_fc, want_fc, **tol)
        got = split_visit_replay(level, "ascend", S, f, x, xc, **noise)
        want = mv.ascend_visit_plain(level, f, x, xc, noise.get("xi"), noise.get("xi_lr"))
        torch.testing.assert_close(got, want, **tol)


# ------------------------------------------------- route, tables, barriers
def test_ssor_route_never_takes_the_stream_kernels():
    """SSOR is decided on the host before any launch: never the stream
    kernels (where a one-sweep visit of the flagship's 255^2 level takes them
    from 256 chains); the smem kernels where ``mgmc_visit_smem.SMEM_CHAINS``
    lists the level's shape and form (the flagship's 255^2 5-point level, at
    every count), else the split kernels for 2d reach-1 levels up to
    ``SPLIT_MAX_CHAINS`` chains, the phase kernels otherwise; reach 2 and 3d
    take the phase kernels at every count where their tables do not list
    them; a stream launch named by the caller raises."""
    limit = mv.SMEM_PER_BLOCK_OPTIN
    assert mv.visit_route(256, 0, CPU, limit, (255, 255), 0) == "stream"
    assert mv.visit_route(256, 0, CPU, limit, (255, 255), 0, ndir=2) == "smem"
    assert mv.visit_route(1, 0, CPU, limit, (255, 255), 0, ndir=2) == "smem"
    assert mv.visit_route(256, 0, CPU, limit, (253, 253), 0, ndir=2) == "phase"
    assert mv.visit_route(1, 0, CPU, limit, (253, 253), 0, ndir=2) == "split"
    level = ssor_level(_small_level().op, 1.0)
    for C in (1, 4, mv.SPLIT_MAX_CHAINS):
        assert level.route(C) == "split"
    for C in (mv.SPLIT_MAX_CHAINS + 1, 256):
        assert level.route(C) == "phase"
    with pytest.raises(NotImplementedError, match="one sweep per visit"):
        level._params(1, level.pre_orders, False, 0, None, route="stream")
    P = level._params(4, level.pre_orders, False, 1, (5, 6), route="split")
    assert isinstance(P, mv.SplitParams) and P.ndir == 2
    assert [tuple(P.v[d].order[:P.v[d].n_order]) for d in range(2)] == list(level.pre_orders)
    assert [(P.v[d].seed, P.v[d].counter) for d in range(2)] == [(5, 6), (5, 7)]
    phase = level._params(256, level.pre_orders, False, 1, (5, 6))
    assert isinstance(phase, mv.VisitParams) and (phase.seed, phase.counter) == (5, 6)
    for kind in ("reach2", "3d"):
        other = ssor_level(to_port(jax_op(kind, True), torch.float32), 1.0)
        for C in (1, 16, 256):
            assert other.route(C) == "phase"
    # a two-sweep launch counts apart from the one-sweep form
    assert mv.kernel_name(level, "phase", "descend") == "descend_visit_ssor"
    assert mv.kernel_name(level, "split", "ascend") == "ascend_visit_split_ssor"
    assert mv.kernel_name(_small_level(), "split", "ascend") == "ascend_visit_split"


def test_two_direction_tables_and_barriers():
    """The tables of a two-sweep launch hold both directions' rows, ``Y``
    and ``W`` (``B``'s and ``Sigma^1/2`` once); the barriers: per direction
    its rhs, its colours, ``B^T x`` and the Woodbury pass, the descend's
    residual and restriction; the stamps build's row holds them all."""
    for lowrank in (False, True):
        op = to_port(jax_op("2d", lowrank), torch.float32)
        level = ssor_level(op, 1.0)
        words, T = mv.phase_tables(level, level.pre_orders)
        assert T.ndir == 2 and T.words == words.size
        n, lr = len(level.pre_orders[0]), 2 if lowrank else 0
        assert mv.phase_barrier_count(level, "descend") == 2 * (1 + n + lr) + 2
        assert mv.phase_barrier_count(level, "ascend") == 2 * (1 + n + lr)
        for kind in ("descend", "ascend"):
            names = mv.pass_names(level, kind)
            assert len(names) == mv.phase_barrier_count(level, kind)
            assert names[0] == ("d0: rhs" if kind == "descend" else "d0: prolongation + rhs")
        if lowrank:
            for d, order in enumerate(level.pre_orders):
                tab = decode(level, level.pre_orders, d)
                Y, W, ybox = level._woodbury[order]
                assert tab["ybox"] == list(ybox) and np.array_equal(tab["wm"], W.numpy())
    # the widest launch (8 colours, two directions, a descend) fits a stamps row
    assert 2 * (1 + mv.MAX_COLORS + 2) + 2 <= mv.PHASE_STAMP_WIDTH - 4
    # the passes loop over the directions; a later direction's rhs barrier is
    # there with the noise off too, as the count has it
    src = (Path(mv.__file__).resolve().parents[2] / "csrc" / "level_passes.cuh").read_text()
    assert src.count("for (int d = 0; d < nd; ++d)") == 2
    assert "if (d > 0 || noise_mode || zero || sync_first)" in src
