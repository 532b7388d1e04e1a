"""Levels of more than 32 measurements (``LANE_SLOTS``), on the CPU.

The CUDA kernels keep a level's low-rank vectors one entry a lane in static
shared memory up to ``mgmc_visit.LANE_SLOTS`` measurements, and in dynamic
shared memory sized by ``m`` above (``csrc/visit_phases.cuh``); the kernels
run on the card only (``chip_smoke.py``, phase ``lowrank``).  Here, at 40 and
64 measurements placed at distinct vertices (``generate_measurements``'
separated points):

* the plain visits against the JAX package's ``FusedVisitLevel`` in Pallas
  interpret mode (float32, ``rtol = atol = 2e-5``; a reach-2 level's ``f_c``
  within 2e-5 of ``max(|f_c|, 1)``) and its composed path (float64, ``rtol =
  1e-10, atol = 1e-12``): 2d reach 1 with one and two sweeps, reach 2, 3d;
* the plain subtree against the JAX ``SubtreeKernel`` interpreted (float32,
  ``5e-4``, the tolerance of ``tests/test_torch_subtree.py``);
* a flagship-shaped sampler (5-level W-cycle, SOR, Cholesky) with 64
  measurements, its levels fused, against the JAX sampler on the JAX draws
  replayed (float64, ``rtol = 1e-9, atol = 1e-11``);
* the routes: the stream kernels refuse such a level (a 255^2 level of 64
  measurements at 256 chains takes the phase kernels), the smem and split
  kernels take it where their bands and the scratch fit, all decided before
  any launch; the host's sizes of the scratch against the sources.
"""

import ctypes
import re
from pathlib import Path
from types import SimpleNamespace as NS

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConst
from multigridmc_tpu.models.posterior import MeasurementParameters as JParams
from multigridmc_tpu.models.posterior import measured_operator as jmeasured
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshifted
from multigridmc_tpu.models.prior import squared_shiftedlaplace_fd as jsquared
from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.ops.coloring import coloring_for as jcoloring_for
from multigridmc_tpu.ops.intergrid import prolongate_add as jprolongate_add
from multigridmc_tpu.ops.intergrid import restrict as jrestrict
from multigridmc_tpu.ops.kernels.mgmc_subtree_pallas import SubtreeKernel as JSubtreeKernel
from multigridmc_tpu.ops.kernels.mgmc_visit_pallas import FusedVisitLevel as JFusedVisitLevel
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler as JMultigridMCSampler
from multigridmc_tpu.smoothers import BACKWARD, FORWARD
from multigridmc_tpu.smoothers import SORSmoother as JSORSmoother
from multigridmc_tpu.smoothers import SSORSmoother as JSSORSmoother
from multigridmc_tpu.solvers.multigrid import MultigridHierarchy as JMultigridHierarchy

from multigridmc_tpu_torch.convert import subtree_kernel_from_numpy
from multigridmc_tpu_torch.drivers.generate_measurements import sample_points
from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem as vsm
from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3
from multigridmc_tpu_torch.parallel.data_parallel import DataParallelMGMCSampler
from multigridmc_tpu_torch.parallel.mesh import chains_mesh
from multigridmc_tpu_torch.samplers.base import ReplayNoise
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.smoothers import SORSmoother, SSORSmoother

from test_torch_common import CPU, F32, F64, assert_close, to_port, tt
from test_torch_sampler import recorded_normals  # noqa: F401  (fixture)

GAMMA = 0.75
REPLAY = dict(rtol=1e-9, atol=1e-11)
M = 40
CSRC = Path(mv.__file__).resolve().parents[2] / "csrc"


def params(n, dim, dmin, variance="order_one", seed=2154157):
    """``n`` measurements at points ``dmin`` apart (``generate_measurements``'
    draw, so at distinct vertices of the lattices below), normal means,
    variances ``0.5 + u`` or, near exact, ``1e-6 (1 + u)``."""
    rng = np.random.default_rng(seed + 1)
    u = rng.uniform(size=n)
    var = 1e-6 * (1.0 + u) if variance == "near_exact" else 0.5 + u
    return JParams(measurement_locations=sample_points(n, dim, dmin, seed),
                   mean=rng.normal(size=n), variance=var)


def jax_op(kind, m=M, dtype=jnp.float64, level=0):
    """The JAX operator of a kind with ``m`` measurements: the 31^2 FD level
    (``"2d"``), the 23^2 squared-FD 13-point level (``"reach2"``), the 11^3
    FD level (``"3d"``); ``level`` 1 its Galerkin coarsening."""
    if kind == "2d":
        a = jmeasured(jshifted(JLattice((32, 32)), JConst(0.3), dtype=dtype),
                      params(m, 2, 0.05))
    elif kind == "reach2":
        a = jmeasured(jsquared(JLattice((24, 24)), JConst(0.3), dtype=dtype),
                      params(m, 2, 0.06))
    else:
        a = jmeasured(jshifted(JLattice((12, 12, 12)), JConst(0.3), dtype=dtype),
                      params(m, 3, 0.15))
    return jgalerkin(a) if level else a


def distinct_vertices(a):
    """Whether each column of B peaks at a vertex no other column touches."""
    B = np.asarray(a.lowrank.B).reshape(a.lowrank.B.shape[0], -1)
    peaks = np.argmax(np.abs(B), axis=1)
    return len(set(peaks.tolist())) == B.shape[0]


def fused_pair(a, sweeps, dtype):
    """The JAX ``FusedVisitLevel`` (interpreted; float32 only) or its smoothers,
    and the port's level, of one (SOR) or two (SSOR) sweeps a visit."""
    b = to_port(a, dtype)
    if sweeps == 1:
        coloring = jcoloring_for(a.offsets, a.vshape)
        jpre = JSORSmoother(a, 1.0, 1, FORWARD, coloring)
        jpost = JSORSmoother(a, 1.0, 1, BACKWARD, coloring)
        pre, post = SORSmoother(b, 1.0, 1, FORWARD), SORSmoother(b, 1.0, 1, BACKWARD)
        port = mv.FusedVisitLevel(b, pre.coloring, 1.0, pre.order, post.order, pre.B_bar,
                                  post.B_bar, GAMMA)
        jargs = (coloring, 1.0, jpre.order, jpost.order, jpre.B_bar, jpost.B_bar)
        return (jpre, jpost), jargs, port
    jssor = JSSORSmoother(a, 1.0, 1)
    fw, bw = jssor.forward, jssor.backward
    Bbar = jnp.concatenate([fw.B_bar, bw.B_bar], axis=0)
    orders, pBbar, coloring, _ = mv._sweep_spec(SSORSmoother(b, 1.0, 1))
    port = mv.FusedVisitLevel(b, coloring, 1.0, orders, orders, pBbar, pBbar, GAMMA)
    jargs = (fw.coloring, 1.0, (fw.order, bw.order), (fw.order, bw.order), Bbar, Bbar)
    return (jssor, jssor), jargs, port


def inputs(vshape, seed, C=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=vshape), rng.normal(size=(C,) + vshape),
            rng.normal(size=(C,) + tuple(n // 2 for n in vshape)))


CASES = [("2d", 1, 0), ("2d", 2, 0), ("2d", 1, 1), ("reach2", 1, 0), ("3d", 1, 0)]
IDS = ["2d_sor", "2d_ssor", "2d_galerkin9pt", "reach2_13pt", "3d_7pt"]


@pytest.mark.parametrize("kind,sweeps,level", CASES, ids=IDS)
def test_plain_visits_match_interpreted_pallas_kernels_at_40_measurements(kind, sweeps, level):
    a = jax_op(kind, dtype=jnp.float32, level=level)
    assert distinct_vertices(jax_op(kind, dtype=jnp.float32))
    _, jargs, port = fused_pair(a, sweeps, torch.float32)
    assert port.op.m_lowrank == M > mv.LANE_SLOTS
    assert mv.kernel_support_error(port.op, port.coloring.n_colors) is None
    jfused = JFusedVisitLevel(a, *jargs, coarse_scaling=GAMMA, interpret=True)
    f, x, xc = inputs(a.vshape, seed=1)
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


@pytest.mark.parametrize("kind,sweeps,level", CASES, ids=IDS)
def test_plain_visits_match_composed_jax_path_float64_at_40_measurements(kind, sweeps, level):
    a = jax_op(kind, level=level)
    (jpre, jpost), _, port = fused_pair(a, sweeps, torch.float64)
    dim = len(a.vshape)
    f, x, xc = inputs(a.vshape, seed=2)
    jf, jx, jxc = jnp.asarray(f), jnp.asarray(x), jnp.asarray(xc)
    exp_x = jpre.apply(jf, jx)
    px, pfc = mv.descend_visit(port, tt(f), tt(x))
    assert_close(px, exp_x, **F64)
    assert_close(pfc, jrestrict(jf - a.apply(exp_x), dim=dim), **F64)
    exp_a = jpost.apply(jf, jprolongate_add(GAMMA, jxc, jx, dim=dim))
    assert_close(mv.ascend_visit(port, tt(f), tt(x), tt(xc)), exp_a, **F64)


def test_plain_subtree_matches_jax_kernel_in_interpret_mode_at_40_measurements():
    """float32, noise off, a 32x32 posterior of 40 measurements, 3 levels,
    W-cycle, gamma = 0.75: the subtree's plain version against the JAX
    ``SubtreeKernel`` interpreted; the launch tables of such sub-levels: two
    m-vectors a warp and the block's vector."""
    ops = JMultigridHierarchy(jax_op("2d", dtype=jnp.float32), 3).operators
    cycle, omega = 2, 1.0
    pres = [JSORSmoother(o, omega, 1, FORWARD) for o in ops[:-1]]
    posts = [JSORSmoother(o, omega, 1, BACKWARD) for o in ops[:-1]]
    L = jnp.linalg.cholesky(jnp.asarray(ops[-1].to_dense(), jnp.float32))
    jkernel = JSubtreeKernel(ops, pres, posts, L, omega, cycle, GAMMA, interpret=True)
    f = np.random.default_rng(8).normal(size=(4,) + ops[0].vshape).astype(np.float32)
    want = jkernel.sample(jax.random.key(0), jnp.asarray(f), noise=False)
    levels = [dict(coeffs=np.asarray(o.coeffs), offsets=o.offsets, lattice_shape=o.lattice.shape,
                   B=np.asarray(o.lowrank.B), Sigma_diag=np.asarray(o.lowrank.Sigma_diag))
              for o in ops]
    kernel = subtree_kernel_from_numpy(
        levels, [np.asarray(p.B_bar) for p in pres], [np.asarray(p.B_bar) for p in posts],
        np.asarray(L), omega, cycle, GAMMA, device=CPU, dtype=torch.float32)
    got = st.subtree_sample(kernel, torch.as_tensor(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)
    assert kernel.wide and kernel._warp_stride == st.slot_words(M) == 2 * M
    # the block's vector right after the slots, at the end of the tables
    assert kernel._warp_vec + 32 * 2 * M + M <= kernel._tables.size
    # each level's boxes right after its Sigma^1/2, where the wide kernel reads them
    words = kernel._tables
    for lv, off in zip(kernel.levels, kernel._table_offsets):
        at = off["sroot"] + M
        boxes = words[at:at + 3 * 4 * M].reshape(3, M, 4)
        assert [tuple(b) for b in boxes[0]] == list(lv.bbox)
        for d, order in enumerate((lv.pre_order, lv.post_order)):
            assert [tuple(b) for b in boxes[1 + d]] == list(lv._woodbury[order][2])


def test_subtree_tables_stay_in_device_memory_where_they_do_not_fit(monkeypatch):
    """Where the launch tables do not fit a block (W is m^2 floats a level
    and direction), the kernel reads them in the table tensor: nothing is
    copied, and only the warps' slots (2 m floats each) and the block's
    m-vector lie at the front of shared memory, before the fields."""
    op = to_port(jax_op("2d"), torch.float32)
    shared = MultigridMCSampler(op, 3, cycle=2, subtree=True).subtree
    assert shared.wide and shared.tables_shared
    S = shared._build_params(2, 1, False)
    assert (S.table_words, S.warp_vec) == (shared._tables.size, shared._warp_vec)
    assert S.warp_vec > 0  # the slots follow the tables: the kernel copies them
    monkeypatch.setattr(st, "dynamic_smem_limit", lambda device=None: 4 * shared._tables.size)
    flat = MultigridMCSampler(op, 3, cycle=2, subtree=True).subtree
    assert not flat.tables_shared and flat.placement["tables_shared"] is False
    S = flat._build_params(2, 1, False)
    slots = 32 * 2 * M
    assert (S.warp_vec, S.warp_stride) == (0, 2 * M)  # 0: the tables stay in device memory
    assert S.table_words == slots + M + (-(slots + M) % 4)
    assert flat.smem_bytes == 4 * (S.table_words + flat._smem_floats)
    f = torch.randn((2,) + tuple(flat.vshape), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(st.subtree_sample(flat, f), st.subtree_sample(shared, f))


@pytest.mark.parametrize("variance", ["order_one", "near_exact"])
def test_flagship_shaped_sampler_with_64_measurements_replays_jax(recorded_normals,  # noqa: F811
                                                                  variance):
    """Two steps of the flagship's sampler (5-level W-cycle, SOR, omega 1,
    Cholesky) on a 64x64 posterior of 64 measurements at distinct vertices,
    every level but the coarsest fused (the plain versions), against the JAX
    package's composed sampler on the same normals.  Near exact (Sigma about
    1e-6) the two forms of the Woodbury correction, the port's factors ``Y``,
    ``W`` and JAX's dense ``B_bar``, differ by rounding that ``Sigma^-1`` (about
    1e6) amplifies over 64 columns: there an absolute 1e-8 on values of order
    one, as ``tests/test_torch_mgmc_visit.py`` holds the near-exact residual."""
    a = jmeasured(jshifted(JLattice((64, 64)), JConst(0.2)), params(64, 2, 0.05, variance))
    assert distinct_vertices(a)
    rng = np.random.default_rng(3)
    f, x = rng.normal(size=a.vshape), rng.normal(size=(3,) + a.vshape)
    kw = dict(nlevel=5, smoother="SOR", cycle=2, omega=1.0, coarse_solver="Cholesky",
              distill=False)
    jsampler = JMultigridMCSampler(a, **kw)
    assert not jsampler.fused_levels
    want = jnp.asarray(x)
    for step in range(2):
        want = jsampler.apply(jax.random.key(20 + step), jnp.asarray(f), want)
    sampler = MultigridMCSampler(to_port(a), fused=True, fused_min_vertices=0, **kw)
    assert sorted(sampler.fused_levels) == [0, 1, 2, 3]
    assert {lv.op.m_lowrank for lv in sampler.fused_levels.values()} == {64}
    replay = ReplayNoise(recorded_normals)
    got = tt(x)
    for _ in range(2):
        got = sampler.apply(replay, tt(f), got)
    assert replay.exhausted
    assert_close(got, want, **(REPLAY if variance == "order_one" else dict(rtol=1e-9, atol=1e-8)))


@pytest.mark.parametrize("m", [33, 64, 256])
def test_constructors_take_many_measurements(m):
    """``MultigridMCSampler`` and ``DataParallelMGMCSampler`` build their fused
    levels (float32; ``fused=True``, the gate of the card) at up to 256
    measurements, and the levels' phase launches size the scratch by ``m``."""
    a = jmeasured(jshifted(JLattice((64, 64)), JConst(0.2), dtype=jnp.float32),
                  params(m, 2, 0.04 if m == 256 else 0.05))
    op = to_port(a, torch.float32)
    sampler = MultigridMCSampler(op, 4, fused=True, fused_min_vertices=0, distill=False)
    assert sorted(sampler.fused_levels) == [0, 1, 2]
    dp = DataParallelMGMCSampler(op, 4, chains_mesh("cpu"), fused=True, distill=False,
                                 fused_min_vertices=0)
    assert sorted(dp.sampler.fused_levels) == [0, 1, 2]
    level = sampler.fused_levels[0]
    tables, T, smem = level.phase_launch(level.pre_orders, 512)
    lowrank = mv.lowrank_scratch_bytes(m, 512)
    assert lowrank == 4 * m * (1 + 2 * 16)
    assert smem == (4 * T.words if T.shared else 0) + lowrank
    # the parameter block holds the first LANE_SLOTS boxes, the device table all
    P = level._build_params(8, level.pre_order, False, 1)
    ybox = list(level._woodbury[level.pre_order][2])
    assert [tuple(P.bbox[k]) for k in range(mv.LANE_SLOTS)] == list(level.bbox)[:mv.LANE_SLOTS]
    assert [tuple(P.ybox[k]) for k in range(mv.LANE_SLOTS)] == ybox[:mv.LANE_SLOTS]
    boxes = level.box_table(level.pre_order).numpy().reshape(2, m, 4)
    assert [tuple(b) for b in boxes[0]] == list(level.bbox)
    assert [tuple(b) for b in boxes[1]] == ybox
    assert mv.box_pointers(level, level.pre_orders) == (
        level.box_table(level.pre_order).data_ptr(), 0)


def test_gate_refuses_only_past_the_scratch_limit():
    """The gate's limit is the phase kernels' scratch at their largest block
    beside the static share, under the H100's opt-in (814 on a 2d reach-1
    level, 1,604 on a reach-2 or 3d level), and it says so."""
    assert mv.max_lowrank(1024) == 814 and mv.max_lowrank(512) == 1604
    assert mv.lowrank_scratch_bytes(814, 1024) + mv.PHASE_STATIC_SMEM <= mv.SMEM_PER_BLOCK_OPTIN
    assert mv.lowrank_scratch_bytes(815, 1024) + mv.PHASE_STATIC_SMEM > mv.SMEM_PER_BLOCK_OPTIN
    assert mv.lowrank_scratch_bytes(mv.LANE_SLOTS, 1024) == 0
    op = NS(vshape=(31, 31), offsets=((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
            m_lowrank=815)
    err = mv.kernel_support_error(op, 2)
    assert "more than 814 measurements" in err and "232448" in err
    op.m_lowrank = 814
    assert mv.kernel_support_error(op, 2) is None


def test_stream_kernels_refuse_more_than_their_cap():
    """A 255^2 level of 64 measurements at 256 chains takes the phase
    kernels, where one of 8 takes the stream kernels (``STREAM_MIN_CHAINS``);
    the route names the cap when the stream route is asked for, before any
    launch."""
    assert mv.STREAM_MAX_LOWRANK == mv.LANE_SLOTS == 32
    assert mv.stream_min_chains((255, 255), 0) == 256
    kw = dict(vshape=(255, 255), form=0, ndir=1, smem_limit=mv.SMEM_PER_BLOCK_OPTIN)
    assert mv.visit_route(256, 80000, m=8, **kw) == "stream"
    assert mv.visit_route(256, 80000, m=mv.STREAM_MAX_LOWRANK, **kw) == "stream"
    assert mv.visit_route(256, 80000, m=64, **kw) == "phase"
    a = jmeasured(jshifted(JLattice((256, 256)), JConst(0.2), dtype=jnp.float32),
                  params(64, 2, 0.05))
    b = to_port(a, torch.float32)
    pre, post = SORSmoother(b, 1.0, 1, FORWARD), SORSmoother(b, 1.0, 1, BACKWARD)
    level = mv.FusedVisitLevel(b, pre.coloring, 1.0, pre.order, post.order, pre.B_bar,
                               post.B_bar, GAMMA)
    assert level.op.vshape == (255, 255) and level.stencil_form == 0
    assert level.route(256) == "phase" and level.route(512) == "phase"
    err = mv.route_support_error(level, "stream")
    assert "at most 32 measurements" in err and "64" in err
    with pytest.raises(NotImplementedError, match="at most 32 measurements"):
        level._params(256, level.pre_orders, False, 0, None, route="stream")


def test_split_route_counts_the_lowrank_vectors():
    """The split kernels keep ``(S + 4) m`` floats of low-rank vectors after
    their bands above 32 measurements: the host's size and the source's."""
    src = (CSRC / "mgmc_visit_split.cu").read_text()
    assert "(m > LANE_SLOTS ? (long long)(S + 4) * m : 0)" in src
    assert "mgmc_split_smem_bytes(P->H, P->W, S, P->m)" in src
    base = mv.split_smem_bytes(255, 255, 4)
    assert mv.split_smem_bytes(255, 255, 4, 32) == base
    assert mv.split_smem_bytes(255, 255, 4, 64) == base + 4 * 8 * 64
    assert (mv.split_smem_bytes(255, 255, 16, 256)
            == mv.split_smem_bytes(255, 255, 16) + 4 * 20 * 256)
    # a limit that holds the bands but not the vectors: no cluster size, the phase kernels
    tiny = mv.split_smem_bytes(127, 127, 16) + mv.SPLIT_STATIC_SMEM
    assert mv.split_cluster(1, (127, 127), CPU, smem_limit=tiny) == 16
    assert mv.split_cluster(1, (127, 127), CPU, smem_limit=tiny, m=256) is None
    kw = dict(device=CPU, vshape=(127, 127), form=2, smem_limit=tiny)
    assert mv.visit_route(1, m=8, **kw) == "split"
    assert mv.visit_route(1, m=256, **kw) == "phase"


class Shape:
    """A level as the smem rules read it: shape, stencil form, device, m."""

    def __init__(self, vshape, form, m, ndir=1):
        self.op = NS(vshape=vshape, device=torch.device("cpu"), m_lowrank=m)
        self.stencil_form, self.ndir = form, ndir


@pytest.mark.parametrize("m", [8, 64, 256])
def test_smem_routes_take_the_scratch_before_the_route(m):
    """The 2d smem kernels' rule counts the scratch after the band: at 8
    measurements (none) the flagship's 255^2 SSOR level's cluster sizes are
    those of before; at 64 and 256 each size the rule keeps holds band, rows
    and scratch under the H100's grant; under a grant that holds the
    smallest band alone no size is left above 32 measurements, and the level
    takes the phase kernels, decided before any launch."""
    level = Shape((255, 255), 0, m, ndir=2)
    grant = mv.SMEM_PER_BLOCK_OPTIN
    got = vsm.candidates(level, smem_limit=grant)
    for S, (c_sh, threads) in got.items():
        need = (vsm.smem_bytes(255, 255, S, c_sh) + mv.lowrank_scratch_bytes(m, threads)
                + vsm.STATIC_SMEM)
        assert need <= grant
    assert got and vsm.smem_cluster(level, 256, smem_limit=grant) is not None
    few = vsm.candidates(Shape((255, 255), 0, 8, ndir=2), smem_limit=grant)
    assert set(few) == {2, 4, 8, 16}
    if m <= mv.LANE_SLOTS:
        assert got == few
    small = min(vsm.smem_bytes(255, 255, S, c_sh) + vsm.STATIC_SMEM
                for S, (c_sh, _) in few.items())
    tight = vsm.candidates(level, smem_limit=small)
    assert bool(tight) == (m <= mv.LANE_SLOTS)
    assert (vsm.smem_cluster(level, 256, smem_limit=small) is None) == (m > mv.LANE_SLOTS)


def test_smem3d_table_entries_that_no_longer_fit_take_the_phase_kernels(monkeypatch):
    """The 3d route table lists a configuration per chain count; a level whose
    scratch does not fit beside that configuration's slab takes the phase
    kernels (``smem_cluster`` is None), one that fits keeps it."""
    conf = v3.route_config((63, 63, 63), 10, 1, 1)
    assert conf == (16, True, 1024)
    assert v3.smem_cluster(Shape((63, 63, 63), 10, 8), 1) == 16
    assert v3.smem_cluster(Shape((63, 63, 63), 10, 64), 1) == 16
    slab = v3.smem_bytes(63, 63, 63, 16, True) + v3.STATIC_SMEM
    m_over = (v3.ss.CPU_SMEM_LIMIT - slab) // (4 * (1 + 64)) + 1
    assert not v3.fits(Shape((63, 63, 63), 10, m_over), *conf)
    assert v3.smem_cluster(Shape((63, 63, 63), 10, m_over), 1) is None


def test_scratch_size_and_lane_layout_in_the_sources():
    """The host's scratch size is the source's, and every kernel that took a
    cap of 32 has an instance for a level of more (LR, the subtree's WIDE),
    which reads the scratch from dynamic shared memory: the phase, smem and
    smem3d launchers refuse a launch whose bytes do not hold it; a parameter
    block holds LANE_SLOTS boxes whatever m (the LR kernels read every box
    from the level's device table), so no block's size depends on m."""
    phases = (CSRC / "visit_phases.cuh").read_text()
    assert "#define LANE_SLOTS 32" in phases
    assert "return m > LANE_SLOTS ? m * (1 + 2 * (threads >> 5)) : 0;" in phases
    assert "int bbox[LANE_SLOTS][BOX_INTS];" in phases and "MAX_LOWRANK" not in phases
    for m, threads in ((8, 512), (33, 512), (64, 1024), (256, 512)):
        want = m * (1 + 2 * (threads >> 5)) if m > 32 else 0
        assert mv.lowrank_scratch_bytes(m, threads) == 4 * want
    passes = (CSRC / "level_passes.cuh").read_text()
    assert "for (int k = threadIdx.x & 31; k < m; k += 32)" in passes
    assert "philox_normals4((uint32_t)(k >> 2), (uint32_t)chain, seed, counter, z4);" in passes
    for name in ("mgmc_visit.cu", "mgmc_visit_smem.cu", "mgmc_visit_smem3d.cu",
                 "mgmc_visit_split.cu", "mgmc_subtree.cu", "mgmc_visit_stream.cu"):
        src = (CSRC / name).read_text()
        assert not re.search(r"\bMAX_LOWRANK\b", src), name
    phase = (CSRC / "mgmc_visit.cu").read_text()
    assert "lowrank_scratch_floats(P->m, threads)" in phase
    assert "phase_kernel(descend, form, L->ndir, P->m > LANE_SLOTS)" in phase
    for name in ("mgmc_visit_smem.cu", "mgmc_visit_smem3d.cu", "mgmc_visit_split.cu"):
        src = (CSRC / name).read_text()
        assert "const bool lr = P->m > LANE_SLOTS;" in src, name
        assert "const int* __restrict__ boxes0" in src and "__restrict__ boxes1" in src, name
    assert "instance(S->stamps != nullptr, threads, wide != 0)" in (
        CSRC / "mgmc_subtree.cu").read_text()
    assert ctypes.sizeof(mv.VisitParams) == 1296 and ctypes.sizeof(mv.WideVisitParams) == 1552
