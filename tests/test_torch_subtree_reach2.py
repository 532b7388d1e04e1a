"""The subtree kernel at reach 2 (the squared shifted-Laplace posterior's
25-point Galerkin sub-levels, 9 colours), on the CPU.

The reach-2 build of ``csrc/mgmc_subtree.cu`` runs on the card only
(``chip_smoke.py`` holds it against :func:`subtree_sample_plain` there).  Here:

* the plain version, float32, noise off, against the JAX package's
  ``SubtreeKernel`` in interpret mode on a 32x32 biharmonic posterior
  (sub-levels 15^2 and 7^2 at 25 points, coarse 3^2), within ``5e-4`` of the
  output's largest magnitude and ``5e-4`` relative: the tolerance of the
  reach-1 case (``tests/test_torch_subtree.py``), scaled to the output, whose
  values here are of order 1e-2 (the squared operator's diagonal is of order
  ``h^-4``);
* in float64 with replayed normals, the plain subtree against the port's
  composed recursion from level 1 (``rtol 1e-9``), and MGMC steps with the
  subtree against steps without;
* the host side of the reach-2 build: its flags and library, the ctypes
  mirrors against the source, the launch tables (25-offset parameter blocks,
  9 colours), the barrier count at 9 colours and the shared-memory placement
  under the larger tables (``tests/test_torch_visit_reach2.py`` holds that reach
  3 is refused before any launch).
"""

import ctypes
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConst
from multigridmc_tpu.models.posterior import measured_operator as jmeasured
from multigridmc_tpu.models.prior import squared_shiftedlaplace_fd as jsquared
from multigridmc_tpu.ops.kernels.mgmc_subtree_pallas import SubtreeKernel as JSubtreeKernel
from multigridmc_tpu.smoothers import BACKWARD, FORWARD
from multigridmc_tpu.smoothers import SORSmoother as JSORSmoother
from multigridmc_tpu.solvers.multigrid import MultigridHierarchy as JMultigridHierarchy

from multigridmc_tpu_torch.convert import subtree_kernel_from_numpy
from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu_torch.models.prior import squared_shiftedlaplace_fd
from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.samplers.base import ReplayNoise
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

from test_torch_common import CPU, measurement_params, tt
from test_torch_subtree import RecordingNoise, level_dicts

#: an H100's dynamic shared memory a block may opt in to
H100_BLOCK_LIMIT = 232448


def biharmonic(nx, dtype, n_meas=4, seed=5, variance="order_one"):
    """The port's squared shifted-Laplace prior (Lambda 0.3) on an nx x nx
    lattice with ``n_meas`` point measurements."""
    prior = squared_shiftedlaplace_fd(Lattice((nx, nx)), ConstantCorrelationLengthModel(0.3),
                                      device=CPU, dtype=dtype)
    return measured_operator(prior, measurement_params(n_meas, seed, variance))


def bench_biharmonic_subtree():
    """The subtree of ``chip_smoke.py``'s biharmonic bench (``native/
    bench_biharmonic_tpu.py``: 256x256, Lambda 0.2, 8 near-exact measurements,
    seed 20260820, means normal(0, 1), 5 levels, W-cycle), float32."""
    prior = squared_shiftedlaplace_fd(Lattice((256, 256)), ConstantCorrelationLengthModel(0.2),
                                      device=CPU, dtype=torch.float32)
    rng = np.random.default_rng(20260820)
    locations = rng.uniform(0.1, 0.9, size=(8, 2))
    mean = rng.normal(0.0, 1.0, size=8)
    var = 1e-6 * (1.0 + rng.uniform(size=8))
    op = measured_operator(prior, MeasurementParameters(
        measurement_locations=locations, mean=mean, variance=var))
    return MultigridMCSampler(op, 5, cycle=2, subtree=True).subtree


@pytest.fixture(scope="module")
def small():
    """A 3-level 64x64 biharmonic posterior's subtree (sub-level 31^2 at 25
    points, coarse 15^2), float32: the shape of ``chip_smoke.py``'s gate."""
    return MultigridMCSampler(biharmonic(64, torch.float32), 3, cycle=2, subtree=True).subtree


def test_plain_reach2_subtree_matches_jax_kernel_in_interpret_mode():
    """float32, noise off, 32x32 biharmonic posterior, 4 levels, W-cycle, gamma 0.75."""
    a = jmeasured(jsquared(JLattice((32, 32)), JConst(0.3), dtype=jnp.float32),
                  measurement_params(4, 5))
    ops = JMultigridHierarchy(a, 4).operators[1:]
    assert [(o.vshape, len(o.offsets)) for o in ops] == [((15, 15), 25), ((7, 7), 25),
                                                          ((3, 3), 25)]
    cycle, gamma, omega = 2, 0.75, 1.0
    pres = [JSORSmoother(o, omega, 1, FORWARD) for o in ops[:-1]]
    posts = [JSORSmoother(o, omega, 1, BACKWARD) for o in ops[:-1]]
    L = jnp.linalg.cholesky(jnp.asarray(ops[-1].to_dense(), jnp.float32))
    jkernel = JSubtreeKernel(ops, pres, posts, L, omega, cycle, gamma, interpret=True)
    f = np.random.default_rng(8).normal(size=(2,) + ops[0].vshape).astype(np.float32)
    want = np.asarray(jkernel.sample(jax.random.key(0), jnp.asarray(f), noise=False))

    kernel = subtree_kernel_from_numpy(
        level_dicts(ops), [np.asarray(p.B_bar) for p in pres],
        [np.asarray(p.B_bar) for p in posts], np.asarray(L), omega, cycle, gamma,
        device=CPU, dtype=torch.float32)
    assert kernel.reach == 2
    assert [lv.coloring.n_colors for lv in kernel.levels] == [9, 9]
    got = st.subtree_sample(kernel, torch.as_tensor(f))  # a CPU tensor: the plain version
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4 * scale)


@pytest.fixture(scope="module")
def samplers64():
    """A 4-level W-cycle on a 32x32 biharmonic posterior in float64, with the
    subtree call and composed, level 0 fused."""
    op = biharmonic(32, torch.float64, variance="small")
    kw = dict(nlevel=4, smoother="SOR", cycle=2, coarse_scaling=0.9, distill=False, fused=True)
    return {sub: MultigridMCSampler(op, subtree=sub, **kw) for sub in (False, True)}


def test_plain_reach2_subtree_equals_the_composed_recursion(samplers64):
    """float64: the subtree's plain version on levels 1.. against the composed
    recursion from level 1 under the same normals, as one (C, K) tensor too."""
    sub, composed = samplers64[True], samplers64[False]
    kernel = sub.subtree
    assert kernel.reach == 2 and [len(lv.op.offsets) for lv in kernel.levels] == [25, 25]
    f = tt(np.random.default_rng(2).normal(size=(3,) + kernel.vshape))
    noise = RecordingNoise(4)
    got = kernel.sample(noise, f)
    assert [r.shape for r in noise.record] == kernel.draw_shapes(3)
    replay = ReplayNoise(noise.record)
    want = composed._sample(1, replay, f, torch.zeros_like(f))
    assert replay.exhausted
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    xi = torch.cat([tt(r).reshape(3, -1) for r in noise.record], dim=1)
    assert xi.shape == (3, kernel.count_noise())
    torch.testing.assert_close(st.subtree_sample_plain(kernel, f, xi), got, rtol=0, atol=0)


def test_mgmc_steps_with_the_reach2_subtree_equal_steps_without(samplers64):
    """Two MGMC steps (level 0 13-point and fused, the subtree below) against
    the same steps with the composed recursion, on the same normals."""
    sub, composed = samplers64[True], samplers64[False]
    assert sub.subtree is not None and sub.distilled is None and sub.fused_levels[0].reach == 2
    rng = np.random.default_rng(6)
    f = tt(rng.normal(size=sub.op.vshape))
    x0 = tt(rng.normal(size=(3,) + sub.op.vshape))
    noise = RecordingNoise(7)
    got = x0.clone()
    for _ in range(2):
        got = sub.apply(noise, f, got)
    replay = ReplayNoise(noise.record)
    want = x0.clone()
    for _ in range(2):
        want = composed.apply(replay, f, want)
    assert replay.exhausted
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


def test_the_reach2_build_is_a_library_of_its_own():
    """The reach-1 build is the source without flags, as before; the reach-2
    build three libraries of ``-DVISIT_REACH=2``, one instance each (production,
    stamps, 1024 threads), all in the parallel build; a launch's library by
    its stamps and block size."""
    assert common.SUBTREE_REACH2_FLAGS == ("-DVISIT_REACH=2",)
    parts = common.SUBTREE_REACH2_PARTS
    assert parts == {"production": ("-DVISIT_REACH=2",),
                     "stamps": ("-DVISIT_REACH=2", "-DSUBTREE_PART=1"),
                     "block1024": ("-DVISIT_REACH=2", "-DSUBTREE_PART=2")}
    assert all(("mgmc_subtree", flags) in common.BUILDS for flags in parts.values())
    assert "mgmc_subtree" in common.SOURCES  # the reach-1 build: the source, no flags
    paths = {common.library_path("mgmc_subtree", flags) for flags in parts.values()}
    assert len(paths) == 3 and common.library_path("mgmc_subtree") not in paths
    assert st.REACH_BUILDS == {1: (mv.VisitParams, {"production": ()}),
                               2: (mv.WideVisitParams, parts)}
    with pytest.raises(ValueError, match="reach-1 and a reach-2 build"):
        st.load_library(3)
    with pytest.raises(ValueError, match="libraries"):
        st.load_library(1, "stamps")  # the reach-1 library holds every instance
    with pytest.raises(ValueError, match="at most 512 threads"):
        st.launch_library(2, True, 1024)
    src = common.source_path("mgmc_subtree").read_text()
    branch = src[src.index("#if VISIT_REACH == 2\n#define MAX_OFFSETS"):]
    assert f"#define MAX_OFFSETS {mv.WIDE_MAX_OFFSETS}" in branch
    assert f"#define MAX_COLORS {mv.WIDE_MAX_COLORS}" in branch
    assert re.search(rf"#define SUBTREE_THREADS {st.REACH2_MAX_THREADS}\b", src)


def _struct_fields(src, name):
    """The field names of ``struct name`` in a CUDA source, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        type_and_first, *rest = decl.split(",")
        names.append(re.sub(r"\[.*", "", type_and_first.split()[-1]).lstrip("*"))
        names += [re.sub(r"\[.*", "", r.strip()) for r in rest]
    return names


def test_wide_mirrors_against_the_source():
    """``SubLevel`` and ``SubtreeParams`` are one layout in both builds (the
    parameter blocks lie in the tables, not in them): their field names follow
    the source's; the tables of a reach-2 kernel hold ``WideVisitParams``
    (25 offsets, 9 colours: 1,552 B against 1,296 B)."""
    src = common.source_path("mgmc_subtree").read_text()
    assert [n for n, _ in st.SubLevel._fields_] == _struct_fields(src, "SubLevel")
    assert [n for n, _ in st.SubtreeParams._fields_] == _struct_fields(src, "SubtreeParams")
    assert [n for n, _ in st.FieldLoc._fields_] == _struct_fields(src, "FieldLoc")
    # a sub-level's reach-2 point lists: 2 int64 offsets, 2 heads, form, band
    assert (ctypes.sizeof(st.FieldLoc), ctypes.sizeof(st.SubLevel)) == (16, 152)
    assert ctypes.sizeof(st.SubtreeParams) == 56 + 8 * 152 + 3 * 16 + 16 + 16
    assert st.SubtreeParams.lv.offset == 56 and st.SubtreeParams.stamps.offset == 1336
    assert (ctypes.sizeof(mv.VisitParams), ctypes.sizeof(mv.WideVisitParams)) == (1296, 1552)
    for name in ("dy", "dx", "coeff_const", "coeff_val"):
        assert getattr(mv.WideVisitParams, name).size == 4 * mv.WIDE_MAX_OFFSETS


def decode_plans(kernel):
    """Per level the two parameter blocks as the kernel reads them from its tables."""
    P = st.REACH_BUILDS[kernel.reach][0]
    size = ctypes.sizeof(P) // 4
    return [[P.from_buffer_copy(kernel._tables[o:o + size].tobytes()) for o in off["plan"]]
            for off in kernel._table_offsets]


def test_launch_tables_at_25_offsets_and_9_colours(small):
    """The reach-2 tables: 25-offset parameter blocks in raster order, 9
    colours in each sweep's order, 9 x 19 words of colour rows per direction
    equal to ``colour_rows``, B, both Y and W as the level holds them."""
    lv, off = small.levels[0], small._table_offsets[0]
    plans = decode_plans(small)[0]
    words, floats = small._tables, small._tables.view(np.float32)
    for d, (P, order) in enumerate(zip(plans, (lv.pre_order, lv.post_order))):
        assert (P.K, P.n_colors, P.n_order) == (25, 9, 9)
        assert [(P.dy[k], P.dx[k]) for k in range(25)] == [(k // 5 - 2, k % 5 - 2)
                                                            for k in range(25)]
        assert tuple(P.order[:9]) == tuple(order)
        assert mv.stencil_form(lv.op.offsets, lv.const_coeffs) in (8, 9)
        rows = words[off["rows"][d]:off["rows"][d] + 9 * 19].reshape(9, 19)
        np.testing.assert_array_equal(rows, mv.colour_rows(P))
        assert (rows[:, 0] >= 1).all()  # every colour holds points of some row
        m = P.m
        Y, W, ybox = lv._woodbury[tuple(order)]
        yoff = words[off["yoff"][d]:off["yoff"][d] + m + 1]
        yval = floats[off["yval"][d]:off["yval"][d] + yoff[-1]]
        Yn = Y.numpy().astype(np.float32)
        for k in range(m):
            i0, i1, j0, j1 = ybox[k]
            np.testing.assert_array_equal(yval[yoff[k]:yoff[k + 1]],
                                          Yn[k, i0:i1, j0:j1].reshape(-1))
            assert tuple(P.ybox[k]) == tuple(ybox[k])
        np.testing.assert_array_equal(floats[off["wm"][d]:off["wm"][d] + m * m],
                                      W.numpy().astype(np.float32).reshape(-1))
    boff = words[off["boff"]:off["boff"] + lv.op.m_lowrank + 1]
    Bn = lv.B.numpy().astype(np.float32)
    for k, (i0, i1, j0, j1) in enumerate(lv.bbox):
        np.testing.assert_array_equal(floats[off["bval"] + boff[k]:off["bval"] + boff[k + 1]],
                                      Bn[k, i0:i1, j0:j1].reshape(-1))
    assert small._tables.size % 4 == 0


def test_barrier_count_at_nine_colours(small):
    """A 9-colour descend passes 1 + 9 + 2 + 2 barriers, an ascend 1 + 9 + 2,
    a coarse sample 2, the table copy 1: one sub-level of a W-cycle 1 + 2 * 14
    + 2 * 2 + 2 * 12 = 57; without noise the second descend has no rhs pass."""
    assert len(small.levels[0].pre_order) == 9 and small.levels[0].op.m_lowrank == 4
    assert st.barrier_count(small) == 57
    assert st.barrier_count(small, noise=False) == 56


def test_place_fields_under_the_larger_tables():
    """The biharmonic bench's subtree (sub-levels 127^2, 63^2, 31^2 at 25
    points, 9 colours, 8 measurements; coarse 15^2): 62,352 B of tables (61,904
    and, per level and direction, the 19 words of its point lists' head), 512
    threads bound (256 launched, two blocks an SM); under the H100's limit the
    fields of 63^2 and below lie in shared memory beside them, 127^2's x and f
    are the launch's tensors; the static reserve holds; under a budget of 0
    every field is in the workspace."""
    kernel = bench_biharmonic_subtree()
    assert kernel.reach == 2 and st.REACH2_MAX_THREADS == 512
    assert kernel.threads == st.REACH2_THREADS == 256
    assert [lv.op.vshape for lv in kernel.levels] == [(127, 127), (63, 63), (31, 31)]
    assert [lv.coloring.n_colors for lv in kernel.levels] == [9, 9, 9]
    table_bytes = 4 * kernel._tables.size
    assert table_bytes == 61904 + 4 * 3 * 2 * (10 + 9) - 8  # (4-word padding)
    budget = st.field_budget(H100_BLOCK_LIMIT, kernel._tables.size)
    assert budget == H100_BLOCK_LIMIT - st.STATIC_SMEM_RESERVE - table_bytes
    levels, coarse, smem, ws = st.place_fields(kernel.level_sizes, kernel.nc, budget)
    assert [loc[0] for loc in coarse] == [st.LOC_SHARED] * 3
    assert [[loc[0] for loc in lv] for lv in levels] == [
        [st.LOC_LAUNCH, st.LOC_WORKSPACE, st.LOC_LAUNCH]] + [[st.LOC_SHARED] * 3] * 2
    assert smem == 3 * (63 * 63 + 31 * 31 + 15 * 15) and ws == 127 * 127
    assert table_bytes + 4 * smem + st.STATIC_SMEM_RESERVE <= H100_BLOCK_LIMIT
    levels, coarse, smem, ws = st.place_fields(kernel.level_sizes, kernel.nc, 0)
    assert smem == 0 and ws == 127 * 127 + 3 * (63 * 63 + 31 * 31 + 15 * 15)

