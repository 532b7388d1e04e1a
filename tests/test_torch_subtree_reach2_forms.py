"""The subtree kernel's reach-2 build redesigned: per sub-level its stencil
form, found once by the host, and its sweeps from the colours' point lists,
on the CPU.

* the form of each sub-level in the launch's parameter block against
  ``mgmc_visit.stencil_form`` (the phase kernels' forms);
* the point lists (``mgmc_subtree.point_tables``) of both directions on the
  biharmonic bench's sub-levels (127^2, 63^2, 31^2 at 25 points, 9 colours):
  every point of each colour once, the interior points first with the
  interior values that the staged parameter blocks hold as ``coeff_val``
  (every point but the edge), the heads in the staged tables;
* a float64 replay of the sweep from the point lists (``sweep_points`` of
  ``csrc/level_passes.cuh``) against the plain directed sweep (``1e-12``);
* two blocks of 256 threads an SM at reach 2 (the placement's limit);
* the per-pass stamps' names: one per barrier, as ``barrier_count`` counts.

The kernel runs on the card only; ``chip_smoke.py`` holds it against its plain
version and its stamps against the source's barrier count there.
"""

import numpy as np
import pytest
import torch

from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

from test_torch_subtree_reach2 import bench_biharmonic_subtree, biharmonic

EXACT = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def bench():
    return bench_biharmonic_subtree()


@pytest.fixture(scope="module")
def small64():
    """A 64x64 biharmonic posterior's subtree in float64 (sub-levels 31^2 and
    15^2 at 25 points, coarse 7^2)."""
    return MultigridMCSampler(biharmonic(64, torch.float64), 4, cycle=2, subtree=True).subtree


def _plans(kernel):
    P = st.REACH_BUILDS[kernel.reach][0]
    size = __import__("ctypes").sizeof(P) // 4
    return [[P.from_buffer_copy(kernel._tables[o:o + size].tobytes()) for o in off["plan"]]
            for off in kernel._table_offsets]


def test_form_of_each_sub_level_is_the_phase_kernels(bench):
    """The host finds each sub-level's form once (``SubLevel.form``), as
    ``stencil_form`` finds the phase kernels'; the bench's are the box with
    planes."""
    S = bench._build_params(256, 1, False)
    for li, lv in enumerate(bench.levels):
        assert S.lv[li].form == mv.stencil_form(lv.op.offsets, lv.const_coeffs) == 9
        assert S.lv[li].form == lv.stencil_form


@pytest.mark.parametrize("li", [0, 1, 2])
def test_point_lists_of_the_bench(bench, li):
    """Per direction: each point of each colour once, colour after colour of
    the sweep's order; interior points first, whose every coefficient with its
    neighbour in the field equals the parameter block's coeff_val; every point
    off the edge is interior; the heads staged."""
    lv, off = bench.levels[li], bench._table_offsets[li]
    H, W = lv.op.vshape
    coeffs = lv.coeffs.numpy().reshape(len(lv.op.offsets), H * W)
    plans = _plans(bench)[li]
    for d, order in enumerate((lv.pre_order, lv.post_order)):
        pl = st.point_tables(lv, order)
        head = bench._tables[off["phead"][d]:off["phead"][d] + 2 * len(order) + 1]
        assert np.array_equal(head, pl["head"])
        start, plain = head[:len(order) + 1], head[len(order) + 1:]
        entries = bench._points[off["pts"][d]:off["pts"][d] + H * W].astype(np.int64)
        assert np.array_equal(entries, pl["entries"])
        i, j = entries >> 16, entries & 0xFFFF
        colour = (plans[d].w0 * i + plans[d].w1 * j) % plans[d].n_colors
        cval = np.array([plans[d].coeff_val[k] for k in range(plans[d].K)], np.float32)
        assert np.array_equal(cval, pl["cval"])
        for o, col in enumerate(order):
            part = slice(start[o], start[o + 1])
            assert (colour[part] == col).all()
            ip, jp = i[part][:plain[o]], j[part][:plain[o]]
            for k, (dy, dx) in enumerate(lv.op.offsets):
                inside = (ip + dy >= 0) & (ip + dy < H) & (jp + dx >= 0) & (jp + dx < W)
                assert (coeffs[k, (ip * W + jp)[inside]] == cval[k]).all()
            # every point off the field's edge is interior
            edge = np.minimum(np.minimum(i[part], H - 1 - i[part]),
                              np.minimum(j[part], W - 1 - j[part]))
            assert (np.flatnonzero(edge >= 1) < plain[o]).all()
        assert sorted((i * W + j).tolist()) == list(range(H * W))
        assert start[-1] == H * W


def _sweep_points(level, order, c, x):
    """``sweep_points`` replayed in float64 on one chain: the colours' points
    in list order, interior points with the interior values, the others with
    the planes, terms in offset order with out-of-field terms skipped."""
    pl = st.point_tables(level, order)
    op = level.op
    H, W = op.vshape
    coeffs = level.coeffs.numpy().reshape(len(op.offsets), H * W)
    cint = coeffs[:, (H // 2) * W + W // 2]
    x = x.copy().reshape(-1)
    head = pl["head"]
    start, plain = head[:len(order) + 1], head[len(order) + 1:]
    for o in range(len(order)):
        for t in range(start[o], start[o + 1]):
            e = int(pl["entries"][t])
            i, j = e >> 16, e & 0xFFFF
            coef = cint if t - start[o] < plain[o] else coeffs[:, i * W + j]
            ax = 0.0
            for k, (dy, dx) in enumerate(op.offsets):
                if 0 <= i + dy < H and 0 <= j + dx < W:
                    ax += coef[k] * x[(i + dy) * W + j + dx]
            x[i * W + j] += level.omega * (c[i, j] - ax) / coef[op.diag_index]
    return x.reshape(H, W)


def test_replay_of_the_point_sweep(small64):
    """On each float64 sub-level, both directions: the point-list sweep equals
    the plain directed sweep."""
    rng = np.random.default_rng(17)
    for lv in small64.levels:
        H, W = lv.op.vshape
        c, x = (rng.normal(size=(H, W)) for _ in range(2))
        masks = torch.as_tensor(lv.coloring.masks(), dtype=torch.float64)
        for order in (lv.pre_order, lv.post_order):
            want = ss.sweep_batched_plain(lv.op, masks, lv.omega, order, torch.as_tensor(c),
                                          torch.as_tensor(x))
            np.testing.assert_allclose(_sweep_points(lv, order, c, x), want.numpy(), **EXACT)


def test_two_blocks_an_sm_at_reach_2(bench):
    """A reach-2 launch takes two blocks of 256 threads an SM: its fields are
    placed under half an SM's shared memory (less the reserve a block), so on
    an H100 the bench's 31^2 and 15^2 fields lie in shared memory and 63^2's
    in the workspace; reach 1 keeps the block's whole grant."""
    limit = st.reach2_limit(232448)
    assert limit == mv.SM_SHARED_BYTES // 2 - mv.BLOCK_RESERVED_BYTES == 115712
    assert st.reach2_limit(48 * 1024) == 48 * 1024
    budget = st.field_budget(limit, bench._tables.size)
    levels, _, smem, ws = st.place_fields(bench.level_sizes, bench.nc, budget)
    assert [[loc[0] for loc in lv] for lv in levels] == [
        [st.LOC_LAUNCH, st.LOC_WORKSPACE, st.LOC_LAUNCH], [st.LOC_WORKSPACE] * 3,
        [st.LOC_SHARED] * 3]
    assert smem == 3 * (31 * 31 + 15 * 15) and ws == 127 * 127 + 3 * 63 * 63
    assert 2 * (4 * (bench._tables.size + smem) + st.STATIC_SMEM_RESERVE) <= mv.SM_SHARED_BYTES
    assert bench.threads == st.REACH2_THREADS == 256


def test_pass_names_follow_the_barriers(bench, small64):
    """One name per barrier of a launch (``barrier_count``), with noise and
    without; the stamps' width is that count and the entry."""
    for kernel in (bench, small64):
        for noise in (True, False):
            names = st.pass_names(kernel, noise)
            assert len(names) == st.barrier_count(kernel, noise)
            assert names[0] == (-1, "table copy")
        S = kernel._build_params(4, 1, False)
        assert S.pass_width == st.barrier_count(kernel) + 1
    s = next(s for s, (op, li) in enumerate(bench.schedule) if op == st.OP_ASCEND)
    ascend = [n for t, n in st.pass_names(bench) if t == s]
    assert ascend == ["prolongation and rhs"] + [f"colour {o}" for o in range(9)] + [
        "B^T x", "Woodbury"]
    stamps = np.zeros((3, st.barrier_count(bench) + 1), np.int64)
    stamps[:] = np.arange(stamps.shape[1]) * 1000  # 1 us a pass
    out = st.pass_times(bench, torch.as_tensor(stamps))
    assert out["descend 31x31"]["passes"]["colour 0"] == {"count": 8, "median_us": 1.0,
                                                         "total_us": 8.0}
    assert out["coarse 15x15"]["visit_us"] == 2.0
