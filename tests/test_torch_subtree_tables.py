"""The subtree kernel's launch tables and its one-pass low-rank terms, on the CPU.

The kernel (``csrc/mgmc_subtree.cu`` with ``csrc/level_passes.cuh``) copies
per sub-level the visit parameter blocks, ``B`` and both directions' ``Y``
inside their bounding boxes, ``W`` and ``Sigma^1/2`` into
shared memory once per launch (:func:`launch_tables`), and does each low-rank
term in one pass: the thread that owns a point adds the columns whose box
holds it, in column order, and ``B^T x`` is one warp per column.  Here:

* the tables, decoded from the words the kernel receives, against the
  levels' ``B``, ``_woodbury`` and boxes, on the flagship's sub-levels, on a
  3-level 64x64 case built from the JAX package's operator and on a 4-level
  64x64 case whose levels the caller gives (5-point stencils, not the 3x3 box);
* a replay of the kernel's per-point order (rows, the columns that the boxes
  span in a row, the columns holding a point in column order) reading the
  staged values: bitwise equal to the column-after-column loops for the
  residual term (and a term added over B's boxes) and the Woodbury correction
  (float32, as on the card);
  the warp-per-column ``B^T x`` (lanes along the box, a shuffle tree) within
  ``1e-12`` of the plain sum in float64;
* the sweep over each colour's rows with the stencil's terms in offset order,
  as the kernel runs it on levels that are not the 3x3 box, against the plain
  sweep;
* the host's shared-memory layout: the flagship's 63^2 level and below in
  shared memory beside the tables, two blocks per SM under the card's limit,
  a budget of 0 placing every field in the workspace, and the tables at the
  most low-rank columns and sub-levels the kernel takes within the card's limit;
* the barriers of a launch counted from the source, and the breakdown of a
  launch by operation from the timer stamps.
"""

import ctypes

import numpy as np
import pytest
import torch

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
from multigridmc_tpu_torch.ops.kernels.mgmc_visit import VisitParams
from multigridmc_tpu_torch.ops.stencil import shift
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.smoothers import sor_sweep
from multigridmc_tpu_torch.solvers.multigrid import MultigridHierarchy

from test_torch_common import CPU, jax_operator, to_port

#: an H100 SM's shared memory, and what the card keeps of it per block
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024
H100_BLOCK_LIMIT = 232448


def posterior(nx, n_meas, seed, near_exact=True):
    """Shifted-Laplace prior on an nx x nx lattice (Lambda = 0.2) plus
    ``n_meas`` point measurements drawn from ``seed``, float32."""
    prior = shiftedlaplace_fd(Lattice((nx, nx)), ConstantCorrelationLengthModel(0.2),
                              device=CPU, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    locations = rng.uniform(0.1, 0.9, size=(n_meas, 2))
    mean = rng.normal(2.0, 1.0, size=n_meas)
    u = rng.uniform(size=n_meas)
    var = 1e-6 * (1.0 + u) if near_exact else 0.5 + u
    return measured_operator(prior, MeasurementParameters(
        measurement_locations=locations, mean=mean, variance=var))


def flagship_subtree():
    """The flagship's subtree (``bench.py::build_problem``: 256x256, Lambda =
    0.2, 8 near-exact measurements, seed 20260816, 5 levels, W-cycle), float32."""
    return MultigridMCSampler(posterior(256, 8, 20260816), 5, cycle=2, subtree=True)


def small_subtree():
    """A 3-level 64x64 posterior (4 measurements) from the JAX package's operator."""
    op = to_port(jax_operator(64, True), dtype=torch.float32)
    return MultigridMCSampler(op, 3, cycle=2, subtree=True)


def five_point_subtree():
    """A 4-level 64x64 posterior (4 measurements, O(1) variances) with levels
    the caller gives: the posterior discretised anew on each level's lattice,
    so every sub-level has the prior's 5-point stencil and a red-black
    colouring."""
    ops = [posterior(64 >> level, 4, 7, near_exact=False) for level in range(4)]
    return MultigridMCSampler(ops[0], 4, cycle=2, subtree=True,
                              hierarchy=MultigridHierarchy(ops[0], 4, operators=ops))


BUILDERS = {"flagship": flagship_subtree, "64x64_3_levels": small_subtree,
            "64x64_5_point": five_point_subtree}


@pytest.fixture(scope="module", params=list(BUILDERS))
def sampler(request):
    return BUILDERS[request.param]()


@pytest.fixture(scope="module", params=["flagship", "64x64_3_levels"])
def galerkin_sampler(request):
    return BUILDERS[request.param]()


def decode(kernel):
    """The staged tables as the kernel reads them: per level and direction the
    parameter block and, per column, the staged B and Y boxes."""
    words = kernel._tables
    floats = words.view(np.float32)
    size = ctypes.sizeof(VisitParams) // 4
    out = []
    for lv, off in zip(kernel.levels, kernel._table_offsets):
        m = lv.op.m_lowrank
        plans = [VisitParams.from_buffer_copy(words[o:o + size].tobytes()) for o in off["plan"]]
        boff = words[off["boff"]:off["boff"] + m + 1]
        level = {"plans": plans, "bval": floats[off["bval"]:off["bval"] + boff[-1]], "boff": boff,
                 "yval": [], "yoff": [], "wm": [],
                 "sroot": floats[off["sroot"]:off["sroot"] + m]}
        for d in range(2):
            yoff = words[off["yoff"][d]:off["yoff"][d] + m + 1]
            level["yoff"].append(yoff)
            level["yval"].append(floats[off["yval"][d]:off["yval"][d] + yoff[-1]])
            level["wm"].append(floats[off["wm"][d]:off["wm"][d] + m * m].reshape(m, m))
        out.append(level)
    return out


def boxes(P, which):
    return [tuple(getattr(P, which)[k]) for k in range(P.m)]


def test_tables_against_the_levels(sampler):
    kernel = sampler.subtree
    assert kernel._tables.dtype == np.int32 and kernel._tables.size % 4 == 0
    for lv, tab in zip(kernel.levels, decode(kernel)):
        m = lv.op.m_lowrank
        assert m == 8 if kernel.vshape == (127, 127) else m == 4
        for d, order in enumerate((lv.pre_order, lv.post_order)):
            P = tab["plans"][d]
            assert (P.H, P.W, P.m) == (*lv.op.vshape, m)
            assert tuple(P.order[:P.n_order]) == order
            Y, W, ybox = lv._woodbury[order]
            assert boxes(P, "bbox") == list(lv.bbox) and boxes(P, "ybox") == list(ybox)
            for k, (i0, i1, j0, j1) in enumerate(ybox):
                staged = tab["yval"][d][tab["yoff"][d][k]:tab["yoff"][d][k + 1]]
                assert np.array_equal(staged, Y[k, i0:i1, j0:j1].numpy().reshape(-1))
                # nothing of Y_k lies outside its box
                outside = Y[k].clone()
                outside[i0:i1, j0:j1] = 0
                assert not outside.any()
            assert np.array_equal(tab["wm"][d], W.numpy())
        # the two directions' factors differ: neither may stand in for the other
        assert not np.array_equal(tab["yval"][0], tab["yval"][1])
        for k, (i0, i1, j0, j1) in enumerate(lv.bbox):
            staged = tab["bval"][tab["boff"][k]:tab["boff"][k + 1]]
            assert np.array_equal(staged, lv.B[k, i0:i1, j0:j1].numpy().reshape(-1))
        # Sigma^1/2 alone: no Gram matrix, no 1 / Sigma, no Sigma^-1/2
        assert np.array_equal(tab["sroot"], lv.sigma_sqrt.numpy())
        # and the reach-2 point lists' places, none at reach 1
        assert set(kernel._table_offsets[0]) == {"plan", "rows", "yval", "yoff", "wm", "bval",
                                                 "boff", "sroot", "pts", "phead"}
        assert kernel._table_offsets[0]["pts"] == [-1, -1] and kernel._points.size == 0
    # the warps' slots after the levels' tables, inside the staged words
    assert kernel._warp_stride == max(lv.op.m_lowrank for lv in kernel.levels)
    assert kernel._warp_vec + 32 * kernel._warp_stride <= kernel._tables.size


def test_colour_rows_cover_each_colour_once(sampler):
    """The sweep's rows of each colour (the kernel's warps take them in turn):
    every point of the colour once, in both directions' orders."""
    kernel = sampler.subtree
    words = kernel._tables
    for lv, off, tab in zip(kernel.levels, kernel._table_offsets, decode(kernel)):
        H, W = lv.op.vshape
        masks = lv.masks.numpy()
        for d, P in enumerate(tab["plans"]):
            K, s = P.n_colors, P.jstride
            rows = words[off["rows"][d]:off["rows"][d] + P.n_order * (1 + 2 * K)].reshape(
                P.n_order, 1 + 2 * K)
            assert np.array_equal(rows, st.colour_rows(P))
            for o in range(P.n_order):
                R = rows[o, 0]
                got = np.zeros((H, W), int)
                for r in range(R * (H // K + 1)):  # the kernel's r = warp, warp + nwarps, ...
                    i = (r // R) * K + rows[o, 1 + 2 * (r % R)]
                    if i >= H:
                        break
                    got[i, rows[o, 2 + 2 * (r % R)]::s] += 1
                assert np.array_equal(got, masks[P.order[o]].astype(int)), (d, o)
            # each colour lies on every other row of the 4-colour Galerkin
            # levels, on every row under red-black
            assert all(rows[o, 0] == (K // 2 if K == 4 else K) for o in range(P.n_order))


# ------------------------------------------------ the kernel's order, replayed
def row_span(box, i):
    spans = [(j0, j1) for i0, i1, j0, j1 in box if i0 <= i < i1]
    return (min(s[0] for s in spans), max(s[1] for s in spans)) if spans else (1 << 30, 0)


def add_columns_replay(box, val, off, coef, sign, dst):
    """``add_columns`` of ``level_passes.cuh`` for every point, one row after
    the other: each point's columns in column order, in float32."""
    out = dst.copy()
    H, W = dst.shape
    sign = np.float32(sign)
    for i in range(H):
        lo, hi = row_span(box, i)
        for j in range(lo, min(hi, W)):
            v = out[i, j]
            for k, (i0, i1, j0, j1) in enumerate(box):
                if i0 <= i < i1 and j0 <= j < j1:
                    v = v + (sign * coef[k]) * val[off[k] + (i - i0) * (j1 - j0) + (j - j0)]
            out[i, j] = v
    return out


def column_after_column(box, fields, coef, sign, dst):
    """One column after the other over its box (the loops the kernels ran
    before each low-rank term was one pass)."""
    out = torch.as_tensor(dst.copy())
    for k, (i0, i1, j0, j1) in enumerate(box):
        out[i0:i1, j0:j1] += sign * torch.tensor(coef[k]) * fields[k, i0:i1, j0:j1]
    return out.numpy()


def test_one_pass_lowrank_terms_equal_the_column_loops_bitwise(sampler):
    kernel = sampler.subtree
    rng = np.random.default_rng(3)
    overlap = 0
    for lv, tab in zip(kernel.levels, decode(kernel)):
        m = lv.op.m_lowrank
        dst = rng.normal(size=lv.op.vshape).astype(np.float32)
        coef = rng.normal(size=m).astype(np.float32)
        # a term added over B's boxes (+) and the residual term (- t B)
        for sign in (1.0, -1.0):
            got = add_columns_replay(lv.bbox, tab["bval"], tab["boff"], coef, sign, dst)
            want = column_after_column(lv.bbox, lv.B, coef, sign, dst)
            assert np.array_equal(got, want)
        # the Woodbury correction x -= u Y over Y's boxes, each direction with its own
        for d, order in enumerate((lv.pre_order, lv.post_order)):
            Y, _, ybox = lv._woodbury[order]
            got = add_columns_replay(ybox, tab["yval"][d], tab["yoff"][d], coef, -1.0, dst)
            want = column_after_column(ybox, Y, coef, -1.0, dst)
            assert np.array_equal(got, want)
            assert not np.array_equal(got, dst)
        for order in (lv.pre_order, lv.post_order):
            cover = np.zeros(lv.op.vshape, int)
            for i0, i1, j0, j1 in lv._woodbury[order][2]:
                cover[i0:i1, j0:j1] += 1
            overlap = max(overlap, cover.max())
    # overlapping boxes, where one owner per point matters, occur on the flagship
    assert overlap >= 2 or kernel.vshape != (127, 127)


def btx_replay(box, val, off, x):
    """``btx_pass``: column k's box points strided over 32 lanes, then the
    shuffle-down tree; lane 0's value."""
    out = []
    for k, (i0, i1, j0, j1) in enumerate(box):
        bw, area = j1 - j0, (i1 - i0) * (j1 - j0)
        lanes = np.zeros(32)
        for q in range(area):
            lanes[q % 32] += x[i0 + q // bw, j0 + q % bw] * val[off[k] + q]
        for o in (16, 8, 4, 2, 1):
            lanes[:o] = lanes[:o] + lanes[o:2 * o]
        out.append(lanes[0])
    return np.array(out)


def test_warp_per_column_btx_matches_the_plain_sum(sampler):
    kernel = sampler.subtree
    rng = np.random.default_rng(4)
    for lv, tab in zip(kernel.levels, decode(kernel)):
        x = rng.normal(size=lv.op.vshape)
        got = btx_replay(lv.bbox, tab["bval"].astype(np.float64), tab["boff"], x)
        B = lv.B.double()
        want = (B * torch.as_tensor(x)).reshape(B.shape[0], -1).sum(dim=1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def stencil_box9_replay(P, coeffs, x):
    """The stencil in registers of ``level_passes.cuh`` on the 3x3 box, on a
    whole field: the nine raster offsets in order, a neighbour outside the
    field skipped, the coefficient a constant unless its plane varies."""
    H, W = x.shape
    ax = np.zeros((H, W))
    for k in range(9):
        dy, dx = k // 3 - 1, k % 3 - 1
        i0, i1, j0, j1 = max(0, -dy), H - max(0, dy), max(0, -dx), W - max(0, dx)
        c = coeffs[k, i0:i1, j0:j1] if not P.coeff_const[k] else np.float64(P.coeff_val[k])
        ax[i0:i1, j0:j1] += c * x[i0 + dy:i1 + dy, j0 + dx:j1 + dx]
    return ax


def test_levels_take_the_register_stencil(galerkin_sampler):
    """Every sub-level of both Galerkin cases is the 3x3 box in raster order,
    which the kernel's sweep and residual hold in registers in its 9-offset
    form; its replay is the level's own stencil."""
    kernel = galerkin_sampler.subtree
    rng = np.random.default_rng(6)
    for lv, tab in zip(kernel.levels, decode(kernel)):
        for P in tab["plans"]:
            assert P.K == 9
            assert [(P.dy[k], P.dx[k]) for k in range(9)] == [
                (k // 3 - 1, k % 3 - 1) for k in range(9)]
            assert P.diag_index == 4
        x = rng.normal(size=lv.op.vshape)
        got = stencil_box9_replay(tab["plans"][0], lv.coeffs.double().numpy(), x)
        # the level's stencil as the port's operator applies it, in float64
        want = sum(c.double() * shift(torch.as_tensor(x), off)
                   for c, off in zip(lv.coeffs, lv.op.offsets)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def box9_on(P):
    """Whether the stencil is the raster 3x3 box."""
    return P.K == 9 and all((P.dy[k], P.dx[k]) == (k // 3 - 1, k % 3 - 1) for k in range(9))


def colour_sweep_replay(P, rows, coeffs, c, x):
    """``sweep_colours`` of ``level_passes.cuh``: per colour phase the points
    of the rows ``colour_rows`` names, each updated from the field as the
    phase found it (no point of a colour reads another), the stencil's terms
    in offset order as ``stencil_at`` adds them."""
    H, W = x.shape
    K, s = P.n_colors, P.jstride
    x = x.copy()
    coef = [np.full((H, W), np.float64(P.coeff_val[k])) if P.coeff_const[k]
            else coeffs[k] for k in range(P.K)]
    for o in range(P.n_order):
        R = rows[o, 0]
        pts = [((q * K + rows[o, 1 + 2 * t]), j) for q in range(H // K + 1) for t in range(R)
               for j in range(rows[o, 2 + 2 * t], W, s) if q * K + rows[o, 1 + 2 * t] < H]
        new = {}
        for i, j in pts:
            ax = 0.0
            for k in range(P.K):
                ii, jj = i + P.dy[k], j + P.dx[k]
                if 0 <= ii < H and 0 <= jj < W:
                    ax += coef[k][i, j] * x[ii, jj]
            new[i, j] = x[i, j] + P.omega * (c[i, j] - ax) / coef[P.diag_index][i, j]
        for (i, j), v in new.items():
            x[i, j] = v
    return x


def test_other_stencils_take_the_generic_sweep_over_the_colour_rows():
    """The caller's 5-point levels are not the 3x3 box; the kernel's sweep
    holds their stencil in registers too (its 5-offset form) and runs over the
    same colour rows; the replay of that sweep in both directions is the plain
    sweep (float64)."""
    kernel = five_point_subtree().subtree
    rng = np.random.default_rng(8)
    for lv, off in zip(kernel.levels, kernel._table_offsets):
        assert len(lv.op.offsets) == 5
        coeffs = lv.coeffs.double().numpy()
        for d, order in enumerate((lv.pre_order, lv.post_order)):
            P = lv._build_params(1, order, True, 0)
            assert not box9_on(P) and P.K == 5
            rows = kernel._tables[off["rows"][d]:off["rows"][d] + P.n_order * (1 + 2 * P.n_colors)]
            rows = rows.reshape(P.n_order, 1 + 2 * P.n_colors)
            c, x = rng.normal(size=(2,) + lv.op.vshape)
            got = colour_sweep_replay(P, rows, coeffs, c, x)
            want = sor_sweep(lv.op.to(CPU, torch.float64), lv.masks.double(), lv.omega, order,
                             torch.as_tensor(c), torch.as_tensor(x)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
            assert not np.allclose(got, x)


# ----------------------------------------------------------- the host's layout
def test_flagship_layout_fits_two_blocks_per_sm():
    kernel = flagship_subtree().subtree
    words = kernel._tables.size
    levels, coarse, smem, ws = st.place_fields(kernel.level_sizes, kernel.nc,
                                               st.field_budget(H100_BLOCK_LIMIT, words))
    # 63^2, 31^2, 15^2 in shared memory as before the tables came (61,860 bytes)
    assert 4 * smem == 61860 and ws == 127 * 127
    assert [loc[0] for loc in levels[0]] == [st.LOC_LAUNCH, st.LOC_WORKSPACE, st.LOC_LAUNCH]
    assert all(loc[0] == st.LOC_SHARED for lv in levels[1:] for loc in lv)
    dynamic = 4 * (words + smem)
    per_block = dynamic + st.STATIC_SMEM_RESERVE + BLOCK_RESERVED_BYTES
    assert 2 * per_block <= SM_SHARED_BYTES, (dynamic, per_block)
    # the tables: 6 parameter blocks and the staged boxes, some 20 KB
    assert 6 * ctypes.sizeof(VisitParams) < 4 * words < 24 * 1024


def test_budget_zero_puts_every_field_in_the_workspace(sampler):
    ops = sampler.hierarchy.operators[1:]
    nl = len(sampler.subtree.levels)
    flat = st.SubtreeKernel(ops, [p.smoother for p in sampler.presamplers[1:nl + 1]],
                            [p.smoother for p in sampler.postsamplers[1:nl + 1]],
                            sampler.coarse_sampler.L, 1.0, 2, 1.0, smem_budget=0)
    placement = flat.placement
    assert placement["shared_bytes"] == 0
    assert placement["dynamic_shared_bytes"] == placement["table_bytes"] == 4 * flat._tables.size
    assert all(row[name] in ("workspace", "launch tensor")
               for row in placement["levels"] for name in ("x", "scratch", "f"))
    S = flat._build_params(2, 0, False)
    assert S.lv[0].x.where == st.LOC_LAUNCH and S.cx.where == st.LOC_WORKSPACE
    # the same tables as with fields in shared memory
    assert np.array_equal(flat._tables, sampler.subtree._tables)


def test_tables_fit_the_card_at_the_most_lowrank_columns():
    """The tables stay in shared memory whatever the fields' placement: at m =
    32 (the most the kernel takes) and 8 sub-levels (a 1024^2 lattice of 10
    levels) they and the kernel's static share fit a block of the H100, and on
    the CPU, where nothing is launched, such a hierarchy builds and samples."""
    kernel = MultigridMCSampler(posterior(1024, 32, 11), 10, cycle=2, subtree=True).subtree
    assert len(kernel.levels) == st.MAX_SUB_LEVELS
    assert all(lv.op.m_lowrank == 32 for lv in kernel.levels)
    table_bytes = kernel.placement["table_bytes"]
    assert table_bytes + st.STATIC_SMEM_RESERVE <= H100_BLOCK_LIMIT, table_bytes
    # more than the CPU's nominal 48 KB (three sub-levels), and the plain
    # version runs all the same
    small = MultigridMCSampler(posterior(64, 32, 12), 5, cycle=2, subtree=True).subtree
    assert small.placement["table_bytes"] > 48 * 1024
    f = torch.randn((2,) + small.vshape, generator=torch.Generator().manual_seed(0))
    x = st.subtree_sample(small, f, xi=torch.randn(2, small.count_noise()))
    assert x.shape == f.shape and torch.isfinite(x).all()


def test_barrier_count_from_the_source(sampler):
    """The barriers of a launch as ``level_passes.cuh`` places them: the
    table copy, a descend n_order + 5, an ascend n_order + 3, a coarse sample
    2.  The flagship's three 4-colour sub-levels: 1 + 14 * 9 + 14 * 7 + 8 * 2;
    one 4-colour sub-level: 1 + 2 * 9 + 2 * 7 + 2 * 2; two red-black ones: 1 +
    6 * 7 + 6 * 5 + 4 * 2.  Without noise a descend that does not zero x has
    no rhs pass."""
    kernel = sampler.subtree
    want = {"flagship": 241, "64x64_3_levels": 37, "64x64_5_point": 81}
    n_colours = len(kernel.levels[0].pre_order)
    name = ("flagship" if kernel.vshape == (127, 127) else
            "64x64_3_levels" if n_colours == 4 else "64x64_5_point")
    assert st.barrier_count(kernel) == want[name]
    plain_descends = sum(op == st.OP_DESCEND for op, _ in kernel.schedule)
    assert st.barrier_count(kernel, noise=False) == want[name] - plain_descends


def test_stamps_are_for_the_card_only():
    kernel = small_subtree().subtree
    f = torch.zeros((2,) + kernel.vshape)
    stamps = torch.zeros((2, len(kernel.schedule) + 1 + st.STAMP_EXTRA), dtype=torch.int64)
    with pytest.raises(ValueError, match="stamps exist in the CUDA kernel only"):
        st.subtree_sample(kernel, f, stamps=stamps)


def test_operation_times_from_stamps():
    kernel = small_subtree().subtree
    n = len(kernel.schedule)
    # block b spends (s + 1) * (b + 1) us on operation s, after a start at 5 us;
    # it enters 2 us before its first stamp and leaves 1 us after its last;
    # blocks 0 and 2 share SM 7, block 1 runs alone on SM 3
    steps = np.array([[(s + 1) * (b + 1) * 1000 for s in range(n)] for b in range(3)])
    times = np.concatenate([np.full((3, 1), 5000), 5000 + np.cumsum(steps, axis=1)], axis=1)
    extra = np.stack([times[:, 0] - 2000, times[:, -1] + 1000, [241, 241, 241], [7, 3, 7]], 1)
    stamps = torch.as_tensor(np.concatenate([times, extra], axis=1), dtype=torch.int64)
    out = st.operation_times(kernel, stamps)
    med = [(s + 1) * 2.0 for s in range(n)]  # the median block is b = 1
    assert out["table_copy_us"] == pytest.approx(2.0)
    assert out["copy_out_us"] == pytest.approx(1.0)
    assert out["sum_us"] == pytest.approx(sum(med) + 3.0)
    assert out["block_span_us"] == pytest.approx(sum(med) + 3.0)
    assert out["slowest_block_us"] == pytest.approx(sum((s + 1) * 3.0 for s in range(n)) + 3.0)
    assert out["launch_span_us"] == pytest.approx(sum((s + 1) * 3.0 for s in range(n)) + 3.0)
    assert out["start_skew_us"] == 0.0
    assert out["barriers_per_block"] == [241]
    assert out["blocks_per_sm"] == 2 and out["sms"] == 2
    share = out["block_span_by_sm_share_us"]
    assert set(share) == {"1", "2"} and share["1"]["sms"] == share["2"]["sms"] == 1
    assert share["1"]["median_by_rank"] == pytest.approx([sum(med) + 3.0])
    assert share["2"]["median_by_rank"] == pytest.approx(
        [sum(med) / 2 + 3.0, sum(med) * 3 / 2 + 3.0])
    ops = out["operations"]
    assert set(ops) == {"descend 31x31", "ascend 31x31", "coarse 15x15"}
    assert sum(v["count"] for v in ops.values()) == n
    coarse = [med[s] for s, (op, _) in enumerate(kernel.schedule) if op == st.OP_COARSE]
    assert ops["coarse 15x15"]["total_us"] == pytest.approx(sum(coarse))
    assert ops["coarse 15x15"]["median_us"] == pytest.approx(np.median(coarse))
