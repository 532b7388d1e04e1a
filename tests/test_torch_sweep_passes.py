"""The one-block sweep kernels on the passes of ``csrc/level_passes.cuh``
(``csrc/sor_sweep_passes.cu``), their host side on the CPU.

The kernels cannot run here; ``chip_smoke.py`` holds them against their plain
versions and against the generic body of ``csrc/sor_sweep.cu`` on the card.
What they read and how they walk a field is checked here:

* the rows table the host builds for a sweep's order (``PassLaunch.rows``)
  gives each point of each colour to one lane once, forward and backward, on
  2- and 4-colour levels, and the rhs scratch packed by colour
  (``packed_index``) gives each point its own slot inside the scratch;
* a float64 replay of the kernels' schedule (the Gibbs rhs into the packed
  scratch group by group, then each colour's rows warp by warp, LANE_POINTS
  points a lane, the stencil's terms in offset order with out-of-field terms
  skipped) equals ``sweep_batched_plain`` / ``gibbs_sweep_batched_plain`` under
  the same ``xi`` and the JAX package's composed sweep to 1e-12;
* the body, the stencil form and the block size each launch takes;
* the barriers of a sweep, counted from the sources, and the stamps builds.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridmc_tpu.ops.coloring import coloring_for as jcoloring_for
from multigridmc_tpu.samplers.sor import SORSampler as JSORSampler
from multigridmc_tpu.smoothers import color_order as jcolor_order
from multigridmc_tpu.smoothers import sor_sweep as jsor_sweep

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
from multigridmc_tpu_torch.ops.coarsen import galerkin_coarsen
from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import SORSmoother

from test_torch_common import CPU, F64, assert_close, to_port, tt
from test_torch_sor_sweep import _inputs, _jax_operator

CSRC = Path(ss.__file__).resolve().parents[2] / "csrc"

#: the 2d stencils of reach 1 that the passes body takes: 2 colours (5-point,
#: constant and varying planes) and 4 colours (the 9-point Galerkin level)
KINDS = ["fd5pt", "galerkin9pt", "periodic5pt"]
DIRECTIONS = ["forward", "backward"]

#: points a lane has in flight in the sweep (``LANE_POINTS`` of level_passes.cuh)
LANE_POINTS = {(5, False): 4, (5, True): 2, (9, False): 2, (9, True): 1}


def plan_of(kind, direction, omega=1.3, dtype=torch.float64):
    return SORSmoother(to_port(_jax_operator(kind, jnp.float64), dtype), omega, 1,
                       direction).plan


def flagship_plans():
    """The flagship's 255^2 5-point level and its 127^2 Galerkin level, both
    directions, float32 as on the card."""
    fine = shiftedlaplace_fd(Lattice((256, 256)), ConstantCorrelationLengthModel(0.2),
                             device=CPU, dtype=torch.float32)
    return [SORSmoother(op, 1.0, 1, d).plan for op in (fine, galerkin_coarsen(fine))
            for d in DIRECTIONS]


def sweep_rows(P):
    """The rows table a launch of the passes body reads (``PassLaunch.rows``)."""
    return mv.colour_rows(ss.pass_params(P))


def packed_index(V, ci, i, j):
    """``packed_index`` of level_passes.cuh."""
    s = V.jstride
    return (ci * V.H + i) * -(-V.W // s) + j // s


def lane_points(V, rows, o, nwarps):
    """The points each (warp, lane) of a block of ``nwarps`` warps updates in
    colour ``o`` of the order, as ``sweep_colours`` walks them: the warps take
    the rows that hold the colour in turn, a lane the k-th points of its row
    k = lane, lane + 32 U, ...; with each point its slot in the packed rhs."""
    H, W, K, s = V.H, V.W, V.n_colors, V.jstride
    U = LANE_POINTS[(5 if V.K <= 5 else 9, any(not V.coeff_const[k] for k in range(V.K)))]
    cr = rows[o]
    R = cr[0]
    out = []
    for warp in range(nwarps):
        r = warp
        while R > 0:
            q, t = divmod(r, R)
            i = q * K + cr[1 + 2 * t]
            if i >= H:
                break
            jc = cr[2 + 2 * t]
            crow = packed_index(V, V.order[o], i, jc)
            for lane in range(32):
                k0 = lane
                while jc + s * k0 < W:
                    for u in range(U):
                        j = jc + s * (k0 + 32 * u)
                        if j < W:
                            out.append((warp, lane, i, j, crow + k0 + 32 * u))
                    k0 += 32 * U
            r += nwarps
    return out


# ----------------------------------------------------------- the rows table
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_rows_table_gives_each_point_of_each_colour_once(kind, direction):
    plan = plan_of(kind, direction)
    P = plan.params(3, True, 1, (1, 2))
    V = ss.pass_params(P)
    rows = sweep_rows(P)
    assert rows.dtype == np.int32 and rows.shape == (V.n_order, 1 + 2 * V.n_colors)
    np.testing.assert_array_equal(rows, plan.pass_launch(P).rows.numpy())
    masks = plan.masks.numpy()
    slots = V.n_colors * V.H * -(-V.W // V.jstride)
    assert slots == plan.pass_launch(P).scratch_floats()
    for nwarps in (8, 32):
        taken = np.zeros(slots, int)
        for o, colour in enumerate(plan.order):
            got = np.zeros(plan.op.vshape, int)
            for _, _, i, j, slot in lane_points(V, rows, o, nwarps):
                got[i, j] += 1
                # the packed slot the sweep reads is the one the rhs pass writes
                assert slot == packed_index(V, colour, i, j)
                taken[slot] += 1
            assert np.array_equal(got, masks[colour].astype(int)), (o, colour, nwarps)
        assert taken.max() == 1 and taken.sum() == plan.op.vshape[0] * plan.op.vshape[1]


@pytest.mark.parametrize("case", range(4))
def test_rows_table_on_the_flagship_levels(case):
    """255^2 red-black and the 127^2 Galerkin level's 4 colours, both
    directions: each colour in every row (2 colours) or every other row (4),
    its first column below the column stride, and a backward sweep the same
    table with its colours in reverse."""
    plan = flagship_plans()[case]
    P = plan.params(256, True, 0, None)
    V = ss.pass_params(P)
    rows = sweep_rows(P)
    K, s = V.n_colors, V.jstride
    assert (K, s) == ((2, 2) if plan.op.vshape == (255, 255) else (4, 2))
    for o in range(V.n_order):
        R = rows[o, 0]
        assert R == (K if K == 2 else K // 2)
        assert all(0 <= rows[o, 2 + 2 * t] < s for t in range(R))
    other = sweep_rows(SORSmoother(plan.op, 1.0, 1, "backward" if plan.order[0] == 0
                                      else "forward").plan.params(256, True, 0, None))
    np.testing.assert_array_equal(rows, other[::-1])
    masks = plan.masks.numpy()
    for o, colour in enumerate(plan.order):
        got = np.zeros(plan.op.vshape, int)
        for _, _, i, j, _ in lane_points(V, rows, o, 16):
            got[i, j] += 1
        assert np.array_equal(got, masks[colour].astype(int))


# ------------------------------------------------- a float64 replay of the schedule
def replay_rhs(V, f, ns, xi):
    """``rhs_packed``: c = f + ns xi group by group (four points of a row),
    each point into its colour's packed slot."""
    H, W, K = V.H, V.W, V.n_colors
    cpk = np.full(K * H * -(-W // V.jstride), np.nan)
    G = (W + 3) // 4
    for q4 in range(H * G):
        i, g = divmod(q4, G)
        for q in range(4):
            j = 4 * g + q
            if j < W:
                cpk[packed_index(V, (V.w0 * i + V.w1 * j) % K, i, j)] = f[i, j] + ns[i, j] * xi[i, j]
    return cpk


def replay_sweep(plan, V, rows, c_at, x):
    """``sweep_colours``: colour by colour, the points of the colour in the
    order the warps and lanes take them, each x[p] += omega (c - (A x)[p]) /
    diag[p] with the stencil's terms in offset order, out-of-field terms
    skipped, x updated in place."""
    x = x.copy()
    H, W = x.shape
    coeffs = plan.coeffs.numpy()
    d = V.diag_index
    for o in range(V.n_order):
        for _, _, i, j, slot in lane_points(V, rows, o, 8):
            ax = 0.0
            for k in range(V.K):
                i2, j2 = i + V.dy[k], j + V.dx[k]
                if 0 <= i2 < H and 0 <= j2 < W:
                    ax += coeffs[k, i, j] * x[i2, j2]
            x[i, j] = x[i, j] + plan.omega * (c_at(slot, i, j) - ax) / coeffs[d, i, j]
    return x


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_float64_replay_of_the_sweep_is_the_plain_sweep(kind, direction):
    plan = plan_of(kind, direction)
    b, x, _ = _inputs(plan.op.vshape, True, seed=31, C=2)
    P = plan.params(2, True, 0, None)
    V, rows = ss.pass_params(P), sweep_rows(P)
    got = np.stack([replay_sweep(plan, V, rows, lambda slot, i, j, c=c: b[c, i, j], x[c])
                    for c in range(2)])
    want = ss.sweep_batched_plain(plan.op, plan.masks, plan.omega, plan.order, tt(b), tt(x))
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)
    # and the JAX package's sweep
    a = _jax_operator(kind, jnp.float64)
    coloring = jcoloring_for(a.offsets, a.vshape)
    jwant = jsor_sweep(a, jnp.asarray(coloring.masks()), plan.omega,
                       jcolor_order(coloring.n_colors, direction), jnp.asarray(b), jnp.asarray(x))
    assert_close(torch.as_tensor(got), jwant, **F64)
    assert np.abs(got - x).max() > 1e-3


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_float64_replay_of_the_gibbs_sweep_is_the_plain_gibbs_sweep(monkeypatch, kind,
                                                                    direction):
    """The packed rhs, then the sweep reading each colour's slots: the plain
    Gibbs sweep fed the same ``xi``, and the JAX package's composed Gibbs
    sweep (``random_rhs`` + ``sor_sweep``) under the same draw."""
    plan = plan_of(kind, direction)
    f, x, xi = _inputs(plan.op.vshape, True, seed=32, C=2)
    P = plan.params(2, True, 2, None)
    V, rows = ss.pass_params(P), sweep_rows(P)
    ns = plan.noise_scale.numpy()
    got = []
    for c in range(2):
        cpk = replay_rhs(V, f[c], ns, xi[c])
        assert not np.isnan(cpk[[packed_index(V, (V.w0 * i + V.w1 * j) % V.n_colors, i, j)
                                 for i in range(V.H) for j in range(V.W)]]).any()
        got.append(replay_sweep(plan, V, rows, lambda slot, i, j, cpk=cpk: cpk[slot], x[c]))
    got = np.stack(got)
    want = ss.gibbs_sweep_batched_plain(plan.op, plan.masks, plan.omega, plan.order, tt(f),
                                        tt(x), tt(xi))
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)
    a = _jax_operator(kind, jnp.float64)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(xi))
    jsampler = JSORSampler(a, plan.omega, 1, direction)
    cj = jsampler.random_rhs(jax.random.key(0), jnp.asarray(f), jnp.asarray(x))
    jwant = jsor_sweep(a, jsampler.smoother.masks, plan.omega, jsampler.smoother.order, cj,
                       jnp.asarray(x))
    assert_close(torch.as_tensor(got), jwant, **F64)


def test_lane_points_mirror_the_source():
    src = (CSRC / "level_passes.cuh").read_text()
    macro = re.search(r"#define LANE_POINTS\(KMAX, PLANES\) (.+)", src).group(1)
    assert macro == "((KMAX) == 5 ? ((PLANES) ? 2 : 4) : ((PLANES) ? 1 : 2))"
    assert LANE_POINTS == {(5, False): 4, (5, True): 2, (9, False): 2, (9, True): 1}
    index = re.search(r"int packed_index\(.*?\{(.*?)\n\}", src, re.S).group(1)
    assert "return (ci * P.H + i) * ((P.W + s - 1) / s) + j / s;" in index


# --------------------------------------------- body, stencil form, block size
def test_body_and_stencil_form_of_each_launch():
    """2d stencils of reach 1 with at most 9 offsets take the passes body, one
    kernel per stencil form (the phase kernels' forms); 3d fields and reach-2
    stencils the shared-memory body where a chain fits a quarter of the card's
    grant, else the passes' 3d or reach-2 build (the phase kernels' forms of
    that build), a 3d stencil of 7 offsets the smem3d body where its table
    lists the shape, else (these small fields) the generic body, as a stencil
    none of those takes (reach 3); the
    raw-array entry points read every coefficient plane, so their launches
    take the odd forms."""
    forms = {}
    for kind in KINDS:
        plan = plan_of(kind, "forward", dtype=torch.float32)
        assert plan.body == "passes"
        launch = plan.pass_launch(plan.params(4, False, 1, (5, 6)))
        forms[kind] = launch.form
        const = common.compress_plan(plan.op, plan.omega)[0]
        assert launch.form == mv.stencil_form(plan.op.offsets, const)
        assert (launch.params.seed, launch.params.counter) == (5, 6)
        raw = ss.PassLaunch(plan.params(4, False, 1, (5, 6)), (None,) * len(plan.op.offsets),
                            CPU, 256)
        assert raw.form == launch.form | 1
    assert forms == {"fd5pt": 0, "galerkin9pt": 2, "periodic5pt": 1}
    for kind, build in (("3d7pt", (1, 3)), ("3d27pt", (1, 3)), ("reach2_13pt", (2, 2))):
        plan = plan_of(kind, "forward", dtype=torch.float32)
        vshape, offsets = plan.op.vshape, plan.op.offsets
        assert plan.body == "smem" == ss.sweep_body(vshape, offsets)
        assert ss.sweep_body(vshape, offsets, ss.smem_sweep_bytes(vshape, offsets) * 4 - 4) \
            == ("generic" if kind == "3d7pt" else "passes")
        assert ss.passes_build(vshape, offsets) == build
        launch = plan.pass_launch(plan.params(4, False, 1, (5, 6)))
        assert launch.build == build
        const = common.compress_plan(plan.op, plan.omega)[0]
        assert launch.form == mv.stencil_form(offsets, const)
        assert type(launch.params) is mv.PHASE_BUILDS[build][1]
        assert launch.params.H * launch.params.W == int(np.prod(vshape))
    box11 = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1)) + ((0, 2), (2, 0))
    assert ss.sweep_body((9, 9), box11) == "smem"
    reach3 = ((0, 0), (0, 3), (3, 0), (0, -3), (-3, 0))
    assert ss.sweep_body((9, 9), reach3) == "generic"
    assert ss.passes_build((9, 9), reach3) is None
    with pytest.raises(ValueError, match="2d stencils of reach 1"):
        P = ss.build_sweep_params((9, 9), reach3, 0, 2, (1, 1), (0, 1), 1.0, (None,) * 5, None,
                                  4, False, 0)
        ss.pass_params(P)


@pytest.mark.parametrize("n", [255 * 255, 127 * 127, 63 * 63, 31 * 31, 15 * 15])
def test_block_size_by_chain_count(n):
    """The block size that holds the chains in one wave (1024 threads: one
    block an SM, 512: two, 256: four), no more than the field's points
    allow (512 below 3,000 points, 256 below 900) and no less (512 from
    16,000): the measured table of ``sor_sweep.py``."""
    sms = common.H100_SMS
    most = 1024 if n >= 3000 else (512 if n >= 900 else 256)
    least = 512 if n >= 16000 else 256
    for C, wave in ((1, 1024), (64, 1024), (sms, 1024), (sms + 1, 512), (256, 512),
                    (2 * sms, 512), (2 * sms + 1, 256), (512, 256), (28529, 256)):
        assert ss.sweep_threads(C, n, sms) == max(least, min(most, wave)), C
    # the distillation set-up's 28,529 columns: 256 threads on 63^2 and 31^2
    assert ss.sweep_threads(28529, 63 * 63, sms) == ss.sweep_threads(28529, 31 * 31, sms) == 256
    # the 256-chain cases of chip_smoke.py: two blocks of 512 an SM
    if n in (255 * 255, 127 * 127):
        assert ss.sweep_threads(256, n, sms) == 512 and ss.sweep_threads(128, n, sms) == 1024


def test_plans_ask_the_rule_with_the_cards_sm_count():
    plan = flagship_plans()[0]
    for C, want in ((128, 1024), (256, 512)):
        assert plan.pass_launch(plan.params(C, True, 1, (0, 0))).threads == want
    # kept per launch configuration; the stream changes from launch to launch
    first = plan.pass_launch(plan.params(256, True, 1, (3, 4)))
    again = plan.pass_launch(plan.params(256, True, 1, (3, 9)))
    assert again is first and first.params.counter == 9
    assert first.rows.dtype == torch.int32 and first.rows.device.type == "cpu"


def test_pass_params_mirror_the_sweep_params():
    plan = plan_of("periodic5pt", "backward", dtype=torch.float32)
    P = plan.params(7, True, 1, (11, 12))
    V = ss.pass_params(P)
    assert (V.C, V.H, V.W, V.Hc, V.Wc, V.m) == (7, P.Y, P.X, 0, 0, 0)
    assert (V.K, V.diag_index, V.n_colors, V.jstride) == (P.K, P.diag_index, P.n_colors, P.jstride)
    assert (V.w0, V.w1) == (P.wy, P.wx)
    for k in range(P.K):
        assert (V.dy[k], V.dx[k]) == (P.dy[k], P.dx[k])
        assert V.coeff_const[k] == P.coeff_const[k] and V.coeff_val[k] == P.coeff_val[k]
    assert [V.order[o] for o in range(V.n_order)] == list(plan.order)
    assert (V.noise_mode, V.ns_const, V.f_batched) == (1, P.ns_const, 1)
    assert abs(V.omega - P.omega) < 1e-7 and V.gamma == 0.0


# ------------------------------------------------------ barriers and stamps
def kernel_text(src, name):
    start = src.index(name + "(")
    return src[start:src.index("\n}\n", start)]


def test_barriers_of_a_sweep_from_the_sources():
    """One barrier after the Gibbs rhs pass and one after each colour, in
    both bodies: ``barrier_count`` is what the stamps builds count on the
    card (``chip_smoke.py`` holds the two equal)."""
    passes = (CSRC / "sor_sweep_passes.cu").read_text()
    level = (CSRC / "level_passes.cuh").read_text()
    generic = (CSRC / "sor_sweep.cu").read_text()
    sweep_kernel = kernel_text(passes, "passes_sweep_kernel")
    gibbs_kernel = kernel_text(passes, "passes_gibbs_kernel")
    assert "block_sync" not in sweep_kernel and "level_sweep<" in sweep_kernel
    assert "block_sync" not in gibbs_kernel
    assert gibbs_kernel.index("rhs_packed<") < gibbs_kernel.index("level_sweep<")
    assert kernel_text(level, "void rhs_packed").count("block_sync<COUNT>();") == 1
    sweep = kernel_text(level, "void sweep_colours")
    assert sweep.count("block_sync<COUNT>();") == 1
    assert sweep.index("for (int o = 0; o < P.n_order; ++o)") < sweep.index("block_sync")
    assert "level_sweep<FORM, STAMPS, true>(P, rows_only(rows), coeffs, cpk" in gibbs_kernel
    phases = kernel_text(generic, "void sweep_phases")
    assert phases.count("block_sync<STAMPS>();") == 1
    assert kernel_text(generic, "gibbs_sweep_kernel").count("block_sync<STAMPS>();") == 1
    for plan in flagship_plans():
        n = len(plan.order)
        assert ss.barrier_count(plan.order, False) == n
        assert ss.barrier_count(plan.order, True) == n + 1
        assert ss.sweep_pass_names(plan.order, True) == ["rhs"] + [f"colour {c}"
                                                                    for c in plan.order]


def test_stamps_of_a_sweep_break_down_by_pass():
    """A stamps row as the builds write it (block_stamps.cuh): the timer at
    entry, after each barrier, at exit at width - 3, then the barriers and the
    SM; two blocks on one SM, one on another."""
    order = (1, 0)
    W = ss.SWEEP_STAMP_WIDTH
    raw = np.zeros((3, W), np.int64)
    for b, (t0, sm) in enumerate(((0, 5), (1000, 5), (0, 7))):
        raw[b, :4] = t0 + np.array([0, 50_000, 110_000, 160_000])
        raw[b, W - 3] = t0 + 161_000
        raw[b, W - 2], raw[b, W - 1] = 3, sm
    got = ss.sweep_pass_times(order, True, torch.as_tensor(raw))
    assert list(got["passes"]) == ["rhs", "colour 1", "colour 0"]
    np.testing.assert_allclose(list(got["passes"].values()), [50.0, 60.0, 50.0])
    assert got["exit_us"] == 1.0 and got["sum_us"] == 161.0
    assert got["barriers_per_block"] == [3] == [ss.barrier_count(order, True)]
    assert got["blocks_per_sm"] == 2 and got["sms"] == 2
    assert got["launch_span_us"] == 162.0


def test_the_sweep_stamps_builds_are_libraries_of_their_own():
    assert common.SWEEP_STAMPS_FLAGS == ("-DSWEEP_STAMPS_BUILD=1",)
    for name in ("sor_sweep_passes", "sor_sweep"):
        assert (name, common.SWEEP_STAMPS_FLAGS) in common.STAMPS_BUILDS
        production = common.library_path(name)
        stamps = common.library_path(name, common.SWEEP_STAMPS_FLAGS)
        assert production != stamps and stamps.parent == common.BUILD_DIR
        src = common.source_path(name).read_text()
        # the width and the build's default stand once, in the header both include
        assert "#define SWEEP_STAMP" not in src
        assert '#include "block_stamps.cuh"' in src or '#include "level_passes.cuh"' in src
    header = (common.CSRC_DIR / "block_stamps.cuh").read_text()
    assert "#ifndef SWEEP_STAMPS_BUILD\n#define SWEEP_STAMPS_BUILD 0" in header
    assert "#define SWEEP_STAMP_WIDTH (2 + MAX_COLORS + 3)" in header
    assert '#include "block_stamps.cuh"' in (common.CSRC_DIR / "level_passes.cuh").read_text()
    assert ss.SWEEP_STAMP_WIDTH == 2 + ss.MAX_COLORS + 3
    assert "block_stamps.cuh" in common.HEADERS


def test_launch_checks_on_the_cpu():
    """A launch takes CUDA tensors; the body asked for must take the stencil;
    a stamps tensor goes to the one-block route only.  Nothing launches."""
    ss.reset_launch_counts()
    plan = plan_of("fd5pt", "forward", dtype=torch.float32)
    x = torch.zeros((2,) + plan.op.vshape)
    with pytest.raises(ValueError, match="CUDA device"):
        ss.launch_sweep(plan, ss.BLOCK_ROUTE, x[0], x)
    with pytest.raises(ValueError, match="CUDA device"):
        ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, x[0], x, xi=x)
    deep = plan_of("3d7pt", "forward", dtype=torch.float32)
    reach3 = ((0, 0), (0, 3), (3, 0), (0, -3), (-3, 0))
    with pytest.raises(ValueError, match="passes body takes"):
        ss._check_body("passes", (9, 9), reach3, ss.BLOCK_ROUTE, None, x)
    with pytest.raises(ValueError, match="shared-memory body takes"):
        ss._check_body("smem", plan.op.vshape, plan.op.offsets, ss.BLOCK_ROUTE, None, x)
    with pytest.raises(ValueError, match="no stamps build"):
        ss._check_body("passes", deep.op.vshape, deep.op.offsets, ss.BLOCK_ROUTE,
                       torch.zeros((2, ss.PASSES_STAMP_WIDTH), dtype=torch.int64), x)
    ss._check_body("smem", deep.op.vshape, deep.op.offsets, ss.BLOCK_ROUTE,
                   torch.zeros((2, ss.SWEEP_STAMP_WIDTH), dtype=torch.int64), x)
    with pytest.raises(ValueError, match="body must be"):
        ss._check_body("fast", plan.op.vshape, plan.op.offsets, ss.BLOCK_ROUTE, None, x)
    stamps = torch.zeros((2, ss.SWEEP_STAMP_WIDTH), dtype=torch.int64)
    with pytest.raises(ValueError, match="only the one-block route"):
        ss._check_body("passes", plan.op.vshape, plan.op.offsets, ("split", 4), stamps, x)
    with pytest.raises(ValueError, match="stamps must be"):
        ss._check_body("passes", plan.op.vshape, plan.op.offsets, ss.BLOCK_ROUTE,
                       stamps[:1], x)
    ss._check_body("generic", plan.op.vshape, plan.op.offsets, ss.BLOCK_ROUTE, stamps, x)
    assert all(v == 0 for v in ss.launch_counts.values())
    assert {"sweep_batched_generic", "gibbs_sweep_batched_generic"} <= set(ss.launch_counts)


def test_reference_normals_of_a_range_of_chains():
    """The host's reference normals of chains ``first .. first + n - 1`` (the
    chip check's in-kernel noise at many chains) are those rows of the
    reference of every chain."""
    whole = common.philox_normals_reference(7, 3, 12, (5, 9))
    for first, n in ((0, 4), (5, 3), (9, 3)):
        part = common.philox_normals_reference(7, 3, n, (5, 9), first_chain=first)
        np.testing.assert_array_equal(part, whole[first:first + n])
