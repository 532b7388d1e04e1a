"""The one-block sweeps' shared-memory body (``csrc/sor_sweep_smem.cu``) and the
passes' reach-2 and 3d builds on the CPU:

* the host's tables of the shared-memory body (``sor_sweep.smem_tables``):
  every point of each colour exactly once, for the 9-colour 25-point 2d and the
  8-colour 27-point 3d levels, in both orders; the padded index of each entry;
  interior points first, with the interior coefficients;
* the fit rule (``smem_fits``: a quarter of the card's grant) and the bodies
  and routes (``sweep_body``, ``passes_build``, ``sweep_route``) on the
  distillation set-up's shapes and on the large ones;
* a float64 replay of the kernel's schedule from its tables (padded x with a
  zero halo, the colours' points in table order, interior points with the
  scalars, the diagonal's reciprocal with one correction) against the plain
  sweeps (``1e-12``);
* the plain 9-colour 25-point and 27-point sweeps against the JAX package in
  float64 (``1e-12``): the deterministic sweep against ``sweep_batched_v2`` in
  interpret mode, as ``tests/test_pallas_v2.py`` runs it; the Gibbs sweep,
  whose Pallas generator has no CPU interpret mode, against the JAX package's
  plain sweep fed the same normals.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against the
plain versions and the generic body on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConstant
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshiftedlaplace_fd
from multigridmc_tpu.models.prior import squared_shiftedlaplace_fd as jsquared_fd
from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.ops.coloring import coloring_for as jcoloring_for
from multigridmc_tpu.ops.kernels import sor_pallas_v2 as v2
from multigridmc_tpu.smoothers import color_order as jcolor_order
from multigridmc_tpu.smoothers import sor_sweep as jsor_sweep

from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import SORSmoother

from test_torch_common import F64, assert_close, to_port, tt

#: an H100's grant of dynamic shared memory to a block (the probe's answer)
H100_GRANT = 232448
DIRECTIONS = ("forward", "backward")
EXACT = dict(rtol=1e-12, atol=1e-12)


def _jax_level(kind, dtype=jnp.float64):
    """The 9-colour 25-point Galerkin level of a squared FD prior (15^2) and the
    8-colour 27-point Galerkin level of a 3d FD prior (5 x 5 x 7)."""
    if kind == "25pt":
        return jgalerkin(jsquared_fd(JLattice((32, 32)), JConstant(0.3), dtype=dtype))
    if kind == "27pt":
        return jgalerkin(jshiftedlaplace_fd(JLattice((12, 12, 16)), JConstant(0.3), dtype=dtype))
    raise ValueError(kind)


def _plan(kind, direction, omega=1.3, dtype=torch.float64):
    return SORSmoother(to_port(_jax_level(kind), dtype), omega, 1, direction).plan


def _inputs(vshape, seed, C=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C,) + vshape), rng.normal(size=(C,) + vshape),
            rng.normal(size=(C,) + vshape))


def _tables(plan):
    op = plan.op
    return ss.smem_tables(op.vshape, op.offsets, plan.coloring.weights, plan.coloring.n_colors,
                          plan.order, op.coeffs.numpy())


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind,colours", [("25pt", 9), ("27pt", 8)])
def test_tables_hold_each_point_of_each_colour_once(kind, colours, direction):
    """Colour after colour of the sweep's order, each point of the colour once
    (and no other), its padded index beside its field index; the interior
    points first, each with the interior coefficient wherever its neighbour
    lies in the field; the reciprocal of the interior diagonal."""
    plan = _plan(kind, direction, dtype=torch.float32)
    op = plan.op
    assert plan.coloring.n_colors == colours and plan.body == "smem"
    t = _tables(plan)
    n = int(np.prod(op.vshape))
    table = t["table"].astype(np.int64)
    assert sorted(table & 0xFFFF) == list(range(n))
    RZ, R = ss.smem_halo(op.vshape, op.offsets)
    PZ, PY, PX = ss.smem_padded(op.vshape, op.offsets, t["extra"])
    assert 0 <= t["extra"] <= ss.SMEM_PITCH_SLACK
    # the bank conflicts of the width chosen: at least one wavefront a warp
    q = table >> 16
    warps = sum(-(-(b - a) // 32) for a, b in zip(t["start"][:-1], t["start"][1:]))
    assert t["conflicts"] == ss.bank_conflicts(q, t["start"]) >= warps
    coeffs = op.coeffs.numpy().reshape(len(op.offsets), n)
    colour = plan.coloring.field.reshape(-1)
    for o, col in enumerate(plan.order):
        part = table[t["start"][o]:t["start"][o + 1]]
        p = part & 0xFFFF
        assert sorted(p) == list(np.flatnonzero(colour == col))
        idx = np.unravel_index(p, op.vshape)
        z = idx[0] if len(op.vshape) == 3 else 0
        assert np.array_equal(part >> 16, ((z + RZ) * PY + idx[-2] + R) * PX + idx[-1] + R)
        plain = p[:t["plain"][o]]
        for k, off in enumerate(op.offsets):
            nb = [c + int(d) for c, d in zip(np.unravel_index(plain, op.vshape), off)]
            inside = np.all([(v >= 0) & (v < m) for v, m in zip(nb, op.vshape)], axis=0)
            assert (coeffs[k, plain][inside] == t["cval"][k]).all()
        # the points after them read the planes: each differs somewhere
        rest = p[t["plain"][o]:]
        assert rest.size == 0 or not np.all(coeffs[:, rest] == t["cval"][:, None])
    assert t["start"][-1] == n and len(t["plain"]) == len(plan.order)
    assert t["rdiag"] == np.float32(1) / t["cval"][op.diag_index]
    most = max(b - a for a, b in zip(t["start"][:-1], t["start"][1:]))
    for C, cap in ((132, 512), (133, 256), (28529, 256)):
        threads = ss.smem_threads(t["start"], C, 132)
        assert threads % 32 == 0 and threads == min(cap, max(64, -(-most // 32) * 32))
    # the planes the other points read: those that vary over the field
    varies = [not np.all(coeffs[k] == coeffs[k, 0]) for k in range(len(op.offsets))]
    assert t["planes"] == sum(1 << k for k, v in enumerate(varies) if v)


def test_bank_order_spreads_the_setup_levels_warps():
    """On the biharmonic set-up's 63^2 level, 9 colours: storage order puts
    several rows of a warp on one bank (4.4 wavefronts a warp); the table
    dealt round the banks, its width searched, takes under 1.2."""
    plan = SORSmoother(to_port(jgalerkin(jsquared_fd(
        JLattice((128, 128)), JConstant(0.2), dtype=jnp.float32)), torch.float32), 1.0, 1).plan
    assert plan.op.vshape == (63, 63) and plan.coloring.n_colors == 9
    t = _tables(plan)
    warps = sum(-(-(b - a) // 32) for a, b in zip(t["start"][:-1], t["start"][1:]))
    p = np.sort(t["table"] & 0xFFFF)
    q0 = ((p // 63) + 2) * 67 + p % 63 + 2
    colour = plan.coloring.field.reshape(-1)
    storage = np.concatenate([q0[colour[p] == c] for c in plan.order])
    assert ss.bank_conflicts(storage, t["start"]) > 4 * warps
    assert t["conflicts"] < 1.2 * warps


def test_the_setup_levels_are_mostly_interior():
    """On the biharmonic set-up's 31^2 level (the Galerkin levels of the
    squared FD prior) only the points on the edge read planes: from one row
    and column in, every coefficient whose neighbour lies in the field is the
    interior one."""
    plan = SORSmoother(to_port(jgalerkin(jgalerkin(jsquared_fd(
        JLattice((128, 128)), JConstant(0.2), dtype=jnp.float32))), torch.float32),
        1.0, 1).plan
    assert plan.op.vshape == (31, 31) and plan.coloring.n_colors == 9
    t = _tables(plan)
    assert sum(t["plain"]) == 29 * 29


# ------------------------------------------------------- fit rule, bodies
BOX25 = tuple((a, b) for a in range(-2, 3) for b in range(-2, 3))
DIAMOND13 = ((0, 0), (-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1), (0, 1), (0, 2),
             (1, -1), (1, 0), (1, 1), (2, 0))
BOX27 = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
STAR7 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


@pytest.mark.parametrize("vshape,offsets,nbytes,body,build", [
    ((63, 63), BOX25, 4 * (67 * 75 + 2 * 63 * 63), "smem", (2, 2)),
    ((31, 31), BOX25, 4 * (35 * 43 + 2 * 31 * 31), "smem", (2, 2)),
    ((15, 15, 15), BOX27, 4 * (17 * 17 * 25 + 2 * 15 ** 3), "smem", (1, 3)),
    ((63, 63), DIAMOND13, 4 * (67 * 75 + 2 * 63 * 63), "smem", (2, 2)),
    ((127, 127), BOX25, 4 * (131 * 139 + 2 * 127 * 127), "passes", (2, 2)),
    ((255, 255), DIAMOND13, 4 * (259 * 267 + 2 * 255 * 255), "passes", (2, 2)),
    ((63, 63, 63), STAR7, 4 * (65 * 65 * 73 + 2 * 63 ** 3), "smem3d", (1, 3)),
    ((31, 31, 31), BOX27, 4 * (33 * 33 * 41 + 2 * 31 ** 3), "passes", (1, 3)),
])
def test_fit_rule_and_body(vshape, offsets, nbytes, body, build):
    """A chain takes the shared-memory body where its padded x (with the
    widest padding the bank search may pick), its rhs and its table fit a
    quarter of the grant (58,112 bytes on an H100, so that four blocks share an SM), else the
    passes' reach-2 or 3d build; the rule is the same on the CPU, which takes
    the H100's grant; a 3d stencil of 7 offsets that does not fit takes the
    smem3d body (its slabs over a cluster), where a cluster holds the chain,
    which the generic body's warp per row and the passes' 3d build measured
    slower than."""
    assert ss.smem_sweep_bytes(vshape, offsets) == nbytes
    assert ss.smem_fits(vshape, offsets, H100_GRANT) == (nbytes <= H100_GRANT // 4)
    assert ss.sweep_body(vshape, offsets) == body == ss.sweep_body(vshape, offsets, H100_GRANT)
    assert ss.passes_build(vshape, offsets) == build
    assert ss.CPU_SMEM_LIMIT == H100_GRANT and ss.SMEM_BLOCKS_PER_SM == 4
    # the rule's edge: a grant four times the bytes fits, four bytes less not
    assert ss.sweep_body(vshape, offsets, 4 * nbytes) == "smem"
    assert ss.sweep_body(vshape, offsets, 4 * nbytes - 4) == (
        "smem3d" if len(offsets) < ss.PASSES_DIM3_MIN_OFFSETS and len(vshape) == 3 else "passes")
    assert ss.smem_kmax(vshape, offsets) == {13: 13, 25: 25, 7: 7, 27: 27}[len(offsets)]


def test_bodies_of_other_stencils_and_routes():
    """2d reach-1 stencils keep the passes' reach-1 build whatever their size;
    what no build takes goes to the generic body; the set-up's chain counts
    take one block per chain, one chain the split route."""
    assert ss.sweep_body((31, 31), ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))) == "passes"
    assert ss.sweep_body((31, 31), ((0, 0), (0, 3), (0, -3))) == "generic"
    assert ss.sweep_body((31, 31), BOX25[::-1]) == "generic"  # not raster order, 25 offsets
    assert ss.sweep_body((7, 7, 7), ((0, 0, 0), (0, 0, 2), (0, 0, -2))) == "generic"
    assert ss.split_stencil((63, 63), BOX25) == "reach-2"
    assert ss.split_stencil((63, 63, 63), STAR7) == "3d"
    plan = SORSmoother(to_port(jgalerkin(jgalerkin(jsquared_fd(
        JLattice((128, 128)), JConstant(0.2), dtype=jnp.float32))), torch.float32), 1.0, 1).plan
    assert plan.body == "smem"
    for mode in (0, 1):  # reach 2: one block per chain at every count
        assert ss.sweep_route(28529, plan, mode, H100_GRANT) == ss.BLOCK_ROUTE
        assert ss.sweep_route(1, plan, mode, H100_GRANT) == ss.BLOCK_ROUTE


# ----------------------------------------------------- replay of the schedule
def _replay(plan, b, x):
    """The shared-memory kernel's schedule in float64: one chain's padded x
    (zero halo) and rhs, the colours' points in table order, interior points
    with the scalars, the others with the planes, the update from the
    diagonal's reciprocal with one correction."""
    op = plan.op
    t = _tables(plan)
    n = int(np.prod(op.vshape))
    RZ, R = ss.smem_halo(op.vshape, op.offsets)
    pad = ss.smem_padded(op.vshape, op.offsets, t["extra"])
    sx = np.zeros(pad)
    inner = (slice(RZ, pad[0] - RZ),) + tuple(slice(R, R + m) for m in op.vshape[-2:])
    sx[inner] = x.reshape((1,) * (3 - x.ndim) + x.shape)
    sx = sx.reshape(-1)
    PY, PX = pad[1:]
    soff = [((off[-3] if len(off) == 3 else 0) * PY + off[-2]) * PX + off[-1]
            for off in op.offsets]
    c = op.coeffs.numpy().reshape(len(op.offsets), n)
    cval = c[:, np.ravel_multi_index(tuple(v // 2 for v in op.vshape), op.vshape)]
    d = op.diag_index
    for o in range(len(plan.order)):
        for tt_ in range(t["start"][o], t["start"][o + 1]):
            e = int(t["table"][tt_])
            q, p = e >> 16, e & 0xFFFF
            coef = cval if tt_ - t["start"][o] < t["plain"][o] else c[:, p]
            ax = sum(coef[k] * sx[q + soff[k]] for k in range(len(op.offsets)))
            num = plan.omega * (b.reshape(-1)[p] - ax)
            q0 = num * (1.0 / coef[d])
            sx[q] += q0 + (num - q0 * coef[d]) * (1.0 / coef[d])
    return sx.reshape(pad)[inner].reshape(x.shape)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", ["25pt", "27pt"])
def test_replay_of_the_kernel_schedule(kind, direction):
    """The replay equals the plain sweeps (deterministic, and Gibbs on the rhs
    the kernel forms) in float64."""
    plan = _plan(kind, direction)
    b, x, xi = _inputs(plan.op.vshape, seed=11, C=1)
    want = ss.sweep_batched_plain(plan.op, plan.masks, plan.omega, plan.order, tt(b), tt(x))
    assert_close(torch.as_tensor(_replay(plan, b[0], x[0]))[None], want, **EXACT)
    c = b + (plan.noise_scale.numpy() * xi)
    want = ss.gibbs_sweep_batched_plain(plan.op, plan.masks, plan.omega, plan.order, tt(b),
                                        tt(x), tt(xi))
    assert_close(torch.as_tensor(_replay(plan, c[0], x[0]))[None], want, **EXACT)


# ------------------------------------------------ plain sweeps against JAX
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", ["25pt", "27pt"])
def test_plain_sweep_matches_interpreted_pallas_kernel_float64(kind, direction):
    """The deterministic 9-colour 25-point and 8-colour 27-point sweeps against
    ``sweep_batched_v2`` in interpret mode, float64."""
    a = _jax_level(kind)
    coloring = jcoloring_for(a.offsets, a.vshape)
    order = jcolor_order(coloring.n_colors, direction)
    b, x, _ = _inputs(a.vshape, seed=12)
    want = v2.sweep_batched_v2(
        a.coeffs, jnp.asarray(b), jnp.asarray(x), offsets=a.offsets, diag_index=a.diag_index,
        omega=1.3, order=order, color_weights=coloring.weights, n_colors=coloring.n_colors,
        interpret=True)
    assert np.asarray(want).dtype == np.float64
    plan = _plan(kind, direction)
    assert plan.order == tuple(order) and plan.coloring.n_colors in (8, 9)
    assert_close(ss.sweep_batched(plan, tt(b), tt(x)), want, **EXACT)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", ["25pt", "27pt"])
def test_plain_gibbs_sweep_matches_jax_plain_sweep_float64(kind, direction):
    """The Gibbs sweep fed ``xi`` against the JAX package's plain sweep on
    ``f + sqrt(diag (2 - omega) / omega) xi`` (the same normals)."""
    a = _jax_level(kind)
    coloring = jcoloring_for(a.offsets, a.vshape)
    masks = jnp.asarray(coloring.masks())
    order = jcolor_order(coloring.n_colors, direction)
    f, x, xi = _inputs(a.vshape, seed=13)
    scale = jnp.sqrt(a.diag_stencil() * ((2.0 - 1.3) / 1.3))
    want = jsor_sweep(a, masks, 1.3, order, jnp.asarray(f) + scale * jnp.asarray(xi),
                      jnp.asarray(x))
    plan = _plan(kind, direction)
    got = ss.gibbs_sweep_batched(plan, tt(f), tt(x), xi=tt(xi))
    assert_close(got, want, **EXACT)
    assert_close(plan.noise_scale, scale, **F64)


def test_passes_builds_take_the_phase_kernels_forms():
    """The large reach-2 and 3d fields' launches on the passes: the parameter
    block of the phase kernels' build (3d: rows (z, y), ``H = Z Y``), their
    stencil form, the colour rows of that build, 512 threads a block at most."""
    for kind, build in (("25pt", (2, 2)), ("27pt", (1, 3))):
        plan = _plan(kind, "forward", dtype=torch.float32)
        launch = plan.pass_launch(plan.params(600, True, 1, (1, 2)))
        assert launch.build == build and launch.threads <= ss.PASSES_WIDE_MAX_THREADS
        V = launch.params
        assert isinstance(V, mv.PHASE_BUILDS[build][1])
        assert V.H * V.W == int(np.prod(plan.op.vshape)) and V.m == 0
        assert np.array_equal(launch.rows.numpy(), mv.colour_rows(V))
        assert launch.form == mv.stencil_form(plan.op.offsets, plan._compressed[0])
        assert launch.scratch_floats() == V.n_colors * V.H * -(-V.W // V.jstride)
    assert ss.passes_flags(2, 2) == ("-DVISIT_REACH=2",)
    assert ss.passes_flags(1, 3) == ("-DVISIT_DIM=3",)
