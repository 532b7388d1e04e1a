"""The one-block route's smem3d body (``csrc/sor_sweep_smem3d.cu``: the 3d
7-point sweeps of fields too large for one block, each chain's field in slabs
of z-planes over a thread-block cluster) on the CPU:

* its tables (``mgmc_visit_smem3d.visit_tables`` of the sweep's order, the 3d
  visits' tables): per slab, each point of each colour once, its padded
  index in the slab beside its index, the interior points first - on 7^3 and
  15^3 fields over 2, 3 and 4 slabs (7 over 2 and 15 over 4 uneven);
* the routes: ``sweep_body``, ``smem_fits``, the cluster fit rule
  (``smem3d_sizes``) and the measured table (``smem3d_listed``,
  ``smem3d_config``) send the 31^3 and 63^3 7-point fields to it above the
  split threshold, leave 15^3 on the shared-memory body, 31^3 27-point on
  the passes' 3d build and a shape the table does not list on the generic
  body;
* a float64 replay of the kernel's schedule - slabs with ghost planes copied
  from the neighbouring slabs after each barrier, the colours' points in
  table order, interior points with the scalars, edge points with the planes,
  the diagonal's reciprocal with one correction - against the plain sweeps
  and against the JAX package's ``sweep_batched_v2`` in interpret mode, as
  ``tests/test_pallas_v2.py`` runs it (``1e-12``), deterministic and Gibbs
  with ``xi`` fed as a tensor (``noise_mode`` 2).  The JAX Gibbs kernel
  ``gibbs_sweep_batched_v2`` draws with the TPU's generator, which has no CPU
  interpret mode (``tests/test_pallas_v2.py`` skips it there): its function
  on given normals is ``sweep_batched_v2`` on ``f + sqrt(diag (2 - omega) /
  omega) xi`` (its ``_gibbs_kernel``), which the replay is held to;
* the parameter block, the shared-memory bytes and the barriers against the
  source, the stamps build, the launch checks.

The kernels themselves run on the card only (``chip_smoke.py`` holds them
against the plain versions and the generic body, and
``tests/test_torch_sweep_smem3d_card.py`` on a card).
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConstant
from multigridmc_tpu.models.correlation import PeriodicCorrelationLengthModel as JPeriodic
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshiftedlaplace_fd
from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.ops.coloring import coloring_for as jcoloring_for
from multigridmc_tpu.ops.kernels import sor_pallas_v2 as v2
from multigridmc_tpu.smoothers import color_order as jcolor_order

from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import SORSmoother

from test_torch_common import assert_close, to_port, tt

CSRC = Path(ss.__file__).resolve().parents[2] / "csrc"
H100_GRANT = 232448
DIRECTIONS = ("forward", "backward")
EXACT = dict(rtol=1e-12, atol=1e-12)
OMEGA = 1.3
#: (field, slabs): 7 over 2 (4 + 3 planes), 15 over 3 (5 each), 15 over 4 (4, 4, 4, 3)
SLABS = [(7, 2), (15, 3), (15, 4)]
SLAB_IDS = ["7^3-S2", "15^3-S3", "15^3-S4"]
#: constant coefficients (every point interior) and a correlation length
#: that varies in space (every coefficient plane read at the edge points)
KINDS = ("constant", "varying")


def _jax_op(nx, kind, dtype=jnp.float64):
    model = JConstant(0.3) if kind == "constant" else JPeriodic(0.2, 0.4)
    return jshiftedlaplace_fd(JLattice((nx + 1,) * 3), model, dtype=dtype)


def _plan(nx, kind, direction, dtype=torch.float64):
    return SORSmoother(to_port(_jax_op(nx, kind), dtype), OMEGA, 1, direction).plan


def _inputs(vshape, seed, C=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(C,) + tuple(vshape)) for _ in range(3))


def _block(plan, S):
    """The kernel's parameter block over clusters of ``S`` and its tables."""
    t = v3.visit_tables(plan, [plan.order], S)
    return ss.smem3d_params(plan.params(1, False, 0, None), t, S, False), t


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("nx,S", SLABS, ids=SLAB_IDS)
def test_tables_hold_each_point_of_each_colour_once(nx, S, direction):
    """Per slab (rank), colour after colour of the sweep's order: each point
    of the slab of that colour once and no other, its padded index in the
    slab (ghost plane below it) beside its index in the slab, the interior
    points first; the heads give each colour's start and interior count; over
    the slabs every point once."""
    plan = _plan(nx, "varying", direction)
    M, t = _block(plan, S)
    Z, Y, X = plan.op.vshape
    n2 = Y * X
    colour = plan.coloring.field.reshape(-1)
    words = t["words"].view(np.uint32).astype(np.int64)
    assert (M.PX, M.PP, M.nz_max) == (X + 2, (Y + 2) * (X + 2), -(-Z // S))
    seen = []
    bounds = v3.slabs(Z, S)
    assert [z1 - z0 for z0, z1 in bounds] == [Z // S + (k < Z % S) for k in range(S)]
    for k, (z0, z1) in enumerate(bounds):
        head = words[k * v3.HEAD_INTS:(k + 1) * v3.HEAD_INTS]
        for o, col in enumerate(plan.order):
            part = words[head[o]:head[o + 1]]
            e = part & 0xFFFF
            p = z0 * n2 + e
            want = [q for q in range(z0 * n2, z1 * n2) if colour[q] == col]
            assert sorted(p) == want
            lz, rem = np.divmod(e, n2)
            y, j = np.divmod(rem, X)
            assert np.array_equal(part >> 16, ((lz + 1) * (Y + 2) + y + 1) * (X + 2) + j + 1)
            nplain = head[v3.HEAD_INTS // 2 + 1 + o]
            assert t["plain"][p[:nplain]].all() and not t["plain"][p[nplain:]].any()
            seen += list(p)
        assert head[len(plan.order)] - head[0] == (z1 - z0) * n2
    assert sorted(seen) == list(range(Z * n2))
    # the varying field: the diagonal varies (the plane the edge points read);
    # interior only the points on the centre's three planes (cos(pi x_d) = 0)
    assert M.planes == 1 << plan.op.diag_index
    assert t["plain"].mean() == pytest.approx(1 - (1 - 1 / nx) ** 3)
    assert (M.K, M.n_order) == (7, 2) and M.S == S
    assert list(M.soff) == [dz * M.PP + dy * M.PX + dx for dz, dy, dx in plan.op.offsets]
    assert M.rdiag == np.float32(1) / np.float32(t["cval"][plan.op.diag_index])


def test_constant_field_is_interior_everywhere():
    """A constant-coefficient FD prior: every point interior (a neighbour
    beyond the field reads the zero halo), no plane read."""
    plan = _plan(15, "constant", "forward")
    M, t = _block(plan, 4)
    assert t["plain"].all() and M.planes == 0 and t["margin"] == 0
    words = t["words"].view(np.uint32).astype(np.int64)
    for k in range(4):
        head = words[k * v3.HEAD_INTS:(k + 1) * v3.HEAD_INTS]
        for o in range(2):
            assert head[v3.HEAD_INTS // 2 + 1 + o] == head[o + 1] - head[o]


# ----------------------------------------------------------------- routes
STAR7 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
BOX27 = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))


@pytest.mark.parametrize("vshape,offsets,body", [
    ((63, 63, 63), STAR7, "smem3d"), ((31, 31, 31), STAR7, "smem3d"),
    ((15, 15, 15), STAR7, "smem"), ((15, 15, 15), BOX27, "smem"),
    ((31, 31, 31), BOX27, "passes"), ((127, 127, 127), STAR7, "generic"),
    ((47, 47, 47), STAR7, "generic"),
])
def test_body_of_each_3d_field(vshape, offsets, body):
    """The body by shape on an H100's grant (and on the CPU, which takes it):
    7-point fields too large for one block take the smem3d body where a
    cluster of at most 16 blocks holds the chain (63^3 over 6-16, 31^3 over
    1-16) and the table lists the shape, 127^3 does not fit one and 47^3 is
    not listed (the generic body); 15^3 fits one block
    (the shared-memory body); 27-point fields too large take the passes' 3d
    build."""
    assert ss.sweep_body(vshape, offsets) == body == ss.sweep_body(vshape, offsets, H100_GRANT)
    assert ss.smem_fits(vshape, offsets, H100_GRANT) == (body == "smem")
    assert ss.smem3d_fits(vshape, offsets, H100_GRANT) == (
        len(offsets) == 7 and vshape[0] < 127)
    sizes = ss.smem3d_sizes(vshape, H100_GRANT)
    Z, Y, X = vshape
    for S in range(1, 17):
        fits = (S <= Z and v3.fits_indices(Z, Y, X, S)
                and v3.smem_bytes(Z, Y, X, S, False) + ss.SMEM3D_STATIC_SMEM <= H100_GRANT)
        assert (S in sizes) == fits
    if vshape == (63, 63, 63):
        assert sizes == tuple(range(6, 17))
    if vshape == (31, 31, 31):
        assert sizes == tuple(range(1, 17))


@pytest.mark.parametrize("chains", [1, 4, 8, 32, 64, 128, 256])
@pytest.mark.parametrize("nx", [31, 63])
def test_route_and_configuration_follow_the_tables(nx, chains):
    """The 31^3 and 63^3 7-point sweeps take the split route up to the 3d
    class's threshold (``SPLIT_MAX_CHAINS``) and the smem3d body above it,
    with the configuration ``SMEM3D_SWEEPS`` gives (cluster size, the rhs in
    shared memory or not, block size), each within the card's grant and the
    tables' 16-bit indices (the route on an H100's grant; the configuration
    is the one the card takes)."""
    plan = SORSmoother(to_port(_jax_op(nx, "constant", jnp.float32), torch.float32), 1.0,
                       1).plan
    assert plan.body == "smem3d"
    for mode, kernel in ((0, "sweep"), (1, "gibbs")):
        limit = ss.split_max_chains(plan.op.vshape, plan.op.offsets, mode)
        route = ss.sweep_route(chains, plan, mode, H100_GRANT)
        assert (route[0] == "split") == (chains <= limit)
        conf = ss.smem3d_config(plan.op.vshape, chains, mode)
        rows = ss.SMEM3D_SWEEPS[(nx, nx, nx, kernel)]
        want = [r[2:] for r in rows if chains >= r[0] and (r[1] is None or chains <= r[1])]
        assert conf == want[0]
        S, c_shared, threads = conf
        assert S in ss.smem3d_sizes(plan.op.vshape, H100_GRANT)
        assert v3.smem_bytes(nx, nx, nx, S, c_shared) + ss.SMEM3D_STATIC_SMEM <= H100_GRANT
        assert threads % 32 == 0 and 32 <= threads <= ss.SMEM3D_MAX_THREADS
        launch = plan.smem3d_launch(plan.params(chains, True, mode, (0, 0)))
        assert (launch.S, launch.c_shared, launch.threads) == conf
        assert launch.nbytes == v3.smem_bytes(nx, nx, nx, S, c_shared)
        assert launch.params.C == chains and launch.params.noise_mode == mode
    # the rows cover every count from one chain on, without a gap
    for kernel in ("sweep", "gibbs"):
        rows = ss.SMEM3D_SWEEPS[(nx, nx, nx, kernel)]
        assert rows[0][0] == 1 and rows[-1][1] is None
        assert all(a[1] + 1 == b[0] for a, b in zip(rows[:-1], rows[1:]))


def test_rule_of_an_unlisted_shape():
    """A shape the table does not list takes the generic body, though a
    cluster would hold its chain: no configuration is guessed, and asking the
    table for one raises.  A listed shape whose configurations exceed the
    grant takes the generic body too."""
    assert (47, 47, 47, "sweep") not in ss.SMEM3D_SWEEPS
    assert ss.smem3d_fits((47, 47, 47), STAR7, H100_GRANT)
    assert not ss.smem3d_listed((47, 47, 47), H100_GRANT)
    assert ss.sweep_body((47, 47, 47), STAR7, H100_GRANT) == "generic"
    for C in (1, 8, 132):
        with pytest.raises(ValueError, match="no configuration of the smem3d body"):
            ss.smem3d_config((47, 47, 47), C, 0)
    for nx in (31, 63):
        assert ss.smem3d_listed((nx,) * 3, H100_GRANT)
    # 63^3's clusters of 6 (219,700 bytes a block) exceed a grant of 200,000
    assert not ss.smem3d_listed((63,) * 3, 200_000)
    assert ss.sweep_body((63, 63, 63), STAR7, 200_000) == "generic"


# ----------------------------------------------------- replay of the schedule
def _replay(plan, S, c, x):
    """The smem3d kernel's schedule in float64 on one chain: block k's slab
    of ``x`` in its padded planes with a ghost plane a side; after the copy-in
    and after each colour (the barriers) every block copies its neighbours'
    edge planes into its ghost planes; then each block updates its points of
    the colour in table order - interior points with the interior
    coefficients, edge points with the planes their bits name - by the
    diagonal's reciprocal with one correction; the slabs written back."""
    op = plan.op
    M, t = _block(plan, S)
    Z, Y, X = op.vshape
    n2, PP = Y * X, M.PP
    K = len(op.offsets)
    coeffs = op.coeffs.numpy().reshape(K, -1)
    cval = coeffs[:, ((Z // 2) * Y + Y // 2) * X + X // 2]
    d = op.diag_index
    words = t["words"].view(np.uint32).astype(np.int64)
    bounds = v3.slabs(Z, S)
    xs = []
    for z0, z1 in bounds:
        slab = np.zeros((z1 - z0 + 2, Y + 2, X + 2))
        slab[1:-1, 1:-1, 1:-1] = x[z0:z1]
        xs.append(slab.reshape(-1))
    cf = c.reshape(-1)
    for o in range(M.n_order):
        for k, (z0, z1) in enumerate(bounds):  # the ghost copies, after the barrier
            if k > 0:
                lo = bounds[k - 1][1] - bounds[k - 1][0]
                xs[k][:PP] = xs[k - 1][lo * PP:(lo + 1) * PP]
            if k + 1 < S:
                xs[k][(z1 - z0 + 1) * PP:] = xs[k + 1][PP:2 * PP]
        for k, (z0, z1) in enumerate(bounds):
            head = words[k * v3.HEAD_INTS:(k + 1) * v3.HEAD_INTS]
            plain = head[v3.HEAD_INTS // 2 + 1 + o]
            for u, e in enumerate(words[head[o]:head[o + 1]]):
                q, p = int(e >> 16), z0 * n2 + int(e & 0xFFFF)
                edge = u >= plain
                a = [coeffs[m, p] if edge and (M.planes >> m) & 1 else cval[m] for m in range(K)]
                ax = 0.0
                for m in range(K):
                    ax += a[m] * xs[k][q + M.soff[m]]
                dd = a[d]
                num = OMEGA * (cf[p] - ax)
                q0 = num * (1.0 / dd)
                xs[k][q] += q0 + (num - q0 * dd) * (1.0 / dd)
    out = np.empty_like(x)
    for k, (z0, z1) in enumerate(bounds):
        out[z0:z1] = xs[k].reshape(z1 - z0 + 2, Y + 2, X + 2)[1:-1, 1:-1, 1:-1]
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("nx,S", SLABS, ids=SLAB_IDS)
def test_replay_equals_the_plain_sweeps(nx, S, direction, kind):
    """The replay equals the plain deterministic sweep and the plain Gibbs
    sweep fed ``xi`` (on the rhs the Gibbs kernel forms: ``f + sqrt(diag (2 -
    omega) / omega) xi``) in float64."""
    plan = _plan(nx, kind, direction)
    b, x, xi = _inputs(plan.op.vshape, seed=21 + S)
    want = ss.sweep_batched_plain(plan.op, plan.masks, OMEGA, plan.order, tt(b), tt(x))
    got = np.stack([_replay(plan, S, b[i], x[i]) for i in range(len(x))])
    assert_close(want, got, **EXACT)
    c = b + plan.noise_scale.numpy() * xi
    want = ss.gibbs_sweep_batched(plan, tt(b), tt(x), xi=tt(xi))
    got = np.stack([_replay(plan, S, c[i], x[i]) for i in range(len(x))])
    assert_close(want, got, **EXACT)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("nx,S", [(7, 2), (15, 4)], ids=["7^3-S2", "15^3-S4"])
def test_replay_equals_the_interpreted_jax_kernels(nx, S, direction, kind):
    """The replay against the JAX package's ``sweep_batched_v2`` in interpret
    mode (float64): the deterministic sweep on ``b``, and the Gibbs sweep's
    function on the normals ``xi`` - ``sweep_batched_v2`` on ``f + sqrt(diag
    (2 - omega) / omega) xi``, what ``gibbs_sweep_batched_v2``'s
    ``_gibbs_kernel`` sweeps - as ``noise_mode`` 2 feeds them."""
    a = _jax_op(nx, kind)
    coloring = jcoloring_for(a.offsets, a.vshape)
    order = jcolor_order(coloring.n_colors, direction)
    plan = _plan(nx, kind, direction)
    assert plan.order == tuple(order) and plan.coloring.n_colors == 2
    b, x, xi = _inputs(a.vshape, seed=31 + S)
    scale = np.sqrt(np.asarray(a.diag_stencil()) * ((2.0 - OMEGA) / OMEGA))
    for rhs in (b, b + scale * xi):
        want = v2.sweep_batched_v2(
            a.coeffs, jnp.asarray(rhs), jnp.asarray(x), offsets=a.offsets,
            diag_index=a.diag_index, omega=OMEGA, order=order, color_weights=coloring.weights,
            n_colors=coloring.n_colors, interpret=True)
        assert np.asarray(want).dtype == np.float64
        got = np.stack([_replay(plan, S, rhs[i], x[i]) for i in range(len(x))])
        np.testing.assert_allclose(got, np.asarray(want), **EXACT)
    np.testing.assert_allclose(plan.noise_scale.numpy(), scale, **EXACT)


def test_one_slab_and_a_cluster_give_the_same_sweep():
    """One block (S = 1: no ghost copy) and clusters of 2-7 on 7^3 replay
    the same sweep: the slabs' cuts change nothing but the order of points."""
    plan = _plan(7, "varying", "forward")
    b, x, _ = _inputs(plan.op.vshape, seed=41, C=1)
    one = _replay(plan, 1, b[0], x[0])
    for S in range(2, 8):
        np.testing.assert_allclose(_replay(plan, S, b[0], x[0]), one, **EXACT)


# ------------------------------------------------------ mirrors of the source
def test_parameter_block_and_bytes_mirror_the_source():
    src = (CSRC / "sor_sweep_smem3d.cu").read_text()
    struct = src[src.index("struct Smem3dSweepParams {"):src.index("};", src.index(
        "struct Smem3dSweepParams {"))]
    names = []
    for decl in re.findall(r"^\s*(?:unsigned long long|unsigned|int|float)\s+([^;]+);", struct,
                           re.M):
        names += [re.sub(r"\[\w+\]", "", v).strip() for v in decl.split(",")]
    assert names == [name for name, _ in ss.Smem3dSweepParams._fields_]
    for define, value in (("SWEEP3D_KMAX", ss.SMEM3D_KMAX),
                          ("SWEEP3D_MAX_CLUSTER", ss.SMEM3D_MAX_CLUSTER),
                          ("SWEEP3D_MAX_THREADS", ss.SMEM3D_MAX_THREADS),
                          ("SWEEP3D_MAX_COLORS", (v3.HEAD_INTS - 1) // 2)):
        assert f"#define {define} {value}\n" in src
    assert "#define SWEEP3D_HEAD_INTS (2 * SWEEP3D_MAX_COLORS + 1)" in src
    assert "#define SWEEP3D_STAMP_WIDTH (2 + SWEEP3D_MAX_COLORS + 3)" in src
    assert ss.SMEM3D_STAMP_WIDTH == 2 + 8 + 3 == ss.STAMP_WIDTHS["smem3d"]
    assert "(long long)(nz + 2) * PP + (c_shared ? (long long)nz * Y * X : 0)" in src
    # the layout is the 3d visits' blocks'
    assert v3.smem_bytes(63, 63, 63, 16, False) == 4 * 6 * 65 * 65 == 101400
    assert v3.smem_bytes(63, 63, 63, 16, True) == 164904
    assert ctypes.sizeof(ss.Smem3dSweepParams) == 152


def test_barriers_and_passes_from_the_source():
    """The kernel's barriers, counted from its smem_sync calls by where they
    stand: one after the copy-in (and the Gibbs rhs), one after each colour
    (the loop's one call), a ghost copy opening each colour; the stamps'
    passes and their count."""
    src = (CSRC / "sor_sweep_smem3d.cu").read_text()
    body = src[src.index("smem3d_sweep_kernel(const"):src.index("stamps_close<STAMPS>(srow")]
    loop = body[body.index("for (int o = 0; o < P.n_order; ++o)"):]
    copy_in = body[:body.index("for (int o = 0; o < P.n_order; ++o)")]
    calls = lambda s: s.count("smem_sync<STAMPS>(")  # noqa: E731
    assert calls(body) == 2 and calls(loop) == 1 and calls(copy_in) == 1
    assert loop.count("ghost_copy(") == 1 and copy_in.count("ghost_copy(") == 0
    for gibbs in (False, True):
        order = (1, 0)
        assert ss.barrier_count(order, gibbs, "smem3d") == 3
        names = ss.sweep_pass_names(order, gibbs, "smem3d")
        assert names[0] == ("copy-in and rhs" if gibbs else "copy-in")
        assert names[1:] == ["colour 1", "colour 0"]
        assert len(names) + 1 + 3 <= ss.SMEM3D_STAMP_WIDTH


def test_profiler_names_of_the_kernels():
    """``chip_smoke.py`` finds the two kernels by their full names (the
    template's first argument tells them apart) and no other sweep kernel."""
    import chip_smoke

    sig = "void smem3d_sweep_kernel<{}, false>(Smem3dSweepParams, int const*, float*)"
    for kind, gibbs in (("sweep", "false"), ("gibbs", "true")):
        name = chip_smoke.SMEM3D_KERNELS[kind]
        assert chip_smoke.SWEEP_KERNELS[("smem3d", kind)] == name
        assert chip_smoke.names_kernel(sig.format(gibbs), name)
        other = "true" if gibbs == "false" else "false"
        assert not chip_smoke.names_kernel(sig.format(other), name)
        assert not chip_smoke.names_kernel("void smem_sweep_kernel<7, false>(SmemSweepParams)",
                                           name)


def test_library_builds_and_shared_header():
    """A source of its own with a stamps build, both in the parallel build;
    the slab helpers in one header the 3d visits include too."""
    assert "sor_sweep_smem3d" in common.SOURCES
    assert ("sor_sweep_smem3d", common.SWEEP_STAMPS_FLAGS) in common.STAMPS_BUILDS
    assert "slab3d.cuh" in common.HEADERS
    for name in ("sor_sweep_smem3d", "mgmc_visit_smem3d"):
        src = common.source_path(name).read_text()
        assert '#include "slab3d.cuh"' in src
        assert "__device__ __forceinline__ void ghost_copy(" not in src
    header = (CSRC / "slab3d.cuh").read_text()
    for fn in ("slab_of(", "slab_load(", "slab_store(", "smem_sync(", "ghost_copy("):
        assert fn in header
    assert common.library_path("sor_sweep_smem3d") != common.library_path(
        "sor_sweep_smem3d", common.SWEEP_STAMPS_FLAGS)


def test_launch_checks_on_the_cpu():
    """A launch takes CUDA tensors, the smem3d body only the 3d stencils it
    takes, and its stamps a row per block; nothing launches here and the
    wrappers take the plain versions on the CPU."""
    ss.reset_launch_counts()
    plan = _plan(7, "constant", "forward", dtype=torch.float32)
    x = torch.zeros((2,) + plan.op.vshape)
    with pytest.raises(ValueError, match="CUDA"):
        ss.launch_sweep(plan, ss.BLOCK_ROUTE, x[0], x.clone(), body="smem3d")
    box = SORSmoother(to_port(jgalerkin(_jax_op(15, "constant")), torch.float32), 1.0, 1).plan
    assert len(box.op.offsets) == 27
    with pytest.raises(ValueError, match="smem3d body takes"):
        ss._check_body("smem3d", box.op.vshape, box.op.offsets, ss.BLOCK_ROUTE, None, x)
    ss._check_body("smem3d", plan.op.vshape, plan.op.offsets, ss.BLOCK_ROUTE, None, x)
    stamps = torch.zeros((2, ss.SMEM3D_STAMP_WIDTH), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\(4, 13\)"):
        ss._check_body("smem3d", plan.op.vshape, plan.op.offsets, ss.BLOCK_ROUTE, stamps, x, 2)
    ss._check_body("smem3d", plan.op.vshape, plan.op.offsets, ss.BLOCK_ROUTE,
                   torch.zeros((4, 13), dtype=torch.int64), x, 2)
    out = ss.sweep_batched(plan, x[0], x.clone())
    assert out.shape == x.shape
    assert ss.launch_counts["sweep_batched_smem3d"] == 0
    assert ss.launch_counts["gibbs_sweep_batched_smem3d"] == 0
