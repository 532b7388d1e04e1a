"""The reach-1 level visits of two sweeps (SSOR) with each chain's field in
shared memory (the ``smem`` route's 5- and 9-point kernels of
``csrc/mgmc_visit_smem.cu``): their tables, a float64 replay of their schedule
against the plain visits and the interpreted JAX kernels with ``orders =
(forward, backward)``, the parameter block widened to the kernels' 25 offsets
and 9 colours, the layout's and the barriers' mirrors of the source, the
launchers' opt-in to dynamic shared memory and the route (CPU).

The levels are those of the flagship's posterior cut to a 32x32 and a 64x64
lattice: the shifted-Laplace FD level (5-point, 2 colours, stencil form 0)
and its Galerkin coarsening (the 3x3 box, 4 colours, form 2).  The replay is
the reach-2 kernels' (``test_torch_visit_reach2_smem.replay``): each rank's
band with a zero halo two deep, a row beyond a cut read from the neighbour's
band, the shares of ``B^T x`` summed in rank order, each coarse row restricted
by the owner of fine row ``2I + 1``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.ops.kernels.mgmc_visit_pallas import FusedVisitLevel as JFusedVisitLevel
from multigridmc_tpu.smoothers import SSORSmoother as JSSORSmoother

from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem as vsm
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import SORSmoother, SSORSmoother

from test_torch_common import jax_operator, to_port, tt
from test_torch_visit_reach2_smem import case_inputs, replay

GAMMA = 0.75
CSRC = Path(mv.__file__).resolve().parents[2] / "csrc"

#: (lattice, Galerkin, offsets, colours, stencil form): the 31^2 5-point
#: level, its 15^2 3x3-box coarsening, and the 63^2 level's 31^2 coarsening
#: (15^2: form 3, its diagonal a plane whose values agree in float32 to the
#: last bit)
LEVELS = {"31_5pt": (32, False, 5, 2, 0), "15_9pt": (32, True, 9, 4, 3),
          "31_9pt": (64, True, 9, 4, 2)}


def jax_level(nx, galerkin, dtype=jnp.float64):
    """The JAX package's flagship posterior (FD prior, four measurements) on an
    ``nx`` lattice, or its Galerkin coarsening."""
    a = jax_operator(nx, True, dtype=dtype)
    return jgalerkin(a) if galerkin else a


def ssor_level(op, omega=1.0):
    """The port's fused level of two sweeps a visit (forward then backward)."""
    orders, Bbar, coloring, _ = mv._sweep_spec(SSORSmoother(op, omega, 1))
    return mv.FusedVisitLevel(op, coloring, omega, orders, orders, Bbar, Bbar, GAMMA)


@pytest.fixture(scope="module")
def levels():
    return {name: ssor_level(to_port(jax_level(nx, gal)))
            for name, (nx, gal, _, _, _) in LEVELS.items()}


# ---------------------------------------------------------------------- tables
@pytest.mark.parametrize("name", sorted(LEVELS))
@pytest.mark.parametrize("S", [1, 2, 4])
def test_tables_hold_each_point_once_interior_first(levels, name, S):
    """Per direction and band every point of each colour exactly once, the
    first ``interior`` of a colour with every coefficient the interior value
    and no row beyond a cut, the rest not; each part dealt round the banks."""
    level = levels[name]
    _, _, offsets, colours, form = LEVELS[name]
    H, W = level.op.vshape
    assert (len(level.op.offsets), level.coloring.n_colors, level.reach) == (offsets, colours, 1)
    assert level.stencil_form == form and level.ndir == 2
    assert level.pre_orders[1] == tuple(reversed(level.pre_orders[0]))
    t = vsm.visit_tables(level, level.pre_orders, S)
    plan = vsm.interior_plan(level)
    PX = t["PX"]
    w0, w1 = (int(v) for v in level.coloring.weights[-2:])
    words = t["words"]
    for d, order in enumerate(level.pre_orders):
        for k, (u0, u1) in enumerate(mv.split_bands(H, S)):
            e = t["entries"][d][k]
            head = words[(d * S + k) * vsm.HEAD_INTS:(d * S + k + 1) * vsm.HEAD_INTS]
            seen = np.zeros(H * W, int)
            for o, col in enumerate(order):
                a, b = t["starts"][d][k][o], t["starts"][d][k][o + 1]
                assert words[head[o]:head[o + 1]].tolist() == e[a:b].astype(np.uint32).view(
                    np.int32).tolist()
                q, p = e[a:b] >> 16, e[a:b] & 0xFFFF
                i, j = p // W, p % W
                assert np.all((w0 * i + w1 * j) % colours == col)
                assert np.array_equal(q, (i - u0 + vsm.HALO) * PX + j + vsm.HALO)
                seen[p] += 1
                # a reach-1 stencil reads one row beyond its own
                cut = ((i - 1 >= 0) & (i - 1 < u0)) | ((i + 1 >= u1) & (i + 1 < H))
                npl = t["interior"][d][k][o]
                assert head[mv.WIDE_MAX_COLORS + 1 + o] == npl
                interior = plan["plain"][p] & ~cut
                assert interior[:npl].all() and not interior[npl:].any()
                for part in (q[:npl], q[npl:]):
                    assert ss.bank_conflicts(part, [0, part.size]) <= ss.bank_conflicts(
                        np.sort(part), [0, part.size])
            rows = np.arange(H * W) // W
            assert np.array_equal(seen, ((rows >= u0) & (rows < u1)).astype(int))


def test_interior_plan_of_the_flagship_levels(levels):
    """Zero-Dirichlet levels whose float32 coefficients are constant: every
    point interior (no plane varies, margin 0), also where the level's form
    counts a plane (15^2); the scalars are the centre point's coefficients,
    the diagonal the largest."""
    for name, level in levels.items():
        plan = vsm.interior_plan(level)
        assert plan["margin"] == 0 and plan["planes"] == 0 and plan["plain"].all()
        cval = plan["cval"]
        assert len(cval) == LEVELS[name][2]
        assert cval[level.op.diag_index] == cval.max() > 0


# ---------------------------------------------------------------------- replay
@pytest.mark.parametrize("name,S", [("31_5pt", 1), ("31_5pt", 2), ("31_5pt", 4),
                                    ("15_9pt", 1), ("15_9pt", 2), ("15_9pt", 4),
                                    ("31_9pt", 4)])
@pytest.mark.parametrize("noisy", [False, True], ids=["noise_off", "noise"])
def test_replay_of_two_sweeps_matches_the_plain_visits(levels, name, S, noisy):
    """The kernel's two-sweep schedule replayed in float64 (bands, reads across
    a cut, the shares of B^T x in rank order, each direction's Woodbury patch,
    the restriction by owner) against descend_visit_plain / ascend_visit_plain
    with two noise fields and 2 m low-rank normals, 1e-12."""
    level = levels[name]
    f, x, xc, xi, xi_lr = case_inputs(level, 23 + S, noisy)
    noise = (None, None) if not noisy else (tt(xi)[:, None], tt(xi_lr)[None])
    want_x, want_fc = mv.descend_visit_plain(level, tt(f), tt(x)[None], *noise)
    got_x, got_fc = replay(level, "descend", S, f, x, xi=xi, xi_lr=xi_lr)
    np.testing.assert_allclose(got_x, want_x[0].numpy(), rtol=1e-12, atol=1e-12)
    scale = max(1.0, float(np.abs(want_fc.numpy()).max()))
    np.testing.assert_allclose(got_fc, want_fc[0].numpy(), rtol=0, atol=1e-12 * scale)
    want = mv.ascend_visit_plain(level, tt(f), tt(x)[None], tt(xc)[None], *noise)
    got = replay(level, "ascend", S, f, x, xc=xc, xi=xi, xi_lr=xi_lr)
    np.testing.assert_allclose(got, want[0].numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,S", [("31_5pt", 2), ("15_9pt", 4)])
def test_replay_matches_the_interpreted_pallas_kernels(name, S):
    """The two-sweep schedule over bands against JAX's FusedVisitLevel with
    ``orders = (forward, backward)`` in interpret mode, as
    ``tests/test_torch_visit_ssor.py`` runs it (float32 kernels: x 2e-5, f_c
    2e-5 of max(|f_c|, 1)), noise off."""
    nx, gal, _, _, _ = LEVELS[name]
    a = jax_level(nx, gal, jnp.float32)
    jssor = JSSORSmoother(a, 1.0, 1)
    fw, bw = jssor.forward, jssor.backward
    Bbar = jnp.concatenate([fw.B_bar, bw.B_bar], axis=0)
    jfused = JFusedVisitLevel(a, fw.coloring, 1.0, (fw.order, bw.order), (fw.order, bw.order),
                              Bbar, Bbar, coarse_scaling=GAMMA, interpret=True)
    level = ssor_level(to_port(jax_level(nx, gal)))
    assert level.pre_orders == (tuple(fw.order), tuple(bw.order))
    f, x, xc, _, _ = case_inputs(level, 31, False)
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    jx, jfc = jfused.descend(jax.random.key(0), f32(f), f32(x)[None], noise=False)
    got_x, got_fc = replay(level, "descend", S, f, x)
    assert float(np.max(np.abs(got_x - np.asarray(jx)[0]))) < 2e-5
    scale = max(1.0, float(np.max(np.abs(np.asarray(jfc)))))
    assert float(np.max(np.abs(got_fc - np.asarray(jfc)[0]))) < 2e-5 * scale
    ja = jfused.ascend(jax.random.key(0), f32(f), f32(x)[None], f32(xc)[None], noise=False)
    got = replay(level, "ascend", S, f, x, xc=xc)
    assert float(np.max(np.abs(got - np.asarray(ja)[0]))) < 2e-5


# ------------------------------------------------------- the parameter block
def test_widen_copies_every_field(levels):
    """A reach-1 level's VisitParams widened field by field to the kernels'
    WideVisitParams: every field equal, the offsets and colours beyond 0; a
    reach-2 level's block as it is; the layout's block of both directions."""
    level = levels["15_9pt"]
    for d, order in enumerate(level.pre_orders):
        P = level._build_params(7, order, True, 1)
        P.seed, P.counter = 123, 45
        Q = vsm.widen(P)
        assert isinstance(P, mv.VisitParams) and isinstance(Q, mv.WideVisitParams)
        for name, _ in mv.VisitParams._fields_:
            got, want = getattr(Q, name), getattr(P, name)
            if isinstance(want, (int, float)):
                assert got == want, name
            elif name in ("bbox", "ybox"):
                assert [list(r) for r in got] == [list(r) for r in want], name
            else:
                assert list(got)[:len(want)] == list(want), name
                assert not any(list(got)[len(want):]), name
    wide = mv.WideVisitParams()
    assert vsm.widen(wide) is wide
    L = vsm.layout(level, level.pre_orders, S=2)
    P = L.params(level, 3, level.pre_orders, False, 2)
    assert P.ndir == 2 and P.S == 2 and P.PX == 15 + 4
    assert [P.v[d].n_order for d in (0, 1)] == [4, 4]
    assert list(P.v[1].order)[:4] == list(reversed(list(P.v[0].order)[:4]))
    assert list(P.soff)[:9] == [dy * 19 + dx for dy, dx in level.op.offsets]


# ------------------------------------------------------- mirrors of the source
@pytest.mark.parametrize("form,km", [(0, 5), (1, 5), (2, 9), (3, 9), (4, 9), (5, 9), (6, 13),
                                     (7, 13), (8, 25), (9, 25)])
def test_kernel_of_each_form_is_in_the_source(form, km):
    """Each 2d form's stencil size has an instance in the library's kernel
    table and in its attributes loop; a 3d form has none here."""
    src = (CSRC / "mgmc_visit_smem.cu").read_text()
    assert vsm.kmax(form) == km
    assert f"if (kmax == {km})" in src
    assert f"smem_visit_kernel<{km}, true, ST>" in src
    assert "const int sizes[4] = {5, 9, 13, 25};" in src
    with pytest.raises(ValueError):
        vsm.kmax(10)


def test_shared_memory_bytes_of_the_flagship_levels():
    """The mirror of mgmc_smem_visit_smem_bytes on the flagship's 255^2 and
    127^2 levels and the placement the rule gives them: 255^2 over two blocks of
    1024 threads (x alone: 136,752 bytes) or more; 127^2 in one block of 512
    threads, two an SM, c in device memory (133 KB with it); the tables' 16-bit
    indices hold both."""
    src = (CSRC / "mgmc_visit_smem.cu").read_text()
    assert ("(long long)(nb + 2 * SMEM_HALO) * PX + (c_shared ? (long long)nb * W : 0)"
            in src)

    class Shape:
        def __init__(self, H, form):
            from types import SimpleNamespace as NS

            self.op = NS(vshape=(H, H), device=torch.device("cpu"), m_lowrank=8)
            self.stencil_form = form

    big, small = Shape(255, 0), Shape(127, 2)
    assert vsm.smem_bytes(255, 255, 2, False) == 4 * 132 * 259 == 136752
    assert vsm.placement(big, 2) == (False, 1024) and vsm.placement(big, 4) == (False, 512)
    assert 1 not in vsm.candidates(big) and set(vsm.candidates(big)) == {2, 4, 8, 16}
    assert vsm.placement(small, 1) == (False, 512)
    assert vsm.smem_bytes(127, 127, 1, False) == 4 * 131 * 131 == 68644
    assert vsm.fits_indices(255, 255, 2) and vsm.fits_indices(127, 127, 1)


def test_barriers_from_the_source(levels):
    """barrier_count of the source's schedule at reach 1 with two sweeps: per
    direction the rhs, each colour (2 or 4) and the shares of B^T x, then a
    descend's 3 and an ascend's 2 (its copy-in, after its first rhs, and the
    corrected x); the pass names one a barrier, within the stamps' width."""
    for level in levels.values():
        K = level.coloring.n_colors
        assert vsm.barrier_count(level, "descend") == 2 * (1 + K + 1) + 3
        assert vsm.barrier_count(level, "ascend") == 2 * (1 + K + 1) + 2
        for kind in ("descend", "ascend"):
            names = vsm.pass_names(level, kind)
            assert len(names) == vsm.barrier_count(level, kind)
            assert len(names) + 1 + 3 <= vsm.STAMP_WIDTH
            assert names[-1 if kind == "ascend" else -3] == "Woodbury"
        assert vsm.pass_names(level, "ascend")[:2] == ["d0: rhs + copy-in", "d0: prolongation"]
        assert vsm.pass_names(level, "descend")[K + 2] == "d1: Woodbury + rhs"
    prior = ssor_level(to_port(jax_operator(32, False)))
    assert vsm.barrier_count(prior, "descend") == 2 * (1 + 2) + 3


# (the ids are the cases' first names, from when the smem bound read MAX_LOWRANK)
@pytest.mark.parametrize("source,bound,mirror", [
    ("mgmc_visit_smem.cu", "#define SMEM_STATIC_BOUND (4 * (LANE_SLOTS + 32 * LANE_SLOTS) + 16)",
     vsm.STATIC_SMEM),
    ("sor_sweep_smem.cu", "#define SMEM_STATIC_BOUND 16", ss.SMEM_STATIC_SMEM),
    ("mgmc_subtree.cu", "#define SUBTREE_STATIC_BOUND 4096", st.STATIC_SMEM_RESERVE),
], ids=["mgmc_visit_smem.cu-#define SMEM_STATIC_BOUND (4 * (MAX_LOWRANK + 32 * MAX_LOWRANK) + 16)"
        "-4240", "sor_sweep_smem.cu-#define SMEM_STATIC_BOUND 16-16",
        "mgmc_subtree.cu-#define SUBTREE_STATIC_BOUND 4096-4096"])
def test_launchers_opt_in_where_static_and_dynamic_pass_48k(source, bound, mirror):
    """The smem visit, the shared-memory sweep and the subtree launchers ask
    for their dynamic shared memory where that and their kernels' static share
    together exceed the 48 KiB a block gets unasked (the rule of
    mgmc_visit.cu's needs_opt_in), never by the dynamic bytes alone; the
    static bound is the host's mirror, which each library holds its kernels'
    declared static bytes to."""
    src = (CSRC / source).read_text()
    assert bound in src
    name = re.search(r"#define (\w+_STATIC_BOUND) (.+)", src)
    assert eval(name.group(2), {"LANE_SLOTS": mv.LANE_SLOTS}) == mirror
    assert f"return smem_bytes > 0 && smem_bytes + {name.group(1)} > 48 * 1024;" in src or (
        f"return bytes > 0 && bytes + {name.group(1)} > 48 * 1024;" in src)
    assert "> 48 * 1024)" not in src and "<= 48 * 1024)" not in src
    assert re.search(r"needs_opt_in\((smem_)?bytes\)", src)
    # a block of dynamic bytes just under 48 KiB needs the opt-in with its static share
    assert 48 * 1024 - 8 + mirror > 48 * 1024


# ----------------------------------------------------------------------- route
def test_route_takes_smem_for_two_sweeps_only_where_listed(levels):
    """visit_route: a 2d reach-1 level of two sweeps takes the smem kernels
    where SMEM_CHAINS lists its shape and form with the chain count in range,
    else as before (split up to SPLIT_MAX_CHAINS where a cluster fits, then
    phase); one sweep never takes them (its routes stay: stream from
    STREAM_MIN_CHAINS on the 255^2 5-point level); the levels here are not
    listed; the smem kernels take a reach-1 level a caller names them for."""
    cpu = torch.device("cpu")
    listed = {key: span for key, span in vsm.SMEM_CHAINS.items() if key[2] < mv.WIDE_FORM0}
    assert {key[:3] for key in listed} == {(255, 255, 0), (127, 127, 2)}
    assert all(key[3] == 2 for key in listed)
    for (H, W, form, ndir), (least, most) in listed.items():
        for C in (1, 4, 8, 9, 16, 64, 256):
            inside = C >= least and (most is None or C <= most)
            got = mv.visit_route(C, 0, cpu, vshape=(H, W), form=form, ndir=2)
            assert got == ("smem" if inside else "split" if C <= mv.SPLIT_MAX_CHAINS
                           else "phase"), (H, C)
            one = mv.visit_route(C, 0, cpu, vshape=(H, W), form=form, ndir=1)
            assert one != "smem"
            if (H, W, form) == (255, 255, 0) and C >= mv.STREAM_MIN_CHAINS[(255, 255, 0)]:
                assert one == "stream"
    for level in levels.values():
        assert {level.route(C) for C in (16, 256)} == {"phase"}
        assert mv.route_support_error(level, "smem", 2) is None
        for kind in ("descend", "ascend"):
            name = mv.kernel_name(level, "smem", kind)
            assert name == f"{kind}_visit_smem_ssor" and mv.launch_counts[name] == 0
            assert mv.launch_counts[f"{kind}_visit_smem"] == 0
    sor = SORSmoother(to_port(jax_operator(32, True)), 1.0, 1)
    one = mv.FusedVisitLevel(sor.op, sor.coloring, 1.0, sor.order, sor.order, sor.B_bar,
                             sor.B_bar, GAMMA)
    assert mv.route_support_error(one, "smem") is None
    assert mv.kernel_name(one, "smem", "descend") == "descend_visit_smem"
    assert mv.stamp_shape(one, "smem", 4, 2) == (8, vsm.STAMP_WIDTH)
