"""The 3d level visits with each chain's field in shared memory (the ``smem``
route of a 3d level, ``csrc/mgmc_visit_smem3d.cu``): their tables, a float64
replay of their schedule against the plain versions and the interpreted JAX
kernels, the layout's mirrors of the source, the barriers and stamps, and the
route (CPU).

The replay follows the kernel: each rank's slab of z-planes in padded planes
with a ghost plane a side (zero at the field's faces), the colours from the
tables (interior points with the scalar coefficients and the padded offsets,
edge points with the planes that vary), the neighbours' edge planes copied into
the ghost planes before each colour and the residual, the slabs'
shares of ``B^T x`` summed in rank order, the Woodbury patch per slab, the
residual per slab and each coarse plane restricted by the rank that owns fine
plane ``2I + 1``.  In float64 it agrees with ``descend_visit_plain`` /
``ascend_visit_plain`` to 1e-12.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridmc_tpu.ops.kernels.mgmc_visit_pallas import FusedVisitLevel as JFusedVisitLevel

from multigridmc_tpu_torch.ops.intergrid import prolongate_add
from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import SSORSmoother

from test_torch_common import tt
from test_torch_visit_3d import GAMMA, levels as volume_levels

CSRC = Path(mv.__file__).resolve().parents[2] / "csrc"

#: (lattice, level): the 15^3 7-point posterior (2 colours) and its 7^3
#: 27-point Galerkin level (8 colours), three measurements each
LEVELS = {"15_7pt": ((16, 16, 16), 0), "7_27pt": ((16, 16, 16), 1)}


@pytest.fixture(scope="module")
def levels():
    return {name: volume_levels(shape, lv, True)[3] for name, (shape, lv) in LEVELS.items()}


def ssor_level(level):
    """The same operator with two sweeps a visit (SSOR), both ways."""
    orders, Bbar, coloring, _ = mv._sweep_spec(SSORSmoother(level.op, 1.0, 1))
    return mv.FusedVisitLevel(level.op, coloring, 1.0, orders, orders, Bbar, Bbar, GAMMA)


# --------------------------------------------------------------------- replay
class Slabs:
    """The chain's field as the kernel holds it: per rank its slab of planes,
    each padded with a zero row and column a side, and a ghost plane a side
    (zero at the field's faces)."""

    def __init__(self, x, S):
        self.Z, self.Y, self.W = x.shape
        self.S, self.PX, self.PP = S, v3.pitch(self.W), v3.plane(self.Y, self.W)
        self.slabs = v3.slabs(self.Z, S)
        self.xs = []
        for z0, z1 in self.slabs:
            pad = np.zeros((z1 - z0 + 2, self.Y + 2, self.PX))
            pad[1:-1, 1:-1, 1:-1] = x[z0:z1]
            self.xs.append(pad.reshape(-1))

    def nz(self, k):
        return self.slabs[k][1] - self.slabs[k][0]

    def ghost_copy(self):
        """The neighbours' edge planes into the ghost planes (ghost_copy)."""
        for k in range(self.S):
            if k > 0:
                self.xs[k][:self.PP] = self.xs[k - 1][self.nz(k - 1) * self.PP:
                                                      (self.nz(k - 1) + 1) * self.PP]
            if k + 1 < self.S:
                self.xs[k][(self.nz(k) + 1) * self.PP:] = self.xs[k + 1][self.PP:2 * self.PP]

    def read(self, k, lz, y, j):
        """x at slab plane(s) ``lz`` of rank ``k``, row ``y``, column ``j`` (the
        halo and the ghost planes included)."""
        return self.xs[k][(np.asarray(lz) + 1) * self.PP + (np.asarray(y) + 1) * self.PX
                          + np.asarray(j) + 1]

    def field(self):
        return np.concatenate([xs.reshape(-1, self.Y + 2, self.PX)[1:-1, 1:-1, 1:-1]
                               for xs in self.xs])


def edge_ax(level, sl, plan, coeffs, k, lz, y, j, p):
    """``edge_ax`` of the source: the planes that vary, the terms in offset
    order."""
    ax = np.zeros(np.shape(p))
    for kk, (dz, dy, dx) in enumerate(level.op.offsets):
        a = coeffs[kk, p] if (plan["planes"] >> kk) & 1 else plan["cval64"][kk]
        ax = ax + a * sl.read(k, lz + dz, y + dy, j + dx)
    return ax


def plain_ax(level, sl, plan, k, q):
    ax = np.zeros(np.shape(q))
    for kk, (dz, dy, dx) in enumerate(level.op.offsets):
        ax = ax + plan["cval64"][kk] * sl.xs[k][q + dz * sl.PP + dy * sl.PX + dx]
    return ax


def replay(level, kind, S, f, x, xc=None, xi=None, xi_lr=None):
    """One visit of one chain as the 3d smem kernels schedule it, float64:
    returns ``x`` (and ``f_c`` for a descend)."""
    op, m = level.op, level.op.m_lowrank
    Z, Y, W = op.vshape
    n, K, n2 = Z * Y * W, len(op.offsets), Y * W
    ghost = S > 1
    orders = level.orders(kind)
    coeffs = level.coeffs.numpy().reshape(K, n)
    ns = level.noise_scale.numpy().reshape(-1)
    tabs = v3.visit_tables(level, orders, S)
    centre = ((Z // 2) * Y + Y // 2) * W + W // 2
    plan = dict(tabs, cval64=coeffs[:, centre])
    if xc is not None:  # the prolongation, before the first rhs
        x = prolongate_add(level.coarse_scaling, torch.as_tensor(xc)[None],
                           torch.zeros((1, Z, Y, W), dtype=torch.float64), dim=3)[0].numpy() + x
    sl = Slabs(x, S)
    t = None
    for d, order in enumerate(orders):
        c = f.reshape(-1) + (0 if xi is None else ns * xi[d].reshape(-1))
        for o in range(len(order)):
            if ghost:
                sl.ghost_copy()
            updates = []
            for k, (z0, _) in enumerate(sl.slabs):
                start, stop = tabs["starts"][d][k][o], tabs["starts"][d][k][o + 1]
                e = tabs["entries"][d][k][start:stop]
                q, p = e >> 16, z0 * n2 + (e & 0xFFFF)
                plain = np.arange(stop - start) < tabs["interior"][d][k][o]
                ax = np.zeros(p.size)
                ax[plain] = plain_ax(level, sl, plan, k, q[plain])
                pe = p[~plain]
                ax[~plain] = edge_ax(level, sl, plan, coeffs, k, pe // n2 - z0, pe % n2 // W,
                                     pe % W, pe)
                dv = coeffs[op.diag_index, p]
                updates.append((k, q, sl.xs[k][q] + level.omega * (c[p] - ax) / dv))
            for k, q, v in updates:  # no point of a colour reads another
                sl.xs[k][q] = v
        if m:
            B = level.B.numpy().reshape(m, n)
            Yf, Wm, _ = level._woodbury[order]
            Yf = Yf.numpy().reshape(m, n)
            field = sl.field().reshape(-1)
            shares = [field[z0 * n2:z1 * n2] @ B[:, z0 * n2:z1 * n2].T for z0, z1 in sl.slabs]
            bt = np.zeros(m)
            for share in shares:  # rank order
                bt = bt + share
            nk = np.zeros(m) if xi_lr is None else xi_lr[d * m:(d + 1) * m]
            sk = level.sigma_sqrt.numpy()
            u = Wm.numpy() @ (bt - sk * nk)
            t = u + nk / sk
            for k, (z0, z1) in enumerate(sl.slabs):
                patch = (u @ Yf[:, z0 * n2:z1 * n2]).reshape(z1 - z0, Y, W)
                view = sl.xs[k].reshape(-1, Y + 2, sl.PX)
                view[1:-1, 1:-1, 1:-1] -= patch
    xout = sl.field()
    if kind == "ascend":
        return xout
    # the residual per slab (c's place), then each coarse plane by its owner
    if ghost:
        sl.ghost_copy()
    r = np.empty(n)
    mg = tabs["margin"]
    jj = np.arange(W)
    for k, (z0, z1) in enumerate(sl.slabs):
        for lz in range(z1 - z0):
            z = z0 + lz
            for y in range(Y):
                row_plain = mg <= z < Z - mg and mg <= y < Y - mg
                p = (z * Y + y) * W + jj
                plainj = row_plain & (jj >= mg) & (jj < W - mg)
                ax = np.empty(W)
                q = ((lz + 1) * (Y + 2) + y + 1) * sl.PX + jj[plainj] + 1
                ax[plainj] = plain_ax(level, sl, plan, k, q)
                ax[~plainj] = edge_ax(level, sl, plan, coeffs, k, lz, y, jj[~plainj],
                                      p[~plainj])
                r[p] = f.reshape(-1)[p] - ax
    if m:
        r = r - t @ level.B.numpy().reshape(m, n)
    r = r.reshape(Z, Y, W)
    fc = np.full(level.vc, np.nan)
    w = np.array([0.5, 1.0, 0.5])
    for z0, z1 in sl.slabs:
        for I in range(z0 // 2, min(z1 // 2, level.vc[0])):
            assert z0 <= 2 * I + 1 < z1
            for J in range(level.vc[1]):
                fc[I, J] = [np.einsum("c,a,b,cab->", w, w, w,
                                      r[2 * I:2 * I + 3, 2 * J:2 * J + 3, 2 * L:2 * L + 3])
                            for L in range(level.vc[2])]
    return xout, fc


def case_inputs(level, seed, noisy):
    rng = np.random.default_rng(seed)
    vshape, m, nd = level.op.vshape, level.op.m_lowrank, level.ndir
    f, x = rng.normal(size=vshape), rng.normal(size=vshape)
    xc = rng.normal(size=level.vc)
    xi = rng.normal(size=(nd,) + vshape) if noisy else None
    xi_lr = rng.normal(size=nd * m) if noisy else None
    return f, x, xc, xi, xi_lr


def check_replay(level, S, seed, noisy):
    """Both replays against the plain versions (1e-12; ``f_c`` of its scale)."""
    f, x, xc, xi, xi_lr = case_inputs(level, seed, noisy)
    one = level.ndir == 1
    noise = (None if xi is None else (tt(xi[0])[None] if one else tt(xi)[:, None]),
             None if xi_lr is None else tt(xi_lr)[None])
    want_x, want_fc = mv.descend_visit_plain(level, tt(f), tt(x)[None], *noise)
    got_x, got_fc = replay(level, "descend", S, f, x, xi=xi, xi_lr=xi_lr)
    np.testing.assert_allclose(got_x, want_x[0].numpy(), rtol=1e-12, atol=1e-12)
    scale = max(1.0, float(np.abs(want_fc.numpy()).max()))
    np.testing.assert_allclose(got_fc, want_fc[0].numpy(), rtol=0, atol=1e-12 * scale)
    want = mv.ascend_visit_plain(level, tt(f), tt(x)[None], tt(xc)[None], *noise)
    got = replay(level, "ascend", S, f, x, xc=xc, xi=xi, xi_lr=xi_lr)
    np.testing.assert_allclose(got, want[0].numpy(), rtol=1e-12, atol=1e-12)
    assert np.abs(got - x).max() > 1e-3


# ---------------------------------------------------------------------- tables
@pytest.mark.parametrize("name", sorted(LEVELS))
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_slab_tables_hold_each_point_once_interior_first(levels, name, S):
    """Per order and slab every point of each colour exactly once; the first
    ``plain`` of a colour interior (coefficients equal to ``coeff_val``: a
    plane beyond a cut lies in a ghost plane), the rest not; the entries'
    padded and slab indices; each part dealt round the banks."""
    level = levels[name]
    Z, Y, W = level.op.vshape
    orders = (level.pre_order, level.post_order)
    t = v3.visit_tables(level, orders, S)
    PX, PP = t["PX"], t["PP"]
    assert (PX, PP) == (W + 2, (Y + 2) * (W + 2))
    wz, w0, w1 = (int(v) for v in level.coloring.weights)
    K = level.coloring.n_colors
    plan = v3.interior_plan(level)
    P = level._build_params(1, level.pre_order, False, 0)
    for k in range(len(level.op.offsets)):
        if P.coeff_const[k]:
            assert np.float32(P.coeff_val[k]) == t["cval"][k]
    words = t["words"]
    for d, order in enumerate(orders):
        for k, (z0, z1) in enumerate(v3.slabs(Z, S)):
            e = t["entries"][d][k]
            head = words[(d * S + k) * v3.HEAD_INTS:(d * S + k + 1) * v3.HEAD_INTS]
            assert e.size == (z1 - z0) * Y * W
            seen = np.zeros(Z * Y * W, int)
            for o, col in enumerate(order):
                a, b = t["starts"][d][k][o], t["starts"][d][k][o + 1]
                assert words[head[o]:head[o + 1]].tolist() == (e[a:b] & 0xFFFFFFFF).astype(
                    np.uint32).view(np.int32).tolist()
                assert head[mv.MAX_COLORS + 1 + o] == t["interior"][d][k][o]
                q, p = e[a:b] >> 16, z0 * Y * W + (e[a:b] & 0xFFFF)
                z, y, j = p // (Y * W), p // W % Y, p % W
                assert np.all((wz * z + w0 * y + w1 * j) % K == col)
                assert np.all((z >= z0) & (z < z1))
                assert np.array_equal(q, ((z - z0 + 1) * (Y + 2) + y + 1) * PX + j + 1)
                seen[p] += 1
                interior = plan["plain"][p]
                npl = t["interior"][d][k][o]
                assert interior[:npl].all() and not interior[npl:].any()
                for part in (q[:npl], q[npl:]):  # each part dealt round the banks
                    assert ss.bank_conflicts(part, [0, part.size]) <= ss.bank_conflicts(
                        np.sort(part), [0, part.size])
            planes = np.arange(Z * Y * W) // (Y * W)
            assert np.array_equal(seen, ((planes >= z0) & (planes < z1)).astype(int))
            assert max(e >> 16) < (z1 - z0 + 2) * PP <= v3.INDEX_LIMIT
    # the 64^3 posterior's levels fit the 16-bit entries where their slabs fit a block
    assert v3.fits_indices(63, 63, 63, 8) and not v3.fits_indices(63, 63, 63, 4)
    assert v3.fits_indices(31, 31, 31, 1)


# ---------------------------------------------------------------------- replay
@pytest.mark.parametrize("name,S", [("15_7pt", 1), ("15_7pt", 2), ("15_7pt", 4), ("15_7pt", 3),
                                    ("15_7pt", 15), ("7_27pt", 1), ("7_27pt", 3),
                                    ("7_27pt", 2)])
@pytest.mark.parametrize("noisy", [False, True], ids=["noise_off", "noise"])
def test_replay_of_the_slab_schedule_matches_the_plain_visits(levels, name, S, noisy):
    """The kernel's schedule replayed in float64 (slabs, the ghost copy
    across a cut, the shares of B^T x in rank order, the restriction by
    owner; 15 planes over 2 and 4 and 7 over 3 are uneven cuts, 15 over 15 a
    plane a slab) against descend_visit_plain / ascend_visit_plain, 1e-12."""
    check_replay(levels[name], S, 3 + S, noisy)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_replay_of_two_sweeps_matches_the_plain_visits(levels, S):
    """Two sweeps a visit (SSOR, forward then backward, each with its tables
    and its noise) on both levels."""
    for level in levels.values():
        level = ssor_level(level)
        assert level.ndir == 2
        check_replay(level, S, 17 + S, True)


def test_replay_matches_the_interpreted_pallas_kernels():
    """The schedule over two slabs (ghost copy) against JAX's FusedVisitLevel
    in interpret mode on a 7^3 7-point posterior, noise off (float32 kernels:
    x 2e-5, f_c 2e-5 of max(|f_c|, 1))."""
    a, jpre, jpost, _ = volume_levels((8, 8, 8), 0, True, torch.float32)
    level = volume_levels((8, 8, 8), 0, True)[3]
    jfused = JFusedVisitLevel(a, jpre.coloring, 1.0, jpre.order, jpost.order, jpre.B_bar,
                              jpost.B_bar, coarse_scaling=GAMMA, interpret=True)
    f, x, xc, _, _ = case_inputs(level, 9, False)
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    jx, jfc = jfused.descend(jax.random.key(0), f32(f), f32(x)[None], noise=False)
    got_x, got_fc = replay(level, "descend", 2, f, x)
    assert float(np.max(np.abs(got_x - np.asarray(jx)[0]))) < 2e-5
    scale = max(1.0, float(np.max(np.abs(np.asarray(jfc)))))
    assert float(np.max(np.abs(got_fc - np.asarray(jfc)[0]))) < 2e-5 * scale
    ja = jfused.ascend(jax.random.key(0), f32(f), f32(x)[None], f32(xc)[None], noise=False)
    got = replay(level, "ascend", 2, f, x, xc=xc)
    assert float(np.max(np.abs(got - np.asarray(ja)[0]))) < 2e-5


# ------------------------------------------------------- mirrors of the source
def test_shared_memory_bytes_mirror_the_source():
    src = (CSRC / "mgmc_visit_smem3d.cu").read_text()
    assert f"#define SMEM_MAX_CLUSTER {v3.MAX_CLUSTER}" in src
    assert ("(long long)(nz + 2) * PP + (c_shared ? (long long)nz * Y * W : 0)" in src)
    assert "Z / S < 1" in src and "PP < (Y + 2) * (W + 2)" in src
    # the 64^3 posterior's levels: 63^3 over 16 blocks with c, over 8 without;
    # 31^3 in one block without c, over 2 and 4 with it
    assert v3.smem_bytes(63, 63, 63, 16, True) == 4 * (6 * 65 * 65 + 4 * 63 * 63) == 164904
    assert v3.smem_bytes(63, 63, 63, 8, False) == 4 * 10 * 65 * 65 == 169000
    assert v3.smem_bytes(31, 31, 31, 1, False) == 4 * 33 * 33 * 33 == 143748
    assert v3.smem_bytes(31, 31, 31, 4, True) == 4 * (10 * 33 * 33 + 8 * 31 * 31)
    with pytest.raises(ValueError):
        v3.smem_bytes(63, 63, 63, 17, False)
    with pytest.raises(ValueError):
        v3.smem_bytes(3, 5, 5, 4, False)
    assert re.search(r"#define SMEM_HEAD_INTS \(2 \* MAX_COLORS \+ 1\)", src)
    assert v3.HEAD_INTS == 2 * 8 + 1
    # the static part holds LANE_SLOTS measurements; a level of more keeps
    # its low-rank scratch after the slab, sized by its m
    assert "__shared__ float s_part[LANE_SLOTS];" in src
    assert "__shared__ float s_wv[32 * LANE_SLOTS];" in src
    assert v3.STATIC_SMEM == 4 * (32 + 32 * 32) + 16
    assert "4 * lowrank_scratch_floats(P->m, threads)" in src
    struct = src[src.index("struct SmemVolumeParams {"):src.index("};", src.index(
        "struct SmemVolumeParams {"))]
    names = re.findall(r"\b(\w+)(?:\[\w+\])?;", struct)
    assert names == [name for name, _ in v3.SmemVolumeParams._fields_]
    assert "#define VISIT_DIM 3" in src and "#define MAX_OFFSETS 27" in src


def test_barriers_and_stamps_from_the_source(levels):
    """The kernel's barriers, counted from the source's smem_sync calls by
    where they stand, against barrier_count (an ascend's copy-in; per
    direction the rhs, each colour, the shares of B^T x; a descend 3, an
    ascend 1; a ghost copy's block barrier not counted); both 3d stamps builds
    (the phase kernels' 3d build and the smem kernels'), their widths and pass
    names."""
    src = (CSRC / "mgmc_visit_smem3d.cu").read_text()
    body = src[src.index("smem_volume_kernel(const"):src.index("stamps_close<STAMPS>(srow, SMEM")]
    loop = body[body.index("for (int d = 0; d < SP.ndir; ++d)"):body.index(
        "// every slab corrected")]
    colours = loop[loop.index("for (int o = 0; o < P.n_order; ++o)"):loop.index("// 4. Woodbury")]
    descend = body[body.index("if (DESCEND) {\n        // 5."):]
    calls = lambda s: s.count("smem_sync<STAMPS>(")  # noqa: E731
    assert calls(body) == 7 and calls(loop) == 3 and calls(colours) == 1 and calls(descend) == 2
    assert colours.count("ghost_copy(") == 1 and descend.count("ghost_copy(") == 1
    copy_in = body[:body.index("for (int d = 0; d < SP.ndir; ++d)")]
    assert "if (!DESCEND) {" in copy_in and calls(copy_in) == 1
    assert ("#define SMEM_STAMP_WIDTH (1 + 1 + MAX_DIRS * (MAX_COLORS + 2) + 3 + 3)" in src)
    assert v3.STAMP_WIDTH == 28
    for level in list(levels.values()) + [ssor_level(levels["15_7pt"])]:
        assert level.op.m_lowrank > 0
        for kind in ("descend", "ascend"):
            per_dir = sum(1 + len(o) + 1 for o in level.orders(kind))
            assert v3.barrier_count(level, kind) == per_dir + (3 if kind == "descend" else 2)
            names = v3.pass_names(level, kind)
            assert len(names) == v3.barrier_count(level, kind)
            assert len(names) + 1 + 3 <= v3.STAMP_WIDTH
            assert len(mv.pass_names(level, kind)) == mv.phase_barrier_count(level, kind)
            assert len(mv.pass_names(level, kind)) + 1 + 3 <= mv.PHASE_STAMP_WIDTH
    assert ("mgmc_visit", common.PHASE_DIM3_STAMPS_FLAGS) in common.STAMPS_BUILDS
    assert ("mgmc_visit_smem3d", common.SMEM_VISIT_STAMPS_FLAGS) in common.STAMPS_BUILDS
    assert "mgmc_visit_smem3d" in common.SOURCES
    assert common.PHASE_DIM3_STAMPS_FLAGS == ("-DVISIT_DIM=3", "-DPHASE_STAMPS_BUILD=1")
    level = levels["7_27pt"]
    assert mv.stamp_shape(level, "phase", 32) == (32, mv.PHASE_STAMP_WIDTH)
    assert mv.stamp_shape(level, "smem", 32, 4) == (128, v3.STAMP_WIDTH)
    assert v3.pass_names(level, "descend") == (
        ["copy-in + rhs"] + [f"colour {c}" for c in level.pre_order]
        + ["B^T x shares", "Woodbury", "write-back + residual", "restriction"])
    with pytest.raises(ValueError, match="stamps build"):
        mv.stamp_shape(level, "split", 1)


# ----------------------------------------------------------------------- route
@pytest.mark.parametrize("chains", [1, 32, 128])
def test_route_at_1_32_and_128_chains_follows_the_table(levels, chains):
    """The rule before any level is built (visit_route on the shape, form and
    sweeps: the 64^3 posterior's levels take the smem kernels where
    SMEM3D_ROUTES lists the count, with its launch configuration; every other
    3d shape the phase kernels); a level the table does not list takes the
    phase kernels; the smem route takes 3d levels, and a 2d reach-1 level takes
    the 2d smem kernels where a caller names them."""
    cpu = torch.device("cpu")
    for (Z, Y, W, form, ndir), rows in v3.SMEM3D_ROUTES.items():
        conf = v3.route_config((Z, Y, W), form, ndir, chains)
        want = [row[2:] for row in rows if chains >= row[0] and (row[1] is None
                                                                  or chains <= row[1])]
        assert (conf is None and not want) or (conf == want[0])
        route = mv.visit_route(chains, 0, cpu, vshape=(Z, Y, W), form=form, ndir=ndir)
        assert route == ("smem" if want else "phase")
        if want:
            S, c_shared, threads = want[0]
            assert v3.smem_bytes(Z, Y, W, S, c_shared) + v3.STATIC_SMEM <= ss.CPU_SMEM_LIMIT
            assert v3.fits_indices(Z, Y, W, S) and 32 <= threads <= v3.MAX_THREADS
    assert mv.visit_route(chains, 0, cpu, vshape=(15, 15, 15), form=10) == "phase"
    for level in levels.values():  # shapes the table does not list
        assert level.route(chains) == "phase" and level.split_cluster(chains) is None
        assert mv.route_support_error(level, "smem") is None
        for kind in ("descend", "ascend"):
            wide = "27" if level.stencil_form >= 12 else "7"
            assert mv.kernel_name(level, "smem", kind) == f"{kind}_visit_3d_{wide}pt_smem"
            assert mv.launch_counts[f"{kind}_visit_3d_{wide}pt_smem"] == 0
        # an unlisted shape: no cluster size unless a launch names one, then
        # the placement's c and block size
        assert v3.smem_cluster(level, chains) is None
        with pytest.raises(ValueError, match="name the cluster size"):
            v3.layout(level, level.pre_orders, C=chains)
        L = v3.layout(level, level.pre_orders, S=2, C=chains)
        assert (L.c_shared, L.threads) == v3.placement(level, 2)
        assert L.nbytes == v3.smem_bytes(*level.op.vshape, 2, L.c_shared)
    from test_torch_visit_split import _small_level

    # a 2d reach-1 level takes the 2d smem kernels where a caller names them
    assert mv.route_support_error(_small_level(), "smem") is None
    assert mv.smem_module(_small_level()).__name__.endswith(".mgmc_visit_smem")


def test_phase_launch_opts_in_where_static_and_dynamic_pass_48k():
    """The phase kernels' launcher asks for its dynamic shared memory where
    that and the kernels' static share together exceed the 48 KiB a block
    gets unasked (the 64^3 posterior's 15^3 level: 46,400 bytes of tables
    beside 20,608 static failed to launch as the first launch of its kernel);
    the 3d smem kernels ask at every launch."""
    src = (CSRC / "mgmc_visit.cu").read_text()
    assert ("#define PHASE_STATIC_BOUND (4 * (LANE_SLOTS + 32 * LANE_SLOTS + 32 * 128) + 16)"
            in src)
    assert mv.PHASE_STATIC_SMEM == 4 * (32 + 32 * 32 + 32 * 128) + 16
    assert "return smem_bytes > 0 && smem_bytes + PHASE_STATIC_BOUND > 48 * 1024;" in src
    assert src.count("needs_opt_in(smem_bytes)") == 2 and "smem_bytes > 48 * 1024" not in src
    assert 46400 + mv.PHASE_STATIC_SMEM > 48 * 1024 >= 46400
    smem = (CSRC / "mgmc_visit_smem3d.cu").read_text()
    assert "bytes > 48 * 1024" not in smem
