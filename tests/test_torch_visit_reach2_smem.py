"""The reach-2 level visits with each chain's field in shared memory (the
``smem`` route, ``csrc/mgmc_visit_smem.cu``): their tables, a float64 replay
of their schedule against the plain versions and the interpreted JAX kernels,
the layout's mirrors of the source, the barriers and stamps, and the route
(CPU).

The replay follows the kernel: each rank's band of rows with a zero halo two
deep, the colours from the tables (interior points with the scalar
coefficients, edge points with the planes and the rows beyond a cut from the
neighbour's band), the bands' shares of ``B^T x`` summed in rank order, the
Woodbury patch per band, the residual per band and each coarse row restricted
by the rank that owns fine row ``2I + 1``.  In float64 it agrees with
``descend_visit_plain`` / ``ascend_visit_plain`` to 1e-12.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConst
from multigridmc_tpu.models.posterior import measured_operator as jmeasured
from multigridmc_tpu.models.prior import squared_shiftedlaplace_fd as jsquared
from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.ops.coloring import coloring_for as jcoloring_for
from multigridmc_tpu.ops.kernels.mgmc_visit_pallas import FusedVisitLevel as JFusedVisitLevel
from multigridmc_tpu.smoothers import BACKWARD, FORWARD
from multigridmc_tpu.smoothers import SORSmoother as JSORSmoother

from multigridmc_tpu_torch.ops.intergrid import prolongate_add
from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem as vsm
from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import SORSmoother, SSORSmoother

from test_torch_common import measurement_params, to_port, tt

GAMMA = 0.75
CSRC = Path(mv.__file__).resolve().parents[2] / "csrc"
HALO = vsm.HALO


def jax_level(nx, galerkin, dtype=jnp.float64):
    """The JAX squared-FD posterior on an ``nx`` lattice (4 measurements), or
    its Galerkin coarsening (the 5x5 box, 9 colours)."""
    a = jmeasured(jsquared(JLattice((nx, nx)), JConst(0.3), dtype=dtype), measurement_params(4, 5))
    return jgalerkin(a) if galerkin else a


def port_level(a, ssor=False, dtype=torch.float64):
    """The port's fused level of a JAX operator: SOR forward / backward, or two
    sweeps (SSOR) each way."""
    b = to_port(a, dtype)
    if ssor:
        orders, Bbar, coloring, _ = mv._sweep_spec(SSORSmoother(b, 1.0, 1))
        return mv.FusedVisitLevel(b, coloring, 1.0, orders, orders, Bbar, Bbar, GAMMA)
    pre, post = SORSmoother(b, 1.0, 1, FORWARD), SORSmoother(b, 1.0, 1, BACKWARD)
    return mv.FusedVisitLevel(b, pre.coloring, 1.0, pre.order, post.order, pre.B_bar,
                              post.B_bar, GAMMA)


# (lattice, Galerkin, offsets, colours): 31^2 13-point, 15^2 and 31^2 25-point
LEVELS = {"31_13pt": (32, False, 13, 5), "15_25pt": (32, True, 25, 9),
          "31_25pt": (64, True, 25, 9)}


@pytest.fixture(scope="module")
def levels():
    return {name: port_level(jax_level(nx, gal)) for name, (nx, gal, _, _) in LEVELS.items()}


# --------------------------------------------------------------------- replay
class Bands:
    """The chain's field as the kernel holds it: per rank its band of rows in
    padded rows of ``W + 4`` (two zero columns a side, two rows a side that
    are zero on the field's edge and never read at a cut)."""

    def __init__(self, x, S):
        self.H, self.W = x.shape
        self.S, self.PX = S, vsm.pitch(self.W)
        self.bands = mv.split_bands(self.H, S)
        self.xs = []
        for u0, u1 in self.bands:
            pad = np.zeros((u1 - u0 + 2 * HALO, self.PX))
            pad[HALO:HALO + u1 - u0, HALO:HALO + self.W] = x[u0:u1]
            self.xs.append(pad.reshape(-1))

    def read(self, k, r, j):
        """x at band row(s) ``r`` of rank ``k``, column(s) ``j`` (the halo
        included): a row beyond a cut from the neighbour's band."""
        nb = [u1 - u0 for u0, u1 in self.bands]
        r, j = np.broadcast_arrays(np.asarray(r), np.asarray(j))
        out = np.empty(r.shape)
        lo = (r < 0) & (k > 0)
        hi = (r >= nb[k]) & (k + 1 < self.S)
        own = ~(lo | hi)
        out[own] = self.xs[k][(r[own] + HALO) * self.PX + j[own] + HALO]
        if lo.any():
            out[lo] = self.xs[k - 1][(r[lo] + nb[k - 1] + HALO) * self.PX + j[lo] + HALO]
        if hi.any():
            out[hi] = self.xs[k + 1][(r[hi] - nb[k] + HALO) * self.PX + j[hi] + HALO]
        return out

    def field(self):
        return np.concatenate([xs.reshape(-1, self.PX)[HALO:-HALO, HALO:HALO + self.W]
                               for xs in self.xs])


def edge_ax(level, bands, plan, coeffs, k, lr, j, p):
    """``edge_ax`` of the source: the planes that vary, the terms in offset
    order, a row beyond a cut from the neighbour."""
    ax = np.zeros(np.shape(p))
    for kk, (dy, dx) in enumerate(level.op.offsets):
        a = coeffs[kk, p] if (plan["planes"] >> kk) & 1 else plan["cval64"][kk]
        ax = ax + a * bands.read(k, lr + dy, j + dx)
    return ax


def plain_ax(level, bands, plan, k, q):
    ax = np.zeros(np.shape(q))
    for kk, (dy, dx) in enumerate(level.op.offsets):
        ax = ax + plan["cval64"][kk] * bands.xs[k][q + dy * bands.PX + dx]
    return ax


def replay(level, kind, S, f, x, xc=None, xi=None, xi_lr=None):
    """One visit of one chain as the smem kernels schedule it, float64:
    returns ``x`` (and ``f_c`` for a descend)."""
    op, m = level.op, level.op.m_lowrank
    H, W = op.vshape
    n, K = H * W, len(op.offsets)
    orders = level.orders(kind)
    coeffs = level.coeffs.numpy().reshape(K, n)
    ns = level.noise_scale.numpy().reshape(-1)
    tabs = vsm.visit_tables(level, orders, S)
    plan = dict(tabs, cval64=coeffs[:, (H // 2) * W + W // 2])
    if xc is not None:  # the prolongation, before the first rhs
        x = prolongate_add(level.coarse_scaling, torch.as_tensor(xc)[None],
                           torch.zeros((1, H, W), dtype=torch.float64), dim=2)[0].numpy() + x
    bands = Bands(x, S)
    u = t = None
    for d, order in enumerate(orders):
        c = f.reshape(-1) + (0 if xi is None else ns * xi[d].reshape(-1))
        for o in range(len(order)):
            updates = []
            for k, (u0, _) in enumerate(bands.bands):
                start, stop = tabs["starts"][d][k][o], tabs["starts"][d][k][o + 1]
                e = tabs["entries"][d][k][start:stop]
                q, p = e >> 16, e & 0xFFFF
                plain = np.arange(stop - start) < tabs["interior"][d][k][o]
                ax = np.zeros(p.size)
                ax[plain] = plain_ax(level, bands, plan, k, q[plain])
                pe = p[~plain]
                ax[~plain] = edge_ax(level, bands, plan, coeffs, k, pe // W - u0, pe % W, pe)
                dv = coeffs[op.diag_index, p]
                updates.append((k, q, bands.xs[k][q] + level.omega * (c[p] - ax) / dv))
            for k, q, v in updates:  # no point of a colour reads another
                bands.xs[k][q] = v
        if m:
            B = level.B.numpy().reshape(m, n)
            Y, Wm, _ = level._woodbury[order]
            Y = Y.numpy().reshape(m, n)
            shares = [bands.field()[u0:u1].reshape(-1) @ B[:, u0 * W:u1 * W].T
                      for u0, u1 in bands.bands]
            bt = np.zeros(m)
            for share in shares:  # rank order
                bt = bt + share
            nk = np.zeros(m) if xi_lr is None else xi_lr[d * m:(d + 1) * m]
            sk = level.sigma_sqrt.numpy()
            u = Wm.numpy() @ (bt - sk * nk)
            t = u + nk / sk
            for k, (u0, u1) in enumerate(bands.bands):
                patch = (u @ Y[:, u0 * W:u1 * W]).reshape(u1 - u0, W)
                view = bands.xs[k].reshape(-1, bands.PX)
                view[HALO:HALO + u1 - u0, HALO:HALO + W] -= patch
    xout = bands.field()
    if kind == "ascend":
        return xout
    # the residual per band (c's place), then each coarse row by its owner
    r = np.empty(n)
    mg = tabs["margin"]
    for k, (u0, u1) in enumerate(bands.bands):
        for lr in range(u1 - u0):
            i = u0 + lr
            row_plain = mg <= i < H - mg and not (k > 0 and lr < HALO) and not (
                k + 1 < S and lr >= u1 - u0 - HALO)
            j = np.arange(W)
            p = i * W + j
            plainj = row_plain & (j >= mg) & (j < W - mg)
            ax = np.empty(W)
            ax[plainj] = plain_ax(level, bands, plan, k, (lr + HALO) * bands.PX + j[plainj] + HALO)
            ax[~plainj] = edge_ax(level, bands, plan, coeffs, k, lr, j[~plainj], p[~plainj])
            r[p] = f.reshape(-1)[p] - ax
    if m:
        r = r - t @ level.B.numpy().reshape(m, n)
    r = r.reshape(H, W)
    Hc, Wc = H // 2, W // 2
    fc = np.full((Hc, Wc), np.nan)
    w = np.array([0.5, 1.0, 0.5])
    for u0, u1 in bands.bands:
        for I in range(u0 // 2, min(u1 // 2, Hc)):
            assert u0 <= 2 * I + 1 < u1
            fc[I] = [w @ r[2 * I:2 * I + 3, 2 * J:2 * J + 3] @ w for J in range(Wc)]
    return xout, fc


def case_inputs(level, seed, noisy):
    rng = np.random.default_rng(seed)
    vshape, m, nd = level.op.vshape, level.op.m_lowrank, level.ndir
    f, x = rng.normal(size=vshape), rng.normal(size=vshape)
    xc = rng.normal(size=level.vc)
    xi = rng.normal(size=(nd,) + vshape) if noisy else None
    xi_lr = rng.normal(size=nd * m) if noisy else None
    return f, x, xc, xi, xi_lr


# ---------------------------------------------------------------------- tables
@pytest.mark.parametrize("name", sorted(LEVELS))
@pytest.mark.parametrize("S", [1, 2, 3])
def test_tables_hold_each_point_once_interior_first(levels, name, S):
    """Per order and band every point of each colour exactly once; the first
    ``plain`` of a colour interior (coefficients equal to ``coeff_val``, no
    row beyond a cut), the rest not; the interior coefficients are the
    parameter block's ``coeff_val`` wherever a coefficient is constant; each
    part dealt round the banks (no more shared-memory wavefronts than in
    storage order, and most warps conflict-free)."""
    level = levels[name]
    _, _, offsets, colours = LEVELS[name]
    H, W = level.op.vshape
    assert (len(level.op.offsets), level.coloring.n_colors, level.reach) == (offsets, colours, 2)
    orders = (level.pre_order, level.post_order)
    t = vsm.visit_tables(level, orders, S)
    PX = t["PX"]
    assert PX == W + 4
    w0, w1 = (int(v) for v in level.coloring.weights[-2:])
    plan = vsm.interior_plan(level)
    P = level._build_params(1, level.pre_order, False, 0)
    for k in range(len(level.op.offsets)):
        if P.coeff_const[k]:
            assert np.float32(P.coeff_val[k]) == t["cval"][k]
    dys = {dy for dy, _ in level.op.offsets}
    words = t["words"]
    for d, order in enumerate(orders):
        for k, (u0, u1) in enumerate(mv.split_bands(H, S)):
            e = t["entries"][d][k]
            head = words[(d * S + k) * vsm.HEAD_INTS:(d * S + k + 1) * vsm.HEAD_INTS]
            assert e.size == (u1 - u0) * W
            seen = np.zeros(H * W, int)
            for o, col in enumerate(order):
                a, b = t["starts"][d][k][o], t["starts"][d][k][o + 1]
                assert words[head[o]:head[o + 1]].tolist() == (e[a:b] & 0xFFFFFFFF).astype(
                    np.uint32).view(np.int32).tolist()
                assert head[mv.WIDE_MAX_COLORS + 1 + o] == t["interior"][d][k][o]
                q, p = e[a:b] >> 16, e[a:b] & 0xFFFF
                i, j = p // W, p % W
                assert np.all((w0 * i + w1 * j) % colours == col)
                assert np.all((i >= u0) & (i < u1))
                assert np.array_equal(q, (i - u0 + HALO) * PX + j + HALO)
                seen[p] += 1
                cut = np.zeros(p.size, bool)
                for dy in dys:
                    r = i + dy
                    cut |= ((r >= 0) & (r < u0)) | ((r >= u1) & (r < H))
                interior = plan["plain"][p] & ~cut
                npl = t["interior"][d][k][o]
                assert interior[:npl].all() and not interior[npl:].any()
                for part in (q[:npl], q[npl:]):  # each part dealt round the banks
                    assert ss.bank_conflicts(part, [0, part.size]) <= ss.bank_conflicts(
                        np.sort(part), [0, part.size])
            assert np.array_equal(seen, ((np.arange(H * W) // W >= u0)
                                         & (np.arange(H * W) // W < u1)).astype(int))
    # over the whole table no more wavefronts than each colour in storage order
    q = np.concatenate([e >> 16 for per in t["entries"] for e in per])
    starts = np.cumsum([0] + [s for per in t["starts"] for st in per
                              for s in np.diff(st).tolist()])
    stored = np.concatenate([np.sort(q[a:b]) for a, b in zip(starts[:-1], starts[1:])])
    assert ss.bank_conflicts(q, starts) <= ss.bank_conflicts(stored, starts)


def test_interior_plan_of_the_biharmonic_levels(levels):
    """The planes vary near the edge only: the margin a few points, most
    points interior, the varying coefficients of level 0 its diagonal's fold,
    of a Galerkin level a few of its 25."""
    for name, level in levels.items():
        plan = vsm.interior_plan(level)
        H, W = level.op.vshape
        assert 1 <= plan["margin"] <= 4
        assert plan["plain"].mean() > 0.5
        varying = bin(plan["planes"]).count("1")
        assert 1 <= varying <= (1 if LEVELS[name][2] == 13 else 25)
        assert level.stencil_form == (7 if LEVELS[name][2] == 13 else 9)


# ---------------------------------------------------------------------- replay
@pytest.mark.parametrize("name,S", [("31_13pt", 1), ("31_13pt", 2), ("31_13pt", 3),
                                    ("15_25pt", 1), ("15_25pt", 3), ("31_25pt", 2)])
@pytest.mark.parametrize("noisy", [False, True], ids=["noise_off", "noise"])
def test_replay_of_the_schedule_matches_the_plain_visits(levels, name, S, noisy):
    """The kernel's schedule replayed in float64 (bands, reads across a cut,
    the shares of B^T x in rank order, the restriction by owner) against
    descend_visit_plain / ascend_visit_plain, 1e-12."""
    level = levels[name]
    f, x, xc, xi, xi_lr = case_inputs(level, 3 + S, noisy)
    want_x, want_fc = mv.descend_visit_plain(
        level, tt(f), tt(x)[None], None if xi is None else tt(xi[0])[None],
        None if xi_lr is None else tt(xi_lr)[None])
    got_x, got_fc = replay(level, "descend", S, f, x, xi=xi, xi_lr=xi_lr)
    np.testing.assert_allclose(got_x, want_x[0].numpy(), rtol=1e-12, atol=1e-12)
    scale = max(1.0, float(np.abs(want_fc.numpy()).max()))
    np.testing.assert_allclose(got_fc, want_fc[0].numpy(), rtol=0, atol=1e-12 * scale)
    want = mv.ascend_visit_plain(level, tt(f), tt(x)[None], tt(xc)[None],
                                 None if xi is None else tt(xi[0])[None],
                                 None if xi_lr is None else tt(xi_lr)[None])
    got = replay(level, "ascend", S, f, x, xc=xc, xi=xi, xi_lr=xi_lr)
    np.testing.assert_allclose(got, want[0].numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_replay_of_two_sweeps_matches_the_plain_visits(S):
    """Two sweeps a visit (SSOR, forward then backward, each with its tables
    and its noise) on the 31^2 13-point and the 15^2 25-point levels."""
    for nx, gal in ((32, False), (32, True)):
        level = port_level(jax_level(nx, gal), ssor=True)
        assert level.ndir == 2
        f, x, xc, xi, xi_lr = case_inputs(level, 17 + S, True)
        want_x, want_fc = mv.descend_visit_plain(level, tt(f), tt(x)[None], tt(xi)[:, None],
                                                 tt(xi_lr)[None])
        got_x, got_fc = replay(level, "descend", S, f, x, xi=xi, xi_lr=xi_lr)
        np.testing.assert_allclose(got_x, want_x[0].numpy(), rtol=1e-12, atol=1e-12)
        scale = max(1.0, float(np.abs(want_fc.numpy()).max()))
        np.testing.assert_allclose(got_fc, want_fc[0].numpy(), rtol=0, atol=1e-12 * scale)
        want = mv.ascend_visit_plain(level, tt(f), tt(x)[None], tt(xc)[None], tt(xi)[:, None],
                                     tt(xi_lr)[None])
        got = replay(level, "ascend", S, f, x, xc=xc, xi=xi, xi_lr=xi_lr)
        np.testing.assert_allclose(got, want[0].numpy(), rtol=1e-12, atol=1e-12)


def test_replay_matches_the_interpreted_pallas_kernels():
    """The schedule over two bands against JAX's FusedVisitLevel in interpret
    mode on the 23^2 13-point level, noise off (float32 kernels: x 2e-5, f_c
    2e-5 of max(|f_c|, 1))."""
    a = jax_level(24, False, jnp.float32)
    coloring = jcoloring_for(a.offsets, a.vshape)
    jpre, jpost = JSORSmoother(a, 1.0, 1, FORWARD, coloring), JSORSmoother(a, 1.0, 1, BACKWARD,
                                                                          coloring)
    jfused = JFusedVisitLevel(a, coloring, 1.0, jpre.order, jpost.order, jpre.B_bar, jpost.B_bar,
                              coarse_scaling=GAMMA, interpret=True)
    level = port_level(jax_level(24, False))
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
class _Shape:
    """A level of a shape and form, as the placement rule reads it."""

    def __init__(self, H, W, form):
        from types import SimpleNamespace as NS

        self.op = NS(vshape=(H, W), device=torch.device("cpu"), m_lowrank=8)
        self.stencil_form = form


def test_placement_of_the_biharmonic_levels():
    """The rule on the biharmonic posterior's shapes: 1024 threads where a band
    of x leaves room for one block an SM (255^2 over two blocks), else 512 (two
    blocks an SM); c in shared memory where that keeps the blocks an SM (not on
    127^2 in one block: 133 KB against two blocks' 69 KB); on the CPU's H100
    grant the cluster sizes the rule takes at 1 and 256 chains."""
    big, small = _Shape(255, 255, 7), _Shape(127, 127, 9)
    assert vsm.placement(big, 2) == (False, 1024) and vsm.placement(big, 4) == (False, 512)
    assert vsm.placement(big, 16) == (True, 512) and vsm.placement(big, 8) == (True, 512)
    assert vsm.placement(small, 1) == (False, 512) and vsm.placement(small, 2) == (True, 512)
    assert 1 not in vsm.candidates(big)  # 259^2 floats exceed a block's grant
    assert vsm.blocks_by_smem(vsm.smem_bytes(127, 127, 1, True)) == 1
    assert vsm.blocks_by_smem(vsm.smem_bytes(127, 127, 1, False)) == 3
    for level, at_one, at_many in ((big, 16, 2), (small, 16, 1)):
        assert vsm.smem_cluster(level, 1) == at_one and vsm.smem_cluster(level, 256) == at_many


def test_shared_memory_bytes_mirror_the_source():
    src = (CSRC / "mgmc_visit_smem.cu").read_text()
    assert "#define SMEM_HALO 2" in src and HALO == 2
    assert f"#define SMEM_MAX_CLUSTER {vsm.MAX_CLUSTER}" in src
    assert ("(long long)(nb + 2 * SMEM_HALO) * PX + (c_shared ? (long long)nb * W : 0)"
            in src)
    assert "H / S < SMEM_HALO" in src
    # the biharmonic levels: 255^2 over two blocks without c, four with c; 127^2 in one
    assert vsm.smem_bytes(255, 255, 2, False) == 4 * 132 * 259 == 136752
    assert vsm.smem_bytes(255, 255, 4, True) == 4 * (68 * 259 + 64 * 255)
    assert vsm.smem_bytes(127, 127, 1, True) == 4 * (131 * 131 + 127 * 127)
    assert vsm.smem_bytes(127, 127, 1, False) == 68644
    with pytest.raises(ValueError):
        vsm.smem_bytes(255, 255, 17, False)
    with pytest.raises(ValueError):
        vsm.smem_bytes(5, 5, 3, False)
    assert not vsm.fits_indices(255, 255, 1) and vsm.fits_indices(255, 255, 2)
    assert vsm.fits_indices(127, 127, 1) and not vsm.fits_indices(511, 511, 16)
    # the parameter block and the static part
    assert re.search(rf"#define SMEM_HEAD_INTS \(2 \* MAX_COLORS \+ 1\)", src)
    assert vsm.HEAD_INTS == 2 * 9 + 1
    assert "__shared__ float s_part[LANE_SLOTS];" in src
    assert "__shared__ float s_wv[32 * LANE_SLOTS];" in src
    assert vsm.STATIC_SMEM == 4 * (32 + 32 * 32) + 16
    struct = src[src.index("struct SmemVisitParams {"):src.index("};", src.index(
        "struct SmemVisitParams {"))]
    names = re.findall(r"\b(\w+)(?:\[\w+\])?;", struct)
    assert names == [name for name, _ in vsm.SmemVisitParams._fields_]


def test_barriers_from_the_source(levels):
    """The kernel's barriers, counted from the source's smem_sync calls by
    where they stand, against barrier_count: an ascend's copy-in (a block
    barrier after its first rhs, which is drawn while the copy lands; a
    descend's copy lands behind its first rhs barrier); per direction the rhs,
    each colour, the shares of B^T x (m > 0); a descend 3, an ascend 1."""
    src = (CSRC / "mgmc_visit_smem.cu").read_text()
    body = src[src.index("smem_visit_kernel(const"):src.index("stamps_close<STAMPS>(srow, SMEM")]
    loop = body[body.index("for (int d = 0; d < SP.ndir; ++d)"):body.index(
        "// every band corrected")]
    colours = loop[loop.index("for (int o = 0; o < P.n_order; ++o)"):loop.index("// 4. Woodbury")]
    descend = body[body.index("if (DESCEND) {\n        // 5."):]
    calls = lambda s: s.count("smem_sync<STAMPS>(")  # noqa: E731
    assert calls(body) == 7 and calls(loop) == 4 and calls(colours) == 1 and calls(descend) == 2
    assert calls(body[:body.index("for (int d = 0; d < SP.ndir; ++d)")]) == 0
    rhs = loop[:loop.index("// every band formed")]
    copy_in = rhs[rhs.index("if (d == 0) {"):]
    assert "if (!DESCEND) {" in copy_in and calls(copy_in) == 1
    assert "smem_sync<STAMPS>(cluster, S, true);" in copy_in  # the block's own barrier
    for level in levels.values():
        m = level.op.m_lowrank
        assert m > 0
        for kind in ("descend", "ascend"):
            per_dir = sum(1 + len(o) + 1 for o in level.orders(kind))
            assert vsm.barrier_count(level, kind) == per_dir + (3 if kind == "descend" else 2)
            names = vsm.pass_names(level, kind)
            assert len(names) == vsm.barrier_count(level, kind)
            assert len(names) + 1 + 3 <= vsm.STAMP_WIDTH


def test_stamps_of_both_reach2_builds(levels):
    """The phase kernels' reach-2 stamps build (its own library, a width of 30
    at 9 colours) and the smem kernels' (30: 26 barriers at most); their pass
    names in order; the stamps tensors' shapes."""
    src = (CSRC / "mgmc_visit.cu").read_text()
    assert "#define PHASE_STAMP_WIDTH (1 + 2 * (MAX_COLORS + 3) + 2 + 3)" in src
    assert mv.WIDE_STAMP_WIDTH == 1 + 2 * (9 + 3) + 2 + 3 == 30
    smem = (CSRC / "mgmc_visit_smem.cu").read_text()
    assert ("#define SMEM_STAMP_WIDTH (1 + 1 + MAX_DIRS * (MAX_COLORS + 2) + 3 + 3)" in smem)
    assert vsm.STAMP_WIDTH == 30
    assert ("mgmc_visit", common.PHASE_REACH2_STAMPS_FLAGS) in common.STAMPS_BUILDS
    assert ("mgmc_visit_smem", common.SMEM_VISIT_STAMPS_FLAGS) in common.STAMPS_BUILDS
    assert common.PHASE_REACH2_STAMPS_FLAGS == ("-DVISIT_REACH=2", "-DPHASE_STAMPS_BUILD=1")
    assert "SMEM_VISIT_STAMPS_BUILD" in smem
    level = levels["15_25pt"]
    order = level.pre_order
    assert mv.pass_names(level, "descend") == (
        ["rhs"] + [f"colour {c}" for c in order] + ["B^T x", "Woodbury", "residual",
                                                     "restriction"])
    assert len(mv.pass_names(level, "descend")) == mv.phase_barrier_count(level, "descend")
    assert vsm.pass_names(level, "descend") == (
        ["copy-in + rhs"] + [f"colour {c}" for c in order]
        + ["B^T x shares", "Woodbury", "write-back + residual", "restriction"])
    assert vsm.pass_names(level, "ascend")[:2] == ["rhs + copy-in", "prolongation"]
    assert mv.stamp_shape(level, "phase", 256) == (256, 30)
    assert mv.stamp_shape(level, "smem", 256, 2) == (512, 30)
    with pytest.raises(ValueError, match="stamps build"):
        mv.stamp_shape(level, "split", 1)


# ----------------------------------------------------------------------- route
def test_route_at_1_16_and_256_chains(levels):
    """The rule before any level is built (visit_route on the shape, form and
    sweeps: the biharmonic posterior's 255^2 13-point and 127^2 25-point
    levels take the smem kernels where SMEM_CHAINS says, every other reach-2
    shape the phase kernels, a 3d form the phase kernels); a level's route
    and cluster size (on the CPU every cluster schedules: the largest that
    fits wins at one chain); the smem route takes a reach-1 level where a
    caller names it."""
    cpu = torch.device("cpu")
    for (H, W, form, ndir), (least, most) in vsm.SMEM_CHAINS.items():
        if form < mv.WIDE_FORM0:  # the reach-1 two-sweep shapes: test_torch_visit_ssor_smem.py
            continue
        for C in (1, 16, 256):
            want = "smem" if C >= least and (most is None or C <= most) else "phase"
            assert mv.visit_route(C, 0, cpu, vshape=(H, W), form=form, ndir=ndir) == want
    for C in (1, 16, 256):
        assert mv.visit_route(C, 0, cpu, vshape=(63, 63), form=7) == "phase"
        # a 3d form takes its own table (mgmc_visit_smem3d.SMEM3D_ROUTES)
        assert mv.visit_route(C, 0, cpu, vshape=(31, 31, 31), form=12) == (
            "phase" if v3.route_config((31, 31, 31), 12, 1, C) is None else "smem")
    for level in levels.values():  # shapes the table does not list
        assert {level.route(C) for C in (1, 16, 256)} == {"phase"}
    level = levels["31_13pt"]
    cands = vsm.candidates(level)
    assert set(cands) == {16, 8, 4, 2, 1} - {16}  # 31 rows: no band of one row
    # on the CPU every cluster schedules; those with an SM a block count
    assert vsm.smem_cluster(level, 1) == 8 and vsm.smem_cluster(level, 256) == 1
    assert all(cands[S] == (True, 512) for S in cands)  # small bands: two blocks an SM
    from test_torch_visit_split import _small_level

    # a reach-1 level: the 2d smem kernels take it where a caller names the
    # route (their table lists reach-1 shapes of two sweeps only), its
    # parameter block widened to the kernels' 25 offsets and 9 colours
    small = _small_level()
    assert mv.route_support_error(small, "smem") is None
    P = small._params(1, small.pre_order, False, 0, None, route="smem")
    assert isinstance(P.v[0], mv.WideVisitParams) and P.v[0].K == len(small.op.offsets)
    assert mv.route_support_error(level, "smem") is None
    for kind in ("descend", "ascend"):
        assert mv.kernel_name(level, "smem", kind) == f"{kind}_visit_reach2_13pt_smem"
        assert mv.launch_counts[f"{kind}_visit_reach2_13pt_smem"] == 0
