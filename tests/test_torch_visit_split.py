"""The split level-visit kernels of ``csrc/mgmc_visit_split.cu`` (each chain's
level split over a thread-block cluster, its bands in shared memory) on the
CPU, where they cannot run: a plain PyTorch replay of their schedule, built
from the host's mirror of the band layout (``mgmc_visit.split_bands``), against

(a) ``descend_visit_plain`` / ``ascend_visit_plain`` in float64
    (``rtol = atol = 1e-12``), noise off and with the normals ``xi`` / ``xi_lr``
    injected: every block keeps its band of ``x`` and of the rhs / residual in
    a copy of its own, reads its halo rows from the neighbours' copies, sums
    its share of ``B^T x`` over its band, and every block adds the shares in
    rank order; coarse row ``I`` is formed by the block that owns fine row
    ``2I + 1`` - on the flagship's 255^2 2-colour 5-point level with 8
    measurements, its 127^2 4-colour 9-point Galerkin level, cluster sizes
    that do not divide the rows, band boundaries on even and on odd rows, and
    a ``Y`` box that straddles a band boundary;
(b) the JAX package's ``descend_visit`` / ``ascend_visit`` in interpret mode,
    as ``tests/test_torch_mgmc_visit.py`` runs them (float32, ``2e-5``: another
    summation order);
(c) the route: chosen before any launch from the chain count, the shape, the
    band layout's shared memory and whether the cluster schedules; the
    drivers' one-chain levels take the split kernels, 256 chains the stream
    kernels, a level whose bands do not fit the phase kernels, and every route
    rejects what ``kernel_support_error`` rejects.

``chip_smoke.py`` holds the kernels themselves against the plain versions and
against the phase kernels on the card.
"""

import functools
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.ops.coloring import coloring_for as jcoloring_for
from multigridmc_tpu.ops.kernels.mgmc_visit_pallas import FusedVisitLevel as JFusedVisitLevel
from multigridmc_tpu.smoothers import BACKWARD, FORWARD
from multigridmc_tpu.smoothers import SORSmoother as JSORSmoother

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
from multigridmc_tpu_torch.ops.coarsen import galerkin_coarsen
from multigridmc_tpu_torch.ops.intergrid import prolongate
from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import SORSmoother

from test_torch_common import CPU, F32, assert_close, jax_operator, to_port, tt

GAMMA = 0.75
F64_TIGHT = dict(rtol=1e-12, atol=1e-12)
H100_SMEM = mv.SMEM_PER_BLOCK_OPTIN
CSRC = Path(mv.__file__).resolve().parents[2] / "csrc"


# ------------------------------------------------------------------ the replay
def _boxed(fields, boxes):
    out = torch.zeros_like(fields)
    for k, (i0, i1, j0, j1) in enumerate(boxes):
        out[k, i0:i1, j0:j1] = fields[k, i0:i1, j0:j1]
    return out


def _visible(bands, bounds, k, shape, halo=True):
    """Block ``k``'s view of a field held in bands: its own band, the row of
    each neighbouring band next to it (the reach is 1; none without ``halo``),
    zeros elsewhere."""
    u0, u1 = bounds[k]
    out = torch.zeros(shape, dtype=bands[k].dtype)
    out[:, u0:u1] = bands[k]
    if halo and k > 0:
        out[:, u0 - 1] = bands[k - 1][:, -1]
    if halo and k + 1 < len(bands):
        out[:, u1] = bands[k + 1][:, 0]
    return out


def _full_weighting(r):
    """``f_c[I, J] = sum_{a, b} w_a w_b r[2I+1+a, 2J+1+b]``, ``w = (0.5, 1, 0.5)``."""
    rows = 0.5 * r[..., 0:-2:2, :] + r[..., 1:-1:2, :] + 0.5 * r[..., 2::2, :]
    return 0.5 * rows[..., 0:-2:2] + rows[..., 1:-1:2] + 0.5 * rows[..., 2::2]


def split_visit_replay(level, kind, S, f, x, x_coarse=None, xi=None, xi_lr=None, halo=True):
    """What one split launch with clusters of ``S`` blocks computes, block by
    block and barrier by barrier; ``kind`` is ``"descend"`` (returns
    ``(x, f_c)``) or ``"ascend"``.  All blocks of a step read the bands as the
    last cluster barrier left them; ``halo=False`` drops the neighbours' rows
    (a schedule that is not the visit).  Each directed sweep of the visit (one:
    SOR; two: SSOR, ``xi`` then ``(2, C, H, W)``, ``xi_lr`` ``(C, 2 m)``) runs
    1-3 on the bands in shared memory."""
    op = level.op
    H, W = op.vshape
    mv.split_smem_bytes(H, W, S)  # raises where the level does not split so
    bounds = mv.split_bands(H, S)
    orders = level.orders(kind)
    shape = x.shape
    f = torch.broadcast_to(f, shape)
    m = op.m_lowrank
    # 1. the load: x and the ascend's prolongation
    if kind == "ascend":
        x = x + level.coarse_scaling * prolongate(x_coarse, op.vshape)
    xb = [x[:, u0:u1].clone() for u0, u1 in bounds]
    diag = op.diag_stencil()
    t = None
    for d, order in enumerate(orders):
        # the rhs of this direction (its low-rank noise enters the correction)
        c = f
        if xi is not None:
            c = f + level.noise_scale * (xi if len(orders) == 1 else xi[d])
        cb = [c[:, u0:u1].clone() for u0, u1 in bounds]
        # 2. the colour phases, a cluster barrier between them
        for colour in order:
            new = []
            for k, (u0, u1) in enumerate(bounds):
                ax = op.apply_stencil(_visible(xb, bounds, k, shape, halo))[:, u0:u1]
                new.append(xb[k] + level.masks[colour][u0:u1]
                           * (level.omega * (cb[k] - ax) / diag[u0:u1]))
            xb = new
        # 3. Woodbury: each band's share of B^T x, summed over the ranks in
        #    order, less Sigma^1/2 n; u = W (B^T x - Sigma^1/2 n)
        if level.B is not None:
            Bbox = _boxed(level.B, level.bbox)
            shares = [torch.einsum("chw,khw->ck", xb[k], Bbox[:, u0:u1])
                      for k, (u0, u1) in enumerate(bounds)]
            btx = shares[0]
            for share in shares[1:]:
                btx = btx + share
            n = None if xi_lr is None else xi_lr[:, d * m:(d + 1) * m]
            if n is not None:
                btx = btx - level.sigma_sqrt * n
            Y, Wm, ybox = level._woodbury[order]
            u = btx @ Wm.T
            patch = torch.einsum("cl,lhw->chw", u, _boxed(Y, ybox))
            xb = [xb[k] - patch[:, u0:u1] for k, (u0, u1) in enumerate(bounds)]
            t = u if n is None else u + n / level.sigma_sqrt
    x_out = torch.cat(xb, dim=1)  # written back once
    if kind == "ascend":
        return x_out
    # 4. the residual over each band (halo rows of the corrected x), then the
    #    restriction of the coarse rows whose centre row lies in the band
    rb = []
    for k, (u0, u1) in enumerate(bounds):
        r = f[:, u0:u1] - op.apply_stencil(_visible(xb, bounds, k, shape))[:, u0:u1]
        if t is not None:
            r = r - torch.einsum("ck,khw->chw", t, Bbox[:, u0:u1])
        rb.append(r)
    Hc, Wc = level.vc
    fc = torch.full((shape[0], Hc, Wc), float("nan"), dtype=x.dtype)
    owners = torch.zeros(Hc, dtype=torch.int64)
    for k, (u0, u1) in enumerate(bounds):
        I0, I1 = u0 // 2, min(u1 // 2, Hc)
        if I1 > I0:
            fc[:, I0:I1] = _full_weighting(_visible(rb, bounds, k, shape))[:, I0:I1]
            owners[I0:I1] += 1
    assert torch.equal(owners, torch.ones_like(owners)), "a coarse row has not one owner"
    return x_out, fc


# ------------------------------------------------------------------ levels
def _posterior(nx, locations, dtype=torch.float64):
    rng = np.random.default_rng(20260816)
    m = len(locations)
    params = MeasurementParameters(measurement_locations=np.asarray(locations),
                                   mean=rng.normal(size=m), variance=0.5 + rng.uniform(size=m))
    prior = shiftedlaplace_fd(Lattice((nx, nx)), ConstantCorrelationLengthModel(0.2),
                              device=CPU, dtype=dtype)
    return measured_operator(prior, params)


def _level(op, omega=1.0):
    pre, post = SORSmoother(op, omega, 1, FORWARD), SORSmoother(op, omega, 1, BACKWARD)
    return mv.FusedVisitLevel(op, pre.coloring, omega, pre.order, post.order, pre.B_bar,
                              post.B_bar, GAMMA)


#: the flagship's 8 measurements, as chip_smoke.py draws them, with the first
#: two moved next to the band boundary at row 128 of the 255^2 level (S = 2 ..
#: 16), on points of both colours: the Y boxes of both sweep directions cross it
def _flagship_locations():
    rng = np.random.default_rng(20260816)
    loc = rng.uniform(0.1, 0.9, size=(8, 2))
    loc[0], loc[1] = (0.37, 0.5), (0.375, 0.5)
    return loc


@functools.lru_cache(maxsize=None)
def _flagship_levels():
    """The flagship's 255^2 level (5-point, 2 colours, 8 measurements) and its
    127^2 Galerkin level (9-point, 4 colours), in float64."""
    op = _posterior(256, _flagship_locations())
    return _level(op), _level(galerkin_coarsen(op), omega=0.9)


def _small_level():
    """A 23^2 level: bands over 8 or 16 blocks start on even and odd rows."""
    return _level(_posterior(24, [(0.3, 0.45), (0.62, 0.71), (0.5, 0.2)]), omega=1.2)


def _inputs(level, C, seed, f_batched=True):
    rng = np.random.default_rng(seed)
    vshape = level.op.vshape
    f = tt(rng.normal(size=((C,) if f_batched else ()) + vshape))
    x = tt(rng.normal(size=(C,) + vshape))
    xc = tt(rng.normal(size=(C,) + level.vc))
    xi = tt(rng.normal(size=(C,) + vshape))
    xi_lr = tt(rng.normal(size=(C, level.op.m_lowrank)))
    return f, x, xc, xi, xi_lr


def _straddles(boxes, bounds):
    return any(u0 in range(i0 + 1, i1) for i0, i1, _, _ in boxes for u0, _ in bounds[1:])


# ---------------------------------------------------------- (a) float64
# (case, level, cluster size)
REPLAY_CASES = {
    "flagship_255_5point_S16": ("flagship0", 16),
    "flagship_255_5point_S4": ("flagship0", 4),
    "galerkin_127_9point_S16": ("flagship1", 16),
    "galerkin_127_9point_S8": ("flagship1", 8),
    "23x23_odd_boundaries_S8": ("small", 8),
    "23x23_one_row_bands_S16": ("small", 16),
}


def _replay_level(name):
    if name == "small":
        return _small_level()
    return _flagship_levels()[int(name[-1])]


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_split_replay_is_the_visit(case):
    name, S = REPLAY_CASES[case]
    level = _replay_level(name)
    H = level.op.vshape[0]
    bounds = mv.split_bands(H, S)
    assert H % S, "every case has a cluster size that does not divide the rows"
    assert bounds[-1][1] == H and all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    starts = {u0 % 2 for u0, _ in bounds[1:]}
    if name == "small":  # boundaries on even and on odd rows, for the restriction
        assert starts == {0, 1}
    if name == "flagship0":  # a Y box (pre and post direction) across a band boundary
        for order in (level.pre_order, level.post_order):
            assert _straddles(level._woodbury[order][2], bounds)
    C = 2
    for f_batched in (False, True):
        f, x, xc, xi, xi_lr = _inputs(level, C, seed=S + f_batched, f_batched=f_batched)
        for noise in (False, True):
            kw = dict(xi=xi, xi_lr=xi_lr) if noise else {}
            got_x, got_fc = split_visit_replay(level, "descend", S, f, x, **kw)
            want_x, want_fc = mv.descend_visit_plain(level, f, x, **kw)
            torch.testing.assert_close(got_x, want_x, **F64_TIGHT)
            torch.testing.assert_close(got_fc, want_fc, **F64_TIGHT)
            got = split_visit_replay(level, "ascend", S, f, x, xc, **kw)
            torch.testing.assert_close(got, mv.ascend_visit_plain(level, f, x, xc, **kw),
                                       **F64_TIGHT)


def test_replay_sees_a_missing_halo():
    # the halo is what makes the bands one sweep: a replay that does not read
    # the neighbours' rows is not the visit
    level = _small_level()
    f, x, _, _, _ = _inputs(level, 2, seed=3)
    want_x, _ = mv.descend_visit_plain(level, f, x)
    got_x, _ = split_visit_replay(level, "descend", 8, f, x, halo=False)
    assert not torch.allclose(got_x, want_x, rtol=1e-6, atol=1e-6)


# ----------------------------------- (b) against the interpreted Pallas kernels
@functools.lru_cache(maxsize=None)
def _jax_levels(level, nx):
    a = jax_operator(nx, True, dtype=jnp.float32)
    if level:
        a = jgalerkin(a)
    coloring = jcoloring_for(a.offsets, a.vshape)
    jpre = JSORSmoother(a, 0.9, 1, FORWARD, coloring)
    jpost = JSORSmoother(a, 0.9, 1, BACKWARD, coloring)
    jfused = JFusedVisitLevel(a, jpre.coloring, 0.9, jpre.order, jpost.order, jpre.B_bar,
                              jpost.B_bar, coarse_scaling=GAMMA, interpret=True)
    b = to_port(a, torch.float32)
    pre, post = SORSmoother(b, 0.9, 1, FORWARD), SORSmoother(b, 0.9, 1, BACKWARD)
    port = mv.FusedVisitLevel(b, pre.coloring, 0.9, pre.order, post.order, pre.B_bar,
                              post.B_bar, GAMMA)
    return a, jfused, port


@pytest.mark.parametrize("level_index,nx,S", [(0, 24, 8), (1, 32, 4)],
                         ids=["23x23_5point_S8", "galerkin_15x15_9point_S4"])
def test_split_replay_matches_interpreted_pallas_kernels(level_index, nx, S):
    a, jfused, port = _jax_levels(level_index, nx)
    rng = np.random.default_rng(12)
    C = 2
    f = rng.normal(size=a.vshape)
    x = rng.normal(size=(C,) + a.vshape)
    xc = rng.normal(size=(C,) + tuple(v // 2 for v in a.vshape))
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    t32 = lambda v: tt(v, torch.float32)  # noqa: E731
    jx, jfc = jfused.descend(jax.random.key(0), f32(f), f32(x), noise=False)
    px, pfc = split_visit_replay(port, "descend", S, t32(f), t32(x))
    assert_close(px, jx, **F32)
    assert_close(pfc, jfc, **F32)
    jxa = jfused.ascend(jax.random.key(0), f32(f), f32(x), f32(xc), noise=False)
    assert_close(split_visit_replay(port, "ascend", S, t32(f), t32(x), t32(xc)), jxa, **F32)


# ------------------------------------------------------------- (c) the route
@functools.lru_cache(maxsize=None)
def _driver_levels():
    """The drivers' two fused levels (255^2 and its 127^2 Galerkin level) of
    the flagship posterior, float32 as on the card."""
    op = _posterior(256, _flagship_locations(), torch.float32)
    return _level(op), _level(galerkin_coarsen(op))


@pytest.mark.parametrize("limit", [None, H100_SMEM])
def test_drivers_levels_take_the_split_route(monkeypatch, limit):
    fine, coarse = _driver_levels()
    assert (fine.op.vshape, coarse.op.vshape) == ((255, 255), (127, 127))
    for level in (fine, coarse):
        vshape = level.op.vshape
        # the one-chain time series: the split kernels, 16 blocks a chain (on
        # the CPU every cluster counts as running at once)
        assert mv.visit_route(1, level.stream_bytes, CPU, limit, vshape) == "split"
        assert mv.split_cluster(1, vshape, CPU, limit) == 16
        for C in (1, 4, mv.SPLIT_MAX_CHAINS):
            assert mv.visit_route(C, level.stream_bytes, CPU, limit, vshape) == "split"
        for C in (mv.SPLIT_MAX_CHAINS + 1, 128, 255):
            assert mv.visit_route(C, level.stream_bytes, CPU, limit, vshape) == "phase"
            assert mv.split_cluster(C, vshape, CPU, limit) is None
    # 256 replica chains: the stream kernels on the 255^2 level, the one shape
    # the table holds a stream threshold for (where their rings fit), the phase
    # kernels on 127^2
    assert (fine.stencil_form, coarse.stencil_form) == (0, 2)
    assert mv.visit_route(256, fine.stream_bytes, CPU, H100_SMEM, (255, 255),
                          fine.stencil_form) == "stream"
    assert mv.visit_route(256, coarse.stream_bytes, CPU, H100_SMEM, (127, 127),
                          coarse.stencil_form) == "phase"
    assert mv.visit_route(255, fine.stream_bytes, CPU, H100_SMEM, (255, 255),
                          fine.stencil_form) == "phase"
    with monkeypatch.context() as m:
        m.setattr(mv, "STREAM_MIN_CHAINS", {})
        assert mv.visit_route(256, fine.stream_bytes, CPU, H100_SMEM, (255, 255),
                              fine.stencil_form) == "phase"
    # the level decides once per chain count, before any launch
    assert fine.route(1) == "split" and fine.split_cluster(1) == 16
    assert fine._routes[1] == ("split", 16)
    P = fine._params(1, fine.pre_order, False, 1, (3, 4))
    assert isinstance(P, mv.SplitParams) and P.ndir == 1
    assert (P.v[0].C, P.v[0].seed, P.v[0].counter) == (1, 3, 4)


#: clusters of split visits an H100 holds at once, by level and cluster size
#: (the split_active_clusters of chip_smoke.py's visit_routes line; at 255^2
#: S = 2 does not fit)
ACTIVE = {(255, 255): {16: 7, 8: 15, 4: 30}, (127, 127): {16: 28, 8: 30, 4: 30, 2: 66}}


@pytest.mark.parametrize("vshape,C,want", [
    ((255, 255), 1, 16), ((255, 255), 4, 16), ((255, 255), 8, 8), ((255, 255), 16, 4),
    ((255, 255), 32, 8), ((255, 255), 64, 8),
    ((127, 127), 1, 16), ((127, 127), 32, 16), ((127, 127), 64, 2)])
def test_cluster_size_minimises_the_waves(monkeypatch, vshape, C, want):
    # the cluster sizes the visit_routes table measured best at these counts
    asked = []

    def active(device, kind, S, threads, nbytes, query=None):
        asked.append((kind, S, query))
        return ACTIVE[vshape][S]

    monkeypatch.setattr(ss, "active_clusters", active)
    # the rule's size at any count (capped=False); the route splits only up to
    # SPLIT_MAX_CHAINS chains
    assert mv.split_cluster(C, vshape, "cuda", H100_SMEM, capped=False) == want
    assert mv.split_cluster(C, vshape, "cuda", H100_SMEM) == (
        want if C <= mv.SPLIT_MAX_CHAINS else None)
    # both kernels are asked, through the split kernels' own entry point
    assert {a[0] for a in asked} == {0, 1}
    assert all(a[2] is mv._split_occupancy_query for a in asked)
    assert {a[1] for a in asked} == set(ACTIVE[vshape])
    # the fixed share of a wave is a fixed number of points: a larger share on
    # the smaller level, where one wave of clusters of 2 beats three of 16
    fixed = mv.SPLIT_WAVE_POINTS / (vshape[0] * vshape[1])
    assert want == ss.cheapest_cluster(C, ACTIVE[vshape], fixed)
    if vshape == (127, 127) and C == 64:
        assert ss.cheapest_cluster(C, ACTIVE[vshape]) == 16  # the sweeps' share


def test_route_takes_the_phase_kernels_where_the_bands_do_not_fit():
    # 1023^2: 64 rows of x and of the scratch band at S = 16 exceed a block
    assert mv.split_smem_bytes(1023, 1023, 16) == 4 * (128 + 2 * 64 * 1023)
    assert mv.split_cluster(1, (1023, 1023), CPU, H100_SMEM) is None
    assert mv.visit_route(1, 0, CPU, H100_SMEM, (1023, 1023)) == "phase"
    # the flagship's 255^2 level: S = 2 needs 261 KB, S = 4 fits the H100
    assert mv.split_smem_bytes(255, 255, 2) + mv.SPLIT_STATIC_SMEM > H100_SMEM
    assert mv.split_smem_bytes(255, 255, 4) == 4 * (128 + 2 * 64 * 255) == 131072
    assert mv.split_smem_bytes(255, 255, 16) == 33152
    # what a block is granted decides: just enough, or four bytes short
    need = mv.split_smem_bytes(511, 511, 16) + mv.SPLIT_STATIC_SMEM
    assert mv.split_cluster(1, (511, 511), CPU, need) == 16
    assert mv.split_cluster(1, (511, 511), CPU, need - 4) is None
    assert mv.visit_route(1, 0, CPU, need - 4, (511, 511)) == "phase"
    # the CPU's default (48 KiB): the flagship's levels fit, 511^2 does not
    assert mv.visit_route(1, 0, CPU, None, (255, 255)) == "split"
    assert mv.visit_route(1, 0, CPU, None, (511, 511)) == "phase"
    # without a shape the route never splits
    assert mv.visit_route(1, 0, CPU, H100_SMEM) == "phase"


def test_band_layout_mirror():
    assert mv.split_bands(255, 16) == tuple((16 * k, 16 * k + 16) for k in range(15)) + (
        (240, 255),)
    assert mv.split_bands(23, 8) == ((0, 3), (3, 6), (6, 9), (9, 12), (12, 15), (15, 18),
                                     (18, 21), (21, 23))
    for H in (7, 23, 127, 255):
        for S in ss.SPLIT_SIZES:
            if S > H:
                with pytest.raises(ValueError, match="does not split"):
                    mv.split_smem_bytes(H, H, S)
                continue
            bands = mv.split_bands(H, S)
            sizes = [u1 - u0 for u0, u1 in bands]
            assert sum(sizes) == H and max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
            assert mv.split_smem_bytes(H, H, S) == 4 * (mv.SPLIT_TABLE_INTS + 2 * -(-H // S) * H)
    for bad in (1, 17):
        with pytest.raises(ValueError, match="does not split"):
            mv.split_smem_bytes(255, 255, bad)


def test_layout_mirror_constants_match_the_kernel_source():
    src = (CSRC / "mgmc_visit_split.cu").read_text()
    assert int(re.search(r"#define MAX_CLUSTER (\d+)", src).group(1)) == ss.SPLIT_SIZES[0]
    assert "#define SPLIT_TABLE_INTS (MAX_DIRS * MAX_COLORS * MAX_COLORS)" in src
    assert int(re.search(r"#define MAX_DIRS (\d+)", src).group(1)) == mv.MAX_DIRS
    sizes = {"LANE_SLOTS": mv.LANE_SLOTS, "MAX_CLUSTER": ss.SPLIT_SIZES[0]}
    statics = re.findall(r"__shared__ float s_\w+\[(\w+)(?: \* (\w+))?\];", src)
    assert mv.SPLIT_STATIC_SMEM == sum(4 * sizes[a] * (sizes[b] if b else 1) for a, b in statics)
    assert '#include "visit_phases.cuh"' in src and "mgmc_visit_split" in common.SOURCES


def test_every_route_rejects_what_the_kernels_do_not_take():
    # a reach-2 (13-point) stencil: the split kernels refuse it, the phase
    # kernels' reach-2 build takes it, at one chain too
    from test_torch_visit_stream import _synthetic_level

    offsets = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-2, 0), (2, 0), (0, -2), (0, 2),
               (-1, -1), (-1, 1), (1, -1), (1, 1))
    level = _synthetic_level((9, 9), offsets, seed=4)
    assert mv.kernel_support_error(level.op, level.coloring.n_colors) is None
    for route in ("split", "stream"):
        with pytest.raises(NotImplementedError, match="reach-1"):
            level._params(1, level.pre_order, False, 0, None, route=route)
    assert level.route(1) == "phase" and level.split_cluster(1) is None
    assert isinstance(level._params(1, level.pre_order, False, 0, None), mv.WideVisitParams)
    # the launches take CUDA tensors only: no CPU path behind any route
    fine = _small_level()
    x = torch.zeros((1,) + fine.op.vshape, dtype=torch.float64)
    xc = torch.zeros((1,) + fine.vc, dtype=torch.float64)
    mv.reset_launch_counts()
    for route in mv.ROUTES:
        with pytest.raises(ValueError, match="CUDA device"):
            mv.launch_descend(fine, route, x[0], x)
        with pytest.raises(ValueError, match="CUDA device"):
            mv.launch_ascend(fine, route, x[0], x, xc, cluster=8)
    assert all(v == 0 for v in mv.launch_counts.values())
    one = ({mv.KERNEL_NAMES[(r, k)] for r in mv.ROUTES + (mv.SMEM_ROUTE,)
            for k in ("descend", "ascend")}
           | set(mv.REACH2_NAMES.values()) | set(mv.DIM3_NAMES.values()))
    # each form apart from its two-sweep (SSOR) form, which the stream kernels lack
    assert one | {name + mv.SSOR_SUFFIX for name in one if "stream" not in name} == set(
        mv.launch_counts)
