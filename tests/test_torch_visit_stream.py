"""The stream (row-wavefront) level-visit kernels of ``csrc/mgmc_visit_stream.cu``
on the CPU, where they cannot run: a plain PyTorch emulation of what they do,
in the order their parameter block prescribes, against

(a) the colour-ordered SOR sweep (``sweep_batched_plain``): the wavefront of
    the lag table that ``FusedVisitLevel._params`` hands the kernel, with all
    colour phases of a step computed from the same snapshot, gives the sweep
    bitwise in float64 - on the flagship's 2-colour 5-point level, the
    4-colour 9-point Galerkin level, a 31^2 level, a field of 5 rows and two
    other colourings that ``kernel_support_error`` admits;
(b) the whole visit: the two-pass descend (sweep, row-chunk partial sums of
    ``B^T x``, Woodbury patch on the ``Y`` boxes, ``(I - G)`` residual
    shortcut, residual, restriction) and the one-pass ascend against
    ``descend_visit_plain`` / ``ascend_visit_plain`` and the JAX composed path
    in float64 (``rtol = atol = 1e-12``), and in float32 against the JAX
    package's Pallas kernels in interpret mode as
    ``tests/test_torch_mgmc_visit.py`` runs them (``2e-5``; the interpreted
    kernels do not run in float64);
(c) the route: chosen before any launch from the chain count and from
    whether the stream kernels' shared memory (the host's mirror of the
    kernel's layout) fits a block at the level's shape, and both routes reject
    what ``kernel_support_error`` rejects.

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
from multigridmc_tpu.ops.intergrid import prolongate_add as jprolongate_add
from multigridmc_tpu.ops.intergrid import restrict as jrestrict
from multigridmc_tpu.ops.kernels.mgmc_visit_pallas import FusedVisitLevel as JFusedVisitLevel
from multigridmc_tpu.smoothers import BACKWARD, FORWARD
from multigridmc_tpu.smoothers import SORSmoother as JSORSmoother

from multigridmc_tpu_torch.convert import operator_from_numpy
from multigridmc_tpu_torch.ops.coloring import Coloring, _linear_coloring, coloring_for
from multigridmc_tpu_torch.ops.intergrid import prolongate
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels.sor_sweep import sweep_batched_plain
from multigridmc_tpu_torch.smoothers import SORSmoother, color_order

from test_torch_common import CPU, F32, assert_close, jax_operator, to_port, tt

GAMMA = 0.75
F64_TIGHT = dict(rtol=1e-12, atol=1e-12)

OFFSETS5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
OFFSETS9 = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))


# ------------------------------------------------------------------ emulation
def wavefront_sweep(level, order, lags, c, x, rows=mv.STREAM_ROWS):
    """Pass 1's sweep as the kernel schedules it: the rows in blocks of
    ``rows``; at step ``s`` phase ``o`` updates the points of colour
    ``order[o]`` in row block ``s - lags[o]``; all phases of a step read the
    field as it stood before the step (the kernel runs them at once), each
    point by the arithmetic of the colour-ordered sweep."""
    op = level.op
    field = torch.as_tensor(level.coloring.field)
    H = op.vshape[0]
    nblocks = -(-H // rows)
    diag = op.diag_stencil()
    for s in range(nblocks + max(lags)):
        update = level.omega * (c - op.apply_stencil(x)) / diag
        mask = torch.zeros(op.vshape, dtype=torch.bool)
        for o, colour in enumerate(order):
            b = s - lags[o]
            if 0 <= b < nblocks:
                mask[b * rows:(b + 1) * rows] |= field[b * rows:(b + 1) * rows] == colour
        x = torch.where(mask, x + update, x)
    return x


def _boxed(fields, boxes):
    out = torch.zeros_like(fields)
    for k, (i0, i1, j0, j1) in enumerate(boxes):
        out[k, i0:i1, j0:j1] = fields[k, i0:i1, j0:j1]
    return out


def _rowchunk_btx(level, x):
    """``B^T x`` as the stream kernel sums it: per row block (the unit of its
    write-back), inside each column's bounding box, block after block."""
    B = _boxed(level.B, level.bbox)
    H, rows = x.shape[-2], mv.STREAM_ROWS
    btx = torch.zeros(x.shape[0], B.shape[0], dtype=x.dtype)
    for r0 in range(0, H, rows):
        btx = btx + torch.einsum("chw,khw->ck", x[:, r0:r0 + rows], B[:, r0:r0 + rows])
    return btx


def _full_weighting(r):
    """``f_c[I, J] = sum_{a, b} w_a w_b r[2I+1+a, 2J+1+b]``, ``w = (0.5, 1, 0.5)``."""
    rows = 0.5 * r[..., 0:-2:2, :] + r[..., 1:-1:2, :] + 0.5 * r[..., 2::2, :]
    return 0.5 * rows[..., 0:-2:2] + rows[..., 1:-1:2] + 0.5 * rows[..., 2::2]


def stream_visit_emulation(level, kind, f, x, x_coarse=None, xi=None, xi_lr=None):
    """What one stream-kernel launch computes, step by step as the kernel
    does; ``kind`` is ``"descend"`` (returns ``(x, f_c)``) or ``"ascend"``."""
    order = level.pre_order if kind == "descend" else level.post_order
    P = level._params(x.shape[0], order, f.ndim == 3, 2 if xi is not None else 0, None,
                      route="stream")
    lags = [P.lag[o] for o in range(len(order))]
    assert P.max_lag == max(lags)
    if kind == "ascend":  # formed as each row enters the ring
        x = x + level.coarse_scaling * prolongate(x_coarse, level.op.vshape)
    c = f if xi is None else f + level.noise_scale * xi  # the low-rank noise: below
    x = wavefront_sweep(level, order, lags, c, x)
    if level.B is not None:
        # u = W (B^T x - Sigma^1/2 n), x -= u_l Y_l
        btx = _rowchunk_btx(level, x)
        if xi_lr is not None:
            btx = btx - level.sigma_sqrt * xi_lr
        Y, Wm, ybox = level._woodbury[order]
        u = btx @ Wm.T
        x = x - torch.einsum("cl,lhw->chw", u, _boxed(Y, ybox))
    if kind == "ascend":
        return x
    r = f - level.op.apply_stencil(x)
    if level.B is not None:  # t = u + Sigma^-1/2 n, pass 2's low-rank term
        t = u if xi_lr is None else u + xi_lr / level.sigma_sqrt
        r = r - torch.einsum("ck,khw->chw", t, _boxed(level.B, level.bbox))
    return x, _full_weighting(r)


# ------------------------------------------------------------------ levels
@functools.lru_cache(maxsize=None)
def _jax_levels(level, lowrank, dtype, nx, omega=1.0):
    """(JAX op, pre, post smoothers), port FusedVisitLevel: the 5-point fine
    level (0) or its Galerkin 9-point coarsening (1); built once per module
    (the JAX set-up compiles per shape)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    a = jax_operator(nx, lowrank, dtype=jdt)
    if level:
        a = jgalerkin(a)
    coloring = jcoloring_for(a.offsets, a.vshape)
    jpre = JSORSmoother(a, omega, 1, FORWARD, coloring)
    jpost = JSORSmoother(a, omega, 1, BACKWARD, coloring)
    b = to_port(a, dtype)
    pre, post = SORSmoother(b, omega, 1, FORWARD), SORSmoother(b, omega, 1, BACKWARD)
    port = mv.FusedVisitLevel(b, pre.coloring, omega, pre.order, post.order,
                              pre.B_bar, post.B_bar, GAMMA)
    return a, jpre, jpost, port


def _synthetic_level(vshape, offsets, coloring=None, seed=0):
    """A diagonally dominant stencil with varying coefficient planes on
    ``vshape`` (any number of rows), with the given or the cheapest colouring."""
    rng = np.random.default_rng(seed)
    coeffs = -rng.uniform(0.2, 1.0, size=(len(offsets),) + vshape)
    d = offsets.index((0, 0))
    coeffs[d] = len(offsets) + rng.uniform(size=vshape)
    lattice_shape = tuple(n + 1 for n in reversed(vshape))  # cells, x axis first
    op = operator_from_numpy(coeffs, offsets, lattice_shape, device="cpu",
                             dtype=torch.float64)
    coloring = coloring or coloring_for(offsets, vshape)
    K = coloring.n_colors
    return mv.FusedVisitLevel(op, coloring, 0.9, color_order(K, FORWARD),
                              color_order(K, BACKWARD), None, None, GAMMA)


def _colouring(vshape, weights, K):
    return Coloring(n_colors=K, field=_linear_coloring(vshape, weights, K), weights=weights)


# ---------------------------------------------------------- (a) the schedule
SCHEDULE_CASES = {
    "flagship_5point_2colour": lambda: _jax_levels(0, True, torch.float64, 16)[3],
    "galerkin_9point_4colour": lambda: _jax_levels(1, True, torch.float64, 16)[3],
    "31x31_5point": lambda: _jax_levels(0, False, torch.float64, 32)[3],
    "5_rows": lambda: _synthetic_level((5, 11), OFFSETS5, seed=1),
    "5point_5colour": lambda: _synthetic_level(
        (9, 13), OFFSETS5, _colouring((9, 13), (1, 2), 5), seed=2),
    "9point_4colour_other_weights": lambda: _synthetic_level(
        (11, 7), OFFSETS9, _colouring((11, 7), (2, 1), 4), seed=3),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_wavefront_schedule_is_the_colour_ordered_sweep(case):
    level = SCHEDULE_CASES[case]()
    assert mv.kernel_support_error(level.op, level.coloring.n_colors) is None
    rng = np.random.default_rng(7)
    C, vshape = 3, level.op.vshape
    c, x = tt(rng.normal(size=(C,) + vshape)), tt(rng.normal(size=(C,) + vshape))
    for order in (level.pre_order, level.post_order):
        P = level._params(C, order, True, 0, None, route="stream")
        lags = [P.lag[o] for o in range(len(order))]
        assert lags == list(mv.wavefront_lags(level.op.offsets, level.coloring.weights,
                                              level.coloring.n_colors, order))
        got = wavefront_sweep(level, order, lags, c, x)
        want = sweep_batched_plain(level.op, level.masks, level.omega, order, c, x)
        assert torch.equal(got, want), float((got - want).abs().max())
        if -(-vshape[0] // mv.STREAM_ROWS) > max(lags):
            # on a field of enough row blocks, lags one step shorter break the sweep
            short = [max(lag - 1, 0) for lag in lags]
            bad = wavefront_sweep(level, order, short, c, x)
            assert not torch.allclose(bad, want, rtol=1e-6, atol=1e-6)


def test_wavefront_lags_of_the_flagship_colourings():
    for order in ((0, 1), (1, 0)):
        assert mv.wavefront_lags(OFFSETS5, (1, 1), 2, order) == (0, 2)
    for order in ((0, 1, 2, 3), (3, 2, 1, 0)):
        assert mv.wavefront_lags(OFFSETS9, (1, 2), 4, order) == (0, 2, 4, 6)
    with pytest.raises(ValueError, match="not proper"):
        mv.wavefront_lags(OFFSETS9, (1, 1), 2, (0, 1))


# ------------------------------------------------------ (b) the whole visit
@pytest.mark.parametrize("level_index", [0, 1], ids=["5point", "galerkin9point"])
@pytest.mark.parametrize("f_batched", [False, True], ids=["fshared", "fbatched"])
def test_stream_visit_emulation_matches_plain_and_jax_float64(level_index, f_batched):
    a, jpre, jpost, port = _jax_levels(level_index, True, torch.float64, 16)
    rng = np.random.default_rng(11)
    C, vshape = 3, a.vshape
    f = rng.normal(size=((C,) if f_batched else ()) + vshape)
    x = rng.normal(size=(C,) + vshape)
    xc = rng.normal(size=(C,) + tuple(v // 2 for v in vshape))
    xi, xi_lr = rng.normal(size=x.shape), rng.normal(size=(C, a.lowrank.m))

    # noise off: the plain versions and the JAX composed path
    got_x, got_fc = stream_visit_emulation(port, "descend", tt(f), tt(x))
    want_x, want_fc = mv.descend_visit_plain(port, tt(f), tt(x))
    torch.testing.assert_close(got_x, want_x, **F64_TIGHT)
    torch.testing.assert_close(got_fc, want_fc, **F64_TIGHT)
    jx = jpre.apply(jnp.asarray(f), jnp.asarray(x))
    assert_close(got_x, jx, **F64_TIGHT)
    assert_close(got_fc, jrestrict(jnp.asarray(f) - a.apply(jx), dim=2), **F64_TIGHT)
    got = stream_visit_emulation(port, "ascend", tt(f), tt(x), tt(xc))
    torch.testing.assert_close(got, mv.ascend_visit_plain(port, tt(f), tt(x), tt(xc)),
                               **F64_TIGHT)
    assert_close(got, jpost.apply(jnp.asarray(f), jprolongate_add(
        GAMMA, jnp.asarray(xc), jnp.asarray(x), dim=2)), **F64_TIGHT)

    # noise as tensors (the kernels' mode 2): the plain versions on the same draws
    lr = tt(xi_lr)
    got_x, got_fc = stream_visit_emulation(port, "descend", tt(f), tt(x), xi=tt(xi), xi_lr=lr)
    want_x, want_fc = mv.descend_visit_plain(port, tt(f), tt(x), tt(xi), lr)
    torch.testing.assert_close(got_x, want_x, **F64_TIGHT)
    torch.testing.assert_close(got_fc, want_fc, **F64_TIGHT)
    got = stream_visit_emulation(port, "ascend", tt(f), tt(x), tt(xc), xi=tt(xi), xi_lr=lr)
    torch.testing.assert_close(
        got, mv.ascend_visit_plain(port, tt(f), tt(x), tt(xc), tt(xi), lr), **F64_TIGHT)


@pytest.mark.parametrize("level_index", [0, 1], ids=["5point", "galerkin9point"])
def test_stream_visit_emulation_matches_interpreted_pallas_kernels(level_index):
    a, jpre, jpost, port = _jax_levels(level_index, True, torch.float32, 16, omega=0.9)
    jfused = JFusedVisitLevel(a, jpre.coloring, 0.9, jpre.order, jpost.order,
                              jpre.B_bar, jpost.B_bar, coarse_scaling=GAMMA, interpret=True)
    rng = np.random.default_rng(12)
    C = 2
    f = rng.normal(size=a.vshape)
    x = rng.normal(size=(C,) + a.vshape)
    xc = rng.normal(size=(C,) + tuple(v // 2 for v in a.vshape))
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    t32 = lambda v: tt(v, torch.float32)  # noqa: E731
    jx, jfc = jfused.descend(jax.random.key(0), f32(f), f32(x), noise=False)
    px, pfc = stream_visit_emulation(port, "descend", t32(f), t32(x))
    assert_close(px, jx, **F32)
    assert_close(pfc, jfc, **F32)
    jxa = jfused.ascend(jax.random.key(0), f32(f), f32(x), f32(xc), noise=False)
    assert_close(stream_visit_emulation(port, "ascend", t32(f), t32(x), t32(xc)), jxa, **F32)


# ------------------------------------------------------------ (c) the route
#: a stream threshold for the route's mechanics (the production table holds
#: it for the flagship's 255^2 5-point level alone, mv.STREAM_MIN_CHAINS)
STREAM_MIN = 256


def test_route_is_chosen_from_the_chain_count_alone(monkeypatch):
    """The chain count decides, against the threshold of the level's shape
    and stencil form: the production table has one for the flagship's 255^2
    5-point level only, so a 15^2 level never takes the stream kernels, unless
    the table is given one for that shape too."""
    _, _, _, port = _jax_levels(0, True, torch.float32, 16)
    key = port.op.vshape + (port.stencil_form,)
    assert mv.STREAM_MIN_CHAINS == {(255, 255, 0): 256}  # what the table supports
    assert mv.stream_min_chains((255, 255), 0) == 256
    assert mv.stream_min_chains((255, 255), 2) is None  # the 9-point 255^2 level
    assert mv.stream_min_chains(port.op.vshape, port.stencil_form) is None
    for C in (1, 2, mv.SPLIT_MAX_CHAINS, mv.SPLIT_MAX_CHAINS + 1, STREAM_MIN - 1,
              STREAM_MIN, 256, 1000):
        # with a threshold for the shape: the stream kernels from it on; without
        # a shape and a form: never
        with monkeypatch.context() as m:
            m.setattr(mv, "STREAM_MIN_CHAINS", {key: STREAM_MIN})
            want = "stream" if C >= STREAM_MIN else "phase"
            assert mv.visit_route(C, device=CPU) == "phase"
            if C > mv.SPLIT_MAX_CHAINS:
                assert mv.visit_route(C, device=CPU, vshape=(1031, 9),
                                      form=port.stencil_form) == "phase"
                assert mv.visit_route(C, device=CPU, vshape=port.op.vshape,
                                      form=port.stencil_form) == want
        # the production table: the flagship's 255^2 level from 256 chains
        assert mv.visit_route(C, device=CPU) == "phase"
        want = "stream" if C >= 256 else "phase"
        assert mv.visit_route(C, 0, CPU, vshape=(255, 255), form=0) == (
            "split" if C <= mv.SPLIT_MAX_CHAINS else want)
        assert mv.visit_route(C, 0, CPU, vshape=(255, 255), form=1) == (
            "split" if C <= mv.SPLIT_MAX_CHAINS else "phase")
        want = "phase"
        if C <= mv.SPLIT_MAX_CHAINS:  # a 15^2 level: the split kernels' bands fit
            want = "split"
        assert port.route(C) == want  # a 15^2 level: no stream threshold
        for order in (port.pre_order, port.post_order):
            for f_batched in (False, True):
                for noise_mode in (0, 1, 2):
                    P = port._params(C, order, f_batched, noise_mode, (5, 6))
                    assert isinstance(P, mv.StreamParams) == (want == "stream")
                    assert isinstance(P, mv.SplitParams) == (want == "split")
                    visit = P.v if want == "stream" else P.v[0] if want == "split" else P
                    assert (visit.C, visit.seed, visit.counter) == (C, 5, 6)
    with pytest.raises(ValueError, match="route must be"):
        port._params(4, port.pre_order, False, 0, None, route="cluster")


def test_both_routes_reject_what_the_kernels_do_not_take():
    # a reach-2 (13-point) stencil: the stream and split kernels refuse it,
    # the phase kernels' reach-2 build takes it, at many chains too
    offsets = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-2, 0), (2, 0), (0, -2), (0, 2),
               (-1, -1), (-1, 1), (1, -1), (1, 1))
    level = _synthetic_level((9, 9), offsets, seed=4)
    assert mv.kernel_support_error(level.op, level.coloring.n_colors) is None
    for route in ("stream", "split"):
        with pytest.raises(NotImplementedError, match="reach-1"):
            level._params(300, level.pre_order, False, 0, None, route=route)
    assert level.route(300) == "phase"
    assert isinstance(level._params(300, level.pre_order, False, 0, None), mv.WideVisitParams)
    # the launches take CUDA tensors only: no CPU path behind either route
    _, _, _, port = _jax_levels(0, False, torch.float32, 16)
    x = torch.zeros((2,) + port.op.vshape)
    xc = torch.zeros((2,) + port.vc)
    for route in mv.ROUTES:
        with pytest.raises(ValueError, match="CUDA device"):
            mv.launch_descend(port, route, x[0], x)
        with pytest.raises(ValueError, match="CUDA device"):
            mv.launch_ascend(port, route, x[0], x, xc)
    assert all(v == 0 for v in mv.launch_counts.values())


# (level, vshape, offsets, colours (weights, K), stream kernels' bytes of the
# larger launch at m = 8 and 256 threads, route at 256 chains)
LAYOUT_CASES = {
    "flagship_255_5point": ((255, 255), OFFSETS5, ((1, 1), 2), 75212, "stream"),
    "flagship_127_galerkin": ((127, 127), OFFSETS9, ((1, 2), 4), 72140, "stream"),
    "wide_511_5point": ((511, 511), OFFSETS5, ((1, 1), 2), 148940, "stream"),
    # 1023^2 and 511^2 x 4 colours: 64 ring rows of 1028 or 128 of 516 floats
    "1023_5point": ((1023, 1023), OFFSETS5, ((1, 1), 2), 296396, "phase"),
    "511_9point_4colour": ((511, 511), OFFSETS9, ((1, 2), 4), 281036, "phase"),
}


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_route_takes_the_phase_kernels_where_the_rings_do_not_fit(monkeypatch, case):
    vshape, offsets, (weights, K), want_bytes, want_route = LAYOUT_CASES[case]
    order = tuple(range(K))
    lags = mv.wavefront_lags(offsets, weights, K, order)
    threads = mv.stream_threads(vshape[1])
    got = max(mv.stream_smem_bytes(*vshape, max(lags), 8, threads, ascend)
              for ascend in (False, True))
    assert got == want_bytes
    assert (got + mv.STREAM_STATIC_SMEM <= mv.SMEM_PER_BLOCK_OPTIN) == (want_route == "stream")
    # the stream kernels where the table holds a threshold for the shape and
    # their rings fit a block
    form = mv.stencil_form(offsets, [1.0] * len(offsets))
    monkeypatch.setattr(mv, "STREAM_MIN_CHAINS", {})
    assert mv.visit_route(256, got, smem_limit=mv.SMEM_PER_BLOCK_OPTIN, vshape=vshape,
                          form=form) == "phase"
    monkeypatch.setattr(mv, "STREAM_MIN_CHAINS", {vshape + (form,): STREAM_MIN})
    assert mv.visit_route(256, got, smem_limit=mv.SMEM_PER_BLOCK_OPTIN, vshape=vshape,
                          form=form) == want_route
    assert mv.visit_route(STREAM_MIN - 1, got, smem_limit=mv.SMEM_PER_BLOCK_OPTIN,
                          vshape=vshape, form=form) == "phase"


def test_level_route_follows_its_layout(monkeypatch):
    # a level's route takes its own shape: a wide synthetic level (no
    # measurements) takes the phase kernels at any chain count above the split
    # kernels' (whose bands of two rows fit it)
    level = _synthetic_level((9, 1031), OFFSETS5, seed=5)
    H, W = level.op.vshape
    lags = mv.wavefront_lags(OFFSETS5, level.coloring.weights, 2, level.post_order)
    assert level.stream_bytes == mv.stream_smem_bytes(H, W, max(lags), 0, 256, True)
    assert level.stream_bytes + mv.STREAM_STATIC_SMEM > mv.SMEM_PER_BLOCK_OPTIN
    assert level.route(1) == "split"
    for C in (mv.SPLIT_MAX_CHAINS + 1, STREAM_MIN, 4 * STREAM_MIN):
        assert level.route(C) == "phase"
        assert isinstance(level._params(C, level.pre_order, False, 0, None), mv.VisitParams)
    # a narrow level's rings fit: the production table holds no threshold for
    # its shape, so the phase kernels; with one the stream kernels from it on
    narrow = _synthetic_level((1031, 9), OFFSETS5, seed=5)
    assert narrow.route(STREAM_MIN) == "phase"
    monkeypatch.setattr(mv, "STREAM_MIN_CHAINS", {(9, 1031, level.stencil_form): STREAM_MIN,
                                                  (1031, 9, narrow.stencil_form): STREAM_MIN})
    for C in (mv.SPLIT_MAX_CHAINS + 1, STREAM_MIN, 4 * STREAM_MIN):
        assert mv.visit_route(C, level.stream_bytes, CPU, mv.SMEM_PER_BLOCK_OPTIN,
                              level.op.vshape, level.stencil_form) == "phase"
    assert mv.visit_route(STREAM_MIN, narrow.stream_bytes, CPU, mv.SMEM_PER_BLOCK_OPTIN,
                          narrow.op.vshape, narrow.stencil_form) == "stream"
    assert mv.visit_route(STREAM_MIN - 1, narrow.stream_bytes, CPU, mv.SMEM_PER_BLOCK_OPTIN,
                          narrow.op.vshape, narrow.stencil_form) == "phase"
    # another stencil form of the same shape has no threshold
    assert mv.visit_route(STREAM_MIN, narrow.stream_bytes, CPU, mv.SMEM_PER_BLOCK_OPTIN,
                          narrow.op.vshape, narrow.stencil_form ^ 1) == "phase"


def test_layout_mirror_constants_match_the_kernel_source():
    src = (Path(mv.__file__).resolve().parents[2] / "csrc" / "mgmc_visit_stream.cu").read_text()
    defines = dict(re.findall(r"^#define (STREAM_\w+|MAX_STREAM_THREADS) (\d+)", src, re.M))
    assert {k: int(v) for k, v in defines.items()} == {
        "STREAM_ROWS": mv.STREAM_ROWS, "STREAM_PREFETCH": mv.STREAM_PREFETCH,
        "STREAM_TILE": mv.STREAM_TILE, "STREAM_COL0": mv.STREAM_COL0,
        "MAX_STREAM_THREADS": mv.MAX_STREAM_THREADS}
    statics = re.findall(r"__shared__ (float|int) s_\w+\[(\w+)(?: \* (\w+))?\];", src)
    sizes = {"STREAM_MAX_LOWRANK": mv.STREAM_MAX_LOWRANK, "MAX_COLORS": mv.MAX_COLORS}
    assert "#define STREAM_MAX_LOWRANK LANE_SLOTS" in src
    assert mv.STREAM_STATIC_SMEM == sum(
        4 * sizes[a] * (sizes[b] if b else 1) for _, a, b in statics)
