"""The reach-2 forms of the fused level visits (the squared shifted-Laplace
prior's 13-point diamond and the 5x5 box of its Galerkin levels) against the
JAX package, and how the port routes and refuses such levels (CPU).

The plain versions, which the kernels are held to on the card, agree with
JAX's ``FusedVisitLevel(..., interpret=True)`` in float32 with the noise off,
at the tolerances of ``tests/test_mgmc_visit.py::
test_biharmonic_visits_match_composed``: ``x`` within 2e-5, the restricted
residual within 2e-5 of ``max(|f_c|, 1)`` (``f - A x`` cancels in float32
against a diagonal of order ``h^-4``).  The edge terms that the CUDA passes
drop at reach 2 are replayed from the kernels' bit masks.
"""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
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

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.prior import squared_shiftedlaplace_fd
from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.smoothers import SORSmoother

from test_torch_common import measurement_params, to_port, tt

GAMMA = 0.75
CSRC = Path(mv.__file__).resolve().parents[2] / "csrc"


def _levels(level):
    """(JAX fused level, port fused level) on the 24x24 biharmonic posterior's
    level 0 (13-point, 5 colours) or its Galerkin level 1 (25-point, 9
    colours), float32."""
    a = jsquared(JLattice((24, 24)), JConst(0.3), dtype=jnp.float32)
    a = jmeasured(a, measurement_params(4, 5))
    if level:
        a = jgalerkin(a)
    coloring = jcoloring_for(a.offsets, a.vshape)
    jpre = JSORSmoother(a, 1.0, 1, FORWARD, coloring)
    jpost = JSORSmoother(a, 1.0, 1, BACKWARD, coloring)
    jfused = JFusedVisitLevel(a, coloring, 1.0, jpre.order, jpost.order, jpre.B_bar,
                              jpost.B_bar, coarse_scaling=GAMMA, interpret=True)
    b = to_port(a, torch.float32)
    pre, post = SORSmoother(b, 1.0, 1, FORWARD), SORSmoother(b, 1.0, 1, BACKWARD)
    port = mv.FusedVisitLevel(b, pre.coloring, 1.0, pre.order, post.order, pre.B_bar,
                              post.B_bar, GAMMA)
    return jfused, port


@pytest.mark.parametrize("level,offsets,colours,form", [(0, 13, 5, 7), (1, 25, 9, 9)],
                         ids=["13pt", "25pt"])
def test_reach2_plain_visits_match_interpreted_pallas_kernels(level, offsets, colours, form):
    jfused, port = _levels(level)
    assert (len(port.op.offsets), port.coloring.n_colors) == (offsets, colours)
    assert (port.reach, port.stencil_form) == (2, form)
    assert mv.kernel_support_error(port.op, port.coloring.n_colors) is None
    rng = np.random.default_rng(11)
    vshape, C = port.op.vshape, 4
    f = rng.normal(size=vshape)
    x = rng.normal(size=(C,) + vshape)
    xc = rng.normal(size=(C,) + tuple(n // 2 for n in vshape))
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    t32 = lambda v: tt(v, torch.float32)  # noqa: E731

    jx, jfc = jfused.descend(jax.random.key(0), f32(f), f32(x), noise=False)
    px, pfc = mv.descend_visit(port, t32(f), t32(x))
    assert float(np.max(np.abs(px.numpy() - np.asarray(jx)))) < 2e-5
    scale = float(np.max(np.abs(np.asarray(jfc))))
    assert float(np.max(np.abs(pfc.numpy() - np.asarray(jfc)))) < 2e-5 * max(scale, 1.0)
    ja = jfused.ascend(jax.random.key(0), f32(f), f32(x), f32(xc), noise=False)
    pa = mv.ascend_visit(port, t32(f), t32(x), t32(xc))
    assert float(np.max(np.abs(pa.numpy() - np.asarray(ja)))) < 2e-5


@pytest.mark.parametrize("level", [0, 1], ids=["13pt", "25pt"])
def test_reach2_levels_take_the_phase_kernels_at_every_chain_count(level):
    """Decided on the host before any launch: the route of the rule at 1, 16
    and 256 chains (a 23^2 or 11^2 level is not in the smem kernels' table:
    the phase kernels; the split and stream kernels are reach-1), the
    reach-2 build's parameter block, its launch count, at most 512 threads a
    block; the split and stream routes refuse the level; the stamps build
    takes a tensor of its own width (30 words a block at 9 colours)."""
    _, port = _levels(level)
    for C in (1, 16, 256):
        want = mv.visit_route(C, 0, port.op.device, vshape=port.op.vshape,
                              form=port.stencil_form, ndir=port.ndir)
        assert port.route(C) == want == "phase" and port.split_cluster(C) is None
        assert port.phase_threads(C) <= mv.WIDE_MAX_THREADS
    P = port._params(256, port.pre_order, False, 1, (3, 4))
    assert isinstance(P, mv.WideVisitParams) and (P.seed, P.counter) == (3, 4)
    assert P.K == len(port.op.offsets) and P.n_colors == port.coloring.n_colors
    assert [P.order[o] for o in range(P.n_order)] == list(port.pre_order)
    rows = mv.colour_rows(P)
    assert rows.shape == (P.n_order, 1 + 2 * P.n_colors)
    for route in ("split", "stream"):
        with pytest.raises(NotImplementedError, match="reach-1 stencils only"):
            port._params(1, port.pre_order, False, 0, None, route=route)
    size = "25" if level else "13"
    for kind in ("descend", "ascend"):
        assert mv.kernel_name(port, "phase", kind) == f"{kind}_visit_reach2_{size}pt"
        assert mv.launch_counts[mv.kernel_name(port, "phase", kind)] == 0
    x = torch.zeros((2,) + port.op.vshape)
    with pytest.raises(ValueError, match="CUDA device"):
        mv.launch_descend(port, "phase", x[0], x)
    with pytest.raises(ValueError, match=r"\(2, 30\) tensor"):
        mv._check_stamps(port, "phase", torch.zeros((2, mv.PHASE_STAMP_WIDTH),
                                                   dtype=torch.int64), x)
    mv._check_stamps(port, "phase", torch.zeros((2, mv.WIDE_STAMP_WIDTH), dtype=torch.int64), x)


@pytest.mark.parametrize("form", range(mv.WIDE_FORM0, mv.WIDE_FORM0 + mv.WIDE_FORMS))
def test_visit_route_sends_every_reach2_form_to_the_phase_kernels(form):
    """The rule itself, before any level is built: a reach-2 form takes the
    smem kernels where their table lists its shape, form and sweeps with the
    chain count in range, else the phase kernels, at any chain count, on the
    shape where a reach-1 form of as many colours takes the stream kernels
    (255^2, 256 chains) and where it splits (one chain); never the split or
    the stream kernels."""
    from multigridmc_tpu_torch.ops.kernels.mgmc_visit_smem import SMEM_CHAINS

    for shape in ((255, 255), (127, 127), (63, 63)):
        for C in (1, 16, 256, 1024):
            span = SMEM_CHAINS.get(shape + (form, 1))
            want = "smem" if span and C >= span[0] and (span[1] is None or C <= span[1]) else (
                "phase")
            assert mv.visit_route(C, 0, torch.device("cpu"), vshape=shape, form=form) == want
    assert mv.visit_route(256, 0, torch.device("cpu"), vshape=(255, 255), form=0) == "stream"
    assert mv.visit_route(1, 0, torch.device("cpu"), vshape=(255, 255), form=0) == "split"


def test_reach3_and_other_wide_stencils_raise():
    from types import SimpleNamespace as NS

    def stub(offsets, m=0):
        return NS(vshape=(31, 31), offsets=tuple(offsets), m_lowrank=m, dtype=torch.float32,
                  device=torch.device("cuda"), lattice=NS(nvertex=31 * 31))

    axis3 = ((0, 0), (-3, 0), (3, 0), (0, -3), (0, 3))
    assert "reach 3" in mv.kernel_support_error(stub(axis3), 2)
    box5 = tuple((i, j) for i in range(-2, 3) for j in range(-2, 3))
    assert mv.kernel_support_error(stub(box5), 9) is None
    assert "more than 9 colours" in mv.kernel_support_error(stub(box5), 10)
    assert "not the 5x5 box" in mv.kernel_support_error(stub(box5[::-1]), 9)
    assert "not the 5x5 box" in mv.kernel_support_error(stub(box5[:20]), 9)
    assert "more than 8 colours" in mv.kernel_support_error(stub(box5[6:9] + box5[11:14]), 9)

    sm = NS(order=(0, 1), B_bar=None, coloring=NS(n_colors=2), omega=1.0, nsmooth=1)
    with pytest.raises(NotImplementedError, match="reach 3"):
        mv.fused_levels_for([stub(axis3), stub(axis3)], [sm, sm], [sm, sm], 1.0, 0)


def test_subtree_kernel_refuses_reach2_before_any_launch():
    """Since the subtree kernel's reach-2 build, reach 2 builds (its plain
    version on the CPU) and what the kernel does not take - a reach-3
    sub-level, sub-levels of two reaches - raises at construction, before any
    launch."""
    from multigridmc_tpu_torch.convert import operator_from_numpy
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st

    prior = squared_shiftedlaplace_fd(Lattice((32, 32)), ConstantCorrelationLengthModel(0.2),
                                      device="cpu", dtype=torch.float32)
    kernel = MultigridMCSampler(prior, 4, cycle=2, subtree=True).subtree
    assert kernel.reach == 2 and [len(lv.op.offsets) for lv in kernel.levels] == [25, 25]
    f = torch.randn((2,) + kernel.vshape, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(st.subtree_sample(kernel, f)).all()
    axis3 = ((0, 0), (-3, 0), (3, 0), (0, -3), (0, 3))
    five = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))

    def level(offsets, n):
        coeffs = np.full((len(offsets), n, n), -1.0)
        coeffs[0] = 10.0
        return operator_from_numpy(coeffs, offsets, (n + 1, n + 1), device="cpu",
                                   dtype=torch.float32)

    for ops, match in (([level(axis3, 15), level(axis3, 7), level(five, 3)], "reach 3"),
                       ([level(five, 15), kernel.levels[1].op, level(five, 3)], "one reach")):
        pre = [SORSmoother(o, 1.0, 1, "forward") for o in ops[:-1]]
        post = [SORSmoother(o, 1.0, 1, "backward") for o in ops[:-1]]
        L = np.linalg.cholesky(ops[-1].to_dense())
        with pytest.raises(NotImplementedError, match=match):
            st.SubtreeKernel(ops, pre, post, L, 1.0, 2, 1.0)
    assert not any(st.launch_counts.values())


def test_stencil_forms_of_both_builds():
    diamond = ((0, 0),) + tuple((k, j) for j in range(-2, 3) for k in range(-2, 3)
                                if 0 < abs(j) + abs(k) <= 2)
    box5 = tuple((i, j) for i in range(-2, 3) for j in range(-2, 3))
    box3 = tuple((i, j) for i in range(-1, 2) for j in range(-1, 2))
    five = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    for offsets, base in ((five, 0), (box3, 2), (box3[::-1], 4), (diamond, 6), (box5, 8),
                          (box5[::-1][:13], 6)):
        assert mv.stencil_form(offsets, (1.0,) * len(offsets)) == base
        assert mv.stencil_form(offsets, (None,) + (1.0,) * (len(offsets) - 1)) == base + 1
    assert mv.WIDE_FORM0 == mv.STENCIL_FORMS
    # the source's forms and limits, as the library reports them on the card
    passes = (CSRC / "level_passes.cuh").read_text()
    assert f"#define WIDE_FORM0 {mv.WIDE_FORM0}" in passes
    assert f"#define WIDE_FORMS {mv.WIDE_FORMS}" in passes
    assert "#define WIDE_KMAX(FORM) ((FORM) < 8 ? 13 : 25)" in passes
    src = (CSRC / "mgmc_visit.cu").read_text()
    branch = src[src.index("#if VISIT_REACH == 2"):src.index("#elif VISIT_REACH != 1")]
    assert f"#define MAX_OFFSETS {mv.WIDE_MAX_OFFSETS}" in branch
    assert f"#define MAX_COLORS {mv.WIDE_MAX_COLORS}" in branch
    assert re.search(rf"#define PHASE_MAX_THREADS {mv.WIDE_MAX_THREADS}\b", src)


def test_the_reach2_build_is_a_library_of_its_own():
    assert common.PHASE_REACH2_FLAGS == ("-DVISIT_REACH=2",)
    assert ("mgmc_visit", common.PHASE_REACH2_FLAGS) in common.VARIANT_BUILDS
    wide = common.library_path("mgmc_visit", common.PHASE_REACH2_FLAGS)
    assert wide not in (common.library_path("mgmc_visit"),
                        common.library_path("mgmc_visit", common.PHASE_STAMPS_FLAGS))
    # the parameter blocks: the same fields, 25 offsets and 9 colours
    narrow, widep = mv.VisitParams, mv.WideVisitParams
    assert [n for n, _ in narrow._fields_] == [n for n, _ in widep._fields_]
    for name in ("dy", "dx", "coeff_const", "coeff_val"):
        assert (getattr(narrow, name).size, getattr(widep, name).size) == (4 * 9, 4 * 25)
    assert (narrow.order.size, widep.order.size) == (4 * 8, 4 * 9)
    # one more colour in each of the two sweep directions a launch may hold;
    # the reach-2 build's stamps build is a library of its own too
    assert mv.WIDE_STAMP_WIDTH == mv.PHASE_STAMP_WIDTH + mv.MAX_DIRS
    assert ("mgmc_visit", common.PHASE_REACH2_STAMPS_FLAGS) in common.STAMPS_BUILDS
    assert common.library_path("mgmc_visit", common.PHASE_REACH2_STAMPS_FLAGS) not in (
        wide, common.library_path("mgmc_visit", common.PHASE_STAMPS_FLAGS))
    with pytest.raises(ValueError, match="reach-2 build"):  # no reach-2 3d build
        mv.load_library(stamps=True, reach=2, dim=3)


def _edge_bits(offsets, box):
    """The masks of ``stencil_regs<KMAX, BOX, 2>`` (csrc/level_passes.cuh)."""
    bits = {name: 0 for name in ("all", "up", "dn", "lf", "rt", "up2", "dn2", "lf2", "rt2")}
    for k in range(25 if box else len(offsets)):
        dy, dx = (k // 5 - 2, k % 5 - 2) if box else offsets[k]
        bit = 1 << k
        bits["all"] |= bit
        for name, on in (("up", dy < 0), ("dn", dy > 0), ("lf", dx < 0), ("rt", dx > 0),
                         ("up2", dy < -1), ("dn2", dy > 1), ("lf2", dx < -1), ("rt2", dx > 1)):
            bits[name] |= bit if on else 0
    return bits


@pytest.mark.parametrize("box", [False, True], ids=["13pt", "25pt_box"])
@pytest.mark.parametrize("vshape", [(7, 9), (3, 2), (2, 5), (1, 1)])
def test_reach2_edge_bits_drop_exactly_the_terms_outside(box, vshape):
    """``row_terms`` / ``point_terms`` at reach 2: a point adds the terms
    whose neighbour lies inside the field and no other, two rows and two
    columns deep, on fields of one to a few rows and columns; the box form's
    offsets are the Galerkin levels' (sorted raster order)."""
    diamond = ((0, 0),) + tuple((k, j) for j in range(-2, 3) for k in range(-2, 3)
                                if 0 < abs(j) + abs(k) <= 2)
    offsets = tuple((i, j) for i in range(-2, 3) for j in range(-2, 3)) if box else diamond
    if box:
        assert offsets == tuple(sorted(offsets)) and mv.raster_box(offsets, 2)
    s = _edge_bits(offsets, box)
    H, W = vshape
    for i in range(H):
        row = s["all"] & ~(s["up"] if i == 0 else 0) & ~(s["dn"] if i == H - 1 else 0)
        row &= ~(s["up2"] if i == 1 else 0) & ~(s["dn2"] if i == H - 2 else 0)
        for j in range(W):
            t = row & ~(s["lf"] if j == 0 else 0) & ~(s["rt"] if j == W - 1 else 0)
            t &= ~(s["lf2"] if j == 1 else 0) & ~(s["rt2"] if j == W - 2 else 0)
            inside = sum(1 << k for k, (dy, dx) in enumerate(offsets)
                         if 0 <= i + dy < H and 0 <= j + dx < W)
            assert t == inside, (i, j)
