"""The kernel module of the port on the CPU: the plain PyTorch versions of the
fused level-visit kernels against

* ``FusedVisitLevel.descend / ascend(noise=False)`` of the JAX package in
  Pallas interpret mode, exactly as ``tests/test_mgmc_visit.py`` runs them
  (float32, ``rtol = atol = 2e-5``: the two sum in different orders), and
* the JAX composed path in float64 (``rtol = 1e-10, atol = 1e-12``).

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds them
against these plain versions on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.ops.coloring import coloring_for as jcoloring_for
from multigridmc_tpu.ops.intergrid import prolongate_add as jprolongate_add
from multigridmc_tpu.ops.intergrid import restrict as jrestrict
from multigridmc_tpu.ops.kernels.mgmc_visit_pallas import FusedVisitLevel as JFusedVisitLevel
from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.smoothers import BACKWARD, FORWARD
from multigridmc_tpu.smoothers import SORSmoother as JSORSmoother

from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.smoothers import SORSmoother

from test_torch_common import F32, F64, assert_close, jax_operator, to_port, tt

GAMMA = 0.75


def _levels(lowrank, level, dtype, omega=1.0, **kw):
    """(JAX op, JAX pre, JAX post), (port FusedVisitLevel) on the 5-point fine
    level (0) or its Galerkin 9-point coarsening (1)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    a = jax_operator(32 if level else 24, lowrank, dtype=jdt, **kw)
    if level:
        a = jgalerkin(a)
    coloring = jcoloring_for(a.offsets, a.vshape)
    jpre = JSORSmoother(a, omega, 1, FORWARD, coloring)
    jpost = JSORSmoother(a, omega, 1, BACKWARD, coloring)
    b = to_port(a, dtype)
    pre = SORSmoother(b, omega, 1, FORWARD)
    post = SORSmoother(b, omega, 1, BACKWARD)
    port = mv.FusedVisitLevel(b, pre.coloring, omega, pre.order, post.order,
                              pre.B_bar, post.B_bar, GAMMA)
    return a, jpre, jpost, port


def _inputs(vshape, f_batched, seed, C=4):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=((C,) if f_batched else ()) + vshape)
    x = rng.normal(size=(C,) + vshape)
    xc = rng.normal(size=(C,) + tuple(n // 2 for n in vshape))
    return f, x, xc


@pytest.mark.parametrize("level", [0, 1], ids=["5point", "galerkin9point"])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
@pytest.mark.parametrize("f_batched", [False, True], ids=["fshared", "fbatched"])
def test_plain_visits_match_interpreted_pallas_kernels(level, lowrank, f_batched):
    a, jpre, jpost, port = _levels(lowrank, level, torch.float32, omega=0.9)
    jfused = JFusedVisitLevel(a, jpre.coloring, 0.9, jpre.order, jpost.order,
                              jpre.B_bar, jpost.B_bar, coarse_scaling=GAMMA, interpret=True)
    f, x, xc = _inputs(a.vshape, f_batched, seed=1)
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    t32 = lambda v: tt(v, torch.float32)  # noqa: E731

    jx, jfc = jfused.descend(jax.random.key(0), f32(f), f32(x), noise=False)
    px, pfc = mv.descend_visit(port, t32(f), t32(x))
    assert_close(px, jx, **F32)
    assert_close(pfc, jfc, **F32)

    jxa = jfused.ascend(jax.random.key(0), f32(f), f32(x), f32(xc), noise=False)
    pxa = mv.ascend_visit(port, t32(f), t32(x), t32(xc))
    assert_close(pxa, jxa, **F32)


@pytest.mark.parametrize("level", [0, 1], ids=["5point", "galerkin9point"])
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
@pytest.mark.parametrize("f_batched", [False, True], ids=["fshared", "fbatched"])
def test_plain_visits_match_composed_jax_path_float64(level, lowrank, f_batched):
    a, jpre, jpost, port = _levels(lowrank, level, torch.float64)
    f, x, xc = _inputs(a.vshape, f_batched, seed=2)
    jf, jx, jxc = jnp.asarray(f), jnp.asarray(x), jnp.asarray(xc)

    exp_x = jpre.apply(jf, jx)
    exp_fc = jrestrict(jf - a.apply(exp_x), dim=2)
    px, pfc = mv.descend_visit_plain(port, tt(f), tt(x))
    assert_close(px, exp_x, **F64)
    assert_close(pfc, exp_fc, **F64)

    exp_a = jpost.apply(jf, jprolongate_add(GAMMA, jxc, jx, dim=2))
    assert_close(mv.ascend_visit_plain(port, tt(f), tt(x), tt(xc)), exp_a, **F64)


def test_noisy_plain_visit_is_the_composed_gibbs_sweep():
    """With noise tensors the plain descend visit is SORSampler.apply followed
    by residual and restriction: same draws, same arithmetic."""
    from multigridmc_tpu_torch.ops.intergrid import restrict
    from multigridmc_tpu_torch.samplers.base import ReplayNoise
    from multigridmc_tpu_torch.samplers.sor import SORSampler

    _, _, _, port = _levels(True, 0, torch.float64)
    f, x, _ = _inputs(port.op.vshape, False, seed=3)
    rng = np.random.default_rng(4)
    xi, xi_lr = rng.normal(size=x.shape), rng.normal(size=(4, 4))
    got_x, got_fc = port.descend(ReplayNoise([xi, xi_lr]), tt(f), tt(x))
    sampler = SORSampler(port.op, 1.0, 1, FORWARD)
    want_x = sampler.apply(ReplayNoise([xi, xi_lr]), tt(f), tt(x))
    torch.testing.assert_close(got_x, want_x, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_fc, restrict(tt(f) - port.op.apply(want_x), dim=2),
                               rtol=1e-12, atol=1e-12)


def _kernel_woodbury(port, order, x):
    """What the CUDA kernel's Woodbury phase computes, from the very buffers it
    is handed: ``u = W B^T x`` and ``x - sum_l u_l Y_l`` with each ``Y_l`` read
    inside its bounding box only.  Returns ``(B^T x, corrected x)``."""
    Y, W, ybox = port._woodbury[order]
    boxed = torch.zeros_like(Y)
    for l, (i0, i1, j0, j1) in enumerate(ybox):
        boxed[l, i0:i1, j0:j1] = Y[l, i0:i1, j0:j1]
    btx = port.op.lowrank.bt(x)
    u = btx @ W.T
    return btx, x - torch.einsum("cl,lhw->chw", u, boxed)


@pytest.mark.parametrize("variance", ["order_one", "near_exact"])
@pytest.mark.parametrize("level", [0, 1], ids=["5point", "galerkin9point"])
def test_factored_woodbury_of_the_kernels_matches_jax_B_bar(level, variance):
    """The kernels apply ``B_bar`` through its factors ``Y`` (boxed) and ``W``;
    the JAX package applies the dense ``B_bar``.  Both directions, float64."""
    a, jpre, jpost, port = _levels(True, level, torch.float64, variance=variance)
    _, x, _ = _inputs(a.vshape, False, seed=6)
    for jsm, order in ((jpre, port.pre_order), (jpost, port.post_order)):
        _, got = _kernel_woodbury(port, order, tt(x))
        assert_close(got, jsm._lowrank_correct(jnp.asarray(x)), **F64)


@pytest.mark.parametrize("variance", ["order_one", "near_exact"])
@pytest.mark.parametrize("level", [0, 1], ids=["5point", "galerkin9point"])
def test_residual_shortcut_of_the_descend_kernel_matches_jax_residual(level, variance):
    """The descend kernel forms the low-rank part of the residual without a
    second reduction: ``t = u``, the Woodbury correction's ``W B^T x`` (noise
    off; with noise ``u + Sigma^-1/2 n``, ``tests/test_torch_lowrank_float32.py``),
    exactly ``Sigma^-1 B^T x'`` (``B^T x' = Sigma u``); the JAX package computes
    ``Sigma^-1 B^T x'`` on the corrected field, which cancels and costs
    ``Sigma^-1`` (about 1e6 when near exact) in relative accuracy, hence the
    absolute tolerance 1e-8 in float64 on values of order one."""
    a, jpre, _, port = _levels(True, level, torch.float64, variance=variance)
    f, x, _ = _inputs(a.vshape, False, seed=7)
    btx, xp = _kernel_woodbury(port, port.pre_order, tt(x))
    t = port.woodbury_u(port.pre_order, btx)
    got = tt(f) - port.op.apply_stencil(xp) - port.op.lowrank.expand(t)
    jxp = jpre._lowrank_correct(jnp.asarray(x))
    want = jnp.asarray(f) - a.apply(jxp)
    tol = dict(rtol=1e-10, atol=1e-12) if variance == "order_one" else dict(rtol=1e-8, atol=1e-8)
    assert_close(got, want, **tol)
    assert_close(t, a.lowrank.bt(jxp) / a.lowrank.Sigma_diag, **tol)


def test_auto_gate_raises_on_the_card_where_the_kernels_cannot_go(monkeypatch):
    """On a CUDA device the automatic gate never hands a float32 level, 2d or
    3d, to the composed path because of the kernels' own limits; it only
    leaves other dtypes there.  Stand-in operators carry the device, since
    none is present where these tests run; a level the gate admits is
    recorded, not built."""
    from types import SimpleNamespace as NS

    monkeypatch.setattr(mv, "FusedVisitLevel", lambda op, *args: ("fused", op.vshape))

    def stub(vshape, m=0, dtype=torch.float32, reach=1):
        offs = tuple((a * reach, b * reach) + (0,) * (len(vshape) - 2)
                     for a, b in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)))
        return NS(vshape=vshape, offsets=offs, m_lowrank=m, dtype=dtype,
                  device=torch.device("cuda"), lattice=NS(nvertex=int(np.prod(vshape))))

    def gate(op, n_colors=2, force=None):
        sm = NS(order=(0, 1), B_bar=None, coloring=NS(n_colors=n_colors), omega=1.0, nsmooth=1)
        return mv.fused_levels_for([op, op], [sm, sm], [sm, sm], 1.0, 0, force=force)

    # any measurement count whose low-rank scratch a block holds is admitted,
    # one past the lane slots and the 256 of the flagship's largest posterior
    # included; only the shared-memory limit beyond raises
    for m in (mv.LANE_SLOTS + 1, 64, 256):
        assert gate(stub((31, 31), m=m)) == {0: ("fused", (31, 31))}
    with pytest.raises(NotImplementedError, match="measurements"):
        gate(stub((31, 31), m=mv.max_lowrank(1024) + 1))
    with pytest.raises(NotImplementedError, match="colours"):
        gate(stub((31, 31)), n_colors=mv.MAX_COLORS + 1)
    # reach 2 is admitted (the phase kernels' reach-2 build), reach 3 refused
    assert mv.kernel_support_error(stub((31, 31), reach=2), 5) is None
    with pytest.raises(NotImplementedError, match="reach 3"):
        gate(stub((31, 31), reach=3))
    # a 3d float32 level takes the kernels' 3d build; one beyond its limits raises
    assert gate(stub((15, 15, 15))) == {0: ("fused", (15, 15, 15))}
    with pytest.raises(NotImplementedError, match="reach up to 1 only"):
        gate(stub((15, 15, 15), reach=2))
    for m in (mv.LANE_SLOTS + 1, 64):
        assert gate(stub((15, 15, 15), m=m)) == {0: ("fused", (15, 15, 15))}
    with pytest.raises(NotImplementedError, match="measurements"):
        gate(stub((15, 15, 15), m=mv.max_lowrank(mv.WIDE_MAX_THREADS) + 1))
    with pytest.raises(NotImplementedError, match="colours"):
        gate(stub((15, 15, 15)), n_colors=mv.MAX_COLORS + 1)
    assert gate(stub((15, 15, 15), dtype=torch.float64)) == {}
    assert gate(stub((31, 31), dtype=torch.float64)) == {}
    with pytest.raises(NotImplementedError, match="float32 only"):
        gate(stub((31, 31), dtype=torch.float64), force=True)


def test_compress_plan_detects_constants_and_supports():
    _, _, _, port = _levels(True, 0, torch.float32)
    assert all(c is not None for c in port.const_coeffs) and port.ns_const is not None
    d = float(port.op.diag_stencil()[5, 5])
    assert port.ns_const == pytest.approx(np.sqrt(d), rel=1e-6)
    B = port.op.lowrank.B.numpy()
    for k, (i0, i1, j0, j1) in enumerate(port.bbox):
        assert (i1 - i0, j1 - j0) == (1, 1)  # radius-0 columns are one-hot
        inside = np.zeros_like(B[k], dtype=bool)
        inside[i0:i1, j0:j1] = True
        assert np.all(B[k][~inside] == 0) and np.all(B[k][inside] != 0)
    _, _, _, coarse = _levels(True, 1, torch.float32)
    # a restricted one-hot column covers at most 3 x 3 coarse points
    assert all(i1 - i0 <= 3 and j1 - j0 <= 3 for (i0, i1, j0, j1) in coarse.bbox)
    # a varying kappa makes the diagonal plane, and with it the noise scale, vary
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import PeriodicCorrelationLengthModel
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd

    op = shiftedlaplace_fd(Lattice((16, 16)), PeriodicCorrelationLengthModel(0.1, 0.4),
                           device="cpu")
    cc, ns, bbox = mv.compress_plan(op, 1.0)
    assert cc[op.diag_index] is None and ns is None and bbox == ()
    assert all(c is not None for k, c in enumerate(cc) if k != op.diag_index)


def test_kernel_parameters_describe_the_level():
    _, _, _, port = _levels(True, 1, torch.float32)
    P = port._params(6, port.post_order, True, 2, None, route="phase")
    # the split kernels take one such block per sweep direction
    split = port._params(6, port.post_order, True, 2, None, route="split")
    assert split.ndir == 1 and bytes(split.v[0]) == bytes(P)
    assert (P.C, P.H, P.W, P.Hc, P.Wc) == (6, 15, 15, 7, 7)
    assert P.K == 9 and (P.dy[P.diag_index], P.dx[P.diag_index]) == (0, 0)
    assert P.n_colors == 4 and [P.order[i] for i in range(4)] == [3, 2, 1, 0]
    # colour period along the row direction for c = (w0 i + w1 j) mod K
    field = port.coloring.field
    assert np.all(field[:, : -P.jstride] == field[:, P.jstride:])
    assert P.m == 4 and P.noise_mode == 2 and P.f_batched == 1
    assert P.gamma == pytest.approx(GAMMA)


def test_philox_reference_is_standard_normal_and_streams_differ():
    v = (199, 201)
    z = mv.philox_normals_reference(seed=123, counter=5, chains=3, vshape=v)
    assert z.shape == (3,) + v and z.dtype == np.float32
    assert abs(z.mean()) < 0.02 and abs(z.var() - 1.0) < 0.02
    same = mv.philox_normals_reference(seed=123, counter=5, chains=3, vshape=v)
    np.testing.assert_array_equal(z, same)
    for other in (mv.philox_normals_reference(123, 6, 3, v),
                  mv.philox_normals_reference(124, 5, 3, v),
                  mv.philox_normals_reference(123, 5 + (1 << 32), 3, v)):
        assert abs(np.corrcoef(z.ravel(), other.ravel())[0, 1]) < 0.02
    assert abs(np.corrcoef(z[0].ravel(), z[1].ravel())[0, 1]) < 0.03
    # Philox4x32-10 known answer (Random123 test vector: counter and key all ones)
    words = _philox_words(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF)
    assert words == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def _philox_words(c0, c1, counter, seed):
    """The four raw Philox words for one counter, by the reference's recipe."""
    M0, M1, mask = 0xD2511F53, 0xCD9E8D57, 0xFFFFFFFF
    c = [c0, c1, counter & mask, counter >> 32]
    k = [seed & mask, seed >> 32]
    for _ in range(10):
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask, (p0 >> 32) ^ c[3] ^ k[1], p0 & mask]
        k = [(k[0] + 0x9E3779B9) & mask, (k[1] + 0xBB67AE85) & mask]
    return c


# ---------------------------------------------------------------- negative tests
def test_wrapper_rejects_what_the_kernels_do_not_take():
    _, _, _, port = _levels(True, 0, torch.float32)
    f, x, xc = (tt(v, torch.float32) for v in _inputs(port.op.vshape, False, seed=5))
    with pytest.raises(ValueError, match="CUDA kernel only"):
        mv.descend_visit(port, f, x, philox=(1, 2))
    with pytest.raises(ValueError, match="x must be"):
        mv._check_visit_args(port, f, x[0], None, None, None)
    with pytest.raises(ValueError, match="xi_lr must be"):
        mv._check_visit_args(port, f, x, torch.zeros_like(x), None, None)
    with pytest.raises(ValueError, match="x_coarse must be"):
        mv._check_visit_args(port, f, x, None, None, None, x_coarse=xc[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        mv._check_visit_args(port, f, x.transpose(1, 2), None, None, None)
    with pytest.raises(TypeError, match="float32 only"):
        mv._check_visit_args(port, f.double(), x, None, None, None)
    with pytest.raises(ValueError, match="one direction"):
        mv.FusedVisitLevel(port.op, port.coloring, 1.0, port.pre_order, port.post_order,
                           port.Bbar_pre, None, 1.0)


def test_unported_kernel_variants_raise():
    """Three sweeps per visit and 1d levels raise; two sweeps per visit (SSOR)
    and 3d levels are admitted (the kernels' 3d build) and left to the composed
    path only where the gate is off, as on the CPU by default."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd

    model = ConstantCorrelationLengthModel(0.3)
    op3 = shiftedlaplace_fd(Lattice((8, 8, 8)), model, device="cpu")
    sm = SORSmoother(op3)
    assert mv.kernel_support_error(op3, 2) is None
    assert mv.FusedVisitLevel(op3, sm.coloring, 1.0, sm.order, sm.order, None, None,
                              1.0).stencil_form == mv.DIM3_FORM0
    _, _, _, port = _levels(False, 0, torch.float32)
    two = (port.pre_order, port.post_order)
    assert mv.FusedVisitLevel(port.op, port.coloring, 1.0, two, two, None, None,
                              1.0).ndir == 2
    with pytest.raises(ValueError, match="once or twice"):
        mv.FusedVisitLevel(port.op, port.coloring, 1.0, two + two[:1], two, None, None, 1.0)
    op1 = shiftedlaplace_fd(Lattice((16,)), model, device="cpu")
    assert "2d and 3d" in mv.kernel_support_error(op1, 2)
    # the gate: off on the CPU unless forced; forced, a 3d hierarchy is fused
    assert mv.fused_levels_for([op3, op3], [sm, sm], [sm, sm], 1.0, 0, force=None) == {}
    assert list(mv.fused_levels_for([op3, op3], [sm, sm], [sm, sm], 1.0, 0, force=True)) == [0]
