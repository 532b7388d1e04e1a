"""The fused level visits on 3d levels against the JAX package, on the CPU.

A 3d level (a lattice's 7-point FD level, 2 colours, and its 27-point Galerkin
levels, 8 colours) takes the phase kernels' 3d build (``csrc/mgmc_visit.cu
-DVISIT_DIM=3``).  The kernels cannot run here; their plain versions can:

* the plain 3d visits against the JAX package's ``FusedVisitLevel`` in Pallas
  interpret mode (float32, the JAX kernel's only dtype: ``rtol = atol =
  2e-5``) and against its composed path in float64 (``rtol = 1e-10, atol =
  1e-12``), on ``Lattice((10, 12, 14))`` and ``(16, 16, 16)``, both levels,
  with and without measurements (the shapes of ``tests/test_mgmc_visit.py``);
* whole 3d MGMC steps with fused levels against the JAX package's composed
  recursion, on the JAX draws replayed (float64, ``rtol = 1e-9, atol =
  1e-11``);
* the Woodbury factors of the 3d levels against the JAX package's ``B_bar``
  (float64, ``1e-12``).

``tests/test_torch_visit_3d_tables.py`` holds the kernels' tables, parameter
block and route.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConstant
from multigridmc_tpu.models.posterior import measured_operator as jmeasured
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshiftedlaplace_fd
from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.ops.coloring import coloring_for as jcoloring_for
from multigridmc_tpu.ops.intergrid import prolongate_add as jprolongate_add
from multigridmc_tpu.ops.intergrid import restrict as jrestrict
from multigridmc_tpu.ops.kernels.mgmc_visit_pallas import FusedVisitLevel as JFusedVisitLevel
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler as JMultigridMCSampler
from multigridmc_tpu.smoothers import BACKWARD, FORWARD
from multigridmc_tpu.smoothers import SORSmoother as JSORSmoother

from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.samplers.base import ReplayNoise
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.smoothers import SORSmoother, woodbury_factors

from test_torch_common import F32, F64, assert_close, measurement_params, to_port, tt

GAMMA = 0.75
REPLAY = dict(rtol=1e-9, atol=1e-11)


def jax_level(shape, level, lowrank, dtype=jnp.float64):
    """The JAX package's 3d FD prior (Lambda = 0.3), with three measurements
    where ``lowrank``, or its Galerkin coarsening (``level`` 1)."""
    a = jshiftedlaplace_fd(JLattice(shape), JConstant(0.3), dtype=dtype)
    if lowrank:
        a = jmeasured(a, measurement_params(n_meas=3, seed=21, dim=3))
    return jgalerkin(a) if level else a


def levels(shape, level, lowrank, dtype=torch.float64):
    """(JAX op, JAX pre, JAX post), the port's FusedVisitLevel."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    a = jax_level(shape, level, lowrank, jdt)
    coloring = jcoloring_for(a.offsets, a.vshape)
    jpre = JSORSmoother(a, 1.0, 1, FORWARD, coloring)
    jpost = JSORSmoother(a, 1.0, 1, BACKWARD, coloring)
    b = to_port(a, dtype)
    pre, post = SORSmoother(b, 1.0, 1, FORWARD), SORSmoother(b, 1.0, 1, BACKWARD)
    port = mv.FusedVisitLevel(b, pre.coloring, 1.0, pre.order, post.order, pre.B_bar,
                              post.B_bar, GAMMA)
    return a, jpre, jpost, port


def inputs(vshape, f_batched, seed, C=3):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=((C,) if f_batched else ()) + vshape)
    x = rng.normal(size=(C,) + vshape)
    xc = rng.normal(size=(C,) + tuple(n // 2 for n in vshape))
    return f, x, xc


CASES = [((10, 12, 14), 0, True), ((10, 12, 14), 1, True), ((16, 16, 16), 0, False),
         ((16, 16, 16), 1, False)]
IDS = ["10x12x14-7pt-posterior", "10x12x14-27pt-posterior", "16^3-7pt-prior",
       "16^3-27pt-prior"]


@pytest.mark.parametrize("shape,level,lowrank", CASES[:3], ids=IDS[:3])
def test_plain_3d_visits_match_interpreted_pallas_kernels(shape, level, lowrank):
    a, jpre, jpost, port = levels(shape, level, lowrank, torch.float32)
    assert port.stencil_form == (10 if level == 0 else 12)
    jfused = JFusedVisitLevel(a, jpre.coloring, 1.0, jpre.order, jpost.order, jpre.B_bar,
                              jpost.B_bar, coarse_scaling=GAMMA, interpret=True)
    f, x, xc = inputs(a.vshape, False, seed=1)
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    t32 = lambda v: tt(v, torch.float32)  # noqa: E731
    jx, jfc = jfused.descend(jax.random.key(0), f32(f), f32(x), noise=False)
    px, pfc = mv.descend_visit(port, t32(f), t32(x))
    assert_close(px, jx, **F32)
    assert_close(pfc, jfc, **F32)
    jxa = jfused.ascend(jax.random.key(0), f32(f), f32(x), f32(xc), noise=False)
    assert_close(mv.ascend_visit(port, t32(f), t32(x), t32(xc)), jxa, **F32)


@pytest.mark.parametrize("f_batched", [False, True], ids=["fshared", "fbatched"])
@pytest.mark.parametrize("shape,level,lowrank", CASES, ids=IDS)
def test_plain_3d_visits_match_composed_jax_path_float64(shape, level, lowrank, f_batched):
    a, jpre, jpost, port = levels(shape, level, lowrank)
    f, x, xc = inputs(a.vshape, f_batched, seed=2)
    jf, jx, jxc = jnp.asarray(f), jnp.asarray(x), jnp.asarray(xc)
    exp_x = jpre.apply(jf, jx)
    px, pfc = mv.descend_visit(port, tt(f), tt(x))
    assert_close(px, exp_x, **F64)
    assert_close(pfc, jrestrict(jf - a.apply(exp_x), dim=3), **F64)
    exp_a = jpost.apply(jf, jprolongate_add(GAMMA, jxc, jx, dim=3))
    assert_close(mv.ascend_visit(port, tt(f), tt(x), tt(xc)), exp_a, **F64)


@pytest.fixture
def recorded_normals(monkeypatch):
    """Every ``jax.random.normal`` draw made while the fixture is active, in
    call order."""
    draws = []
    real = jax.random.normal

    def recording(key, shape=(), dtype=None, **kw):
        out = real(key, shape, dtype, **kw) if dtype is not None else real(key, shape, **kw)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "normal", recording)
    return draws


def test_fused_3d_mgmc_steps_replay_jax_composed_recursion(recorded_normals):
    """Two MGMC steps on an 11^3 posterior (3 levels, W-cycle, 3 chains): the
    port with levels 0 (7-point) and 1 (27-point) fused, through the plain
    versions of the 3d kernels, against the JAX package's composed recursion
    on the same normals."""
    a = jax_level((12, 12, 12), 0, True)
    rng = np.random.default_rng(3)
    f, x = rng.normal(size=a.vshape), rng.normal(size=(3,) + a.vshape)
    jsampler = JMultigridMCSampler(a, nlevel=3, smoother="SOR", cycle=2, coarse_scaling=0.9,
                                   omega=1.0, distill=False)
    assert not jsampler.fused_levels and jsampler.distilled is None
    want = jnp.asarray(x)
    for step in range(2):
        want = jsampler.apply(jax.random.key(10 + step), jnp.asarray(f), want)
    sampler = MultigridMCSampler(to_port(a), nlevel=3, smoother="SOR", cycle=2,
                                 coarse_scaling=0.9, omega=1.0, fused=True, distill=False)
    assert sorted(sampler.fused_levels) == [0, 1]
    assert [lv.stencil_form for lv in sampler.fused_levels.values()] == [10, 12]
    replay = ReplayNoise(recorded_normals)
    got = tt(x)
    for _ in range(2):
        got = sampler.apply(replay, tt(f), got)
    assert replay.exhausted
    assert_close(got, want, **REPLAY)


@pytest.mark.parametrize("level", [0, 1], ids=["7pt", "27pt"])
def test_3d_woodbury_factors_match_jax_b_bar(level):
    """``B_bar = W^T Y`` from the port's factors against the JAX package's
    ``B_bar``, both directions; ``Y``'s boxes hold its support, which grows
    with the colours of the order (8 colours on the 27-point level)."""
    a, jpre, jpost, port = levels((16, 16, 16), level, True)
    for order, jsm in ((port.pre_order, jpre), (port.post_order, jpost)):
        Y, W, ybox = port._woodbury[order]
        masks = port.masks
        Y2, W2 = woodbury_factors(port.op, masks, 1.0, order)
        assert torch.equal(Y, Y2) and torch.equal(W, W2)
        m = Y.shape[0]
        assert_close((W.T @ Y.reshape(m, -1)).reshape(Y.shape), jsm.B_bar,
                     rtol=1e-12, atol=1e-12)
        for k, box in enumerate(ybox):
            outside = Y[k].clone()
            outside[mv.box_slices(box)] = 0
            assert len(box) == 6 and not outside.any()
    if level:  # the support grows by one point per colour of the order
        assert max(b[1] - b[0] for b in port._woodbury[port.pre_order][2]) > 3
