"""The Gibbs sweep's low-rank noise and the descend's residual term in float32,
on the CPU.

The JAX package adds a sweep's low-rank noise to the rhs as ``B Sigma^{-1/2}
n`` and corrects with ``x' = x - B_bar B^T x``; its visit kernel forms the
residual's low-rank term as ``t = Sigma^{-1} (I - G) B^T x``.  The port carries
``Sigma^{1/2} n`` into the correction, ``x' = x_f - Y u`` with ``u = W (B^T x_f
- Sigma^{1/2} n)``, and takes ``t = u + Sigma^{-1/2} n``.  Here:

* the identity: the two forms give the same ``x'`` in float64 on a small
  near-exact level (``Sigma`` about 1e-6), 2d and 3d, to 1e-12 of its scale;
  ``t`` is ``Sigma^{-1} B^T x'`` to 1e-12 of its scale (the Gram form's own
  float64 cancellation, 1e-9);
* float32 against float64 on the same draws, on a 31^2 level with 4
  measurements of variance ``1e-6 (1 + u)``: ``B^T x`` within ``1e-3
  sqrt(Sigma)`` through the plain visits, the composed SOR and SSOR samplers
  and the subtree kernel's plain version; the descend's ``f_c`` within 1e-4 of
  its scale.
"""

import numpy as np
import pytest
import torch

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.samplers.base import ReplayNoise
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.samplers.sor import SORSampler, SSORSampler
from multigridmc_tpu_torch.smoothers import BACKWARD, FORWARD, SORSmoother, sor_sweep

CPU = "cpu"
#: B^T x of float32 against float64, in units of sqrt(Sigma)
BTX_TOL = 1e-3
#: the descend's f_c of float32 against float64, of its largest value
FC_TOL = 1e-4


def near_exact(shape, n_meas, seed=20260816, dtype=torch.float64):
    """An FD posterior (Lambda 0.2) with point measurements of variance
    ``1e-6 (1 + u)``."""
    rng = np.random.default_rng(seed)
    params = MeasurementParameters(
        measurement_locations=rng.uniform(0.15, 0.85, size=(n_meas, len(shape))),
        mean=rng.normal(size=n_meas), variance=1e-6 * (1.0 + rng.uniform(size=n_meas)))
    prior = shiftedlaplace_fd(Lattice(shape), ConstantCorrelationLengthModel(0.2), device=CPU,
                              dtype=dtype)
    return measured_operator(prior, params)


def sor_level(op, omega=1.0):
    pre, post = SORSmoother(op, omega, 1, FORWARD), SORSmoother(op, omega, 1, BACKWARD)
    return mv.FusedVisitLevel(op, pre.coloring, omega, pre.order, post.order, pre.B_bar,
                              post.B_bar, 0.75)


def draws(op, C, seed):
    """Per sweep the field, then the m low-rank scalars."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(C,) + op.vshape), rng.normal(size=(C, op.m_lowrank))


def tpu_form(level, f, x, xi, n):
    """One forward Gibbs sweep and its correction as the JAX package computes
    them (the rhs holds ``B Sigma^-1/2 n``, ``x' = x - B_bar B^T x``), and the
    visit kernel's residual term ``Sigma^-1 (I - G) B^T x``."""
    op, lr = level.op, level.op.lowrank
    m = lr.m
    c = f + level.noise_scale * xi + lr.expand(n / torch.sqrt(lr.Sigma_diag))
    x = sor_sweep(op, level.masks, level.omega, level.pre_order, c, x)
    btx = lr.bt(x)
    Bbar = level.Bbar_pre.reshape(m, -1)
    G = lr.B.reshape(m, -1) @ Bbar.T
    t = (btx - btx @ G.T) / lr.Sigma_diag
    return x - (btx @ Bbar).reshape(x.shape), t


@pytest.mark.parametrize("shape,n_meas", [((32, 32), 4), ((8, 8, 8), 3)], ids=["2d", "3d"])
def test_lowrank_noise_in_the_correction_is_the_rhs_form_float64(shape, n_meas):
    op = near_exact(shape, n_meas)
    level = sor_level(op)
    rng = np.random.default_rng(1)
    f, x = (torch.as_tensor(v) for v in rng.normal(size=(2, 2) + op.vshape))
    xi, n = (torch.as_tensor(v) for v in draws(op, 2, 2))
    old_x, old_t = tpu_form(level, f, x, xi, n)
    new_x, new_t = mv._sweeps_plain(level, level.pre_orders, level.Bbar_pre, f, x, xi, n)
    assert float((new_x - old_x).abs().max()) <= 1e-12 * float(old_x.abs().max())
    # t is Sigma^-1 B^T x' of the corrected field, to rounding
    exact = op.lowrank.bt(new_x) / op.lowrank.Sigma_diag
    scale = float(exact.abs().max())
    assert float((new_t - exact).abs().max()) <= 1e-12 * scale
    # the Gram form cancels B^T x of the size of x (hundreds here) down to
    # Sigma u, and so loses about Sigma^-1 eps64 in float64 (1.3e-11 and
    # 1.5e-10 of t's scale on these levels)
    assert float((new_t - old_t).abs().max()) <= 1e-9 * scale
    # the low-rank noise does move the sample: the test is not vacuous
    quiet_x, _ = mv._sweeps_plain(level, level.pre_orders, level.Bbar_pre, f, x, xi, 0 * n)
    assert float((quiet_x - new_x).abs().max()) > 1e-4


def btx_error(op64, x32, x64):
    """max |B^T x32 - B^T x64| in units of sqrt(Sigma)."""
    lr = op64.lowrank
    return float(((lr.bt(x32.double()) - lr.bt(x64)) / torch.sqrt(lr.Sigma_diag)).abs().max())


@pytest.fixture(scope="module")
def pair():
    """The 31^2 level in float64 and float32, its inputs and draws (f = 0, the
    zero-mean protocol of the float32 runs)."""
    op64 = near_exact((32, 32), 4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4,) + op64.vshape)
    return op64, op64.to(dtype=torch.float32), x


def test_float32_plain_visits_follow_float64(pair):
    op64, op32, x = pair
    lv64, lv32 = sor_level(op64), sor_level(op32)
    xi, n = draws(op64, 4, 5)
    xc = np.random.default_rng(6).normal(size=(4,) + lv64.vc)
    out = {}
    for dt, lv in ((torch.float64, lv64), (torch.float32, lv32)):
        t = lambda v: torch.as_tensor(v, dtype=dt)  # noqa: E731
        f = torch.zeros(op64.vshape, dtype=dt)
        out[dt] = (*mv.descend_visit_plain(lv, f, t(x), t(xi), t(n)),
                   mv.ascend_visit_plain(lv, f, t(x), t(xc), t(xi), t(n)))
    (x64, fc64, a64), (x32, fc32, a32) = out[torch.float64], out[torch.float32]
    assert btx_error(op64, x32, x64) < BTX_TOL
    assert btx_error(op64, a32, a64) < BTX_TOL
    scale = float(fc64.abs().max())
    assert float((fc32.double() - fc64).abs().max()) < FC_TOL * scale


@pytest.mark.parametrize("sampler", ["SOR", "SSOR"])
def test_float32_composed_samplers_follow_float64(pair, sampler):
    op64, op32, x = pair
    sweeps = 2 if sampler == "SSOR" else 1
    recorded = [d for s in range(sweeps) for d in draws(op64, 4, 7 + s)]
    out = {}
    for dt, op in ((torch.float64, op64), (torch.float32, op32)):
        make = SSORSampler(op, 1.0, 1) if sampler == "SSOR" else SORSampler(op, 1.0, 1)
        replay = ReplayNoise(recorded)
        out[dt] = make.apply(replay, torch.zeros(op.vshape, dtype=dt),
                             torch.as_tensor(x, dtype=dt))
        assert replay.exhausted
    assert btx_error(op64, out[torch.float32], out[torch.float64]) < BTX_TOL


def test_float32_subtree_plain_version_follows_float64():
    """The subtree kernel's plain version below a 64^2 posterior's level 0:
    its sub-level 0 is the 31^2 level with the 4 near-exact measurements."""
    op64 = near_exact((64, 64), 4)
    kernels = {dt: MultigridMCSampler(op64.to(dtype=dt), 4, cycle=2, subtree=True).subtree
               for dt in (torch.float64, torch.float32)}
    k64 = kernels[torch.float64]
    assert k64.vshape == (31, 31) and k64.levels[0].op.m_lowrank == 4
    rng = np.random.default_rng(9)
    f = rng.normal(size=(2,) + k64.vshape)
    xi = rng.normal(size=(2, k64.count_noise()))
    out = {dt: st.subtree_sample_plain(k, torch.as_tensor(f, dtype=dt),
                                       torch.as_tensor(xi, dtype=dt))
           for dt, k in kernels.items()}
    assert btx_error(k64.levels[0].op, out[torch.float32], out[torch.float64]) < BTX_TOL
