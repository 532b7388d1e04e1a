"""The sweep-kernel module of the port on the CPU: the plain PyTorch versions of
the two sweep kernels against

* ``sweep_batched_v2(..., interpret=True)`` of the JAX package, exactly as
  ``tests/test_pallas_v2.py`` runs it (float32, ``rtol = atol = 2e-5``: the two
  sum in different orders), and
* the JAX composed Gibbs sweep (``SORSampler.random_rhs`` + ``sor_sweep``) under
  the same normals in float64 (``rtol = 1e-10``, ``atol = 1e-12``: summation
  order only).  The Pallas Gibbs kernel cannot run on the CPU (its generator
  has no interpret mode), so its composed form is the reference.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds them
against these plain versions on the card.  What surrounds them (the parameter
block, the chain layout, the argument checks, the generator's reference) is
tested here.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConstant
from multigridmc_tpu.models.correlation import PeriodicCorrelationLengthModel as JPeriodic
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshiftedlaplace_fd
from multigridmc_tpu.models.prior import squared_shiftedlaplace_fd as jsquared_fd
from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.ops.coloring import coloring_for as jcoloring_for
from multigridmc_tpu.ops.kernels import sor_pallas_v2 as v2
from multigridmc_tpu.samplers.sor import SORSampler as JSORSampler
from multigridmc_tpu.smoothers import color_order as jcolor_order
from multigridmc_tpu.smoothers import sor_sweep as jsor_sweep

from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import SORSmoother, sor_sweep

from test_torch_common import F32, F64, assert_close, to_port, tt


def _jax_operator(kind, dtype):
    if kind == "fd5pt":
        return jshiftedlaplace_fd(JLattice((24, 24)), JConstant(0.3), dtype=dtype)
    if kind == "galerkin9pt":
        return jgalerkin(jshiftedlaplace_fd(JLattice((32, 32)), JConstant(0.3), dtype=dtype))
    if kind == "periodic5pt":  # coefficient planes (and the diagonal) vary in space
        return jshiftedlaplace_fd(JLattice((24, 24)), JPeriodic(0.2, 0.4), dtype=dtype)
    if kind == "3d7pt":
        return jshiftedlaplace_fd(JLattice((8, 10, 12)), JConstant(0.3), dtype=dtype)
    if kind == "3d27pt":
        return jgalerkin(jshiftedlaplace_fd(JLattice((12, 12, 16)), JConstant(0.3), dtype=dtype))
    if kind == "reach2_13pt":
        return jsquared_fd(JLattice((16, 16)), JConstant(0.3), dtype=dtype)
    raise ValueError(kind)


KINDS = ["fd5pt", "galerkin9pt", "periodic5pt", "3d7pt", "3d27pt", "reach2_13pt"]


def _inputs(vshape, b_batched, seed, C=3):
    rng = np.random.default_rng(seed)
    b = rng.normal(size=((C,) if b_batched else ()) + vshape)
    x = rng.normal(size=(C,) + vshape)
    xi = rng.normal(size=(C,) + vshape)
    return b, x, xi


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("kind", ["fd5pt", "galerkin9pt", "3d7pt"])
def test_plain_sweep_matches_interpreted_pallas_kernel(kind, direction, omega):
    a = _jax_operator(kind, jnp.float32)
    coloring = jcoloring_for(a.offsets, a.vshape)
    order = jcolor_order(coloring.n_colors, direction)
    b, x, _ = _inputs(a.vshape, True, seed=3)
    want = v2.sweep_batched_v2(
        a.coeffs, jnp.asarray(b, jnp.float32), jnp.asarray(x, jnp.float32),
        offsets=a.offsets, diag_index=a.diag_index, omega=omega, order=order,
        color_weights=coloring.weights, n_colors=coloring.n_colors, interpret=True)
    plan = SORSmoother(to_port(a, torch.float32), omega, 1, direction).plan
    assert plan.order == tuple(order) and plan.coloring.weights == tuple(coloring.weights)
    got = ss.sweep_batched(plan, tt(b, torch.float32), tt(x, torch.float32))
    assert_close(got, want, **F32)


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_sweep_matches_jax_sor_sweep_float64(kind, direction, omega):
    a = _jax_operator(kind, jnp.float64)
    coloring = jcoloring_for(a.offsets, a.vshape)
    masks = jnp.asarray(coloring.masks())
    order = jcolor_order(coloring.n_colors, direction)
    b, x, _ = _inputs(a.vshape, False, seed=4)
    want = jsor_sweep(a, masks, omega, order, jnp.asarray(b), jnp.asarray(x))
    plan = SORSmoother(to_port(a), omega, 1, direction).plan
    got = ss.sweep_batched(plan, tt(b), tt(x))
    assert_close(got, want, **F64)
    assert sor_sweep is ss.sweep_batched_plain


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_gibbs_sweep_matches_jax_composed_sweep(monkeypatch, kind, direction, omega):
    """``gibbs_sweep_batched_plain`` fed ``xi`` against ``random_rhs`` +
    ``sor_sweep`` of the JAX package under the same draw.  The noise scale is
    the diagonal *plane* (``periodic5pt`` varies it), and ``omega = 1.3`` shows
    a wrong factor that ``omega = 1`` would hide."""
    a = _jax_operator(kind, jnp.float64)
    f, x, xi = _inputs(a.vshape, True, seed=5)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(xi))
    jsampler = JSORSampler(a, omega, 1, direction)
    c = jsampler.random_rhs(jax.random.key(0), jnp.asarray(f), jnp.asarray(x))
    sm = jsampler.smoother
    want = jsor_sweep(a, sm.masks, omega, sm.order, c, jnp.asarray(x))
    plan = SORSmoother(to_port(a), omega, 1, direction).plan
    got = ss.gibbs_sweep_batched(plan, tt(f), tt(x), xi=tt(xi))
    assert_close(got, want, **F64)
    assert_close(plan.noise_scale, jsampler.sqrt_precision_diag, **F64)


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    a = _jax_operator("fd5pt", jnp.float64)
    plan = SORSmoother(to_port(a), 1.0, 1).plan
    b, x, xi = (tt(v) for v in _inputs(a.vshape, True, seed=6))
    ss.reset_launch_counts()
    x0 = x.clone()
    out = ss.sweep_batched(plan, b, x)
    assert torch.equal(x, x0) and out is not x  # the plain version returns a new tensor
    ss.gibbs_sweep_batched(plan, b, x, xi=xi)
    assert {"sweep_batched", "gibbs_sweep_batched"} <= set(ss.launch_counts)
    assert all(count == 0 for count in ss.launch_counts.values())  # no launch on the CPU
    assert not plan.on_kernel_device()
    with pytest.raises(ValueError, match="Philox stream exists in the CUDA kernel only"):
        ss.gibbs_sweep_batched(plan, b, x, philox=(1, 2))
    with pytest.raises(ValueError, match="one of the two"):
        ss.gibbs_sweep_batched(plan, b, x)
    with pytest.raises(ValueError, match="one of the two"):
        ss.gibbs_sweep_batched(plan, b, x, xi=xi, philox=(1, 2))


def test_argument_checks_of_the_kernel_route():
    a = _jax_operator("fd5pt", jnp.float32)
    plan = SORSmoother(to_port(a, torch.float32), 1.0, 1).plan
    b, x, xi = (tt(v, torch.float32) for v in _inputs(a.vshape, True, seed=7))
    assert ss._check_sweep_args(plan, b, x, xi) == (3, True)
    assert ss._check_sweep_args(plan, b[0], x) == (3, False)
    with pytest.raises(ValueError, match="x must be"):
        ss._check_sweep_args(plan, b, x[0])
    with pytest.raises(ValueError, match="b must be"):
        ss._check_sweep_args(plan, b[:2], x)
    with pytest.raises(ValueError, match="xi must have the shape"):
        ss._check_sweep_args(plan, b, x, xi[:2])
    with pytest.raises(TypeError, match="float32 only"):
        ss._check_sweep_args(plan, b.double(), x)
    with pytest.raises(ValueError, match="contiguous"):
        ss._check_sweep_args(plan, b, x.transpose(1, 2))


@pytest.mark.parametrize("kind", ["fd5pt", "galerkin9pt", "periodic5pt", "3d27pt", "reach2_13pt"])
def test_parameter_block_describes_the_operator(kind):
    a = _jax_operator(kind, jnp.float32)
    op = to_port(a, torch.float32)
    sm = SORSmoother(op, 1.3, 1, "backward")
    P = sm.plan.params(5, True, 1, (7, (1 << 40) + 3))
    lead = 3 - len(op.vshape)
    assert (P.C, P.Z, P.Y, P.X) == (5,) + (1,) * lead + op.vshape
    assert P.K == len(op.offsets) and P.diag_index == op.diag_index
    offsets = [(P.dz[k], P.dy[k], P.dx[k])[lead:] for k in range(P.K)]
    assert offsets == [tuple(o) for o in op.offsets]
    assert [P.order[o] for o in range(P.n_order)] == list(reversed(range(sm.coloring.n_colors)))
    # the colours the kernel regenerates from the weights are the smoother's masks
    grids = np.meshgrid(*[np.arange(n) for n in op.vshape], indexing="ij")
    weights = (P.wz, P.wy, P.wx)[lead:]
    colour = sum(w * g for w, g in zip(weights, grids)) % P.n_colors
    np.testing.assert_array_equal(colour, sm.coloring.field)
    assert P.n_colors % P.jstride == 0 and (P.wx * P.jstride) % P.n_colors == 0
    # constant planes travel as scalars, varying ones by pointer
    const, ns_const, _ = common.compress_plan(op, 1.3)
    for k in range(P.K):
        assert bool(P.coeff_const[k]) == (const[k] is not None)
        if const[k] is not None:
            assert P.coeff_val[k] == np.float32(const[k])
    assert bool(P.ns_const) == (ns_const is not None)
    if kind == "periodic5pt":
        assert not P.coeff_const[P.diag_index] and not P.ns_const
    assert (P.noise_mode, P.b_batched, P.seed, P.counter) == (1, 1, 7, (1 << 40) + 3)
    assert abs(P.omega - 1.3) < 1e-6
    # the block is cached per launch configuration; only the stream changes
    assert sm.plan.params(5, True, 1, (7, 9)) is P and P.counter == 9


def test_flatten_chains_layout():
    vshape = (5, 6)
    x = torch.arange(2 * 3 * 30, dtype=torch.float32).reshape(2, 3, 5, 6)
    b = torch.ones(vshape)
    bf, xf, batch = ss.flatten_chains(vshape, b, x)
    assert bf.shape == vshape and xf.shape == (6, 5, 6) and batch == (2, 3)
    assert xf.data_ptr() == x.data_ptr()  # a view: the kernel's in-place update reaches x
    bf, xf, batch = ss.flatten_chains(vshape, x[:, :1], x)  # b broadcasts over chains
    assert bf.shape == (6, 5, 6) and bf.is_contiguous()
    assert torch.equal(bf[1], x[0, 0]) and torch.equal(bf[5], x[1, 0])
    bf, xf, batch = ss.flatten_chains(vshape, b, x[0, 0])  # a single field: a batch of one
    assert xf.shape == (1, 5, 6) and batch == ()


def test_kernel_support_limits():
    a = _jax_operator("fd5pt", jnp.float32)
    op = to_port(a, torch.float32)
    assert ss.kernel_support_error(op, 2) is None
    assert "colours" in ss.kernel_support_error(op, ss.MAX_COLORS + 1)
    assert ss.kernel_support_error(to_port(_jax_operator("3d27pt", jnp.float32)), 8) is None


def test_philox_reference_addresses_rows_in_storage_order():
    """The generator's reference in 3d: row ``z * Y + y`` of a ``(Z, Y, X)``
    field is row ``z * Y + y`` of the ``(Z * Y, X)`` field with the same
    normals, and streams differ by chain and counter."""
    z3 = common.philox_normals_reference(11, 5, 2, (3, 4, 9))
    z2 = common.philox_normals_reference(11, 5, 2, (12, 9))
    assert z3.shape == (2, 3, 4, 9) and z3.dtype == np.float32
    np.testing.assert_array_equal(z3.reshape(2, 12, 9), z2)
    assert not np.array_equal(z3[0], z3[1])
    assert not np.array_equal(z2, common.philox_normals_reference(11, 6, 2, (12, 9)))
    big = common.philox_normals_reference(3, 0, 4, (64, 64))
    assert abs(big.mean()) < 0.05 and abs(big.var() - 1.0) < 0.05
