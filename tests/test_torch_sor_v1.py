"""The four raw-array sweep entry points (counterparts of the first-generation
Pallas sweeps of ``multigridmc_tpu/ops/kernels/sor_pallas.py``).

On the CPU the entry points run their plain versions.  The deterministic pair
is held in float32 against ``fused_sor_sweep`` / ``fused_sor_sweep_batched`` of
the JAX package in interpret mode at ``rtol = atol = 2e-5`` (the tolerance of
``tests/test_pallas_kernels.py``).  The Gibbs pair cannot run in interpret mode
(``pltpu.prng_seed`` has no CPU rule); its plain versions, fed the normals
``xi``, are held in float64 against the JAX ``sor_sweep`` on
``f + sqrt(diag (2 - omega) / omega) xi`` at ``rtol = 1e-10``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu.models.prior import shiftedlaplace_fd, shiftedlaplace_fem
from multigridmc_tpu.ops.coloring import coloring_for
from multigridmc_tpu.ops.kernels import sor_pallas
from multigridmc_tpu.smoothers import sor_sweep

from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

F32 = dict(rtol=2e-5, atol=2e-5)


def problem(assemble, dtype, reverse, nx=16):
    op = assemble(Lattice((nx, nx)), ConstantCorrelationLengthModel(0.2), dtype=dtype)
    coloring = coloring_for(op.offsets, op.vshape)
    order = tuple(range(coloring.n_colors))
    if reverse:
        order = tuple(reversed(order))
    kw = dict(offsets=op.offsets, diag_index=op.diag_index, omega=0.9, order=order,
              color_weights=coloring.weights, n_colors=coloring.n_colors)
    return op, coloring, kw


def tensor(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("assemble", [shiftedlaplace_fd, shiftedlaplace_fem], ids=["fd", "fem"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_fused_sor_sweep_matches_jax_kernel(assemble, reverse):
    op, _, kw = problem(assemble, jnp.float32, reverse)
    rng = np.random.default_rng(0)
    b = rng.normal(size=op.vshape).astype(np.float32)
    x = rng.normal(size=op.vshape).astype(np.float32)
    want = sor_pallas.fused_sor_sweep(op.coeffs, jnp.asarray(b), jnp.asarray(x), interpret=True,
                                      **kw)
    coeffs = tensor(op.coeffs, torch.float32)
    got = ss.fused_sor_sweep(coeffs, torch.as_tensor(b), torch.as_tensor(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    plain = ss.fused_sor_sweep_plain(coeffs, torch.as_tensor(b), torch.as_tensor(x), **kw)
    assert torch.equal(got, plain)  # a CPU tensor takes the plain version


@pytest.mark.parametrize("assemble", [shiftedlaplace_fd, shiftedlaplace_fem], ids=["fd", "fem"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_fused_sor_sweep_batched_matches_jax_kernel(assemble, reverse):
    op, _, kw = problem(assemble, jnp.float32, reverse)
    rng = np.random.default_rng(3)
    C = 8
    b = rng.normal(size=(C,) + op.vshape).astype(np.float32)
    x = rng.normal(size=(C,) + op.vshape).astype(np.float32)
    want = sor_pallas.fused_sor_sweep_batched(op.coeffs, jnp.asarray(b), jnp.asarray(x),
                                              interpret=True, **kw)
    coeffs = tensor(op.coeffs, torch.float32)
    got = ss.fused_sor_sweep_batched(coeffs, torch.as_tensor(b), torch.as_tensor(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for c in (0, C - 1):  # a single chain is a batch of one
        one = ss.fused_sor_sweep(coeffs, torch.as_tensor(b[c]), torch.as_tensor(x[c]), **kw)
        torch.testing.assert_close(one, got[c], rtol=0, atol=0)


@pytest.mark.parametrize("assemble", [shiftedlaplace_fd, shiftedlaplace_fem], ids=["fd", "fem"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_gibbs_plain_versions_match_jax_sweep_on_noisy_rhs(assemble, batched):
    op, coloring, kw = problem(assemble, jnp.float64, reverse=batched)
    rng = np.random.default_rng(4)
    shape = ((5,) if batched else ()) + op.vshape
    f, x, xi = (rng.normal(size=shape) for _ in range(3))
    masks = jnp.asarray(coloring.masks())
    omega = kw["omega"]
    c = jnp.asarray(f) + jnp.sqrt(op.diag_stencil() * ((2.0 - omega) / omega)) * jnp.asarray(xi)
    want = sor_sweep(op, masks, omega, kw["order"], c, jnp.asarray(x))
    entry = ss.fused_gibbs_sweep_batched if batched else ss.fused_gibbs_sweep
    t = [tensor(a, torch.float64) for a in (op.coeffs, f, x, xi)]
    got = entry(None, t[0], t[1], t[2], xi=t[3], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    plain = (ss.fused_gibbs_sweep_batched_plain if batched else ss.fused_gibbs_sweep_plain)(
        t[3], t[0], t[1], t[2], **kw)
    assert torch.equal(got, plain)


def test_gibbs_entry_points_need_a_seed_or_normals():
    op, _, kw = problem(shiftedlaplace_fd, jnp.float64, False, nx=8)
    coeffs = tensor(op.coeffs, torch.float64)
    f = torch.zeros(op.vshape, dtype=torch.float64)
    for entry, args in ((ss.fused_gibbs_sweep, (coeffs, f, f)),
                        (ss.fused_gibbs_sweep_batched, (coeffs, f[None], f[None]))):
        with pytest.raises(ValueError, match="one of the two"):
            entry(None, *args, **kw)
        with pytest.raises(ValueError, match="one of the two"):
            entry(3, *args, xi=args[1], **kw)
        with pytest.raises(ValueError, match="CUDA kernel only"):
            entry(3, *args, **kw)  # the Philox stream lives in the kernel


@pytest.mark.parametrize("seed,want", [
    (7, (7, 0)),
    (-1, (0xFFFFFFFFFFFFFFFF, 0)),
    (np.int32(5), (5, 0)),
    (np.array([1, 2], dtype=np.uint32), (1 | (2 << 32), 0)),
    (np.array([1, 2, 3, 4], dtype=np.uint32), (1 | (2 << 32), 3 | (4 << 32))),
    (np.array([-1], dtype=np.int32), (0xFFFFFFFF, 0)),
    (torch.tensor([9, 8, 7]), (9 | (8 << 32), 7)),
], ids=["int", "negative", "numpy_scalar", "two_words", "four_words", "signed_word", "tensor"])
def test_philox_from_seed(seed, want):
    assert ss.philox_from_seed(seed) == want


def test_philox_from_seed_rejects_long_keys():
    with pytest.raises(ValueError, match="one to four"):
        ss.philox_from_seed(np.arange(5))


def test_raw_parameter_block_equals_the_plan_based_one():
    """``build_sweep_params`` from raw values gives the block that a
    ``SweepPlan`` builds, up to the planes that the plan sends as scalars."""
    from multigridmc_tpu_torch.lattice import Lattice as PLattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel as PConst
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd as pfd
    from multigridmc_tpu_torch.smoothers import SORSmoother

    op = pfd(PLattice((16, 16)), PConst(0.2), device="cpu", dtype=torch.float32)
    sm = SORSmoother(op, 0.9, 1)
    P = sm.plan._build_params(4, True, 2)
    Q = ss.build_sweep_params(op.vshape, op.offsets, op.diag_index, sm.coloring.n_colors,
                              sm.coloring.weights, sm.order, 0.9, (None,) * 5, None, 4, True, 2)
    skip = {"coeff_const", "coeff_val", "ns_const", "ns_val"}
    for name, _ in ss.SweepParams._fields_:
        a, b = getattr(P, name), getattr(Q, name)
        if name in skip:
            continue
        assert (list(a) == list(b)) if hasattr(a, "__len__") else (a == b), name
    assert list(P.coeff_const)[:5] == [1] * 5 and list(Q.coeff_const)[:5] == [0] * 5
    assert (P.Z, P.Y, P.X, P.K, P.n_colors, P.jstride) == (1, 15, 15, 5, 2, 2)
    assert set(ss.launch_counts) >= {"fused_sor_sweep", "fused_sor_sweep_batched",
                                     "fused_gibbs_sweep_batched", "fused_gibbs_sweep"}
    assert all(v == 0 for v in ss.launch_counts.values())  # nothing launches on the CPU
