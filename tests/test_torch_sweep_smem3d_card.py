"""The smem3d sweep kernels (``csrc/sor_sweep_smem3d.cu``) on a card: both
kernels against their plain versions (``2e-5``) and against the generic body
of ``csrc/sor_sweep.cu`` on the same inputs and under one Philox stream
(``1e-6``), on a 31^3 7-point field whose diagonal varies, over clusters of
2, 4 and 16 blocks with the rhs in shared memory and in device memory.

Marked ``cuda``: without a card (and ``nvcc``) every case skips.  This file
imports no JAX; on a machine with a card and no JAX, skip ``tests/conftest.py``
(which sets JAX up for the CPU tests)::

    python -m pytest --noconftest -m cuda tests/test_torch_sweep_smem3d_card.py
"""

import pytest
import torch

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import PeriodicCorrelationLengthModel
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import BACKWARD, FORWARD, SORSmoother

TOL = 2e-5
BODY_TOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the smem3d kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("direction", [FORWARD, BACKWARD])
@pytest.mark.parametrize("config", [(2, False, 512), (4, True, 1024), (16, True, 256)])
def test_smem3d_kernels_against_plain_and_generic(card, config, direction):
    op = shiftedlaplace_fd(Lattice((32, 32, 32)), PeriodicCorrelationLengthModel(0.2, 0.4),
                           device=card)
    plan = SORSmoother(op, 1.3, 1, direction).plan
    assert plan.body == "smem3d"
    gen = torch.Generator(device=card)
    gen.manual_seed(7)
    C = 6
    x, b, xi = (torch.randn((C,) + op.vshape, device=card, generator=gen) for _ in range(3))
    want = ss.sweep_batched_plain(op, plan.masks, plan.omega, plan.order, b, x)
    got = ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), smem3d=config)
    old = ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), body="generic")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert float((got - old).abs().max()) <= BODY_TOL
    want = ss.gibbs_sweep_batched_plain(op, plan.masks, plan.omega, plan.order, b[0], x, xi)
    got = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b[0], x.clone(), xi=xi, smem3d=config)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    stream = (0x5EED_3D, 3)
    got = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), philox=stream,
                                smem3d=config)
    old = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), philox=stream,
                                body="generic")
    torch.cuda.synchronize()
    assert float((got - old).abs().max()) <= BODY_TOL
