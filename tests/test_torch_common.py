"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Every test builds its inputs from a seed with numpy and hands the same arrays
to the JAX package and to the PyTorch port (``device="cpu"``).  The port's
operators are rebuilt from the JAX operators' arrays through
``multigridmc_tpu_torch.convert``, so both sides run on identical operators.
"""

import numpy as np
import jax.numpy as jnp
import torch

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu.models.prior import shiftedlaplace_fd

from multigridmc_tpu_torch.convert import operator_from_numpy

# Every test worker imports this helper when it collects.  Several workers run
# at once, and torch's default intra-op thread pool per worker oversubscribes
# the cores: the small tensors of these tests run hundreds of times slower so.
torch.set_num_threads(1)

CPU = "cpu"
#: float64 parity: only the summation order differs between the two packages
F64 = dict(rtol=1e-10, atol=1e-12)
#: float32 against the fused JAX kernels (the tolerance of tests/test_mgmc_visit.py)
F32 = dict(rtol=2e-5, atol=2e-5)


def measurement_params(n_meas=4, seed=5, variance="order_one", dim=2):
    rng = np.random.default_rng(seed)
    var = 0.5 + rng.uniform(size=n_meas)
    if variance == "small":
        var = 1e-4 * var
    if variance == "near_exact":  # the production regime: Sigma^-1 about 1e6
        var = 1e-6 * var
    return MeasurementParameters(
        measurement_locations=rng.uniform(0.1, 0.9, size=(n_meas, dim)),
        mean=rng.normal(size=n_meas),
        variance=var,
    )


def jax_operator(nx=24, lowrank=True, dtype=jnp.float64, Lambda=0.3, **kw):
    """Shifted-Laplace FD prior (optionally with point measurements) of the
    JAX package."""
    op = shiftedlaplace_fd(Lattice((nx, nx)), ConstantCorrelationLengthModel(Lambda),
                           dtype=dtype)
    if lowrank:
        op = measured_operator(op, measurement_params(**kw))
    return op


def to_port(op, dtype=torch.float64):
    """The port's operator built from a JAX operator's arrays."""
    lr = op.lowrank
    return operator_from_numpy(
        np.asarray(op.coeffs), op.offsets, op.lattice.shape,
        B=None if lr is None else np.asarray(lr.B),
        Sigma_diag=None if lr is None else np.asarray(lr.Sigma_diag),
        device=CPU, dtype=dtype)


def tt(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def assert_close(port_tensor, jax_array, **tol):
    np.testing.assert_allclose(port_tensor.detach().numpy(), np.asarray(jax_array), **tol)
