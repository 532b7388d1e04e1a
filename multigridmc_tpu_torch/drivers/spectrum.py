"""Posterior covariance spectrum driver.

Counterpart of ``multigridmc_tpu/drivers/spectrum.py``: assemble the 2d FEM
prior and the measured posterior of the configuration, compute the
eigenvalues of the dense covariance ``Q^-1`` in float64 on the device, and
write them, largest first, to ``spectrum.csv`` (``j, value`` per line, the
JAX driver's format).  The covariance is symmetric, so its eigenvalues are
taken by ``torch.linalg.eigvalsh``: the same values as the general
eigenvalue solver's real parts, with less rounding.

Usage: ``python -m multigridmc_tpu_torch.drivers.spectrum CONFIGFILE [--device cpu]``
"""

from __future__ import annotations

import torch

from ..models.posterior import measured_operator
from ..models.prior import shiftedlaplace_fem
from ..utils.config import load_config
from ..utils.runtime import configure_runtime
from .common import (build_correlation_model, build_lattice, measurement_params,
                     parse_command_line)


def spectrum(config, device) -> torch.Tensor:
    """The eigenvalues of the configuration's posterior covariance, float64 on
    ``device``, largest first."""
    prior = shiftedlaplace_fem(build_lattice(config), build_correlation_model(config),
                               device=device, dtype=torch.float64)
    op = measured_operator(prior, measurement_params(config))
    Q = torch.as_tensor(op.to_dense(), dtype=torch.float64, device=device)
    cov = torch.linalg.inv(Q)
    return torch.linalg.eigvalsh(0.5 * (cov + cov.T)).flip(0)


def main(argv=None):
    configure_runtime()
    path, device, _ = parse_command_line(argv, "mgmc-spectrum-torch",
                                         "Posterior covariance spectrum (spectrum.csv)")
    evals = spectrum(load_config(path), device).cpu().numpy()
    with open("spectrum.csv", "w") as out:
        for j, ev in enumerate(evals):
            out.write(f"{j}, {ev:e}\n")
    print(f"wrote {len(evals)} eigenvalues to spectrum.csv")


if __name__ == "__main__":
    main()
