"""Shared driver setup: config -> lattice, correlation model, prior/posterior
operators, and the drivers' command line.

Counterpart of ``multigridmc_tpu/drivers/common.py``.  The JAX drivers pick
their platform through an environment variable; here the device is an option of
the command line: the card unless ``--device cpu`` is given.  A run on the card
is float32, a run on the CPU float64 (the parity surface).
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..lattice import Lattice
from ..models.correlation import (
    ConstantCorrelationLengthModel,
    PeriodicCorrelationLengthModel,
)
from ..models.posterior import MeasurementParameters, measured_operator
from ..models.prior import prior_operator
from ..utils.config import Config
from ..utils.runtime import resolve_device


def parse_command_line(argv, prog: str, description: str):
    """``(config path, device, dtype)`` from ``CONFIGURATIONFILE [--device D]``.
    Without ``--device`` the run needs a CUDA device and raises when there is
    none; it never moves to the CPU on its own."""
    parser = argparse.ArgumentParser(prog=prog, description=description)
    parser.add_argument("config", metavar="CONFIGURATIONFILE")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda); 'cpu' runs in float64 on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    return args.config, device, run_dtype(device)


def run_dtype(device: torch.device) -> torch.dtype:
    """float32 on a CUDA device, float64 on the CPU."""
    return torch.float64 if device.type == "cpu" else torch.float32


def synchronize(device) -> None:
    """Wait for the device's queued work (a host clock around GPU work needs
    it); nothing to do on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_lattice(config: Config) -> Lattice:
    lp = config.lattice
    dim = config.general.dim
    if dim == 2:
        return Lattice((lp.nx, lp.ny))
    if dim == 3:
        return Lattice((lp.nx, lp.ny, lp.nz))
    print(f"ERROR: invalid dimension {dim}")
    sys.exit(-1)


def build_correlation_model(config: Config):
    name = config.prior.correlationlengthmodel
    if name == "constant":
        return ConstantCorrelationLengthModel(config.constant_correlationlength.Lambda)
    if name == "periodic":
        return PeriodicCorrelationLengthModel(
            config.periodic_correlationlength.Lambda_min,
            config.periodic_correlationlength.Lambda_max,
        )
    print(f"ERROR: invalid correlation length model '{name}'")
    sys.exit(-1)


def measurement_params(config: Config) -> MeasurementParameters:
    m = config.measurements
    return MeasurementParameters(
        measurement_locations=m.measurement_locations,
        mean=m.mean,
        variance=m.variance,
        radius=m.radius,
        variance_scaling=m.variance_scaling,
        sample_location=m.sample_location,
        measure_global=m.measure_global,
        mean_global=m.mean_global,
        variance_global=m.variance_global,
    )


def build_operators(config: Config, device=None, dtype=None):
    """Returns ``(prior, posterior_or_prior, measurement_params)`` following the
    drivers' operator selection, on ``device`` in ``dtype``."""
    lattice = build_lattice(config)
    model = build_correlation_model(config)
    prior = prior_operator(config.prior.pdemodel, lattice, model, device=device, dtype=dtype)
    mparams = measurement_params(config)
    if config.general.operator == "posterior":
        op = measured_operator(prior, mparams)
    elif config.general.operator == "prior":
        op = prior
    else:
        print(f"ERROR: invalid operator '{config.general.operator}'")
        sys.exit(-1)
    return prior, op, mparams
