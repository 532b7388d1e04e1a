"""End-to-end posterior sampling on the PyTorch port.

Counterpart of ``examples/posterior_sampling.py``: build a Matern-like GMRF
prior on a 2d lattice, condition it on point measurements, and estimate the
posterior mean and variance fields with batched MGMC chains - the library-API
version of the ``drivers.mgmc`` experiment.  On the card the sampler runs in
float32 on the fused level-visit kernels with its coarse subtree distilled; on
the CPU (``--device cpu``) in float64 on the plain PyTorch path.  Either way it
samples the zero-mean posterior fluctuation and adds the exact mean computed
on the host in float64 (``MeanShiftedSampler``).

Run: ``python examples/posterior_sampling_torch.py [--device cpu]`` (the card
by default); ``--nx``, ``--chains``, ``--warmup`` and ``--steps`` size it.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.posterior import (MeasurementParameters, measured_operator,
                                                    posterior_mean)
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
from multigridmc_tpu_torch.samplers.base import GeneratorNoise, MeanShiftedSampler
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu_torch.utils.runtime import resolve_device
from multigridmc_tpu_torch.utils.vtk import VTKWriter


def run(device, nx=64, nchains=64, nwarmup=30, nsteps=200, output="posterior_example.vtk"):
    """Sample the example's posterior; returns the mean and variance fields
    (numpy) and writes them to ``output``."""
    device = resolve_device(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    # 1. prior: shifted-Laplace GMRF with correlation length 0.2
    lattice = Lattice((nx, nx))
    prior = shiftedlaplace_fd(lattice, ConstantCorrelationLengthModel(Lambda=0.2),
                              device=device, dtype=dtype)

    # 2. posterior: condition on 6 noisy point observations
    rng = np.random.default_rng(42)
    params = MeasurementParameters(
        measurement_locations=rng.uniform(0.15, 0.85, size=(6, 2)),
        mean=rng.normal(1.0, 0.5, size=6),
        variance=np.full(6, 1e-4),
    )
    op = measured_operator(prior, params)

    # 3. MGMC sampler: 4-level W-cycle, forward/backward SOR Gibbs smoothing,
    #    around the exact posterior mean (host float64)
    mu = posterior_mean(op, np.zeros(op.vshape), params.y())
    sampler = MeanShiftedSampler(MultigridMCSampler(op, nlevel=4, smoother="SOR", cycle=2), mu)

    noise = GeneratorNoise(0, device)
    f = torch.zeros(op.vshape, dtype=dtype, device=device)
    x = sampler.mean.expand((nchains,) + op.vshape).clone()
    for _ in range(nwarmup):
        x = sampler.apply(noise, f, x)
    s1 = torch.zeros(op.vshape, dtype=torch.float64, device=device)
    s2 = torch.zeros_like(s1)
    for _ in range(nsteps):
        x = sampler.apply(noise, f, x)
        e = (x - sampler.mean).double()  # the fluctuation, summed in float64
        s1 += e.sum(0)
        s2 += (e * e).sum(0)
    e_mean = (s1 / (nchains * nsteps)).cpu().numpy()
    e_sq = (s2 / (nchains * nsteps)).cpu().numpy()
    mean_field = mu + e_mean
    var_field = e_sq - e_mean ** 2
    print(f"{nchains * nsteps} samples on {device} ({dtype})")
    print(f"posterior mean range: [{mean_field.min():.3f}, {mean_field.max():.3f}]")
    print(f"posterior sd at measurements ~ {np.sqrt(var_field).min():.4f} (pinned)")
    print(f"posterior sd far field       ~ {np.sqrt(var_field).max():.4f}")

    writer = VTKWriter(output, lattice)
    writer.add_state(mean_field, "mean")
    writer.add_state(var_field, "variance")
    writer.write()
    print(f"wrote {output}")
    return mean_field, var_field


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--nx", type=int, default=64)
    parser.add_argument("--chains", type=int, default=64)
    parser.add_argument("--warmup", type=int, default=30)
    parser.add_argument("--steps", type=int, default=200)
    args = parser.parse_args(argv)
    run(args.device, args.nx, args.chains, args.warmup, args.steps)


if __name__ == "__main__":
    main()
