"""MGMC sampling experiment driver.

Counterpart of ``multigridmc_tpu/drivers/mgmc.py``: reads a config file, builds
the posterior operator, runs the configured samplers (Cholesky / SSOR / MGMC),
and reports per-sample timings, observed mean/variance vs the exact posterior
(``measure_sampling_time``), warmup convergence tables
(``measure_convergence``), and the posterior mean/variance field as VTK
(``posterior_statistics``).

Usage: ``python -m multigridmc_tpu_torch.drivers.mgmc CONFIGFILE [--device cpu]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..models.posterior import (
    measurement_vector,
    observed_mean_and_variance,
    posterior_mean,
)
from ..samplers.base import GeneratorNoise, MeanShiftedSampler
from ..samplers.cholesky import BandCholeskySampler, DenseCholeskySampler
from ..samplers.mgmc import MultigridMCSampler
from ..samplers.sor import SSORSampler
from ..utils.config import echo_config, load_config
from ..utils.runtime import configure_runtime
from ..utils.vtk import VTKWriter, write_vtk_circle
from .common import build_operators, parse_command_line, synchronize

#: chain steps between two copies of the observable to the host
CHUNK = 512


def make_samplers(config, op):
    samplers = {}
    if config.general.do_cholesky:
        t0 = time.perf_counter()
        if config.cholesky.factorisation == "dense":
            samplers["cholesky"] = DenseCholeskySampler(op)
        else:
            samplers["cholesky"] = BandCholeskySampler(op)
        synchronize(op.device)
        t1 = time.perf_counter()
        print(f"time for Cholesky factorisation = {t1 - t0:.4f} s")
    if config.general.do_ssor:
        samplers["ssor"] = SSORSampler(op, config.smoother.omega, config.smoother.nsmooth)
    if config.general.do_multigridmc:
        mg = config.multigrid
        samplers["multigridmc"] = MultigridMCSampler(
            op,
            nlevel=mg.nlevel,
            smoother=mg.smoother,
            coarse_solver=mg.coarse_solver,
            npresmooth=mg.npresmooth,
            npostsmooth=mg.npostsmooth,
            ncoarsesmooth=mg.ncoarsesmooth,
            omega=mg.omega,
            cycle=mg.cycle,
            coarse_scaling=mg.coarse_scaling,
            cholesky_factorisation=config.cholesky.factorisation,
            verbose=mg.verbose,
            sweep_schedule=mg.sweep_schedule,
            distill_precision=mg.distill_precision,
        )  # distill="auto": on a CUDA device the coarse subtree is distilled
        mgmc = samplers["multigridmc"]
        if mgmc.distilled is not None:
            level_op = mgmc.hierarchy.operators[mgmc.distill_level]
            print(f"multigridmc distilled subtree: level {mgmc.distill_level} "
                  f"({level_op.lattice.nvertex} vertices)")
        else:
            print("multigridmc distilled subtree: none")
    return samplers


def exact_setup(prior, op, mparams):
    """Exact posterior mean (host float64) and rhs ``f = Q_post mean`` (on the
    operator's device, in its dtype)."""
    xbar = np.zeros(op.lattice.vshape)
    y = mparams.y()
    mean_x_exact = posterior_mean(op, xbar, y) if op.lowrank is not None else xbar
    f = op.apply(torch.as_tensor(mean_x_exact, dtype=op.dtype, device=op.device))
    sample_vec = measurement_vector(
        op.lattice, mparams.sample_location, mparams.radius
    )
    return xbar, y, mean_x_exact, f, sample_vec


def _run_chain(sampler, noise, f, x, svec, k0, n):
    """``n`` chain steps from step index ``k0``; the observable
    ``z_k = <w, x_k>`` stays on the device and comes back as one tensor."""
    zs = []
    for k in range(k0, k0 + n):
        x = sampler.apply_indexed(noise, f, x, k)
        zs.append(x.reshape(-1) @ svec)
    return x, torch.stack(zs)


def measure_sampling_time(label, sampler, op, config, f, sample_vec, exact, filename):
    """Time series of the observable over one chain: ms per sample, sample
    mean and variance beside the exact ones (``exact``)."""
    sp = config.sampling
    svec = torch.as_tensor(sample_vec, dtype=op.dtype, device=op.device).reshape(-1)
    noise = GeneratorNoise(5418513, op.device)
    x = torch.zeros(op.lattice.vshape, dtype=op.dtype, device=op.device)

    # The chain is sequential; the observable is kept on the device and copied
    # out once per chunk, so no step waits for the host.
    sampler.fix_rhs(f)
    done = 0
    while done < sp.nwarmup:
        n = min(CHUNK, sp.nwarmup - done)
        x, _ = _run_chain(sampler, noise, f, x, svec, done, n)
        done += n
    synchronize(op.device)

    data = np.empty(sp.nsamples)
    t0 = time.perf_counter()
    done = 0
    while done < sp.nsamples:
        n = min(CHUNK, sp.nsamples - done)
        x, z = _run_chain(sampler, noise, f, x, svec, sp.nwarmup + done, n)
        data[done:done + n] = z.double().cpu().numpy()
        done += n
    synchronize(op.device)
    t_elapsed = (time.perf_counter() - t0) * 1e3 / sp.nsamples
    print(f"  {label:>12s} time per sample = {t_elapsed:12.4f} ms")
    np.savetxt(filename, data)

    x_avg = float(np.mean(data))
    variance = float(np.mean(data**2) - x_avg**2)
    x_error = np.sqrt(variance / sp.nsamples)
    mean_exact, variance_exact = exact
    print(f"  {label:>12s} mean     = {x_avg:12.4e} +/- {x_error:12.4e} [ignoring IACT]")
    print(f"  {'exact':>12s} mean     = {mean_exact:12.4e}")
    print(f"  {label:>12s} variance = {variance:12.4e}")
    print(f"  {'exact':>12s} variance = {variance_exact:12.4e}\n")
    sampler.unfix_rhs()
    return t_elapsed


def measure_convergence(label, sampler, op, config, f, sample_vec, exact, filename):
    """Decay of ``|E[z^k] - E[z]|`` and ``|Var[z^k] - Var[z]|`` over the first
    chain steps, batched over independent replica chains on the device, from
    the exact moments ``exact``."""
    sp = config.sampling
    nsteps = sp.nstepsconvergence
    nsamples = sp.nsamplesconvergence
    svec = torch.as_tensor(sample_vec, dtype=op.dtype, device=op.device).reshape(-1)
    noise = GeneratorNoise(2813741, op.device)

    x = torch.zeros((nsamples,) + op.lattice.vshape, dtype=op.dtype, device=op.device)
    zs = []
    for k in range(nsteps):
        x = sampler.apply_indexed(noise, f, x, k)
        zs.append(x.reshape(nsamples, -1) @ svec)
    zs = torch.stack(zs).double().cpu().numpy()  # (nsteps, nsamples)
    zs = np.concatenate([np.zeros((1, nsamples)), zs])  # j=0 row (x=0)
    x_avg = zs.mean(axis=1)
    x2_avg = (zs**2).mean(axis=1)
    x3_avg = (zs**3).mean(axis=1)
    x4_avg = (zs**4).mean(axis=1)

    mean_exact, variance_exact = exact
    diff_mean = np.abs(x_avg - mean_exact)
    diff_variance = np.abs(x2_avg - x_avg**2 - variance_exact)
    sigma_sq = nsamples / (nsamples - 1.0) * (x2_avg - x_avg**2)
    mu4 = x4_avg - 4 * x_avg * x3_avg + 6 * x_avg**2 * x2_avg - 3 * x_avg**4
    error_diff_mean = np.sqrt(sigma_sq / nsamples)
    error_diff_variance = np.sqrt(
        np.maximum(mu4 - (nsamples - 3.0) / (nsamples - 1.0) * sigma_sq**2, 0.0) / nsamples
    )

    with open(filename, "w") as out:
        for q, (label_q, diff, err) in enumerate(
            [
                ("mean", diff_mean, error_diff_mean),
                ("variance", diff_variance, error_diff_variance),
            ]
        ):
            out.write(
                "**** q_k = |E[z^k] - E[z]| **** \n"
                if q == 0
                else "**** q_k = |Var[z^k] - Var[z]| **** \n"
            )
            out.write(f"  {'':12s}   {'k':>3s} : {'q_k':>12s} {'q_k/q_0':>35s} {'q_k/q_{k-1}':>35s}\n")
            diff_0 = diff[0] if diff[0] != 0 else 1.0
            for j in range(nsteps + 1):
                line = (
                    f"  {label_q:>12s}   {j:3d} : {diff[j]:12.8f} +/- {err[j]:12.8f}"
                    f"       {diff[j] / diff_0:12.8f} +/- {err[j] / diff_0:12.8f}      "
                )
                if j > 0 and diff[j - 1] != 0:
                    rel = diff[j] / diff[j - 1] * np.sqrt(
                        (err[j] / max(diff[j], 1e-300)) ** 2
                        + (err[j - 1] / max(diff[j - 1], 1e-300)) ** 2
                    )
                    line += f" {diff[j] / diff[j - 1]:12.8f} +/- {rel:12.8f} \n"
                else:
                    line += f" {'---':>12s}\n"
                out.write(line)
            out.write("\n")


def posterior_statistics(sampler, op, config, f, mean_x_exact, mparams):
    """Mean and variance fields of one chain beside the exact mean, as VTK."""
    sp = config.sampling
    noise = GeneratorNoise(815747, op.device)
    x = torch.zeros(op.lattice.vshape, dtype=op.dtype, device=op.device)
    for k in range(sp.nwarmup):
        x = sampler.apply_indexed(noise, f, x, k)
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    for k in range(sp.nsamples):
        x = sampler.apply_indexed(noise, f, x, k)
        m = m + (x - m) / (k + 1.0)
        v = v + (x * x - v) / (k + 1.0)
    mean = m.double().cpu().numpy()
    variance = v.double().cpu().numpy() - mean * mean

    writer = VTKWriter("posterior.vtk", op.lattice, 1)
    writer.add_state(mean, "mean")
    writer.add_state(variance, "variance")
    writer.add_state(mean_x_exact, "mean_exact")
    writer.write()
    if op.lattice.dim == 2 and mparams.sample_location is not None:
        write_vtk_circle(mparams.sample_location, mparams.radius, "sample_location.vtk")


def run(config, device, dtype):
    """Everything the configuration asks for, on ``device`` in ``dtype``;
    returns ``{label: ms per sample}``."""
    t0 = time.perf_counter()
    prior, op, mparams = build_operators(config, device, dtype)
    samplers = make_samplers(config, op)
    xbar, y, mean_x_exact, f, sample_vec = exact_setup(prior, op, mparams)
    # the exact moments of the observation, once for every series and table:
    # above 4096 unknowns each solve factors the stencil's band or runs CG
    exact = observed_mean_and_variance(op, xbar, y, sample_vec)
    synchronize(op.device)
    print(f"setup time (operators, samplers, exact mean) = {time.perf_counter() - t0:.3f} s")

    # float32 zero-mean protocol: wrap the iterative samplers so that the
    # exactly known (host float64) posterior mean is carried outside the
    # float32 chain; direct Cholesky samplers have no iterative mean solve and
    # keep the reference semantics
    ms = config.general.mean_shift.lower()
    if ms == "on" or (ms == "auto" and op.dtype == torch.float32):
        for label in ("ssor", "multigridmc"):
            if label in samplers:
                samplers[label] = MeanShiftedSampler(samplers[label], mean_x_exact)
        if ms == "auto":
            print("float32 run: zero-mean sampling protocol enabled "
                  "(general.mean_shift = auto)")

    times = {}
    for label, sampler in samplers.items():
        times[label] = measure_sampling_time(
            label, sampler, op, config, f, sample_vec, exact, f"timeseries_{label}.txt"
        )
    if config.general.measure_convergence:
        for label in ("ssor", "multigridmc"):
            if label in samplers:
                measure_convergence(
                    label, samplers[label], op, config, f, sample_vec, exact,
                    f"convergence_{label}.txt",
                )
    if config.general.save_posterior_statistics and "multigridmc" in samplers:
        posterior_statistics(samplers["multigridmc"], op, config, f, mean_x_exact, mparams)
    return times


def main(argv=None):
    configure_runtime()
    argv = argv if argv is not None else sys.argv[1:]
    path, device, dtype = parse_command_line(
        argv, "python -m multigridmc_tpu_torch.drivers.mgmc",
        "Multigrid Monte Carlo sampling of the configured posterior")
    t_start = time.perf_counter()
    print()
    print("+--------------------------------+")
    print("! Multigrid Monte Carlo sampling !")
    print("!        (PyTorch / CUDA)        !")
    print("+--------------------------------+")
    print()
    config = load_config(path)
    echo_config(config)
    print(f"device = {device}, dtype = {dtype}")
    run(config, device, dtype)

    t_elapsed = time.perf_counter() - t_start
    hours, rem = divmod(int(t_elapsed), 3600)
    mins, secs = divmod(rem, 60)
    print(f"total run time: {hours:d}h {mins:02d}m {secs:02d}s")


if __name__ == "__main__":
    main()
