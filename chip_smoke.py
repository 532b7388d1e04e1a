#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

drives the port's main path - batched float32 MGMC chains on the flagship
problem (2d 256x256 lattice, shifted-Laplace prior, 8 near-exact point
measurements, 5-level W-cycle, SOR, dense Cholesky on the coarsest level, 256
chains) - on the card and checks, one phase after the other:

1. ``device``      the card (``nvidia-smi`` name and power limit);
2. ``build``       ``nvcc`` builds the level-visit kernels from ``csrc/``;
3. ``kernels``     each kernel against its plain PyTorch version at the shapes
                   the main path gives it (noise off, then the same noise
                   tensor fed to both; ``rtol = atol = 2e-5``: float32 with
                   another summation order and FMA contraction), the
                   in-kernel Philox normals (known-answer reference, moments,
                   lag correlations, distinct streams), and the kernels'
                   times beside their bounds;
4. ``main_path``   the flagship sampler for a few tens of steps, with level 0
                   fused only and with every non-coarsest level fused: finite
                   samples, launch counters, samples/s and ms/step;
5. ``statistics``  a 64x64 posterior whose exact moments are known: one step
                   under replayed noise agrees between kernels and composed
                   path, and the sample mean and variance of an observable
                   agree with the exact ones within 4 standard errors, through
                   the kernels and through the plain path.

One JSON object per line.  The line ``{"kernels": [...]}`` lists per kernel its
launches on the main path, its error against the plain version, its time, the
plain version's time and its bound.  The last line is
``{"ok": true, "device": {...}}``; any failing phase raises and the exit code
is not 0.  Without a CUDA device the script exits with code 1 and prints no
result.  ``--phases`` runs a subset of the phases (and the block-size table
``threads``) and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

TOL = 2e-5
FLAGSHIP_SEED = 20260816


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ problems
def build_posterior(nx, n_meas, seed, variance, device, dtype=torch.float32, Lambda=0.2):
    """Shifted-Laplace FD prior on an nx x nx lattice plus ``n_meas`` point
    measurements, drawn as the flagship benchmark draws them."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd

    lattice = Lattice((nx, nx))
    prior = shiftedlaplace_fd(lattice, ConstantCorrelationLengthModel(Lambda),
                              device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    locations = rng.uniform(0.1, 0.9, size=(n_meas, 2))
    mean = rng.normal(2.0, 1.0, size=n_meas)
    u = rng.uniform(size=n_meas)
    var = 1e-6 * (1.0 + u) if variance == "near_exact" else 0.5 + u
    params = MeasurementParameters(measurement_locations=locations, mean=mean, variance=var)
    return measured_operator(prior, params), params


def cuda_ms(fn, repeats, inner):
    """Median over ``repeats`` of the CUDA-event time of ``inner`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_ms_per_launch(fn, kernel, launches=20):
    """Device time of one launch of the CUDA kernel whose name contains
    ``kernel``, from ``torch.profiler`` (mean over ``launches`` calls of ``fn``).
    Unlike the event time of back-to-back launches this does not contain the
    host's launch rate.  None when the profiler shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if kernel in e.key and us and e.count:
            return us / 1e3 / e.count
    return None


def device_busy(step, nsteps):
    """Device time of ``nsteps`` calls of ``step`` from ``torch.profiler``: ms of
    kernel time per step and the three kernels that take most of it.  None when
    the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(nsteps):
            step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # an operator's row repeats the time of the kernels it launched
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            rows.append((e.key, us / 1e3 / nsteps, e.count / nsteps))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return {"kernel_ms_per_step": sum(r[1] for r in rows),
            "kernels_per_step": sum(r[2] for r in rows),
            "top": [{"name": r[0][:60], "ms_per_step": r[1], "calls_per_step": r[2]}
                    for r in rows[:4]]}


# --------------------------------------------------------------- phase: device
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "nvidia_smi": smi})
    return smi


# ---------------------------------------------------------------- phase: build
def phase_build():
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit

    t0 = time.perf_counter()
    path = mgmc_visit.build_library()
    mgmc_visit.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": path.name, "source": "multigridmc_tpu_torch/csrc/mgmc_visit.cu"})


# -------------------------------------------------------------- phase: kernels
def visit_bound(level, C, f_batched, kind):
    """Least time of one visit on the card: the bytes the visit must move
    (every input read once, every output written once) over the memory rate,
    against float32 operations over the peak rate.  Counted as inputs are only
    what the kernel is handed by pointer and reads: coefficient planes and the
    noise-scale plane that are not constant (constant ones travel as scalars),
    ``B`` and ``Y = M^-1 B`` inside their bounding boxes, the small matrices."""
    op = level.op
    n = int(np.prod(op.vshape))
    nc = int(np.prod(level.vc))
    K, m = len(op.offsets), op.m_lowrank
    order = level.pre_order if kind == "descend" else level.post_order

    def area(boxes):
        return sum((i1 - i0) * (j1 - j0) for i0, i1, j0, j1 in boxes)

    shared = 0 if f_batched else n
    shared += n * sum(c is None for c in level.const_coeffs)
    shared += n if level.ns_const is None else 0
    shared += area(level.bbox) + area(level._woodbury[order][2]) + m * m  # B, Y, W
    if kind == "descend":
        shared += m + m * m  # Sigma^-1 and the Gram matrix of the residual shortcut
    chain = 2 * n + nc + (n if f_batched else 0) + m  # x in and out, f_c or x_c, f, xi_lr
    words = shared + C * chain
    # per point: noisy rhs (Philox + Box-Muller about 40, 2 + 2m), sweep 2K + 4,
    # Woodbury 4m; descend adds the residual 2K + 1 + 2m and 18 per coarse point,
    # ascend the interpolation (about 8)
    flops = 42 + 2 * m + 2 * K + 4 + 4 * m
    flops_total = C * (n * (flops + (2 * K + 1 + 2 * m if kind == "descend" else 8))
                       + (18 * nc if kind == "descend" else 0))
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = flops_total / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 4 * words


def compare(name, got, want):
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel and plain version disagree, max abs err {err}")
    return err


def check_level(level, li, C, f_batched, gen):
    """Kernel against plain version on one level: noise off, then shared noise."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    dev = level.coeffs.device
    vshape, m = level.op.vshape, level.op.m_lowrank

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.float32, generator=gen)

    f = rand(*((C,) + vshape if f_batched else vshape))
    x = rand(C, *vshape)
    xc = rand(C, *level.vc)
    errs = {"descend_visit": 0.0, "ascend_visit": 0.0}
    for noisy in (False, True):
        xi = rand(C, *vshape) if noisy else None
        xi_lr = rand(C, m) * level.lr_scale if (noisy and m) else None
        tag = f"L{li} {'shared noise' if noisy else 'noise off'}"
        want_x, want_fc = mv.descend_visit_plain(level, f, x, xi, xi_lr)
        got_x, got_fc = mv.descend_visit(level, f, x.clone(), xi=xi, xi_lr=xi_lr)
        errs["descend_visit"] = max(errs["descend_visit"],
                                    compare(f"descend x {tag}", got_x, want_x),
                                    compare(f"descend f_c {tag}", got_fc, want_fc))
        want = mv.ascend_visit_plain(level, f, x, xc, xi, xi_lr)
        got = mv.ascend_visit(level, f, x.clone(), xc, xi=xi, xi_lr=xi_lr)
        errs["ascend_visit"] = max(errs["ascend_visit"], compare(f"ascend x {tag}", got, want))
    torch.cuda.synchronize()  # a fault during a launch surfaces here
    return errs


def time_level(level, C, f_batched, noise, plain=True):
    """ms per launch of both kernels (in-kernel noise on, as the main path runs
    them): CUDA events around back-to-back launches (``*_ms``) and the
    profiler's device time of the kernel alone (``*_device_ms``); and of their
    plain versions (noise tensors drawn inside the timed region), at one
    level's shape."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    dev = level.coeffs.device
    vshape = level.op.vshape
    f = torch.rand((C,) + vshape if f_batched else vshape, device=dev)
    x = torch.zeros((C,) + vshape, device=dev)
    xc = torch.randn((C,) + level.vc, device=dev)

    def plain_noise():
        xi, xi_lr, _ = level._draw(_TensorNoise(noise), x)
        return xi, xi_lr

    out = {}
    out["descend_ms"] = cuda_ms(lambda: level.descend(noise, f, x), 5, 10)
    out["ascend_ms"] = cuda_ms(lambda: level.ascend(noise, f, x, xc), 5, 10)
    if not plain:
        return out
    out["descend_device_ms"] = device_ms_per_launch(
        lambda: level.descend(noise, f, x), "descend_kernel")
    out["ascend_device_ms"] = device_ms_per_launch(
        lambda: level.ascend(noise, f, x, xc), "ascend_kernel")
    x.zero_()
    out["descend_plain_ms"] = cuda_ms(
        lambda: mv.descend_visit_plain(level, f, x, *plain_noise()), 3, 3)
    out["ascend_plain_ms"] = cuda_ms(
        lambda: mv.ascend_visit_plain(level, f, x, xc, *plain_noise()), 3, 3)
    return out


class _TensorNoise:
    """A noise source that only hands out tensors (no Philox stream), so the
    kernels take their field noise from a tensor as the plain path does."""

    def __init__(self, inner, record=None):
        self.inner, self.record = inner, record

    def normal(self, shape, dtype, device):
        t = self.inner.normal(shape, dtype, device)
        if self.record is not None:
            self.record.append(t.detach().cpu().numpy().copy())
        return t

    def philox_stream(self):
        return None


def check_philox(device, nx, C):
    """The in-kernel generator, read out through the descend kernel itself: on
    an identity operator with f = 0, x = 0, omega = 1 the visit returns x = xi."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.ops.coloring import coloring_for
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.stencil import StencilOperator
    from multigridmc_tpu_torch.smoothers import BACKWARD, FORWARD, color_order

    lattice = Lattice((nx, nx))
    offsets = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    coeffs = torch.zeros((5,) + lattice.vshape, device=device)
    coeffs[0] = 1.0
    op = StencilOperator(coeffs=coeffs, offsets=offsets, lattice=lattice)
    coloring = coloring_for(offsets, lattice.vshape)
    level = mv.FusedVisitLevel(op, coloring, 1.0, color_order(coloring.n_colors, FORWARD),
                               color_order(coloring.n_colors, BACKWARD), None, None, 1.0)
    n = lattice.nvertex
    f = torch.zeros(lattice.vshape, device=device)

    def draw(seed, counter):
        x = torch.zeros((C,) + lattice.vshape, device=device)
        x, _ = mv.descend_visit(level, f, x, philox=(seed, counter))
        return x

    seed = 0x1234_5678_9ABC_DEF0
    z0 = draw(seed, 7)
    if not torch.equal(z0, draw(seed, 7)):
        raise AssertionError("philox: two launches with the same seed and counter differ")
    # known answer: the host reference of the same generator, incl. high counter words
    ka_err = 0.0
    for counter in (7, (1 << 32) + 5):
        z = z0 if counter == 7 else draw(seed, counter)
        ref = mv.philox_normals_reference(seed, counter, C, lattice.vshape)
        rows = [0, 1, C - 1]
        ka_err = max(ka_err, float(np.abs(z[rows].cpu().numpy() - ref[rows]).max()))
    if ka_err > 2e-5:
        raise AssertionError(f"philox: kernel normals differ from the reference by {ka_err}")
    # moments and lag correlations over all draws of one launch
    z0 = z0.reshape(C, n)
    z = z0.double()
    N = z.numel()
    mean, var = float(z.mean()), float(z.var())
    m4 = float((z ** 4).mean())
    lags = {}
    for lag in (1, 2, 3, 4, nx - 1, nx):
        lags[f"point+{lag}"] = float((z[:, :-lag] * z[:, lag:]).mean())
    lags["chain+1"] = float((z[:-1] * z[1:]).mean())
    z1 = draw(seed, 8).reshape(C, n).double()
    lags["launch+1"] = float((z * z1).mean())
    lags["seed+1"] = float((z * draw(seed + 1, 7).reshape(C, n).double()).mean())
    lim = 5.0 / np.sqrt(N / 2)
    checks = {"mean": abs(mean) < 5 / np.sqrt(N), "var": abs(var - 1) < 5 * np.sqrt(2 / N),
              "m4": abs(m4 - 3) < 5 * np.sqrt(96 / N),
              "lags": all(abs(v) < lim for v in lags.values())}
    # no two of (launch, chain) share a stream: all pairwise correlations small
    both = torch.cat([z0, z1.float()]).double()
    both = both / both.norm(dim=1, keepdim=True)
    corr = both @ both.T
    corr.fill_diagonal_(0.0)
    max_corr = float(corr.abs().max())
    checks["distinct_streams"] = max_corr < 6.0 / np.sqrt(n)
    if not all(checks.values()):
        raise AssertionError(f"philox statistics failed: {checks} mean={mean} var={var} "
                             f"m4={m4} lags={lags} max_corr={max_corr}")
    return {"draws": N, "mean": mean, "var": var, "m4": m4, "lags": lags,
            "max_stream_corr": max_corr, "known_answer_max_err": ka_err}


def phase_kernels(device, nx, nlevel, C, n_meas):
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    # elementwise checks with O(1) measurement variances: with near-exact ones
    # both sides share a float32 cancellation that such a check cannot separate
    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "order_one", device)
    sampler = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0)
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    errs = {"descend_visit": 0.0, "ascend_visit": 0.0}
    by_level = []
    for li, level in sorted(sampler.fused_levels.items()):
        # the main path gives level 0 a shared f and the coarser levels one per chain
        for f_batched in ((False, True) if li == 0 else (True,)):
            e = check_level(level, li, C, f_batched, gen)
            by_level.append({"level": li, "vshape": list(level.op.vshape),
                             "f_batched": f_batched, **e})
            for k in errs:
                errs[k] = max(errs[k], e[k])
    philox = check_philox(device, nx, C)

    # times at the production operator (near-exact measurements), all fused levels
    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    sampler = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0)
    noise = GeneratorNoise(5, device)
    timings = []
    for li, level in sorted(sampler.fused_levels.items()):
        f_batched = li > 0
        t = time_level(level, C, f_batched, noise)
        for kind in ("descend", "ascend"):
            bound, by, nbytes = visit_bound(level, C, f_batched, kind)
            t[f"{kind}_bound_ms"], t[f"{kind}_bound_by"], t[f"{kind}_bytes"] = bound, by, nbytes
        timings.append({"level": li, "vshape": list(level.op.vshape), "chains": C,
                        "threads": level.threads, **t})
    emit({"phase": "kernels", "tolerance": TOL, "max_abs_err": errs, "checks": by_level,
          "philox": philox, "timings": timings})
    return errs, timings


def phase_threads(device, nx, nlevel, C, n_meas):
    """Not part of the default run: ms per launch of both kernels on every
    fused level of the flagship for several block sizes (the default comes from
    ``mgmc_visit._default_threads``)."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    sampler = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0)
    noise = GeneratorNoise(5, device)
    rows = []
    for li, level in sorted(sampler.fused_levels.items()):
        default = level.threads
        for threads in (64, 128, 256, 512, 1024):
            level.threads = threads
            t = time_level(level, C, li > 0, noise, plain=False)
            rows.append({"level": li, "threads": threads, "default": threads == default,
                         "descend_ms": t["descend_ms"], "ascend_ms": t["ascend_ms"]})
        level.threads = default
    emit({"phase": "threads", "chains": C, "rows": rows})


# ------------------------------------------------------------ phase: main_path
def phase_main_path(device, nx, nlevel, C, n_meas, steps, smi):
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    f = torch.as_tensor(np.random.default_rng(0).uniform(size=op.vshape),
                        dtype=torch.float32, device=device)
    n0 = op.lattice.nvertex
    results = {}
    counts_default = None
    # level 0 fused only / every non-coarsest level fused (None = the default)
    for name, min_vertices, nsteps in (("level0_fused", n0, max(steps // 3, 2)),
                                       ("all_levels_fused", None, steps)):
        sampler = MultigridMCSampler(op, nlevel, smoother="SOR", coarse_solver="Cholesky",
                                     omega=1.0, cycle=2, fused_min_vertices=min_vertices)
        noise = GeneratorNoise(FLAGSHIP_SEED, device)
        x = torch.zeros((C,) + op.vshape, dtype=torch.float32, device=device)
        for _ in range(2):  # warm-up: caches, allocator, lazily built buffers
            x = sampler.apply(noise, f, x)
        torch.cuda.synchronize()
        mv.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(nsteps):
            x = sampler.apply(noise, f, x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(mv.launch_counts)
        if tuple(x.shape) != (C,) + op.vshape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"main path ({name}): samples not finite or of wrong shape")
        fused = sorted(sampler.fused_levels)
        # the W-cycle visits level l 2^l times per step
        expected = nsteps * sum(2 ** li for li in fused)
        if counts["descend_visit"] != expected or counts["ascend_visit"] != expected:
            raise AssertionError(f"main path ({name}): launches {counts}, expected {expected} each")
        busy = device_busy(lambda: sampler.apply(noise, f, x), 3)
        results[name] = {"fused_levels": fused, "device_busy": busy, "steps": nsteps,
                         "ms_per_step": 1e3 * dt / nsteps,
                         "samples_per_s": C * nsteps / dt, "launches": counts,
                         "launches_per_step": expected // nsteps,
                         "sample_std": float(x.std())}
        if min_vertices is None:
            counts_default = counts
    emit({"phase": "main_path", "card": smi, "chains": C, "lattice": [nx, nx], "nlevel": nlevel,
          "cycle": 2, "dtype": "float32", **results})
    return counts_default, results


# ----------------------------------------------------------- phase: statistics
def phase_statistics(device, nx, C, warmup, steps):
    from multigridmc_tpu_torch.models.posterior import (measurement_vector,
                                                        observed_mean_and_variance,
                                                        posterior_mean)
    from multigridmc_tpu_torch.samplers.base import (GeneratorNoise, MeanShiftedSampler,
                                                     ReplayNoise)
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    out = {"phase": "statistics", "lattice": [nx, nx], "chains": C, "steps": steps}

    # (1) one W-cycle step under the same noise: kernels (noise fed as tensors)
    # against the composed plain path; elementwise, so O(1) variances as above
    op, _ = build_posterior(nx, 4, 77, "order_one", device)
    fused = MultigridMCSampler(op, 3, cycle=2, fused=True, fused_min_vertices=0)
    composed = MultigridMCSampler(op, 3, cycle=2, fused=False)
    rng = np.random.default_rng(3)
    f = torch.as_tensor(rng.normal(size=op.vshape), dtype=torch.float32, device=device)
    x0 = torch.as_tensor(rng.normal(size=(8,) + op.vshape), dtype=torch.float32, device=device)
    record = []
    got = fused.apply(_TensorNoise(GeneratorNoise(9, device), record), f, x0.clone())
    replay = ReplayNoise(record)
    want = composed.apply(replay, f, x0.clone())
    err = float((got - want).abs().max())
    if not replay.exhausted or not torch.allclose(got, want, rtol=2e-4, atol=2e-4):
        raise AssertionError(f"statistics: fused and composed step differ by {err}")
    out["replayed_step_max_abs_err"] = err

    # (2) exact moments of z = <w, x> under the near-exact posterior
    op, params = build_posterior(nx, 4, 78, "near_exact", device)
    xbar = np.zeros(op.vshape)
    mean = posterior_mean(op, xbar, params.y())
    w = measurement_vector(op.lattice, np.array([0.45, 0.55]), 0.1)
    z_mean, z_var = observed_mean_and_variance(op, xbar, params.y(), w)
    wt = torch.as_tensor(w, dtype=torch.float32, device=device).reshape(-1)
    out["exact"] = {"mean": z_mean, "variance": z_var}
    for name, use_fused in (("kernels", True), ("plain", False)):
        inner = MultigridMCSampler(op, 3, cycle=2, fused=use_fused, fused_min_vertices=0)
        sampler = MeanShiftedSampler(inner, mean)
        noise = GeneratorNoise(1000 + int(use_fused), device)
        x = sampler.mean.expand((C,) + op.vshape).clone()
        for _ in range(warmup):
            x = sampler.apply(noise, None, x)
        zs = []
        for _ in range(steps):
            x = sampler.apply(noise, None, x)
            zs.append((x.reshape(C, -1) @ wt).double())
        z = torch.stack(zs).cpu().numpy()  # (steps, C)
        # independent chains: the spread of the per-chain time averages carries
        # the autocorrelation of the series
        zbar = z.mean(axis=0)
        vbar = ((z - z_mean) ** 2).mean(axis=0)
        se_mean = zbar.std(ddof=1) / np.sqrt(C)
        se_var = vbar.std(ddof=1) / np.sqrt(C)
        res = {"mean": float(zbar.mean()), "mean_se": float(se_mean),
               "variance": float(vbar.mean()), "variance_se": float(se_var)}
        res["mean_sigmas"] = abs(res["mean"] - z_mean) / se_mean
        res["variance_sigmas"] = abs(res["variance"] - z_var) / se_var
        out[name] = res
        if not np.isfinite(z).all() or res["mean_sigmas"] > 4 or res["variance_sigmas"] > 4:
            raise AssertionError(f"statistics ({name}): moments off: {res}, exact {out['exact']}")
    emit(out)


# ------------------------------------------------------------------------ main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="kernels,main_path,statistics",
                        help="comma-separated subset of kernels,main_path,statistics to run "
                             "(device and build always run; 'threads' adds a block-size "
                             "table); the ok line needs exactly the default three")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = "cuda"
    from multigridmc_tpu_torch.utils import runtime  # noqa: F401  (precision policy)

    nx, nlevel, C, n_meas, steps = 256, 5, 256, 8, 30
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    if "threads" in phases:
        phase_threads(device, nx, nlevel, C, n_meas)
    if "kernels" in phases:
        errs, timings = phase_kernels(device, nx, nlevel, C, n_meas)
    if "main_path" in phases:
        counts, _ = phase_main_path(device, nx, nlevel, C, n_meas, steps, smi)
    if "statistics" in phases:
        phase_statistics(device, 64, C, warmup=50, steps=300)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    if phases != {"kernels", "main_path", "statistics"}:
        print("partial run: no result line")
        return 0

    t0 = timings[0]  # level 0: the shape that dominates the main path
    kernels = []
    for kind, line in (("descend", 700), ("ascend", 847)):
        kernels.append({
            "name": f"{kind}_visit", "route": "cuda",
            "source": "multigridmc_tpu_torch/csrc/mgmc_visit.cu",
            "replaces": f"multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py:{line}",
            "launches": counts[f"{kind}_visit"], "max_abs_err": errs[f"{kind}_visit"],
            "ms": t0[f"{kind}_ms"], "device_ms": t0[f"{kind}_device_ms"],
            "plain_ms": t0[f"{kind}_plain_ms"],
            "bound_ms": t0[f"{kind}_bound_ms"], "bound_by": t0[f"{kind}_bound_by"],
            "bound_bytes": t0[f"{kind}_bytes"],
            "library_ms": None, "shape": {"chains": C, "vshape": t0["vshape"]},
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
