#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

drives the port's main paths on the flagship problem (2d 256x256 lattice,
shifted-Laplace prior, 8 near-exact point measurements, 5-level W-cycle) - the
batched float32 MGMC sampler (SOR, dense Cholesky on the coarsest level, 256
chains) with every level's visit fused, with its coarse subtree distilled,
with the subtree in one kernel launch and on the alternating sweep schedule,
with SSOR levels (two sweeps per visit), the exact band-Cholesky sampler, and
the two config-file drivers - and the same sampler on the squared
shifted-Laplace (biharmonic) and the FEM priors and on a 64^3 posterior, on
the card and checks, one phase after the other:

1. ``device``      the card (``nvidia-smi`` name and power limit);
2. ``build``       ``nvcc`` builds the kernel sources of ``csrc/`` (one process
                   per source, started together);
3. ``kernels``     each kernel against its plain PyTorch version at the shapes
                   the main paths give it (noise off, then the same noise
                   tensor fed to both; ``rtol = atol = 2e-5``: float32 with
                   another summation order and FMA contraction) - the
                   level-visit kernels of the three routes (the phase kernels,
                   the row-wavefront stream kernels and the split kernels, each
                   chain over a thread-block cluster) on every level of the
                   flagship (the split kernels at 1 and 16 chains, and on a
                   24x24 lattice's levels, whose bands begin on odd rows), the
                   stream and the split kernels against the phase kernels under
                   one in-kernel Philox stream, the stream and the split
                   kernels' shared-memory layouts against the host's copies;
                   the phase kernels at 128 chains on the flagship's levels 0
                   and 1, on the 511^2 4-colour level of a 1024x1024 lattice
                   and on a 255^2 level with dense measurement columns (noise
                   off, from a tensor, and in-kernel against the host's
                   reference normals), their registers and spills, and their
                   launch by pass from their stamps build (the barriers each
                   block passed against the count from the source);
                   their times at 1 .. 512 chains on the 255^2 and 127^2 levels
                   (the split kernels up to 132 chains at every cluster size
                   that fits) and at 132 .. 512 on the 511^2 and 255^2 levels
                   of a 512x512 lattice (the ``visit_routes`` line, which must
                   support the chain count up to which the split kernels run
                   and, level by level, the one from which the stream kernels
                   run), the
                   two sweep kernels of both routes (one block per chain, and
                   each chain split over a thread-block cluster) in both
                   directions on 2d 5- and 9-point, 3d 7- and 27-point,
                   space-varying and reach-2 operators (the one-block route's
                   passes body - its reach-1, reach-2 and 3d builds - and its
                   shared-memory body also with in-kernel noise against the
                   host's reference normals, and against its generic body,
                   ``1e-6``),
                   the split route at one
                   chain and at a few and against the one-block route under one
                   Philox stream (``1e-6``), the one-block kernels' launch by
                   pass from their stamps builds before (generic body) and
                   after (passes body) on the 256-chain cases and the
                   distillation set-up's shapes, the passes body's registers
                   and its block-size table (which must support the rule) -
                   the in-kernel Philox normals
                   (known-answer reference through every route, moments, lag
                   correlations, distinct streams, and whether they are torch's
                   own normals of the same seed), the split layout's host mirror,
                   the kernels' times beside their bounds, and the
                   ``sweep_routes`` table (both routes at 1 .. 256 chains, which
                   must support the split route's constants); then the third slice's
                   kernels: the subtree kernel on the flagship's levels 1..4,
                   on a 3-level 64x64 case and on a 4-level 64x64 case whose
                   levels are 5-point stencils (noise off, all normals from a
                   tensor, the in-kernel generator with its normals recorded;
                   ``1e-4``: one launch chains 28 sweeps and 8 coarse samples),
                   its time broken down by operation of the schedule from the
                   kernel's timer stamps (their sum 0.8 - 1.05 of the profiler's
                   time, their span within 10%), the barriers each block passed
                   against the count from the source and the blocks one SM ran
                   at once, the shared-memory probe, and the four raw-array sweep entry
                   points with the short path that drives them;
4. ``main_path``   the flagship sampler for a few tens of steps in five
                   variants - every non-coarsest level's visit fused, the
                   subtree from level 2 distilled (and once more with TF32
                   allowed in its two products, once at 128 chains, whose
                   visits take the phase kernels, and once on the alternating
                   sweep schedule, with each parity's routes and distilled
                   map), the subtree below level 0 in one kernel launch, and
                   level 0 fused only: finite samples, launch counters, the
                   visit route each level took, samples/s, ms/step, set-up
                   seconds;
5. ``band``        the exact band (``"sparse"``) Cholesky sampler on the
                   flagship posterior at 255^2: host set-up seconds, the bytes
                   of the doubling's level tensors, ms per sample at 1 and 256
                   chains by recursive doubling and by the block scan (slope of
                   two run lengths), their float32 residuals against the
                   float64 band operator (``BAND_RESIDUAL_LIMIT``; the doubling
                   within ``BAND_DOUBLING_FACTOR`` of the scan) and a 64x64
                   posterior's mean and variance at 256 chains within 4
                   standard errors of dense ``Q^-1``;
6. ``alternating`` the alternating sweep schedule: parity 1's swapped-order
                   visits against their plain versions on the three routes
                   (phase 1, 16, 128 and 256 chains, split 1, 16 and 128,
                   stream 256),
                   stream and split against phase under one Philox stream,
                   both parities' 255^2 visits at 256 chains on the stream and
                   the phase kernels (the route must take the faster by device
                   or by event ms), and the
                   default (distilled) sampler at 256 chains: ms per step and
                   kernel ms of parity 0, parity 1 and ``apply_pair``, each
                   parity's routes, both distilled maps' set-up and bytes;
7. ``drivers``     the port's other entry points: ``drivers.spectrum`` on the
                   flagship's 32^2 config (eigenvalues against the float64
                   host inverse), ``drivers.generate_measurements``, a
                   checkpoint of the default flagship sampler at 256 chains
                   resumed (5 steps, save, load, 5 steps: bitwise the 10
                   uninterrupted steps), ``lowrank_approx.pivoted_cholesky``
                   of the 64x64 posterior covariance (the trace error it
                   reports against the one it reaches); then
                   ``drivers.mgmc`` (SSOR and MGMC time series, convergence
                   tables over 256 replica chains, posterior statistics), the
                   same with the band sampler (the factorisation unset) and
                   MGMC on the alternating schedule, and ``drivers.mg``
                   (SSOR-smoothed multigrid Richardson, its levels on the
                   two-sweep split visit kernels) from config files written
                   to a temporary directory, at the flagship's size: output
                   files, launch counters, the distill level ``"auto"``
                   chose, the Richardson contraction rate and the time
                   series' means against the exact one; the same solve with
                   its levels composed (the split sweep kernel); one step of
                   the one-chain SSOR and MGMC samplers, host ms against
                   kernel ms and launches;
8. ``statistics``  a 64x64 posterior whose exact moments are known: one step
                   under replayed noise agrees between kernels and composed
                   path; the sample mean and variance of an observable, and of
                   the first measurement's functional ``B_0^T x`` (variance
                   about 1e-6), agree with the exact ones within 4 standard
                   errors, through the visit kernels (1 and 8 chains: the
                   split route; 128 and 256 chains: the phase route; the
                   alternating schedule at omega = 1.4 on the phase route at
                   256 chains and the split route at one chain; SSOR levels on
                   the two-sweep visits at 256 chains and at one chain), the
                   plain path, the distilled subtree, the subtree kernel with
                   its in-kernel noise and the SSOR sampler on the Gibbs sweep
                   kernel (256 chains on the one-block route, 32 on the split
                   route); and a batched deterministic solve, its levels
                   composed and fused, agrees with the float64 dense solve;
9. ``biharmonic``  the squared shifted-Laplace prior of
                   ``native/bench_biharmonic_tpu.py`` (255^2, 8 near-exact
                   measurements, 5 levels, 256 chains): the phase kernels'
                   reach-2 build on its levels 0 (13-point, 5 colours) and 1
                   (25-point Galerkin, 9 colours) against their plain versions
                   (noise off, from a tensor, in-kernel against the host's
                   reference normals; ``x`` within TOL, ``f_c`` within TOL of
                   ``max(|f_c|, 1)``), their routes (the phase kernels at 1, 16
                   and 256 chains; split and stream refuse), times, registers
                   and spills; both sweep kernels on its 9-colour 63^2 level
                   (one block at 256 chains, split at 1 and 4 chains); the
                   sampler through ``MultigridMCSampler.apply`` (30 steps, the
                   default distillation at 63^2, levels 0 and 1 on the reach-2
                   kernels); the FEM prior under the flagship's measurements
                   (10 steps); the subtree kernel's reach-2 build (its
                   sub-levels 127^2, 63^2 and 31^2 25-point, 9 colours; coarse
                   15^2): the sampler with ``subtree=True`` (30 steps, level 0
                   on the reach-2 phase kernels, one subtree launch a step),
                   the kernel against its plain version on the same hierarchy
                   as the flagship's subtree cases (``1e-4``), the barriers
                   each block passed against the source's count, its time by
                   operation from the stamps and at 256, 512 and 1024 threads
                   and four placements; the 64x64 statistical gate of
                   ``native/validate_biharmonic_tpu.py`` (zero-mean protocol,
                   4 standard errors against the dense float64 inverse, a
                   point observation and ``B_0^T x``), once on the reach-2
                   phase kernels and once with the subtree kernel; and
                   ``drivers.mgmc`` on a biharmonic and a FEM configuration at
                   256^2 (the biharmonic one's exact moments by the band
                   Cholesky, its residual held to ``BAND_SOLVE_RESIDUAL``),
                   ``drivers.mg`` on the FEM one;
10. ``volume``     the 3d posterior of ``native/bench_mgmc3d_tpu.py`` (64^3
                   lattice, 63^3 unknowns, 8 near-exact measurements, 4
                   levels, W-cycle, SOR): the sampler at 32 chains and one
                   chain, distilled (the default) and with every level fused,
                   levels 0 (7-point) and 1 (27-point Galerkin) on the route
                   ``mgmc_visit_smem3d.SMEM3D_ROUTES`` gives them (the smem
                   kernels of ``csrc/mgmc_visit_smem3d.cu``: each chain's
                   field in shared memory, slabs of planes over a cluster),
                   and composed (``fused=False``, the visits on the sweep
                   kernels) as the "before"; both 3d routes (the smem kernels
                   and the phase kernels' 3d build) on both levels against
                   their plain versions (noise off, a tensor, in-kernel
                   against the host's reference normals), against each other
                   under one Philox stream and against the composed visit
                   under one Philox stream, their device times (the route
                   taken within ``SMEM_ROUTE_SLACK`` of the other), registers
                   and spills, both by pass (stamps builds); the
                   statistical gate of ``native/validate_mgmc3d_tpu.py`` (32
                   chains, zero-mean protocol, 30 + 300 steps, 4 standard
                   errors against the exact variance by converged float64 CG)
                   at the centre and on ``B_0^T x``; the descend's ``f_c`` on
                   every fused level against a float64 visit (1e-4 of its
                   scale); the 3d 7-point sweeps of the smem3d body
                   (``csrc/sor_sweep_smem3d.cu``: each chain's 63^3 field in
                   slabs of planes over a cluster) at 32 and 128 chains
                   against their plain versions (noise off, a tensor, in-kernel
                   against the host's reference normals) and the generic body
                   (``1e-6``, one Philox stream), their device ms beside the
                   generic body's, by pass (stamps build), and the paths at
                   full width: the 64^3 SSOR Gibbs sampler at 128 chains (ms
                   per step, device ms per sweep, and the same steps on the
                   generic body) and the multigrid solve of 128 right-hand
                   sides (the deterministic kernel); ``drivers.mgmc`` and
                   ``drivers.mg`` on a 32^3 config;
11. ``ssor``       two sweeps per visit (SSOR): the flagship posterior with
                   SSOR levels through ``MultigridMCSampler.apply`` at 256
                   chains (levels 0 and 1 on the smem kernels of
                   ``csrc/mgmc_visit_smem.cu``, each chain's field in shared
                   memory through both sweeps) and at one chain (the route the
                   rule takes), the biharmonic (256 chains) and 64^3 (32
                   chains) posteriors with SSOR levels, a few steps each; the
                   two-sweep visits against their plain versions (noise off,
                   tensors, in-kernel against the host's reference normals):
                   the smem kernels on the flagship's levels 0 and 1 at 256
                   chains and one chain, the phase kernels at 256 chains, the
                   split kernels at one chain (clusters of 16), each other
                   one's level 0; smem and split against the phase kernels
                   under one Philox stream; their device ms, plain ms and
                   bounds (smem and phase side by side on both levels), the
                   launches by pass from the stamps builds (barriers against
                   the source's count); the descend's ``f_c`` on every fused
                   level of the flagship, SOR and SSOR, against a float64
                   visit.
12. ``lowrank``    levels of more than 32 measurements (the low-rank scratch
                   in dynamic shared memory sized by m): every visit kernel
                   (phase 2d / reach-2 / 3d, split, smem 5-, 9-, 13-,
                   25-point, smem3d) against its plain version at 33, 64 and
                   256 measurements (3d: 33, 64; 2e-5, f_c by its scale), the
                   split and smem kernels against the phase kernels under one
                   Philox stream, the stream kernels refusing such a level,
                   the subtree kernel (reach 1 and 2; 1e-4, the low-rank
                   draws' known answers past 32 normals); the flagship with
                   the 64 measurements of ``generate_measurements --nmeas 64
                   --dmin 0.05``: distilled at 256, 128 and one chain, SSOR at
                   256 and one chain, ``subtree=True`` at 256, the 64^3
                   posterior (64 measurements) at 32 chains - routes by level,
                   ms and kernel ms per step, the 4-standard-error gates on
                   the centre point and B_0^T x -; ``drivers.mgmc`` on a
                   64-measurement config; the new forms' times at 64 and 256
                   measurements;
13. ``parallel``   the multi-device paths (``multigridmc_tpu_torch/parallel``)
                   on this card, a world of one over NCCL: the chains path
                   (``DataParallelMGMCSampler``) at the flagship's width (256
                   chains, distilled) - one step bitwise the single-device
                   sampler's under rank 0's noise (``fold_seed(seed, 0)``),
                   the routes of ``main_path``'s distilled variant, the visit
                   launches of 30 steps (the counts set to 0 just before),
                   ms per step and samples/s beside ``main_path``'s - and the
                   lattice-decomposed cycle (``ShardedMGMCSampler``) on a 1x1
                   mesh at 255^2 (padded 256^2), W-cycle, 4 chains: noise off
                   against ``MultigridPreconditioner`` (float32,
                   ``PARALLEL_SOLVER_TOL`` of its scale), ``"sharded"`` noise
                   finite with the padding exactly zero, ms per step.

``--phases multichip`` (not in the default run; four cards) starts four ranks
over NCCL, one card each, through ``multigridmc_tpu_torch.parallel.dryrun``:
the chains path at 4 x 256 chains of the flagship (each rank's step bitwise
the single-device sampler's under its own noise, the ranks' chains pairwise
different, samples/s summed over the world) and the lattice cycle on a 2x2
mesh at 255^2 (``"global"`` noise against the world of one on rank 0 within
``FLOAT32_MESH_TOL`` of the output's scale; ``"sharded"`` noise: ms per step,
the NCCL kernels' device ms, the replicated levels bitwise equal across the
lattice shards).  It raises with fewer than four cards.

Device times come from ``torch.profiler``: the kernel matched by its full name
(:func:`names_kernel`), the median of three windows, each of which must have
recorded at least half of the launches made in it; a launch that is bound by
the device (above ``DEVICE_BOUND_MS`` by its CUDA events, enqueued by the host
in less than ``HOST_SHARE`` of that) must agree with its device time within
``EVENTS_FACTOR``, or the run fails.

One JSON object per line.  The line ``{"kernels": [...]}`` lists per kernel its
launches on its path, its error against the plain version, its time, the
plain version's time and its bound.  The last line is
``{"ok": true, "device": {...}}``; any failing phase raises and the exit code
is not 0.  Without a CUDA device the script exits with code 1 and prints no
result.  ``--phases`` runs a subset of the phases (``threads``: the visit
kernels' block-size table; ``passes``: the phase kernels' checks and their
breakdown by pass alone; ``compare``: the phase kernels' and the one-block
sweeps' times and the main path, which a parent tree runs too; ``new``: the
third slice's kernels alone; ``visits``: the visit kernels of the three routes
alone; ``sweeps``: the sweep kernels of both routes alone; ``sweep_check``:
the one-block sweeps against their plain versions alone; ``sweep_stamps``: the
generic one-block sweeps by pass, with ``sweep_passes`` the passes body too;
``sweep_threads``: the passes body's block-size table; ``volume``: the 3d
posterior alone; ``volume_check``: the 3d visits' checks and stamps alone,
``volume_table`` with the 3d smem kernels' route and placement table;
``ssor``: the two-sweep visits alone; ``ssor_check``: the 2d two-sweep smem
visits' checks and stamps alone, ``ssor_table`` with the route table of every
route on the flagship's levels 0 and 1 at 1-256 chains, two sweeps and one,
and the smem kernels' placement table; ``sweep3d_check``: the smem3d sweeps'
checks, times and paths alone, ``sweep3d_table`` with their configuration and
route table - the smem3d body at every cluster size, ``c`` placement and block
size, the generic body, the passes' 3d build and the split route at 1-256
chains on 63^3 and 31^3 7-point fields, which must support
``SMEM3D_SWEEPS``, ``SPLIT_MAX_CHAINS``'s 3d class and
``PASSES_DIM3_MIN_OFFSETS``; ``parallel``: the multi-device paths on one card
alone; ``lowrank``: the many-measurement levels alone; ``lowrank_check``:
their kernels' checks alone; ``lowrank_table``: device ms of a descend plus an
ascend of each route on the flagship's 255^2 and 127^2 levels at 8, 32, 64, 128
and 256 measurements and 1, 32 and 256 chains; ``multichip``: the four-card
check above) and prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

TOL = 2e-5
FLAGSHIP_SEED = 20260816
ALL_PHASES = {"kernels", "main_path", "band", "alternating", "drivers", "statistics",
              "biharmonic", "volume", "ssor", "lowrank", "parallel"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ problems
def build_posterior(nx, n_meas, seed, variance, device, dtype=torch.float32, Lambda=0.2,
                    pdemodel="shiftedlaplace_fd", mean=2.0):
    """Shifted-Laplace FD prior (or the prior ``pdemodel`` names) on an nx x nx
    lattice plus ``n_meas`` point measurements, drawn as the flagship benchmark
    draws them: locations uniform in [0.1, 0.9]^2, means normal(``mean``, 1),
    variances ``0.5 + u`` (``"order_one"``), ``1e-6 (1 + u)`` (``"near_exact"``)
    or ``variance (1 + u)`` for a number (the biharmonic gate's 1e-2)."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
    from multigridmc_tpu_torch.models.prior import prior_operator

    lattice = Lattice((nx, nx))
    prior = prior_operator(pdemodel, lattice, ConstantCorrelationLengthModel(Lambda),
                           device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    locations = rng.uniform(0.1, 0.9, size=(n_meas, 2))
    means = rng.normal(mean, 1.0, size=n_meas)
    u = rng.uniform(size=n_meas)
    if variance == "order_one":
        var = 0.5 + u
    else:
        var = (1e-6 if variance == "near_exact" else float(variance)) * (1.0 + u)
    params = MeasurementParameters(measurement_locations=locations, mean=means, variance=var)
    return measured_operator(prior, params), params


def cuda_ms(fn, repeats, inner, host=None):
    """Median over ``repeats`` of the CUDA-event time of ``inner`` calls, per call.
    ``host``, a dict, receives ``"ms"``: the median host time per call of
    enqueuing them (the host clock before the synchronize)."""
    fn()
    torch.cuda.synchronize()
    times, host_times = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        host_times.append((time.perf_counter() - t0) * 1e3 / inner)
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    if host is not None:
        host["ms"] = float(np.median(host_times))
    return float(np.median(times))


def profiler_kernel_name(key):
    """``(function name, template arguments)`` of a profiler key, a demangled
    signature such as ``void descend_kernel<0, false>(VisitParams, ...)``: the
    return type and the parameter list cut off, the template arguments split
    at the top level (``Memcpy DtoD (Device -> Device)`` gives ``Memcpy DtoD``)."""
    name = key.strip()
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    name = name.strip()
    if "<" not in name:
        return name, ()
    base, args = name[: name.index("<")], name[name.index("<") + 1: name.rindex(">")]
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(args):
        depth += (ch == "<") - (ch == ">")
        if ch == "," and depth == 0:
            parts.append(args[start:i].strip())
            start = i + 1
    parts.append(args[start:].strip())
    return base.strip(), tuple(parts)


def names_kernel(key, kernel):
    """Whether the profiler key ``key`` is the kernel ``kernel`` in full: the
    same function name, and where ``kernel`` gives template arguments
    (``"stream_visit_kernel<true"``: the first of them) the same ones.  A key
    that merely contains the name (``passes_gibbs_kernel`` for ``gibbs_kernel``)
    is another kernel."""
    base, args = profiler_kernel_name(key)
    want = kernel.split("<", 1)
    if base != want[0].strip():
        return False
    if len(want) == 1:
        return True
    given = tuple(a.strip() for a in want[1].rstrip(">").split(",") if a.strip())
    return args[: len(given)] == given


#: spin kernels launched at the start of every profiler window, before what it
#: measures, and left out of its rows: late in a long run torch.profiler drops
#: the first few kernel records of each window (the default run's last phase
#: lost 3-4 of them a window), and these take that loss
PROFILER_PRELUDE = 32


def profiler_prelude():
    """Launch the :data:`PROFILER_PRELUDE` spin kernels and wait for them."""
    for _ in range(PROFILER_PRELUDE):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def prelude_record(key):
    """Whether a profiler key is one of :func:`profiler_prelude`'s kernels."""
    return "spin_kernel" in key


def device_window(fn, kernel, launches=20):
    """One torch.profiler window of ``launches`` calls of ``fn``: the device
    ms per launch of the kernel that :func:`names_kernel` matches, its launches
    in the window, the device ms per call of every other kernel in it and their
    names.  Fails where two distinct kernels match; ``ms`` is None where none
    does."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_prelude()
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and e.count and not prelude_record(e.key):
            rows.append((e.key, us / 1e3, e.count))
    hits = [r for r in rows if names_kernel(r[0], kernel)]
    if len({r[0] for r in hits}) > 1:
        raise AssertionError(f"the profiler name {kernel!r} matches {len(hits)} kernels: "
                             f"{[r[0][:80] for r in hits]}")
    others = [r for r in rows if r not in hits]
    return {"ms": hits[0][1] / hits[0][2] if hits else None, "key": hits[0][0] if hits else None,
            "count": hits[0][2] if hits else 0,
            "other_ms_per_call": sum(r[1] for r in others) / launches,
            "other_kernels": sorted(r[0][:60] for r in others)}


def device_busy(step, nsteps, pattern=r"trsm|triang"):
    """Device time of ``nsteps`` calls of ``step`` from ``torch.profiler``: ms of
    kernel time per step, the kernels that take most of it, and the kernels
    whose name matches ``pattern`` (the triangular solves of the coarse
    sampler).  None when the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_prelude()
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
        if us and not prelude_record(e.key):
            rows.append((e.key, us / 1e3 / nsteps, e.count / nsteps))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return {"kernel_ms_per_step": sum(r[1] for r in rows),
            "kernels_per_step": sum(r[2] for r in rows),
            "top": [{"name": r[0][:60], "ms_per_step": r[1], "calls_per_step": r[2]}
                    for r in rows[:4]],
            "matching": [{"name": r[0][:60], "ms_per_step": r[1], "calls_per_step": r[2]}
                         for r in rows if re.search(pattern, r[0])]}


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
    from multigridmc_tpu_torch.ops.kernels import common, mgmc_subtree, mgmc_visit, sor_sweep

    t0 = time.perf_counter()
    paths = common.build_libraries(common.BUILDS)
    mgmc_visit.load_library()
    mgmc_visit.load_library(stamps=True)
    if hasattr(mgmc_visit, "WideVisitParams"):  # (a parent tree of --phases compare lacks it)
        mgmc_visit.load_library(reach=2)
    if hasattr(mgmc_visit, "VolumeVisitParams"):  # (nor this)
        mgmc_visit.load_library(dim=3)
    if hasattr(mgmc_visit, "SMEM_ROUTE"):  # (nor these)
        from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem

        mgmc_visit.load_library(stamps=True, reach=2)
        mgmc_visit_smem.load_library()
        mgmc_visit_smem.load_library(stamps=True)
    if hasattr(mgmc_visit, "smem_module"):  # (nor these)
        from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d

        mgmc_visit.load_library(stamps=True, dim=3)
        mgmc_visit_smem3d.load_library()
        mgmc_visit_smem3d.load_library(stamps=True)
    mgmc_visit.load_stream_library()
    mgmc_visit.load_split_library()
    sor_sweep.load_library()
    sor_sweep.load_split_library()
    if hasattr(sor_sweep, "load_passes_library"):  # (a parent tree of --phases compare lacks it)
        sor_sweep.load_library(stamps=True)
        sor_sweep.load_passes_library()
        sor_sweep.load_passes_library(stamps=True)
    if hasattr(sor_sweep, "load_smem_library"):  # (nor these)
        sor_sweep.load_smem_library()
        sor_sweep.load_smem_library(stamps=True)
        sor_sweep.load_passes_library(reach=2)
        sor_sweep.load_passes_library(dim=3)
    if hasattr(sor_sweep, "load_smem3d_library"):  # (nor these)
        sor_sweep.load_smem3d_library()
        sor_sweep.load_smem3d_library(stamps=True)
    mgmc_subtree.load_library()
    if hasattr(mgmc_subtree, "REACH_BUILDS"):  # (a parent tree of --phases compare lacks it)
        for part in mgmc_subtree.REACH_BUILDS[2][1]:
            mgmc_subtree.load_library(2, part)
    common.load_probe_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {(f"multigridmc_tpu_torch/csrc/{item}.cu" if isinstance(item, str) else
                         f"multigridmc_tpu_torch/csrc/{item[0]}.cu {' '.join(item[1])}"): path.name
                        for item, path in paths.items()}})


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
    orders = level.orders(kind)
    nd = len(orders)

    def area(boxes):
        return sum(int(np.prod([b[a + 1] - b[a] for a in range(0, len(b), 2)])) for b in boxes)

    shared = 0 if f_batched else n
    shared += n * sum(c is None for c in level.const_coeffs)
    shared += n if level.ns_const is None else 0
    shared += area(level.bbox) + m  # B, Sigma^1/2
    shared += sum(area(level._woodbury[order][2]) + m * m for order in orders)  # Y, W
    # x in and out, f_c or x_c, f, the low-rank normals of each sweep
    chain = 2 * n + nc + (n if f_batched else 0) + nd * m
    words = shared + C * chain
    # per point and sweep: noisy rhs (Philox + Box-Muller about 40, 2), sweep
    # 2K + 4, Woodbury 4m; descend adds the residual 2K + 1 + 2m and 2 3^d per
    # coarse point, ascend the interpolation (about 4 d)
    dim = len(op.vshape)
    flops = nd * (42 + 2 * K + 4 + 4 * m)
    flops_total = C * (n * (flops + (2 * K + 1 + 2 * m if kind == "descend" else 4 * dim))
                       + (2 * 3 ** dim * nc if kind == "descend" else 0))
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = flops_total / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 4 * words


def compare(name, got, want, tol=TOL):
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel and plain version disagree, max abs err {err} "
                             f"(values up to {float(want.abs().max())})")
    return err


#: the kernel names of the three visit routes (``mgmc_visit.ROUTES``)
VISIT_KERNELS = {"phase": ("descend_visit", "ascend_visit"),
                 "stream": ("descend_visit_stream", "ascend_visit_stream"),
                 "split": ("descend_visit_split", "ascend_visit_split")}
#: the kernels as torch.profiler names them
PROFILER_NAMES = {"descend_visit": "descend_kernel", "ascend_visit": "ascend_kernel",
                  "descend_visit_stream": "stream_visit_kernel<true",
                  "ascend_visit_stream": "stream_visit_kernel<false",
                  "descend_visit_split": "split_visit_kernel<true",
                  "ascend_visit_split": "split_visit_kernel<false"}


def check_level(level, li, C, f_batched, gen, routes=("phase", "stream"), cluster=None):
    """The visit kernels of ``routes`` against the plain version on one level:
    noise off, then the same noise tensors; with the phase kernels and another
    route, then every other route against the phase kernels under one
    in-kernel Philox stream, and against itself (bitwise).  ``cluster`` sets
    the split route's cluster size (default: the level's rule).  Returns the
    errors against the plain versions and, per other route, against the phase
    kernels."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    dev = level.coeffs.device
    vshape, m = level.op.vshape, level.op.m_lowrank

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.float32, generator=gen)

    f = rand(*((C,) + vshape if f_batched else vshape))
    x = rand(C, *vshape)
    xc = rand(C, *level.vc)
    errs = {name: 0.0 for route in routes for name in VISIT_KERNELS[route]}
    for noisy in (False, True):
        xi = rand(C, *vshape) if noisy else None
        xi_lr = rand(C, m) if (noisy and m) else None
        tag = f"L{li} C={C} {'shared noise' if noisy else 'noise off'}"
        want_x, want_fc = mv.descend_visit_plain(level, f, x, xi, xi_lr)
        want = mv.ascend_visit_plain(level, f, x, xc, xi, xi_lr)
        for route in routes:
            dname, aname = VISIT_KERNELS[route]
            got_x, got_fc = mv.launch_descend(level, route, f, x.clone(), xi=xi, xi_lr=xi_lr,
                                              cluster=cluster)
            errs[dname] = max(errs[dname], compare(f"{dname} x {tag}", got_x, want_x),
                              compare(f"{dname} f_c {tag}", got_fc, want_fc))
            got = mv.launch_ascend(level, route, f, x.clone(), xc, xi=xi, xi_lr=xi_lr,
                                   cluster=cluster)
            errs[aname] = max(errs[aname], compare(f"{aname} x {tag}", got, want))
    others = [route for route in routes if route != "phase"]
    if "phase" not in routes or not others:
        torch.cuda.synchronize()
        return errs, {}
    # one Philox stream through every route's kernels
    xi_lr = rand(C, m) if m else None
    stream = (0x5EED_0000 + li, 7)
    out = {}
    for route in routes:
        kw = dict(xi_lr=xi_lr, philox=stream, cluster=cluster)
        out[route] = (*mv.launch_descend(level, route, f, x.clone(), **kw),
                      mv.launch_ascend(level, route, f, x.clone(), xc, **kw))
    route_errs = {}
    for route in others:
        again = mv.launch_descend(level, route, f, x.clone(), xi_lr=xi_lr, philox=stream,
                                  cluster=cluster)
        if not (torch.equal(again[0], out[route][0]) and torch.equal(again[1], out[route][1])):
            raise AssertionError(f"L{li}: two {route} launches with one seed and counter differ")
        tag = f"L{li} C={C} one Philox stream, {route} against phase kernel"
        route_errs[route] = {
            "descend_x": compare(f"descend x {tag}", out[route][0], out["phase"][0]),
            "descend_fc": compare(f"descend f_c {tag}", out[route][1], out["phase"][1]),
            "ascend_x": compare(f"ascend x {tag}", out[route][2], out["phase"][2])}
    torch.cuda.synchronize()  # a fault during a launch surfaces here
    return errs, route_errs


def visit_fns(level, route, noise, f, x, xc, cluster=None, threads=None):
    """One descend and one ascend launch through ``route`` (the split route
    with clusters of ``cluster`` blocks, by default the level's rule; the
    phase route with ``threads`` per block, by default its rule), each drawing
    its noise as the main path does (a fresh Philox counter per launch)."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    kw = {"threads": threads} if threads is not None else {}

    def descend():
        xi, xi_lr, philox = level._draw(noise, x)
        return mv.launch_descend(level, route, f, x, xi, xi_lr, philox, cluster, **kw)

    def ascend():
        xi, xi_lr, philox = level._draw(noise, x, "ascend")
        return mv.launch_ascend(level, route, f, x, xc, xi, xi_lr, philox, cluster, **kw)

    return descend, ascend


def device_ms_retried(fn, kernel, launches=10):
    """Device time of one launch of the CUDA kernel ``kernel`` (by its full
    name, :func:`names_kernel`) over one :func:`device_window` of ``launches``
    calls of ``fn``, each of which launches it once.  Unlike the event time of
    back-to-back launches this does not contain the host's launch rate.  The
    mean is over the launches the window recorded: a window of 20 often
    records 19 (in a whole run, after some hundred windows, nearly always), now
    and then 13.  A window that shows no such kernel, fewer than half of the
    launches or more than were made is asked again, up to four times; None
    after that, with a line that shows what each window recorded."""
    seen = []
    for _ in range(4):
        w = device_window(fn, kernel, launches)
        if launches // 2 <= w["count"] <= launches:
            return w["ms"]
        seen.append({k: w[k] for k in ("count", "ms", "key", "other_kernels")})
        time.sleep(0.2)
    emit({"profiler_miss": kernel, "launches": launches, "windows": seen})
    return None


def device_ms_median(fn, kernel, launches=10, windows=3):
    """The median over ``windows`` profiler windows of
    :func:`device_ms_retried`: every device time that a table or the
    ``kernels`` line reports takes it, so that no single window (one the card
    ran slower in, a clock change, one that recorded a part of its launches)
    decides; None where a window showed no such kernel."""
    return device_ms_medians({0: (fn, kernel)}, launches, windows)[0]


def device_ms_medians(candidates, launches=10, windows=3):
    """:func:`device_ms_median` of each ``{key: (fn, kernel)}`` of
    ``candidates``, their windows interleaved (window 1 of every candidate,
    then window 2, ...): where a table compares candidates with each other, a
    spell in which the card runs faster or slower (a clock change lasting a
    few windows) then falls on all of them alike instead of on the one that
    happened to be timed in it."""
    times = {key: [] for key in candidates}
    for _ in range(windows):
        for key, (fn, kernel) in candidates.items():
            times[key].append(device_ms_retried(fn, kernel, launches))
    return {key: None if None in t else float(np.median(t)) for key, t in times.items()}


#: a launch is bound by the device where its event time is above this many ms
#: and the host enqueues it in less than :data:`HOST_SHARE` of that time; its
#: device ms must then agree with its event ms within :data:`EVENTS_FACTOR`
DEVICE_BOUND_MS = 0.1
#: a launch whose host enqueue takes this share of its event time or more is
#: bound by the host (a one-chain split visit of 127^2: 0.034 device ms, 0.107
#: by events, the Python launch path some 0.1 ms), and its events time the host
HOST_SHARE = 0.5
#: the largest ratio, either way, of a device-bound launch's event ms (back-to-
#: back launches, CUDA events) to its device ms (profiler, median of three
#: windows).  The events add the gap between two launches (some 2-10 us) and
#: the profiler's windows read 5-15% off now and then, so single launches of
#: the card's runs lie at 1.00-1.14 (PERF.md section 6); 1.25 leaves room for
#: that and still catches a window that matched the wrong kernel or lost half
#: the time (the 63^3 Gibbs row's old 0.414 against 0.877: 2.1).
EVENTS_FACTOR = 1.25


def check_events_against_device(name, ms, device_ms, host_ms):
    """Fail where a device-bound launch's device ms and event ms disagree by
    more than :data:`EVENTS_FACTOR`; returns their ratio."""
    if device_ms is None:
        raise AssertionError(f"{name}: the profiler shows no device time")
    ratio = ms / device_ms
    bound = ms > DEVICE_BOUND_MS and host_ms < HOST_SHARE * ms
    if bound and not 1.0 / EVENTS_FACTOR <= ratio <= EVENTS_FACTOR:
        raise AssertionError(f"{name}: event ms {ms} and device ms {device_ms} of a "
                             f"device-bound launch (host {host_ms} ms) differ by {ratio} "
                             f"(more than {EVENTS_FACTOR})")
    return ratio


def time_level(level, C, f_batched, noise, plain=True, routes=("phase", "stream")):
    """ms per launch of the visit kernels of ``routes`` (in-kernel noise on, as
    the main path runs them): CUDA events around back-to-back launches
    (``<kernel>_ms``) and the profiler's device time of the kernel alone
    (``<kernel>_device_ms``); and of the plain versions (noise tensors drawn
    inside the timed region), at one level's shape."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    dev = level.coeffs.device
    vshape = level.op.vshape
    f = torch.rand((C,) + vshape if f_batched else vshape, device=dev)
    x = torch.zeros((C,) + vshape, device=dev)
    xc = torch.randn((C,) + level.vc, device=dev)

    def plain_noise(kind="descend"):
        xi, xi_lr, _ = level._draw(_TensorNoise(noise), x, kind)
        return xi, xi_lr

    out = {}
    for route in routes:
        for name, fn in zip(VISIT_KERNELS[route], visit_fns(level, route, noise, f, x, xc)):
            host = {}
            out[f"{name}_ms"] = cuda_ms(fn, 5, 10 if C > 1 else 50, host)
            out[f"{name}_host_ms"] = host["ms"]
            out[f"{name}_device_ms"] = device_ms_median(fn, PROFILER_NAMES[name], 20)
            out[f"{name}_events_over_device"] = check_events_against_device(
                f"{name} {tuple(vshape)} C={C}", out[f"{name}_ms"], out[f"{name}_device_ms"],
                host["ms"])
    if not plain:
        return out
    x.zero_()
    out["descend_plain_ms"] = cuda_ms(
        lambda: mv.descend_visit_plain(level, f, x, *plain_noise()), 3, 3)
    out["ascend_plain_ms"] = cuda_ms(
        lambda: mv.ascend_visit_plain(level, f, x, xc, *plain_noise("ascend")), 3, 3)
    return out


#: chain counts of the ``visit_routes`` table on the flagship's 255^2 and 127^2
#: levels (all three routes; the split route up to 132 chains, at every
#: cluster size that fits), and on the 511^2 and 255^2 (9-point) levels of a
#: 512x512 lattice (the phase and the stream kernels)
ROUTE_CHAINS = (1, 4, 8, 16, 32, 64, 132, 256, 512)
SPLIT_ROUTE_CHAINS = (1, 4, 8, 16, 32, 64, 132)
WIDE_ROUTE_CHAINS = (132, 256, 512)


def time_routes(levels, wide_levels, noise, smi):
    """The ``visit_routes`` line: device ms per launch (torch.profiler) of the
    visit kernels, descend plus ascend, beside the bound: the phase and the
    stream kernels at every chain count of :data:`ROUTE_CHAINS` on the
    flagship's levels 0 and 1 and of :data:`WIDE_ROUTE_CHAINS` on levels 0 and
    1 of the wider lattice; the split kernels on the flagship's levels at every
    count of :data:`SPLIT_ROUTE_CHAINS` and every cluster size that fits and
    schedules.

    The table supports the code's constants when (1) for every level it times
    the threshold of its shape and stencil form (``STREAM_MIN_CHAINS``,
    ``mgmc_visit.stream_min_chains``) is the least measured chain count from
    which on the stream kernels are faster than the phase kernels at every
    larger count on that level, or none where no measured count is one, (2)
    ``SPLIT_MAX_CHAINS`` is the largest count of :data:`SPLIT_ROUTE_CHAINS` up
    to which the split kernels at the rule's cluster size take less than
    :data:`SPLIT_CLEAR_WIN` of the phase kernels' time on both levels, and (3)
    wherever the route takes the split kernels, the rule's cluster size is
    within :data:`SPLIT_SIZE_SLACK` of the best one measured there.  The run
    fails otherwise."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    limit = mv.dynamic_smem_limit()
    rows, faults = [], []
    stream_wins, split_wins, thresholds = {}, {}, {}
    cases = [(f"L{li}", levels[li], ROUTE_CHAINS) for li in (0, 1)]
    cases += [(f"wide L{li}", wide_levels[li], WIDE_ROUTE_CHAINS) for li in (0, 1)]
    for name, level, chains in cases:
        if level.stream_bytes + mv.STREAM_STATIC_SMEM > limit:
            raise AssertionError(f"visit_routes: the stream kernels do not fit {name}")
        H, W = level.op.vshape
        f_batched = not name.endswith("L0")  # level 0 shares f, as on the main path
        for C in chains:
            dev = level.coeffs.device
            f = torch.rand((C,) + level.op.vshape if f_batched else level.op.vshape, device=dev)
            x = torch.zeros((C,) + level.op.vshape, device=dev)
            xc = torch.randn((C,) + level.vc, device=dev)

            candidates = {}

            def add_pair(route, cluster=None):
                fns = visit_fns(level, route, noise, f, x, xc, cluster)
                for i, (kernel, fn) in enumerate(zip(VISIT_KERNELS[route], fns)):
                    candidates[(route, cluster, i)] = (fn, PROFILER_NAMES[kernel])

            def pair_ms(route, cluster=None):
                pair = [medians[(route, cluster, i)] for i in range(2)]
                return None if None in pair else pair

            row = {"level": name, "vshape": [H, W], "stencil_form": level.stencil_form,
                   "chains": C, "stream_smem_bytes": level.stream_bytes,
                   "route": level.route(C)}
            for kind in ("descend", "ascend"):
                bound, by, _ = visit_bound(level, C, f_batched, kind)
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound, by
            for route in ("phase", "stream"):
                add_pair(route)
            sizes, active = [], {}
            split_table = not name.startswith("wide") and C in SPLIT_ROUTE_CHAINS
            if split_table:
                for S in ss.SPLIT_SIZES:
                    if S > H or mv.split_smem_bytes(H, W, S) + mv.SPLIT_STATIC_SMEM > limit:
                        continue
                    active[S] = mv.split_active_clusters(S, level.op.vshape)
                    if active[S] > 0:
                        sizes.append(S)
                        add_pair("split", S)
            # every route and cluster size in interleaved windows
            medians = device_ms_medians(candidates)
            times = {route: pair_ms(route) for route in ("phase", "stream")}
            if split_table:
                split = {S: pair_ms("split", S) for S in sizes}
                rule = mv.split_cluster(C, level.op.vshape, capped=False)
                row["split_by_cluster"] = {str(S): t for S, t in split.items()}
                row["split_active_clusters"] = {str(S): a for S, a in active.items()}
                timed = {S: sum(t) for S, t in split.items() if t is not None}
                row["rule_cluster"] = rule
                row["best_cluster"] = min(timed, key=timed.get) if timed else None
                times["split"] = split.get(rule)
            if None in times.values():
                faults.append(f"{name} C={C}: the profiler showed no device time {times}")
                continue
            for route, t in times.items():
                for kernel, ms in zip(VISIT_KERNELS[route], t):
                    row[f"{kernel}_device_ms"] = ms
            pair = {route: sum(t) for route, t in times.items()}
            row["pair_device_ms"] = pair
            stream_wins[(name, C)] = pair["stream"] <= pair["phase"]
            if "split" in pair:
                split_wins[(name, C)] = pair["split"] < SPLIT_CLEAR_WIN * pair["phase"]
                best = timed[row["best_cluster"]]
                if row["route"] == "split" and (pair["split"] >= pair["phase"]
                                                or pair["split"] > SPLIT_SIZE_SLACK * best):
                    faults.append(f"{name} C={C}: the split kernels at S={rule} take "
                                  f"{pair['split']} ms, S={row['best_cluster']} {best}, "
                                  f"the phase kernels {pair['phase']}")
            rows.append(row)
    for name, level, chains in cases:  # per level: from which count on the stream kernels win
        supported = None
        for C in sorted(chains, reverse=True):
            if not all(w for (lv, c), w in stream_wins.items() if lv == name and c >= C):
                break
            supported = C
        constant = mv.stream_min_chains(level.op.vshape, level.stencil_form)
        thresholds[name] = {"vshape": list(level.op.vshape), "stencil_form": level.stencil_form,
                            "measured": supported, "constant": constant}
        if supported != constant:
            faults.append(f"{name}: the table supports a stream threshold of "
                          f"{'none' if supported is None else f'{supported} chains'}, "
                          f"STREAM_MIN_CHAINS holds {constant} for "
                          f"{tuple(level.op.vshape) + (level.stencil_form,)}")
    split_measured = None
    for C in SPLIT_ROUTE_CHAINS:
        if not all(w for (_, c), w in split_wins.items() if c == C):
            break
        split_measured = C
    if split_measured != mv.SPLIT_MAX_CHAINS:
        faults.append(f"the table supports a split threshold of {split_measured} chains, "
                      f"SPLIT_MAX_CHAINS is {mv.SPLIT_MAX_CHAINS}")
    emit({"visit_routes": rows, "card": smi, "smem_limit": limit,
          "stream_thresholds": thresholds,
          "split_threshold_measured": split_measured,
          "split_threshold_constant": mv.SPLIT_MAX_CHAINS,
          "stream_wins": {f"{name} C={C}": w for (name, C), w in stream_wins.items()},
          "split_wins": {f"{name} C={C}": w for (name, C), w in split_wins.items()},
          "faults": faults})
    if faults:
        raise AssertionError("visit_routes: " + "; ".join(faults))


def check_split_visit_layout(levels):
    """The host's mirror of the split kernels' shared-memory layout
    (``mgmc_visit.split_smem_bytes``, from which the route is chosen) against
    the kernel source's (``mgmc_split_smem_bytes``), the shapes it refuses
    included, and the kernels' static shared memory against the constant the
    route adds; the clusters the card holds at once at the flagship's levels."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    lib = mv.load_split_library()
    static = lib.mgmc_split_static_smem_bytes()
    if static != mv.SPLIT_STATIC_SMEM:
        raise AssertionError(f"split layout: the kernels hold {static} B static, the route "
                             f"adds {mv.SPLIT_STATIC_SMEM}")
    cases = 0
    for H, W in ((255, 255), (127, 127), (23, 23), (15, 15), (9, 1031), (1023, 1023)):
        for S in (1,) + ss.SPLIT_SIZES + (17, 32):
            for m in (0, 8, mv.LANE_SLOTS, mv.LANE_SLOTS + 1, 256):
                got = lib.mgmc_split_smem_bytes(H, W, S, m)
                try:
                    want = mv.split_smem_bytes(H, W, S, m)
                except ValueError:
                    want = -1
                if got != want:
                    raise AssertionError(f"split layout {H}x{W} S={S} m={m}: kernel {got} B, "
                                         f"host {want} B")
                cases += 1
    active = {f"L{li} S={S}": mv.split_active_clusters(S, level.op.vshape)
              for li, level in sorted(levels.items()) if li < 2 for S in ss.SPLIT_SIZES
              if mv.split_smem_bytes(*level.op.vshape, S) + mv.SPLIT_STATIC_SMEM
              <= mv.dynamic_smem_limit()}
    return {"cases": cases, "static_bytes": static, "max_active_clusters": active}


def check_stream_layout(levels, C):
    """The host's mirror of the stream kernels' shared-memory layout
    (``mgmc_visit.stream_smem_bytes``, from which the route is chosen) against
    the kernel source's (``mgmc_stream_smem_bytes``) on the flagship's fused
    levels and on the two shapes whose rings do not fit a block (a 1023^2
    5-point level, a 511^2 4-colour level); the card's opt-in limit and the
    kernels' static shared memory against the constants the route uses."""
    import ctypes

    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    lib = mv.load_stream_library()
    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", None)
    static = lib.mgmc_stream_static_smem_bytes()
    if (optin is not None and optin != mv.SMEM_PER_BLOCK_OPTIN) or not (
            0 <= static <= mv.STREAM_STATIC_SMEM):
        raise AssertionError(f"stream layout: the card grants {optin} B a block, the kernels "
                             f"hold {static} B static; the route assumes "
                             f"{mv.SMEM_PER_BLOCK_OPTIN} and {mv.STREAM_STATIC_SMEM}")
    cases = []
    for li, level in sorted(levels.items()):
        for order, ascend in ((level.pre_order, 0), (level.post_order, 1)):
            S = level._params(C, order, False, 1, (0, 0), route="stream")
            H, W = level.op.vshape
            cases.append((f"L{li}", S, ascend, level.stream_threads, H, W, level.op.m_lowrank))
    for name, H, max_lag in (("1023^2 5-point", 1023, 2), ("511^2 4-colour", 511, 6)):
        for ascend in (0, 1):
            S = mv.StreamParams()
            S.v.H = S.v.W = H
            S.v.Hc = S.v.Wc = H // 2
            S.v.m, S.max_lag = 8, max_lag
            cases.append((name, S, ascend, 256, H, H, 8))
    out = []
    limit = mv.dynamic_smem_limit()
    for name, S, ascend, threads, H, W, m in cases:
        got = lib.mgmc_stream_smem_bytes(ctypes.byref(S), ascend, threads)
        want = mv.stream_smem_bytes(H, W, S.max_lag, m, threads, bool(ascend))
        fits = want + mv.STREAM_STATIC_SMEM <= limit
        if got != want or fits != name.startswith("L"):
            raise AssertionError(f"stream layout {name}: kernel {got} B, host {want} B, "
                                 f"fits a block's {limit} B: {fits}")
        out.append({"case": name, "ascend": bool(ascend), "bytes": got, "fits": fits,
                    "route": mv.visit_route(C, want)})
    return {"optin_bytes": optin, "static_bytes": static, "cases": out}


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

    def philox_streams(self, n):
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

    def draw(seed, counter, route="phase"):
        # the split kernels of all C chains in clusters of 16 (several waves)
        x = torch.zeros((C,) + lattice.vshape, device=device)
        x, _ = mv.launch_descend(level, route, f, x, philox=(seed, counter), cluster=16)
        return x

    seed = 0x1234_5678_9ABC_DEF0
    z0 = draw(seed, 7)
    if not torch.equal(z0, draw(seed, 7)):
        raise AssertionError("philox: two launches with the same seed and counter differ")
    # known answer: the host reference of the same generator, incl. high counter
    # words, read out through every route's descend kernel
    ka = {}
    for route in mv.ROUTES:
        ka[route] = 0.0
        for counter in (7, (1 << 32) + 5):
            z = z0 if (counter, route) == (7, "phase") else draw(seed, counter, route)
            ref = mv.philox_normals_reference(seed, counter, C, lattice.vshape)
            rows = [0, 1, C - 1]
            ka[route] = max(ka[route], float(np.abs(z[rows].cpu().numpy() - ref[rows]).max()))
    ka_err = ka["phase"]
    if max(ka.values()) > 2e-5:
        raise AssertionError(f"philox: kernel normals differ from the reference by {ka}")
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
            "max_stream_corr": max_corr, "known_answer_max_err": ka_err,
            "known_answer_max_err_stream": ka["stream"],
            "known_answer_max_err_split": ka["split"]}


# ------------------------------------------------- phase: kernels (the sweeps)
def reach2_operator(nx, device):
    """A synthetic 13-point (reach 2) operator on an nx x nx lattice: the
    stencil of a shifted squared Laplacian with a diagonal that varies in
    space; diagonally dominant."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.ops.stencil import StencilOperator

    lattice = Lattice((nx, nx))
    weights = {(0, 0): 21.0, (0, 1): -8.0, (0, -1): -8.0, (1, 0): -8.0, (-1, 0): -8.0,
               (1, 1): 2.0, (1, -1): 2.0, (-1, 1): 2.0, (-1, -1): 2.0,
               (0, 2): 1.0, (0, -2): 1.0, (2, 0): 1.0, (-2, 0): 1.0}
    offsets = tuple(weights)
    coeffs = torch.stack([torch.full(lattice.vshape, w, device=device) for w in weights.values()])
    ii, jj = torch.meshgrid(torch.arange(nx - 1, device=device),
                            torch.arange(nx - 1, device=device), indexing="ij")
    coeffs[0] += 30.0 + 5.0 * torch.sin(0.1 * ii) * torch.cos(0.07 * jj)
    return StencilOperator(coeffs=coeffs, offsets=offsets, lattice=lattice).normalized()


def sweep_cases(device):
    """``(name, operator, chains, omega)``: the shapes the drivers give the sweep
    kernels (255^2 5-point and its Galerkin levels, one chain and many) and
    what else the port's operators produce."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import (ConstantCorrelationLengthModel,
                                                          PeriodicCorrelationLengthModel)
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
    from multigridmc_tpu_torch.ops.coarsen import galerkin_coarsen

    const = ConstantCorrelationLengthModel(0.2)
    fine = shiftedlaplace_fd(Lattice((256, 256)), const, device=device)
    fine3 = shiftedlaplace_fd(Lattice((64, 64, 64)), const, device=device)
    periodic = shiftedlaplace_fd(Lattice((128, 128)), PeriodicCorrelationLengthModel(0.2, 0.4),
                                 device=device)
    return [
        ("2d_255_5pt", fine, 256, 1.0),
        ("2d_127_9pt_galerkin", galerkin_coarsen(fine), 256, 1.3),
        ("2d_255_5pt_one_chain", fine, 1, 1.3),
        ("2d_127_5pt_varying", periodic, 64, 1.3),
        ("3d_63_7pt", fine3, 32, 1.0),
        ("3d_31_27pt_galerkin", galerkin_coarsen(fine3), 32, 1.3),
        ("2d_63_13pt_reach2", reach2_operator(64, device), 64, 1.3),
        ("2d_127_25pt_reach2", galerkin_coarsen(reach2_operator(256, device)), 64, 1.0),
    ]


def distill_cases(device, nx, nlevel, n_meas):
    """``(name, operator, chains, omega)``: the one-block sweeps of the
    flagship's levels below the distillation level, each level at the chain
    count that the distillation set-up hands it (every basis column a chain)
    and at the main path's 256 chains, at which the level-0-fused variant's
    composed visits sweep them (Gibbs with in-kernel noise)."""
    _, _, shapes = distill_sweep_shapes(flagship_posterior(device, nx, n_meas), nlevel)
    cases, seen = [], set()
    for d in shapes:
        tag = "x".join(map(str, d["vshape"]))
        if tag in seen:
            continue
        seen.add(tag)
        plan = d["plan"]
        cases += [(f"distill_{tag}", plan.op, d["chains"], plan.omega),
                  (f"level0_fused_{tag}", plan.op, 256, plan.omega)]
    return cases


#: chains at each end of a launch whose in-kernel normals are held against the
#: host's reference where a launch has more than twice as many (the numpy
#: reference of every chain of a distillation sweep would take minutes)
NOISE_CHECK_CHAINS = 128


def noise_check_chains(C):
    """The chains of a ``C``-chain launch whose in-kernel normals are checked:
    all of them, or the first and the last :data:`NOISE_CHECK_CHAINS` (the
    first and the last wave of blocks)."""
    if C <= 2 * NOISE_CHECK_CHAINS:
        return [(0, C)]
    return [(0, NOISE_CHECK_CHAINS), (C - NOISE_CHECK_CHAINS, NOISE_CHECK_CHAINS)]


def check_sweeps(device, gen, nx, nlevel, n_meas):
    """Both sweep kernels of the one-block route against their plain versions,
    forward and backward, ``b`` shared and per chain, on every case of
    :func:`sweep_cases` and :func:`distill_cases`: noise off, then the same
    ``xi`` fed to both, then (2d) the in-kernel generator against the plain
    version fed the host's reference normals (TOL; at many chains on the chains
    of :func:`noise_check_chains`).  Where the one-block route takes the passes
    body (any of its builds) or a shared-memory body, the generic body of
    ``sor_sweep.cu`` beside it on the same inputs and under one Philox stream
    (ROUTE_TOL: the same terms in the same order).  Each row gives the passes
    body's block sizes; the run fails unless the checks launched it at every
    size :func:`sor_sweep.sweep_threads` gives."""
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import BACKWARD, FORWARD, SORSmoother

    errs = {"sweep_batched": 0.0, "gibbs_sweep_batched": 0.0, "sweep_batched_generic": 0.0,
            "gibbs_sweep_batched_generic": 0.0, "sweep_batched_smem": 0.0,
            "gibbs_sweep_batched_smem": 0.0, "sweep_batched_smem3d": 0.0,
            "gibbs_sweep_batched_smem3d": 0.0}
    body_err = 0.0
    rows = []
    threads_checked = set()
    for name, op, C, omega in sweep_cases(device) + distill_cases(device, nx, nlevel, n_meas):
        for direction in (FORWARD, BACKWARD):
            plan = SORSmoother(op, omega, 1, direction).plan
            x = torch.randn((C,) + op.vshape, device=device, generator=gen)
            xi = torch.randn((C,) + op.vshape, device=device, generator=gen)
            suffix = "" if plan.body == "passes" else "_" + plan.body
            row = {"case": name, "chains": C, "vshape": list(op.vshape), "omega": omega,
                   "offsets": len(op.offsets), "colours": plan.coloring.n_colors,
                   "direction": direction, "body": plan.body, "sweep_err": 0.0,
                   "gibbs_err": 0.0}
            if plan.body == "passes":
                launches = [plan.pass_launch(plan.params(C, True, mode, (0, 0)))
                            for mode in (0, 1)]
                row["stencil_form"] = launches[0].form
                row["build"] = list(launches[0].build)
                row["threads"] = {"sweep": launches[0].threads, "gibbs": launches[1].threads}
                threads_checked.update(row["threads"].values())
            elif plan.body == "smem":
                launch = plan.smem_launch(plan.params(C, True, 0, None))
                row.update({"kmax": launch.kmax, "threads": launch.threads,
                            "smem_bytes": launch.nbytes,
                            "interior_points": int(sum(launch.params.plain[o] for o in
                                                       range(launch.params.n_order)))})
            elif plan.body == "smem3d":
                launch = plan.smem3d_launch(plan.params(C, True, 1, (0, 0)))
                row.update({"cluster": launch.S, "c_shared": launch.c_shared,
                            "threads": launch.threads, "smem_bytes": launch.nbytes})
            if plan.body != "generic":
                row["against_generic"] = 0.0
            for b_batched in (False, True):
                b = torch.randn(((C,) if b_batched else ()) + op.vshape, device=device,
                                generator=gen)
                tag = f"{name} {direction} {'b per chain' if b_batched else 'b shared'}"
                want_det = ss.sweep_batched_plain(op, plan.masks, omega, plan.order, b, x)
                got_det = ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x.clone())
                row["sweep_err"] = max(row["sweep_err"],
                                       compare(f"sweep {tag}", got_det, want_det))
                want = ss.gibbs_sweep_batched_plain(op, plan.masks, omega, plan.order, b, x, xi)
                got = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), xi=xi)
                row["gibbs_err"] = max(row["gibbs_err"], compare(f"gibbs sweep {tag}", got, want))
                if plan.body == "generic":
                    del want, want_det
                    continue
                against = [(got_det, ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(),
                                                     body="generic")),
                           (got, ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), xi=xi,
                                                       body="generic"))]
                row["against_generic"] = max([row["against_generic"]] + [
                    float((new - old).abs().max()) for new, old in against])
                # the generic body's own error, beside the body it is held to
                errs["sweep_batched_generic"] = max(errs["sweep_batched_generic"], compare(
                    f"generic sweep {tag}", against[0][1], want_det))
                errs["gibbs_sweep_batched_generic"] = max(
                    errs["gibbs_sweep_batched_generic"],
                    compare(f"generic gibbs sweep {tag}", against[1][1], want))
                del against, got_det, want, want_det
                # the in-kernel generator against the reference normals
                seed, counter = 0x5EED_0010 + C, 5 + b_batched
                got = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(),
                                            philox=(seed, counter))
                old = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(),
                                            philox=(seed, counter), body="generic")
                row["against_generic"] = max(row["against_generic"],
                                             float((got - old).abs().max()))
                del old
                for first, n in noise_check_chains(C):
                    part = slice(first, first + n)
                    ref = torch.as_tensor(common.philox_normals_reference(
                        seed, counter, n, op.vshape, first_chain=first), device=device)
                    want = ss.gibbs_sweep_batched_plain(op, plan.masks, omega, plan.order,
                                                        b[part] if b_batched else b, x[part], ref)
                    row["gibbs_err"] = max(row["gibbs_err"], compare(
                        f"gibbs sweep {tag} in-kernel noise, chains {first}..{first + n - 1}",
                        got[part], want))
                del got
            if row.get("against_generic", 0.0) > ROUTE_TOL:
                raise AssertionError(f"sweeps: {name} {direction}: the {plan.body} and the "
                                     f"generic body differ by {row['against_generic']}")
            body_err = max(body_err, row.get("against_generic", 0.0))
            errs["sweep_batched" + suffix] = max(errs["sweep_batched" + suffix], row["sweep_err"])
            errs["gibbs_sweep_batched" + suffix] = max(errs["gibbs_sweep_batched" + suffix],
                                                       row["gibbs_err"])
            rows.append(row)
            del x, xi, b
    torch.cuda.synchronize()  # a fault during a launch surfaces here
    missing = set(ss.SWEEP_WAVE_THREADS) - threads_checked
    if missing:
        raise AssertionError(f"sweeps: the checks launched the passes body at no block of "
                             f"{sorted(missing)} threads")
    return errs, body_err, rows


def check_sweep_philox(device):
    """The Gibbs kernels' in-kernel normals, read out through the kernels of
    both routes: on an identity operator with f = 0, x = 0, omega = 1 the sweep
    returns x = xi.  Known answer (2d and 3d, counters above 2^32; the 3d
    field's one-block route is the smem3d body) and moments; the split route
    at its one-chain cluster size, bitwise equal to the one-block route."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.ops.stencil import StencilOperator
    from multigridmc_tpu_torch.smoothers import SORSmoother

    seed = 0x0FED_CBA9_8765_4321
    out = {}
    for shape, C in (((256, 256), 64), ((64, 64, 64), 8)):
        lattice = Lattice(shape)
        dim = len(shape)
        offsets = [(0,) * dim]
        for d in range(dim):
            for o in (-1, 1):
                offsets.append(tuple(o if a == d else 0 for a in range(dim)))
        coeffs = torch.zeros((len(offsets),) + lattice.vshape, device=device)
        coeffs[0] = 1.0
        op = StencilOperator(coeffs=coeffs, offsets=tuple(offsets), lattice=lattice)
        plan = SORSmoother(op, 1.0, 1).plan
        f = torch.zeros(lattice.vshape, device=device)

        # the split route at its one-chain cluster size: the route of a 2d
        # field's one chain; a 3d 7-point field's sweeps take the smem3d body
        # at every chain count (SPLIT_MAX_CHAINS), so the one-block route
        # there is that body and the split route is named
        split = ("split", ss.split_size(1, lattice.vshape, op.offsets, 1, device))
        if split[1] is None or (dim == 2 and plan.route(1, 1) != split):
            raise AssertionError(f"gibbs sweep: one chain of {shape} takes {plan.route(1, 1)}, "
                                 f"the split route {split}")

        def draw(counter, route=ss.BLOCK_ROUTE):
            x = torch.zeros((C,) + lattice.vshape, device=device)
            return ss.launch_gibbs_sweep(plan, route, f, x, philox=(seed, counter))

        z = draw(3)
        if not torch.equal(z, draw(3)):
            raise AssertionError("gibbs sweep: two launches with the same seed and counter differ")
        if torch.equal(z, draw(4)):
            raise AssertionError("gibbs sweep: two launch counters gave the same normals")
        ka = {}
        for route in (ss.BLOCK_ROUTE, split):
            ka[route[0]] = 0.0
            for counter in (3, (1 << 32) + 9):
                zc = z if (counter, route) == (3, ss.BLOCK_ROUTE) else draw(counter, route)
                ref = common.philox_normals_reference(seed, counter, C, lattice.vshape)
                ka[route[0]] = max(ka[route[0]], float(np.abs(zc.cpu().numpy() - ref).max()))
                if route != ss.BLOCK_ROUTE and not torch.equal(zc, draw(counter)):
                    raise AssertionError("gibbs sweep: the split route's normals differ from "
                                         "the one-block route's")
        ka_err = ka["block"]
        if max(ka.values()) > 2e-5:
            raise AssertionError(f"gibbs sweep: normals differ from the reference by {ka}")
        zd = z.double()
        N = zd.numel()
        mean, var, m4 = float(zd.mean()), float(zd.var()), float((zd ** 4).mean())
        if not (abs(mean) < 5 / np.sqrt(N) and abs(var - 1) < 5 * np.sqrt(2 / N)
                and abs(m4 - 3) < 5 * np.sqrt(96 / N)):
            raise AssertionError(f"gibbs sweep normals: mean={mean} var={var} m4={m4}")
        out["x".join(map(str, lattice.vshape))] = {
            "draws": N, "mean": mean, "var": var, "m4": m4, "known_answer_max_err": ka_err,
            "known_answer_max_err_split": ka["split"], "split_cluster": split[1]}
    return out


def check_philox_collision(device):
    """Whether the kernels' normals are torch's own.  torch's CUDA generator
    seeded with ``s`` runs Philox4x32-10 under the key ``s`` with the counter
    ``(offset / 4, 0, thread, 0)``, and ``torch.randn(N)[L]`` is the first
    normal of thread ``L``; its ``g``-th small draw starts at offset ``4 g``.
    The kernels' counter of point group ``g``, chain 0, launch ``L`` is
    ``(g, 0, L, 0)``.  Under the bare key ``s`` the two coincide up to rounding
    (torch forms its uniforms from 32 bits, the kernels from 24) and the
    order of sine and cosine; the kernels' key ``s ^ PHILOX_KEY_MIX`` keeps
    them apart.  Prints both; fails if the kernels' normals are torch's."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.ops.stencil import StencilOperator
    from multigridmc_tpu_torch.smoothers import SORSmoother
    from multigridmc_tpu_torch.utils.runtime import make_generator

    seed, N, groups = 20260816, 256, 2
    launches = (0, 1, 2, 7, 100, 255)
    gen = make_generator(seed, device)
    torch_draws = [torch.randn(N, device=device, generator=gen).cpu().numpy()
                   for _ in range(groups)]  # draw g at generator offset 4 g
    lattice = Lattice((4 * groups + 1, 2))  # one row of 4 * groups points
    coeffs = torch.zeros((5,) + lattice.vshape, device=device)
    coeffs[0] = 1.0
    op = StencilOperator(coeffs=coeffs, offsets=((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
                         lattice=lattice)
    plan = SORSmoother(op, 1.0, 1).plan
    f = torch.zeros(lattice.vshape, device=device)

    def nearest(value, four):  # the closest of a group's four normals (sine or cosine)
        return float(np.abs(four - value).min())

    bare, kernel = [], []
    for L in launches:
        ref = common.philox_normals_reference(seed, L, 1, lattice.vshape, key=seed)[0, 0]
        z = ss.gibbs_sweep_batched(plan, f, torch.zeros((1,) + lattice.vshape, device=device),
                                   philox=(seed, L))[0, 0].cpu().numpy()
        for g in range(groups):
            t = torch_draws[g][L]
            bare.append(nearest(t, ref[4 * g:4 * g + 4]))
            kernel.append(nearest(t, z[4 * g:4 * g + 4]))
    torch.cuda.synchronize()
    # a collision: every one of the len(launches) * groups draws is a normal of
    # the same counter (a chance match of one draw is about 4 * 2 tol * 0.4)
    tol = 1e-3
    out = {"seed": seed, "launches": list(launches), "groups": groups, "tolerance": tol,
           "bare_key_max_diff": max(bare), "bare_key_matches": sum(d < tol for d in bare),
           "bare_key_collides": max(bare) < tol,
           "kernel_key_min_diff": min(kernel), "kernel_key_matches": sum(d < tol for d in kernel),
           "kernel_key_collides": max(kernel) < tol, "draws": len(bare)}
    emit({"philox_collision": out})
    if out["kernel_key_collides"]:
        raise AssertionError(f"philox: the kernels' normals are torch's own: {out}")
    return out


def sweep_bound(plan, C, b_batched):
    """Least time of one sweep on the card: x read and written and b read once
    per chain (b once for all when shared), plus the coefficient planes that
    vary in space, over the memory rate, against the float32 operations over
    the peak rate."""
    from multigridmc_tpu_torch.ops.kernels.common import compress_plan

    op = plan.op
    n = int(np.prod(op.vshape))
    K = len(op.offsets)
    const_coeffs, _, _ = compress_plan(op, plan.omega)
    words = C * n * (3 if b_batched else 2) + (0 if b_batched else n)
    words += n * sum(c is None for c in const_coeffs)
    flops = C * n * (2 * K + 4)
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 4 * words


#: the sweep kernels as torch.profiler names them, by route or one-block body
SWEEP_KERNELS = {("passes", "sweep"): "passes_sweep_kernel",
                 ("passes", "gibbs"): "passes_gibbs_kernel",
                 ("smem", "sweep"): "smem_sweep_kernel",
                 ("smem", "gibbs"): "smem_gibbs_kernel",
                 ("smem3d", "sweep"): "smem3d_sweep_kernel<false",
                 ("smem3d", "gibbs"): "smem3d_sweep_kernel<true",
                 ("generic", "sweep"): "sor_sweep_kernel",
                 ("generic", "gibbs"): "gibbs_sweep_kernel",
                 ("split", "sweep"): "cluster_sweep_kernel<false",
                 ("split", "gibbs"): "cluster_sweep_kernel<true"}


def sweep_kernel(route, body, kind):
    """The profiler's name of the sweep kernel of ``route`` (one-block: of
    ``body``) and ``kind`` (``"sweep"`` or ``"gibbs"``)."""
    return SWEEP_KERNELS[("split" if route[0] == "split" else body, kind)]


def time_sweeps(device, noise):
    """ms per launch of both sweep kernels (the Gibbs kernel with its
    in-kernel noise, ``b`` per chain as the samplers of a posterior give it)
    through the one-block route (on 2d fields the passes body and, in the same
    call, the generic body of ``sor_sweep.cu`` beside it) and, where the case's
    chain count takes it, the split route; their plain versions' ms and the
    bound, per case."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import SORSmoother

    rows, faults = [], []
    for name, op, C, omega in sweep_cases(device):
        plan = SORSmoother(op, omega, 1).plan
        b = torch.rand((C,) + op.vshape, device=device)
        x = torch.zeros((C,) + op.vshape, device=device)
        bound, by, nbytes = sweep_bound(plan, C, True)
        inner = 10 if C > 1 else 50
        row = {"case": name, "chains": C, "vshape": list(op.vshape), "body": plan.body,
               "threads": (plan.pass_launch(plan.params(C, True, 0, None)).threads
                           if plan.body == "passes" else
                           plan.smem_launch(plan.params(C, True, 0, None)).threads
                           if plan.body == "smem" else
                           plan.smem3d_launch(plan.params(C, True, 0, None)).threads
                           if plan.body == "smem3d" else plan.threads),
               "generic_threads": plan.threads,
               "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes}
        routes = {"": (ss.BLOCK_ROUTE, plan.body)}
        if plan.body != "generic":
            routes["generic_"] = (ss.BLOCK_ROUTE, "generic")
        if plan.route(C, 0)[0] == "split":
            routes["split_"] = (plan.route(C, 0), None)
            row["split_cluster"] = plan.route(C, 0)[1]
            row["split_threads"] = ss.split_threads(op.vshape, plan.route(C, 0)[1])
        for prefix, (route, body) in routes.items():
            gibbs_route = plan.route(C, 1) if prefix == "split_" else route

            def det():
                return ss.launch_sweep(plan, route, b, x, body=body)

            def gibbs():
                return ss.launch_gibbs_sweep(plan, gibbs_route, b, x, philox=noise.philox_stream(),
                                             body=body)

            hosts = {"sweep": {}, "gibbs": {}}
            row[f"{prefix}sweep_ms"] = cuda_ms(det, 5, inner, hosts["sweep"])
            row[f"{prefix}gibbs_ms"] = cuda_ms(gibbs, 5, inner, hosts["gibbs"])
            row[f"{prefix}sweep_device_ms"] = device_ms_median(
                det, sweep_kernel(route, body, "sweep"), 20)
            row[f"{prefix}gibbs_device_ms"] = device_ms_median(
                gibbs, sweep_kernel(gibbs_route, body, "gibbs"), 20)
            for kind, fn, r in (("sweep", det, route), ("gibbs", gibbs, gibbs_route)):
                w = device_window(fn, sweep_kernel(r, body, kind), 20)
                row[f"{prefix}{kind}_window"] = {"kernel": w["key"], "launches": w["count"],
                                                 "other_kernels": w["other_kernels"]}
                try:
                    row[f"{prefix}{kind}_host_ms"] = hosts[kind]["ms"]
                    row[f"{prefix}{kind}_events_over_device"] = check_events_against_device(
                        f"{name} {prefix}{kind}", row[f"{prefix}{kind}_ms"],
                        row[f"{prefix}{kind}_device_ms"], hosts[kind]["ms"])
                except AssertionError as err:
                    faults.append(str(err))
        x.zero_()
        row["sweep_plain_ms"] = cuda_ms(
            lambda: ss.sweep_batched_plain(op, plan.masks, omega, plan.order, b, x), 3, 3)
        row["gibbs_plain_ms"] = cuda_ms(
            lambda: ss.gibbs_sweep_batched_plain(op, plan.masks, omega, plan.order, b, x,
                                                 torch.randn_like(x)), 3, 3)
        rows.append(row)
    if faults:
        emit({"sweep_timings": rows})
        raise AssertionError("sweep timings: " + "; ".join(faults))
    return rows


def flagship_posterior(device, nx, n_meas):
    """The flagship's posterior: the shifted-Laplace prior, near-exact
    measurements from :data:`FLAGSHIP_SEED`."""
    return build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)[0]


def distill_sweep_shapes(op, nlevel):
    """The sweeps the distillation set-up of ``op`` (the flagship's posterior,
    or the biharmonic one) hands the sweep kernels: the plans, routes and
    chain counts of every deterministic sweep launch while the default
    (distilled) sampler is built, counted by shape."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    seen = {}
    launch = ss.launch_sweep

    def recording(plan, route, b, x, *args, **kwargs):
        key = (tuple(plan.op.vshape), int(x.shape[0]), b.ndim == x.ndim, plan.order)
        seen.setdefault(key, [plan, 0, route])[1] += 1
        return launch(plan, route, b, x, *args, **kwargs)

    ss.launch_sweep = recording
    try:
        t0 = time.perf_counter()
        sampler = MultigridMCSampler(op, nlevel, smoother="SOR", coarse_solver="Cholesky",
                                     omega=1.0, cycle=2, distill=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        ss.launch_sweep = launch
    return sampler.distill_level, seconds, [
        {"vshape": list(k[0]), "chains": k[1], "b_batched": k[2], "order": list(k[3]),
         "launches": n, "plan": plan, "route": route} for k, (plan, n, route) in seen.items()]


#: launches of a sweep's stamps build per row of the breakdown by pass: the
#: row is the launch of median span (one launch in several runs slower, as a
#: profiler window can)
STAMP_LAUNCHES = 5


def time_sweep_passes(device, noise, bodies, nx, nlevel, n_meas):
    """The one-block sweep kernels' launches by pass, from the stamps builds
    of the bodies ``bodies`` (``"generic"``: ``sor_sweep.cu``, the kernels before
    the passes; ``"passes"``: ``sor_sweep_passes.cu``), on the 256-chain 2d
    reach-1 cases of :func:`sweep_cases` (both kernels, the Gibbs kernel with its
    in-kernel noise, ``b`` per chain) and on the shapes the flagship's
    distillation set-up hands the deterministic kernel: per pass the median
    over the blocks, their sum and span against the profiler's device ms of
    the production build, the barriers each block passed against the count
    from the source (the rhs pass and one per colour) and the blocks one SM
    ran at once; of :data:`STAMP_LAUNCHES` launches the one of median span
    (every launch's span beside)."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import SORSmoother

    cases = [(name, SORSmoother(op, omega, 1).plan, C, ("sweep", "gibbs"))
             for name, op, C, omega in sweep_cases(device)
             if C == 256 and ss.passes_build(op.vshape, op.offsets) == (1, 2)]
    level, seconds, shapes = distill_sweep_shapes(flagship_posterior(device, nx, n_meas), nlevel)
    cases += [(f"distill {'x'.join(map(str, d['vshape']))}", d["plan"], d["chains"], ("sweep",))
              for d in shapes if d["b_batched"]]
    rows = []
    for name, plan, C, kinds in cases:
        vshape = plan.op.vshape
        b = torch.rand((C,) + vshape, device=device)
        x = torch.zeros((C,) + vshape, device=device)
        for kind in kinds:
            for body in bodies:
                def run(stamps=None):
                    if kind == "sweep":
                        return ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x, body=body,
                                               stamps=stamps)
                    return ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x,
                                                 philox=noise.philox_stream(), body=body,
                                                 stamps=stamps)

                device_ms = device_ms_median(run, sweep_kernel(ss.BLOCK_ROUTE, body, kind), 10)
                stamps = [torch.zeros((C, ss.STAMP_WIDTHS[body]), dtype=torch.int64, device=device)
                          for _ in range(STAMP_LAUNCHES)]
                for launch_stamps in stamps:  # back to back, as the profiler's launches
                    run(launch_stamps)
                torch.cuda.synchronize()
                spans = [ss.sweep_pass_times(plan.order, kind == "gibbs", launch_stamps)
                         for launch_stamps in stamps]
                pt = sorted(spans, key=lambda t: t["launch_span_us"])[STAMP_LAUNCHES // 2]
                pt["launch_spans_us"] = [t["launch_span_us"] for t in spans]
                pt["device_ms"] = device_ms
                pt["sum_over_device_ms"] = pt["sum_us"] / 1e3 / device_ms
                pt["span_over_device_ms"] = pt["launch_span_us"] / 1e3 / device_ms
                pt["barriers_from_source"] = ss.barrier_count(plan.order, kind == "gibbs")
                P = plan.params(C, True, int(kind == "gibbs"), (0, 0))
                threads = plan.pass_launch(P).threads if body == "passes" else plan.threads
                row = {"case": name, "vshape": list(vshape), "chains": C, "kind": kind,
                       "body": body, "threads": threads, **pt}
                if pt["barriers_per_block"] != [pt["barriers_from_source"]]:
                    raise AssertionError(f"sweep stamps {name} {kind} {body}: the blocks passed "
                                         f"{pt['barriers_per_block']} barriers, the source "
                                         f"places {pt['barriers_from_source']}")
                if not 0.85 <= pt["span_over_device_ms"] <= 1.15:
                    raise AssertionError(f"sweep stamps {name} {kind} {body}: the stamps span "
                                         f"{pt['span_over_device_ms']} of the device time")
                rows.append(row)
        del b, x
    return {"distill_level": level, "distill_setup_seconds": seconds,
            "distill_shapes": [{k: v for k, v in d.items() if k != "plan"} for d in shapes],
            "rows": rows}


#: chain counts and block sizes of the passes body's block-size table
SWEEP_THREAD_CHAINS = (64, 132, 200, 256, 512)
SWEEP_THREADS = (256, 512, 1024)


def time_sweep_threads(device, noise, nx, nlevel, n_meas):
    """Device ms per launch of the passes body's two kernels at 256, 512 and
    1024 threads per block (the block-size rule, ``sor_sweep.sweep_threads``,
    marked) at the counts of :data:`SWEEP_THREAD_CHAINS` on the 2d fields of
    :func:`sweep_cases` and on the flagship's 63^2 and 31^2 Galerkin levels,
    and at the distillation set-up's own count on those two levels (the
    deterministic kernel).  Returns the rows and the faults: where the rule's
    block size takes more than :data:`SPLIT_SIZE_SLACK` times the best's."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import SORSmoother

    _, _, shapes = distill_sweep_shapes(flagship_posterior(device, nx, n_meas), nlevel)
    distill = {tuple(d["vshape"]): d for d in shapes if d["order"][0] == 0}
    cases = [(name, op, omega) for name, op, C, omega in sweep_cases(device)
             if C > 1 and ss.passes_build(op.vshape, op.offsets) == (1, 2)]
    cases += [(f"{'x'.join(map(str, v))} 9-point Galerkin (distillation)", d["plan"].op, 1.0)
              for v, d in sorted(distill.items(), reverse=True)]
    rows, faults = [], []
    for name, op, omega in cases:
        plan = SORSmoother(op, omega, 1).plan
        counts = SWEEP_THREAD_CHAINS
        if "distillation" in name:
            counts += (distill[tuple(op.vshape)]["chains"],)
        for C in counts:
            b = torch.rand((C,) + op.vshape, device=device)
            x = torch.zeros((C,) + op.vshape, device=device)
            kinds = ("sweep",) if C > 1000 else ("sweep", "gibbs")
            for kind in kinds:
                def run(t):
                    if kind == "sweep":
                        return lambda: ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x, threads=t)
                    return lambda: ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x,
                                                         philox=noise.philox_stream(), threads=t)

                # every block size in interleaved windows
                by_threads = device_ms_medians(
                    {t: (run(t), sweep_kernel(ss.BLOCK_ROUTE, "passes", kind))
                     for t in SWEEP_THREADS})
                timed = {t: v for t, v in by_threads.items() if v is not None}
                rule = plan.pass_launch(plan.params(C, True, int(kind == "gibbs"), (0, 0))).threads
                best = min(timed, key=timed.get) if timed else None
                rows.append({"case": name, "vshape": list(op.vshape), "chains": C, "kind": kind,
                             "rule_threads": rule, "best_threads": best,
                             "device_ms": {str(t): v for t, v in by_threads.items()}})
                if len(timed) < len(SWEEP_THREADS) or timed[rule] > SPLIT_SIZE_SLACK * timed[best]:
                    faults.append(f"{name} C={C} {kind}: {rule} threads against {best}: "
                                  f"{by_threads}")
            del b, x
    return rows, faults


def sweep_kernel_attributes():
    """Registers and local (spill) bytes per thread and static shared bytes of
    the passes body's kernels of every stencil form, as the card's loader
    reports them, and the blocks of 512 and 1024 threads one SM holds."""
    import ctypes

    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    lib = ss.load_passes_library()
    out = {}
    for form in range(mv.STENCIL_FORMS):
        for kind, gibbs in (("sweep", 0), ("gibbs", 1)):
            vals = (ctypes.c_int * 3)()
            err = lib.sor_passes_kernel_attributes(gibbs, form, vals)
            if err:
                raise AssertionError(f"passes {kind} kernel attributes: CUDA error {err}")
            out[f"{kind} form {form}"] = {
                "registers": vals[0], "local_bytes": vals[1], "static_shared_bytes": vals[2],
                "blocks_per_sm": {t: lib.sor_passes_blocks_per_sm(gibbs, form, t)
                                  for t in (256, 512, 1024)}}
    return out


#: the few-chain count at which the split route is checked besides one chain
SPLIT_CHECK_CHAINS = 4
#: the split route against the one-block route under one Philox stream: the
#: same arithmetic on the same values (bitwise equal where nvcc contracts both alike)
ROUTE_TOL = 1e-6


def check_split_sweeps(device, gen):
    """The split route's two kernels against their plain versions on every
    sweep case at one chain and at :data:`SPLIT_CHECK_CHAINS` (the rule's
    cluster size, whether or not the route takes the split route there),
    forward and backward, ``b`` shared and per chain:
    noise off, then the same ``xi`` fed to both (TOL); and against the
    one-block route on the same inputs, the Gibbs kernel under one in-kernel
    Philox stream (ROUTE_TOL)."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import BACKWARD, FORWARD, SORSmoother

    errs = {"sweep_batched_split": 0.0, "gibbs_sweep_batched_split": 0.0}
    route_err = 0.0
    rows = []
    for name, op, _, omega in sweep_cases(device):
        for C in (1, SPLIT_CHECK_CHAINS):
            for direction in (FORWARD, BACKWARD):
                plan = SORSmoother(op, omega, 1, direction).plan
                # the rule's cluster size, also where the route takes one block
                sizes = [ss.split_size(C, op.vshape, op.offsets, mode, device) for mode in (0, 1)]
                if None in sizes:
                    raise AssertionError(f"split sweeps: {name} at {C} chains does not split")
                det_route, gibbs_route = ("split", sizes[0]), ("split", sizes[1])
                x = torch.randn((C,) + op.vshape, device=device, generator=gen)
                xi = torch.randn((C,) + op.vshape, device=device, generator=gen)
                row = {"case": name, "chains": C, "vshape": list(op.vshape),
                       "direction": direction, "cluster": det_route[1],
                       "gibbs_cluster": gibbs_route[1], "sweep_err": 0.0, "gibbs_err": 0.0,
                       "against_block": 0.0}
                for b_batched in (False, True):
                    b = torch.randn(((C,) if b_batched else ()) + op.vshape, device=device,
                                    generator=gen)
                    tag = f"{name} C={C} {direction} {'b per chain' if b_batched else 'b shared'}"
                    want = ss.sweep_batched_plain(op, plan.masks, omega, plan.order, b, x)
                    got = ss.launch_sweep(plan, det_route, b, x.clone())
                    row["sweep_err"] = max(row["sweep_err"], compare(f"split sweep {tag}", got, want))
                    block = ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x.clone())
                    row["against_block"] = max(row["against_block"],
                                               float((got - block).abs().max()))
                    want = ss.gibbs_sweep_batched_plain(op, plan.masks, omega, plan.order, b, x, xi)
                    got = ss.launch_gibbs_sweep(plan, gibbs_route, b, x.clone(), xi=xi)
                    row["gibbs_err"] = max(row["gibbs_err"],
                                           compare(f"split gibbs sweep {tag}", got, want))
                    stream = (0xC0FFEE + C, 7 + b_batched)
                    got = ss.launch_gibbs_sweep(plan, gibbs_route, b, x.clone(), philox=stream)
                    block = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), philox=stream)
                    row["against_block"] = max(row["against_block"],
                                               float((got - block).abs().max()))
                if row["against_block"] > ROUTE_TOL:
                    raise AssertionError(f"split sweeps: {name} C={C} {direction}: the split and "
                                         f"one-block routes differ by {row['against_block']}")
                errs["sweep_batched_split"] = max(errs["sweep_batched_split"], row["sweep_err"])
                errs["gibbs_sweep_batched_split"] = max(errs["gibbs_sweep_batched_split"],
                                                        row["gibbs_err"])
                route_err = max(route_err, row["against_block"])
                rows.append(row)
    torch.cuda.synchronize()
    return errs, route_err, rows


def check_split_layout(device):
    """The host's mirror of the split kernels' shared-memory layout
    (``sor_sweep.split_smem_bytes``, from which the route is chosen) against the
    kernel source's (``sor_sweep_cluster_smem_bytes``), including the shapes it
    refuses, and the clusters the card schedules at the drivers' shape."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    lib = ss.load_split_library()
    shapes = [((255, 255), 1), ((127, 127), 1), ((63, 63), 2), ((15, 15), 1), ((1023, 1023), 1),
              ((63, 63, 63), 1), ((31, 31, 31), 1), ((1, 9, 11), 1)]
    cases = []
    for vshape, reach in shapes:
        Z, Y, X = (1,) * (3 - len(vshape)) + vshape
        for S in (1,) + ss.SPLIT_SIZES + (32,):
            for noise_mode in (0, 1):
                got = lib.sor_sweep_cluster_smem_bytes(Z, Y, X, S, reach, noise_mode)
                try:
                    want = ss.split_smem_bytes(vshape, S, reach, noise_mode)
                except ValueError:
                    want = -1
                if got != want:
                    raise AssertionError(f"split layout {vshape} S={S}: kernel {got} B, "
                                         f"host {want} B")
                cases.append({"vshape": list(vshape), "S": S, "noise_mode": noise_mode,
                              "bytes": got})
    clusters = {}
    for S in ss.SPLIT_SIZES:
        for noise_mode in (0, 1):
            nbytes = ss.split_smem_bytes((255, 255), S, 1, noise_mode)
            clusters[f"255^2 S={S} noise_mode={noise_mode}"] = ss.max_active_clusters(
                torch.device("cuda", torch.cuda.current_device()), noise_mode != 0, S,
                ss.split_threads((255, 255), S), nbytes)
    return {"cases": len(cases), "max_active_clusters": clusters,
            "smem_limit": ss.dynamic_smem_limit(device)}


#: chain counts of the ``sweep_routes`` table
SWEEP_ROUTE_CHAINS = (1, 2, 4, 8, 16, 32, 64, 132, 256)
#: the rule's cluster size stands if its time is within this factor of the
#: best cluster size measured at the same chain count
SPLIT_SIZE_SLACK = 1.10
#: the split route counts as the faster one below this share of the one-block
#: route's time: the measured threshold does not move with a few per cent of noise
SPLIT_CLEAR_WIN = 0.90


def time_sweep_routes(device, noise, smi):
    """The ``sweep_routes`` line: device ms per launch (torch.profiler) of both
    sweep kernels through the one-block route and through the split route at
    every cluster size that fits and schedules, at every chain count of
    :data:`SWEEP_ROUTE_CHAINS` on the fields of each stencil class of
    ``sor_sweep.SPLIT_MAX_CHAINS`` (``sor_sweep.split_stencil``): a 255^2
    5-point field and a 127^2 5-point field whose coefficients vary in space
    (read per point); the 255^2 and 127^2 9-point Galerkin levels of a 511^2
    and a 255^2 field; a 63^3 7-point field (class "3d", the smem3d body:
    slabs over a cluster), the 31^3 27-point Galerkin level of a 64^3 lattice
    (class "3d 27-point", the passes' 3d build) and a 63^2 13-point field of
    reach 2 (class "reach-2", the shared-memory body).  A field's counts end
    after the first at which both kernels' split route failed to win (by
    :data:`SPLIT_CLEAR_WIN`): no threshold depends on a larger count.

    The table supports the code's constants when (1) wherever the route takes
    the split route it beats one block per chain, (2) its cluster size (the
    least ``split_cost``, from ``SPLIT_WAVE_FIXED`` and the clusters the card
    holds at once) is within :data:`SPLIT_SIZE_SLACK` of the best one measured
    there, and (3) each entry of ``SPLIT_MAX_CHAINS`` (by kernel and stencil
    class) is the largest chain count of the table up to which the split route
    at the rule's cluster size takes less than :data:`SPLIT_CLEAR_WIN` of the
    one-block route's time on every field of that class (0 where it does at no
    count).  The run fails otherwise."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import (ConstantCorrelationLengthModel,
                                                          PeriodicCorrelationLengthModel)
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
    from multigridmc_tpu_torch.ops.coarsen import galerkin_coarsen
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import SORSmoother

    const = ConstantCorrelationLengthModel(0.2)
    fine = shiftedlaplace_fd(Lattice((256, 256)), const, device=device)
    wide = shiftedlaplace_fd(Lattice((512, 512)), const, device=device)
    varying = shiftedlaplace_fd(Lattice((128, 128)), PeriodicCorrelationLengthModel(0.2, 0.4),
                                device=device)
    shapes = [("255^2 5-point", fine),
              ("127^2 5-point varying", varying),
              ("255^2 9-point Galerkin", galerkin_coarsen(wide)),
              ("127^2 9-point Galerkin", galerkin_coarsen(fine)),
              ("63^3 7-point", shiftedlaplace_fd(Lattice((64, 64, 64)), const, device=device)),
              ("31^3 27-point Galerkin",
               galerkin_coarsen(shiftedlaplace_fd(Lattice((64, 64, 64)), const, device=device))),
              ("63^2 13-point reach 2", reach2_operator(64, device))]
    limit = ss.dynamic_smem_limit(device)
    rows = []
    for label, op in shapes:
        plan = SORSmoother(op, 1.0, 1).plan
        reach = ss.slow_reach(op.offsets, op.vshape)
        L = ss.split_layout(op.vshape)[0]
        lost = {}
        for C in SWEEP_ROUTE_CHAINS:
            if len(lost) == 2:  # both kernels' split route lost at a smaller count
                break
            b = torch.rand((C,) + op.vshape, device=device)
            x = torch.zeros((C,) + op.vshape, device=device)
            for kernel, noise_mode in (("sweep", 0), ("gibbs", 1)):
                def run(route):
                    if noise_mode == 0:
                        return lambda: ss.launch_sweep(plan, route, b, x)
                    return lambda: ss.launch_gibbs_sweep(plan, route, b, x,
                                                         philox=noise.philox_stream())

                def candidate(route):
                    return run(route), sweep_kernel(route, plan.body, kernel)

                candidates, active = {"block": candidate(ss.BLOCK_ROUTE)}, {}
                for S in ss.SPLIT_SIZES:
                    if S > L or L // S < reach:
                        continue
                    nbytes = ss.split_smem_bytes(op.vshape, S, reach, noise_mode)
                    if nbytes > limit:
                        continue
                    active[S] = ss.active_clusters(device, noise_mode, S,
                                                   ss.split_threads(op.vshape, S), nbytes)
                    if active[S] > 0:
                        candidates[S] = candidate(("split", S))
                # one block and every cluster size in interleaved windows
                split = device_ms_medians(candidates)
                row = {"shape": label, "chains": C, "kernel": kernel,
                       "block_ms": split.pop("block")}
                row["split_ms"] = {str(S): t for S, t in split.items()}
                row["active_clusters"] = {str(S): a for S, a in active.items()}
                timed = {S: t for S, t in split.items() if t is not None}
                row["best_cluster"] = min(timed, key=timed.get) if timed else None
                # the rule's cluster size, whatever the chain count
                row["rule_cluster"] = ss.split_size(C, op.vshape, op.offsets, noise_mode, device)
                row["rule_ms"] = split.get(row["rule_cluster"])
                row["route"] = list(plan.route(C, noise_mode))
                # the threshold that decides this row (sor_sweep.split_max_chains)
                row["key"] = (kernel, ss.split_stencil(op.vshape, op.offsets))
                rows.append(row)
                if not (row["rule_ms"] is not None and row["block_ms"] is not None
                        and row["rule_ms"] < SPLIT_CLEAR_WIN * row["block_ms"]):
                    lost[kernel] = C
    # what the table supports
    faults = []
    wins = {}
    for r in rows:
        tag = f"{r['shape']} {r['kernel']} C={r['chains']}"
        if r["block_ms"] is None or None in r["split_ms"].values():
            faults.append(f"{tag}: the profiler showed no device time")
            wins.setdefault(r["key"], {}).setdefault(r["chains"], []).append(False)
            continue
        if r["route"][0] == "split" and not r["rule_ms"] < r["block_ms"]:
            faults.append(f"{tag}: the split route ({r['rule_ms']}) loses to one block "
                          f"({r['block_ms']})")
        if r["route"][0] == "split":
            best = r["split_ms"][str(r["best_cluster"])]
            if r["rule_ms"] > SPLIT_SIZE_SLACK * best:
                faults.append(f"{tag}: cluster size {r['rule_cluster']} ({r['rule_ms']}) against "
                              f"{r['best_cluster']} ({best})")
        wins.setdefault(r["key"], {}).setdefault(r["chains"], []).append(
            r["rule_ms"] is not None and r["rule_ms"] < SPLIT_CLEAR_WIN * r["block_ms"])
    thresholds = {}
    for key, by_count in wins.items():  # per threshold: the largest count of clear wins
        measured = 0
        for C in sorted(by_count):
            if not all(by_count[C]):
                break
            measured = C
        constant = ss.SPLIT_MAX_CHAINS[key]
        thresholds[str(key)] = {"measured": measured, "constant": constant}
        if measured != constant:
            faults.append(f"the table supports a split threshold of {measured} chains for "
                          f"{key}, the constant is {constant}")
    for key in set(ss.SPLIT_MAX_CHAINS) - set(wins):
        faults.append(f"no field of the table measures the split threshold of {key}")
    emit({"sweep_routes": rows, "card": smi, "smem_limit": limit,
          "thresholds": thresholds,
          "wave_fixed_constant": ss.SPLIT_WAVE_FIXED, "faults": faults})
    if faults:
        raise AssertionError("sweep_routes: " + "; ".join(faults))
    return rows


# ------------------------------------- phase: kernels (subtree, probe, v1 sweeps)
#: the subtree kernel against its plain version.  One launch chains 28 sweeps,
#: 14 residuals and transfers and 8 coarse samples of float32 arithmetic that
#: the plain version does in another summation order, where a single visit
#: (TOL) does one of each.
SUBTREE_TOL = 1e-4


def subtree_bound(kernel, C):
    """Least time of one subtree launch on the card: ``f`` read and ``x``
    written once per chain plus what the kernel is handed by pointer once
    (planes that are not constant, ``B`` and ``Y`` inside their boxes, the small
    matrices, the inverse factor and its transpose), over the memory rate,
    against the float32 operations of every visit and coarse sample of the
    schedule (per point as in ``visit_bound``; a coarse sample is two triangular
    matrix-vector products, ``2 nc^2`` operations, and ``10 nc`` for its
    normals) over the peak rate."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st

    def area(boxes):
        return sum((i1 - i0) * (j1 - j0) for i0, i1, j0, j1 in boxes)

    words = C * 2 * kernel.level_sizes[0] + 2 * kernel.nc ** 2
    for lv, n in zip(kernel.levels, kernel.level_sizes):
        m = lv.op.m_lowrank
        words += n * sum(c is None for c in lv.const_coeffs) + (n if lv.ns_const is None else 0)
        words += area(lv.bbox) + sum(area(lv._woodbury[o][2])
                                     for o in {lv.pre_order, lv.post_order})
        words += 2 * m * m + m * m + 2 * m
    flops = 0
    for op, li in kernel.schedule:
        if op == st.OP_COARSE:
            flops += 2 * kernel.nc ** 2 + 10 * kernel.nc
            continue
        lv, n = kernel.levels[li], kernel.level_sizes[li]
        K, m = len(lv.op.offsets), lv.op.m_lowrank
        per_point = 42 + 2 * m + 2 * K + 4 + 4 * m
        if op == st.OP_ASCEND:
            flops += n * (per_point + 8)
        else:
            flops += n * (per_point + 2 * K + 1 + 2 * m) + 18 * int(np.prod(lv.vc))
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = C * flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 4 * words


def rediscretised_sampler(nx, nlevel, n_meas, device):
    """A subtree sampler whose levels are given by the caller: the posterior of
    ``build_posterior`` discretised anew on each level's lattice (the same
    measurements), so every sub-level has the prior's 5-point stencil, not the
    3x3 box of the Galerkin levels."""
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
    from multigridmc_tpu_torch.solvers.multigrid import MultigridHierarchy

    ops = [build_posterior(nx >> level, n_meas, FLAGSHIP_SEED, "order_one", device)[0]
           for level in range(nlevel)]
    return MultigridMCSampler(ops[0], nlevel, cycle=2, subtree=True,
                              hierarchy=MultigridHierarchy(ops[0], nlevel, operators=ops))


def flagship_subtree_cases(device, nx, nlevel, n_meas):
    """The subtree kernel's cases on the flagship's hierarchy: ``(name, builder
    of the sampler, stencil points of every sub-level)``.  O(1) measurement
    variances, as for the visits' elementwise checks: the flagship's levels 1
    .. coarsest (3x3 Galerkin boxes), a 3-level 64x64 case, and a 4-level one
    whose sub-levels are 5-point stencils (not the 3x3 box)."""
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    def galerkin(cx, cl, cm):
        op, _ = build_posterior(cx, cm, FLAGSHIP_SEED, "order_one", device)
        return MultigridMCSampler(op, cl, cycle=2, subtree=True)

    return (("flagship_levels_1_to_4", lambda: galerkin(nx, nlevel, n_meas), 9),
            ("64x64_3_levels", lambda: galerkin(64, 3, 4), 9),
            ("64x64_4_levels_5_point", lambda: rediscretised_sampler(64, 4, 4, device), 5))


def check_subtree(device, C, gen, cases):
    """The subtree kernel against ``subtree_sample_plain`` on each of
    ``cases`` (``(name, sampler builder, stencil points of every sub-level)``:
    :func:`flagship_subtree_cases`, the biharmonic phase's own) at ``C`` chains: the sub-levels' stencils as the case expects them (and the build
    of their reach); noise off, all normals from one tensor, and the in-kernel
    generator (its recorded normals fed to the plain version, known answers of
    one field, one low-rank and one coarse draw, equal seeds bitwise equal,
    another counter another result, and a placement with every field in the
    global workspace bitwise equal to the one in shared memory)."""
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st

    rows, max_err = [], 0.0
    seed = 0x5EED_0F_7E57
    for name, build, points in cases:
        sampler = build()
        kernel = sampler.subtree
        vshape = kernel.vshape
        f = torch.randn((C,) + tuple(vshape), device=device, generator=gen)
        K = kernel.count_noise()
        xi = torch.randn((C, K), device=device, generator=gen)
        row = {"case": name, "chains": C, "vshape": list(vshape), "normals_per_chain": K,
               "draws": kernel.count_draws(), "schedule_ops": len(kernel.schedule),
               "stencil_points": [len(lv.op.offsets) for lv in kernel.levels],
               "colours": [lv.coloring.n_colors for lv in kernel.levels],
               "reach": kernel.reach, "placement": kernel.placement,
               "barriers_per_launch_from_source": st.barrier_count(kernel)}
        if row["stencil_points"] != [points] * len(kernel.levels) or kernel.reach != (
                2 if points == 25 else 1):
            raise AssertionError(f"subtree {name}: sub-levels of {row['stencil_points']} points "
                                 f"(reach {kernel.reach}), expected {points} points each")
        want = st.subtree_sample_plain(kernel, f)
        row["err_noise_off"] = compare(f"subtree {name} noise off", st.subtree_sample(kernel, f),
                                       want, SUBTREE_TOL)
        row["scale_noise_off"] = float(want.abs().max())
        row["err_shared_noise"] = compare(
            f"subtree {name} shared noise", st.subtree_sample(kernel, f, xi=xi),
            st.subtree_sample_plain(kernel, f, xi), SUBTREE_TOL)
        # the in-kernel generator
        x1, rec = st.subtree_sample(kernel, f, philox=(seed, 100), record=True)
        x2 = st.subtree_sample(kernel, f, philox=(seed, 100))
        if not torch.equal(x1, x2):
            raise AssertionError(f"subtree {name}: equal seeds and counters gave different output")
        if torch.equal(x1, st.subtree_sample(kernel, f, philox=(seed, 100 + kernel.count_draws()))):
            raise AssertionError(f"subtree {name}: another counter gave the same output")
        row["err_philox_vs_plain_on_recorded_normals"] = compare(
            f"subtree {name} in-kernel noise", x1, st.subtree_sample_plain(kernel, f, rec),
            SUBTREE_TOL)
        # known answers: draw d of the launch uses the counter 100 + d
        shapes = kernel.draw_shapes(C)
        offsets = np.concatenate([[0], np.cumsum([int(np.prod(sh[1:])) for sh in shapes])])
        picks = {"field": 0, "lowrank": 1, "coarse": next(
            d for d, sh in enumerate(shapes) if sh == (C, kernel.nc))}
        chains = [0, 1, C - 1]
        ka = {}
        for what, d in picks.items():
            width = int(np.prod(shapes[d][1:]))
            got = rec[:, offsets[d]:offsets[d] + width].cpu().numpy()
            ref_shape = shapes[d][1:] if what == "field" else (1, width)
            ref = common.philox_normals_reference(seed, 100 + d, C, ref_shape).reshape(C, width)
            ka[what] = float(np.abs(got[chains] - ref[chains]).max())
            if ka[what] > 2e-5:
                raise AssertionError(f"subtree {name}: {what} normals differ from the "
                                     f"reference by {ka[what]}")
        row["philox_known_answer_max_err"] = ka
        zd = rec.double()
        row["philox_moments"] = {"draws": zd.numel(), "mean": float(zd.mean()),
                                 "var": float(zd.var()), "m4": float((zd ** 4).mean())}
        N = zd.numel()
        mom = row["philox_moments"]
        if not (abs(mom["mean"]) < 5 / np.sqrt(N) and abs(mom["var"] - 1) < 5 * np.sqrt(2 / N)
                and abs(mom["m4"] - 3) < 5 * np.sqrt(96 / N)):
            raise AssertionError(f"subtree {name}: moments of the in-kernel normals {mom}")
        # every field in the global workspace: the same arithmetic, bitwise
        flat = subtree_variant(sampler, 0)
        if flat.placement["shared_bytes"] != 0:
            raise AssertionError("subtree: smem_budget=0 still placed fields in shared memory")
        if not torch.equal(st.subtree_sample(flat, f, xi=xi), st.subtree_sample(kernel, f, xi=xi)):
            raise AssertionError(f"subtree {name}: the placement changed the result")
        # the barriers each block passed, from the stamps build, against the
        # count from the source (both noise modes)
        width = len(kernel.schedule) + 1 + st.STAMP_EXTRA
        for noisy in (True, False):
            stamps = torch.zeros((C, width), dtype=torch.int64, device=device)
            st.subtree_sample(kernel, f, philox=(seed, 100) if noisy else None, stamps=stamps)
            passed = sorted(int(v) for v in stamps[:, -2].unique())
            want_barriers = st.barrier_count(kernel, noise=noisy)
            row[f"barriers_passed_{'noise' if noisy else 'no_noise'}"] = passed
            if passed != [want_barriers]:
                raise AssertionError(f"subtree {name}: the blocks passed {passed} barriers, the "
                                     f"source places {want_barriers}")
        torch.cuda.synchronize()
        max_err = max(max_err, row["err_noise_off"], row["err_shared_noise"],
                      row["err_philox_vs_plain_on_recorded_normals"])
        rows.append(row)
    return max_err, rows


def subtree_variant(sampler, budget, threads=None):
    """The sampler's subtree kernel built anew with the shared-memory budget
    ``budget`` (bytes; None: the default) and ``threads`` a block (None: the
    default)."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st

    nl = sampler.nlevel
    k = st.SubtreeKernel(sampler.hierarchy.operators[1:],
                         [p.smoother for p in sampler.presamplers[1:nl - 1]],
                         [p.smoother for p in sampler.postsamplers[1:nl - 1]],
                         sampler.coarse_sampler.L, sampler.presamplers[0].omega, sampler.cycle,
                         sampler.coarse_scaling, smem_budget=budget)
    if threads is not None:
        k.threads = threads
    return k


#: the flagship subtree's other block sizes and placements: (threads, field
#: budget in bytes; None the default)
FLAGSHIP_SUBTREE_VARIANTS = ((256, None), (512, None), (1024, None), (512, 0), (1024, 0))


def time_subtree(sampler, C, noise, variants=FLAGSHIP_SUBTREE_VARIANTS, plain_repeats=(3, 2)):
    """ms per launch of ``sampler``'s subtree kernel at ``C`` chains (in-kernel
    noise), its device time, its plain version (the normals drawn inside the
    timed region), its bound, where the launch's time goes by operation (the
    stamps build), and the device ms of ``variants`` (threads a block and
    field budget; a budget ``"one_block"``: the whole block grant); the
    plain version's time over ``plain_repeats`` (repeats, calls each)."""
    import ctypes

    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st

    kernel = sampler.subtree
    device = kernel.Linv.device
    f = torch.rand((C,) + tuple(kernel.vshape), device=device)
    K = kernel.count_noise()
    bound, by, nbytes = subtree_bound(kernel, C)
    out = {"chains": C, "vshape": list(kernel.vshape), "threads": kernel.threads,
           "placement": kernel.placement, "bound_ms": bound, "bound_by": by,
           "bound_bytes": nbytes}
    host = {}
    out["ms"] = cuda_ms(lambda: kernel.sample(noise, f), 5, 10, host)
    out["host_ms"] = host["ms"]
    out["device_ms"] = device_ms_median(lambda: kernel.sample(noise, f), "mgmc_subtree_kernel")
    out["events_over_device"] = check_events_against_device("subtree_sample", out["ms"],
                                                            out["device_ms"], host["ms"])
    out["plain_ms"] = cuda_ms(lambda: st.subtree_sample_plain(
        kernel, f, torch.randn((C, K), device=device)), *plain_repeats)
    # where the launch's time goes: thread 0 of each block stamps the card's
    # global timer at entry, after the table copy, after each operation of the
    # schedule and at exit, and counts the barriers it passes (the last of
    # three launches).  The breakdown (medians over the blocks) sums to the
    # median block, which ends before the slowest one (of the two blocks an SM
    # runs, one ends some 120 us after the other): 0.89 - 0.90 of the device
    # time on this kernel, 0.84 - 0.92 on the earlier versions the bound was
    # set from.  The span from the first entry to the last exit must agree
    # with the profiler's time.
    stamps = torch.zeros((C, len(kernel.schedule) + 1 + st.STAMP_EXTRA), dtype=torch.int64,
                         device=device)
    for _ in range(3):
        st.subtree_sample(kernel, f, philox=noise.philox_streams(kernel.count_draws()),
                          stamps=stamps)
    po = out["per_operation"] = st.operation_times(kernel, stamps)
    # and by pass inside each operation (the timer after every barrier), from
    # launches of their own: each pass's median over the blocks, per operation
    # and level the median over the schedule's operations
    if hasattr(st, "pass_times"):  # (a parent tree of --phases compare lacks it)
        per_op = torch.zeros_like(stamps)
        passes = torch.zeros((C, st.barrier_count(kernel) + 1), dtype=torch.int64, device=device)
        for _ in range(3):
            st.subtree_sample(kernel, f, philox=noise.philox_streams(kernel.count_draws()),
                              stamps=per_op, pass_stamps=passes)
        out["per_pass"] = st.pass_times(kernel, passes)
    # where the chains take more than one wave of blocks (the reach-2 build
    # at 256 chains: one block an SM), a block's breakdown is a wave's share
    waves = po["waves"] = -(-C // (po["blocks_per_sm"] * po["sms"]))
    ratio = po["sum_over_device_ms"] = po["sum_us"] / 1e3 / out["device_ms"]
    if not 0.8 <= ratio * waves <= 1.05:
        raise AssertionError(f"subtree stamps: the operations sum to {ratio} of the device time "
                             f"({waves} waves of blocks)")
    ratio = po["span_over_device_ms"] = po["launch_span_us"] / 1e3 / out["device_ms"]
    if not 0.9 <= ratio <= 1.1:
        raise AssertionError(f"subtree stamps: the launch spans {ratio} of the device time")
    # measured on the card: the barriers each block passed (held against the
    # count from the source, st.barrier_count) and the blocks one SM ran at
    # once (held against the occupancy calculator's answer)
    out["barriers_per_launch_from_source"] = st.barrier_count(kernel)
    if po["barriers_per_block"] != [out["barriers_per_launch_from_source"]]:
        raise AssertionError(f"subtree: the blocks passed {po['barriers_per_block']} barriers, "
                             f"the source places {out['barriers_per_launch_from_source']}")
    lib = st.load_library(kernel.reach)
    out["blocks_per_sm_occupancy_api"] = lib.mgmc_subtree_blocks_per_sm(kernel.threads,
                                                                        kernel.smem_bytes)
    if not 1 <= po["blocks_per_sm"] <= out["blocks_per_sm_occupancy_api"]:
        raise AssertionError(f"subtree: {po['blocks_per_sm']} blocks ran on one SM at once, "
                             f"the occupancy calculator allows "
                             f"{out['blocks_per_sm_occupancy_api']}")
    regs, local = ctypes.c_int(), ctypes.c_int()
    out["kernel_attributes"] = {}
    for which, (label, stamped, threads) in enumerate((("production", False, kernel.threads),
                                                       ("stamps", True, kernel.threads),
                                                       ("1024_threads", False, 1024))):
        held = st.launch_library(kernel.reach, stamped, threads)
        if held.mgmc_subtree_attributes(which, ctypes.byref(regs), ctypes.byref(local)) == 0:
            out["kernel_attributes"][label] = {"registers": regs.value,
                                               "local_bytes": local.value}
    # other block sizes and placements, the default among them
    default_budget = kernel.smem_budget
    out["variants"] = []
    for threads, budget in variants:
        if budget == "one_block":  # every field the block's whole grant holds
            budget = st.field_budget(common.dynamic_smem_limit(device), kernel._tables.size)
        k = subtree_variant(sampler, budget, threads)
        out["variants"].append({
            "threads": threads, "shared_bytes": k.placement["shared_bytes"],
            "dynamic_shared_bytes": k.smem_bytes,
            "blocks_per_sm_occupancy_api": st.launch_library(
                k.reach, False, threads).mgmc_subtree_blocks_per_sm(threads, k.smem_bytes),
            "default": threads == kernel.threads and k.smem_budget == default_budget,
            "device_ms": device_ms_median(lambda: k.sample(noise, f), "mgmc_subtree_kernel",
                                              launches=10)})
    return out


def check_probe(device):
    """The shared-memory probe: granted 232,448 bytes (the H100's opt-in
    maximum), refused more, and its copy equals its input."""
    from multigridmc_tpu_torch.ops.kernels import common

    x = torch.randn(common.PROBE_SHAPE, device=device)
    limit = common.dynamic_smem_limit(device)
    got = common.smem_copy(x, limit)
    err = float((got - common.smem_copy_plain(x)).abs().max())
    granted = common.probe_dynamic_smem(232448, device)
    refused_more = not common.probe_dynamic_smem(232448 + 1024, device)
    small = common.probe_dynamic_smem(4096, device)
    torch.cuda.synchronize()
    out = {"limit_bytes": limit, "grants_232448": granted, "refuses_233472": refused_more,
           "grants_4096": small, "max_abs_err": err}
    if err != 0.0 or not granted or not refused_more or not small or limit != 232448:
        raise AssertionError(f"shared-memory probe: {out}")
    nbytes = 2 * 4 * x.numel()
    out.update({"bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "bound_bytes": nbytes,
                "ms": cuda_ms(lambda: common.smem_copy(x, limit), 5, 50),
                "device_ms": device_ms_median(lambda: common.smem_copy(x, limit),
                                                  "smem_probe_kernel"),
                "plain_ms": cuda_ms(lambda: common.smem_copy_plain(x), 5, 50),
                # the one PyTorch call that computes the same function; its
                # event time, like the probe's, holds a whole Python call (the
                # probe's also the attribute call for the shared memory), so
                # the device times are the pair to compare
                "library_ms": cuda_ms(lambda: x.clone(), 5, 50)})
    for name in ("Memcpy DtoD", "copy"):
        out["library_device_ms"] = device_ms_median(lambda: x.clone(), name)
        if out["library_device_ms"] is not None:
            out["library_device_kernel"] = name
            break
    return out


V1_NAMES = ("fused_sor_sweep", "fused_sor_sweep_batched", "fused_gibbs_sweep_batched",
            "fused_gibbs_sweep")
V1_LINES = {"fused_sor_sweep": 230, "fused_sor_sweep_batched": 268,
            "fused_gibbs_sweep_batched": 315, "fused_gibbs_sweep": 401}


def v1_problem(device, nx):
    """Raw arrays of the flagship's prior (5-point, 255^2) as the v1 entry
    points take them."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
    from multigridmc_tpu_torch.ops.coloring import coloring_for

    op = shiftedlaplace_fd(Lattice((nx, nx)), ConstantCorrelationLengthModel(0.2), device=device)
    coloring = coloring_for(op.offsets, op.vshape)
    kw = dict(offsets=op.offsets, diag_index=op.diag_index, omega=1.3,
              color_weights=coloring.weights, n_colors=coloring.n_colors)
    return op, coloring, kw


def check_v1_sweeps(device, nx, C, gen, noise):
    """The four raw-array entry points against their plain versions (both
    directions; noise off and a shared ``xi``), the seeded Gibbs entry against
    the plan-based wrapper on the same Philox stream, and their times."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import SORSmoother

    op, coloring, kw = v1_problem(device, nx)
    coeffs = op.coeffs.contiguous()
    n, K = int(np.prod(op.vshape)), len(op.offsets)
    errs = dict.fromkeys(V1_NAMES, 0.0)
    x = torch.randn((C,) + op.vshape, device=device, generator=gen)
    b = torch.randn((C,) + op.vshape, device=device, generator=gen)
    xi = torch.randn((C,) + op.vshape, device=device, generator=gen)
    for order in (tuple(range(coloring.n_colors)), tuple(reversed(range(coloring.n_colors)))):
        k = dict(order=order, **kw)
        errs["fused_sor_sweep_batched"] = max(errs["fused_sor_sweep_batched"], compare(
            "v1 batched sweep", ss.fused_sor_sweep_batched(coeffs, b, x, **k),
            ss.fused_sor_sweep_batched_plain(coeffs, b, x, **k)))
        errs["fused_sor_sweep"] = max(errs["fused_sor_sweep"], compare(
            "v1 single sweep", ss.fused_sor_sweep(coeffs, b[0], x[0], **k),
            ss.fused_sor_sweep_plain(coeffs, b[0], x[0], **k)))
        errs["fused_gibbs_sweep_batched"] = max(errs["fused_gibbs_sweep_batched"], compare(
            "v1 batched Gibbs sweep",
            ss.fused_gibbs_sweep_batched(None, coeffs, b, x, xi=xi, **k),
            ss.fused_gibbs_sweep_batched_plain(xi, coeffs, b, x, **k)))
        errs["fused_gibbs_sweep"] = max(errs["fused_gibbs_sweep"], compare(
            "v1 single Gibbs sweep",
            ss.fused_gibbs_sweep(None, coeffs, b[1], x[1], xi=xi[1], **k),
            ss.fused_gibbs_sweep_plain(xi[1], coeffs, b[1], x[1], **k)))
    # a seed is the Philox stream (seed, 0): the plan-based wrapper on the same stream
    k = dict(order=tuple(range(coloring.n_colors)), **kw)
    plan = SORSmoother(op, 1.3, 1).plan
    seeded = ss.fused_gibbs_sweep_batched(77, coeffs, b, x, **k)
    compare("v1 seeded Gibbs sweep against gibbs_sweep_batched",
            seeded, ss.gibbs_sweep_batched(plan, b, x.clone(), philox=(77, 0)))
    if not torch.equal(seeded, ss.fused_gibbs_sweep_batched(77, coeffs, b, x, **k)):
        raise AssertionError("v1 Gibbs sweep: equal seeds gave different output")
    drawn = seeded - ss.fused_sor_sweep_batched(coeffs, b, x, **k)  # the sweep of the noise alone
    if torch.equal(drawn[0], drawn[1]):
        raise AssertionError("v1 Gibbs sweep: two chains share a stream")
    torch.cuda.synchronize()

    # times: the batched entries at C chains, the single ones on one field; all
    # coefficient planes are read from the tensor here
    timings = {}
    for name in V1_NAMES:
        single = name in ("fused_sor_sweep", "fused_gibbs_sweep")
        chains = 1 if single else C
        bb, xx = (b[0], x[0]) if single else (b, x)
        words = chains * n * 3 + K * n + (0 if "sor" in name else n)
        flops = chains * n * (2 * K + 4 + (0 if "sor" in name else 42))
        t_bytes, t_ops = 4 * words / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
        noise_mode = 1 if "gibbs" in name else 0
        route = ss.split_route(chains, op.vshape, op.offsets, noise_mode, x.device)
        kernel_name = sweep_kernel(route, ss.sweep_body(op.vshape, op.offsets),
                                   "gibbs" if noise_mode else "sweep")
        if "gibbs" in name:
            def call():
                return getattr(ss, name)(noise.philox_stream()[1] + 1, coeffs, bb, xx, **k)

            def plain():
                return getattr(ss, name + "_plain")(torch.randn_like(xx), coeffs, bb, xx, **k)
        else:
            def call():
                return getattr(ss, name)(coeffs, bb, xx, **k)

            def plain():
                return getattr(ss, name + "_plain")(coeffs, bb, xx, **k)
        timings[name] = {
            "chains": chains, "vshape": list(op.vshape), "route": list(route),
            "ms": cuda_ms(call, 5, 10 if chains > 1 else 50),
            "device_ms": device_ms_median(call, kernel_name),
            # not a launch but a whole Python call, which also launches the
            # kernels of the masks and the noise-scale plane: its event time
            # is not held against the device time (check_events_against_device)
            "other_kernels_per_call": device_window(call, kernel_name, 10)["other_kernels"],
            "plain_ms": cuda_ms(plain, 3, 3),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": 4 * words}
    return errs, timings


def drive_v1_path(device, nx, C):
    """The path of the four raw-array entry points: a few SSOR Gibbs steps of
    ``C`` chains and of one chain on the flagship's prior, then SOR iterations
    on ``A x = b`` for ``C`` right-hand sides and for one, whose residual must
    fall.  Returns the launch counts of that run."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    op, coloring, kw = v1_problem(device, nx)
    coeffs = op.coeffs.contiguous()
    fwd = tuple(range(coloring.n_colors))
    bwd = tuple(reversed(fwd))
    f = torch.zeros((C,) + op.vshape, device=device)
    ss.reset_launch_counts()
    x, x1 = torch.zeros_like(f), torch.zeros_like(f[0])
    for step in range(10):
        for order in (fwd, bwd):
            x = ss.fused_gibbs_sweep_batched(1000 + 2 * step + (order == bwd), coeffs, f, x,
                                             order=order, **kw)
            x1 = ss.fused_gibbs_sweep(np.array([5, 6, step, order == bwd], dtype=np.uint32),
                                      coeffs, f[0], x1, order=order, **kw)
    b = torch.randn((C,) + op.vshape, device=device)
    y, y1 = torch.zeros_like(b), torch.zeros_like(b[0])
    r0 = float((b - op.apply_stencil(y)).norm())
    for _ in range(10):
        for order in (fwd, bwd):
            y = ss.fused_sor_sweep_batched(coeffs, b, y, order=order, **kw)
            y1 = ss.fused_sor_sweep(coeffs, b[0], y1, order=order, **kw)
    torch.cuda.synchronize()
    r = float((b - op.apply_stencil(y)).norm())
    counts = {name: ss.launch_counts[name] for name in V1_NAMES}
    ok = (bool(torch.isfinite(x).all()) and bool(torch.isfinite(x1).all()) and r < 0.5 * r0
          and float((y[0] - y1).abs().max()) < 1e-4 and float(x.std()) > 0
          and all(c == 20 for c in counts.values()))
    out = {"gibbs_sample_std": float(x.std()), "residual_start": r0, "residual_after_10_ssor": r,
           "single_vs_batched_max_abs": float((y[0] - y1).abs().max()), "launches": counts}
    if not ok:
        raise AssertionError(f"v1 path: {out}")
    return counts, out


def phase_new_kernels(device, nx, nlevel, C, n_meas, gen, noise):
    """The kernels of the third slice: checks, times, and the v1 path."""
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    subtree_err, subtree_checks = check_subtree(
        device, C, gen, flagship_subtree_cases(device, nx, nlevel, n_meas))
    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    subtree_timing = time_subtree(MultigridMCSampler(op, nlevel, cycle=2, subtree=True), C, noise)
    del op
    probe = check_probe(device)
    v1_errs, v1_timings = check_v1_sweeps(device, nx, C, gen, noise)
    v1_counts, v1_path = drive_v1_path(device, nx, C)
    emit({"phase": "kernels_third_slice", "subtree_tolerance": SUBTREE_TOL,
          "subtree_checks": subtree_checks, "subtree_timing": subtree_timing, "probe": probe,
          "v1_max_abs_err": v1_errs, "v1_timings": v1_timings, "v1_path": v1_path})
    return {"subtree_err": subtree_err, "subtree_timing": subtree_timing, "probe": probe,
            "v1_errs": v1_errs, "v1_timings": v1_timings, "v1_counts": v1_counts}


#: chain counts at which the split kernels are checked against the plain
#: versions and the phase kernels: one chain (the drivers' time series) and 16
#: (where the rule takes smaller clusters at 255^2; above ``SPLIT_MAX_CHAINS``
#: the rule's size uncapped)
SPLIT_CHECK_VISIT_CHAINS = (1, 16)
#: chains of the main-path variant that takes the phase kernels (above
#: ``SPLIT_MAX_CHAINS``; the 256-chain variants take them too, as the route
#: takes the stream kernels nowhere)
PHASE_CHAINS = 128


def timed_visits(level, C, f_batched, noise, routes):
    """:func:`time_level` of ``routes`` with the plain versions, and the bound
    of both visits, at ``C`` chains on one level."""
    t = time_level(level, C, f_batched, noise, routes=routes)
    for kind in ("descend", "ascend"):
        bound, by, nbytes = visit_bound(level, C, f_batched, kind)
        t[f"{kind}_bound_ms"], t[f"{kind}_bound_by"], t[f"{kind}_bytes"] = bound, by, nbytes
    return {"vshape": list(level.op.vshape), "chains": C, "threads": level.phase_threads(C),
            "stream_threads": level.stream_threads,
            "split_cluster": level.split_cluster(C), **t}


#: chain counts of the phase kernels' breakdown by pass: the two main-path
#: counts (1024 and 512 threads) and one chain
PASS_CHAINS = (PHASE_CHAINS, 256, 1)


def time_phase_passes(levels, noise):
    """The phase kernels' launches by pass, from their stamps build (the
    in-kernel noise of the main path), on the flagship's levels 0 and 1 at the
    counts of :data:`PASS_CHAINS`, beside the profiler's device ms of the
    production build: per pass the median over the blocks, their sum, the
    span from the first entry to the last exit, the barriers each block
    passed (held against ``mgmc_visit.phase_barrier_count``, the count from
    the source) and the blocks one SM ran at once (against the occupancy
    calculator); the last of three launches."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    lib = mv.load_library()
    rows = []
    for li in (0, 1):
        level = levels[li]
        dev = level.coeffs.device
        for C in PASS_CHAINS:
            f = torch.rand((C,) + level.op.vshape if li else level.op.vshape, device=dev)
            x = torch.zeros((C,) + level.op.vshape, device=dev)
            xc = torch.randn((C,) + level.vc, device=dev)
            threads = level.phase_threads(C)
            row = {"level": li, "vshape": list(level.op.vshape), "chains": C, "threads": threads,
                   "stencil_form": level.stencil_form}
            fns = visit_fns(level, "phase", noise, f, x, xc)
            for kind, fn, name in zip(("descend", "ascend"), fns, VISIT_KERNELS["phase"]):
                device_ms = device_ms_median(fn, PROFILER_NAMES[name])
                stamps = torch.zeros((C, mv.PHASE_STAMP_WIDTH), dtype=torch.int64, device=dev)
                for _ in range(3):
                    xi, xi_lr, philox = level._draw(noise, x, kind)
                    if kind == "descend":
                        mv.launch_descend(level, "phase", f, x, xi, xi_lr, philox, stamps=stamps)
                    else:
                        mv.launch_ascend(level, "phase", f, x, xc, xi, xi_lr, philox,
                                         stamps=stamps)
                torch.cuda.synchronize()
                pt = mv.pass_times(level, kind, stamps)
                pt["device_ms"] = device_ms
                pt["sum_over_device_ms"] = pt["sum_us"] / 1e3 / device_ms
                pt["span_over_device_ms"] = pt["launch_span_us"] / 1e3 / device_ms
                pt["barriers_from_source"] = mv.phase_barrier_count(level, kind)
                smem = level.phase_launch(level.orders(kind), threads)[2]
                pt["tables_in_shared_memory"] = smem > 0
                pt["blocks_per_sm_occupancy_api"] = lib.mgmc_visit_blocks_per_sm(
                    int(kind == "descend"), level.stencil_form, len(level.orders(kind)), threads,
                    smem)
                if pt["barriers_per_block"] != [pt["barriers_from_source"]]:
                    raise AssertionError(f"phase L{li} C={C} {kind}: the blocks passed "
                                         f"{pt['barriers_per_block']} barriers, the source places "
                                         f"{pt['barriers_from_source']}")
                if not 1 <= pt["blocks_per_sm"] <= pt["blocks_per_sm_occupancy_api"]:
                    raise AssertionError(f"phase L{li} C={C} {kind}: {pt['blocks_per_sm']} blocks "
                                         "on one SM at once, the occupancy calculator allows "
                                         f"{pt['blocks_per_sm_occupancy_api']}")
                if not 0.9 <= pt["span_over_device_ms"] <= 1.1:
                    raise AssertionError(f"phase L{li} C={C} {kind}: the stamps span "
                                         f"{pt['span_over_device_ms']} of the device time")
                row[kind] = pt
            rows.append(row)
    return rows


def phase_kernel_attributes():
    """Registers and local (spill) bytes per thread and static shared bytes of
    the production phase kernels of every stencil form, as the card's loader
    reports them."""
    import ctypes

    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    lib = mv.load_library()
    out = {}
    for form in range(mv.STENCIL_FORMS):
        for (kind, descend), ndir in itertools.product((("descend", 1), ("ascend", 0)), (1, 2)):
            vals = (ctypes.c_int * 3)()
            err = lib.mgmc_visit_kernel_attributes(descend, form, ndir, vals)
            if err:
                raise AssertionError(f"phase {kind} kernel attributes: CUDA error {err}")
            out[f"{kind}{' ssor' if ndir == 2 else ''} form {form}"] = {
                "registers": vals[0], "local_bytes": vals[1], "static_shared_bytes": vals[2]}
    return out


def check_phase_level(level, name, C, f_batched, gen):
    """The phase kernels against their plain versions on one level at ``C``
    chains: noise off and the same noise tensors (:func:`check_level`), then
    the in-kernel generator against the plain versions fed its normals as the
    host's reference recomputes them (``philox_normals_reference``)."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    errs, _ = check_level(level, 0, C, f_batched, gen, routes=("phase",))
    dev = level.coeffs.device
    vshape, m = level.op.vshape, level.op.m_lowrank
    f = torch.randn((C,) + vshape if f_batched else vshape, device=dev, generator=gen)
    x = torch.randn((C,) + vshape, device=dev, generator=gen)
    xc = torch.randn((C,) + level.vc, device=dev, generator=gen)
    xi_lr = torch.randn((C, m), device=dev, generator=gen) if m else None
    seed = 0x5EED_0009

    def reference(counter):
        return torch.as_tensor(mv.philox_normals_reference(seed, counter, C, vshape), device=dev)

    got_x, got_fc = mv.launch_descend(level, "phase", f, x.clone(), xi_lr=xi_lr,
                                      philox=(seed, 11))
    want_x, want_fc = mv.descend_visit_plain(level, f, x, reference(11), xi_lr)
    tag = f"{name} C={C} in-kernel noise"
    errs["descend_visit_philox"] = max(compare(f"descend_visit x {tag}", got_x, want_x),
                                       compare(f"descend_visit f_c {tag}", got_fc, want_fc))
    got = mv.launch_ascend(level, "phase", f, x.clone(), xc, xi_lr=xi_lr, philox=(seed, 12))
    want = mv.ascend_visit_plain(level, f, x, xc, reference(12), xi_lr)
    errs["ascend_visit_philox"] = compare(f"ascend_visit x {tag}", got, want)
    torch.cuda.synchronize()
    T = {kind: level.phase_launch(level.orders(kind), level.phase_threads(C))[1]
         for kind in ("descend", "ascend")}
    return {"level": name, "vshape": list(vshape), "chains": C, "m": m,
            "threads": level.phase_threads(C),
            "table_bytes": {k: 4 * t.words for k, t in T.items()},
            "tables_in_shared_memory": {k: bool(t.shared) for k, t in T.items()}, **errs}


def dense_b_level(nx, m, device):
    """Level 0 of a posterior on an ``nx x nx`` lattice whose ``m`` measurement
    columns are dense (each column nonzero at every point, seed 9): its tables
    (``B`` and ``Y`` whole fields) do not fit a block's shared memory."""
    import dataclasses

    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
    from multigridmc_tpu_torch.ops.stencil import LowRank
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    prior = shiftedlaplace_fd(Lattice((nx, nx)), ConstantCorrelationLengthModel(0.2),
                              device=device)
    rng = np.random.default_rng(9)
    B = torch.as_tensor(1e-3 * rng.normal(size=(m,) + prior.vshape), dtype=torch.float32,
                        device=device)
    op = dataclasses.replace(prior, lowrank=LowRank(B=B, Sigma_diag=torch.ones(m, device=device)))
    sampler = MultigridMCSampler(op, 3, cycle=2, fused=True, fused_min_vertices=0, distill=False)
    return sampler.fused_levels[0]


def phase_checks(levels, wide_level, device, gen):
    """The phase kernels against their plain versions at :data:`PHASE_CHAINS`
    chains (:func:`check_phase_level`) on the flagship's levels 0 and 1, on the
    511^2 4-colour level of a 1024x1024 lattice (which no other route fits) and
    on a 255^2 level with 8 dense measurement columns (whose tables are read
    from device memory)."""
    dense = dense_b_level(256, 8, device)
    cases = (("L0", levels[0], False), ("L1", levels[1], True),
             ("1024 L1 (511^2, 4 colours)", wide_level, True), ("dense B 255^2", dense, True))
    rows = [check_phase_level(level, name, PHASE_CHAINS, f_batched, gen)
            for name, level, f_batched in cases]
    if rows[-1]["tables_in_shared_memory"]["descend"] or not rows[0]["tables_in_shared_memory"][
            "descend"]:
        raise AssertionError(f"phase tables: the dense-B level's tables must lie in device "
                             f"memory, the flagship's in shared memory: {rows}")
    return rows


def phase_passes(device, nx, nlevel, n_meas, smi):
    """Not part of the default run: the phase kernels' checks
    (:func:`phase_checks`), their registers and their breakdown by pass
    (:func:`time_phase_passes`) alone."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "order_one", device)
    checked = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                                 distill=False)
    op, _ = build_posterior(4 * nx, n_meas, FLAGSHIP_SEED, "order_one", device)
    wide = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                              distill=False)
    checks = phase_checks(checked.fused_levels, wide.fused_levels[1], device, gen)
    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    sampler = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                                 distill=False)
    emit({"phase": "passes", "card": smi, "checks": checks,
          "kernel_attributes": phase_kernel_attributes(),
          "rows": time_phase_passes(sampler.fused_levels, GeneratorNoise(5, device))})


def phase_visits(device, nx, nlevel, C, n_meas, gen, smi):
    """The level-visit kernels of the three routes: against the plain versions
    and against each other on every fused flagship level (the phase and the
    stream kernels at ``C`` chains, the phase and the split kernels at the
    counts of :data:`SPLIT_CHECK_VISIT_CHAINS`, and on the levels of a 24x24
    lattice, whose bands begin on even and odd rows), the stream and the split
    kernels' shared-memory layouts, the generator's known answer (through every
    route) and moments, their times beside the bound (``C`` chains; one chain
    for the split kernels; :data:`PHASE_CHAINS` for the phase kernels' main
    path), and the route table."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    # elementwise checks with O(1) measurement variances: with near-exact ones
    # both sides share a float32 cancellation that such a check cannot separate
    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "order_one", device)
    sampler = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                                 distill=False)
    op, _ = build_posterior(24, 3, FLAGSHIP_SEED, "order_one", device)
    small = MultigridMCSampler(op, 3, cycle=2, fused=True, fused_min_vertices=0, distill=False)
    errs = {name: 0.0 for names in VISIT_KERNELS.values() for name in names}
    route_err = {"stream": 0.0, "split": 0.0}
    by_level = []
    # the main path gives level 0 a shared f and the coarser levels one per chain
    cases = [(f"L{li}", level, chains, f_batched, routes, None)
             for li, level in sorted(sampler.fused_levels.items())
             for f_batched in ((False, True) if li == 0 else (True,))
             for chains, routes in ([(C, ("phase", "stream"))]
                                    + [(c, ("phase", "split")) for c in SPLIT_CHECK_VISIT_CHAINS])]
    # 23^2 and 11^2: bands of one to three rows, at the rule's size and at 4 blocks
    cases += [(f"24x24 L{li}", level, 2, True, ("phase", "split"), cluster)
              for li, level in sorted(small.fused_levels.items()) for cluster in (None, 4)]
    for name, level, chains, f_batched, routes, cluster in cases:
        li = int(name[-1])
        if "split" in routes and cluster is None:
            cluster = mv.split_cluster(chains, level.op.vshape, capped=False)
        e, route_errs = check_level(level, li, chains, f_batched, gen, routes, cluster)
        by_level.append({"level": name, "vshape": list(level.op.vshape), "chains": chains,
                         "f_batched": f_batched, "cluster": cluster, **e,
                         "against_phase_one_philox_stream": route_errs})
        for k in e:
            errs[k] = max(errs[k], e[k])
        for route, d in route_errs.items():
            route_err[route] = max(route_err[route], *d.values())
    layout = check_stream_layout(sampler.fused_levels, C)
    split_layout = check_split_visit_layout(sampler.fused_levels)
    philox = check_philox(device, nx, C)
    # the phase kernels at the main path's count: the flagship's levels, the
    # 511^2 4-colour level of a 1024x1024 lattice, a dense-B level
    op, _ = build_posterior(4 * nx, n_meas, FLAGSHIP_SEED, "order_one", device)
    wide = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                              distill=False)
    phase = phase_checks(sampler.fused_levels, wide.fused_levels[1], device, gen)
    for row in phase:
        for kind in ("descend", "ascend"):
            name = f"{kind}_visit"
            errs[name] = max(errs[name], row[name], row[f"{name}_philox"])
    del wide

    # times at the production operator (near-exact measurements), all fused levels
    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    sampler = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                                 distill=False)
    noise = GeneratorNoise(5, device)
    timings = [{"level": li, **timed_visits(level, C, li > 0, noise, ("phase", "stream"))}
               for li, level in sorted(sampler.fused_levels.items())]
    one_chain = [{"level": li, **timed_visits(sampler.fused_levels[li], 1, li > 0, noise,
                                              ("phase", "split"))} for li in (0, 1)]
    phase_chains = [{"level": li, **timed_visits(sampler.fused_levels[li], PHASE_CHAINS, li > 0,
                                                 noise, ("phase",))} for li in (0, 1)]
    passes = time_phase_passes(sampler.fused_levels, noise)
    emit({"phase": "visits", "tolerance": TOL, "max_abs_err": errs,
          "stream_against_phase_max_abs_err": route_err["stream"],
          "split_against_phase_max_abs_err": route_err["split"], "checks": by_level,
          "phase_checks": phase, "phase_kernel_attributes": phase_kernel_attributes(),
          "stream_layout": layout, "split_layout": split_layout, "philox": philox,
          "timings": timings, "one_chain_timings": one_chain,
          "phase_chains_timing": phase_chains, "phase_passes": passes})
    op, _ = build_posterior(2 * nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    wide = MultigridMCSampler(op, 4, cycle=2, fused=True, fused_min_vertices=0, distill=False)
    time_routes(sampler.fused_levels, wide.fused_levels, noise, smi)
    return errs, {"at_C": timings, "one_chain": one_chain, "phase_chains": phase_chains,
                  "phase_passes": passes}, noise


def phase_sweeps(device, gen, noise, smi, nx, nlevel, n_meas):
    """The sweep kernels of both routes: against their plain versions and
    against each other (the one-block route's bodies, the two routes),
    the generator through both and against torch's own, the split layout's
    host mirror, their times, the one-block kernels' launches by pass before
    (the generic body) and after (the passes body) with their registers, the
    passes body's block-size table, and the route table."""
    errs, body_err, sweep_checks = check_sweeps(device, gen, nx, nlevel, n_meas)
    split_errs, route_err, split_checks = check_split_sweeps(device, gen)
    errs.update(split_errs)
    sweep_philox = check_sweep_philox(device)
    collision = check_philox_collision(device)
    layout = check_split_layout(device)
    sweep_timings = time_sweeps(device, noise)
    stamps = time_sweep_passes(device, noise, ("generic", "passes"), nx, nlevel, n_meas)
    thread_rows, thread_faults = time_sweep_threads(device, noise, nx, nlevel, n_meas)
    emit({"phase": "sweeps", "tolerance": TOL, "route_tolerance": ROUTE_TOL,
          "max_abs_err": errs, "split_against_block_max_abs_err": route_err,
          "passes_against_generic_max_abs_err": body_err,
          "sweep_checks": sweep_checks, "split_checks": split_checks,
          "sweep_philox": sweep_philox, "philox_collision": collision, "split_layout": layout,
          "sweep_timings": sweep_timings, "passes_kernel_attributes": sweep_kernel_attributes(),
          "stamps": stamps, "passes_threads": thread_rows, "card": smi})
    if thread_faults:
        raise AssertionError("sweeps: the block-size rule's size is more than "
                             f"{SPLIT_SIZE_SLACK} times the best's: " + "; ".join(thread_faults))
    time_sweep_routes(device, noise, smi)
    return errs, sweep_timings


def phase_kernels(device, nx, nlevel, C, n_meas, smi):
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    errs, timings, noise = phase_visits(device, nx, nlevel, C, n_meas, gen, smi)
    sweep_errs, sweep_timings = phase_sweeps(device, gen, noise, smi, nx, nlevel, n_meas)
    errs.update(sweep_errs)
    emit({"phase": "kernels", "tolerance": TOL, "max_abs_err": errs})
    third = phase_new_kernels(device, nx, nlevel, C, n_meas, gen, noise)
    return errs, timings, sweep_timings, third


#: chain counts of the phase kernels' block-size table
THREAD_CHAINS = (64, 128, 132, 200, 256)


def phase_threads(device, nx, nlevel, C, n_meas, smi):
    """Not part of the default run: device ms per descend plus ascend of the
    phase kernels on the flagship's levels 0 and 1 at the counts of
    :data:`THREAD_CHAINS` for 256, 512 and 1024 threads (the block-size rule,
    ``mgmc_visit.phase_threads``, marked), and of the stream kernels on every
    fused level at ``C`` chains for 64, 128 and 256 threads (the default from
    ``mgmc_visit.stream_threads``)."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    sampler = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                                 distill=False)
    noise = GeneratorNoise(5, device)
    rows, stream_rows = [], []
    for li in (0, 1):
        level = sampler.fused_levels[li]
        for chains in THREAD_CHAINS:
            f = torch.rand((chains,) + level.op.vshape if li else level.op.vshape, device=device)
            x = torch.zeros((chains,) + level.op.vshape, device=device)
            xc = torch.randn((chains,) + level.vc, device=device)
            by_threads = {}
            for threads in (256, 512, 1024):
                fns = visit_fns(level, "phase", noise, f, x, xc, threads=threads)
                by_threads[threads] = [device_ms_median(fn, PROFILER_NAMES[name])
                                       for name, fn in zip(VISIT_KERNELS["phase"], fns)]
            pair = {t: sum(v) for t, v in by_threads.items() if None not in v}
            rule = level.phase_threads(chains)
            rows.append({"level": li, "vshape": list(level.op.vshape), "chains": chains,
                         "rule_threads": rule, "best_threads": min(pair, key=pair.get),
                         "pair_device_ms": {str(t): v for t, v in pair.items()},
                         "device_ms": {str(t): v for t, v in by_threads.items()}})
    for li, level in sorted(sampler.fused_levels.items()):
        default = level.stream_threads
        for threads in (64, 128, 256):
            level.stream_threads = threads
            t = time_level(level, C, li > 0, noise, plain=False, routes=("stream",))
            stream_rows.append({"level": li, "threads": threads, "default": threads == default,
                                **{k: v for k, v in t.items() if k.endswith("ms")}})
        level.stream_threads = default
    emit({"phase": "threads", "card": smi, "phase_kernels": rows,
          "stream_kernels": {"chains": C, "rows": stream_rows}})


def device_ms_of(fn, candidates, launches=20):
    """:func:`device_ms_median` of the first of the kernel names
    ``candidates`` that the profiler shows (a tree and its parent name their
    kernels differently); None where it shows none of them."""
    for kernel in candidates:
        t = device_ms_median(fn, kernel, launches)
        if t is not None:
            return t
    return None


def compare_sweeps(device, noise):
    """Device ms per launch of the one-block sweep kernels on the 256-chain
    cases of :func:`sweep_cases` (``b`` per chain, the Gibbs kernel with its
    in-kernel noise) and of the two batched raw-array entry points at 256
    chains on the flagship's prior, through calls that a tree and its parent
    both have."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import SORSmoother

    names = {"sweep": ("passes_sweep_kernel", "sor_sweep_kernel"),
             "gibbs": ("passes_gibbs_kernel", "gibbs_sweep_kernel")}
    rows = []
    for name, op, C, omega in sweep_cases(device):
        if C != 256:
            continue
        plan = SORSmoother(op, omega, 1).plan
        b = torch.rand((C,) + op.vshape, device=device)
        x = torch.zeros((C,) + op.vshape, device=device)
        row = {"case": name, "chains": C, "vshape": list(op.vshape)}
        row["sweep_device_ms"] = device_ms_of(
            lambda: ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x), names["sweep"])
        row["gibbs_device_ms"] = device_ms_of(
            lambda: ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x,
                                          philox=noise.philox_stream()), names["gibbs"])
        rows.append(row)
    op, coloring, kw = v1_problem(device, 256)
    coeffs = op.coeffs.contiguous()
    k = dict(order=tuple(range(coloring.n_colors)), **kw)
    b = torch.rand((256,) + op.vshape, device=device)
    x = torch.zeros((256,) + op.vshape, device=device)
    rows.append({"case": "v1 fused_sor_sweep_batched", "chains": 256,
                 "device_ms": device_ms_of(lambda: ss.fused_sor_sweep_batched(coeffs, b, x, **k),
                                           names["sweep"])})
    rows.append({"case": "v1 fused_gibbs_sweep_batched", "chains": 256,
                 "device_ms": device_ms_of(
                     lambda: ss.fused_gibbs_sweep_batched(noise.philox_stream()[1] + 1, coeffs, b,
                                                          x, **k), names["gibbs"])})
    return rows


def phase_compare(device, nx, nlevel, C, n_meas, steps, smi):
    """Not part of the default run: what both a tree and its parent can run,
    for timing the two in one call (copy this script into the parent's
    checkout and run it there too): the phase kernels' device ms per launch
    at :data:`PHASE_CHAINS` and ``C`` chains on the flagship's levels 0 and 1
    (through the launch call both trees have, in-kernel noise, each tree's own
    block size), beside the bound, the one-block sweeps (:func:`compare_sweeps`),
    then :func:`phase_main_path`."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    sampler = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                                 distill=False)
    noise = GeneratorNoise(5, device)
    rows = []
    for li in (0, 1):
        level = sampler.fused_levels[li]
        for chains in (PHASE_CHAINS, C):
            f = torch.rand((chains,) + level.op.vshape if li else level.op.vshape, device=device)
            x = torch.zeros((chains,) + level.op.vshape, device=device)
            xc = torch.randn((chains,) + level.vc, device=device)
            row = {"level": li, "vshape": list(level.op.vshape), "chains": chains}
            fns = visit_fns(level, "phase", noise, f, x, xc)
            for kind, name, fn in zip(("descend", "ascend"), VISIT_KERNELS["phase"], fns):
                row[f"{name}_device_ms"] = device_ms_median(fn, PROFILER_NAMES[name], 20)
                row[f"{kind}_bound_ms"] = visit_bound(level, chains, li > 0, kind)[0]
            rows.append(row)
    emit({"phase": "compare", "card": smi, "phase_kernels": rows,
          "sweeps": compare_sweeps(device, noise)})
    phase_main_path(device, nx, nlevel, C, n_meas, steps, smi)


# ------------------------------------------------------------ phase: main_path
class _FixedNoise:
    """A noise source that hands out one stored tensor (for comparing two
    precisions of one map on the same normals)."""

    def __init__(self, xi):
        self.xi = xi

    def normal(self, shape, dtype, device):
        return self.xi.reshape(shape)


def phase_main_path(device, nx, nlevel, C, n_meas, steps, smi):
    """The flagship at full width through four variants of the cycle below
    level 0: every level's visit fused, the subtree from level 2 distilled, the
    subtree below level 0 in one kernel launch, and level 0 fused only (at a
    smaller depth); and the distilled variant once more at
    :data:`PHASE_CHAINS` chains, the count whose visits take the phase
    kernels.  Each variant is built and driven with the launch counts set to 0
    just before (the subtree variant's construction launches the shared-memory
    probe) and read just after."""
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    f = torch.as_tensor(np.random.default_rng(0).uniform(size=op.vshape),
                        dtype=torch.float32, device=device)
    n0 = op.lattice.nvertex
    results, counts_by_variant = {}, {}
    variants = (
        ("all_levels_fused", dict(distill=False), steps, C),
        ("distilled", dict(distill=True), steps, C),
        ("distilled_tf32", dict(distill=True, distill_precision="default"), steps, C),
        ("subtree_kernel", dict(subtree=True), steps, C),
        ("level0_fused", dict(distill=False, fused_min_vertices=n0), max(steps // 3, 2), C),
        (f"distilled_{PHASE_CHAINS}_chains", dict(distill=True), steps, PHASE_CHAINS),
        ("alternating", dict(distill=True, sweep_schedule="alternating"), steps, C),
    )
    for name, kwargs, nsteps, C in variants:
        for module in (mv, ss, st, common):
            module.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler = MultigridMCSampler(op, nlevel, smoother="SOR", coarse_solver="Cholesky",
                                     omega=1.0, cycle=2, **kwargs)
        torch.cuda.synchronize()
        setup_seconds = time.perf_counter() - t0
        setup_counts = {**mv.launch_counts, **ss.launch_counts, **st.launch_counts,
                        **common.launch_counts}
        coarse_calls = [0]
        coarse_apply = sampler.coarse_sampler.apply

        def counted_coarse(*args, _apply=coarse_apply, _calls=coarse_calls):
            _calls[0] += 1
            return _apply(*args)

        sampler.coarse_sampler.apply = counted_coarse
        noise = GeneratorNoise(FLAGSHIP_SEED, device)
        x = torch.zeros((C,) + op.vshape, dtype=torch.float32, device=device)
        for k in range(2):  # warm-up: caches, allocator, lazily built buffers
            x = sampler.apply_indexed(noise, f, x, k)
        torch.cuda.synchronize()
        mv.reset_launch_counts()
        st.reset_launch_counts()
        coarse_calls[0] = 0
        t0 = time.perf_counter()
        for k in range(nsteps):  # the step index picks the alternating schedule's parity
            x = sampler.apply_indexed(noise, f, x, k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {**mv.launch_counts, **st.launch_counts,
                  "smem_probe": setup_counts["smem_probe"]}
        coarse_per_step = coarse_calls[0] / nsteps
        if tuple(x.shape) != (C,) + op.vshape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"main path ({name}): samples not finite or of wrong shape")
        # the W-cycle visits level l 2^l times per step, down to where the
        # distilled map or the subtree kernel takes over
        below = sampler.distill_level if sampler.distilled is not None else (
            1 if sampler.subtree is not None else nlevel)
        visited = [li for li in sorted(sampler.fused_levels) if li < below]
        expected = nsteps * sum(2 ** li for li in visited)
        expected_subtree = nsteps if sampler.subtree is not None else 0
        visits = {kind: sum(counts[mv.KERNEL_NAMES[(route, kind)]] for route in mv.ROUTES)
                  for kind in ("descend", "ascend")}
        # the route of each visited level at this chain count; a route that no
        # visited level takes must show no launch
        routes = {li: sampler.fused_levels[li].route(C) for li in visited}
        routes_1 = {li: sampler._engine(1)[2][li].route(C) for li in visited}
        unused = [kernel for route in mv.ROUTES
                  if route not in set(routes.values()) | set(routes_1.values())
                  for kernel in VISIT_KERNELS[route]]
        if (visits["descend"] != expected or visits["ascend"] != expected
                or counts["subtree_sample"] != expected_subtree
                or (sampler.subtree is not None and counts["smem_probe"] < 1)
                or any(counts[kernel] for kernel in unused)):
            raise AssertionError(f"main path ({name}): launches {counts}, expected {expected} "
                                 f"visits each through the routes {routes} "
                                 f"and {expected_subtree} subtree launches")
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()  # after the timed steps: the card's state for them
        # four steps by the step index, as timed: under the alternating
        # schedule two of each parity
        ks = iter(range(4))
        busy = device_busy(lambda: sampler.apply_indexed(noise, f, x, next(ks)), 4,
                           pattern=r"trsm|triang|visit_kernel|descend_kernel|ascend_kernel")
        if busy is not None:  # device ms per launch of each visit kernel (by level shape)
            busy["visit_device_ms"] = {
                r["name"]: r["ms_per_step"] / r["calls_per_step"] for r in busy["matching"]
                if re.search("visit_kernel|descend_kernel|ascend_kernel", r["name"])}
        res = {"chains": C, "fused_levels": sorted(sampler.fused_levels),
               "visited_levels": visited,
               "distill_level": sampler.distill_level, "subtree": sampler.subtree is not None,
               "setup_seconds": setup_seconds, "device_busy": busy, "steps": nsteps,
               "clocks_sm_power_temperature": clocks,
               "ms_per_step": 1e3 * dt / nsteps, "samples_per_s": C * nsteps / dt,
               "launches": counts, "setup_launches": setup_counts,
               "route_by_level": routes,
               "visit_launches_per_step": 2 * expected // nsteps,
               "coarse_sampler_calls_per_step": coarse_per_step,
               "sample_std": float(x.std())}
        if sampler.distilled is not None:
            d = sampler.distilled
            res["distilled"] = {**d.info, "vshape": list(d.vshape), "precision": d.precision,
                                "T_bytes": d.Tm.numel() * d.Tm.element_size(),
                                "S_bytes": d.S_T.numel() * d.S_T.element_size()}
        if sampler._alt is not None:  # the parity-1 engine: its routes and its own map
            res["route_by_level_parity_1"] = routes_1
            d1 = sampler._alt["distilled"]
            res["distilled_parity_1"] = {
                **d1.info, "T_bytes": d1.Tm.numel() * d1.Tm.element_size(),
                "S_bytes": d1.S_T.numel() * d1.S_T.element_size()}
        if sampler.subtree is not None:
            res["placement"] = sampler.subtree.placement
        if name == "distilled_tf32":
            # the map's perturbation by TF32 on the same f and the same normals
            fc = torch.randn((C,) + d.vshape, device=device)
            fixed = _FixedNoise(torch.randn((C, d.n), device=device))
            x_tf32 = d.apply(fixed, fc)
            d.precision = None
            x_fp32 = d.apply(fixed, fc)
            d.precision = "default"
            res["tf32_map_perturbation"] = {
                "max_abs": float((x_tf32 - x_fp32).abs().max()),
                "sample_max_abs": float(x_fp32.abs().max()), "sample_std": float(x_fp32.std())}
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("main path: the TF32 context leaked into the process")
        results[name] = res
        counts_by_variant[name] = counts
    emit({"phase": "main_path", "card": smi, "chains": variants[0][3], "lattice": [nx, nx],
          "nlevel": nlevel,
          "cycle": 2, "dtype": "float32", **results})
    return counts_by_variant, results


# -------------------------------------------------------------- phase: drivers
DRIVER_CONFIG = """
general = {{
    dim = 2;
    do_cholesky = {do_cholesky};
    do_ssor = {do_ssor};
    do_multigridmc = true;
    save_posterior_statistics = {do_ssor};
    measure_convergence = true;
    operator = "posterior";
    mean_shift = "auto";
}}
lattice = {{ nx = {nx}; ny = {nx}; nz = {nx}; }}
{cholesky}
smoother = {{ nsmooth = 1; omega = 1.0; }}
iterative_solver = {{ rtol = 1.0E-5; atol = 1.0E-2; maxiter = 100; verbose = 2; }}
multigrid = {{
    smoother = "{smoother}"; coarse_solver = "Cholesky";
    npresmooth = 1; npostsmooth = 1; ncoarsesmooth = 1;
    omega = 1.0; nlevel = {nlevel}; cycle = 2; coarse_scaling = 1.0; verbose = 0;{schedule}
}}
sampling = {{
    timeseries = {{ nsamples = {nsamples}; nwarmup = {nwarmup}; }}
    convergence = {{ nsteps = 16; nsamples = {nchains}; }}
}}
prior = {{ pdemodel = "shiftedlaplace_fd"; correlationlengthmodel = "constant"; }}
constantcorrelationlengthmodel = {{ Lambda = 0.2; }}
periodiccorrelationlengthmodel = {{ Lambda_min = 0.2; Lambda_max = 0.4; }}
measurements = {{
    radius = 0.0;
    sample_location = [0.5, 0.5];
    variance_scaling = 1.0;
    measure_global = false;
    mean_global = 1.0;
    variance_global = 0.01;
    filename = "measurements.cfg";
}}
"""


def write_driver_configs(directory, nx, nlevel, n_meas, nchains, nsamples, nwarmup):
    """``params_mgmc.cfg`` (SOR multigrid), ``params_mg.cfg`` (SSOR multigrid),
    ``params_band.cfg`` (the exact sampler with the factorisation unset, i.e.
    the band sampler, beside SOR multigrid on the alternating schedule) and
    ``measurements.cfg`` with the flagship's measurements."""
    rng = np.random.default_rng(FLAGSHIP_SEED)
    locations = rng.uniform(0.1, 0.9, size=(n_meas, 2))
    mean = rng.normal(2.0, 1.0, size=n_meas)
    variance = 1e-6 * (1.0 + rng.uniform(size=n_meas))

    def listing(values):
        return "[" + ", ".join(repr(float(v)) for v in np.asarray(values).reshape(-1)) + "]"

    with open(os.path.join(directory, "measurements.cfg"), "w") as out:
        out.write(f"dim = 2;\nn = {n_meas};\nmeasurement_locations = {listing(locations)};\n"
                  f"mean = {listing(mean)};\nvariance = {listing(variance)};\n")
    dense = 'cholesky = { factorisation = "dense"; }'
    for name, smoother, extra in (
            ("params_mgmc.cfg", "SOR", dict(cholesky=dense)),
            ("params_mg.cfg", "SSOR", dict(cholesky=dense)),
            ("params_band.cfg", "SOR", dict(do_cholesky="true", do_ssor="false", cholesky="",
                                            schedule=' sweep_schedule = "alternating";'))):
        fields = {"do_cholesky": "false", "do_ssor": "true", "schedule": "", **extra}
        with open(os.path.join(directory, name), "w") as out:
            out.write(DRIVER_CONFIG.format(nx=nx, nlevel=nlevel, smoother=smoother,
                                           nchains=nchains, nsamples=nsamples, nwarmup=nwarmup,
                                           **fields))


def read_vtk_scalars(path):
    """``{label: values}`` of a legacy ASCII ``STRUCTURED_POINTS`` file."""
    fields, label, npoints = {}, None, None
    with open(path) as lines:
        for line in lines:
            if line.startswith("POINT_DATA"):
                npoints = int(line.split()[1])
            elif line.startswith("SCALARS"):
                label = line.split()[1]
                fields[label] = []
            elif label is not None and not line.startswith("LOOKUP_TABLE") and line.strip():
                fields[label].append(float(line))
    for name, values in fields.items():
        if len(values) != npoints:
            raise AssertionError(f"{path}: field {name} has {len(values)} of {npoints} values")
    return {name: np.asarray(values) for name, values in fields.items()}


def integrated_autocorrelation_time(series, window=200):
    """``1 + 2 sum_k rho_k`` with the sum cut at the first non-positive
    autocorrelation (or at ``window``)."""
    d = np.asarray(series) - np.mean(series)
    var = float(np.mean(d * d))
    tau = 1.0
    for k in range(1, min(window, len(d) // 4)):
        rho = float(np.mean(d[:-k] * d[k:])) / var
        if rho <= 0:
            break
        tau += 2.0 * rho
    return tau


def richardson_table(text):
    """The rows ``[iteration, ||r||, ||r||/||r_0||, rho]`` of the solver's
    per-iteration table in a driver's output."""
    return [[float(v) for v in line.split()] for line in text.splitlines()
            if re.match(r"\s*\d+\s+\S+e[-+]\d+\s+\S+e[-+]\d+\s+\S+\s*$", line)]


def run_driver(main, argv):
    """Call a driver's ``main`` and return what it printed."""
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        main(argv)
    return captured.getvalue()


def time_one_chain_ssor(device, nx, n_meas, steps=200):
    """One step of the one-chain SSOR sampler on the flagship posterior (the
    drivers' SSOR time series: two Gibbs sweeps, each with the low-rank draw
    and the Woodbury correction around it): host ms per step, with a
    synchronisation only at the end, against the device's kernel ms and
    launches per step (torch.profiler) - what bounds the series."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.sor import SSORSampler

    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    sampler = SSORSampler(op, 1.0, 1)
    noise = GeneratorNoise(17, device)
    f = torch.zeros(op.vshape, device=device)
    x = torch.zeros((1,) + op.vshape, device=device)
    for _ in range(20):
        x = sampler.apply(noise, f, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        x = sampler.apply(noise, f, x)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    busy = device_busy(lambda: sampler.apply(noise, f, x), 20) or {}
    return {"host_ms_per_step": host_ms, "kernel_ms_per_step": busy.get("kernel_ms_per_step"),
            "kernels_per_step": busy.get("kernels_per_step"), "top": busy.get("top"),
            "route": list(sampler.forward.smoother.plan.route(1, 1))}


def time_one_chain_mgmc(device, nx, nlevel, n_meas, steps=200):
    """One step of the one-chain MGMC sampler on the flagship posterior as
    ``drivers.mgmc`` builds it (SOR W-cycle, the subtree from level 2 distilled,
    levels 0 and 1 fused): host ms per step, with a synchronisation only at the
    end, against the device's kernel ms and launches per step
    (torch.profiler), and the visit route of each fused level."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    sampler = MultigridMCSampler(op, nlevel, smoother="SOR", coarse_solver="Cholesky",
                                 omega=1.0, cycle=2)
    noise = GeneratorNoise(19, device)
    f = torch.zeros(op.vshape, device=device)
    x = torch.zeros(op.vshape, device=device)
    for _ in range(20):
        x = sampler.apply(noise, f, x)
    torch.cuda.synchronize()
    mv.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        x = sampler.apply(noise, f, x)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    visits = {k: v / steps for k, v in mv.launch_counts.items() if v}
    busy = device_busy(lambda: sampler.apply(noise, f, x), 20,
                       pattern=r"visit_kernel|descend_kernel|ascend_kernel") or {}
    return {"host_ms_per_step": host_ms, "kernel_ms_per_step": busy.get("kernel_ms_per_step"),
            "kernels_per_step": busy.get("kernels_per_step"), "top": busy.get("top"),
            "visit_kernels": busy.get("matching"), "visit_launches_per_step": visits,
            "distill_level": sampler.distill_level,
            "route_by_level": {li: level.route(1) for li, level in sampler.fused_levels.items()}}


def composed_mg_solve(device, b):
    """``params_mg.cfg``'s Richardson solve of ``b`` with every level composed
    (``MultigridPreconditioner(..., fused=False)``: the SSOR sweeps on the
    sweep kernels, the residual and transfers in plain PyTorch); its
    iterations, contraction rates and solve seconds, and the launches it made
    (the split sweep kernel's and no visit's)."""
    from multigridmc_tpu_torch.drivers import mg as driver_mg
    from multigridmc_tpu_torch.drivers.common import build_operators
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.solvers.loop import IterativeSolverParameters, LoopSolver
    from multigridmc_tpu_torch.solvers.multigrid import MultigridPreconditioner

    config = driver_mg.load_config("params_mg.cfg")
    _, op, _ = build_operators(config, torch.device(device), torch.float32)
    mg, it = config.multigrid, config.iterative_solver
    precond = MultigridPreconditioner(
        op, nlevel=mg.nlevel, smoother=mg.smoother, npresmooth=mg.npresmooth,
        npostsmooth=mg.npostsmooth, omega=mg.omega, cycle=mg.cycle,
        coarse_scaling=mg.coarse_scaling, fused=False)
    solver = LoopSolver(op, precond, IterativeSolverParameters(
        rtol=it.rtol, atol=it.atol, maxiter=it.maxiter, verbose=0))
    mv.reset_launch_counts()
    ss.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = solver.solve_jit(b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {**mv.launch_counts, **ss.launch_counts}
    if (not result.converged or counts["sweep_batched_split"] <= 0
            or any(mv.launch_counts.values())):
        raise AssertionError(f"drivers.mg (composed): converged {result.converged}, launches "
                             f"{counts}")
    return {"solve_seconds": seconds, "iterations": result.niter,
            "launches": {k: v for k, v in counts.items() if v}}, counts


def phase_drivers(device, nx, nlevel, n_meas, nchains, nsamples, nwarmup, smi):
    from multigridmc_tpu_torch.drivers import mg as driver_mg
    from multigridmc_tpu_torch.drivers import mgmc as driver_mgmc
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    out = {"phase": "drivers", "card": smi, "lattice": [nx, nx], "nlevel": nlevel,
           "measurements": n_meas, "timeseries": {"nsamples": nsamples, "nwarmup": nwarmup},
           "convergence": {"nsteps": 16, "nsamples": nchains}, "dtype": "float32"}
    n_vertices = (nx + 1) ** 2
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        write_driver_configs(work, nx, nlevel, n_meas, nchains, nsamples, nwarmup)
        os.chdir(work)
        try:
            # ---- drivers.mgmc: SSOR and MGMC, SOR multigrid (the fused visits)
            mv.reset_launch_counts()
            ss.reset_launch_counts()
            t0 = time.perf_counter()
            text = run_driver(driver_mgmc.main, ["params_mgmc.cfg"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts_mgmc = {**mv.launch_counts, **ss.launch_counts}
            report = [line for line in text.splitlines()
                      if re.search(r"time per sample|mean  |variance =|setup time|zero-mean"
                                   r"|distilled subtree", line)]
            print("\n".join(report), flush=True)
            res = {"seconds": seconds, "launches": counts_mgmc}
            for label in ("ssor", "multigridmc"):
                ms = re.search(rf"{label} time per sample =\s+(\S+) ms", text)
                mean = re.search(rf"{label} mean\s+=\s+(\S+) \+/-\s+(\S+)", text)
                var = re.search(rf"{label} variance =\s+(\S+)", text)
                series = np.loadtxt(f"timeseries_{label}.txt")
                if series.shape != (nsamples,) or not np.isfinite(series).all():
                    raise AssertionError(f"drivers: timeseries_{label}.txt is not {nsamples} "
                                         "finite values")
                table = [line for line in open(f"convergence_{label}.txt")
                         if re.match(r"\s+(mean|variance)\s+\d+ :", line)]
                numbers = [float(v) for line in table
                           for v in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", line)]
                if len(table) != 2 * 17 or not np.isfinite(numbers).all():
                    raise AssertionError(f"drivers: convergence_{label}.txt does not parse")
                res[label] = {"ms_per_sample": float(ms.group(1)), "mean": float(mean.group(1)),
                              "mean_error": float(mean.group(2)), "variance": float(var.group(1)),
                              "iact": integrated_autocorrelation_time(series)}
            exact_mean = float(re.search(r"exact mean\s+=\s+(\S+)", text).group(1))
            exact_var = float(re.search(r"exact variance =\s+(\S+)", text).group(1))
            res["exact"] = {"mean": exact_mean, "variance": exact_var}
            res["setup_seconds"] = float(re.search(r"setup time .* = (\S+) s", text).group(1))
            chosen = re.search(r"multigridmc distilled subtree: level (\d+) \((\d+) vertices\)", text)
            if chosen is None or int(chosen.group(1)) != 2:
                raise AssertionError("drivers.mgmc: distill='auto' did not choose level 2 "
                                     "on the card:\n" + text[-1500:])
            res["distill_level"] = int(chosen.group(1))
            res["distill_vertices"] = int(chosen.group(2))
            fields = read_vtk_scalars("posterior.vtk")
            for name in ("mean", "variance", "mean_exact"):
                if fields[name].shape != (n_vertices,) or not np.isfinite(fields[name]).all():
                    raise AssertionError(f"drivers: posterior.vtk field {name} is not finite")
            if not os.path.exists("sample_location.vtk"):
                raise AssertionError("drivers: sample_location.vtk is missing")
            # the one-chain time series takes the visit kernels of one chain's
            # route (the split kernels) and the split sweep route, the 256
            # replica chains of the convergence tables the routes of their
            # chain count
            one_chain = VISIT_KERNELS[mv.visit_route(1, vshape=(nx - 1, nx - 1))]
            replicas = VISIT_KERNELS[mv.visit_route(nchains)]
            if one_chain != VISIT_KERNELS["split"]:
                raise AssertionError(f"drivers.mgmc: one chain takes {one_chain}")
            for name in ("gibbs_sweep_batched", "gibbs_sweep_batched_split") + one_chain + replicas:
                if counts_mgmc[name] <= 0:
                    raise AssertionError(f"drivers.mgmc: {name} was not launched: {counts_mgmc}")
            # the MGMC time series against the exact mean: the driver's own
            # standard error ignores the autocorrelation, so the bar is widened
            # by the square root of the measured autocorrelation time
            mg_res = res["multigridmc"]
            bar = 5.0 * mg_res["mean_error"] * np.sqrt(max(mg_res["iact"], 1.0))
            mg_res["mean_bar"] = bar
            if abs(mg_res["mean"] - exact_mean) > bar:
                raise AssertionError(f"drivers.mgmc: MGMC mean {mg_res['mean']} is further than "
                                     f"{bar} from the exact mean {exact_mean}")
            out["mgmc"] = res

            # ---- drivers.mg: Richardson, SSOR multigrid (the fused two-sweep
            # visits: one right-hand side takes the route of one chain)
            mv.reset_launch_counts()
            ss.reset_launch_counts()
            t0 = time.perf_counter()
            text = run_driver(driver_mg.main, ["params_mg.cfg"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts_mg = {**mv.launch_counts, **ss.launch_counts}
            rows = richardson_table(text)
            print("\n".join(line for line in text.splitlines()
                            if re.search(r"setup time|solve time|converged|\|\|r\|\|", line)),
                  flush=True)
            if "Solver converged" not in text or not rows:
                raise AssertionError("drivers.mg: the Richardson iteration did not converge:\n"
                                     + text[-2000:])
            # contraction per cycle while float32 rounding does not yet set the
            # rate.  With near-exact measurements the W-cycle contracts at about
            # 0.69 per cycle on this posterior in float64 (on the prior at
            # 0.1-0.25), so the rates are held against the same iteration in
            # float64 through the plain sweeps, run here beside it, and against
            # a ceiling of 0.75.
            rates = [r[3] for r in rows[1:] if r[2] > 1e-4]
            from multigridmc_tpu_torch.utils.runtime import make_generator

            b = torch.randn((nx - 1, nx - 1), dtype=torch.float32, device=device,
                            generator=make_generator(1482817, device))  # the driver's rhs
            with contextlib.redirect_stdout(io.StringIO()) as text64:
                driver_mg.run(driver_mg.load_config("params_mg.cfg"), torch.device(device),
                              torch.float64, b=b)
            rates64 = [r[3] for r in richardson_table(text64.getvalue())[1:]][:len(rates)]
            if (not rates or max(rates) >= 0.75 or len(rates64) != len(rates)
                    or max(abs(a - b) for a, b in zip(rates, rates64)) > 0.02):
                raise AssertionError(f"drivers.mg: contraction rates {rates}, in float64 "
                                     f"through the plain sweeps {rates64}")
            solution = read_vtk_scalars("solution.vtk")["solution"]
            if solution.shape != (n_vertices,) or not np.isfinite(solution).all():
                raise AssertionError("drivers.mg: solution.vtk is not finite")
            # one right-hand side: every fused SSOR visit (levels 0 and 1, 255^2
            # 5-point and 127^2 3x3 box) takes the route of one chain, the split
            # kernels or the smem kernels where mgmc_visit_smem.SMEM_CHAINS
            # lists the level at one chain
            ssor_one = {mv.KERNEL_NAMES[(mv.visit_route(1, vshape=(h, h), form=form, ndir=2),
                                         kind)] + mv.SSOR_SUFFIX
                        for h, form in ((nx - 1, 0), (nx // 2 - 1, 2))
                        for kind in ("descend", "ascend")}
            if (min(counts_mg[n] for n in ssor_one) <= 0
                    or any(counts_mg[n] for n in mv.launch_counts if n not in ssor_one)):
                raise AssertionError(f"drivers.mg: the one-chain SSOR visits {sorted(ssor_one)} "
                                     f"were not the visits launched: {counts_mg}")
            out["mg"] = {
                "seconds": seconds, "launches": {k: v for k, v in counts_mg.items() if v},
                "iterations": len(rows) - 1,
                "relative_residual": rows[-1][2], "contraction_rates": rates,
                "contraction_rates_float64_plain": rates64,
                "setup_seconds": float(re.search(r"multigrid setup time = (\S+) s", text).group(1)),
                "solve_seconds": float(re.search(r"solve time = (\S+) s", text).group(1))}
            chosen = re.search(r"distilled deterministic subtree: level (\d+)", text)
            out["mg"]["distill_level"] = None if chosen is None else int(chosen.group(1))
            if out["mg"]["distill_level"] != 2:
                raise AssertionError("drivers.mg: distill='auto' did not choose level 2")
            # the same solve with the levels composed (fused=False), the "before"
            # of the fused SSOR visits: every sweep a launch of the split sweep
            # kernel (one right-hand side)
            out["mg_composed"], composed_counts = composed_mg_solve(device, b)
            for name, count in composed_counts.items():
                counts_mg[name] += count

            # ---- drivers.mgmc: the band sampler (factorisation unset) and MGMC
            # on the alternating schedule
            mv.reset_launch_counts()
            ss.reset_launch_counts()
            t0 = time.perf_counter()
            text = run_driver(driver_mgmc.main, ["params_band.cfg"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            print("\n".join(line for line in text.splitlines()
                            if re.search(r"time per sample|mean  |variance =|factorisation", line)),
                  flush=True)
            res = {"seconds": seconds, "launches": {**mv.launch_counts, **ss.launch_counts},
                   "factorisation_seconds": float(re.search(
                       r"time for Cholesky factorisation = (\S+) s", text).group(1))}
            exact_mean = float(re.search(r"exact mean\s+=\s+(\S+)", text).group(1))
            for label in ("cholesky", "multigridmc"):
                series = np.loadtxt(f"timeseries_{label}.txt")
                if series.shape != (nsamples,) or not np.isfinite(series).all():
                    raise AssertionError(f"drivers (band): timeseries_{label}.txt is not "
                                         f"{nsamples} finite values")
                ms = re.search(rf"{label} time per sample =\s+(\S+) ms", text)
                mean = re.search(rf"{label} mean\s+=\s+(\S+) \+/-\s+(\S+)", text)
                r = res[label] = {"ms_per_sample": float(ms.group(1)),
                                  "mean": float(mean.group(1)),
                                  "mean_error": float(mean.group(2)),
                                  "iact": integrated_autocorrelation_time(series)}
                r["mean_bar"] = 5.0 * r["mean_error"] * np.sqrt(max(r["iact"], 1.0))
                if abs(r["mean"] - exact_mean) > r["mean_bar"]:
                    raise AssertionError(f"drivers (band): {label} mean {r['mean']} is further "
                                         f"than {r['mean_bar']} from the exact mean {exact_mean}")
            if not all(res["launches"][n] > 0 for n in VISIT_KERNELS["split"]):
                raise AssertionError(f"drivers (band): the one-chain MGMC series launched "
                                     f"{res['launches']}")
            out["band_alternating"] = res
        finally:
            os.chdir(cwd)
    out["one_chain_ssor_step"] = time_one_chain_ssor(device, nx, n_meas)
    out["one_chain_mgmc_step"] = time_one_chain_mgmc(device, nx, nlevel, n_meas)
    out["other_entry_points"] = other_entry_points(device, nlevel, n_meas, nchains)
    emit(out)
    counts = {name: counts_mgmc[name] + counts_mg[name] for name in counts_mgmc}
    return counts, out


#: the spectrum driver's lattice: the flagship's configuration at 32^2 (961
#: unknowns, a dense covariance)
SPECTRUM_NX = 32
#: the checkpoint check: steps before the save and after the load
CHECKPOINT_STEPS = 5
#: the pivoted Cholesky check: the 64x64 flagship-like posterior's covariance
#: (3969 unknowns), at most this many pivots, stopped at this relative trace error
PIVOTED = {"nx": 64, "max_rank": 256, "tolerance": 1e-3}


def other_entry_points(device, nlevel, n_meas, C):
    """The port's other entry points on the card, each failing the run on
    error: ``drivers.spectrum`` on the flagship configuration at
    :data:`SPECTRUM_NX` (its ``spectrum.csv`` against the eigenvalues of the
    float64 host inverse of the same operator, to the file's 7 digits);
    ``drivers.generate_measurements`` (read back by the config parser, the
    points in the unit square and ``dmin`` apart); a checkpoint of the default
    flagship sampler at ``C`` chains (:data:`CHECKPOINT_STEPS` steps, save,
    load, as many more: bitwise the uninterrupted chain, its in-kernel and its
    tensor draws alike); ``lowrank_approx.pivoted_cholesky`` of a 64x64
    posterior covariance (:data:`PIVOTED`; the trace error it reports against
    the one its factor reaches)."""
    from multigridmc_tpu_torch.drivers import generate_measurements, spectrum
    from multigridmc_tpu_torch.drivers.common import (build_correlation_model, build_lattice,
                                                      measurement_params)
    from multigridmc_tpu_torch.models.posterior import measured_operator
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fem
    from multigridmc_tpu_torch.ops import lowrank_approx
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
    from multigridmc_tpu_torch.utils.checkpoint import ChainState
    from multigridmc_tpu_torch.utils.config import load_config, read_config

    out = {}
    t_start = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            # ---- drivers.spectrum
            write_driver_configs(work, SPECTRUM_NX, nlevel, n_meas, C, 10, 1)
            t0 = time.perf_counter()
            run_driver(spectrum.main, ["params_mgmc.cfg"])
            seconds = time.perf_counter() - t0
            got = np.loadtxt("spectrum.csv", delimiter=",")
            config = load_config("params_mgmc.cfg")
            prior = shiftedlaplace_fem(build_lattice(config), build_correlation_model(config),
                                       device="cpu", dtype=torch.float64)
            Q = measured_operator(prior, measurement_params(config)).to_dense()
            want = np.sort(np.linalg.eigvalsh(np.linalg.inv(Q)))[::-1]
            n = (SPECTRUM_NX - 1) ** 2
            rel = float(np.max(np.abs(got[:, 1] - want) / np.abs(want)))
            out["spectrum"] = {"lattice": [SPECTRUM_NX, SPECTRUM_NX], "eigenvalues": len(got),
                               "seconds": seconds, "largest": float(got[0, 1]),
                               "smallest": float(got[-1, 1]), "max_rel_err": rel}
            if (got.shape != (n, 2) or not np.array_equal(got[:, 0], np.arange(n))
                    or rel > 1e-6):
                raise AssertionError(f"drivers.spectrum: spectrum.csv {got.shape}, against the "
                                     f"host inverse {rel}")
            # ---- drivers.generate_measurements
            run_driver(generate_measurements.main, ["--nmeas", "8", "--output", "gen.cfg"])
            gen = read_config("gen.cfg")
            points = np.asarray(gen["measurement_locations"], dtype=np.float64).reshape(-1, 2)
            allp = np.vstack([points, np.asarray(gen["sample_location"]).reshape(1, 2)])
            gaps = [np.linalg.norm(a - b) for a, b in itertools.combinations(allp, 2)]
            out["generate_measurements"] = {"n": gen["n"], "min_distance": float(min(gaps))}
            if (gen["n"] != 8 or points.shape != (8, 2) or len(gen["variance"]) != 8
                    or not ((allp > 0) & (allp < 1)).all() or min(gaps) < 0.2):
                raise AssertionError(f"drivers.generate_measurements: {gen}")
        finally:
            os.chdir(cwd)

        # ---- a checkpoint of the default flagship sampler
        op, _ = build_posterior(256, n_meas, FLAGSHIP_SEED, "near_exact", device)
        sampler = MultigridMCSampler(op, nlevel, smoother="SOR", coarse_solver="Cholesky",
                                     omega=1.0, cycle=2)
        f = torch.as_tensor(np.random.default_rng(0).uniform(size=op.vshape),
                            dtype=torch.float32, device=device)
        x0 = torch.zeros((C,) + op.vshape, dtype=torch.float32, device=device)
        noise = GeneratorNoise(FLAGSHIP_SEED, device)
        whole = x0.clone()
        for _ in range(2 * CHECKPOINT_STEPS):
            whole = sampler.apply(noise, f, whole)
        noise = GeneratorNoise(FLAGSHIP_SEED, device)
        x = x0.clone()
        for _ in range(CHECKPOINT_STEPS):
            x = sampler.apply(noise, f, x)
        path = os.path.join(work, "chains.npz")
        t0 = time.perf_counter()
        ChainState(x, noise, CHECKPOINT_STEPS).save(path)
        state = ChainState.load(path, device)
        seconds = time.perf_counter() - t0
        x = state.x
        for _ in range(CHECKPOINT_STEPS):
            x = sampler.apply(state.noise, f, x)
        out["checkpoint"] = {"chains": C, "steps": [CHECKPOINT_STEPS, CHECKPOINT_STEPS],
                             "distill_level": sampler.distill_level,
                             "bytes": os.path.getsize(path), "save_load_seconds": seconds,
                             "philox_launches": state.noise.launches,
                             "max_abs_diff": float((x - whole).abs().max())}
        if state.step != CHECKPOINT_STEPS or not torch.equal(x, whole):
            raise AssertionError(f"checkpoint: the resumed chain differs from the "
                                 f"uninterrupted one: {out['checkpoint']}")
        del sampler, op

    # ---- the pivoted Cholesky of a posterior covariance
    g = PIVOTED
    op, _ = build_posterior(g["nx"], n_meas, FLAGSHIP_SEED, "near_exact", "cpu",
                            dtype=torch.float64)
    cov = torch.linalg.inv(torch.as_tensor(op.to_dense(), dtype=torch.float64, device=device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L, rel = lowrank_approx.pivoted_cholesky(cov, g["tolerance"], g["max_rank"])
    seconds = time.perf_counter() - t0
    trace = float(torch.diagonal(cov).sum())
    reached = float((torch.diagonal(cov) - (L * L).sum(1)).sum()) / trace
    out["pivoted_cholesky"] = {"n": cov.shape[0], "rank": L.shape[1], "seconds": seconds,
                               "reported_rel_trace_error": float(rel[-1]),
                               "reached_rel_trace_error": reached,
                               "frobenius_rel_err": float(torch.linalg.norm(cov - L @ L.T)
                                                          / torch.linalg.norm(cov))}
    stopped = rel[-1] < g["tolerance"] or L.shape[1] == g["max_rank"]
    if (not L.is_cuda or L.shape[1] > g["max_rank"] or not np.isfinite(rel).all()
            or abs(reached - rel[-1]) > 1e-9 or not stopped):
        raise AssertionError(f"pivoted_cholesky: {out['pivoted_cholesky']}")
    out["seconds"] = time.perf_counter() - t_start
    return out


# ----------------------------------------------------------------- phase: band
#: chain counts at which the band sampler is timed
BAND_CHAINS = (1, 256)
#: the float32 residual ``||L g - v|| / ||v||`` of both solve strategies on the
#: flagship's band, against the float64 host band operator: the JAX package's
#: gate on its production-like band (tests/test_sampler.py, 32^2 FD prior)
BAND_RESIDUAL_LIMIT = 5e-4
#: the doubling's residual, and its distance from the scan, at most this many
#: times the scan's own (its residual; its distance from the float64 solve)
BAND_DOUBLING_FACTOR = 50.0
#: the band solver's solution and the band sampler's mean (``fix_rhs`` unset)
#: in float32 against an independent float64 host solve of the same rhs: at
#: most this share of the solution's largest entry off.  Both solve in float64
#: on the host and round once to float32 (6e-8); a float32 Woodbury step on the
#: card is off by percents on a near-exact posterior.
BAND_MEAN_TOL = 1e-6


def band_lower_matvec(cb, g):
    """``L g`` in float64 on the host for the lower band factor
    ``cb[k, j] = L[j + k, j]`` and ``g`` of shape ``(K, n)``."""
    n = cb.shape[1]
    out = np.zeros_like(g)
    for k in range(cb.shape[0]):
        out[:, k:] += cb[k, : n - k] * g[:, : n - k]
    return out


def band_upper_solve(cb, v):
    """``L^T x = v`` in float64 on the host (``v`` of shape ``(n, K)``)."""
    import scipy.linalg

    b, n = cb.shape[0] - 1, cb.shape[1]
    ub = np.zeros_like(cb)
    for k in range(b + 1):
        ub[b - k, k:] = cb[k, : n - k]
    return scipy.linalg.solve_banded((0, b), ub, v)


def host_posterior_solve(op, F):
    """``Q^-1 F`` in float64 on the host for ``F`` of shape ``(K, n)``: scipy's
    own band factorisation of the stencil part (``solveh_banded``) and the
    Woodbury step with ``A^-1 B`` solved alongside.  It shares no code with the
    port's band solves but the band storage, which the CPU tests hold bitwise
    against the JAX package's."""
    import scipy.linalg

    from multigridmc_tpu_torch.ops.band import band_matrix_stencil

    ab, _ = band_matrix_stencil(op)
    m = op.m_lowrank
    B = op.lowrank.B.double().cpu().numpy().reshape(m, -1).T  # (n, m)
    Sig = op.lowrank.Sigma_diag.double().cpu().numpy()
    sol = scipy.linalg.solveh_banded(ab, np.concatenate([F.T, B], axis=1), lower=True)
    t, AB = sol[:, : F.shape[0]], sol[:, F.shape[0]:]
    return (t - AB @ np.linalg.solve(np.diag(Sig) + B.T @ AB, B.T @ t)).T


def check_band_means(op, sampler, f, device):
    """The float32 entry points' ``Q^-1 f`` on the near-exact posterior, where
    the Woodbury step cancels almost completely: ``BandCholeskySolver.apply``
    on two right-hand sides (the posterior's own, ``f``, and a uniform field),
    and the sampler's ``apply`` with no rhs fixed, read from one draw of zero
    normals; each against :func:`host_posterior_solve` (:data:`BAND_MEAN_TOL`).
    For the record, the same Woodbury step in float32 on the card, which the
    port does not take."""
    from multigridmc_tpu_torch.samplers.base import ReplayNoise
    from multigridmc_tpu_torch.solvers.cholesky import BandCholeskySolver

    n = sampler.factor.n
    F = torch.stack([f.reshape(n), torch.rand(n, generator=torch.Generator().manual_seed(3))
                     .to(device)])
    exact = host_posterior_solve(op, F.double().cpu().numpy())
    t0 = time.perf_counter()
    solver = BandCholeskySolver(op)
    t1 = time.perf_counter()
    got = {"solver": solver.apply(F.reshape((2,) + op.vshape)).reshape(2, n)}
    t2 = time.perf_counter()
    zeros = ReplayNoise([np.zeros((1, n), np.float32), np.zeros((1, op.m_lowrank), np.float32)])
    got["sampler_rhs_unfixed"] = sampler.apply(zeros, f, torch.zeros((1,) + op.vshape,
                                                                       device=device))
    t = sampler.factor.solve(F)
    got["float32_woodbury_on_the_card"] = t - (t @ sampler.B_flat) @ sampler.W.T
    errs = {}
    for name, g in got.items():
        if g.dtype != torch.float32 or g.device.type != "cuda":
            raise AssertionError(f"band means ({name}): {g.dtype} on {g.device}")
        g = g.reshape(-1, n).double().cpu().numpy()
        e = exact[: g.shape[0]]
        errs[name] = float((np.abs(g - e).max(axis=1) / np.abs(e).max(axis=1)).max())
    res = {"error_over_solution_max": errs, "solution_max_abs": np.abs(exact).max(axis=1).tolist(),
           "tolerance": BAND_MEAN_TOL, "solver_setup_seconds": t1 - t0,
           "solver_seconds_two_rhs": t2 - t1}
    if max(errs["solver"], errs["sampler_rhs_unfixed"]) > BAND_MEAN_TOL:
        raise AssertionError(f"band: float32 Q^-1 f off the float64 solve: {res}")
    return res


def slope_ms(fn, n1=2, n2=6, repeats=3):
    """ms per call of ``fn`` from the difference of two run lengths (CUDA
    events), the median over ``repeats``: what a call adds to a long run."""
    fn()
    torch.cuda.synchronize()

    def run(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    return float(np.median([(run(n2) - run(n1)) / (n2 - n1) for _ in range(repeats)]))


def phase_band(device, nx, n_meas, smi):
    """The exact band (``"sparse"``) Cholesky sampler on the flagship posterior
    at 255^2: its host set-up (band storage from the stencil, the float64
    factorisation, the doubling's level tensors on the card), ms per sample at
    1 and 256 chains by recursive doubling and by the block scan, the two
    against each other and their float32 residuals against the float64 band
    operator; the float32 solver's and the unfixed sampler's ``Q^-1 f``
    against a float64 host solve (:func:`check_band_means`); then a 64x64
    posterior's mean and variance against dense ``Q^-1`` (4 standard errors,
    256 chains)."""
    import copy

    import scipy.linalg

    from multigridmc_tpu_torch.models.posterior import (measurement_vector,
                                                        observed_mean_and_variance,
                                                        posterior_mean)
    from multigridmc_tpu_torch.ops.band import band_matrix_stencil
    from multigridmc_tpu_torch.samplers import cholesky as pc
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise, MeanShiftedSampler

    op, params = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    out = {"phase": "band", "card": smi, "lattice": [nx, nx], "dtype": "float32"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = pc.BandCholeskySampler(op)  # the entry point: parallel=None
    torch.cuda.synchronize()
    out["setup_seconds"] = time.perf_counter() - t0
    factor = sampler.factor
    if not factor.parallel:
        raise AssertionError("band: parallel=None did not take the doubling on the card")
    # the set-up's parts, once more
    t0 = time.perf_counter()
    ab, b = band_matrix_stencil(op)
    t1 = time.perf_counter()
    cb = scipy.linalg.cholesky_banded(ab, lower=True)
    t2 = time.perf_counter()
    scan_factor = pc.BandFactor(cb, torch.float32, device, parallel=False)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out.update({"n": factor.n, "bandwidth": b, "blocks": factor.nb, "block": factor.blk,
                "levels": factor.n_levels, "level_bytes": factor.level_bytes(),
                "band_storage_bytes": ab.nbytes, "band_storage_seconds": t1 - t0,
                "host_factorisation_seconds": t2 - t1, "blocks_upload_seconds": t3 - t2})
    del ab
    scan = copy.copy(sampler)
    scan.factor = scan_factor

    # the two strategies on the same normals: residuals and distance
    gen = torch.Generator(device=device)
    gen.manual_seed(41)
    K = 4
    v = torch.randn((K, factor.n), device=device, generator=gen)
    v64 = v.double().cpu().numpy()
    res, sols = {}, {}
    for name, fac in (("doubling", factor), ("scan", scan_factor)):
        g = fac.solve_L(v).double().cpu().numpy()
        r = band_lower_matvec(cb, g) - v64
        res[name] = float(np.max(np.linalg.norm(r, axis=1) / np.linalg.norm(v64, axis=1)))
        sols[name] = fac.solve_LT(v).double().cpu().numpy()
    exact = band_upper_solve(cb, v64.T).T
    scan_err = float(np.abs(sols["scan"] - exact).max())
    dist = float(np.abs(sols["doubling"] - sols["scan"]).max())
    out["solves"] = {"residual_L": res, "residual_limit": BAND_RESIDUAL_LIMIT,
                     "scan_LT_against_float64_max_abs": scan_err,
                     "doubling_LT_against_float64_max_abs":
                         float(np.abs(sols["doubling"] - exact).max()),
                     "doubling_against_scan_max_abs": dist,
                     "solution_max_abs": float(np.abs(exact).max()),
                     "factor": BAND_DOUBLING_FACTOR}
    if (max(res.values()) > BAND_RESIDUAL_LIMIT
            or res["doubling"] > BAND_DOUBLING_FACTOR * max(res["scan"], 1e-7)
            or dist > BAND_DOUBLING_FACTOR * max(scan_err,
                                                 1e-7 * out["solves"]["solution_max_abs"])):
        raise AssertionError(f"band: the solves disagree: {out['solves']}")

    f = op.apply(torch.as_tensor(posterior_mean(op, np.zeros(op.vshape), params.y()),
                                 dtype=torch.float32, device=device))
    out["means"] = check_band_means(op, sampler, f, device)

    # ms per sample (the rhs fixed, as the driver fixes it)
    noise = GeneratorNoise(FLAGSHIP_SEED, device)
    out["timings"] = []
    for C in BAND_CHAINS:
        x = torch.zeros((C,) + op.vshape, device=device)
        row = {"chains": C}
        for name, s in (("doubling", sampler), ("scan", scan)):
            s.fix_rhs(f)
            ms = slope_ms(lambda: s.apply(noise, f, x))
            row[f"{name}_ms_per_call"] = ms
            row[f"{name}_ms_per_sample"] = ms / C
            y = s.apply(noise, f, x)
            if tuple(y.shape) != tuple(x.shape) or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"band ({name}, {C} chains): samples not finite")
            busy = device_busy(lambda: s.apply(noise, f, x), 3, pattern=r"gemm|trsm|triang")
            row[f"{name}_kernel_ms_per_call"] = None if busy is None else busy["kernel_ms_per_step"]
            row[f"{name}_kernels_per_call"] = None if busy is None else busy["kernels_per_step"]
            s.unfix_rhs()
        out["timings"].append(row)
    del sampler, scan, factor, scan_factor

    # the statistical gate: a 64x64 posterior, through the zero-mean protocol as
    # every gate of phase statistics, and with the rhs fixed as the driver runs it
    op, params = build_posterior(64, 4, 78, "near_exact", device)
    mean = posterior_mean(op, np.zeros(op.vshape), params.y())
    w = measurement_vector(op.lattice, np.array([0.45, 0.55]), 0.1)
    z_mean, z_var = observed_mean_and_variance(op, np.zeros(op.vshape), params.y(), w)
    wt = torch.as_tensor(w, dtype=torch.float32, device=device).reshape(-1)
    C, nsteps = 256, 200
    band = pc.BandCholeskySampler(op)
    gate = {}
    for name, s, fs in (("zero_mean_protocol", MeanShiftedSampler(band, mean), None),
                        ("fix_rhs", band, op.apply(torch.as_tensor(mean, dtype=torch.float32,
                                                                   device=device)))):
        if fs is not None:
            s.fix_rhs(fs)
        noise = GeneratorNoise(4242 + len(gate), device)
        x = torch.zeros((C,) + op.vshape, device=device)
        zs = []
        for _ in range(nsteps):
            x = s.apply(noise, fs, x)
            zs.append((x.reshape(C, -1) @ wt).double())
        z = torch.stack(zs).cpu().numpy()
        gate[name] = moments_gate(f"band, {name}", z, z_mean, z_var, C)
        s.unfix_rhs()
    out["statistics_64x64"] = {"chains": C, "steps": nsteps, "exact": {"mean": z_mean,
                                                                       "variance": z_var},
                               "doubling": band.factor.parallel, **gate}
    emit(out)
    return out


# ---------------------------------------------------------- phase: alternating
#: chain counts at which the swapped-order visits are held against their plain
#: versions, by route: the phase kernels at 1, 16, 128 and 256, the split
#: kernels at 1, 16 and 128 (beyond the route's 16: at the cluster size the rule
#: picks uncapped), the stream kernels at 256 (level 0, where the main path
#: takes them)
ALT_CHECKS = (("phase", 128), ("stream", 256), ("split", 1), ("split", 16), ("split", 128))


def phase_alternating(device, nx, nlevel, C, n_meas, steps, smi):
    """The alternating sweep schedule on the flagship: every visit in the
    swapped orders of parity 1 against its plain version (2e-5) on the three
    routes, stream and split against the phase kernels under one Philox stream;
    both parities' 255^2 visits at ``C`` chains on the stream and the phase
    kernels (the route must take the faster, by device or event ms); then the
    default (distilled) sampler at ``C`` chains: ms per step and kernel ms of
    parity 0, parity 1 and ``apply_pair``, each parity's route by level, the
    set-up of both distilled maps."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    out = {"phase": "alternating", "card": smi, "chains": C, "tolerance": TOL}
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "order_one", device)
    alt = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                             distill=False, sweep_schedule="alternating")
    levels = alt._alt["fused_levels"]
    for li, level in levels.items():
        base = alt.fused_levels[li]
        if (level.pre_order != base.post_order or level.post_order != base.pre_order
                or not torch.equal(level.Bbar_pre, base.Bbar_post)):
            raise AssertionError(f"alternating: level {li} of parity 1 is not the swapped level")
    checks, errs, route_err = [], {}, {}
    for li in (0, 1):
        level = levels[li]
        for route, chains in ALT_CHECKS:
            if route == "stream" and li != 0:
                continue
            routes = ("phase",) if route == "phase" else ("phase", route)
            cluster = (mv.split_cluster(chains, level.op.vshape, capped=False)
                       if route == "split" else None)
            e, against = check_level(level, li, chains, li > 0, gen, routes, cluster)
            checks.append({"level": li, "vshape": list(level.op.vshape), "chains": chains,
                           "pre_order": list(level.pre_order), "routes": list(routes),
                           "cluster": cluster, **e,
                           "against_phase_one_philox_stream": against})
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            for r, d in against.items():
                route_err[r] = max(route_err.get(r, 0.0), *d.values())
    out.update({"max_abs_err": errs, "against_phase_max_abs_err": route_err,
                "checks": checks, "stream_layout": check_stream_layout(levels, C)})

    # both parities' 255^2 visits at C chains, stream against phase kernels
    op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
    alt = MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                             distill=False, sweep_schedule="alternating")
    noise = GeneratorNoise(6, device)
    out["level0_by_parity"] = {}
    for parity, lv in ((0, alt.fused_levels), (1, alt._alt["fused_levels"])):
        level = lv[0]
        t = timed_visits(level, C, False, noise, ("phase", "stream"))
        # the pair by device ms and by event ms (launches bound by the device:
        # check_events_against_device); the route must take the faster kernels
        # by one of the two, so that one window that read a few % off (0.3727
        # device ms against 0.3527 by events in one run) cannot decide a tie
        pair, faster = {}, {}
        for measure in ("device_ms", "ms"):
            pair[measure] = {route: t[f"{VISIT_KERNELS[route][0]}_{measure}"]
                             + t[f"{VISIT_KERNELS[route][1]}_{measure}"]
                             for route in ("phase", "stream")}
            faster[measure] = min(pair[measure], key=pair[measure].get)
        out["level0_by_parity"][parity] = {**t, "pre_order": list(level.pre_order),
                                           "pair": pair, "route": level.route(C),
                                           "faster": faster}
        if level.route(C) not in faster.values():
            raise AssertionError(f"alternating: parity {parity}'s 255^2 level takes the "
                                 f"{level.route(C)} kernels at {C} chains, the other kernels "
                                 f"are faster: {pair}")
    del alt

    # the default sampler (distilled) under the alternating schedule
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = MultigridMCSampler(op, nlevel, smoother="SOR", coarse_solver="Cholesky",
                                 omega=1.0, cycle=2, sweep_schedule="alternating")
    torch.cuda.synchronize()
    out["setup_seconds"] = time.perf_counter() - t0
    li = sampler.distill_level
    if sampler.distilled is None or sampler._alt["distilled"] is None:
        raise AssertionError("alternating: the default sampler did not distil both parities")
    maps = {}
    for parity, (pre, post) in ((0, (sampler.presamplers, sampler.postsamplers)),
                                (1, (sampler.postsamplers, sampler.presamplers))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = sampler._make_distilled(li, pre, post)
        torch.cuda.synchronize()
        maps[parity] = {"setup_seconds": time.perf_counter() - t0, "level": li,
                        "T_bytes": d.Tm.numel() * d.Tm.element_size(),
                        "S_bytes": d.S_T.numel() * d.S_T.element_size()}
        del d
    out["distilled_by_parity"] = maps
    f = torch.as_tensor(np.random.default_rng(0).uniform(size=op.vshape), dtype=torch.float32,
                        device=device)
    noise = GeneratorNoise(FLAGSHIP_SEED + 1, device)
    x = torch.zeros((C,) + op.vshape, device=device)
    for k in range(4):  # warm-up of both engines
        x = sampler.apply_indexed(noise, f, x, k)
    out["route_by_level"] = {
        parity: {li: lv.route(C) for li, lv in sorted(sampler._engine(parity)[2].items())
                 if li < sampler.distill_level} for parity in (0, 1)}
    timed = {}
    for name, fn, per in (("parity_0", lambda x: sampler.apply(noise, f, x, parity=0), 1),
                          ("parity_1", lambda x: sampler.apply(noise, f, x, parity=1), 1),
                          ("apply_pair", lambda x: sampler.apply_pair(noise, f, x), 2)):
        n = max(steps // per, 2)
        mv.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x = fn(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"alternating ({name}): samples not finite")
        busy = device_busy(lambda: fn(x), 3)
        timed[name] = {"calls": n, "ms_per_call": 1e3 * dt / n,
                       "ms_per_step": 1e3 * dt / (n * per),
                       "samples_per_s": C * n * per / dt,
                       "kernel_ms_per_call": None if busy is None else busy["kernel_ms_per_step"],
                       "kernels_per_call": None if busy is None else busy["kernels_per_step"],
                       "launches": {k: v for k, v in mv.launch_counts.items() if v}}
    out["timings"] = timed
    emit(out)
    return out


# ----------------------------------------------------------- phase: statistics
#: the SSOR sampler alone mixes slowly (its autocorrelation time on the 64x64
#: posterior is of the order of a hundred steps): warm-up, steps and thinning of
#: its statistical gate
SSOR_GATE = {"warmup": 2000, "steps": 4000, "thin": 10}
#: chains of the SSOR gate through the split sweep route
SSOR_SPLIT_CHAINS = 32
#: chains of the MGMC gate through the split visit kernels beside the one-chain
#: gate: the most the route splits (``mgmc_visit.SPLIT_MAX_CHAINS``; 32 before
#: the phase kernels ran the passes of ``csrc/level_passes.cuh``, 16 before they
#: took the low-rank noise into the Woodbury correction)
SPLIT_GATE_CHAINS = 8
#: the MGMC gate through the split visit kernels at one chain: steps, and the
#: batches whose means stand in for independent chains (the W-cycle's
#: autocorrelation time on the 64x64 posterior is a few steps)
SPLIT_GATE = {"steps": 3000, "batches": 30}
#: the same for the two-sweep visits at one chain (a step takes twice the
#: sweeps, and the run's time is bounded): half the steps, 30 batches of 50
SSOR_SPLIT_GATE_STEPS = 1500
#: the alternating schedule's statistical gates: over-relaxed, as the reference's
#: own warm-up diagnostic runs it
ALTERNATING = {"sweep_schedule": "alternating", "omega": 1.4}


def moments_gate(name, z, z_mean, z_var, C, gated=True):
    """Mean and variance of the observable ``z`` (steps, chains) against the
    exact ones, within 4 standard errors unless ``gated`` is false (a
    reading).  Independent chains: the spread of the per-chain time averages
    carries the autocorrelation of the series."""
    zbar = z.mean(axis=0)
    vbar = ((z - z_mean) ** 2).mean(axis=0)
    se_mean = zbar.std(ddof=1) / np.sqrt(C)
    se_var = vbar.std(ddof=1) / np.sqrt(C)
    res = {"mean": float(zbar.mean()), "mean_se": float(se_mean),
           "variance": float(vbar.mean()), "variance_se": float(se_var)}
    res["mean_sigmas"] = abs(res["mean"] - z_mean) / se_mean
    res["variance_sigmas"] = abs(res["variance"] - z_var) / se_var
    if not np.isfinite(z).all() or gated and (res["mean_sigmas"] > 4
                                              or res["variance_sigmas"] > 4):
        raise AssertionError(f"statistics ({name}): moments off: {res}, exact "
                             f"mean {z_mean} variance {z_var}")
    return res


def phase_statistics(device, nx, C, warmup, steps):
    from multigridmc_tpu_torch.models.posterior import (measurement_vector,
                                                        observed_mean_and_variance,
                                                        posterior_mean)
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.samplers.base import (GeneratorNoise, MeanShiftedSampler,
                                                     ReplayNoise)
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler
    from multigridmc_tpu_torch.samplers.sor import SSORSampler
    from multigridmc_tpu_torch.solvers.loop import IterativeSolverParameters, LoopSolver
    from multigridmc_tpu_torch.solvers.multigrid import MultigridPreconditioner

    out = {"phase": "statistics", "lattice": [nx, nx], "chains": C, "steps": steps}

    # (1) one W-cycle step under the same noise: kernels (noise fed as tensors)
    # against the composed plain path; elementwise, so O(1) variances as above
    op, _ = build_posterior(nx, 4, 77, "order_one", device)
    fused = MultigridMCSampler(op, 3, cycle=2, fused=True, fused_min_vertices=0, distill=False)
    composed = MultigridMCSampler(op, 3, cycle=2, fused=False, distill=False)
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
    # beside w, the first measurement's own functional B_0^T x (variance about
    # its Sigma, 1e-6), gated the same way on every variant
    b0 = op.lowrank.B[0].double().cpu().numpy()
    b0_mean, b0_var = observed_mean_and_variance(op, xbar, params.y(), b0)
    out["exact_B0"] = {"mean": b0_mean, "variance": b0_var}
    wb = torch.stack([wt, op.lowrank.B[0].reshape(-1).float()]).T.double()  # (n, 2)

    def gate_both(name, z, Cz):
        """``z`` (steps, chains, 2): the gate on w and, beside it, on B_0^T x."""
        res = moments_gate(name, z[..., 0], z_mean, z_var, Cz)
        res["B0"] = moments_gate(f"{name} B_0^T x", z[..., 1], b0_mean, b0_var, Cz)
        return res
    # through the visit kernels, the plain path, the distilled subtree (31^2
    # and 15^2 as one affine map) and the subtree kernel with its in-kernel noise
    # and through the split visit kernels at one chain (batch means over its
    # time series) and at the most chains the route splits, and through the
    # phase kernels at the main-path variant's count
    variants = (("kernels", dict(fused=True, distill=False), 1001, C, steps),
                ("plain", dict(fused=False, distill=False), 1000, C, steps),
                ("distilled", dict(distill=True), 1002, C, steps),
                ("subtree_kernel", dict(subtree=True), 1003, C, steps),
                ("kernels_split_one_chain", dict(fused=True, distill=False), 1004, 1,
                 SPLIT_GATE["steps"]),
                (f"kernels_split_{SPLIT_GATE_CHAINS}_chains", dict(fused=True, distill=False),
                 1005, SPLIT_GATE_CHAINS, steps),
                ("kernels_phase", dict(fused=True, distill=False), 1006, PHASE_CHAINS, steps),
                # the alternating schedule at omega = 1.4 (the reference's
                # warm-up scan), both parities by step index: the phase kernels
                # at C chains, the split kernels at one chain
                ("kernels_alternating", dict(ALTERNATING, fused=True, distill=False), 1007, C,
                 steps),
                ("kernels_split_one_chain_alternating", dict(ALTERNATING, fused=True,
                                                             distill=False), 1008, 1,
                 SPLIT_GATE["steps"]),
                # SSOR levels on the two-sweep visit kernels: the phase kernels
                # at C chains, the split kernels at one chain (the JAX package's
                # gate 3c, "SSOR fused MGMC")
                ("kernels_ssor", dict(smoother="SSOR", fused=True, distill=False), 1009, C, steps),
                ("kernels_ssor_split_one_chain", dict(smoother="SSOR", fused=True, distill=False),
                 1010, 1, SSOR_SPLIT_GATE_STEPS))
    for name, kwargs, seed, Cv, nsteps in variants:
        inner = MultigridMCSampler(op, 3, cycle=2, fused_min_vertices=0, **kwargs)
        if (name == "distilled") != (inner.distilled is not None and inner.distill_level == 1):
            raise AssertionError(f"statistics ({name}): distill level {inner.distill_level}")
        st.reset_launch_counts()
        mv.reset_launch_counts()
        sampler = MeanShiftedSampler(inner, mean)
        noise = GeneratorNoise(seed, device)
        x = sampler.mean.expand((Cv,) + op.vshape).clone()
        for k in range(warmup):
            x = sampler.apply_indexed(noise, None, x, k)
        zs = []
        for k in range(warmup, warmup + nsteps):
            x = sampler.apply_indexed(noise, None, x, k)
            zs.append(x.reshape(Cv, -1).double() @ wb)
        z = torch.stack(zs).cpu().numpy()  # (steps, Cv, 2)
        if Cv == 1:  # one chain: its series in batches, whose means are nearly independent
            z = z[:, 0].reshape(SPLIT_GATE["batches"], -1, 2).transpose(1, 0, 2)
        out[name] = gate_both(name, z, z.shape[1])
        out[name]["chains"] = Cv
        if name.startswith("kernels"):  # the visit kernels of this chain count's route
            routes = {level.route(Cv) for engine in (0, 1)
                      for level in inner._engine(engine)[2].values()}
            route = routes.pop()
            want = ("split" if "split" in name else
                    "phase" if name == "kernels_phase" else mv.visit_route(Cv))
            suffix = mv.SSOR_SUFFIX if kwargs.get("smoother") == "SSOR" else ""
            names = [n + suffix for n in VISIT_KERNELS[route]]
            out[name]["route"] = route
            out[name]["launches"] = {n: c for n, c in mv.launch_counts.items() if c}
            if (routes or route != want or min(mv.launch_counts[n] for n in names) <= 0
                    or any(c for n, c in mv.launch_counts.items() if n not in names)):
                raise AssertionError(f"statistics ({name}): visit launches {mv.launch_counts}, "
                                     f"expected {names} only")
        if name == "subtree_kernel":
            out[name]["launches"] = st.launch_counts["subtree_sample"]
            if st.launch_counts["subtree_sample"] != warmup + nsteps:
                raise AssertionError(f"statistics: {st.launch_counts} subtree launches")

    # (3) the same posterior through the SSOR sampler alone: every sweep is a
    # launch of the Gibbs sweep kernel with its in-kernel noise
    sampler = MeanShiftedSampler(SSORSampler(op, 1.0, 1), mean)
    noise = GeneratorNoise(3000, device)
    x = sampler.mean.expand((C,) + op.vshape).clone()
    ss.reset_launch_counts()
    zs = []
    for k in range(SSOR_GATE["warmup"] + SSOR_GATE["steps"]):
        x = sampler.apply(noise, None, x)
        if k >= SSOR_GATE["warmup"] and (k - SSOR_GATE["warmup"]) % SSOR_GATE["thin"] == 0:
            zs.append(x.reshape(C, -1).double() @ wb)
    z = torch.stack(zs).cpu().numpy()
    launches = ss.launch_counts["gibbs_sweep_batched"]
    if launches != 2 * (SSOR_GATE["warmup"] + SSOR_GATE["steps"]):
        raise AssertionError(f"statistics (ssor): {launches} Gibbs sweep launches")
    out["ssor_kernel"] = {**SSOR_GATE, "launches": launches, **gate_both("ssor_kernel", z, C)}
    # the same gate through the split route, at a chain count that takes it
    Cs = SSOR_SPLIT_CHAINS
    route = sampler.inner.forward.smoother.plan.route(Cs, 1)
    if route[0] != "split":
        raise AssertionError(f"statistics (ssor, split): {Cs} chains take {route}")
    noise = GeneratorNoise(3001, device)
    x = sampler.mean.expand((Cs,) + op.vshape).clone()
    ss.reset_launch_counts()
    zs = []
    for k in range(SSOR_GATE["warmup"] + SSOR_GATE["steps"]):
        x = sampler.apply(noise, None, x)
        if k >= SSOR_GATE["warmup"] and (k - SSOR_GATE["warmup"]) % SSOR_GATE["thin"] == 0:
            zs.append(x.reshape(Cs, -1).double() @ wb)
    z = torch.stack(zs).cpu().numpy()
    launches = ss.launch_counts["gibbs_sweep_batched_split"]
    if launches != 2 * (SSOR_GATE["warmup"] + SSOR_GATE["steps"]) or ss.launch_counts[
            "gibbs_sweep_batched"]:
        raise AssertionError(f"statistics (ssor, split): launches {ss.launch_counts}")
    out["ssor_kernel_split"] = {**SSOR_GATE, "chains": Cs, "route": list(route),
                                "launches": launches,
                                **gate_both("ssor_kernel_split", z, Cs)}

    # (4) a batched deterministic solve: Richardson with the SSOR-smoothed
    # W-cycle, 64 right-hand sides as one system (the route of 64 chains),
    # against the float64 dense solve; with its levels fused (the two-sweep
    # visits on the phase kernels) and composed (every sweep a launch of the
    # sweep kernels)
    op, _ = build_posterior(nx, 4, 77, "order_one", device)
    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    b = torch.randn((64,) + op.vshape, device=device, generator=gen)
    dense = torch.as_tensor(op.to(dtype=torch.float64).to_dense(), device=device)
    want = torch.linalg.solve(dense, b.double().reshape(64, -1).T).T.reshape(b.shape)
    for key, fused in (("batched_solve", False), ("batched_solve_fused", True)):
        precond = MultigridPreconditioner(op, 3, smoother="SSOR", cycle=2, fused=fused)
        ss.reset_launch_counts()
        mv.reset_launch_counts()
        result = LoopSolver(op, precond, IterativeSolverParameters(
            rtol=1e-5, atol=1.0, maxiter=30)).solve_jit(b)
        rel = float((result.x.double() - want).norm() / want.norm())
        sweeps = ss.launch_counts["sweep_batched"] + ss.launch_counts["sweep_batched_split"]
        visits = sum(mv.launch_counts[n + mv.SSOR_SUFFIX] for n in VISIT_KERNELS["phase"])
        out[key] = {"rhs": 64, "iterations": result.niter, "converged": result.converged,
                    "relative_error": rel, "sweep_launches": sweeps,
                    "split_launches": ss.launch_counts["sweep_batched_split"],
                    "ssor_phase_visit_launches": visits}
        if not result.converged or rel > 1e-4 or (visits <= 0 if fused else sweeps <= 0):
            raise AssertionError(f"statistics ({key}): {out[key]}")
    emit(out)
    return out


# ------------------------------------------------------------------------ main

# ------------------------------------------------------------ phase: biharmonic
#: the problem of ``native/bench_biharmonic_tpu.py``: the squared shifted-Laplace
#: (13-point, reach 2) prior with Lambda = 0.2 and 8 near-exact measurements
#: drawn from this seed, 5 levels, W-cycle, SOR
BIHARMONIC_SEED = 20260820
#: :func:`build_posterior`'s arguments for that prior: zero-mean measurements
BIHARMONIC = {"pdemodel": "squared_shiftedlaplace_fd", "mean": 0.0}
#: the statistical gate of ``native/validate_biharmonic_tpu.py``: 64x64, 3
#: levels, variances 1e-2 (1 + u) drawn from this seed, every non-coarsest level
#: fused, 256 chains, the zero-mean protocol
BIHARMONIC_GATE_SEED = 20260821
BIHARMONIC_GATE = {"nx": 64, "nlevel": 3, "warmup": 80, "steps": 300}
#: steps of the full-width biharmonic sampler and of the FEM flagship variant
BIHARMONIC_STEPS = 30
#: the reach-2 subtree kernel's block sizes and placements (threads, field
#: budget in bytes: None the default, two blocks an SM; 0 every field in the
#: workspace; "one_block" every field the block's whole grant holds, one block
#: an SM, the rule before the sweeps took the colours' point lists)
BIHARMONIC_SUBTREE_VARIANTS = ((256, None), (512, None), (1024, None), (512, "one_block"),
                               (512, 0), (1024, 0))
FEM_STEPS = 10
#: chain counts at which a reach-2 or 3d level's route must be the phase kernels
PHASE_ONLY_CHAINS = (1, 16, 256)
#: the chains at the start and at the end of a launch whose in-kernel normals
#: are held against the host's reference (the first and the last wave)
NOISE_CHECK_WAVE = 32
#: above this many chains a sweep is timed over fewer launches (the
#: distillation set-up's batch, tens of thousands of chains)
BIG_SWEEP_CHAINS = 1024
#: profiler windows of the full-width samplers' kernel ms per step: taken
#: until three record every visit launch of their steps, at most this many
BUSY_WINDOWS = 6


def compare_fc(name, got, want, tol=TOL):
    """A restricted residual against its plain version: within ``tol`` times
    ``max(|f_c|, 1)``.  A reach-2 level's diagonal is about 1.3e6 at h = 1/256,
    and ``f - A x`` cancels in float32 (the rule of
    ``tests/test_mgmc_visit.py::test_biharmonic_visits_match_composed``).
    Returns the error over that scale."""
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    if not err <= tol * scale or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel and plain version disagree, max abs err {err} "
                             f"(limit {tol} x {scale})")
    return err / scale


def check_phase_only_level(level, name, C, gen, label="biharmonic", route="phase"):
    """The kernels of ``route`` on a level the reach-1 routes do not take (the
    reach-2 forms: the phase kernels' build or the smem kernels; the 3d forms:
    the phase kernels') against their plain versions on one level at ``C``
    chains: noise off and the same noise tensors, then the in-kernel generator
    against the plain versions fed the host's reference normals (the first
    and the last :data:`NOISE_CHECK_WAVE`); ``x`` elementwise within TOL,
    ``f_c`` by :func:`compare_fc`; the smem kernels also against the phase
    kernels under one Philox stream (the same tolerances).  A 3d level's route
    at every count of :data:`PHASE_ONLY_CHAINS` must be the one
    ``mgmc_visit_smem3d.SMEM3D_ROUTES`` gives it (a reach-2 level's routes are
    recorded), and the split and stream routes must refuse the level before
    they launch.  ``label`` names the phase in messages."""
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3

    routes = {c: level.route(c) for c in PHASE_ONLY_CHAINS}
    if level.dim == 3 and routes != {c: "phase" if v3.route_config(
            level.op.vshape, level.stencil_form, level.ndir, c) is None else "smem"
            for c in PHASE_ONLY_CHAINS}:
        raise AssertionError(f"{label} {name}: the level takes the routes {routes}")
    dev = level.coeffs.device
    vshape, m = level.op.vshape, level.op.m_lowrank

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.float32, generator=gen)

    f, x, xc = rand(*vshape), rand(C, *vshape), rand(C, *level.vc)
    before = dict(mv.launch_counts)
    for refused in ("split", "stream"):
        try:
            mv.launch_descend(level, refused, f, x.clone())
        except NotImplementedError:
            continue
        raise AssertionError(f"{label} {name}: the {refused} route took the level")
    if mv.launch_counts != before:
        raise AssertionError(f"{label} {name}: a refused launch was counted")
    errs = {"x": 0.0, "f_c_over_scale": 0.0, "ascend_x": 0.0}
    for noisy in (False, True):
        xi = rand(C, *vshape) if noisy else None
        xi_lr = rand(C, m) if (noisy and m) else None
        tag = f"{label} {name} C={C} {route} {'shared noise' if noisy else 'noise off'}"
        want_x, want_fc = mv.descend_visit_plain(level, f, x, xi, xi_lr)
        got_x, got_fc = mv.launch_descend(level, route, f, x.clone(), xi=xi, xi_lr=xi_lr)
        errs["x"] = max(errs["x"], compare(f"descend x {tag}", got_x, want_x))
        errs["f_c_over_scale"] = max(errs["f_c_over_scale"],
                                     compare_fc(f"descend f_c {tag}", got_fc, want_fc))
        want = mv.ascend_visit_plain(level, f, x, xc, xi, xi_lr)
        got = mv.launch_ascend(level, route, f, x.clone(), xc, xi=xi, xi_lr=xi_lr)
        errs["ascend_x"] = max(errs["ascend_x"], compare(f"ascend x {tag}", got, want))
        del want_x, want_fc, got_x, got_fc, want, got
    xi_lr = rand(C, m) if m else None
    seed = 0x5EED_0012
    got_x, got_fc = mv.launch_descend(level, route, f, x.clone(), xi_lr=xi_lr, philox=(seed, 11))
    got = mv.launch_ascend(level, route, f, x.clone(), xc, xi_lr=xi_lr, philox=(seed, 12))
    for first, n in ((0, min(C, NOISE_CHECK_WAVE)), (max(C - NOISE_CHECK_WAVE, 0),
                                                   min(C, NOISE_CHECK_WAVE))):
        part = slice(first, first + n)
        tag = f"{label} {name} C={C} {route} in-kernel noise, chains {first}..{first + n - 1}"
        ref = [torch.as_tensor(common.philox_normals_reference(seed, counter, n, vshape,
                                                               first_chain=first), device=dev)
               for counter in (11, 12)]
        lr = xi_lr[part] if m else None
        want_x, want_fc = mv.descend_visit_plain(level, f, x[part], ref[0], lr)
        errs["x"] = max(errs["x"], compare(f"descend x {tag}", got_x[part], want_x))
        errs["f_c_over_scale"] = max(errs["f_c_over_scale"], compare_fc(
            f"descend f_c {tag}", got_fc[part], want_fc))
        want = mv.ascend_visit_plain(level, f, x[part], xc[part], ref[1], lr)
        errs["ascend_x"] = max(errs["ascend_x"], compare(f"ascend x {tag}", got[part], want))
    if route == "smem":  # one Philox stream through the smem and the phase kernels
        stream = {"xi_lr": xi_lr, "philox": (seed, 21)}
        got = [(*mv.launch_descend(level, r, f, x.clone(), **stream),
                mv.launch_ascend(level, r, f, x.clone(), xc, **stream)) for r in ("phase", route)]
        tag = f"{label} {name} C={C} one Philox stream, smem against phase kernel"
        errs["smem_against_phase"] = {
            "descend_x": compare(f"descend x {tag}", got[1][0], got[0][0]),
            "descend_f_c_over_scale": compare_fc(f"descend f_c {tag}", got[1][1], got[0][1]),
            "ascend_x": compare(f"ascend x {tag}", got[1][2], got[0][2])}
        del got
    torch.cuda.synchronize()
    return {"level": name, "vshape": list(vshape), "offsets": len(level.op.offsets),
            "colours": level.coloring.n_colors, "stencil_form": level.stencil_form,
            "chains": C, "route": route, "routes": routes,
            "threads": level.phase_threads(C) if route == "phase" else smem_launch_of(
                level, C)["threads"],
            "cluster": smem_launch_of(level, C)["cluster"] if route == "smem" else None,
            "coefficient_planes": sum(c is None for c in level.const_coeffs), **errs}


def reach2_kernel(level, route, kind):
    """The profiler's name of the kernel a launch of ``kind`` through ``route``
    (the phase kernels' reach-2 or 3d build, or the smem kernels, 2d or 3d)
    runs on ``level``."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    if route == "smem":
        body = "smem_volume_kernel" if level.dim == 3 else "smem_visit_kernel"
        return (f"{body}<{mv.smem_module(level).kmax(level.stencil_form)}, "
                f"{'true' if kind == 'descend' else 'false'}")
    return f"{kind}_kernel<{level.stencil_form}"


def smem_launch_of(level, C):
    """The smem route's launch configuration of ``C`` chains on ``level`` by
    its rules (3d: its table where it lists the count): the cluster size,
    ``c`` in shared memory, threads, bytes."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    vsm = mv.smem_module(level)
    L = vsm.layout(level, level.pre_orders, C=C)
    if level.dim == 3:
        Z, Y, W = level.op.vshape
        card = vsm.load_library().mgmc_smem3d_smem_bytes(Z, Y, W, L.S, vsm.plane(Y, W),
                                                          int(L.c_shared))
    else:
        H, W = level.op.vshape
        card = vsm.load_library().mgmc_smem_visit_smem_bytes(H, W, L.S, vsm.pitch(W),
                                                              int(L.c_shared))
    card += mv.lowrank_scratch_bytes(level.op.m_lowrank, L.threads)  # more than 32 measurements
    if card != L.nbytes:
        raise AssertionError(f"smem {tuple(level.op.vshape)} S={L.S}: the library lays out "
                             f"{card} bytes a block, {vsm.__name__}.smem_bytes {L.nbytes}")
    return {"cluster": L.S, "c_shared": L.c_shared, "threads": L.threads,
            "dynamic_shared_bytes": L.nbytes}


def time_phase_only_level(level, C, noise, route="phase"):
    """ms per launch of the kernels of ``route`` (the phase kernels' reach-2 or
    3d build, or the smem kernels) at ``C`` chains with in-kernel noise, as
    the main path runs them: CUDA events around back-to-back launches and the
    profiler's device time (the kernel of this level's stencil form by its
    full name, the median of three windows, held to the events), the plain
    versions' ms and the bound."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    dev = level.coeffs.device
    f = torch.rand(level.op.vshape, device=dev)
    x = torch.zeros((C,) + level.op.vshape, device=dev)
    xc = torch.randn((C,) + level.vc, device=dev)
    out = {"vshape": list(level.op.vshape), "chains": C, "route": route,
           "threads": level.phase_threads(C), "stencil_form": level.stencil_form}
    if route == "smem":
        out.update(smem_launch_of(level, C))
    for kind, fn in zip(("descend", "ascend"), visit_fns(level, route, noise, f, x, xc)):
        host = {}
        out[f"{kind}_ms"] = cuda_ms(fn, 5, 10, host)
        out[f"{kind}_device_ms"] = device_ms_median(fn, reach2_kernel(level, route, kind), 20)
        out[f"{kind}_events_over_device"] = check_events_against_device(
            f"{kind} {route} {tuple(level.op.vshape)} form {level.stencil_form} C={C}",
            out[f"{kind}_ms"],
            out[f"{kind}_device_ms"], host["ms"])
        bound, by, nbytes = visit_bound(level, C, False, kind)
        out[f"{kind}_bound_ms"], out[f"{kind}_bound_by"], out[f"{kind}_bytes"] = bound, by, nbytes
    x.zero_()

    def plain_noise(kind="descend"):
        xi, xi_lr, _ = level._draw(_TensorNoise(noise), x, kind)
        return xi, xi_lr

    out["descend_plain_ms"] = cuda_ms(
        lambda: mv.descend_visit_plain(level, f, x, *plain_noise()), 3, 3)
    out["ascend_plain_ms"] = cuda_ms(
        lambda: mv.ascend_visit_plain(level, f, x, xc, *plain_noise("ascend")), 3, 3)
    return out


#: chain counts of the ``smem_routes`` table (phase ``biharmonic``)
SMEM_ROUTE_CHAINS = (1, 16, 256)
#: the rule's route may take up to this multiple of the other route's device
#: ms before the table fails (two profiler medians of one card differ by a few
#: percent from call to call)
SMEM_ROUTE_SLACK = 1.10


def biharmonic_ssor_levels(sampler):
    """Two-sweep (SSOR, forward then backward) fused levels of the sampler's
    levels 0 and 1 (the biharmonic posterior's, the 64^3 posterior's), from
    their operators and ``SSORSmoother``s as the sampler would build them with
    ``smoother="SSOR"``."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.smoothers import SSORSmoother

    out = {}
    for li in (0, 1):
        lv = sampler.fused_levels[li]
        orders, Bbar, coloring, _ = mv._sweep_spec(SSORSmoother(lv.op, lv.omega, 1))
        out[li] = mv.FusedVisitLevel(lv.op, coloring, lv.omega, orders, orders, Bbar, Bbar,
                                     lv.coarse_scaling)
    return out


def time_reach2_routes(levels, noise, chains=SMEM_ROUTE_CHAINS):
    """The ``smem_routes`` table: device ms per launch (torch.profiler, the
    median of three interleaved windows) of both reach-2 routes, the phase
    kernels' build and the smem kernels at the rule's cluster size, descend
    plus ascend, at each count of ``chains`` on each of ``levels`` (``{name:
    level}``, one and two sweeps), beside the route the rule takes.  Returns
    the rows and the faults: a count where the rule's route takes more than
    :data:`SMEM_ROUTE_SLACK` times the other's."""
    rows, faults = [], []
    for name, level in levels.items():
        dev = level.coeffs.device
        for C in chains:
            f = torch.rand(level.op.vshape, device=dev)
            x = torch.zeros((C,) + level.op.vshape, device=dev)
            xc = torch.randn((C,) + level.vc, device=dev)
            cands = {}
            for route in ("phase", "smem"):
                for kind, fn in zip(("descend", "ascend"),
                                    visit_fns(level, route, noise, f, x, xc)):
                    cands[(route, kind)] = (fn, reach2_kernel(level, route, kind))
            ms = device_ms_medians(cands, 10, 3)
            row = {"level": name, "vshape": list(level.op.vshape), "sweeps": level.ndir,
                   "stencil_form": level.stencil_form, "chains": C, "rule": level.route(C),
                   **{f"smem_{k}": v for k, v in smem_launch_of(level, C).items()},
                   "phase_threads": level.phase_threads(C)}
            for route in ("phase", "smem"):
                for kind in ("descend", "ascend"):
                    row[f"{route}_{kind}_ms"] = ms[(route, kind)]
                row[f"{route}_ms"] = ms[(route, "descend")] + ms[(route, "ascend")]
            row["smem_over_phase"] = row["smem_ms"] / row["phase_ms"]
            other = "phase" if row["rule"] == "smem" else "smem"
            if row[f"{row['rule']}_ms"] > SMEM_ROUTE_SLACK * row[f"{other}_ms"]:
                faults.append(f"{name} C={C}: the rule takes {row['rule']} "
                              f"({row[row['rule'] + '_ms']} ms), {other} takes {row[other + '_ms']}")
            rows.append(row)
            del x, xc
    return rows, faults


def reach2_pass_stamps(level, li, C, noise, route, label="biharmonic"):
    """One reach-2 (or 3d) launch of each kind by pass from the stamps build
    of ``route`` (the phase kernels' reach-2 or 3d build, or the smem
    kernels), in-kernel noise, at ``C`` chains: per pass the median over the
    blocks, the barriers each block passed against the count from the source
    (``mgmc_visit.phase_barrier_count``, ``mgmc_visit_smem.barrier_count``,
    ``mgmc_visit_smem3d.barrier_count``), the blocks one SM ran at once
    against the occupancy calculator, the span against the profiler's device
    ms of the production build, the registers and spills of the kernel; the
    last of three launches."""
    import ctypes

    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    vsm = mv.smem_module(level)

    dev = level.coeffs.device
    f = torch.rand(level.op.vshape, device=dev)
    x = torch.zeros((C,) + level.op.vshape, device=dev)
    xc = torch.randn((C,) + level.vc, device=dev)
    row = {"level": li, "vshape": list(level.op.vshape), "chains": C, "route": route,
           "stencil_form": level.stencil_form}
    S = 1
    if route == "smem":
        row.update(smem_launch_of(level, C))
        S = row["cluster"]
    else:
        row["threads"] = level.phase_threads(C)
    fns = visit_fns(level, route, noise, f, x, xc)
    for kind, fn in zip(("descend", "ascend"), fns):
        device_ms = device_ms_median(fn, reach2_kernel(level, route, kind))
        stamps = torch.zeros(mv.stamp_shape(level, route, C, S), dtype=torch.int64, device=dev)
        for _ in range(3):
            xi, xi_lr, philox = level._draw(noise, x, kind)
            if kind == "descend":
                mv.launch_descend(level, route, f, x, xi, xi_lr, philox, stamps=stamps)
            else:
                mv.launch_ascend(level, route, f, x, xc, xi, xi_lr, philox, stamps=stamps)
        torch.cuda.synchronize()
        vals = (ctypes.c_int * 3)()
        if route == "smem":
            pt = vsm.pass_times(level, kind, stamps)
            pt["barriers_from_source"] = vsm.barrier_count(level, kind)
            L = vsm.layout(level, level.orders(kind), C=C)
            lib = vsm.load_library()
            if level.dim == 3:
                pt["blocks_per_sm_occupancy_api"] = lib.mgmc_smem3d_blocks_per_sm(
                    int(kind == "descend"), L.kmax, L.threads, L.nbytes)
                lib.mgmc_smem3d_kernel_attributes(int(kind == "descend"), L.kmax, vals)
            else:
                pt["blocks_per_sm_occupancy_api"] = lib.mgmc_smem_visit_blocks_per_sm(
                    int(kind == "descend"), L.kmax, L.threads, L.nbytes)
                lib.mgmc_smem_visit_kernel_attributes(int(kind == "descend"), L.kmax, vals)
        else:
            pt = mv.pass_times(level, kind, stamps)
            pt["barriers_from_source"] = mv.phase_barrier_count(level, kind)
            smem = level.phase_launch(level.orders(kind), row["threads"])[2]
            pt["tables_in_shared_memory"] = smem > 0
            lib = mv.load_library(reach=level.reach, dim=level.dim)
            pt["blocks_per_sm_occupancy_api"] = lib.mgmc_visit_blocks_per_sm(
                int(kind == "descend"), level.stencil_form, len(level.orders(kind)),
                row["threads"], smem)
            lib.mgmc_visit_kernel_attributes(int(kind == "descend"), level.stencil_form,
                                             len(level.orders(kind)), vals)
        pt["registers"], pt["local_bytes"] = vals[0], vals[1]
        pt["device_ms"] = device_ms
        pt["span_over_device_ms"] = pt["launch_span_us"] / 1e3 / device_ms
        tag = f"{label} {route} L{li} C={C} {kind}"
        if pt["barriers_per_block"] != [pt["barriers_from_source"]]:
            raise AssertionError(f"{tag}: the blocks passed {pt['barriers_per_block']} "
                                 f"barriers, the source places {pt['barriers_from_source']}")
        if not 1 <= pt["blocks_per_sm"] <= pt["blocks_per_sm_occupancy_api"]:
            raise AssertionError(f"{tag}: {pt['blocks_per_sm']} blocks on one SM at once, the "
                                 f"occupancy calculator allows {pt['blocks_per_sm_occupancy_api']}")
        row[kind] = pt
    del x, xc
    return row


def smem_kernel_attributes(dim=2):
    """Registers, local (spill) bytes and static shared bytes per thread of
    the smem kernels (2d: the 5-, 9-, 13- and 25-point kernels; 3d: the 7- and
    27-point kernels; both kinds)."""
    import ctypes

    from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem as vsm
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3

    lib = (v3 if dim == 3 else vsm).load_library()
    query = (lib.mgmc_smem3d_kernel_attributes if dim == 3
             else lib.mgmc_smem_visit_kernel_attributes)
    out = {}
    for (kind, descend), km in itertools.product((("descend", 1), ("ascend", 0)),
                                                 (7, 27) if dim == 3 else (5, 9, 13, 25)):
        vals = (ctypes.c_int * 3)()
        err = query(descend, km, vals)
        if err:
            raise AssertionError(f"smem {kind} {km}-point kernel attributes: CUDA error {err}")
        out[f"{kind} {km}-point"] = {"registers": vals[0], "local_bytes": vals[1],
                                     "static_shared_bytes": vals[2]}
    return out


#: the smem kernels' block-size and placement table (``--phases smem_table``):
#: threads per block tried at every cluster size that fits, with ``c`` in
#: shared memory where it fits and without
SMEM_TABLE_THREADS = (256, 512, 1024)
SMEM_TABLE_CHAINS = (1, 16, 256)


def time_smem_variants(levels, noise):
    """The smem kernels' device ms per descend plus ascend on each of
    ``levels`` at the chain counts of :data:`SMEM_TABLE_CHAINS`: every cluster
    size of ``mgmc_visit_smem.candidates`` (and the size that fits without
    ``c``), ``c`` in shared memory or not, :data:`SMEM_TABLE_THREADS`; the
    rule's choice beside."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem as vsm
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    rows = []
    for name, level in levels.items():
        dev = level.coeffs.device
        H, W = level.op.vshape
        limit = ss.smem_limit_of(dev)
        for C in SMEM_TABLE_CHAINS:
            f = torch.rand(level.op.vshape, device=dev)
            x = torch.zeros((C,) + level.op.vshape, device=dev)
            xc = torch.randn((C,) + level.vc, device=dev)
            cands = {}
            for S in vsm.CLUSTER_SIZES:
                if H // S < vsm.HALO or not vsm.fits_indices(H, W, S):
                    continue
                for c_sh in (True, False):
                    if vsm.smem_bytes(H, W, S, c_sh) + vsm.STATIC_SMEM > limit:
                        continue
                    for threads in SMEM_TABLE_THREADS:
                        if vsm.active_clusters(level, S, c_sh, threads) < 1:
                            continue
                        kw = dict(cluster=S, c_shared=c_sh, threads=threads)
                        for kind in ("descend", "ascend"):
                            def fn(kind=kind, kw=kw):
                                xi, xi_lr, philox = level._draw(noise, x, kind)
                                if kind == "descend":
                                    return mv_launch("descend", level, f, x, xi, xi_lr, philox,
                                                     None, kw)
                                return mv_launch("ascend", level, f, x, xi, xi_lr, philox, xc,
                                                 kw)
                            cands[(S, c_sh, threads, kind)] = (
                                fn, reach2_kernel(level, "smem", kind))
            ms = device_ms_medians(cands, 10, 3)
            rule = smem_launch_of(level, C)
            for (S, c_sh, threads) in sorted({k[:3] for k in cands}):
                d, a = ms[(S, c_sh, threads, "descend")], ms[(S, c_sh, threads, "ascend")]
                rows.append({"level": name, "vshape": [H, W], "sweeps": level.ndir, "chains": C,
                             "cluster": S, "c_shared": c_sh, "threads": threads,
                             "descend_ms": d, "ascend_ms": a,
                             "ms": None if None in (d, a) else d + a,
                             "rule": (S, c_sh, threads) == (rule["cluster"], rule["c_shared"],
                                                            rule["threads"])})
            del x, xc
    return rows


def mv_launch(kind, level, f, x, xi, xi_lr, philox, xc, kw):
    """One smem launch of ``kind`` with the configuration ``kw`` (cluster,
    c_shared, threads)."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    if kind == "descend":
        return mv.launch_descend(level, "smem", f, x, xi, xi_lr, philox, **kw)
    return mv.launch_ascend(level, "smem", f, x, xc, xi, xi_lr, philox, **kw)


def phase_reach2(device, nlevel, C, smi, table):
    """The reach-2 visits alone on the biharmonic posterior's levels 0 and 1 at
    ``C`` chains: both designs' registers and spills, the phase kernels'
    reach-2 build by pass (its stamps build), the smem kernels and their
    two-sweep form against the plain versions and the phase kernels; with
    ``table`` the smem kernels by pass and their block-size and placement
    table (:func:`time_smem_variants`, one and two sweeps).  No result line."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    out = {"phase": "reach2_check", "card": smi}
    try:
        gen = torch.Generator(device=device)
        gen.manual_seed(12)
        op, _ = build_posterior(256, 8, BIHARMONIC_SEED, "near_exact", device, **BIHARMONIC)
        sampler = MultigridMCSampler(op, nlevel, smoother="SOR", coarse_solver="Cholesky",
                                     omega=1.0, cycle=2)
        levels = sampler.fused_levels
        noise = GeneratorNoise(BIHARMONIC_SEED + 1, device)
        out["kernel_attributes"] = build_kernel_attributes(reach=2)
        out["smem_kernel_attributes"] = smem_kernel_attributes()
        out["routes"] = {li: {c: levels[li].route(c) for c in SMEM_ROUTE_CHAINS} for li in (0, 1)}
        out["pass_stamps"] = [reach2_pass_stamps(levels[li], li, C, noise, "phase")
                              for li in (0, 1)]
        emit(dict(out, partial=True))
        out["smem_checks"] = [check_phase_only_level(levels[li], f"L{li}", c, gen, route="smem")
                              for li in (0, 1) for c in (C, 1)]
        two = biharmonic_ssor_levels(sampler)
        out["smem_ssor_checks"] = [check_ssor_level(two[li], f"biharmonic L{li}", C, gen, "smem",
                                                    own_route=False) for li in (0, 1)]
        if table:
            out["smem_pass_stamps"] = [reach2_pass_stamps(levels[li], li, c, noise, "smem")
                                       for c in (C, 1) for li in (0, 1)]
            out["smem_table"] = time_smem_variants({"L0": levels[0], "L1": levels[1]}, noise)
    except BaseException:
        out["failed"] = True
        raise
    finally:
        emit(out)


def build_kernel_attributes(reach=2, dim=2):
    """Registers, local (spill) bytes and static shared bytes per thread of the
    kernels of the phase kernels' reach-2 (or 3d) build, by stencil form."""
    import ctypes

    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    lib = mv.load_library(reach=reach, dim=dim)
    _, _, form0, nforms, _, _ = mv.PHASE_BUILDS[(reach, dim)]
    out = {}
    for form in range(form0, form0 + nforms):
        for (kind, descend), ndir in itertools.product((("descend", 1), ("ascend", 0)), (1, 2)):
            vals = (ctypes.c_int * 3)()
            err = lib.mgmc_visit_kernel_attributes(descend, form, ndir, vals)
            if err:
                raise AssertionError(f"form {form} {kind} kernel attributes: CUDA error {err}")
            out[f"{kind}{' ssor' if ndir == 2 else ''} form {form}"] = {
                "registers": vals[0], "local_bytes": vals[1], "static_shared_bytes": vals[2]}
    return out


def check_setup_sweeps(shapes, gen):
    """Every deterministic sweep a distillation set-up launched
    (:func:`distill_sweep_shapes`), at its own shape, chain count, colour
    order, route and ``b`` (shared or per chain), against the plain sweep with
    the noise off, as the set-up runs it (TOL), and, where its body is not the
    generic one, against the generic body of ``sor_sweep.cu`` on the same
    inputs (ROUTE_TOL).  One row per shape."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    rows = []
    for d in shapes:
        plan, C = d["plan"], d["chains"]
        op = plan.op
        x = torch.randn((C,) + op.vshape, device=op.coeffs.device, generator=gen)
        b = torch.randn(((C,) if d["b_batched"] else ()) + op.vshape, device=op.coeffs.device,
                        generator=gen)
        want = ss.sweep_batched_plain(op, plan.masks, plan.omega, plan.order, b, x)
        got = ss.launch_sweep(plan, d["route"], b, x.clone())
        tag = (f"set-up sweep {tuple(op.vshape)} C={C} order {d['order']} "
               f"b_batched={d['b_batched']}")
        row = {"vshape": d["vshape"], "chains": C, "b_batched": d["b_batched"],
               "order": d["order"], "route": list(d["route"]), "body": plan.body,
               "offsets": len(op.offsets), "colours": plan.coloring.n_colors,
               "launches": d["launches"], "max_abs_err": compare(tag, got, want)}
        del want
        if plan.body != "generic" and d["route"][0] == "block":
            old = ss.launch_sweep(plan, d["route"], b, x.clone(), body="generic")
            row["against_generic"] = float((got - old).abs().max())
            del old
            if row["against_generic"] > ROUTE_TOL:
                raise AssertionError(f"{tag}: the {plan.body} and the generic body differ by "
                                     f"{row['against_generic']}")
        rows.append(row)
        del x, b, got
    torch.cuda.synchronize()
    return rows


def check_distill_setup(op, nlevel, sampler, main, gen, label):
    """The distillation set-up's sweeps of ``op``'s default sampler
    (``sampler``, whose main path ``main`` is :func:`drive_sampler`'s record)
    at their own shapes (:func:`check_setup_sweeps`).  They must run on the
    shared-memory body, on the levels below the distilled one down to the
    coarsest (exclusive), and their launches must be those of the main path's
    set-up.  Returns the rows."""
    ops = sampler.hierarchy.operators
    below = {tuple(o.vshape) for o in ops[main["distill_level"]:nlevel - 1]}
    del ops
    level, _, setup = distill_sweep_shapes(op, nlevel)
    rows = check_setup_sweeps(setup, gen)
    del setup
    counted = sum(v for k, v in main["setup_sweep_launches"].items()
                  if k.startswith("sweep_batched"))
    if (level != main["distill_level"] or {r["body"] for r in rows} != {"smem"}
            or {tuple(r["vshape"]) for r in rows} != below
            or sum(r["launches"] for r in rows) != counted):
        raise AssertionError(f"{label} set-up sweeps: distilled at {level}, {rows}, the main "
                             f"path's set-up {counted} launches")
    return rows


def check_nine_colour_sweeps(op, C, gen):
    """Both sweep kernels on a 9-colour level (the 25-point Galerkin level of
    the biharmonic hierarchy) against their plain versions, forward and
    backward, ``b`` shared and per chain, noise off and the same ``xi``: the
    one-block route's shared-memory body at ``C`` chains (and its in-kernel
    normals against the host's reference) and the generic body beside it
    (against the plain versions, TOL, and the shared-memory body against it
    on the same inputs and under one Philox stream, ROUTE_TOL), the split
    route at one chain and at :data:`SPLIT_CHECK_CHAINS` (TOL), and the split
    against the one-block route under one Philox stream (ROUTE_TOL)."""
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import BACKWARD, FORWARD, SORSmoother

    device = op.coeffs.device
    errs = {"sweep_batched_smem": 0.0, "gibbs_sweep_batched_smem": 0.0,
            "sweep_batched_generic": 0.0, "gibbs_sweep_batched_generic": 0.0,
            "sweep_batched_split": 0.0, "gibbs_sweep_batched_split": 0.0}
    route_err = body_err = 0.0
    for direction in (FORWARD, BACKWARD):
        plan = SORSmoother(op, 1.0, 1, direction).plan
        if plan.coloring.n_colors != 9 or plan.body != "smem":
            raise AssertionError(f"nine-colour sweeps: {plan.coloring.n_colors} colours, "
                                 f"body {plan.body}")
        for Cs, routes in ((C, (ss.BLOCK_ROUTE,)), (1, None), (SPLIT_CHECK_CHAINS, None)):
            if routes is None:
                sizes = [ss.split_size(Cs, op.vshape, op.offsets, mode, device) for mode in (0, 1)]
                if None in sizes:
                    raise AssertionError(f"nine-colour sweeps: {Cs} chains do not split")
                routes = (("split", sizes[0]), ("split", sizes[1]))
            det_route, gibbs_route = routes[0], routes[-1]
            bodies = ("smem", "generic") if det_route[0] == "block" else (None,)
            x = torch.randn((Cs,) + op.vshape, device=device, generator=gen)
            xi = torch.randn((Cs,) + op.vshape, device=device, generator=gen)
            for b_batched in (False, True):
                b = torch.randn(((Cs,) if b_batched else ()) + op.vshape, device=device,
                                generator=gen)
                tag = f"nine colours {direction} C={Cs} {det_route[0]} b_batched={b_batched}"
                stream = (0x5EED_0013 + Cs, 3 + b_batched)
                got = {}
                want = {"sweep": ss.sweep_batched_plain(op, plan.masks, 1.0, plan.order, b, x),
                        "gibbs": ss.gibbs_sweep_batched_plain(op, plan.masks, 1.0, plan.order,
                                                              b, x, xi)}
                for body in bodies:
                    suffix = "_split" if body is None else "_" + body
                    got["sweep", body] = ss.launch_sweep(plan, det_route, b, x.clone(), body=body)
                    errs["sweep_batched" + suffix] = max(
                        errs["sweep_batched" + suffix],
                        compare(f"sweep {tag} {body}", got["sweep", body], want["sweep"]))
                    got["gibbs", body] = ss.launch_gibbs_sweep(plan, gibbs_route, b, x.clone(),
                                                               xi=xi, body=body)
                    errs["gibbs_sweep_batched" + suffix] = max(
                        errs["gibbs_sweep_batched" + suffix],
                        compare(f"gibbs sweep {tag} {body}", got["gibbs", body], want["gibbs"]))
                    got["philox", body] = ss.launch_gibbs_sweep(plan, gibbs_route, b, x.clone(),
                                                                philox=stream, body=body)
                del want
                if det_route[0] == "split":
                    block = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(),
                                                  philox=stream)
                    route_err = max(route_err, float((got["philox", None] - block).abs().max()))
                    continue
                body_err = max([body_err] + [float((got[k, "smem"] - got[k, "generic"])
                                                   .abs().max())
                                             for k in ("sweep", "gibbs", "philox")])
                for first, n in noise_check_chains(Cs):
                    part = slice(first, first + n)
                    ref = torch.as_tensor(common.philox_normals_reference(
                        *stream, n, op.vshape, first_chain=first), device=device)
                    want = ss.gibbs_sweep_batched_plain(op, plan.masks, 1.0, plan.order,
                                                        b[part] if b_batched else b, x[part], ref)
                    errs["gibbs_sweep_batched_smem"] = max(
                        errs["gibbs_sweep_batched_smem"],
                        compare(f"gibbs sweep {tag} in-kernel noise", got["philox", "smem"][part],
                                want))
                del got
    torch.cuda.synchronize()
    if route_err > ROUTE_TOL or body_err > ROUTE_TOL:
        raise AssertionError(f"nine-colour sweeps: the split and one-block routes differ by "
                             f"{route_err}, the shared-memory and generic bodies by {body_err}")
    return errs, route_err, body_err


def smem_sweep_stamps(plan, C, b_batched, noise):
    """One launch of each kernel of the shared-memory body's stamps build at
    ``C`` chains (the Gibbs kernel with its in-kernel noise), by pass: the
    copy-in (with the Gibbs rhs) and each colour, the median over the blocks
    (:func:`sor_sweep.sweep_pass_times`), the barriers each block passed
    against :func:`sor_sweep.barrier_count`, the blocks one SM ran at once; the
    kernels' registers and the blocks per SM the occupancy API gives."""
    import ctypes

    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    device = plan.op.coeffs.device
    b = torch.rand(((C,) if b_batched else ()) + plan.op.vshape, device=device)
    x = torch.zeros((C,) + plan.op.vshape, device=device)
    out = {}
    for kind, gibbs in (("sweep", False), ("gibbs", True)):
        runs = []
        for _ in range(3):
            stamps = torch.zeros((C, ss.SWEEP_STAMP_WIDTH), dtype=torch.int64, device=device)
            if gibbs:
                ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x, philox=noise.philox_stream(),
                                      body="smem", stamps=stamps)
            else:
                ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x, body="smem", stamps=stamps)
            torch.cuda.synchronize()
            runs.append(ss.sweep_pass_times(plan.order, gibbs, stamps, body="smem"))
        pt = sorted(runs, key=lambda r: r["launch_span_us"])[1]
        pt["barriers_from_source"] = ss.barrier_count(plan.order, gibbs, body="smem")
        if pt["barriers_per_block"] != [pt["barriers_from_source"]]:
            raise AssertionError(f"shared-memory sweep {kind}: barriers {pt['barriers_per_block']}"
                                 f" against {pt['barriers_from_source']} from the source")
        launch = plan.smem_launch(plan.params(C, b_batched, 1 if gibbs else 0, None))
        lib = ss.load_smem_library()
        vals = (ctypes.c_int * 3)()
        if lib.sor_smem_kernel_attributes(int(gibbs), launch.kmax, vals):
            raise AssertionError(f"shared-memory sweep {kind}: kernel attributes")
        pt.update({"threads": launch.threads, "smem_bytes": launch.nbytes, "kmax": launch.kmax,
                   "registers": vals[0], "local_bytes": vals[1],
                   "blocks_per_sm_occupancy_api": lib.sor_smem_blocks_per_sm(
                       int(gibbs), launch.kmax, launch.threads, launch.nbytes)})
        out[kind] = pt
    del b, x
    return out


def time_block_sweeps(op, C, b_batched, noise, one_chain=True):
    """ms per launch of both sweep kernels on a level of the distillation
    set-up (the biharmonic hierarchy's 9-colour 63^2 and 31^2, the 3d one's
    15^3): at ``C`` chains with ``b`` per chain or shared (``b_batched``; the distillation
    set-up's shape) the one-block route's shared-memory body and its generic
    body in the same windows, and (``one_chain``) at one chain (the split
    route, the rule's cluster size), events and device time (held to each
    other), the plain versions and the bound; the shared-memory body's launch
    by pass from its stamps build (:func:`smem_sweep_stamps`)."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import SORSmoother

    device = op.coeffs.device
    plan = SORSmoother(op, 1.0, 1).plan
    rows = []
    for Cs, bb in ((C, b_batched),) + (((1, True),) if one_chain else ()):
        b = torch.rand(((Cs,) if bb else ()) + op.vshape, device=device)
        x = torch.zeros((Cs,) + op.vshape, device=device)
        bound, by, nbytes = sweep_bound(plan, Cs, bb)
        routes = {"sweep": plan.route(Cs, 0), "gibbs": plan.route(Cs, 1)}
        if Cs == 1:  # the split route at its rule's cluster size, whatever the route
            routes = {kind: ("split", ss.split_size(1, op.vshape, op.offsets, mode, device))
                      for kind, mode in (("sweep", 0), ("gibbs", 1))}
        row = {"chains": Cs, "b_batched": bb, "vshape": list(op.vshape),
               "offsets": len(op.offsets), "colours": plan.coloring.n_colors, "routes": routes,
               "body": plan.body if routes["sweep"][0] == "block" else None,
               "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes}
        # the set-up's tens of thousands of chains take ms a launch
        big = Cs > BIG_SWEEP_CHAINS
        bodies = ((plan.body, ""), ("generic", "generic_")) if routes["sweep"][0] == "block" \
            else ((None, ""),)
        for kind in ("sweep", "gibbs"):
            fns = {}
            for body, prefix in bodies:
                if kind == "sweep":
                    fns[prefix] = (lambda body=body: ss.launch_sweep(plan, routes["sweep"], b, x,
                                                                      body=body))
                else:
                    fns[prefix] = (lambda body=body: ss.launch_gibbs_sweep(
                        plan, routes["gibbs"], b, x, philox=noise.philox_stream(), body=body))
            device_ms = device_ms_medians(
                {prefix: (fn, sweep_kernel(routes[kind], body or "generic", kind))
                 for (body, prefix), fn in zip(bodies, fns.values())}, 4 if big else 20)
            for (body, prefix), fn in zip(bodies, fns.values()):
                host = {}
                row[f"{prefix}{kind}_ms"] = cuda_ms(fn, 5, 50 if Cs == 1 else (2 if big else 10),
                                                    host)
                row[f"{prefix}{kind}_device_ms"] = device_ms[prefix]
                row[f"{prefix}{kind}_events_over_device"] = check_events_against_device(
                    f"{tuple(op.vshape)} {prefix}{kind} C={Cs}", row[f"{prefix}{kind}_ms"],
                    row[f"{prefix}{kind}_device_ms"], host["ms"])
        x.zero_()
        row["sweep_plain_ms"] = cuda_ms(
            lambda: ss.sweep_batched_plain(op, plan.masks, 1.0, plan.order, b, x), 3,
            1 if big else 3)
        row["gibbs_plain_ms"] = cuda_ms(
            lambda: ss.gibbs_sweep_batched_plain(op, plan.masks, 1.0, plan.order, b, x,
                                                 torch.randn_like(x)), 3, 1 if big else 3)
        if row["body"] == "smem":
            row["stamps"] = smem_sweep_stamps(plan, Cs, bb, noise)
        rows.append(row)
        del b, x
    return rows


def drive_sampler(op, f, C, steps, kwargs, levels_are=None, sampler=None, busy_steps=4):
    """Build the sampler (unless ``sampler`` is given: then no set-up is
    timed) with the launch counts set to 0, take two warm-up
    steps, set the visit counts to 0 again and take ``steps`` timed steps:
    set-up seconds and the sweep launches of the set-up, ms per step,
    samples/s, the visit launches of the timed steps, the route of each visited
    level, the device's kernel ms and launches per step (profiler windows of
    ``busy_steps`` steps more: the median of three that recorded every visit
    launch).
    The counts must show every visit of a visited level under its kernel's name
    and no other visit kernel a launch, and with ``subtree=True`` one subtree
    launch a step; ``levels_are``, where given, must hold for every visited
    level (the reach-2 or the 3d kernels took them)."""
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    device = op.coeffs.device
    for module in (mv, ss, st, common):
        module.reset_launch_counts()
    setup_seconds, setup_sweeps = None, {}
    if sampler is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler = MultigridMCSampler(op, **kwargs)
        torch.cuda.synchronize()
        setup_seconds = time.perf_counter() - t0
        setup_sweeps = dict(ss.launch_counts)
    noise = GeneratorNoise(BIHARMONIC_SEED, device)
    x = torch.zeros((C,) + op.vshape, dtype=torch.float32, device=device)
    for _ in range(2):
        x = sampler.apply(noise, f, x)
    torch.cuda.synchronize()
    mv.reset_launch_counts()
    st.reset_launch_counts()
    ss.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        x = sampler.apply(noise, f, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(mv.launch_counts)
    sweep_launches = {k: v for k, v in ss.launch_counts.items() if v}
    subtree_launches = {k: v for k, v in st.launch_counts.items() if v}
    if tuple(x.shape) != (C,) + op.vshape or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{kwargs}: samples not finite or of wrong shape")
    if sum(subtree_launches.values()) != (steps if sampler.subtree is not None else 0):
        raise AssertionError(f"{kwargs}: subtree launches {subtree_launches} in {steps} steps")
    below = (sampler.distill_level if sampler.distilled is not None else
             1 if sampler.subtree is not None else sampler.nlevel)
    visited = [li for li in sorted(sampler.fused_levels) if li < below]
    routes = {li: sampler.fused_levels[li].route(C) for li in visited}
    names = {li: {kind: mv.kernel_name(sampler.fused_levels[li], routes[li], kind)
                  for kind in ("descend", "ascend")} for li in visited}
    expected = {}
    for li in visited:
        for name in names[li].values():
            expected[name] = expected.get(name, 0) + steps * 2 ** li
    wrong = {name: n for name, n in counts.items() if n != expected.get(name, 0)}
    if wrong or (levels_are and not all(levels_are(sampler.fused_levels[li]) for li in visited)):
        raise AssertionError(f"{kwargs}: visit launches {counts}, expected {expected}")
    # a profiler window can record a part of its launches, or none at all:
    # only windows that show every visit launch of their steps count, the
    # median of three, out of at most BUSY_WINDOWS
    per_step = sum(expected.values()) / steps
    windows, complete, empty = [], [], 0
    while len(windows) + empty < BUSY_WINDOWS and len(complete) < 3:
        busy = device_busy(lambda: sampler.apply(noise, f, x), busy_steps,
                           pattern=r"trsm|triang|visit_kernel|volume_kernel|descend_kernel"
                                   r"|ascend_kernel|mgmc_subtree_kernel")
        if busy is None:
            empty += 1
            continue
        busy["visit_calls_per_step"] = sum(r["calls_per_step"] for r in busy["matching"]
                                           if re.search(r"visit_kernel|volume_kernel|"
                                                        r"descend_kernel|ascend_kernel",
                                                        r["name"]))
        windows.append(busy)
        if busy["visit_calls_per_step"] == per_step:
            complete.append(busy)
    if windows and not complete:
        raise AssertionError(f"{kwargs}: no profiler window of {len(windows)} recorded the "
                             f"{per_step} visit launches a step: "
                             f"{[w['visit_calls_per_step'] for w in windows]} "
                             f"({empty} windows recorded nothing)")
    busy = None
    if complete:
        busy = sorted(complete, key=lambda w: w["kernel_ms_per_step"])[len(complete) // 2]
        busy.update({"windows": len(windows), "complete_windows": len(complete),
                     "empty_windows": empty,
                     "kernel_ms_per_step_windows": [w["kernel_ms_per_step"] for w in windows]})
    return sampler, {
        "chains": C, "steps": steps, "setup_seconds": setup_seconds,
        "setup_sweep_launches": {k: v for k, v in setup_sweeps.items() if v},
        "distill_level": sampler.distill_level, "fused_levels": sorted(sampler.fused_levels),
        "visited_levels": visited, "route_by_level": routes,
        "stencil_form_by_level": {li: sampler.fused_levels[li].stencil_form for li in visited},
        "colours_by_level": {li: sampler.fused_levels[li].coloring.n_colors for li in visited},
        "ms_per_step": 1e3 * dt / steps, "samples_per_s": C * steps / dt,
        "kernel_ms_per_step": None if busy is None else busy["kernel_ms_per_step"],
        "launches_per_step": None if busy is None else busy["kernels_per_step"],
        "device_busy": busy, "launches": {k: v for k, v in counts.items() if v},
        "sweep_launches": sweep_launches,
        "subtree_launches": subtree_launches, "sample_std": float(x.std())}


def biharmonic_gate(device):
    """The statistical gate of ``native/validate_biharmonic_tpu.py``: the 64x64
    biharmonic posterior (3 levels, variances 1e-2 (1 + u)), 256 chains, the
    zero-mean protocol (f = 0 from x = 0: the fluctuation about the posterior
    mean), twice: every non-coarsest level fused on the reach-2 phase kernels
    (``"phase_kernels"``), and level 0 fused with everything below it in one
    launch of the subtree kernel's reach-2 build (``"subtree_kernel"``).  The
    mean and the variance of ``z = <w, x>`` (a point observation) and of the
    first measurement's own functional ``B_0^T x`` within 4 standard errors of
    0 and of ``w^T Q^-1 w`` from the dense float64 solve."""
    from multigridmc_tpu_torch.models.posterior import measurement_vector
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    g = BIHARMONIC_GATE
    op, _ = build_posterior(g["nx"], 8, BIHARMONIC_GATE_SEED, 1e-2, device, **BIHARMONIC)
    observations = {"point": measurement_vector(op.lattice, np.array([0.45, 0.55]), 0.1),
                    "measurement_0": op.lowrank.B[0].double().cpu().numpy()}
    Wt = np.stack([w.reshape(-1) for w in observations.values()], axis=1)
    exact = np.einsum("nk,nk->k", Wt, np.linalg.solve(op.to_dense(), Wt))
    W = torch.as_tensor(Wt.T, dtype=torch.float64, device=device)
    C = 256
    out = {}
    for name, subtree in (("phase_kernels", False), ("subtree_kernel", True)):
        sampler = MultigridMCSampler(op, g["nlevel"], smoother="SOR", cycle=2, fused=True,
                                     fused_min_vertices=0, distill=False, subtree=subtree)
        if sorted(sampler.fused_levels) != list(range(g["nlevel"] - 1)) or (
                subtree and sampler.subtree.reach != 2):
            raise AssertionError(f"biharmonic gate: fused levels {sorted(sampler.fused_levels)}")
        mv.reset_launch_counts()
        st.reset_launch_counts()
        noise = GeneratorNoise(BIHARMONIC_GATE_SEED, device)
        fz = torch.zeros(op.vshape, device=device)
        x = torch.zeros((C,) + op.vshape, device=device)
        for _ in range(g["warmup"]):
            x = sampler.apply(noise, fz, x)
        zs = []
        for _ in range(g["steps"]):
            x = sampler.apply(noise, fz, x)
            zs.append(x.reshape(C, -1).double() @ W.T)
        z = torch.stack(zs).cpu().numpy()  # (steps, chains, observations)
        label = f"biharmonic 64x64 {name}"
        res = out[name] = moments_gate(label, z[:, :, 0], 0.0, float(exact[0]), C)
        res.update({"lattice": [g["nx"], g["nx"]], "nlevel": g["nlevel"], "chains": C,
                    "warmup": g["warmup"], "steps": g["steps"], "exact_variance": float(exact[0]),
                    "launches": {k: v for k, v in mv.launch_counts.items() if v},
                    "subtree_launches": {k: v for k, v in st.launch_counts.items() if v},
                    "colours_by_level": {li: lv.coloring.n_colors
                                         for li, lv in sampler.fused_levels.items()}})
        res["measurement_0"] = moments_gate(f"{label} B_0^T x", z[:, :, 1], 0.0,
                                            float(exact[1]), C)
        res["measurement_0"]["exact_variance"] = float(exact[1])
        gated = (0,) if subtree else (0, 1)
        want = tuple(mv.kernel_name(sampler.fused_levels[li], sampler.fused_levels[li].route(C),
                                    "descend") for li in gated)
        res["routes_by_level"] = {li: sampler.fused_levels[li].route(C) for li in gated}
        if not all(res["launches"].get(n, 0) > 0 for n in want) or res["subtree_launches"] != (
                {"subtree_sample_reach2": g["warmup"] + g["steps"]} if subtree else {}):
            raise AssertionError(f"{label} gate: launches {res['launches']}, subtree launches "
                                 f"{res['subtree_launches']}")
    return out


def write_prior_configs(directory, nx_bih, nx_fem, nlevel, nchains, nsamples, nwarmup):
    """``params_biharmonic.cfg`` (the squared shifted-Laplace prior, the
    bench's 8 measurements, ``nx_bih``) and ``params_fem.cfg`` (the FEM prior,
    the flagship's measurements, ``nx_fem``), SOR multigrid, each with its own
    measurements file."""
    rng = np.random.default_rng(BIHARMONIC_SEED)
    bih = (rng.uniform(0.1, 0.9, size=(8, 2)), rng.normal(size=8),
           1e-6 * (1.0 + rng.uniform(size=8)))
    rng = np.random.default_rng(FLAGSHIP_SEED)
    fem = (rng.uniform(0.1, 0.9, size=(8, 2)), rng.normal(2.0, 1.0, size=8),
           1e-6 * (1.0 + rng.uniform(size=8)))

    def listing(values):
        return "[" + ", ".join(repr(float(v)) for v in np.asarray(values).reshape(-1)) + "]"

    for name, nx, pdemodel, smoother, (loc, mean, var) in (
            ("biharmonic", nx_bih, "squared_shiftedlaplace_fd", "SOR", bih),
            ("fem", nx_fem, "shiftedlaplace_fem", "SOR", fem)):
        with open(os.path.join(directory, f"measurements_{name}.cfg"), "w") as out:
            out.write(f"dim = 2;\nn = 8;\nmeasurement_locations = {listing(loc)};\n"
                      f"mean = {listing(mean)};\nvariance = {listing(var)};\n")
        text = DRIVER_CONFIG.format(
            nx=nx, nlevel=nlevel, smoother=smoother, nchains=nchains, nsamples=nsamples,
            nwarmup=nwarmup, do_cholesky="false", do_ssor="false", schedule="",
            cholesky='cholesky = { factorisation = "dense"; }')
        text = text.replace('pdemodel = "shiftedlaplace_fd"', f'pdemodel = "{pdemodel}"')
        text = text.replace('filename = "measurements.cfg"',
                            f'filename = "measurements_{name}.cfg"')
        with open(os.path.join(directory, f"params_{name}.cfg"), "w") as out:
            out.write(text)


#: the lattice of the biharmonic driver run, the bench's: the drivers' exact
#: moments solve a 2d lattice above 4096 unknowns by a float64 band Cholesky
#: on the host (bandwidth 2 x 255 at 255^2; CG did not converge there)
BIHARMONIC_DRIVER_NX = 256
#: the band solve of the exact moments: the largest relative residual
#: ``||B_k - A x_k|| / ||B_k||`` it may leave on the measurement columns
BAND_SOLVE_RESIDUAL = 1e-10


def band_solve_residual(nx):
    """The drivers' exact-moment solve (``models.posterior._default_stencil_solve``,
    the solve the driver takes: above ``DENSE_SOLVE_MAX_N`` unknowns in 2d the
    band Cholesky of ``ops.band``, float64 on the host) on the biharmonic
    driver config's stencil, held to its float64 stencil: the largest relative
    residual over the measurement columns, and the seconds of the
    factorisation and solve."""
    import dataclasses

    from multigridmc_tpu_torch.models import posterior

    op, _ = build_posterior(nx, 8, BIHARMONIC_SEED, "near_exact", "cpu", dtype=torch.float64,
                            **BIHARMONIC)
    m = op.m_lowrank
    B = op.lowrank.B.numpy().reshape((m,) + op.vshape)
    t0 = time.perf_counter()
    solve = posterior._default_stencil_solve(op)
    X = solve(B)
    seconds = time.perf_counter() - t0
    if op.lattice.nvertex <= posterior.DENSE_SOLVE_MAX_N or solve.__name__ != "solve_band":
        raise AssertionError(f"exact moments at {nx - 1}^2: the driver's solve is "
                             f"{solve.__name__}, not the band solve")
    AX = dataclasses.replace(op, lowrank=None).apply(torch.as_tensor(X)).reshape(m, -1).numpy()
    B = B.reshape(m, -1)
    rel = float((np.linalg.norm(B - AX, axis=1) / np.linalg.norm(B, axis=1)).max())
    if not rel <= BAND_SOLVE_RESIDUAL:
        raise AssertionError(f"exact moments at {nx - 1}^2: the band solve leaves a relative "
                             f"residual of {rel} (limit {BAND_SOLVE_RESIDUAL})")
    return {"solve": solve.__name__, "relative_residual": rel, "seconds": seconds}


def prior_drivers(device, nlevel, nchains):
    """``mgmc-sample-torch`` on the biharmonic and the FEM configuration
    (MGMC alone: the one-chain time series, the convergence table over
    ``nchains`` replicas, the posterior statistics) and ``mgmc-solve-torch`` on
    the FEM one: the report lines, the MGMC mean within 5 error bars (widened
    by the autocorrelation time) of the exact one, the visit launches of each
    prior's kernels; the solve converges."""
    from multigridmc_tpu_torch.drivers import mg as driver_mg
    from multigridmc_tpu_torch.drivers import mgmc as driver_mgmc
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    out = {}
    nsamples, nwarmup = 400, 100
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        write_prior_configs(work, BIHARMONIC_DRIVER_NX, 256, nlevel, nchains, nsamples, nwarmup)
        os.chdir(work)
        try:
            # the one-chain series: the 13-point level 0 and the 25-point level
            # 1 on the reach-2 kernels of the route the rule takes (the smem
            # kernels where their table lists the level, else the phase
            # kernels' build), the FEM prior's on the split kernels; the
            # replica chains of the FEM convergence table the phase kernels.
            # Each level's visits launched on one of its routes.
            reach2 = [tuple(mv.REACH2_NAMES[("descend", box, route)] for route in
                            ("phase", mv.SMEM_ROUTE)) for box in (False, True)]
            for name, visits in (("biharmonic", reach2),
                                 ("fem", (("descend_visit_split",), ("descend_visit",)))):
                mv.reset_launch_counts()
                ss.reset_launch_counts()
                t0 = time.perf_counter()
                text = run_driver(driver_mgmc.main, [f"params_{name}.cfg"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                print("\n".join(line for line in text.splitlines()
                                if re.search(r"time per sample|mean  |variance =|setup time",
                                             line)), flush=True)
                series = np.loadtxt("timeseries_multigridmc.txt")
                if series.shape != (nsamples,) or not np.isfinite(series).all():
                    raise AssertionError(f"drivers ({name}): the time series is not {nsamples} "
                                         "finite values")
                ms = re.search(r"multigridmc time per sample =\s+(\S+) ms", text)
                mean = re.search(r"multigridmc mean\s+=\s+(\S+) \+/-\s+(\S+)", text)
                exact = float(re.search(r"exact mean\s+=\s+(\S+)", text).group(1))
                res = {"lattice": BIHARMONIC_DRIVER_NX if name == "biharmonic" else 256,
                       "seconds": seconds, "ms_per_sample": float(ms.group(1)),
                       "mean": float(mean.group(1)), "mean_error": float(mean.group(2)),
                       "exact_mean": exact, "iact": integrated_autocorrelation_time(series),
                       "launches": {k: v for k, v in {**mv.launch_counts,
                                                      **ss.launch_counts}.items() if v}}
                res["mean_bar"] = 5.0 * res["mean_error"] * np.sqrt(max(res["iact"], 1.0))
                if abs(res["mean"] - exact) > res["mean_bar"]:
                    raise AssertionError(f"drivers ({name}): MGMC mean {res['mean']} is further "
                                         f"than {res['mean_bar']} from the exact mean {exact}")
                if not all(any(mv.launch_counts[v] > 0 for v in names) for names in visits):
                    raise AssertionError(f"drivers ({name}): visit launches {mv.launch_counts}")
                if name == "biharmonic":
                    res["exact_moments_band_solve"] = band_solve_residual(BIHARMONIC_DRIVER_NX)
                out[f"mgmc_{name}"] = res
            ss.reset_launch_counts()
            t0 = time.perf_counter()
            text = run_driver(driver_mg.main, ["params_fem.cfg"])
            torch.cuda.synchronize()
            rows = richardson_table(text)
            if "Solver converged" not in text or not rows:
                raise AssertionError("drivers.mg (fem): the Richardson iteration did not "
                                     "converge:\n" + text[-2000:])
            out["mg_fem"] = {"seconds": time.perf_counter() - t0, "iterations": len(rows) - 1,
                             "relative_residual": rows[-1][2],
                             "contraction_rates": [r[3] for r in rows[1:]],
                             "launches": {k: v for k, v in ss.launch_counts.items() if v}}
        finally:
            os.chdir(cwd)
    return out


def phase_biharmonic(device, nlevel, C, n_meas, smi):
    """The squared shifted-Laplace (biharmonic) and FEM priors on the card:

    * the reach-2 phase kernels on the biharmonic posterior's levels 0 (255^2,
      13-point, 5 colours) and 1 (127^2, 25-point Galerkin, 9 colours) at ``C``
      chains against their plain versions (:func:`check_phase_only_level`), their
      times (:func:`time_phase_only_level`), registers and spills;
    * every sweep its distillation set-up launches, at the set-up's shapes
      (:func:`check_setup_sweeps`: both 9-colour levels, 63^2 and 31^2), and
      both sweep kernels on the 9-colour 63^2 level at the set-up's chain
      count (:func:`check_nine_colour_sweeps`, :func:`time_block_sweeps`, also on the set-up's 31^2 level);
    * the full-width sampler (5 levels, W-cycle, SOR, the default ``distill``,
      ``C`` chains, :data:`BIHARMONIC_STEPS` steps) through
      ``MultigridMCSampler.apply``: levels 0 and 1 on the reach-2 phase
      kernels, the launches of each form, ms/step, samples/s, kernel ms and
      launches per step, set-up seconds;
    * the FEM prior under the flagship's measurements at ``C`` chains,
      :data:`FEM_STEPS` steps;
    * the same biharmonic sampler with ``subtree=True`` (:func:`drive_sampler`):
      level 0 on the reach-2 phase kernels, the rest in one launch of the
      subtree kernel's reach-2 build a step; the kernel against its plain
      version (:func:`check_subtree`), its times by operation and by block
      size and placement (:func:`time_subtree`,
      :data:`BIHARMONIC_SUBTREE_VARIANTS`);
    * the 64x64 statistical gate (:func:`biharmonic_gate`), on the phase
      kernels and with the subtree kernel;
    * the drivers on both priors (:func:`prior_drivers`).

    Returns the errors and the times the ``kernels`` line reports, and the
    launches of the full-width run and of its set-up; the line is printed
    also where a part fails, with what was found up to there."""
    out = {"phase": "biharmonic", "card": smi}
    try:
        _biharmonic_parts(out, device, nlevel, C, n_meas)
    except BaseException:
        out["failed"] = True
        raise
    finally:
        emit(out)
    return out


def _biharmonic_parts(out, device, nlevel, C, n_meas):
    """The parts of :func:`phase_biharmonic`, each filling its key of ``out``."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise

    t0 = time.perf_counter()

    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    op, _ = build_posterior(256, 8, BIHARMONIC_SEED, "near_exact", device, **BIHARMONIC)
    f = torch.as_tensor(np.random.default_rng(0).uniform(size=op.vshape), dtype=torch.float32,
                        device=device)
    kwargs = dict(nlevel=nlevel, smoother="SOR", coarse_solver="Cholesky", omega=1.0, cycle=2)
    sampler, main = drive_sampler(op, f, C, BIHARMONIC_STEPS, kwargs,
                                  levels_are=lambda lv: lv.reach == 2)
    if main["distill_level"] != 2 or main["visited_levels"] != [0, 1]:
        raise AssertionError(f"biharmonic: {main}")
    out["main_path"] = main
    levels = sampler.fused_levels
    noise = GeneratorNoise(BIHARMONIC_SEED + 1, device)
    out["kernel_attributes"] = build_kernel_attributes(reach=2)
    out["smem_kernel_attributes"] = smem_kernel_attributes()
    # both designs by pass at C chains: the phase kernels' reach-2 stamps build
    # (the parent's design), the smem kernels' stamps build
    out["pass_stamps"] = [reach2_pass_stamps(levels[li], li, C, noise, route)
                          for route in ("phase", "smem") for li in (0, 1)]
    out["checks"] = [check_phase_only_level(levels[li], f"L{li}", C, gen) for li in (0, 1)]
    out["smem_checks"] = [check_phase_only_level(levels[li], f"L{li}", C, gen, route="smem")
                          for li in (0, 1)]
    two = biharmonic_ssor_levels(sampler)
    out["smem_ssor_checks"] = [check_ssor_level(two[li], f"biharmonic L{li}", C, gen, "smem",
                                                own_route=False) for li in (0, 1)]
    out["timings"] = [time_phase_only_level(levels[li], C, noise) for li in (0, 1)]
    out["smem_timings"] = [time_phase_only_level(levels[li], C, noise, "smem") for li in (0, 1)]
    out["smem_routes"], route_faults = time_reach2_routes(
        {"L0": levels[0], "L1": levels[1], "L0 ssor": two[0], "L1 ssor": two[1]}, noise)
    del two
    # the distillation set-up's sweeps: every shape it launched, on both
    # 9-colour levels below the distilled level, at the set-up's chain counts
    out["setup_sweeps"] = check_distill_setup(op, nlevel, sampler, main, gen, "biharmonic")
    nine = sampler.hierarchy.operators[main["distill_level"]]
    sampler_ops = list(sampler.hierarchy.operators)
    del sampler, levels
    at = max((r for r in out["setup_sweeps"] if tuple(r["vshape"]) == tuple(nine.vshape)),
             key=lambda r: r["launches"])
    out["nine_colour_sweeps"] = {"vshape": list(nine.vshape), "offsets": len(nine.offsets),
                                 "chains": at["chains"], "b_batched": at["b_batched"]}
    errs, route_err, body_err = check_nine_colour_sweeps(nine, at["chains"], gen)
    errs["sweep_batched_smem"] = max([errs["sweep_batched_smem"]] + [
        r["max_abs_err"] for r in out["setup_sweeps"] if r["colours"] == 9])
    # the set-up's 31^2 level beside, at its own chain count (one block per chain)
    small = min((r for r in out["setup_sweeps"] if r["colours"] == 9),
                key=lambda r: r["vshape"][0])
    small_op = next(o for o in sampler_ops if tuple(o.vshape) == tuple(small["vshape"]))
    out["nine_colour_sweeps"].update({
        "max_abs_err": errs, "split_against_block": route_err, "smem_against_generic": body_err,
        "timings": time_block_sweeps(nine, at["chains"], at["b_batched"], noise),
        "timings_31": time_block_sweeps(small_op, small["chains"], small["b_batched"],
                                              noise, one_chain=False)})
    del nine, small_op, sampler_ops
    fem, _ = build_posterior(256, n_meas, FLAGSHIP_SEED, "near_exact", device,
                             pdemodel="shiftedlaplace_fem")
    _, out["fem_main_path"] = drive_sampler(fem, f, C, FEM_STEPS, kwargs)
    del fem
    # the subtree kernel's reach-2 build: everything below level 0 in one
    # launch, driven as the main path, checked against its plain version on
    # the same hierarchy, timed
    seconds = out["subtree_part_seconds"] = {}
    t1 = time.perf_counter()
    sampler, out["subtree_main_path"] = drive_sampler(
        op, f, C, BIHARMONIC_STEPS, dict(kwargs, subtree=True),
        levels_are=lambda lv: lv.reach == 2)
    if out["subtree_main_path"]["visited_levels"] != [0]:
        raise AssertionError(f"biharmonic subtree: {out['subtree_main_path']}")
    seconds["main_path"] = time.perf_counter() - t1
    out["subtree_max_abs_err"], out["subtree_checks"] = check_subtree(
        device, C, gen, (("biharmonic_levels_1_to_4", lambda: sampler, 25),))
    seconds["checks"] = time.perf_counter() - t1 - sum(seconds.values())
    out["subtree_timing"] = time_subtree(sampler, C, noise, BIHARMONIC_SUBTREE_VARIANTS, (2, 1))
    seconds["timing"] = time.perf_counter() - t1 - sum(seconds.values())
    del sampler
    out["statistics"] = biharmonic_gate(device)
    seconds["gates"] = time.perf_counter() - t1 - sum(seconds.values())
    out["drivers"] = prior_drivers(device, nlevel, C)
    out["seconds"] = time.perf_counter() - t0
    if route_faults:
        raise AssertionError("smem_routes: the rule's route is more than "
                             f"{SMEM_ROUTE_SLACK} times the other's: " + "; ".join(route_faults))


# --------------------------------------------------------------- phase: volume
#: the 3d posterior of ``native/bench_mgmc3d_tpu.py`` and
#: ``native/validate_mgmc3d_tpu.py``: a 64^3 lattice (63^3 unknowns), the
#: shifted-Laplace FD prior with Lambda = 0.2, 8 measurements drawn from this
#: seed (locations uniform in [0.1, 0.9]^3, means normal(2, 1), variances
#: 1e-6 (1 + u)), 4 levels, W-cycle, SOR, omega 1
VOLUME_SEED = 7
VOLUME_NX = 64
VOLUME_NLEVEL = 4
#: the chain counts of the bench, steps per timed variant
VOLUME_CHAINS = (32, 1)
VOLUME_STEPS = 10
#: the gate of ``native/validate_mgmc3d_tpu.py``: zero-mean protocol, 32
#: chains, 30 warm-up steps and 300 steps, the point observation at the centre
VOLUME_GATE = {"chains": 32, "warmup": 30, "steps": 300}
#: the 3d driver config: a 32^3 lattice (31^3 unknowns), one chain
VOLUME_DRIVER_NX = 32


def volume_posterior(nx, device, dtype=torch.float32, near_exact=True):
    """The 3d posterior of the bench on an ``nx^3`` lattice, its measurements
    and the bench's rhs ``f`` (uniform, drawn after the measurements); with
    ``near_exact=False`` the variances are ``0.5 + u``, for the elementwise
    checks.  With near-exact variances the kernel and its plain version take
    the residual's low-rank term ``Sigma^-1 B^T x'`` (``Sigma^-1`` about 1e6) as
    ``t = u + Sigma^-1/2 n``, exact; :func:`near_exact_fc` holds both to a
    float64 visit on the main path's levels."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd

    prior = shiftedlaplace_fd(Lattice((nx, nx, nx)), ConstantCorrelationLengthModel(0.2),
                              device=device, dtype=dtype)
    rng = np.random.default_rng(VOLUME_SEED)
    locations, mean, u = (rng.uniform(0.1, 0.9, size=(8, 3)), rng.normal(2.0, 1.0, size=8),
                          rng.uniform(size=8))
    params = MeasurementParameters(measurement_locations=locations, mean=mean,
                                   variance=1e-6 * (1.0 + u) if near_exact else 0.5 + u)
    op = measured_operator(prior, params)
    f = torch.as_tensor(rng.uniform(size=op.vshape), dtype=dtype, device=device)
    return op, params, f


def check_volume_composed(sampler, li, C, gen, route="phase"):
    """A 3d level's visit kernels of ``route`` (the phase kernels' 3d build or
    the smem kernels) against the composed visit on the sweep kernels under
    one Philox stream (``C`` chains): the descend against the
    presampler's Gibbs sweep kernel with its Woodbury correction, then the
    residual and the restriction; the ascend against the prolongation and the
    postsampler's; the same low-rank normals.  ``x`` within TOL, ``f_c`` by
    :func:`compare_fc`."""
    from multigridmc_tpu_torch.ops.intergrid import prolongate_add, restrict
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    level = sampler.fused_levels[li]
    op, dev = level.op, level.coeffs.device
    f = torch.randn(op.vshape, device=dev, generator=gen)
    x = torch.randn((C,) + op.vshape, device=dev, generator=gen)
    xc = torch.randn((C,) + level.vc, device=dev, generator=gen)
    z = torch.randn((C, op.m_lowrank), device=dev, generator=gen)

    class OneStream:
        """One Philox launch counter and the low-rank normals ``z``."""

        def __init__(self, counter):
            self.counter = counter

        def philox_stream(self):
            return (0x5EED_0013, self.counter)

        def normal(self, shape, dtype, device):
            assert tuple(shape) == tuple(z.shape)
            return z.clone()

    before = dict(ss.launch_counts)
    got_x, got_fc = mv.launch_descend(level, route, f, x.clone(), xi_lr=z,
                                      philox=OneStream(5).philox_stream())
    want_x = sampler.presamplers[li].apply(OneStream(5), f, x.clone())
    want_fc = restrict(f - op.apply(want_x), dim=3)
    got = mv.launch_ascend(level, route, f, x.clone(), xc, xi_lr=z,
                           philox=OneStream(6).philox_stream())
    want = sampler.postsamplers[li].apply(OneStream(6), f,
                                          prolongate_add(level.coarse_scaling, xc, x, dim=3))
    sweeps = {k: v - before.get(k, 0) for k, v in ss.launch_counts.items() if v != before.get(k, 0)}
    if not any(k.startswith("gibbs_sweep_batched") for k in sweeps):
        raise AssertionError(f"volume L{li}: the composed visit launched no Gibbs sweep kernel")
    tag = f"volume L{li} C={C} {route} against the composed visit under one Philox stream"
    return {"level": li, "chains": C, "route": route, "composed_sweeps": sweeps,
            "descend_x": compare(f"descend x {tag}", got_x, want_x),
            "descend_f_c_over_scale": compare_fc(f"descend f_c {tag}", got_fc, want_fc),
            "ascend_x": compare(f"ascend x {tag}", got, want)}


#: the descend's f_c of a float32 visit (kernel and plain version) off a
#: float64 visit on a near-exact level, over its scale max(|f_c|, 1)
NEAR_EXACT_FC_TOL = 1e-4


def near_exact_fc(level, name, C, gen):
    """A check: the descend's ``f_c`` on a main-path level of a near-exact
    posterior (2d or 3d, one sweep or two, ``C`` chains), noise off and with
    the same noise tensors, from the kernel of the level's route and from its
    float32 plain version, each against the plain version of the same level in
    float64 within :data:`NEAR_EXACT_FC_TOL` of that ``f_c``'s scale
    ``max(|f_c|, 1)``.  With the low-rank noise in the rhs and the residual's
    term as ``Sigma^-1 (I - G) B^T x`` (the TPU kernel's form) the kernel read
    1.0% / 19.7% off on the 64^3 posterior's 63^3 / 31^3 levels and the plain
    version 4.7% / 35.9% (PERF.md section 6)."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.smoothers import compute_B_bar

    op, dev = level.op, level.coeffs.device
    nd = level.ndir
    f = torch.randn(op.vshape, device=dev, generator=gen)
    x = torch.randn((C,) + op.vshape, device=dev, generator=gen)
    xi = torch.randn(((nd,) if nd > 1 else ()) + (C,) + op.vshape, device=dev, generator=gen)
    xi_lr = torch.randn((C, nd * op.m_lowrank), device=dev, generator=gen)
    op64, masks64 = op.to(dtype=torch.float64), level.masks.double()
    bbar = {kind: torch.cat([compute_B_bar(op64, masks64, level.omega, order)
                             for order in level.orders(kind)])
            for kind in ("descend", "ascend")}
    exact = mv.FusedVisitLevel(op64, level.coloring, level.omega, level.pre_orders,
                               level.post_orders, bbar["descend"], bbar["ascend"],
                               level.coarse_scaling)
    route = level.route(C)
    out = {"level": name, "vshape": list(op.vshape), "chains": C, "sweeps": nd, "route": route}
    for tag, noise in (("noise_off", (None, None)), ("noise", (xi, xi_lr))):
        _, want = mv.descend_visit_plain(exact, f.double(), x.double(),
                                         *(None if t is None else t.double() for t in noise))
        _, kernel = mv.launch_descend(level, route, f, x.clone(), *noise)
        _, plain = mv.descend_visit_plain(level, f, x, *noise)
        torch.cuda.synchronize()
        scale = max(float(want.abs().max()), 1.0)
        res = {"f_c_scale": scale,
               "kernel_against_float64": float((kernel.double() - want).abs().max()) / scale,
               "plain_against_float64": float((plain.double() - want).abs().max()) / scale}
        out[tag] = res
        if max(res["kernel_against_float64"], res["plain_against_float64"]) > NEAR_EXACT_FC_TOL:
            raise AssertionError(f"near-exact f_c {name} C={C} {tag}: {res}, more than "
                                 f"{NEAR_EXACT_FC_TOL} of its scale off float64")
    del exact
    return out


#: the gate's reading of B_0^T x with the sweep's low-rank noise in the rhs
#: (the TPU kernel's arithmetic; PERF.md section 6, NVIDIA H100 80GB HBM3,
#: 700.00 W): then read, not gated
B0_BEFORE = {"variance": 1.4481989855943245e-06, "exact": 1.192402027783146e-06,
             "variance_sigmas": 8.954234938796553,
             "source": "PERF.md section 6 (the low-rank noise in the rhs)"}


def volume_gate(sampler, op, device):
    """The gate of ``native/validate_mgmc3d_tpu.py`` on the sampler of the
    main path: the zero-mean protocol (f = 0 from x = 0) at 32 chains, 30
    warm-up and 300 steps; the mean and variance of the point observation at
    the centre within 4 standard errors of 0 and of the exact float64 variance
    (``observed_mean_and_variance``: CG on the card, which must converge); and
    gated the same way, the first measurement's own functional ``B_0^T x``
    (variance about its Sigma, 1e-6), which float32 resolves since the sweep's
    low-rank noise enters the Woodbury correction and not the rhs (before: the
    variance 21% high, :data:`B0_BEFORE`)."""
    from multigridmc_tpu_torch.models.posterior import (measurement_vector,
                                                        observed_mean_and_variance)
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise

    g = VOLUME_GATE
    observations = {
        "centre": torch.as_tensor(measurement_vector(op.lattice, np.array([0.5, 0.5, 0.5]), 0.0),
                                  dtype=torch.float32, device=device),
        "measurement_0": op.lowrank.B[0].float()}
    exact, exact_seconds = {}, {}
    for name, w in observations.items():
        t0 = time.perf_counter()
        exact[name] = observed_mean_and_variance(op.to(dtype=torch.float64),
                                                 np.zeros(op.vshape), np.zeros(op.m_lowrank),
                                                 w.double().cpu().numpy())[1]
        exact_seconds[name] = time.perf_counter() - t0
    W = torch.stack(list(observations.values())).reshape(len(observations), -1)
    C = g["chains"]
    noise = GeneratorNoise(VOLUME_SEED + 1, device)
    fz = torch.zeros(op.vshape, device=device)
    x = torch.zeros((C,) + op.vshape, device=device)
    for _ in range(g["warmup"]):
        x = sampler.apply(noise, fz, x)
    zs = []
    for _ in range(g["steps"]):
        x = sampler.apply(noise, fz, x)
        zs.append(x.reshape(C, -1).double() @ W.double().T)
    z = torch.stack(zs).cpu().numpy()  # (steps, chains, observations)
    out = {"chains": C, "warmup": g["warmup"], "steps": g["steps"]}
    for k, name in enumerate(observations):
        res = moments_gate(f"volume 64^3 {name}", z[:, :, k], 0.0, exact[name], C)
        res.update({"exact_variance": exact[name], "exact_variance_seconds": exact_seconds[name]})
        out[name] = res
    out["centre"]["observation"] = [0.5, 0.5, 0.5]
    return out


#: the volume table (``--phases volume_table``): chain counts, and the block
#: sizes tried at each cluster size that fits
VOLUME_TABLE_CHAINS = (1, 4, 8, 32, 64, 128)
VOLUME_TABLE_THREADS = (512, 1024)


def time_volume_variants(levels, noise, chains=VOLUME_TABLE_CHAINS):
    """The ``volume_table``: device ms per launch (torch.profiler, the median
    of three interleaved windows) of the phase kernels' 3d build and of the
    smem kernels at every cluster size whose slab fits a block (and the
    tables' indices), ``c`` in shared memory or not,
    :data:`VOLUME_TABLE_THREADS`, descend plus ascend, at
    each count of ``chains`` on each of ``levels`` (``{name: level}``, one and
    two sweeps); beside each row the configuration the route takes
    (``mgmc_visit_smem3d.SMEM3D_ROUTES``) and the fastest.  Returns the rows
    and the faults: a count where the route's choice takes more than
    :data:`SMEM_ROUTE_SLACK` times the fastest configuration's."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    rows, faults = [], []
    for name, level in levels.items():
        dev = level.coeffs.device
        Z, Y, W = level.op.vshape
        limit = ss.smem_limit_of(dev)
        for C in chains:
            f = torch.rand(level.op.vshape, device=dev)
            x = torch.zeros((C,) + level.op.vshape, device=dev)
            xc = torch.randn((C,) + level.vc, device=dev)
            cands = {}
            for kind, fn in zip(("descend", "ascend"), visit_fns(level, "phase", noise, f, x, xc)):
                cands[("phase", kind)] = (fn, reach2_kernel(level, "phase", kind))
            configs = []
            for S in v3.CLUSTER_SIZES:
                if Z // S < 1 or not v3.fits_indices(Z, Y, W, S):
                    continue
                for c_sh in (True, False):
                    if v3.smem_bytes(Z, Y, W, S, c_sh) + v3.STATIC_SMEM > limit:
                        continue
                    for threads in VOLUME_TABLE_THREADS:
                        if v3.active_clusters(level, S, c_sh, threads) < 1:
                            continue
                        configs.append((S, c_sh, threads))
            for conf in configs:
                kw = dict(zip(("cluster", "c_shared", "threads"), conf))
                for kind in ("descend", "ascend"):
                    def fn(kind=kind, kw=kw):
                        xi, xi_lr, philox = level._draw(noise, x, kind)
                        return mv_launch(kind, level, f, x, xi, xi_lr, philox,
                                         xc if kind == "ascend" else None, kw)
                    cands[(conf, kind)] = (fn, reach2_kernel(level, "smem", kind))
            ms = device_ms_medians(cands, 10, 3)
            route = level.route(C)
            chosen = v3.route_config(level.op.vshape, level.stencil_form, level.ndir, C)
            group = []
            for conf in ["phase"] + configs:
                d, a = ms[(conf, "descend")], ms[(conf, "ascend")]
                row = {"level": name, "vshape": [Z, Y, W], "sweeps": level.ndir,
                       "stencil_form": level.stencil_form, "chains": C,
                       "route": "phase" if conf == "phase" else "smem",
                       "descend_ms": d, "ascend_ms": a, "ms": None if None in (d, a) else d + a,
                       "taken": (conf == "phase" and route == "phase")
                       or (route == "smem" and conf == chosen)}
                if conf != "phase":
                    row.update(dict(zip(("cluster", "c_shared", "threads"), conf)))
                group.append(row)
            timed = [r for r in group if r["ms"] is not None]
            best = min(timed, key=lambda r: r["ms"])
            best["fastest"] = True
            taken = [r for r in group if r["taken"]]
            if (not taken or taken[0]["ms"] is None
                    or taken[0]["ms"] > SMEM_ROUTE_SLACK * best["ms"]):
                faults.append(f"{name} sweeps={level.ndir} C={C}: the route takes "
                              f"{taken[0] if taken else None}, the fastest is {best}")
            rows += group
            del x, xc
    return rows, faults


def phase_volume_check(device, smi, table):
    """The 3d visits alone on the 64^3 posterior's levels 0 (63^3, 7-point)
    and 1 (31^3, 27-point) at 32 and 1 chains: both designs' registers and
    spills, the phase kernels' 3d build by pass (its stamps build), the smem
    kernels and their two-sweep form against the plain versions and the
    phase kernels under one Philox stream, and by pass; with ``table`` the
    ``volume_table`` (:func:`time_volume_variants`, one and two sweeps), which
    fails where the route's choice is more than :data:`SMEM_ROUTE_SLACK` times
    the fastest.  No result line."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    out = {"phase": "volume_check", "card": smi}
    try:
        gen = torch.Generator(device=device)
        gen.manual_seed(15)
        op, _, _ = volume_posterior(VOLUME_NX, device)
        sampler = MultigridMCSampler(op, nlevel=VOLUME_NLEVEL, smoother="SOR",
                                     coarse_solver="Cholesky", omega=1.0, cycle=2)
        levels = sampler.fused_levels
        noise = GeneratorNoise(VOLUME_SEED + 4, device)
        out["kernel_attributes"] = build_kernel_attributes(reach=1, dim=3)
        out["smem_kernel_attributes"] = smem_kernel_attributes(dim=3)
        out["routes"] = {li: {c: levels[li].route(c) for c in VOLUME_TABLE_CHAINS}
                         for li in (0, 1)}
        out["pass_stamps"] = [reach2_pass_stamps(levels[li], li, c, noise, "phase", "volume")
                              for c in VOLUME_CHAINS for li in (0, 1)]
        emit(dict(out, partial=True))
        checked = MultigridMCSampler(volume_posterior(VOLUME_NX, device, near_exact=False)[0],
                                     nlevel=3, smoother="SOR", cycle=2, distill=False)
        out["smem_checks"] = [check_phase_only_level(checked.fused_levels[li], f"L{li}", c, gen,
                                                     label="volume", route="smem")
                              for li in (0, 1) for c in VOLUME_CHAINS]
        two = biharmonic_ssor_levels(checked)
        out["smem_ssor_checks"] = [check_ssor_level(two[li], f"volume L{li}", c, gen, "smem",
                                                    own_route=False)
                                   for li in (0, 1) for c in VOLUME_CHAINS]
        del checked, two
        out["smem_pass_stamps"] = [reach2_pass_stamps(levels[li], li, c, noise, "smem", "volume")
                                   for c in VOLUME_CHAINS for li in (0, 1)]
        emit(dict(out, partial=True))
        if table:
            levels2 = biharmonic_ssor_levels(sampler)
            out["volume_table"], faults = time_volume_variants(
                {"L0": levels[0], "L1": levels[1], "L0 SSOR": levels2[0], "L1 SSOR": levels2[1]},
                noise)
            out["volume_table_faults"] = faults
            if faults:
                raise AssertionError("volume_table: the route's configuration is more than "
                                     f"{SMEM_ROUTE_SLACK} times the fastest: " + "; ".join(faults))
    except BaseException:
        out["failed"] = True
        raise
    finally:
        emit(out)


# ------------------------------- phase volume: the 3d 7-point sweeps (smem3d)
#: the chain counts at which the smem3d body's sweeps are held against their
#: plain versions and the generic body and timed: the 32 of the sweep tables
#: and the 128 of the SSOR sampler's path
SWEEP3D_CHAINS = (32, 128)
#: the path at full width: the 64^3 posterior's SSOR Gibbs sampler at 128
#: chains (steps timed, steps profiled), and the multigrid solve of that many
#: right-hand sides with its levels composed (cycles)
SWEEP3D_PATH = {"chains": 128, "steps": 10, "profile_steps": 3, "cycles": 3}
#: the ``sweep3d_table``: chain counts, and the cluster sizes tried on each
#: field (every one that fits, the rest of 1-16 being near neighbours)
SWEEP3D_TABLE_CHAINS = (1, 4, 8, 16, 32, 64, 128, 256)
SWEEP3D_TABLE_SIZES = {63: (16, 12, 8, 6), 31: (16, 8, 4, 2, 1)}
SWEEP3D_TABLE_THREADS = (512, 1024)
#: the smem3d kernels as torch.profiler names them
SMEM3D_KERNELS = {"sweep": "smem3d_sweep_kernel<false", "gibbs": "smem3d_sweep_kernel<true"}


def check_sweep3d(op, gen):
    """Both kernels of the smem3d body (``csrc/sor_sweep_smem3d.cu``) on the
    64^3 posterior's 63^3 7-point level ``op`` at each count of
    :data:`SWEEP3D_CHAINS`, forward and backward, ``b`` shared (the samplers')
    and per chain (the solver's), at the configuration the table gives
    (``sor_sweep.smem3d_config``): against the plain versions (TOL) with the
    noise off and with ``xi`` as a tensor (``noise_mode`` 2), the in-kernel
    generator against the plain version fed the host's reference normals
    (forward, ``b`` shared, the chains of :func:`noise_check_chains`), and
    against the generic body of ``sor_sweep.cu`` on the same inputs and under
    one Philox stream (ROUTE_TOL).  Returns the errors by kernel and the
    rows."""
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import BACKWARD, FORWARD, SORSmoother

    dev = op.coeffs.device
    errs = {"sweep_batched_smem3d": 0.0, "gibbs_sweep_batched_smem3d": 0.0,
            "sweep_batched_generic": 0.0, "gibbs_sweep_batched_generic": 0.0}
    rows = []
    for direction in (FORWARD, BACKWARD):
        plan = SORSmoother(op, 1.0, 1, direction).plan
        if plan.body != "smem3d":
            raise AssertionError(f"sweep3d: the 63^3 7-point level takes the {plan.body} body")
        for C in SWEEP3D_CHAINS:
            x = torch.randn((C,) + op.vshape, device=dev, generator=gen)
            xi = torch.randn((C,) + op.vshape, device=dev, generator=gen)
            conf = {kind: plan.smem3d_launch(plan.params(C, False, mode, (0, 0)))
                    for kind, mode in (("sweep", 0), ("gibbs", 1))}
            row = {"chains": C, "direction": direction, "sweep_err": 0.0, "gibbs_err": 0.0,
                   "against_generic": 0.0,
                   "config": {k: [v.S, v.c_shared, v.threads] for k, v in conf.items()},
                   "smem_bytes": {k: v.nbytes for k, v in conf.items()}}
            for b_batched in (False, True):
                b = torch.randn(((C,) if b_batched else ()) + op.vshape, device=dev,
                                generator=gen)
                tag = f"sweep3d {direction} C={C} {'b per chain' if b_batched else 'b shared'}"
                want = ss.sweep_batched_plain(op, plan.masks, 1.0, plan.order, b, x)
                got = ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x.clone())
                old = ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), body="generic")
                row["sweep_err"] = max(row["sweep_err"], compare(f"{tag} sweep", got, want))
                errs["sweep_batched_generic"] = max(errs["sweep_batched_generic"], compare(
                    f"{tag} generic sweep", old, want))
                row["against_generic"] = max(row["against_generic"],
                                             float((got - old).abs().max()))
                want = ss.gibbs_sweep_batched_plain(op, plan.masks, 1.0, plan.order, b, x, xi)
                got = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), xi=xi)
                old = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), xi=xi,
                                            body="generic")
                row["gibbs_err"] = max(row["gibbs_err"], compare(f"{tag} gibbs", got, want))
                errs["gibbs_sweep_batched_generic"] = max(
                    errs["gibbs_sweep_batched_generic"],
                    compare(f"{tag} generic gibbs", old, want))
                row["against_generic"] = max(row["against_generic"],
                                             float((got - old).abs().max()))
                del want, old
                stream = (0x5EED_3D00 + C, 7 + b_batched)
                got = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), philox=stream)
                old = ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x.clone(), philox=stream,
                                            body="generic")
                row["against_generic"] = max(row["against_generic"],
                                             float((got - old).abs().max()))
                del old
                if direction == FORWARD and not b_batched:
                    for first, n in noise_check_chains(C):
                        part = slice(first, first + n)
                        ref = torch.as_tensor(common.philox_normals_reference(
                            *stream, n, op.vshape, first_chain=first), device=dev)
                        want = ss.gibbs_sweep_batched_plain(op, plan.masks, 1.0, plan.order, b,
                                                            x[part], ref)
                        row["gibbs_err"] = max(row["gibbs_err"], compare(
                            f"{tag} in-kernel noise, chains {first}..{first + n - 1}",
                            got[part], want))
                        del ref, want
                del got, b
            if row["against_generic"] > ROUTE_TOL:
                raise AssertionError(f"sweep3d {direction} C={C}: the smem3d and the generic "
                                     f"body differ by {row['against_generic']}")
            errs["sweep_batched_smem3d"] = max(errs["sweep_batched_smem3d"], row["sweep_err"])
            errs["gibbs_sweep_batched_smem3d"] = max(errs["gibbs_sweep_batched_smem3d"],
                                                     row["gibbs_err"])
            rows.append(row)
            del x, xi
    torch.cuda.synchronize()
    return errs, rows


def smem3d_sweep_stamps(plan, C, noise, config=None):
    """One launch of each kernel of the smem3d body's stamps build at ``C``
    chains (``b`` shared, the Gibbs kernel with its in-kernel noise; the
    configuration ``config`` or the rule's), by pass: the copy-in (with the
    Gibbs rhs) and each colour, the median over the blocks (a row per block,
    ``C S``; :func:`sor_sweep.sweep_pass_times`), the barriers each block
    passed against :func:`sor_sweep.barrier_count`, the blocks one SM ran at
    once; the kernels' registers and the blocks per SM the occupancy API
    gives."""
    import ctypes

    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    device = plan.op.coeffs.device
    b = torch.rand(plan.op.vshape, device=device)
    x = torch.zeros((C,) + plan.op.vshape, device=device)
    out = {}
    for kind, gibbs in (("sweep", False), ("gibbs", True)):
        launch = plan.smem3d_launch(plan.params(C, False, int(gibbs), (0, 0)), config)
        runs = []
        for _ in range(3):
            stamps = torch.zeros((C * launch.S, ss.SMEM3D_STAMP_WIDTH), dtype=torch.int64,
                                 device=device)
            conf = (launch.S, launch.c_shared, launch.threads)
            if gibbs:
                ss.launch_gibbs_sweep(plan, ss.BLOCK_ROUTE, b, x, philox=noise.philox_stream(),
                                      stamps=stamps, smem3d=conf)
            else:
                ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x, stamps=stamps, smem3d=conf)
            torch.cuda.synchronize()
            runs.append(ss.sweep_pass_times(plan.order, gibbs, stamps, body="smem3d"))
        pt = sorted(runs, key=lambda r: r["launch_span_us"])[1]
        pt["barriers_from_source"] = ss.barrier_count(plan.order, gibbs, body="smem3d")
        if pt["barriers_per_block"] != [pt["barriers_from_source"]]:
            raise AssertionError(f"smem3d sweep {kind}: barriers {pt['barriers_per_block']} "
                                 f"against {pt['barriers_from_source']} from the source")
        lib = ss.load_smem3d_library()
        vals = (ctypes.c_int * 3)()
        if lib.sor_smem3d_kernel_attributes(int(gibbs), vals):
            raise AssertionError(f"smem3d sweep {kind}: kernel attributes")
        pt.update({"chains": C, "cluster": launch.S, "c_shared": launch.c_shared,
                   "threads": launch.threads, "smem_bytes": launch.nbytes,
                   "registers": vals[0], "local_bytes": vals[1],
                   "blocks_per_sm_occupancy_api": lib.sor_smem3d_blocks_per_sm(
                       int(gibbs), launch.threads, launch.nbytes)})
        out[kind] = pt
    del b, x
    return out


def time_sweep3d(op, noise):
    """Both kernels of the smem3d body on the 63^3 7-point level ``op`` at each
    count of :data:`SWEEP3D_CHAINS` (``b`` shared, as the SSOR sampler gives
    it; the Gibbs kernel with its in-kernel noise) at the rule's
    configuration, and the generic body beside it in interleaved profiler
    windows: device ms (median of three windows) and event ms per launch
    (held to each other), the plain versions' ms and the bound; at 128
    chains the launch by pass (:func:`smem3d_sweep_stamps`)."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.smoothers import SORSmoother

    dev = op.coeffs.device
    plan = SORSmoother(op, 1.0, 1).plan
    rows = []
    for C in SWEEP3D_CHAINS:
        b = torch.rand(op.vshape, device=dev)
        x = torch.zeros((C,) + op.vshape, device=dev)
        bound, by, nbytes = sweep_bound(plan, C, False)
        row = {"chains": C, "vshape": list(op.vshape), "b_batched": False,
               "offsets": len(op.offsets), "colours": plan.coloring.n_colors,
               "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes}
        for kind, mode in (("sweep", 0), ("gibbs", 1)):
            launch = plan.smem3d_launch(plan.params(C, False, mode, (0, 0)))
            row[f"{kind}_config"] = {"cluster": launch.S, "c_shared": launch.c_shared,
                                     "threads": launch.threads, "smem_bytes": launch.nbytes}
            fns = {}
            for body, prefix in (("smem3d", ""), ("generic", "generic_")):
                if mode:
                    fns[prefix] = (lambda body=body: ss.launch_gibbs_sweep(
                        plan, ss.BLOCK_ROUTE, b, x, philox=noise.philox_stream(), body=body))
                else:
                    fns[prefix] = (lambda body=body: ss.launch_sweep(plan, ss.BLOCK_ROUTE, b, x,
                                                                      body=body))
            device_ms = device_ms_medians(
                {"": (fns[""], SMEM3D_KERNELS[kind]),
                 "generic_": (fns["generic_"], sweep_kernel(ss.BLOCK_ROUTE, "generic", kind))},
                20)
            for prefix, fn in fns.items():
                host = {}
                row[f"{prefix}{kind}_ms"] = cuda_ms(fn, 5, 10, host)
                row[f"{prefix}{kind}_device_ms"] = device_ms[prefix]
                row[f"{prefix}{kind}_events_over_device"] = check_events_against_device(
                    f"sweep3d {prefix}{kind} C={C}", row[f"{prefix}{kind}_ms"],
                    row[f"{prefix}{kind}_device_ms"], host["ms"])
            row[f"{kind}_over_generic"] = (row[f"{kind}_device_ms"]
                                           / row[f"generic_{kind}_device_ms"])
        x.zero_()
        row["sweep_plain_ms"] = cuda_ms(
            lambda: ss.sweep_batched_plain(op, plan.masks, 1.0, plan.order, b, x), 3, 3)
        row["gibbs_plain_ms"] = cuda_ms(
            lambda: ss.gibbs_sweep_batched_plain(op, plan.masks, 1.0, plan.order, b, x,
                                                 torch.randn_like(x)), 3, 3)
        if C == SWEEP3D_PATH["chains"]:
            row["stamps"] = smem3d_sweep_stamps(plan, C, noise)
        rows.append(row)
        del b, x
    return rows


def sweep3d_path(op, f, device):
    """The smem3d body on the paths at full width: the 64^3 posterior's SSOR
    Gibbs sampler (``samplers/sor.py::SSORSampler``) at 128 chains, whose
    steps sweep the 63^3 level twice (forward, backward) above the split
    threshold, and the multigrid solve of 128 right-hand sides with its levels
    composed (``MultigridPreconditioner(fused=False)``, the deterministic
    sweeps).  Per path the launch counts, set to 0 just before it is driven
    and read just after (the smem3d kernels must run, the generic body not);
    the sampler's ms per step and samples/s (host clock) and its device ms per
    step and per sweep (torch.profiler), then the same steps with both plans'
    body set to the generic one (the A/B in one run); the solve's residual
    contraction per cycle and its seconds."""
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.sor import SSORSampler
    from multigridmc_tpu_torch.solvers.multigrid import MultigridPreconditioner

    C, steps = SWEEP3D_PATH["chains"], SWEEP3D_PATH["steps"]
    sampler = SSORSampler(op, 1.0, 1)
    plans = (sampler.forward.smoother.plan, sampler.backward.smoother.plan)
    out = {"chains": C, "steps": steps}
    for body in ("smem3d", "generic"):
        for plan in plans:
            plan.body = body
        noise = GeneratorNoise(VOLUME_SEED + 5, device)
        x = torch.zeros((C,) + op.vshape, device=device)
        for _ in range(2):
            x = sampler.apply(noise, f, x)
        torch.cuda.synchronize()
        ss.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            x = sampler.apply(noise, f, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        counts = {k: v for k, v in ss.launch_counts.items() if v}
        name = "gibbs_sweep_batched_" + body
        if counts != {name: 2 * steps} or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"sweep3d: the SSOR sampler with the {body} body launched "
                                 f"{counts}")
        pattern = (r"smem3d_sweep_kernel<true" if body == "smem3d"
                   else r"(?<!passes_)gibbs_sweep_kernel<")
        busy = device_busy(lambda: sampler.apply(noise, f, x), SWEEP3D_PATH["profile_steps"],
                           pattern)
        sweeps = busy["matching"] if busy else []
        per_step = sum(r["ms_per_step"] for r in sweeps)
        calls = sum(r["calls_per_step"] for r in sweeps)
        out[body] = {"ms_per_step": ms, "samples_per_s": C / ms * 1e3,
                     "kernel_ms_per_step": busy["kernel_ms_per_step"] if busy else None,
                     "kernels_per_step": busy["kernels_per_step"] if busy else None,
                     "sweep_device_ms": per_step / calls if calls else None,
                     "sweeps_per_step": calls, "launches": counts,
                     "top": busy["top"] if busy else None}
        del x
    for plan in plans:
        plan.body = "smem3d"
    out["sweep_device_ms_over_generic"] = (
        out["smem3d"]["sweep_device_ms"] / out["generic"]["sweep_device_ms"]
        if out["smem3d"]["sweep_device_ms"] and out["generic"]["sweep_device_ms"] else None)
    # the deterministic sweeps: the solve of 128 right-hand sides
    precond = MultigridPreconditioner(op, nlevel=VOLUME_NLEVEL, smoother="SOR", omega=1.0,
                                      cycle=2, fused=False, distill=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(VOLUME_SEED + 6)
    b = torch.rand((C,) + op.vshape, device=device, generator=gen)
    x = torch.zeros_like(b)
    norms = [float(b.norm())]
    torch.cuda.synchronize()
    ss.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(SWEEP3D_PATH["cycles"]):
        x = x + precond.apply(b - op.apply(x))
        norms.append(float((b - op.apply(x)).norm()))
    torch.cuda.synchronize()
    counts = {k: v for k, v in ss.launch_counts.items() if v}
    rates = [n1 / n0 for n0, n1 in zip(norms[:-1], norms[1:])]
    if (counts.get("sweep_batched_smem3d", 0) < 1 or counts.get("sweep_batched_generic")
            or not max(rates) < 1.0):
        raise AssertionError(f"sweep3d: the solve of {C} right-hand sides launched {counts}, "
                             f"residual rates {rates}")
    out["solve"] = {"right_hand_sides": C, "cycles": SWEEP3D_PATH["cycles"],
                    "seconds": time.perf_counter() - t0, "residual_rates": rates,
                    "launches": counts}
    del precond, b, x
    return out


def time_sweep3d_table(device):
    """The ``sweep3d_table``: device ms per launch (torch.profiler, the median
    of three interleaved windows) of both sweep kernels, ``b`` per chain as in
    ``sweep_routes``, at each count of :data:`SWEEP3D_TABLE_CHAINS` on the
    64^3 posterior's 63^3 and a 32^3 lattice's 31^3 7-point fields: the
    smem3d body at every cluster size of :data:`SWEEP3D_TABLE_SIZES` that fits
    (and the tables' indices, and schedules), ``c`` in shared memory or not,
    :data:`SWEEP3D_TABLE_THREADS`; the generic body; on 63^3 the passes' 3d
    build (``PASSES_DIM3_MIN_OFFSETS``); the split route at every cluster size
    that fits and schedules.  Returns the rows and the faults: a count where
    the configuration ``sor_sweep.smem3d_config`` gives takes more than
    :data:`SMEM_ROUTE_SLACK` times the fastest one; a threshold of
    ``SPLIT_MAX_CHAINS`` (class ``"3d"``, the 63^3 field) other than the
    largest count up to which the split route at the rule's cluster size takes
    less than :data:`SPLIT_CLEAR_WIN` of the smem3d body's time at every
    count; the passes' 3d build faster than the smem3d body on 63^3.  Beside
    them, the other field of the class ``"3d"``: the 31^3 27-point Galerkin
    level of a 64^3 lattice on the passes' 3d build and the split route (rows
    only, no fault)."""
    import ctypes

    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
    from multigridmc_tpu_torch.ops.coarsen import galerkin_coarsen
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.smoothers import SORSmoother

    noise = GeneratorNoise(VOLUME_SEED + 7, device)
    limit = ss.smem_limit_of(device)
    lib = ss.load_smem3d_library()
    rows, faults, wins = [], [], {}
    const = ConstantCorrelationLengthModel(0.2)
    for nx, label in ((63, "7-point"), (31, "7-point"), (31, "27-point Galerkin")):
        op = shiftedlaplace_fd(Lattice((nx + 1,) * 3), const, device=device)
        if label != "7-point":
            op = galerkin_coarsen(shiftedlaplace_fd(Lattice((2 * nx + 2,) * 3), const,
                                                    device=device))
        plan = SORSmoother(op, 1.0, 1).plan
        reach = ss.slow_reach(op.offsets, op.vshape)
        fits = ss.smem3d_sizes(op.vshape, limit)
        for C in SWEEP3D_TABLE_CHAINS:
            b = torch.rand((C,) + op.vshape, device=device)
            x = torch.zeros((C,) + op.vshape, device=device)
            for kernel, mode in (("sweep", 0), ("gibbs", 1)):
                def run(route, **kw):
                    if mode:
                        return lambda: ss.launch_gibbs_sweep(plan, route, b, x,
                                                             philox=noise.philox_stream(), **kw)
                    return lambda: ss.launch_sweep(plan, route, b, x, **kw)

                if label != "7-point":  # the passes' 3d build and the split route
                    cands = {"passes": (run(ss.BLOCK_ROUTE, body="passes"),
                                        sweep_kernel(ss.BLOCK_ROUTE, "passes", kernel))}
                    for S in ss.SPLIT_SIZES:
                        nbytes = ss.split_smem_bytes(op.vshape, S, reach, mode)
                        if nbytes <= limit and ss.active_clusters(
                                device, mode, S, ss.split_threads(op.vshape, S), nbytes) > 0:
                            cands[("split", S)] = (run(("split", S)),
                                                   sweep_kernel(("split", S), None, kernel))
                    ms = device_ms_medians(cands, 10, 3)
                    rule_split = ss.split_size(C, op.vshape, op.offsets, mode, device)
                    rows.append({"field": f"{nx}^3 {label}", "chains": C, "kernel": kernel,
                                 "passes_ms": ms["passes"],
                                 "split_ms": {str(k[1]): v for k, v in ms.items()
                                              if isinstance(k, tuple)},
                                 "rule_split": rule_split,
                                 "rule_split_ms": ms.get(("split", rule_split)),
                                 "route": list(ss.sweep_route(C, plan, mode))})
                    continue
                cands = {"generic": (run(ss.BLOCK_ROUTE, body="generic"),
                                     sweep_kernel(ss.BLOCK_ROUTE, "generic", kernel))}
                if nx == 63:
                    cands["passes"] = (run(ss.BLOCK_ROUTE, body="passes"),
                                       sweep_kernel(ss.BLOCK_ROUTE, "passes", kernel))
                configs = []
                for S in SWEEP3D_TABLE_SIZES[nx]:
                    if S not in fits:
                        continue
                    for c_sh in (True, False):
                        nbytes = v3.smem_bytes(nx, nx, nx, S, c_sh)
                        if nbytes + ss.SMEM3D_STATIC_SMEM > limit:
                            continue
                        for threads in SWEEP3D_TABLE_THREADS:
                            active = ctypes.c_int(0)
                            if (lib.sor_smem3d_max_active(mode, S, threads, nbytes,
                                                          ctypes.byref(active)) or
                                    active.value < 1):
                                continue
                            configs.append((S, c_sh, threads))
                chosen = ss.smem3d_config(op.vshape, C, mode)
                if chosen not in configs:
                    configs.append(chosen)
                for conf in configs:
                    cands[conf] = (run(ss.BLOCK_ROUTE, body="smem3d", smem3d=conf),
                                   SMEM3D_KERNELS[kernel])
                active = {}
                for S in ss.SPLIT_SIZES:
                    if S > nx or nx // S < reach:
                        continue
                    nbytes = ss.split_smem_bytes(op.vshape, S, reach, mode)
                    if nbytes > limit:
                        continue
                    active[S] = ss.active_clusters(device, mode, S,
                                                   ss.split_threads(op.vshape, S), nbytes)
                    if active[S] > 0:
                        cands[("split", S)] = (run(("split", S)),
                                               sweep_kernel(("split", S), None, kernel))
                ms = device_ms_medians(cands, 10, 3)
                smem = {c: ms[c] for c in configs if ms[c] is not None}
                best = min(smem, key=smem.get)
                rule_split = ss.split_size(C, op.vshape, op.offsets, mode, device)
                row = {"field": f"{nx}^3 {label}", "chains": C, "kernel": kernel,
                       "generic_ms": ms["generic"], "passes_ms": ms.get("passes"),
                       "smem3d_ms": {"/".join(map(str, c)): ms[c] for c in configs},
                       "split_ms": {str(k[1]): v for k, v in ms.items()
                                    if isinstance(k, tuple) and k[0] == "split"},
                       "active_split_clusters": {str(S): a for S, a in active.items()},
                       "config": list(chosen), "config_ms": ms[chosen],
                       "fastest": list(best), "fastest_ms": smem[best],
                       "rule_split": rule_split,
                       "rule_split_ms": ms.get(("split", rule_split)),
                       "route": list(ss.sweep_route(C, plan, mode))}
                row["over_generic"] = (row["config_ms"] / row["generic_ms"]
                                       if row["config_ms"] and row["generic_ms"] else None)
                rows.append(row)
                tag = f"{nx}^3 {kernel} C={C}"
                if ms[chosen] is None or ms[chosen] > SMEM_ROUTE_SLACK * smem[best]:
                    faults.append(f"{tag}: the configuration {chosen} takes {ms[chosen]}, "
                                  f"{best} {smem[best]}")
                if nx == 63:
                    if ms["passes"] is not None and ms["passes"] < smem[best]:
                        faults.append(f"{tag}: the passes' 3d build ({ms['passes']}) beats the "
                                      f"smem3d body ({smem[best]})")
                    wins.setdefault((kernel, "3d"), {})[C] = (
                        row["rule_split_ms"] is not None and ms[chosen] is not None
                        and row["rule_split_ms"] < SPLIT_CLEAR_WIN * ms[chosen])
            del b, x
    thresholds = {}
    for key, by_count in wins.items():
        measured = 0
        for C in sorted(by_count):
            if not by_count[C]:
                break
            measured = C
        thresholds[str(key)] = {"measured": measured, "constant": ss.SPLIT_MAX_CHAINS[key]}
        if measured != ss.SPLIT_MAX_CHAINS[key]:
            faults.append(f"the table supports a split threshold of {measured} chains for "
                          f"{key}, the constant is {ss.SPLIT_MAX_CHAINS[key]}")
    return rows, thresholds, faults


def phase_sweep3d(device, smi, table):
    """The smem3d sweeps alone (no result line): their checks
    (:func:`check_sweep3d`), times (:func:`time_sweep3d`) and paths
    (:func:`sweep3d_path`) as the volume phase runs them, the kernels'
    registers; with ``table`` the ``sweep3d_table`` (:func:`time_sweep3d_table`),
    which fails where a constant is not the one it supports."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise

    out = {"phase": "sweep3d_check", "card": smi}
    try:
        gen = torch.Generator(device=device)
        gen.manual_seed(17)
        op, _, f = volume_posterior(VOLUME_NX, device)
        out["max_abs_err"], out["checks"] = check_sweep3d(op, gen)
        out["timings"] = time_sweep3d(op, GeneratorNoise(VOLUME_SEED + 2, device))
        out["path"] = sweep3d_path(op, f, device)
        emit(dict(out, partial=True))
        if table:
            out["sweep3d_table"], out["thresholds"], faults = time_sweep3d_table(device)
            out["sweep3d_table_faults"] = faults
            if faults:
                raise AssertionError("sweep3d_table: " + "; ".join(faults))
    except BaseException:
        out["failed"] = True
        raise
    finally:
        emit(out)


def write_volume_configs(directory, nx, nlevel, nchains, nsamples, nwarmup):
    """``params_volume.cfg`` (the 3d posterior of the bench on an ``nx^3``
    lattice, SOR multigrid, MGMC alone) and ``measurements_volume.cfg``."""
    rng = np.random.default_rng(VOLUME_SEED)
    loc, mean = rng.uniform(0.1, 0.9, size=(8, 3)), rng.normal(2.0, 1.0, size=8)
    var = 1e-6 * (1.0 + rng.uniform(size=8))

    def listing(values):
        return "[" + ", ".join(repr(float(v)) for v in np.asarray(values).reshape(-1)) + "]"

    with open(os.path.join(directory, "measurements_volume.cfg"), "w") as out:
        out.write(f"dim = 3;\nn = 8;\nmeasurement_locations = {listing(loc)};\n"
                  f"mean = {listing(mean)};\nvariance = {listing(var)};\n")
    text = DRIVER_CONFIG.format(
        nx=nx, nlevel=nlevel, smoother="SOR", nchains=nchains, nsamples=nsamples,
        nwarmup=nwarmup, do_cholesky="false", do_ssor="false", schedule="",
        cholesky='cholesky = { factorisation = "dense"; }')
    for old, new in (("dim = 2;", "dim = 3;"), ("sample_location = [0.5, 0.5];",
                                                 "sample_location = [0.5, 0.5, 0.5];"),
                     ('filename = "measurements.cfg"', 'filename = "measurements_volume.cfg"')):
        if old not in text:
            raise AssertionError(f"the driver config has no {old!r}")
        text = text.replace(old, new)
    with open(os.path.join(directory, "params_volume.cfg"), "w") as out:
        out.write(text)


def volume_drivers(nlevel, nchains):
    """``mgmc-sample-torch`` and ``mgmc-solve-torch`` on the 3d config
    (:data:`VOLUME_DRIVER_NX`): the one-chain series and the convergence table
    over ``nchains`` replicas on the 3d visit kernels, the exact moments (CG on
    the card, which must converge), the MGMC mean within 5 error bars (widened
    by the autocorrelation time) of the exact one; the Richardson solve on the
    3d kernels with the noise off converges."""
    from multigridmc_tpu_torch.drivers import mg as driver_mg
    from multigridmc_tpu_torch.drivers import mgmc as driver_mgmc
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    out = {}
    nsamples, nwarmup = 400, 100
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        write_volume_configs(work, VOLUME_DRIVER_NX, nlevel, nchains, nsamples, nwarmup)
        os.chdir(work)
        try:
            mv.reset_launch_counts()
            t0 = time.perf_counter()
            text = run_driver(driver_mgmc.main, ["params_volume.cfg"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            print("\n".join(line for line in text.splitlines()
                            if re.search(r"time per sample|mean  |variance =|setup time", line)),
                  flush=True)
            series = np.loadtxt("timeseries_multigridmc.txt")
            if series.shape != (nsamples,) or not np.isfinite(series).all():
                raise AssertionError(f"drivers (volume): the time series is not {nsamples} "
                                     "finite values")
            ms = re.search(r"multigridmc time per sample =\s+(\S+) ms", text)
            mean = re.search(r"multigridmc mean\s+=\s+(\S+) \+/-\s+(\S+)", text)
            exact = float(re.search(r"exact mean\s+=\s+(\S+)", text).group(1))
            res = {"lattice": [VOLUME_DRIVER_NX] * 3, "seconds": seconds,
                   "ms_per_sample": float(ms.group(1)), "mean": float(mean.group(1)),
                   "mean_error": float(mean.group(2)), "exact_mean": exact,
                   "iact": integrated_autocorrelation_time(series),
                   "launches": {k: v for k, v in mv.launch_counts.items() if v}}
            res["mean_bar"] = 5.0 * res["mean_error"] * np.sqrt(max(res["iact"], 1.0))
            if abs(res["mean"] - exact) > res["mean_bar"]:
                raise AssertionError(f"drivers (volume): MGMC mean {res['mean']} is further than "
                                     f"{res['mean_bar']} from the exact mean {exact}")
            if not mv.launch_counts["descend_visit_3d_7pt"] > 0:
                raise AssertionError(f"drivers (volume): visit launches {mv.launch_counts}")
            out["mgmc_volume"] = res
            mv.reset_launch_counts()
            t0 = time.perf_counter()
            text = run_driver(driver_mg.main, ["params_volume.cfg"])
            torch.cuda.synchronize()
            rows = richardson_table(text)
            if "Solver converged" not in text or not rows:
                raise AssertionError("drivers.mg (volume): the Richardson iteration did not "
                                     "converge:\n" + text[-2000:])
            if not mv.launch_counts["descend_visit_3d_7pt"] > 0:
                raise AssertionError(f"drivers.mg (volume): visit launches {mv.launch_counts}")
            out["mg_volume"] = {"seconds": time.perf_counter() - t0, "iterations": len(rows) - 1,
                                "relative_residual": rows[-1][2],
                                "contraction_rates": [r[3] for r in rows[1:]],
                                "launches": {k: v for k, v in mv.launch_counts.items() if v}}
        finally:
            os.chdir(cwd)
    return out


def phase_volume(device, smi):
    """The 3d posterior of ``native/bench_mgmc3d_tpu.py`` on the card
    (:func:`volume_posterior`), through ``MultigridMCSampler.apply`` in
    float32:

    * the main path at 32 chains and at one chain with the default
      ``distill="auto"`` (distilled at level 2, 15^3), and with
      ``distill=False``: levels 0 (63^3, 7-point, 2 colours) and 1 (31^3,
      27-point Galerkin, 8 colours) on the phase kernels' 3d build, every visit
      one launch of it (the counts by name), ms/step, samples/s, kernel ms and
      launches per step, routes by level; the same step with ``fused=False``,
      the composed visits on the sweep kernels, as the "before";
    * the 3d kernels on both levels at 32 chains and at one chain against
      their plain versions (noise off, a tensor ``xi``, the in-kernel
      generator against the host's reference normals; ``f_c`` within TOL of
      its scale) and against the composed visit under one Philox stream
      (:func:`check_volume_composed`), on the same lattice with order-one
      measurement variances; the descend's ``f_c`` on the main path's
      near-exact levels against a float64 visit (:func:`near_exact_fc`, a
      check at :data:`NEAR_EXACT_FC_TOL`); their device ms on the main path's levels (the median of
      three profiler windows, held to the events), registers and spills;
    * every sweep the distillation set-up launches (the shared-memory body
      on 15^3, 27-point, 8 colours), at its shapes, against the plain sweep
      and the generic body (:func:`check_setup_sweeps`), their launches those
      of the main path's set-up, and both kernels' times there beside the
      generic body's (:func:`time_block_sweeps`);
    * the statistical gate of ``native/validate_mgmc3d_tpu.py`` at the centre
      and on the first measurement's functional (:func:`volume_gate`);
    * ``drivers.mgmc`` and ``drivers.mg`` on a 32^3 config
      (:func:`volume_drivers`).

    The line is printed also where a part fails, with what was found up to
    there."""
    out = {"phase": "volume", "card": smi}
    try:
        _volume_parts(out, device)
    except BaseException:
        out["failed"] = True
        raise
    finally:
        emit(out)
    return out


def _volume_parts(out, device):
    """The parts of :func:`phase_volume`, each filling its key of ``out``."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    op, _, f = volume_posterior(VOLUME_NX, device)
    kwargs = dict(nlevel=VOLUME_NLEVEL, smoother="SOR", coarse_solver="Cholesky", omega=1.0,
                  cycle=2)
    variants = {"distilled": {}, "every_level_fused": {"distill": False},
                "composed": {"fused": False, "distill": False}}
    # the composed step's thousand launches make a profiler window of several
    # steps slow to record: one step a window there
    busy_steps = {"composed": 1}
    out["main_path"] = {}
    out["part_seconds"] = parts = {}
    samplers = {}
    for name, extra in variants.items():
        sampler = None
        for C in VOLUME_CHAINS:
            sampler, res = drive_sampler(op, f, C, VOLUME_STEPS, {**kwargs, **extra},
                                         levels_are=lambda lv: lv.dim == 3, sampler=sampler,
                                         busy_steps=busy_steps.get(name, 4))
            if C == VOLUME_CHAINS[0]:
                setup = {"setup_seconds": res["setup_seconds"],
                         "setup_sweep_launches": res["setup_sweep_launches"]}
            res.update(setup)
            out["main_path"][f"{name}_{C}"] = res
        samplers[name] = sampler
    parts["main_path"] = time.perf_counter() - t0
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3

    for C in VOLUME_CHAINS:
        main = out["main_path"][f"distilled_{C}"]
        # each level's route as the table gives it, every visit through it
        want = {li: "phase" if v3.route_config((n,) * 3, form, 1, C) is None else "smem"
                for li, n, form in ((0, VOLUME_NX - 1, 10), (1, VOLUME_NX // 2 - 1, 12))}
        names = {f"{k}_visit_3d_{s}pt" + ("_smem" if want[li] == "smem" else "")
                 for k in ("descend", "ascend") for li, s in ((0, 7), (1, 27))}
        if (main["distill_level"] != 2 or main["fused_levels"] != [0, 1, 2]
                or main["visited_levels"] != [0, 1]
                or {int(k): v for k, v in main["route_by_level"].items()} != want
                or set(main["launches"]) != names):
            raise AssertionError(f"volume: the main path at {C} chains {main}, expected the "
                                 f"routes {want}")
    main = out["main_path"][f"distilled_{VOLUME_CHAINS[0]}"]
    if out["main_path"][f"composed_{VOLUME_CHAINS[0]}"]["launches"]:
        raise AssertionError("volume: the composed variant launched visit kernels")
    # the composed step's Gibbs sweeps: every smoothed level (all but the
    # coarsest, which Cholesky samples) through the route and body it takes
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    for C in VOLUME_CHAINS:
        want = set()
        for lop in samplers["composed"].hierarchy.operators[:-1]:
            route = ss.split_route(C, lop.vshape, lop.offsets, 1, device)
            body = ss.sweep_body(lop.vshape, lop.offsets, ss.smem_limit_of(device))
            want.add(ss._count_name("gibbs_sweep_batched", route, body))
        got = out["main_path"][f"composed_{C}"]["sweep_launches"]
        if set(got) != want:
            raise AssertionError(f"volume: the composed step at {C} chains launched the sweeps "
                                 f"{got}, its levels' routes give {sorted(want)}")
    del samplers["every_level_fused"], samplers["composed"]
    sampler = samplers["distilled"]
    levels = sampler.fused_levels
    out["kernel_attributes"] = build_kernel_attributes(reach=1, dim=3)
    # the distillation set-up's sweeps: every shape it launched (15^3), at
    # the set-up's chain counts
    out["setup_sweeps"] = check_distill_setup(op, VOLUME_NLEVEL, sampler, main, gen, "volume")
    at = max(out["setup_sweeps"], key=lambda r: r["launches"])
    level = next(o for o in sampler.hierarchy.operators if list(o.vshape) == at["vshape"])
    out["setup_sweep_timings"] = time_block_sweeps(level, at["chains"], at["b_batched"],
                                                   GeneratorNoise(VOLUME_SEED + 3, device),
                                                   one_chain=False)
    del level
    parts["setup_sweeps"] = time.perf_counter() - t0 - sum(parts.values())
    # the elementwise checks on the same lattice with order-one variances
    checked = MultigridMCSampler(volume_posterior(VOLUME_NX, device, near_exact=False)[0],
                                 nlevel=3, smoother="SOR", cycle=2, distill=False)
    out["checks"] = [check_phase_only_level(checked.fused_levels[li], f"L{li}", C, gen,
                                            label="volume", route=route)
                     for li in (0, 1) for C in VOLUME_CHAINS for route in ("smem", "phase")]
    out["against_composed"] = [check_volume_composed(checked, li, C, gen, route)
                               for li in (0, 1) for C in VOLUME_CHAINS
                               for route in ("smem", "phase")]
    del checked
    # and the reading of f_c on the main path's own near-exact levels
    out["near_exact_f_c"] = [near_exact_fc(levels[li], f"L{li}", VOLUME_CHAINS[0], gen)
                             for li in sorted(levels)]
    parts["checks"] = time.perf_counter() - t0 - sum(parts.values())
    noise = GeneratorNoise(VOLUME_SEED + 2, device)
    out["timings"] = [time_phase_only_level(levels[li], C, noise, route)
                      for li in (0, 1) for C in VOLUME_CHAINS for route in ("smem", "phase")]
    # the route each level takes at each count within SMEM_ROUTE_SLACK of the other's
    for li in (0, 1):
        for C in VOLUME_CHAINS:
            ms = {t["route"]: t["descend_device_ms"] + t["ascend_device_ms"]
                  for t in out["timings"] if t["chains"] == C
                  and t["vshape"] == list(levels[li].op.vshape)}
            taken = levels[li].route(C)
            other = "phase" if taken == "smem" else "smem"
            if ms[taken] > SMEM_ROUTE_SLACK * ms[other]:
                raise AssertionError(f"volume L{li} C={C}: the route takes {taken} ({ms[taken]} "
                                     f"device ms a descend and an ascend), {other} takes "
                                     f"{ms[other]}")
    out["smem_pass_stamps"] = [reach2_pass_stamps(levels[li], li, VOLUME_CHAINS[0], noise,
                                                  "smem", "volume") for li in (0, 1)]
    out["smem_kernel_attributes"] = smem_kernel_attributes(dim=3)
    parts["timings"] = time.perf_counter() - t0 - sum(parts.values())
    # the 3d 7-point sweeps on the smem3d body: checks, times, the paths at 128 chains
    out["sweep3d_errs"], out["sweep3d_checks"] = check_sweep3d(op, gen)
    out["sweep3d_timings"] = time_sweep3d(op, GeneratorNoise(VOLUME_SEED + 2, device))
    out["sweep3d_path"] = sweep3d_path(op, f, device)
    parts["sweep3d"] = time.perf_counter() - t0 - sum(parts.values())
    out["statistics"] = volume_gate(sampler, op, device)
    b0 = out["statistics"]["measurement_0"]
    emit({"volume_B0": {"before": B0_BEFORE,
                        "after": {"variance": b0["variance"], "exact": b0["exact_variance"],
                                  "variance_sigmas": b0["variance_sigmas"],
                                  "mean_sigmas": b0["mean_sigmas"],
                                  "source": "this run, chip_smoke.py volume_gate"}}})
    parts["statistics"] = time.perf_counter() - t0 - sum(parts.values())
    del sampler, samplers, levels
    out["drivers"] = volume_drivers(VOLUME_NLEVEL - 1, VOLUME_CHAINS[0])
    parts["drivers"] = time.perf_counter() - t0 - sum(parts.values())
    out["seconds"] = time.perf_counter() - t0


# -------------------------------------------------------------- phase: ssor
#: the SSOR flagship: chains of the phase route's path (level 0 on the phase
#: kernels) and of the one-chain path (level 0 on the split kernels), steps
#: of each; the 3d SSOR posterior's chains; steps of the reach-2 and 3d SSOR
#: samplers (their levels' visits are the point)
SSOR_CHAINS = (256, 1)
SSOR_STEPS = 10
SSOR_VOLUME_CHAINS = 32
SSOR_OTHER_STEPS = 3
#: the split route's cluster size at one chain on the 255^2 level
SSOR_SPLIT_CLUSTER = 16
#: chains at the start and at the end of a two-sweep launch whose in-kernel
#: normals are held against the host's reference (its recomputation on the
#: host takes most of a check's time)
SSOR_NOISE_CHECK = 8
#: chain counts of the ``ssor_table`` route table (``--phases ssor_table``)
SSOR_TABLE_CHAINS = (1, 4, 8, 16, 32, 64, 128, 256)


def check_ssor_level(level, name, C, gen, route, cluster=None, own_route=True):
    """A two-sweep (SSOR) level's visit kernels of ``route`` against their
    plain versions at ``C`` chains: noise off and the same noise tensors (two
    fields, ``(C, 2 m)`` low-rank normals), then the in-kernel generator
    (direction ``d`` on the counter ``+ d``) against the plain versions fed
    the host's reference normals of both counters (the first and the last
    :data:`SSOR_NOISE_CHECK` chains); ``x`` elementwise within TOL, ``f_c`` by
    :func:`compare_fc`.  The level's own route at ``C`` must be ``route``, and
    the stream kernels (and for a reach-2 or 3d level the split kernels too)
    must refuse it before they launch (``own_route=False``: ``route`` is
    held to the plain versions where the rule takes another).  With ``route``
    split or smem, those kernels are held against the phase kernels under one
    Philox stream."""
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    if level.ndir != 2 or (own_route and level.route(C) != route):
        raise AssertionError(f"ssor {name}: {level.ndir} sweeps, route {level.route(C)} at "
                             f"{C} chains, expected two sweeps and {route}")
    dev = level.coeffs.device
    vshape, m = level.op.vshape, level.op.m_lowrank

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.float32, generator=gen)

    f, x, xc = rand(*vshape), rand(C, *vshape), rand(C, *level.vc)
    before = dict(mv.launch_counts)
    refused = ("stream",) if level.reach == 1 and level.dim == 2 else ("split", "stream")
    for other in refused:
        try:
            mv.launch_descend(level, other, f, x.clone())
        except NotImplementedError:
            continue
        raise AssertionError(f"ssor {name}: the {other} route took the level")
    if mv.launch_counts != before:
        raise AssertionError(f"ssor {name}: a refused launch was counted")
    kw = {"cluster": cluster} if route == "split" else {}
    errs = {"x": 0.0, "f_c_over_scale": 0.0, "ascend_x": 0.0}
    for noisy in (False, True):
        xi = rand(2, C, *vshape) if noisy else None
        xi_lr = rand(C, 2 * m) if (noisy and m) else None
        tag = f"ssor {name} C={C} {route} {'shared noise' if noisy else 'noise off'}"
        want_x, want_fc = mv.descend_visit_plain(level, f, x, xi, xi_lr)
        got_x, got_fc = mv.launch_descend(level, route, f, x.clone(), xi, xi_lr, **kw)
        errs["x"] = max(errs["x"], compare(f"descend x {tag}", got_x, want_x))
        errs["f_c_over_scale"] = max(errs["f_c_over_scale"],
                                     compare_fc(f"descend f_c {tag}", got_fc, want_fc))
        want = mv.ascend_visit_plain(level, f, x, xc, xi, xi_lr)
        got = mv.launch_ascend(level, route, f, x.clone(), xc, xi, xi_lr, **kw)
        errs["ascend_x"] = max(errs["ascend_x"], compare(f"ascend x {tag}", got, want))
        del want_x, want_fc, got_x, got_fc, want, got
    xi_lr = rand(C, 2 * m) if m else None
    seed = 0x5EED_0014
    got_x, got_fc = mv.launch_descend(level, route, f, x.clone(), xi_lr=xi_lr, philox=(seed, 11),
                                      **kw)
    got = mv.launch_ascend(level, route, f, x.clone(), xc, xi_lr=xi_lr, philox=(seed, 13), **kw)
    for first, n in ((0, min(C, SSOR_NOISE_CHECK)), (max(C - SSOR_NOISE_CHECK, 0),
                                                   min(C, SSOR_NOISE_CHECK))):
        part = slice(first, first + n)
        tag = f"ssor {name} C={C} {route} in-kernel noise, chains {first}..{first + n - 1}"

        def ref(counter):
            return torch.stack([torch.as_tensor(common.philox_normals_reference(
                seed, counter + d, n, vshape, first_chain=first), device=dev) for d in (0, 1)])

        lr = xi_lr[part] if m else None
        want_x, want_fc = mv.descend_visit_plain(level, f, x[part], ref(11), lr)
        errs["x"] = max(errs["x"], compare(f"descend x {tag}", got_x[part], want_x))
        errs["f_c_over_scale"] = max(errs["f_c_over_scale"], compare_fc(
            f"descend f_c {tag}", got_fc[part], want_fc))
        want = mv.ascend_visit_plain(level, f, x[part], xc[part], ref(13), lr)
        errs["ascend_x"] = max(errs["ascend_x"], compare(f"ascend x {tag}", got[part], want))
    if route in ("split", "smem"):  # one Philox stream through these and the phase kernels
        stream = {"xi_lr": xi_lr, "philox": (seed, 31)}
        phase_x, phase_fc = mv.launch_descend(level, "phase", f, x.clone(), **stream)
        phase_a = mv.launch_ascend(level, "phase", f, x.clone(), xc, **stream)
        split_x, split_fc = mv.launch_descend(level, route, f, x.clone(), **stream, **kw)
        split_a = mv.launch_ascend(level, route, f, x.clone(), xc, **stream, **kw)
        tag = f"ssor {name} C={C} one Philox stream, {route} against phase kernel"
        errs[f"{route}_against_phase"] = {
            "descend_x": compare(f"descend x {tag}", split_x, phase_x),
            "descend_f_c_over_scale": compare_fc(f"descend f_c {tag}", split_fc, phase_fc),
            "ascend_x": compare(f"ascend x {tag}", split_a, phase_a)}
    torch.cuda.synchronize()
    smem = smem_launch_of(level, C) if route == "smem" else {}
    barriers = mv.smem_module(level).barrier_count if route == "smem" else mv.phase_barrier_count
    return {"level": name, "vshape": list(vshape), "offsets": len(level.op.offsets),
            "colours": level.coloring.n_colors, "stencil_form": level.stencil_form,
            "chains": C, "route": route, "cluster": smem.get("cluster", cluster),
            "threads": level.phase_threads(C) if route == "phase" else smem.get("threads"),
            "barriers_from_source": {k: barriers(level, k) for k in ("descend", "ascend")},
            **errs}


def ssor_stamps(level, C, noise):
    """The two-sweep phase launch by pass from the stamps build (in-kernel
    noise), at ``C`` chains on a 2d reach-1 level: the barriers each block
    passed must be ``mgmc_visit.phase_barrier_count``'s."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    dev = level.coeffs.device
    f = torch.rand(level.op.vshape, device=dev)
    x = torch.zeros((C,) + level.op.vshape, device=dev)
    xc = torch.randn((C,) + level.vc, device=dev)
    out = {}
    for kind in ("descend", "ascend"):
        stamps = torch.zeros((C, mv.PHASE_STAMP_WIDTH), dtype=torch.int64, device=dev)
        for _ in range(3):
            xi, xi_lr, philox = level._draw(noise, x, kind)
            if kind == "descend":
                mv.launch_descend(level, "phase", f, x, xi, xi_lr, philox, stamps=stamps)
            else:
                mv.launch_ascend(level, "phase", f, x, xc, xi, xi_lr, philox, stamps=stamps)
        torch.cuda.synchronize()
        pt = mv.pass_times(level, kind, stamps)
        pt["barriers_from_source"] = mv.phase_barrier_count(level, kind)
        if pt["barriers_per_block"] != [pt["barriers_from_source"]]:
            raise AssertionError(f"ssor stamps {kind} C={C}: the blocks passed "
                                 f"{pt['barriers_per_block']} barriers, the source places "
                                 f"{pt['barriers_from_source']}")
        out[kind] = pt
    return out


def ssor_route_kernel(level, route, kind):
    """The profiler's name of the kernel a launch of ``kind`` through ``route``
    runs on a 2d reach-1 level of one or two sweeps."""
    if route in ("smem", "phase"):
        return reach2_kernel(level, route, kind)
    return PROFILER_NAMES[VISIT_KERNELS[route][0 if kind == "descend" else 1]]


def ssor_levels(device):
    """The fused levels 0 (255^2 5-point) and 1 (127^2 3x3 box) of the
    flagship posterior's SSOR sampler (two sweeps a visit, the default
    distillation) and of its SOR sampler."""
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    op, _ = build_posterior(256, 8, FLAGSHIP_SEED, "near_exact", device)
    sampler = MultigridMCSampler(op, 5, smoother="SSOR", coarse_solver="Cholesky", omega=1.0,
                                 cycle=2)
    sor = MultigridMCSampler(op, 5, cycle=2, distill=False)
    return {"L0": sampler.fused_levels[0], "L1": sampler.fused_levels[1],
            "L0 one sweep": sor.fused_levels[0], "L1 one sweep": sor.fused_levels[1]}


def time_ssor_routes(levels, noise, chains=SSOR_TABLE_CHAINS):
    """The ``ssor_table``: device ms per launch (torch.profiler, the median of
    three interleaved windows), descend plus ascend, of every route that takes
    a 2d reach-1 level, at each count of ``chains`` on each of ``levels``
    (``{name: level}``: the flagship's 255^2 5-point and 127^2 3x3-box levels
    with two sweeps a visit and with one): the phase kernels at their rule's
    block size, the split kernels at the rule's cluster size at every count
    (``split_cluster(capped=False)``), the smem kernels at the rule's cluster
    size, placement and block size, and for one sweep the stream kernels where
    their rings fit; beside the route the rule takes.  Returns the rows and
    the faults: a two-sweep count where the rule's route takes more than
    :data:`SMEM_ROUTE_SLACK` times the fastest (one sweep keeps its routes:
    its rows are readings)."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    rows, faults = [], []
    limit = mv.dynamic_smem_limit()
    for name, level in levels.items():
        dev = level.coeffs.device
        for C in chains:
            f = torch.rand(level.op.vshape, device=dev)
            x = torch.zeros((C,) + level.op.vshape, device=dev)
            xc = torch.randn((C,) + level.vc, device=dev)
            S_split = mv.split_cluster(C, level.op.vshape, dev, capped=False)
            routes = ["phase", "smem"] + (["split"] if S_split is not None else [])
            if level.ndir == 1 and level.stream_bytes + mv.STREAM_STATIC_SMEM <= limit:
                routes.append("stream")
            cands = {}
            for route in routes:
                fns = visit_fns(level, route, noise, f, x, xc,
                                cluster=S_split if route == "split" else None)
                for kind, fn in zip(("descend", "ascend"), fns):
                    cands[(route, kind)] = (fn, ssor_route_kernel(level, route, kind))
            ms = device_ms_medians(cands, 10, 3)
            row = {"level": name, "vshape": list(level.op.vshape), "sweeps": level.ndir,
                   "stencil_form": level.stencil_form, "chains": C, "rule": level.route(C),
                   "split_cluster": S_split, "phase_threads": level.phase_threads(C),
                   **{f"smem_{k}": v for k, v in smem_launch_of(level, C).items()}}
            for route in routes:
                for kind in ("descend", "ascend"):
                    row[f"{route}_{kind}_ms"] = ms[(route, kind)]
                row[f"{route}_ms"] = ms[(route, "descend")] + ms[(route, "ascend")]
            best = min(routes, key=lambda r: row[f"{r}_ms"])
            row["fastest"] = best
            row["smem_over_rule"] = row["smem_ms"] / row[f"{row['rule']}_ms"]
            if level.ndir == 2 and row[f"{row['rule']}_ms"] > SMEM_ROUTE_SLACK * row[f"{best}_ms"]:
                faults.append(f"{name} C={C}: the rule takes {row['rule']} "
                              f"({row[row['rule'] + '_ms']} ms), {best} takes {row[best + '_ms']}")
            rows.append(row)
            del x, xc
    return rows, faults


def phase_ssor_check(device, smi, table):
    """The 2d two-sweep visits alone on the flagship's levels 0 (255^2
    5-point) and 1 (127^2 3x3 box): the smem kernels' registers and spills,
    both levels by pass from their stamps build and against the plain
    versions and the phase kernels at 256 chains and one chain; with
    ``table`` the route table (:func:`time_ssor_routes`, two sweeps and one)
    and the smem kernels' block-size and placement table
    (:func:`time_smem_variants`, two sweeps).  No result line; fails where a
    two-sweep route of the rule takes more than :data:`SMEM_ROUTE_SLACK` times
    the fastest."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise

    out = {"phase": "ssor_check", "card": smi}
    try:
        gen = torch.Generator(device=device)
        gen.manual_seed(19)
        noise = GeneratorNoise(FLAGSHIP_SEED + 19, device)
        levels = ssor_levels(device)
        two = {"L0": levels["L0"], "L1": levels["L1"]}
        out["smem_kernel_attributes"] = smem_kernel_attributes()
        out["routes"] = {name: {c: lv.route(c) for c in SSOR_TABLE_CHAINS}
                         for name, lv in two.items()}
        out["smem_checks"] = [check_ssor_level(lv, f"flagship {name}", c, gen, "smem",
                                               own_route=False)
                              for name, lv in two.items() for c in (SSOR_CHAINS[0], 1)]
        out["smem_pass_stamps"] = [reach2_pass_stamps(lv, int(name[1]), c, noise, "smem",
                                                      label="ssor")
                                   for name, lv in two.items() for c in (SSOR_CHAINS[0], 1)]
        emit(dict(out, partial=True))
        if table:
            out["ssor_table"], faults = time_ssor_routes(levels, noise)
            out["ssor_table_faults"] = faults
            emit(dict(out, partial=True))
            out["smem_table"] = time_smem_variants(two, noise)
            if faults:
                raise AssertionError("ssor_table: the rule's route is more than "
                                     f"{SMEM_ROUTE_SLACK} times the fastest: " + "; ".join(faults))
    except BaseException:
        out["failed"] = True
        raise
    finally:
        emit(out)


def phase_ssor(device, smi):
    """Two sweeps per visit (SSOR) on the visit kernels, through
    ``MultigridMCSampler.apply`` in float32:

    * path 1, the flagship posterior with ``smoother="SSOR"`` (255^2, 8
      near-exact measurements, 5 levels, W-cycle, omega 1, the default
      distillation) at 256 chains (levels 0 and 1 on the smem kernels where
      ``mgmc_visit_smem.SMEM_CHAINS`` lists them) and at one chain (the route
      the rule takes: split or smem), ms per step, kernel ms, launches by
      name, routes;
    * path 3, the biharmonic posterior (255^2 13-point, 256 chains) and the
      64^3 posterior (63^3 7-point, 32 chains) with SSOR levels, a few steps;
    * each level-0 form against its plain version (:func:`check_ssor_level`:
      the smem kernels on the flagship's levels 0 and 1 at 256 chains and one
      chain, the phase kernels at 256 chains, the split kernels at one chain
      with clusters of 16, reach 2 and 3d at their chains; smem and split
      against phase under one Philox stream), their device ms, plain ms and
      bounds (smem and phase side by side on both levels), the launches by pass
      from the stamps builds (barriers against the source's count);
    * the descend's ``f_c`` on every fused level of the flagship, SOR and SSOR,
      against a float64 visit (:func:`near_exact_fc`);
    * ``drivers.mg``'s SSOR config runs in the ``drivers`` phase, the JAX
      package's gate 3c in ``statistics`` (``kernels_ssor``)."""
    out = {"phase": "ssor", "card": smi}
    try:
        _ssor_parts(out, device)
    except BaseException:
        out["failed"] = True
        raise
    finally:
        emit(out)
    return out


def _ssor_parts(out, device):
    """The parts of :func:`phase_ssor`, each filling its key of ``out``."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    t0 = time.perf_counter()
    parts = out["part_seconds"] = {}
    gen = torch.Generator(device=device)
    gen.manual_seed(14)
    noise = GeneratorNoise(FLAGSHIP_SEED + 14, device)
    kwargs = dict(nlevel=5, smoother="SSOR", coarse_solver="Cholesky", omega=1.0, cycle=2)
    # path 1: the flagship with SSOR levels, 256 chains and one chain
    op, _ = build_posterior(256, 8, FLAGSHIP_SEED, "near_exact", device)
    f = torch.as_tensor(np.random.default_rng(0).uniform(size=op.vshape), dtype=torch.float32,
                        device=device)
    out["main_path"] = {}
    sampler = None
    for C in SSOR_CHAINS:
        sampler, res = drive_sampler(op, f, C, SSOR_STEPS, kwargs, sampler=sampler,
                                     levels_are=lambda lv: lv.ndir == 2)
        out["main_path"][f"flagship_{C}"] = res
    big, one = (out["main_path"][f"flagship_{C}"] for C in SSOR_CHAINS)
    level, level1 = sampler.fused_levels[0], sampler.fused_levels[1]
    if (big["route_by_level"].get(0) != "smem" or one["route_by_level"].get(0) not in (
            "split", "smem") or big["distill_level"] is None or 0 not in big["visited_levels"]):
        raise AssertionError(f"ssor: the flagship's paths {big}, {one}")
    parts["main_path"] = time.perf_counter() - t0
    C = SSOR_CHAINS[0]
    out["checks"] = [
        check_ssor_level(level, "flagship L0", C, gen, "smem"),
        check_ssor_level(level, "flagship L0", 1, gen, "smem", own_route=level.route(1) == "smem"),
        check_ssor_level(level1, "flagship L1", C, gen, "smem",
                         own_route=level1.route(C) == "smem"),
        check_ssor_level(level1, "flagship L1", 1, gen, "smem",
                         own_route=level1.route(1) == "smem"),
        check_ssor_level(level, "flagship L0", C, gen, "phase", own_route=False),
        check_ssor_level(level, "flagship L0", 1, gen, "split", cluster=SSOR_SPLIT_CLUSTER,
                         own_route=level.route(1) == "split"),
        check_ssor_level(level1, "flagship L1", 1, gen, "split",
                         cluster=mv.split_cluster(1, level1.op.vshape),
                         own_route=level1.route(1) == "split")]
    out["stamps"] = ssor_stamps(level, C, noise)
    out["smem_stamps"] = [reach2_pass_stamps(lv, li, C, noise, "smem", label="ssor")
                          for li, lv in ((0, level), (1, level1))]
    out["timings"] = {"phase": timed_visits(level, C, False, noise, ("phase",)),
                      "split": timed_visits(level, 1, False, noise, ("split",)),
                      "smem": time_phase_only_level(level, C, noise, "smem"),
                      "smem_one_chain": time_phase_only_level(level, 1, noise, "smem"),
                      "smem_L1": time_phase_only_level(level1, C, noise, "smem"),
                      "phase_L1": time_phase_only_level(level1, C, noise, "phase")}
    parts["flagship_checks"] = time.perf_counter() - t0 - sum(parts.values())
    # the descend's f_c on every fused level of the flagship, SSOR and SOR
    sor = MultigridMCSampler(op, 5, cycle=2, distill=False)
    out["near_exact_f_c"] = (
        [near_exact_fc(lv, f"SSOR L{li}", SSOR_CHAINS[0], gen)
         for li, lv in sorted(sampler.fused_levels.items())]
        + [near_exact_fc(lv, f"SOR L{li}", SSOR_CHAINS[0], gen)
           for li, lv in sorted(sor.fused_levels.items())])
    del sampler, sor, level, level1
    parts["near_exact_f_c"] = time.perf_counter() - t0 - sum(parts.values())
    # path 3: the reach-2 and the 3d posteriors with SSOR levels
    bih, _ = build_posterior(256, 8, BIHARMONIC_SEED, "near_exact", device, **BIHARMONIC)
    vol, _, fv = volume_posterior(VOLUME_NX, device)
    others = (("biharmonic", bih, f, SSOR_CHAINS[0], dict(kwargs), lambda lv: lv.reach == 2),
              ("volume", vol, fv, SSOR_VOLUME_CHAINS, dict(kwargs, nlevel=VOLUME_NLEVEL),
               lambda lv: lv.dim == 3))
    out["other_checks"], out["other_timings"] = [], []
    for name, other, fo, C, kw, kind in others:
        s_other, res = drive_sampler(other, fo, C, SSOR_OTHER_STEPS, kw, levels_are=kind,
                                     busy_steps=1)
        out["main_path"][name] = res
        lv = s_other.fused_levels[0]
        route = lv.route(C)
        out["other_checks"].append(check_ssor_level(lv, f"{name} L0", C, gen, route))
        t = time_phase_only_level(lv, C, noise, route)
        if route != "phase":  # the phase kernels' build beside
            phase = time_phase_only_level(lv, C, noise)
            t.update({f"phase_{k}": phase[k] for k in ("descend_ms", "descend_device_ms",
                                                       "ascend_ms", "ascend_device_ms")})
        t["name"] = name
        out["other_timings"].append(t)
        del s_other, lv
    parts["other_posteriors"] = time.perf_counter() - t0 - sum(parts.values())
    out["seconds"] = time.perf_counter() - t0


# -------------------------------------------------------------- phase: lowrank
#: measurement counts of the many-measurement checks: one past the kernels'
#: lane slots, the flagship's path count and the largest 2d count the port
#: promises (the JAX kernels admit about 278 on the flagship's 255^2 level at
#: one sweep); 3d up to 64
LOWRANK_COUNTS = (33, 64, 256)
LOWRANK_COUNTS_3D = (33, 64)
#: the separation of ``generate_measurements --dmin``: 0.05 in 2d as the
#: reference's script is run for the flagship, 0.04 at 256 points (257 points
#: 0.05 apart do not place in the unit square within the script's attempts),
#: 0.1 in 3d
LOWRANK_DMIN = {33: 0.05, 64: 0.05, 256: 0.04}
LOWRANK_DMIN_3D = 0.1
#: ``generate_measurements --seed``
LOWRANK_SEED = 2154157
#: chains of the elementwise checks (the split kernels at one chain)
LOWRANK_CHECK_CHAINS = 8
#: the measurements of the many-measurement path
LOWRANK_PATH_M = 64
#: steps a variant of the path takes (timed), and the moment gates' protocol
LOWRANK_STEPS = 10
LOWRANK_GATE = {"warmup": 30, "steps": 300}
#: the lowrank table (``--phases lowrank_table``): measurement counts and chains
LOWRANK_TABLE_COUNTS = (8, 32, 64, 128, 256)
LOWRANK_TABLE_CHAINS = (1, 32, 256)


def generated_measurements(dim, nmeas, dmin, seed=LOWRANK_SEED):
    """Locations, means and variances as ``python -m
    multigridmc_tpu_torch.drivers.generate_measurements --dim dim --nmeas nmeas
    --dmin dmin --seed seed`` writes them: pairwise ``dmin`` apart, means
    uniform in [1, 4], variances uniform in [1e-6, 2e-6]."""
    from multigridmc_tpu_torch.drivers import generate_measurements as gm

    points = gm.sample_points(nmeas + 1, dim, dmin, seed)
    return points[:-1], gm.average(nmeas, 1.0, 4.0), gm.variance(nmeas, 1e-6, 2e-6)


def lowrank_posterior(nx, nmeas, device, dim=2, pdemodel="shiftedlaplace_fd", order_one=False):
    """The prior ``pdemodel`` (Lambda 0.2) on an ``nx^dim`` lattice and
    ``nmeas`` measurements of :func:`generated_measurements`; with
    ``order_one`` each variance ``v`` becomes ``0.5 + 1e6 (v - 1e-6)`` (in [0.5,
    1.5]) for the elementwise checks, as :func:`phase_visits` takes them."""
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu_torch.models.posterior import MeasurementParameters, measured_operator
    from multigridmc_tpu_torch.models.prior import prior_operator

    dmin = LOWRANK_DMIN.get(nmeas, 0.05) if dim == 2 else LOWRANK_DMIN_3D
    locations, mean, var = generated_measurements(dim, nmeas, dmin)
    if order_one:
        var = 0.5 + 1e6 * (var - 1e-6)
    prior = prior_operator(pdemodel, Lattice((nx,) * dim), ConstantCorrelationLengthModel(0.2),
                           device=device, dtype=torch.float32)
    params = MeasurementParameters(measurement_locations=locations, mean=mean, variance=var)
    return measured_operator(prior, params), params


def lowrank_kernel(level, route, kind):
    """The profiler's name of the kernel a launch of ``kind`` through ``route``
    runs on ``level`` (any dimension, reach and route)."""
    if level.dim == 3 or level.reach > 1:
        return reach2_kernel(level, route, kind)
    return ssor_route_kernel(level, route, kind)


def check_lowrank_level(level, name, C, gen, route):
    """One level's visit kernels of ``route`` against their plain versions at
    ``C`` chains, noise off and the same noise tensors (``x`` within TOL,
    ``f_c`` by :func:`compare_fc`), then, for a route other than the phase
    kernels, against the phase kernels under one in-kernel Philox stream (the
    same tolerances; the split kernels at the cluster size of their rule).
    The stream kernels must refuse a level of more than their cap before they
    launch."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    dev, vshape, m, nd = level.coeffs.device, level.op.vshape, level.op.m_lowrank, level.ndir

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.float32, generator=gen)

    f, x, xc = rand(*vshape), rand(C, *vshape), rand(C, *level.vc)
    kw = {"cluster": mv.split_cluster(C, vshape, capped=False, m=m)} if route == "split" else {}
    if m > mv.STREAM_MAX_LOWRANK:
        before = dict(mv.launch_counts)
        try:
            mv.launch_descend(level, "stream", f, x.clone())
            raise AssertionError(f"lowrank {name}: the stream kernels took {m} measurements")
        except NotImplementedError:
            pass
        if mv.launch_counts != before:
            raise AssertionError(f"lowrank {name}: a refused launch was counted")
    errs = {"x": 0.0, "f_c_over_scale": 0.0, "ascend_x": 0.0}
    for noisy in (False, True):
        xi = (rand(C, *vshape) if nd == 1 else rand(2, C, *vshape)) if noisy else None
        xi_lr = rand(C, nd * m) if noisy else None
        tag = f"lowrank {name} m={m} C={C} {route} {'shared noise' if noisy else 'noise off'}"
        want_x, want_fc = mv.descend_visit_plain(level, f, x, xi, xi_lr)
        got_x, got_fc = mv.launch_descend(level, route, f, x.clone(), xi, xi_lr, **kw)
        errs["x"] = max(errs["x"], compare(f"descend x {tag}", got_x, want_x))
        errs["f_c_over_scale"] = max(errs["f_c_over_scale"],
                                     compare_fc(f"descend f_c {tag}", got_fc, want_fc))
        want = mv.ascend_visit_plain(level, f, x, xc, xi, xi_lr)
        got = mv.launch_ascend(level, route, f, x.clone(), xc, xi, xi_lr, **kw)
        errs["ascend_x"] = max(errs["ascend_x"], compare(f"ascend x {tag}", got, want))
        del want_x, want_fc, got_x, got_fc, want, got
    if route != "phase":
        stream = {"xi_lr": rand(C, nd * m), "philox": (0x5EED_0022, 7)}
        got = [(*mv.launch_descend(level, r, f, x.clone(), **stream, **k),
                mv.launch_ascend(level, r, f, x.clone(), xc, **stream, **k))
               for r, k in (("phase", {}), (route, kw))]
        tag = f"lowrank {name} m={m} C={C} one Philox stream, {route} against phase kernel"
        errs[f"{route}_against_phase"] = {
            "descend_x": compare(f"descend x {tag}", got[1][0], got[0][0]),
            "descend_f_c_over_scale": compare_fc(f"descend f_c {tag}", got[1][1], got[0][1]),
            "ascend_x": compare(f"ascend x {tag}", got[1][2], got[0][2])}
        del got
    torch.cuda.synchronize()
    return {"level": name, "m": m, "vshape": list(vshape), "sweeps": nd,
            "stencil_form": level.stencil_form, "chains": C, "route": route,
            "cluster": kw.get("cluster"),
            "names": [mv.kernel_name(level, route, k) for k in ("descend", "ascend")], **errs}


def lowrank_levels(device, m):
    """The fused levels the many-measurement checks take, each ``(name, level,
    [(chains, route), ...])``: the flagship's 255^2 and 127^2 levels with one
    sweep (phase at :data:`LOWRANK_CHECK_CHAINS`, split at one chain) and two
    (phase, split; the smem kernels where their table and the scratch fit),
    the biharmonic posterior's 255^2 13-point and 127^2 25-point levels (phase
    and smem), and for ``m`` up to 64 the 64^3 posterior's 63^3 7-point and
    31^3 27-point levels (phase and smem); O(1) variances.  Also the samplers,
    for the subtree checks."""
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    C = LOWRANK_CHECK_CHAINS
    out, samplers = [], {}
    op, _ = lowrank_posterior(256, m, device, order_one=True)
    for smoother in ("SOR", "SSOR"):
        sampler = MultigridMCSampler(op, 5, smoother=smoother, cycle=2, fused=True,
                                     fused_min_vertices=0, distill=False)
        for li in (0, 1):
            level = sampler.fused_levels[li]
            runs = [(C, "phase"), (1, "split")]
            if smoother == "SSOR" and level.route(C) == "smem":
                runs.append((C, "smem"))
            out.append((f"{smoother} L{li}", level, runs))
    op_bih, _ = lowrank_posterior(256, m, device, pdemodel="squared_shiftedlaplace_fd",
                                  order_one=True)
    bih = MultigridMCSampler(op_bih, 5, smoother="SOR", cycle=2, fused=True,
                             fused_min_vertices=0, distill=False)
    for li in (0, 1):
        level = bih.fused_levels[li]
        runs = [(C, "phase")] + ([(C, "smem")] if level.route(C) == "smem" else [])
        out.append((f"biharmonic L{li}", level, runs))
    samplers["flagship"] = lambda: MultigridMCSampler(op, 5, cycle=2, subtree=True)
    samplers["biharmonic"] = lambda: MultigridMCSampler(op_bih, 5, cycle=2, subtree=True)
    if m in LOWRANK_COUNTS_3D:
        op3, _ = lowrank_posterior(64, m, device, dim=3, order_one=True)
        vol = MultigridMCSampler(op3, 4, smoother="SOR", cycle=2, fused=True,
                                 fused_min_vertices=0, distill=False)
        for li in (0, 1):
            level = vol.fused_levels[li]
            runs = [(C, "phase")] + ([(C, "smem")] if level.route(C) == "smem" else [])
            out.append((f"3d L{li}", level, runs))
    return out, samplers


def lowrank_checks(device, gen):
    """Every visit kernel against its plain version at each count of
    :data:`LOWRANK_COUNTS` (3d :data:`LOWRANK_COUNTS_3D`): the levels of
    :func:`lowrank_levels` through each of their routes, and the subtree kernel
    (reach 1 on the flagship's levels 1-4, reach 2 on the biharmonic ones;
    :func:`check_subtree`, ``SUBTREE_TOL``: noise off, shared noise, the
    in-kernel generator with the low-rank draws' known answers past 32
    normals).  Returns the rows and the largest error by kernel name."""
    rows, worst, subtree = [], {}, []
    for m in LOWRANK_COUNTS:
        levels, samplers = lowrank_levels(device, m)
        for name, level, runs in levels:
            for C, route in runs:
                row = check_lowrank_level(level, name, C, gen, route)
                rows.append(row)
                for kname in row["names"]:
                    key = f"{kname}@m{m}"
                    worst[key] = max(worst.get(key, 0.0), row["x"], row["ascend_x"],
                                     row["f_c_over_scale"])
        cases = (("flagship_levels_1_to_4", samplers["flagship"], 9),
                 ("biharmonic_levels_1_to_3", samplers["biharmonic"], 25))
        err, srows = check_subtree(device, LOWRANK_CHECK_CHAINS, gen, cases)
        for r in srows:
            r["m"] = m
        subtree += srows
        worst[f"subtree@m{m}"] = err
        torch.cuda.empty_cache()
    return rows, subtree, worst


def lowrank_gate(name, sampler, op, C, device, exact):
    """The zero-mean protocol of :func:`volume_gate` (f = 0 from x = 0,
    :data:`LOWRANK_GATE` warm-up and steps at ``C`` chains) on ``sampler``:
    the mean and variance of the point observation at the centre and of the
    first measurement's functional ``B_0^T x`` within 4 standard errors of 0
    and of ``exact`` (float64 variances, ``observed_mean_and_variance``)."""
    from multigridmc_tpu_torch.models.posterior import measurement_vector
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise

    dim = len(op.vshape)
    W = torch.stack([torch.as_tensor(measurement_vector(op.lattice, np.full(dim, 0.5), 0.0),
                                     dtype=torch.float32, device=device).reshape(-1),
                     op.lowrank.B[0].float().reshape(-1)]).double()
    noise = GeneratorNoise(LOWRANK_SEED + 1, device)
    fz = torch.zeros(op.vshape, device=device)
    x = torch.zeros((C,) + op.vshape, device=device)
    for _ in range(LOWRANK_GATE["warmup"]):
        x = sampler.apply(noise, fz, x)
    zs = []
    for _ in range(LOWRANK_GATE["steps"]):
        x = sampler.apply(noise, fz, x)
        zs.append(x.reshape(C, -1).double() @ W.T)
    z = torch.stack(zs).cpu().numpy()
    out = {"chains": C, **LOWRANK_GATE}
    for k, obs in enumerate(("centre", "B0")):
        out[obs] = moments_gate(f"lowrank {name} {obs}", z[:, :, k], 0.0, exact[obs], C)
        out[obs]["exact_variance"] = exact[obs]
    return out


def lowrank_exact(op):
    """The exact float64 variances of the centre point and of ``B_0^T x``
    under ``op`` (:func:`lowrank_gate`'s observations)."""
    from multigridmc_tpu_torch.models.posterior import (measurement_vector,
                                                        observed_mean_and_variance)

    dim = len(op.vshape)
    op64 = op.to(dtype=torch.float64)
    zeros, zm = np.zeros(op.vshape), np.zeros(op.m_lowrank)
    return {"centre": observed_mean_and_variance(
                op64, zeros, zm, measurement_vector(op.lattice, np.full(dim, 0.5), 0.0))[1],
            "B0": observed_mean_and_variance(
                op64, zeros, zm, op.lowrank.B[0].double().cpu().numpy())[1]}


def lowrank_path(device):
    """The many-measurement path through the normal entry points: the
    flagship's posterior (255^2, FD prior, Lambda 0.2, 5-level W-cycle,
    Cholesky, float32) with the :data:`LOWRANK_PATH_M` measurements of
    ``generate_measurements --nmeas 64 --dmin 0.05 --seed 2154157``:
    ``MultigridMCSampler.apply`` distilled at 256 and 128 chains and at one
    chain, with SOR and with SSOR levels, and ``subtree=True`` at 256; the 64^3
    posterior (``--dim 3 --nmeas 64 --dmin 0.1``) distilled at 32 chains;
    each with its routes by level, ms and kernel ms per step
    (:func:`drive_sampler`), the 256-chain SOR, SSOR and subtree steps and the
    3d step through :func:`lowrank_gate`.  The launch counts are set to 0
    before and read after (``launches``, summed over the variants)."""
    m = LOWRANK_PATH_M
    op, _ = lowrank_posterior(256, m, device)
    f = torch.as_tensor(np.random.default_rng(0).uniform(size=op.vshape), dtype=torch.float32,
                        device=device)
    base = dict(nlevel=5, coarse_solver="Cholesky", omega=1.0, cycle=2)
    variants = (("distilled_256", dict(smoother="SOR", distill=True), 256, True),
                ("distilled_128", dict(smoother="SOR", distill=True), 128, False),
                ("distilled_1", dict(smoother="SOR", distill=True), 1, False),
                ("ssor_256", dict(smoother="SSOR", distill=True), 256, True),
                ("ssor_1", dict(smoother="SSOR", distill=True), 1, False),
                ("subtree_256", dict(smoother="SOR", subtree=True), 256, True))
    exact = lowrank_exact(op)
    out = {"measurements": m, "dmin": LOWRANK_DMIN[m], "lattice": [256, 256],
           "exact": exact, "steps": {}, "gates": {}}
    launches = {}
    samplers = {}
    for name, kwargs, C, gated in variants:
        key = tuple(sorted(kwargs.items()))
        sampler, res = drive_sampler(op, f, C, LOWRANK_STEPS, {**base, **kwargs},
                                     sampler=samplers.get(key))
        samplers[key] = sampler
        out["steps"][name] = res
        for k, v in {**res["launches"], **res["subtree_launches"]}.items():
            launches[k] = launches.get(k, 0) + v
        if gated:
            out["gates"][name] = lowrank_gate(name, sampler, op, C, device, exact)
    del samplers, sampler
    op3, _ = lowrank_posterior(64, m, device, dim=3)
    f3 = torch.as_tensor(np.random.default_rng(0).uniform(size=op3.vshape),
                         dtype=torch.float32, device=device)
    sampler3, res3 = drive_sampler(op3, f3, 32, LOWRANK_STEPS,
                                   dict(nlevel=4, smoother="SOR", coarse_solver="Cholesky",
                                        omega=1.0, cycle=2, distill=True),
                                   levels_are=lambda lv: lv.dim == 3)
    out["steps"]["volume_distilled_32"] = res3
    for k, v in res3["launches"].items():
        launches[k] = launches.get(k, 0) + v
    out["gates"]["volume_distilled_32"] = lowrank_gate("volume", sampler3, op3, 32, device,
                                                       lowrank_exact(op3))
    out["launches"] = launches
    del sampler3
    torch.cuda.empty_cache()
    return out


def lowrank_driver(device):
    """``python -m multigridmc_tpu_torch.drivers.mgmc`` once on a 255^2
    configuration (SOR multigrid, 5 levels, the MGMC time series alone) whose
    measurement file ``generate_measurements --nmeas 64 --dmin 0.05`` wrote:
    the fused visits' launches, the samples' mean and variance finite."""
    from multigridmc_tpu_torch.drivers import generate_measurements as gm
    from multigridmc_tpu_torch.drivers import mgmc as driver_mgmc
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            gm.main(["--dim", "2", "--nmeas", str(LOWRANK_PATH_M), "--dmin",
                     str(LOWRANK_DMIN[LOWRANK_PATH_M]), "--seed", str(LOWRANK_SEED),
                     "--output", "measurements.cfg"])
            with open("params_mgmc.cfg", "w") as out:
                out.write(DRIVER_CONFIG.format(
                    nx=256, nlevel=5, smoother="SOR", nchains=32, nsamples=200, nwarmup=20,
                    do_cholesky="false", do_ssor="false", schedule="",
                    cholesky='cholesky = { factorisation = "dense"; }'))
            mv.reset_launch_counts()
            t0 = time.perf_counter()
            text = run_driver(driver_mgmc.main, ["params_mgmc.cfg"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in mv.launch_counts.items() if v}
        finally:
            os.chdir(cwd)
    ms = re.search(r"multigridmc time per sample =\s+(\S+) ms", text)
    mean = re.search(r"multigridmc mean\s+=\s+(\S+) \+/-\s+(\S+)", text)
    var = re.search(r"multigridmc variance =\s+(\S+)", text)
    if ms is None or mean is None or var is None or not counts or not np.isfinite(
            [float(mean.group(1)), float(var.group(1))]).all():
        raise AssertionError("lowrank driver: no finite MGMC statistics or no visit launch:\n"
                             + text[-1500:])
    return {"measurements": LOWRANK_PATH_M, "seconds": seconds,
            "ms_per_sample": float(ms.group(1)), "mean": float(mean.group(1)),
            "mean_error": float(mean.group(2)), "variance": float(var.group(1)),
            "launches": counts}


def lowrank_times(level, route, C, noise, label):
    """Device ms of one descend and one ascend through ``route`` at ``C``
    chains on ``level`` (in-kernel noise, as the path draws it), the plain
    versions' ms, and the bound of each (:func:`visit_bound`)."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    dev, vshape = level.coeffs.device, level.op.vshape
    f = torch.rand(vshape, device=dev)
    x = torch.zeros((C,) + vshape, device=dev)
    xc = torch.randn((C,) + level.vc, device=dev)
    fns = dict(zip(("descend", "ascend"), visit_fns(level, route, noise, f, x, xc)))
    dev_ms = device_ms_medians({k: (fn, lowrank_kernel(level, route, k))
                                for k, fn in fns.items()})
    out = {"label": label, "m": level.op.m_lowrank, "vshape": list(vshape), "chains": C,
           "route": route}
    for kind, fn in fns.items():
        name = mv.kernel_name(level, route, kind)
        out[f"{kind}_name"] = name
        out[f"{kind}_ms"] = cuda_ms(fn, 3, 5 if C > 1 else 20)
        out[f"{kind}_device_ms"] = dev_ms[kind]
        bound, by, nbytes = visit_bound(level, C, False, kind)
        out.update({f"{kind}_bound_ms": bound, f"{kind}_bound_by": by,
                    f"{kind}_bound_bytes": nbytes})

    def plain_noise(kind):
        xi, xi_lr, _ = level._draw(_TensorNoise(noise), x, kind)
        return xi, xi_lr

    out["descend_plain_ms"] = cuda_ms(
        lambda: mv.descend_visit_plain(level, f, x, *plain_noise("descend")), 3, 2)
    out["ascend_plain_ms"] = cuda_ms(
        lambda: mv.ascend_visit_plain(level, f, x, xc, *plain_noise("ascend")), 3, 2)
    return out


def lowrank_kernel_times(device):
    """The many-measurement forms' times at 64 and 256 measurements (3d: 64)
    at the shapes their path gives them: the phase kernels on 255^2 at
    :data:`PHASE_CHAINS`, the split kernels on 255^2 at one chain, the smem
    kernels on the SSOR 255^2 level at 256 chains and on the biharmonic 255^2
    13-point and 127^2 25-point levels at 256, the phase kernels' reach-2 build
    on the biharmonic 255^2 level at 256, the 3d phase and smem kernels on
    63^3 and 31^3 at 32 chains, the subtree kernel at 256 chains."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    noise = GeneratorNoise(LOWRANK_SEED + 2, device)
    rows = []
    for m in (64, 256):
        op, _ = lowrank_posterior(256, m, device)
        sor = MultigridMCSampler(op, 5, smoother="SOR", cycle=2, fused=True, fused_min_vertices=0,
                                 distill=False)
        L0 = sor.fused_levels[0]
        rows.append(lowrank_times(L0, "phase", PHASE_CHAINS, noise, "flagship SOR 255^2"))
        rows.append(lowrank_times(L0, "split", 1, noise, "flagship SOR 255^2"))
        ssor = MultigridMCSampler(op, 5, smoother="SSOR", cycle=2, fused=True,
                                  fused_min_vertices=0, distill=False)
        S0 = ssor.fused_levels[0]
        rows.append(lowrank_times(S0, S0.route(256), 256, noise, "flagship SSOR 255^2"))
        op_b, _ = lowrank_posterior(256, m, device, pdemodel="squared_shiftedlaplace_fd")
        bih = MultigridMCSampler(op_b, 5, smoother="SOR", cycle=2, fused=True,
                                 fused_min_vertices=0, distill=False)
        for li in (0, 1):
            B = bih.fused_levels[li]
            rows.append(lowrank_times(B, B.route(256), 256, noise, f"biharmonic L{li}"))
        rows.append(lowrank_times(bih.fused_levels[0], "phase", 256, noise, "biharmonic L0"))
        sub = MultigridMCSampler(op, 5, cycle=2, subtree=True)
        kernel = sub.subtree
        f = torch.rand((256,) + tuple(kernel.vshape), device=device)
        xi = torch.randn((256, kernel.count_noise()), device=device)
        run = lambda: kernel.sample(noise, f)  # noqa: E731
        bound, by, nbytes = subtree_bound(kernel, 256)
        rows.append({"label": "flagship subtree", "m": m, "vshape": list(kernel.vshape),
                     "chains": 256, "route": "subtree", "subtree_name": "subtree_sample",
                     "subtree_ms": cuda_ms(run, 3, 3),
                     "subtree_device_ms": device_ms_median(run, "mgmc_subtree_kernel", 5),
                     "subtree_plain_ms": cuda_ms(lambda: st.subtree_sample_plain(kernel, f, xi),
                                                 2, 1),
                     "subtree_bound_ms": bound, "subtree_bound_by": by,
                     "subtree_bound_bytes": nbytes, "tables_shared": kernel.tables_shared})
        del sor, ssor, bih, sub, kernel, xi
        torch.cuda.empty_cache()
    op3, _ = lowrank_posterior(64, 64, device, dim=3)
    vol = MultigridMCSampler(op3, 4, smoother="SOR", cycle=2, fused=True, fused_min_vertices=0,
                             distill=False)
    for li in (0, 1):
        V = vol.fused_levels[li]
        rows.append(lowrank_times(V, V.route(32), 32, noise, f"64^3 L{li}"))
        if V.route(32) != "phase":
            rows.append(lowrank_times(V, "phase", 32, noise, f"64^3 L{li}"))
    return rows


def phase_lowrank(device, smi):
    """Levels of more than 32 measurements on the card: every kernel against
    its plain version and the routes against each other (:func:`lowrank_checks`),
    the many-measurement path with its moment gates (:func:`lowrank_path`), the
    driver (:func:`lowrank_driver`) and the new forms' times
    (:func:`lowrank_kernel_times`)."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

    gen = torch.Generator(device=device)
    gen.manual_seed(22)
    t0 = time.perf_counter()
    out = {"phase": "lowrank", "card": smi, "counts_2d": list(LOWRANK_COUNTS),
           "counts_3d": list(LOWRANK_COUNTS_3D), "tol": TOL, "subtree_tol": SUBTREE_TOL,
           "max_lowrank": {"2d": mv.max_lowrank(1024), "reach2_3d": mv.max_lowrank(512)}}
    out["checks"], out["subtree_checks"], out["max_abs_err"] = lowrank_checks(device, gen)
    out["checks_seconds"] = time.perf_counter() - t0
    out["path"] = lowrank_path(device)
    out["driver"] = lowrank_driver(device)
    out["times"] = lowrank_kernel_times(device)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def phase_lowrank_table(device, smi):
    """Device ms of a descend plus an ascend of every route a visit can take
    on the flagship's 255^2 and 127^2 levels (one sweep) at each count of
    :data:`LOWRANK_TABLE_COUNTS` and :data:`LOWRANK_TABLE_CHAINS`: the level's
    own route and the phase kernels (and the split kernels at one chain)."""
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    noise = GeneratorNoise(LOWRANK_SEED + 3, device)
    rows = []
    for m in LOWRANK_TABLE_COUNTS:
        op, _ = lowrank_posterior(256, m, device)
        sampler = MultigridMCSampler(op, 5, smoother="SOR", cycle=2, fused=True,
                                     fused_min_vertices=0, distill=False)
        for li in (0, 1):
            level = sampler.fused_levels[li]
            for C in LOWRANK_TABLE_CHAINS:
                routes = sorted({level.route(C), "phase"} | ({"split"} if C == 1 else set()))
                for route in routes:
                    dev, vshape = level.coeffs.device, level.op.vshape
                    f = torch.rand(vshape, device=dev)
                    x = torch.zeros((C,) + vshape, device=dev)
                    xc = torch.randn((C,) + level.vc, device=dev)
                    fns = dict(zip(("descend", "ascend"),
                                   visit_fns(level, route, noise, f, x, xc)))
                    ms = device_ms_medians({k: (fn, lowrank_kernel(level, route, k))
                                            for k, fn in fns.items()})
                    rows.append({"m": m, "level": li, "vshape": list(vshape), "chains": C,
                                 "route": route, "rule": route == level.route(C),
                                 "descend_ms": ms["descend"], "ascend_ms": ms["ascend"],
                                 "device_ms": None if None in ms.values() else sum(ms.values())})
        del sampler
        torch.cuda.empty_cache()
    emit({"phase": "lowrank_table", "card": smi, "rows": rows})
    return rows




# ------------------------------------------------------------- phase: parallel
#: the lattice cycle of phase ``parallel``: chains, steps timed, the
#: agglomeration threshold (the JAX package's default)
PARALLEL_LATTICE = {"chains": 4, "steps": 5, "agglomerate_below": 8}
#: the deterministic lattice cycle against ``MultigridPreconditioner`` in
#: float32, of the solver's output scale: the same cycle, but the
#: preconditioner's levels are the fused kernels (noise off) and its subtree
#: below 63^2 the distilled matrix, each with its own order of summation
PARALLEL_SOLVER_TOL = 1e-3


def _parallel_counts():
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    return {**mv.launch_counts, **ss.launch_counts, **st.launch_counts, **common.launch_counts}


def _reset_counts():
    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss

    for module in (mv, ss, st, common):
        module.reset_launch_counts()


def phase_parallel(device, nx, nlevel, C, n_meas, steps, smi, main):
    """The multi-device paths on one card, a world of one over NCCL: the
    chains path (:func:`parallel_chains_path`) and the lattice cycle
    (:func:`parallel_lattice_cycle`) on the flagship posterior."""
    import torch.distributed as dist

    from multigridmc_tpu_torch.parallel.dryrun import free_port
    from multigridmc_tpu_torch.parallel.mesh import init_distributed

    init_distributed(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0, device=device)
    try:
        out = {"phase": "parallel", "card": smi, "backend": dist.get_backend(), "world": 1}
        op, _ = build_posterior(nx, n_meas, FLAGSHIP_SEED, "near_exact", device)
        f = torch.as_tensor(np.random.default_rng(0).uniform(size=op.vshape),
                            dtype=torch.float32, device=device)
        out["chains_path"] = parallel_chains_path(op, f, nlevel, C, steps, main, device)
        out["lattice_cycle"] = parallel_lattice_cycle(op, f, nlevel, device)
    finally:
        dist.destroy_process_group()
    emit(out)
    return out


def parallel_chains_path(op, f, nlevel, C, steps, main, device):
    """``DataParallelMGMCSampler`` on a chains mesh of one rank at ``C``
    chains: a step bitwise the single-device sampler's under rank 0's noise,
    the routes of ``main_path``'s distilled variant (or, without it, the
    single-device sampler's), the visit launches of ``steps`` steps driven
    with the counts set to 0 just before, ms per step beside ``main_path``'s
    and beside the single-device sampler's, timed after it in this phase."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.parallel.data_parallel import DataParallelMGMCSampler
    from multigridmc_tpu_torch.parallel.mesh import chains_mesh, fold_seed
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

    kw = dict(smoother="SOR", coarse_solver="Cholesky", omega=1.0, cycle=2)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp = DataParallelMGMCSampler(op, nlevel, chains_mesh(device), **kw)
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t0
    setup_counts = {k: v for k, v in _parallel_counts().items() if v}
    single = MultigridMCSampler(op, nlevel, fused=True, distill=True, **kw)
    zeros = torch.zeros((C,) + op.vshape, dtype=torch.float32, device=device)
    noise = GeneratorNoise(FLAGSHIP_SEED, device)
    x = dp.apply(noise, f, zeros.clone())
    ref = single.apply(GeneratorNoise(fold_seed(FLAGSHIP_SEED, 0), device), f, zeros.clone())
    if not torch.equal(x, ref):
        raise AssertionError("parallel: the chains path's step is not bitwise the "
                             "single-device sampler's under rank 0's noise (max "
                             f"{float((x - ref).abs().max())})")
    sampler = dp.sampler
    visited = [li for li in sorted(sampler.fused_levels) if li < sampler.distill_level]
    routes = {li: sampler.fused_levels[li].route(C) for li in visited}
    want = ({li: single.fused_levels[li].route(C) for li in visited} if main is None
            else main["distilled"]["route_by_level"])
    if routes != want:
        raise AssertionError(f"parallel: the chains path's routes {routes} are not "
                             f"main_path's {want}")
    x = dp.apply(noise, f, x)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        x = dp.apply(noise, f, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: v for k, v in _parallel_counts().items() if v}
    expected = steps * sum(2 ** li for li in visited)
    visits = {kind: sum(counts.get(mv.KERNEL_NAMES[(route, kind)], 0) for route in mv.ROUTES)
              for kind in ("descend", "ascend")}
    if visits["descend"] != expected or visits["ascend"] != expected:
        raise AssertionError(f"parallel: chains path launches {counts}, expected "
                             f"{expected} visits each")
    if tuple(x.shape) != (C,) + op.vshape or not bool(torch.isfinite(x).all()):
        raise AssertionError("parallel: chains path samples not finite or of wrong shape")
    # the single-device sampler's steps, then the chains path's once more, in
    # this phase: the two ms/step compared on one card at one point of the run
    single_noise = GeneratorNoise(fold_seed(FLAGSHIP_SEED, 0), device)
    xs = single.apply(single_noise, f, x.clone())
    turns = {}
    for name, fn in (("single_device", lambda x: single.apply(single_noise, f, x)),
                     ("chains_path_again", lambda x: dp.apply(noise, f, x))):
        xs = fn(xs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            xs = fn(xs)
        torch.cuda.synchronize()
        turns[name] = 1e3 * (time.perf_counter() - t0) / steps
    return {"chains": C, "steps": steps, "bitwise_single_device": True,
            "single_device_ms_per_step": turns["single_device"],
            "ms_per_step_again": turns["chains_path_again"],
            "route_by_level": routes, "distill_level": sampler.distill_level,
            "setup_seconds": setup_seconds, "setup_launches": setup_counts,
            "launches": counts, "ms_per_step": 1e3 * dt / steps,
            "samples_per_s": C * steps / dt,
            "main_path_distilled_ms_per_step": main and main["distilled"]["ms_per_step"],
            "main_path_distilled_samples_per_s": main and main["distilled"]["samples_per_s"]}


def parallel_lattice_cycle(op, f, nlevel, device):
    """``ShardedMGMCSampler`` on a 1x1 lattice mesh, W-cycle,
    :data:`PARALLEL_LATTICE` chains: noise off against
    ``MultigridPreconditioner`` (float32, :data:`PARALLEL_SOLVER_TOL` of its
    scale), ``"sharded"`` noise finite with the padding exactly zero, ms per
    step."""
    from multigridmc_tpu_torch.parallel.cycle import ShardedMGMCSampler, pad_field
    from multigridmc_tpu_torch.parallel.mesh import multihost_lattice_mesh
    from multigridmc_tpu_torch.samplers.base import GeneratorNoise
    from multigridmc_tpu_torch.solvers.multigrid import MultigridPreconditioner

    cfg = PARALLEL_LATTICE
    mesh = multihost_lattice_mesh(2, chains=1, mesh_shape=(1, 1), device=device)
    lkw = dict(smoother="SOR", cycle=2, agglomerate_below=cfg["agglomerate_below"])
    t0 = time.perf_counter()
    det = ShardedMGMCSampler(op, nlevel, mesh, deterministic=True, **lkw)
    setup_seconds = time.perf_counter() - t0
    pre = MultigridPreconditioner(op, nlevel, smoother="SOR", cycle=2)
    b = torch.randn((cfg["chains"],) + op.vshape, dtype=op.dtype, device=device,
                    generator=torch.Generator(device=device).manual_seed(3))
    pn = tuple(m + 1 for m in op.vshape)
    got = det.apply(None, pad_field(b, op.vshape),
                    torch.zeros((cfg["chains"],) + pn, dtype=op.dtype, device=device))
    want = pre.apply(b)
    scale = float(want.abs().max())
    err = float((got[..., :op.vshape[0], :op.vshape[1]] - want).abs().max())
    if not err <= PARALLEL_SOLVER_TOL * scale:
        raise AssertionError(f"parallel: the deterministic lattice cycle is {err} from "
                             f"MultigridPreconditioner (limit {PARALLEL_SOLVER_TOL} x {scale})")
    prod = ShardedMGMCSampler(op, nlevel, mesh, noise_mode="sharded", **lkw)
    fp = pad_field(f, op.vshape)
    xl = torch.zeros((cfg["chains"],) + pn, dtype=op.dtype, device=device)
    noise = GeneratorNoise(FLAGSHIP_SEED, device)
    xl = prod.apply(noise, fp, xl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cfg["steps"]):
        xl = prod.apply(noise, fp, xl)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    padding = max(float(xl[..., -1, :].abs().max()), float(xl[..., :, -1].abs().max()))
    if not bool(torch.isfinite(xl).all()) or padding != 0.0:
        raise AssertionError(f"parallel: sharded-noise lattice cycle not finite or its "
                             f"padding not zero ({padding})")
    return {"mesh": mesh.shape, "vshape": list(op.vshape), "padded": list(pn),
            "chains": cfg["chains"], "steps": cfg["steps"], "nlevel": nlevel, "cycle": 2,
            "sharded_levels": [lv.sharded for lv in prod.levels],
            "distill_level": prod.distill_level, "setup_seconds": setup_seconds,
            "deterministic_against_preconditioner": {"max_abs_err": err, "scale": scale,
                                                     "limit": PARALLEL_SOLVER_TOL * scale},
            "sharded_ms_per_step": 1e3 * dt / cfg["steps"],
            "sharded_samples_per_s": cfg["chains"] * cfg["steps"] / dt,
            "padding_max_abs": padding, "sample_std": float(xl.std())}


def phase_multichip(smi):
    """Four ranks over NCCL, one card each (``--phases multichip``): the
    chains path at 4 x 256 chains of the flagship and the lattice cycle on a
    2x2 mesh at 255^2, through the port's launcher
    (``multigridmc_tpu_torch.parallel.dryrun.task_multichip``).  Raises with
    fewer than four cards."""
    from multigridmc_tpu_torch.parallel import dryrun

    world = 4
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"multichip: needs {world} CUDA devices, found "
                           f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    res = dryrun.launch("multichip", world, device="cuda", timeout=1500)
    seconds = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        row = {k.split("/", 1)[1]: res[k].tolist() for k in res if k.startswith(f"{r}/")
               and not k.endswith("/log")}
        for key in ("chains_route_by_level", "lattice_profile"):
            row[key] = json.loads(row[key])
        ranks.append(row)
    r0 = ranks[0]
    faults = []
    for r, row in enumerate(ranks):
        if not (row["chains_bitwise_single_device"] and row["chains_finite"]
                and row["lattice_finite"]):
            faults.append(f"rank {r}: chains path not bitwise the single-device sampler or "
                          "output not finite")
        if row["lattice_replicated_spread"] != 0.0:
            faults.append(f"rank {r}: replicated levels differ across the lattice shards by "
                          f"{row['lattice_replicated_spread']}")
    if not r0["chains_pairwise_distinct"]:
        faults.append("two ranks drew the same chains")
    if not r0["lattice_global_err"] <= r0["lattice_global_limit"]:
        faults.append(f"global-noise 2x2 cycle {r0['lattice_global_err']} from the world of "
                      f"one (limit {r0['lattice_global_limit']})")
    emit({"phase": "multichip", "card": smi, "world": world, "seconds": seconds,
          "chains_samples_per_s_world": r0["chains_samples_per_s_world"],
          "lattice_global_err": r0["lattice_global_err"],
          "lattice_global_limit": r0["lattice_global_limit"], "ranks": ranks,
          "faults": faults})
    if faults:
        raise AssertionError("multichip: " + "; ".join(faults))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(sorted(ALL_PHASES)),
                        help="comma-separated subset of kernels,main_path,band,alternating,"
                             "drivers,statistics,biharmonic,volume,ssor,lowrank,parallel "
                             "to run (device and build always run; 'threads' adds a "
                             "block-size table, 'passes' the phase kernels' checks and "
                             "breakdown by pass, 'compare' the phase kernels' times and "
                             "the main path (runs on a parent tree too), 'new' the third "
                             "slice's kernels alone, "
                             "'visits' the visit kernels of the three routes alone, "
                             "'sweeps' the sweep kernels of both routes alone, "
                             "'sweep_check', 'sweep_stamps' (with 'sweep_passes') and "
                             "'sweep_threads' the one-block sweeps' checks, breakdown by "
                             "pass and block-size table alone, 'reach2_check' the reach-2 "
                             "visits' stamps and checks alone, 'smem_table' with the smem "
                             "kernels' block-size and placement table, 'volume_check' the 3d "
                             "visits' stamps and checks alone, 'volume_table' with the 3d "
                             "smem kernels' route and placement table, 'ssor_check' the 2d "
                             "two-sweep smem visits' stamps and checks alone, 'ssor_table' "
                             "with their route and placement table, 'sweep3d_check' the "
                             "smem3d sweeps' checks, times and paths alone, 'sweep3d_table' "
                             "with their configuration and route table; 'multichip' four ranks "
                             "over NCCL, one card each: the chains path and the 2x2 lattice "
                             "cycle); 'lowrank_check' the many-measurement checks alone, "
                             "'lowrank_table' the many-measurement routes' table; the ok line "
                             "needs exactly the default eleven")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = "cuda"
    from multigridmc_tpu_torch.utils import runtime  # noqa: F401  (precision policy)

    nx, nlevel, C, n_meas, steps = 256, 5, 256, 8, 30
    t_start = time.perf_counter()
    laps = {}

    def lap(name):
        """Seconds since the last lap, kept under ``name`` for the total line."""
        laps[name] = time.perf_counter() - t_start - sum(laps.values())

    smi = phase_device()
    phase_build()
    lap("device and build")
    if "threads" in phases:
        phase_threads(device, nx, nlevel, C, n_meas, smi)
    if "passes" in phases:  # the phase kernels' breakdown by pass alone
        phase_passes(device, nx, nlevel, n_meas, smi)
    if "compare" in phases:  # what a tree and its parent both run
        phase_compare(device, nx, nlevel, C, n_meas, steps, smi)
    if "new" in phases:  # the third slice's kernels alone
        from multigridmc_tpu_torch.samplers.base import GeneratorNoise

        gen = torch.Generator(device=device)
        gen.manual_seed(11)
        phase_new_kernels(device, nx, nlevel, C, n_meas, gen, GeneratorNoise(5, device))
    if "visits" in phases:  # the visit kernels of the three routes alone
        gen = torch.Generator(device=device)
        gen.manual_seed(11)
        phase_visits(device, nx, nlevel, C, n_meas, gen, smi)
    if phases & {"reach2_check", "smem_table"}:  # the reach-2 visits alone (no result line)
        phase_reach2(device, nlevel, C, smi, "smem_table" in phases)
    if phases & {"volume_check", "volume_table"}:  # the 3d visits alone (no result line)
        phase_volume_check(device, smi, "volume_table" in phases)
    if phases & {"ssor_check", "ssor_table"}:  # the 2d two-sweep visits alone (no result line)
        phase_ssor_check(device, smi, "ssor_table" in phases)
    if phases & {"sweep3d_check", "sweep3d_table"}:  # the smem3d sweeps alone (no result line)
        phase_sweep3d(device, smi, "sweep3d_table" in phases)
    if "sweep_check" in phases:  # the one-block sweeps against their plain versions alone
        gen = torch.Generator(device=device)
        gen.manual_seed(11)
        errs, body_err, rows = check_sweeps(device, gen, nx, nlevel, n_meas)
        emit({"phase": "sweep_check", "max_abs_err": errs,
              "passes_against_generic_max_abs_err": body_err, "sweep_checks": rows})
    if "sweep_threads" in phases:  # the passes body's block-size table alone
        from multigridmc_tpu_torch.samplers.base import GeneratorNoise

        rows, faults = time_sweep_threads(device, GeneratorNoise(5, device), nx, nlevel, n_meas)
        emit({"phase": "sweep_threads", "card": smi, "rows": rows, "faults": faults})
        if faults:
            raise AssertionError("sweep_threads: the rule's block size is more than "
                                 f"{SPLIT_SIZE_SLACK} times the best's: " + "; ".join(faults))
    if "sweeps" in phases:  # the sweep kernels of both routes alone
        from multigridmc_tpu_torch.samplers.base import GeneratorNoise

        gen = torch.Generator(device=device)
        gen.manual_seed(11)
        phase_sweeps(device, gen, GeneratorNoise(5, device), smi, nx, nlevel, n_meas)
    if "sweep_stamps" in phases:  # the one-block sweeps' launches by pass alone
        from multigridmc_tpu_torch.samplers.base import GeneratorNoise

        bodies = ("generic", "passes") if "sweep_passes" in phases else ("generic",)
        emit({"phase": "sweep_stamps", "card": smi,
              "passes_kernel_attributes": sweep_kernel_attributes(),
              "stamps": time_sweep_passes(device, GeneratorNoise(5, device), bodies, nx, nlevel,
                                          n_meas)})
    if "lowrank_check" in phases:  # the many-measurement checks alone (no result line)
        gen = torch.Generator(device=device)
        gen.manual_seed(22)
        rows, subtree_rows, worst = lowrank_checks(device, gen)
        emit({"phase": "lowrank_check", "checks": rows, "subtree_checks": subtree_rows,
              "max_abs_err": worst})
    if "lowrank_table" in phases:  # the many-measurement routes' table (no result line)
        phase_lowrank_table(device, smi)
    if "multichip" in phases:  # four ranks over NCCL, one card each (no result line)
        phase_multichip(smi)
        lap("multichip")
    if "kernels" in phases:
        errs, timings, sweep_timings, third = phase_kernels(device, nx, nlevel, C, n_meas, smi)
        lap("kernels")
    if "main_path" in phases:
        counts, main = phase_main_path(device, nx, nlevel, C, n_meas, steps, smi)
        lap("main_path")
    if "band" in phases:
        phase_band(device, nx, n_meas, smi)
        lap("band")
    if "alternating" in phases:
        alternating = phase_alternating(device, nx, nlevel, C, n_meas, steps, smi)
        lap("alternating")
    if "drivers" in phases:
        driver_counts, _ = phase_drivers(device, nx, nlevel, n_meas, C, nsamples=2000, nwarmup=200,
                                         smi=smi)
        lap("drivers")
    if "statistics" in phases:
        statistics = phase_statistics(device, 64, C, warmup=50, steps=300)
        lap("statistics")
    if "biharmonic" in phases:
        biharmonic = phase_biharmonic(device, nlevel, C, n_meas, smi)
        lap("biharmonic")
    if "volume" in phases:
        volume = phase_volume(device, smi)
        lap("volume")
    if "ssor" in phases:
        ssor = phase_ssor(device, smi)
        lap("ssor")
    if "lowrank" in phases:
        lowrank = phase_lowrank(device, smi)
        lap("lowrank")
    if "parallel" in phases:
        parallel = phase_parallel(device, nx, nlevel, C, n_meas, steps, smi,
                                  main if "main_path" in phases else None)
        lap("parallel")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start, "phase_seconds": laps})
    if phases != ALL_PHASES:
        print("partial run: no result line")
        return 0

    from multigridmc_tpu_torch.ops.kernels import common
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
    from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss_module

    kernels = []
    # the visits at level 0, the shape that dominates each path, and their
    # launches on the path of each route: the phase kernels in the flagship's
    # distilled steps at PHASE_CHAINS chains (the 256-chain variants take them
    # on 127^2: launches_by_variant), the split kernels in the one-chain MGMC
    # series of drivers.mgmc, the stream kernels in the steps with every
    # level's visit fused at 256 chains, whose 255^2 level takes them
    # (STREAM_MIN_CHAINS); where it did not, on no path: their row says so
    stream_path = ("main_path all_levels_fused"
                   if "stream" in main["all_levels_fused"]["route_by_level"].values() else None)
    paths = {"phase": (f"main_path distilled_{PHASE_CHAINS}_chains",
                       counts[f"distilled_{PHASE_CHAINS}_chains"], timings["phase_chains"][0]),
             "stream": (stream_path, counts["all_levels_fused"], timings["at_C"][0]),
             "split": ("drivers", driver_counts, timings["one_chain"][0])}
    for route, source in (("phase", "mgmc_visit.cu"), ("stream", "mgmc_visit_stream.cu"),
                          ("split", "mgmc_visit_split.cu")):
        path, launches, t = paths[route]
        for name, kind, line in zip(VISIT_KERNELS[route], ("descend", "ascend"), (700, 847)):
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"multigridmc_tpu_torch/csrc/{source}",
                "replaces": f"multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py:{line}",
                "launches": launches[name], "path": path,
                "launches_by_variant": {v: c[name] for v, c in counts.items()},
                "launches_parallel_chains_path": parallel["chains_path"]["launches"].get(name, 0),
                "max_abs_err": errs[name],
                "swapped_order_max_abs_err": alternating["max_abs_err"][name],
                "ms": t[f"{name}_ms"], "device_ms": t[f"{name}_device_ms"],
                "events_over_device": t[f"{name}_events_over_device"],
                "plain_ms": t[f"{kind}_plain_ms"],
                "bound_ms": t[f"{kind}_bound_ms"], "bound_by": t[f"{kind}_bound_by"],
                "bound_bytes": t[f"{kind}_bytes"], "library_ms": None,
                "shape": {"chains": t["chains"], "vshape": t["vshape"],
                          "cluster": t["split_cluster"] if route == "split" else 1},
            })
            if route == "phase":  # level 1 beside, and the stamps' breakdown by pass
                t1 = timings["phase_chains"][1]
                passes = next(r[kind] for r in timings["phase_passes"]
                              if r["level"] == 0 and r["chains"] == PHASE_CHAINS)
                kernels[-1].update({
                    "design": "the passes of level_passes.cuh shared with the subtree kernel: "
                              "one level's tables in shared memory where they fit, each "
                              "low-rank term in one pass, every reach-1 stencil in registers "
                              "with several points per lane in flight, the colour rows over "
                              "all warps, the block size by chain count",
                    "threads": t["threads"],
                    "at_level_1": {"vshape": t1["vshape"], "chains": t1["chains"],
                                   "ms": t1[f"{name}_ms"], "device_ms": t1[f"{name}_device_ms"],
                                   "plain_ms": t1[f"{kind}_plain_ms"],
                                   "bound_ms": t1[f"{kind}_bound_ms"],
                                   "bound_by": t1[f"{kind}_bound_by"]},
                    "barriers_per_launch": passes["barriers_per_block"][0],
                    "per_pass_us": passes["passes"]})
    # the probe: launched where the subtree variant of the main path is built
    probe = third["probe"]
    kernels.append({
        "name": "smem_probe", "route": "cuda",
        "source": "multigridmc_tpu_torch/csrc/smem_probe.cu",
        "replaces": "multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py:84",
        "launches": counts["subtree_kernel"]["smem_probe"], "max_abs_err": probe["max_abs_err"],
        "ms": probe["ms"], "device_ms": probe["device_ms"], "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "bound_bytes": probe["bound_bytes"], "library_ms": probe["library_ms"],
        "library_device_ms": probe["library_device_ms"],
        "shape": {"copied": [8, 128], "shared_bytes": probe["limit_bytes"]},
    })
    # the sweep kernels of both routes at the drivers' shape, one chain of
    # 255^2, with the one-block route's 256-chain figures beside; their
    # launches are those of the two driver runs (the split route: the
    # one-chain SSOR series and drivers.mg's solve with its levels composed;
    # the one-block route's passes body: the replica chains of the convergence
    # tables and the distillation's set-up).  The passes body's 3d build at
    # 32 x 31^3 27-point, its launches those of the volume phase's composed
    # step at 32 chains (its 31^3 27-point level; every sweep of that run is
    # 3d, so the passes body's count is the 3d build's), and its reach-2
    # build at 256 x 127^2 25-point (no path: the composed biharmonic step is
    # not driven).  The generic body of sor_sweep.cu at 32 x 63^3 7-point,
    # beside the smem3d body that shape takes now, its launches too those of
    # the composed step (none: the reference the bodies are held to)
    vol_main = volume["main_path"][f"distilled_{VOLUME_CHAINS[0]}"]
    composed_name = f"composed_{VOLUME_CHAINS[0]}"
    composed = volume["main_path"][composed_name]["sweep_launches"]
    st = next(t for t in sweep_timings if t["case"] == "2d_255_5pt_one_chain")
    wide = next(t for t in sweep_timings if t["case"] == "2d_255_5pt")
    galerkin = next(t for t in sweep_timings if t["case"] == "2d_127_9pt_galerkin")
    generic = next(t for t in sweep_timings if t["case"] == "3d_63_7pt")
    dim3 = next(t for t in sweep_timings if t["case"] == "3d_31_27pt_galerkin")
    reach2 = next(t for t in sweep_timings if t["case"] == "2d_127_25pt_reach2")
    for name, key, kernel_line in (("sweep_batched", "sweep", 194),
                                   ("gibbs_sweep_batched", "gibbs", 246)):
        for route, source in (("", "sor_sweep_passes.cu"), ("split_", "sor_sweep_cluster.cu"),
                              ("generic_", "sor_sweep.cu"), ("passes_3d_", "sor_sweep_passes.cu"),
                              ("passes_reach2_", "sor_sweep_passes.cu")):
            entry = name + ("_" + route[:-1] if route else "")
            t = {"generic_": generic, "passes_3d_": dim3, "passes_reach2_": reach2}.get(route, st)
            prefix = route if route in ("split_", "generic_") else ""
            launches, path, err = driver_counts.get(entry, 0), "drivers", errs.get(entry)
            if route in ("generic_", "passes_3d_"):
                launches = composed.get(name + ("_generic" if route == "generic_" else ""), 0)
                path = f"volume {composed_name}" if launches else None
            elif route == "passes_reach2_":
                launches, path = 0, None
            if route in ("passes_3d_", "passes_reach2_"):
                err = errs[name]
            kernels.append({
                "name": entry, "route": "cuda",
                "source": f"multigridmc_tpu_torch/csrc/{source}",
                "replaces": f"multigridmc_tpu/ops/kernels/sor_pallas_v2.py:{kernel_line}",
                "launches": launches, "max_abs_err": err, "path": path,
                "ms": t[f"{prefix}{key}_ms"], "device_ms": t[f"{prefix}{key}_device_ms"],
                "events_over_device": t[f"{prefix}{key}_events_over_device"],
                "plain_ms": t[f"{key}_plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "bound_bytes": t["bound_bytes"],
                "library_ms": None, "shape": {"chains": t["chains"], "vshape": t["vshape"],
                                              "cluster": t.get("split_cluster") if route == "split_"
                                              else 1},
            })
            if route in ("passes_3d_", "passes_reach2_"):
                kernels[-1].update({
                    "build": " ".join(ss_module.passes_flags(*(
                        (1, 3) if route == "passes_3d_" else (2, 2)))),
                    "generic_device_ms": t[f"generic_{key}_device_ms"],
                    "design": "the passes of level_passes.cuh in the reach-2 / 3d build: the "
                              "phase kernels' stencil forms and colour rows with no low-rank "
                              "term, the fields in device memory, 512 threads a block at most"})
            if not route:
                kernels[-1]["design"] = (
                    "the passes of level_passes.cuh with no low-rank term: the stencil in "
                    "registers with several points per lane in flight, each colour's rows over "
                    "all warps from a rows table, the Gibbs rhs packed by colour, one kernel per "
                    "stencil form, the block size by chain count")
                for label, w in (("at_256_chains", wide), ("at_256_chains_127_9pt", galerkin)):
                    kernels[-1][label] = {
                        "vshape": w["vshape"], "threads": w["threads"],
                        "ms": w[f"{key}_ms"], "device_ms": w[f"{key}_device_ms"],
                        "generic_device_ms": w[f"generic_{key}_device_ms"],
                        "plain_ms": w[f"{key}_plain_ms"], "bound_ms": w["bound_ms"],
                        "bound_by": w["bound_by"], "bound_bytes": w["bound_bytes"]}
    # the smem3d body (sor_sweep_smem3d.cu: the 3d 7-point form of rows 4 /
    # 5 on fields too large for one block) at 128 x 63^3 on the paths at full
    # width (phase volume's sweep3d_path): the 64^3 SSOR Gibbs sampler (the
    # Gibbs kernel, twice a step) and the solve of 128 right-hand sides (the
    # deterministic kernel); 32 chains and the generic body beside
    s3 = volume["sweep3d_path"]
    for name, key, kernel_line in (("sweep_batched", "sweep", 194),
                                   ("gibbs_sweep_batched", "gibbs", 246)):
        entry = f"{name}_smem3d"
        t, t32 = (next(r for r in volume["sweep3d_timings"] if r["chains"] == c)
                  for c in (SWEEP3D_PATH["chains"], SWEEP3D_CHAINS[0]))
        on = s3["smem3d"] if key == "gibbs" else s3["solve"]
        kernels.append({
            "name": entry, "route": "cuda",
            "source": "multigridmc_tpu_torch/csrc/sor_sweep_smem3d.cu",
            "replaces": f"multigridmc_tpu/ops/kernels/sor_pallas_v2.py:{kernel_line}",
            "launches": on["launches"].get(entry, 0),
            "path": "volume sweep3d_path " + ("ssor_sampler" if key == "gibbs" else "solve"),
            "max_abs_err": max(volume["sweep3d_errs"][entry], errs.get(entry, 0.0)),
            "against_generic_max_abs_err": max(r["against_generic"]
                                               for r in volume["sweep3d_checks"]),
            "ms": t[f"{key}_ms"], "device_ms": t[f"{key}_device_ms"],
            "events_over_device": t[f"{key}_events_over_device"],
            "plain_ms": t[f"{key}_plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bound_bytes": t["bound_bytes"], "library_ms": None,
            "generic_ms": t[f"generic_{key}_ms"],
            "generic_device_ms": t[f"generic_{key}_device_ms"],
            "over_generic": t[f"{key}_over_generic"],
            "shape": {"chains": t["chains"], "vshape": t["vshape"], "b_batched": False,
                      **t[f"{key}_config"]},
            "at_32_chains": {"device_ms": t32[f"{key}_device_ms"],
                             "generic_device_ms": t32[f"generic_{key}_device_ms"],
                             "bound_ms": t32["bound_ms"], "plain_ms": t32[f"{key}_plain_ms"],
                             **t32[f"{key}_config"]},
            "per_pass_us": t["stamps"][key]["passes"],
            "registers": t["stamps"][key]["registers"],
            "local_bytes": t["stamps"][key]["local_bytes"],
            "barriers_per_launch": t["stamps"][key]["barriers_per_block"][0],
            **({"path_sweep_device_ms": s3["smem3d"]["sweep_device_ms"],
                "path_generic_sweep_device_ms": s3["generic"]["sweep_device_ms"],
                "path_ms_per_step": s3["smem3d"]["ms_per_step"],
                "path_generic_ms_per_step": s3["generic"]["ms_per_step"]}
               if key == "gibbs" else {}),
            "design": "each chain's field in slabs of z-planes over a cluster of up to 16 "
                      "blocks (the 3d visits' slab helpers and tables), the neighbours' edge "
                      "planes copied into ghost planes after each cluster barrier, interior "
                      "points with scalar coefficients and no bounds test, the diagonal's "
                      "reciprocal, x copied in and written back once"})
    # the four raw-array entry points share those kernels (one chain: the
    # split route, many: the passes body); their launches are those of their
    # own path (drive_v1_path)
    for name in V1_NAMES:
        t = third["v1_timings"][name]
        source = "sor_sweep_cluster.cu" if t["route"][0] == "split" else "sor_sweep_passes.cu"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"multigridmc_tpu_torch/csrc/{source}",
            "replaces": f"multigridmc_tpu/ops/kernels/sor_pallas.py:{V1_LINES[name]}",
            "launches": third["v1_counts"][name], "max_abs_err": third["v1_errs"][name],
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_bytes": t["bound_bytes"],
            "library_ms": None, "shape": {"chains": t["chains"], "vshape": t["vshape"]},
        })
    # the subtree kernel: launched once per step of the main path's subtree variant
    t = third["subtree_timing"]
    kernels.append({
        "name": "subtree_sample", "route": "cuda",
        "source": "multigridmc_tpu_torch/csrc/mgmc_subtree.cu",
        "replaces": "multigridmc_tpu/ops/kernels/mgmc_subtree_pallas.py:326",
        "launches": counts["subtree_kernel"]["subtree_sample"],
        "max_abs_err": third["subtree_err"],
        "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
        "events_over_device": t["events_over_device"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_bytes": t["bound_bytes"],
        "library_ms": None, "shape": {"chains": t["chains"], "vshape": t["vshape"]},
        "design": "launch tables in shared memory; the passes of level_passes.cuh shared "
                  "with the phase visit kernels: each low-rank term in one pass, every "
                  "reach-1 stencil in registers, each colour's rows over all warps",
        "barriers_per_launch": t["per_operation"]["barriers_per_block"][0],
        "blocks_per_sm": t["per_operation"]["blocks_per_sm"],
        "per_operation_us": {key: v["total_us"]
                             for key, v in t["per_operation"]["operations"].items()},
    })
    # the reach-2 levels (rows 1b / 2b): on the biharmonic posterior's levels 0
    # (255^2 13-point) and 1 (127^2 25-point Galerkin) at C chains, launched
    # by its full-width main path on the route the rule takes there (the smem
    # kernels, mgmc_visit_smem.cu, where SMEM_CHAINS lists the level), the
    # other route's device ms beside; the phase kernels' reach-2 build also on
    # the 64x64 gate's levels (63^2, 31^2), which it takes.  And the sweep
    # kernels on its 9-colour 63^2 level at the distillation set-up's shape:
    # the deterministic sweep's generic body is launched by that set-up (on
    # 63^2 and 31^2), the Gibbs sweep and the split route run on no path here
    gate_launches = biharmonic["statistics"]["phase_kernels"]["launches"]
    for li, size in ((0, "13pt"), (1, "25pt")):
        phase_t, smem_t = biharmonic["timings"][li], biharmonic["smem_timings"][li]
        phase_chk, smem_chk = biharmonic["checks"][li], biharmonic["smem_checks"][li]
        routed = biharmonic["main_path"]["route_by_level"][li]
        route_row = next(r for r in biharmonic["smem_routes"]
                         if r["level"] == f"L{li}" and r["chains"] == smem_t["chains"])
        for kind, line in (("descend", 700), ("ascend", 847)):
            for route, t, chk in (("smem", smem_t, smem_chk), ("phase", phase_t, phase_chk)):
                name = f"{kind}_visit_reach2_{size}" + ("_smem" if route == "smem" else "")
                on_path = route == routed
                other = "phase" if route == "smem" else "smem"
                entry = {
                    "name": name, "route": "cuda",
                    "source": "multigridmc_tpu_torch/csrc/" + (
                        "mgmc_visit_smem.cu" if route == "smem" else "mgmc_visit.cu"),
                    "build": "" if route == "smem" else " ".join(mv.PHASE_REACH2_FLAGS),
                    "replaces": f"multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py:{line}",
                    "launches": (biharmonic["main_path"]["launches"].get(name, 0) if on_path
                                 else gate_launches.get(name, 0)),
                    "path": ("biharmonic main_path" if on_path else
                             "biharmonic statistics (64x64 gate)" if gate_launches.get(name)
                             else None),
                    "max_abs_err": chk["x"] if kind == "descend" else chk["ascend_x"],
                    "f_c_max_abs_err_over_scale": chk["f_c_over_scale"] if kind == "descend"
                    else None,
                    "ms": t[f"{kind}_ms"], "device_ms": t[f"{kind}_device_ms"],
                    "events_over_device": t[f"{kind}_events_over_device"],
                    "plain_ms": t[f"{kind}_plain_ms"],
                    "bound_ms": t[f"{kind}_bound_ms"], "bound_by": t[f"{kind}_bound_by"],
                    "bound_bytes": t[f"{kind}_bytes"], "library_ms": None,
                    f"{other}_device_ms": route_row[f"{other}_{kind}_ms"],
                    "shape": {"chains": t["chains"], "vshape": t["vshape"],
                              "offsets": chk["offsets"], "colours": chk["colours"]},
                    "stencil_form": t["stencil_form"], "threads": t["threads"],
                    "per_pass_us": next(r[kind]["passes"] for r in biharmonic["pass_stamps"]
                                        if r["route"] == route and r["level"] == li)}
                if route == "smem":
                    entry.update({
                        "cluster": t["cluster"], "c_shared": t["c_shared"],
                        "against_phase_one_philox_stream": chk["smem_against_phase"],
                        "two_sweeps_max_abs_err": biharmonic["smem_ssor_checks"][li],
                        "design": "each chain's field in shared memory, in bands over a cluster "
                                  "where one block cannot hold it (rows beyond a cut read from "
                                  "the neighbour's shared memory), copied in once by cp.async; "
                                  "each colour's points over all threads from host tables, "
                                  "interior points with their coefficients as scalars; B^T x "
                                  "per band, summed in rank order"})
                else:
                    entry["design"] = (
                        "the passes of level_passes.cuh at reach 2: a parameter block of 25 "
                        "offsets and 9 colours in a build of its own, the stencil in registers "
                        "with edge terms dropped two rows and columns deep, one point per "
                        "lane, 512 threads a block at most")
                kernels.append(entry)
    # the subtree kernel's reach-2 build (mgmc_subtree.cu -DVISIT_REACH=2) on
    # the biharmonic posterior's sub-levels (127^2, 63^2, 31^2 25-point, 9
    # colours; coarse 15^2) at C chains, launched once per step of the
    # biharmonic sampler with subtree=True
    t = biharmonic["subtree_timing"]
    kernels.append({
        "name": "subtree_sample_reach2", "route": "cuda",
        "source": "multigridmc_tpu_torch/csrc/mgmc_subtree.cu",
        "build": " ".join(common.SUBTREE_REACH2_FLAGS),
        "replaces": "multigridmc_tpu/ops/kernels/mgmc_subtree_pallas.py:326",
        "launches": biharmonic["subtree_main_path"]["subtree_launches"].get(
            "subtree_sample_reach2", 0),
        "path": "biharmonic subtree_main_path",
        "max_abs_err": biharmonic["subtree_max_abs_err"],
        "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
        "events_over_device": t["events_over_device"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_bytes": t["bound_bytes"],
        "library_ms": None, "shape": {"chains": t["chains"], "vshape": t["vshape"],
                                      "threads": t["threads"]},
        "design": "the reach-1 kernel's schedule and tables with a parameter block of 25 "
                  "offsets and 9 colours, the reach-2 passes of level_passes.cuh (the level's "
                  "form found by the host), the sweeps from the colours' point lists (every "
                  "thread on a colour's points, interior points with their coefficients as "
                  "scalars), two blocks of 256 threads an SM",
        "barriers_per_launch": t["per_operation"]["barriers_per_block"][0],
        "blocks_per_sm": t["per_operation"]["blocks_per_sm"],
        "per_operation_us": {key: v["total_us"]
                             for key, v in t["per_operation"]["operations"].items()},
        "per_visit_us": {key: v["visit_us"] for key, v in t["per_pass"].items()},
    })
    # the 3d forms on the 64^3 posterior's levels 0 (63^3, 7-point) and 1 (31^3,
    # 27-point Galerkin) at 32 chains, launched by its main path (distilled at
    # level 2): the route the main path takes (the smem kernels of
    # mgmc_visit_smem3d.cu where SMEM3D_ROUTES lists the level), the phase
    # kernels' 3d build (mgmc_visit.cu -DVISIT_DIM=3) beside
    for li, size in ((0, "7pt"), (1, "27pt")):
        vshape = [VOLUME_NX // 2 ** li - 1] * 3
        route = vol_main["route_by_level"].get(li, vol_main["route_by_level"].get(str(li)))
        t, one, ph, ph_one = (next(r for r in volume["timings"] if r["chains"] == C
                                   and r["vshape"] == vshape and r["route"] == rt)
                              for rt in (route, "phase") for C in VOLUME_CHAINS)
        chk = [c for c in volume["checks"] if c["level"] == f"L{li}" and c["route"] == route]
        comp = [c for c in volume["against_composed"] if c["level"] == li
                and c["route"] == route]
        stamps = next(r for r in volume["smem_pass_stamps"] if r["level"] == li)
        for kind, line in (("descend", 700), ("ascend", 847)):
            name = f"{kind}_visit_3d_{size}" + ("_smem" if route == "smem" else "")
            kernels.append({
                "name": name, "route": "cuda",
                "source": "multigridmc_tpu_torch/csrc/" + (
                    "mgmc_visit_smem3d.cu" if route == "smem" else "mgmc_visit.cu"),
                "build": "" if route == "smem" else " ".join(mv.PHASE_DIM3_FLAGS),
                "replaces": f"multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py:{line}",
                "launches": vol_main["launches"].get(name, 0),
                "path": f"volume main_path distilled_{VOLUME_CHAINS[0]}",
                "max_abs_err": max(c["x"] if kind == "descend" else c["ascend_x"] for c in chk),
                "f_c_max_abs_err_over_scale": max(c["f_c_over_scale"] for c in chk)
                if kind == "descend" else None,
                "against_phase_one_philox_stream": [c.get("smem_against_phase") for c in chk]
                if route == "smem" else None,
                "against_composed_max_abs_err": max(c[f"{kind}_x"] for c in comp),
                "near_exact_f_c": next(r for r in volume["near_exact_f_c"]
                                       if r["level"] == f"L{li}") if kind == "descend" else None,
                "ms": t[f"{kind}_ms"], "device_ms": t[f"{kind}_device_ms"],
                "events_over_device": t[f"{kind}_events_over_device"],
                "plain_ms": t[f"{kind}_plain_ms"],
                "bound_ms": t[f"{kind}_bound_ms"], "bound_by": t[f"{kind}_bound_by"],
                "bound_bytes": t[f"{kind}_bytes"], "library_ms": None,
                "shape": {"chains": t["chains"], "vshape": t["vshape"],
                          "offsets": chk[0]["offsets"], "colours": chk[0]["colours"]},
                "one_chain": {"route": one["route"], "ms": one[f"{kind}_ms"],
                              "device_ms": one[f"{kind}_device_ms"],
                              "plain_ms": one[f"{kind}_plain_ms"],
                              "bound_ms": one[f"{kind}_bound_ms"]},
                "phase_build": {"ms": ph[f"{kind}_ms"], "device_ms": ph[f"{kind}_device_ms"],
                                "one_chain_device_ms": ph_one[f"{kind}_device_ms"],
                                "threads": ph["threads"],
                                "launches": vol_main["launches"].get(
                                    f"{kind}_visit_3d_{size}", 0)},
                "stencil_form": t["stencil_form"], "threads": t["threads"],
                **({"cluster": t["cluster"], "c_shared": t["c_shared"],
                    "per_pass_us": stamps[kind]["passes"],
                    "registers": stamps[kind]["registers"],
                    "local_bytes": stamps[kind]["local_bytes"]} if route == "smem" else {}),
                "design": ("each chain's field in shared memory, slabs of z-planes over a "
                           "cluster, the neighbours' edge planes copied into ghost planes "
                           "after each cluster barrier, host tables (interior points with scalar "
                           "coefficients, several in flight), B^T x shares in rank order"
                           if route == "smem" else
                           "the passes of level_passes.cuh in 3d: the (C, Z, Y, X) fields row "
                           "major, a row (z, y), the colour rows as (z, y) residue pairs, the "
                           "stencil in registers with z edge bits, 3d measurement boxes, the "
                           "3d transfers as passes; one block per chain, 512 threads at most")})
    # the two-sweep (SSOR) forms, phase ssor: the smem kernels on the
    # flagship's 255^2 level at 256 chains (127^2 and one chain beside),
    # launched by its SSOR flagship paths, the phase kernels' device ms beside;
    # the phase kernels on the flagship's 255^2 level at 256 chains, launched
    # by the 64x64 gate's SSOR levels (statistics kernels_ssor) and by any SSOR
    # flagship level the smem kernels do not take; the split kernels at one
    # chain (clusters of 16), launched by the one-chain SSOR flagship path and
    # drivers.mg's SSOR solve where the rule gives them the level; the reach-2
    # and 3d builds on their posteriors' level 0, launched by their SSOR
    # samplers' steps
    smem_t, smem_one, smem_l1, phase_l1 = (ssor["timings"][k] for k in (
        "smem", "smem_one_chain", "smem_L1", "phase_L1"))
    smem_chks = [c for c in ssor["checks"] if c["route"] == "smem"]
    for kind, line in (("descend", 700), ("ascend", 847)):
        name = mv.KERNEL_NAMES[(mv.SMEM_ROUTE, kind)] + mv.SSOR_SUFFIX
        launches = sum(ssor["main_path"][v]["launches"].get(name, 0)
                       for v in ssor["main_path"] if v.startswith("flagship"))
        stamps = {r["level"]: r[kind] for r in ssor["smem_stamps"]}
        err = max(max(c["x"], c["f_c_over_scale"]) if kind == "descend" else c["ascend_x"]
                  for c in smem_chks)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "multigridmc_tpu_torch/csrc/mgmc_visit_smem.cu",
            "replaces": f"multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py:{line}",
            "launches": launches + driver_counts.get(name, 0),
            "path": "ssor main_path flagship_256" + (
                " and flagship_1" if "smem" in ssor["main_path"]["flagship_1"][
                    "route_by_level"].values() else ""),
            "max_abs_err": err,
            "against_phase_one_philox_stream": [c["smem_against_phase"] for c in smem_chks],
            "ms": smem_t[f"{kind}_ms"], "device_ms": smem_t[f"{kind}_device_ms"],
            "events_over_device": smem_t[f"{kind}_events_over_device"],
            "plain_ms": smem_t[f"{kind}_plain_ms"],
            "bound_ms": smem_t[f"{kind}_bound_ms"], "bound_by": smem_t[f"{kind}_bound_by"],
            "bound_bytes": smem_t[f"{kind}_bytes"], "library_ms": None,
            "phase_device_ms": ssor["timings"]["phase"][f"{kind}_visit_device_ms"],
            "shape": {"chains": smem_t["chains"], "vshape": smem_t["vshape"],
                      "cluster": smem_t["cluster"], "c_shared": smem_t["c_shared"],
                      "threads": smem_t["threads"]},
            "stencil_form": smem_t["stencil_form"],
            "per_pass_us": stamps[0]["passes"], "registers": stamps[0]["registers"],
            "local_bytes": stamps[0]["local_bytes"],
            "barriers_per_launch": stamps[0]["barriers_per_block"][0],
            "at_level_1": {"vshape": smem_l1["vshape"], "chains": smem_l1["chains"],
                           "cluster": smem_l1["cluster"], "threads": smem_l1["threads"],
                           "device_ms": smem_l1[f"{kind}_device_ms"],
                           "phase_device_ms": phase_l1[f"{kind}_device_ms"],
                           "plain_ms": smem_l1[f"{kind}_plain_ms"],
                           "bound_ms": smem_l1[f"{kind}_bound_ms"],
                           "bound_by": smem_l1[f"{kind}_bound_by"],
                           "per_pass_us": stamps[1]["passes"]},
            "one_chain": {"cluster": smem_one["cluster"], "ms": smem_one[f"{kind}_ms"],
                          "device_ms": smem_one[f"{kind}_device_ms"],
                          "split_device_ms": ssor["timings"]["split"][
                              f"{kind}_visit_split_device_ms"],
                          "bound_ms": smem_one[f"{kind}_bound_ms"]},
            "design": "each chain's field in shared memory through both sweeps, in bands over "
                      "a cluster (rows beyond a cut read from the neighbour's shared memory), "
                      "copied in once by cp.async and written back once; each colour's points "
                      "over all threads from host tables, interior points with their "
                      "coefficients as scalars; B^T x per band, summed in rank order, both "
                      "Woodbury patches, the residual and the restriction on the bands"})
    for route, source in (("phase", "mgmc_visit.cu"), ("split", "mgmc_visit_split.cu")):
        t = ssor["timings"][route]
        chks = [c for c in ssor["checks"] if c["route"] == route]
        variant = f"flagship_{SSOR_CHAINS[0] if route == 'phase' else 1}"
        for base, kind, line in zip(VISIT_KERNELS[route], ("descend", "ascend"), (700, 847)):
            name = base + mv.SSOR_SUFFIX
            # the SSOR flagship path (and drivers.mg's one right-hand side) where
            # the rule gives these kernels a level there, the 64x64 gate's SSOR
            # levels (63^2, 31^2: not in SMEM_CHAINS) at its chain counts
            on_path = ssor["main_path"][variant]["launches"].get(name, 0) + (
                driver_counts.get(name, 0) if route == "split" else 0)
            gate_name = "kernels_ssor" if route == "phase" else "kernels_ssor_split_one_chain"
            gate = statistics[gate_name]["launches"].get(name, 0)
            launches = on_path + gate
            path = " and ".join(part for part, n in (
                (f"ssor main_path {variant}" + (" and drivers.mg (SSOR)" if route == "split"
                                                else ""), on_path),
                (f"statistics {gate_name} (64x64)", gate)) if n) or None
            err = max(max(c["x"], c["f_c_over_scale"]) if kind == "descend" else c["ascend_x"]
                      for c in chks)
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"multigridmc_tpu_torch/csrc/{source}",
                "replaces": f"multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py:{line}",
                "launches": launches, "path": path, "max_abs_err": err,
                "ms": t[f"{base}_ms"], "device_ms": t[f"{base}_device_ms"],
                "events_over_device": t[f"{base}_events_over_device"],
                "plain_ms": t[f"{kind}_plain_ms"],
                "bound_ms": t[f"{kind}_bound_ms"], "bound_by": t[f"{kind}_bound_by"],
                "bound_bytes": t[f"{kind}_bytes"], "library_ms": None,
                "shape": {"chains": t["chains"], "vshape": t["vshape"],
                          "cluster": t["split_cluster"] if route == "split" else 1},
                "design": "two directed sweeps in one launch, each with its own colour rows, "
                          "Y boxes and W and its own Philox counter, the residual after the "
                          "last" + (" (the launch's tables of both directions)" if route == "phase"
                                    else " (each band kept in shared memory across both)")})
            if route == "phase":
                kernels[-1].update({
                    "threads": t["threads"],
                    "barriers_per_launch": ssor["stamps"][kind]["barriers_per_block"][0],
                    "per_pass_us": ssor["stamps"][kind]["passes"]})
    for t, chk in zip(ssor["other_timings"], ssor["other_checks"]):
        reach2 = t["name"] == "biharmonic"
        smem = t["route"] == "smem"
        for kind, line in (("descend", 700), ("ascend", 847)):
            name = (f"{kind}_visit_reach2_13pt" if reach2 else f"{kind}_visit_3d_7pt") + (
                "_smem" if smem else "") + mv.SSOR_SUFFIX
            kernels.append({
                "name": name, "route": "cuda",
                "source": "multigridmc_tpu_torch/csrc/" + (
                    ("mgmc_visit_smem.cu" if reach2 else "mgmc_visit_smem3d.cu") if smem
                    else "mgmc_visit.cu"),
                "build": "" if smem else " ".join(
                    mv.PHASE_REACH2_FLAGS if reach2 else mv.PHASE_DIM3_FLAGS),
                **({"phase_ms": t["phase_" + kind + "_ms"],
                    "phase_device_ms": t["phase_" + kind + "_device_ms"]} if smem else {}),
                "replaces": f"multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py:{line}",
                "launches": ssor["main_path"][t["name"]]["launches"].get(name, 0),
                "path": f"ssor main_path {t['name']}",
                "max_abs_err": max(chk["x"], chk["f_c_over_scale"]) if kind == "descend"
                else chk["ascend_x"],
                "ms": t[f"{kind}_ms"], "device_ms": t[f"{kind}_device_ms"],
                "events_over_device": t[f"{kind}_events_over_device"],
                "plain_ms": t[f"{kind}_plain_ms"],
                "bound_ms": t[f"{kind}_bound_ms"], "bound_by": t[f"{kind}_bound_by"],
                "bound_bytes": t[f"{kind}_bytes"], "library_ms": None,
                "shape": {"chains": t["chains"], "vshape": t["vshape"],
                          "offsets": chk["offsets"], "colours": chk["colours"]},
                "stencil_form": t["stencil_form"], "threads": t["threads"]})
    # the shared-memory body on the distillation set-ups' shapes (the
    # biharmonic hierarchy's 9-colour 63^2 and 31^2 at 28,529 chains, the 3d
    # one's 27-point 15^3 at 17,593), launched by those set-ups (the
    # deterministic sweep; the Gibbs sweep on no path); on 63^2 the generic
    # body (the A/B reference, no path now) and the split route at one chain
    # beside
    nine = biharmonic["nine_colour_sweeps"]
    bih_setup = biharmonic["setup_sweeps"]
    vol_setup = volume["setup_sweeps"]
    shapes = (("_9_colours", nine["timings"][0], bih_setup, "biharmonic main_path set-up"),
              ("_9_colours_31", nine["timings_31"][0], bih_setup, "biharmonic main_path set-up"),
              ("_27pt_15_cube", volume["setup_sweep_timings"][0], vol_setup,
               "volume main_path set-up"))
    for name, key, kernel_line in (("sweep_batched", "sweep", 194),
                                   ("gibbs_sweep_batched", "gibbs", 246)):
        for suffix, t, setup, setup_path in shapes:
            on_path = key == "sweep"
            launches = sum(r["launches"] for r in setup if r["vshape"] == t["vshape"]
                           and r["chains"] == t["chains"]) if on_path else 0
            err = max([r["max_abs_err"] for r in setup if r["vshape"] == t["vshape"]]
                      + ([nine["max_abs_err"][f"{name}_smem"]] if suffix == "_9_colours" else []))
            kernels.append({
                "name": f"{name}_smem{suffix}", "route": "cuda",
                "source": "multigridmc_tpu_torch/csrc/sor_sweep_smem.cu",
                "replaces": f"multigridmc_tpu/ops/kernels/sor_pallas_v2.py:{kernel_line}",
                "launches": launches, "path": setup_path if on_path else None,
                "max_abs_err": err,
                "against_generic_max_abs_err": max(
                    [r.get("against_generic", 0.0) for r in setup if r["vshape"] == t["vshape"]]
                    + ([nine["smem_against_generic"]] if suffix == "_9_colours" else [])),
                "ms": t[f"{key}_ms"], "device_ms": t[f"{key}_device_ms"],
                "events_over_device": t[f"{key}_events_over_device"],
                "generic_ms": t[f"generic_{key}_ms"],
                "generic_device_ms": t[f"generic_{key}_device_ms"],
                "plain_ms": t[f"{key}_plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "bound_bytes": t["bound_bytes"], "library_ms": None,
                "shape": {"chains": t["chains"], "b_batched": t["b_batched"],
                          "vshape": t["vshape"], "offsets": t["offsets"],
                          "colours": t["colours"]},
                "per_pass_us": t["stamps"][key]["passes"],
                "stamps": {k: v for k, v in t["stamps"][key].items() if k != "passes"},
                "design": "one block per chain with x (zero halo) and the rhs in shared memory, "
                          "copied in once by cp.async and written back once; each colour's "
                          "points over all threads from a host-made table, interior points "
                          "with the coefficients as scalars, the diagonal's reciprocal"})
        # the generic body and the split route on the 9-colour 63^2 level
        for t in nine["timings"]:
            split = t["routes"][key][0] == "split"
            prefix = "" if split else "generic_"
            entry = f"{name}_{'split' if split else 'generic'}"
            kernels.append({
                "name": f"{entry}_9_colours", "route": "cuda",
                "source": "multigridmc_tpu_torch/csrc/" + (
                    "sor_sweep_cluster.cu" if split else "sor_sweep.cu"),
                "replaces": f"multigridmc_tpu/ops/kernels/sor_pallas_v2.py:{kernel_line}",
                "launches": 0, "path": None,
                "max_abs_err": nine["max_abs_err"][entry],
                "ms": t[f"{prefix}{key}_ms"], "device_ms": t[f"{prefix}{key}_device_ms"],
                "events_over_device": t[f"{prefix}{key}_events_over_device"],
                "plain_ms": t[f"{key}_plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "bound_bytes": t["bound_bytes"], "library_ms": None,
                "shape": {"chains": t["chains"], "b_batched": t["b_batched"],
                          "vshape": t["vshape"], "offsets": t["offsets"],
                          "colours": t["colours"], "cluster": t["routes"][key][1]}})
    # the many-measurement forms (more than mv.LANE_SLOTS measurements: the
    # low-rank scratch in dynamic shared memory): device ms at 64 measurements,
    # at 256 beside it (3d: 64 alone), and the launches of the lowrank path
    # (64 measurements; each variant's counts set to 0 before it and read
    # after, summed)
    path_launches = lowrank["path"]["launches"]
    forms = {}
    for t in lowrank["times"]:
        for kind in (("subtree",) if t["route"] == "subtree" else ("descend", "ascend")):
            forms.setdefault(t[f"{kind}_name"], {})[t["m"]] = (t, kind)
    for base, by_m in forms.items():
        t, kind = by_m[min(by_m)]
        errs = [v for key, v in lowrank["max_abs_err"].items()
                if key.split("@")[0] == ("subtree" if kind == "subtree" else base)]
        if not errs:
            raise AssertionError(f"lowrank: the form {base} was timed but not checked")
        launches = path_launches.get(base, 0)
        source = {"phase": "mgmc_visit.cu", "split": "mgmc_visit_split.cu",
                  "smem": "mgmc_visit_smem3d.cu" if "_3d_" in base else "mgmc_visit_smem.cu",
                  "subtree": "mgmc_subtree.cu"}[t["route"]]
        kernels.append({
            "name": f"{base}_many_measurements", "route": "cuda",
            "source": f"multigridmc_tpu_torch/csrc/{source}",
            "replaces": ("multigridmc_tpu/ops/kernels/mgmc_subtree_pallas.py:326"
                         if kind == "subtree" else
                         f"multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py:"
                         f"{700 if kind == 'descend' else 847}"),
            "launches": launches, "path": "lowrank path" if launches else None,
            "max_abs_err": max(errs), "measurements": t["m"],
            "ms": t[f"{kind}_ms"], "device_ms": t[f"{kind}_device_ms"],
            "plain_ms": t[f"{kind}_plain_ms"], "bound_ms": t[f"{kind}_bound_ms"],
            "bound_by": t[f"{kind}_bound_by"], "bound_bytes": t[f"{kind}_bound_bytes"],
            "library_ms": None,
            "shape": {"chains": t["chains"], "vshape": t["vshape"], "level": t["label"]},
            "at_256_measurements": None if 256 not in by_m else {
                key: by_m[256][0][f"{kind}_{key}"] for key in
                ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
            "design": "the low-rank vectors in dynamic shared memory sized by m, each lane "
                      "holding entries lane, lane + 32, ..., u = W v one row at a time with "
                      "the lanes along it (csrc/visit_phases.cuh)"})
    for k in kernels:
        if k.get("path", "") is not None and k["launches"] < 1:
            raise AssertionError(f"kernel {k['name']} was launched no time on its path")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
