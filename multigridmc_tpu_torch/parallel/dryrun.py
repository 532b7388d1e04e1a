"""Multi-rank dry run of the parallel samplers, and the launcher of rank worlds.

Counterpart of ``__graft_entry__.dryrun_multichip`` and
``native/dryrun_multihost.py``::

    python -m multigridmc_tpu_torch.parallel.dryrun --world N [--device cpu] [--out FILE]

starts ``N`` ranks - one per card over NCCL (the default), or ``N`` CPU
processes over gloo with ``--device cpu`` - and runs in them:

1. the lattice-decomposed cycle (:class:`~.cycle.ShardedMGMCSampler`) in
   ``"global"`` noise mode on a ``chains x ly x lx`` mesh, held against the
   same sampler on a world of one that rank 0 runs beside (float64 on the CPU
   within ``1e-10``, float32 on the card within ``1e-4``, of the output's
   scale);
2. the ``"sharded"`` mode: finite output, and every lattice shard holding the
   same replicated coarse field, bit for bit;
3. the chains path (:class:`~.data_parallel.DataParallelMGMCSampler`): a step
   repeated from the same seed is the same, the ranks' chains differ, and each
   rank's chains are bitwise the single-device sampler's under that rank's
   noise.

It prints one line per rank and ``dryrun: OK`` last (exit code 0), or the
failing ranks' output and ``dryrun: FAILED``.  Asked for more cards than the
machine has, it raises.

:func:`launch` starts any of the worker tasks of :data:`TASKS` in a world of
``N`` ranks (``python -m multigridmc_tpu_torch.parallel.dryrun --worker TASK
...`` per rank, the rendezvous on a free localhost port, one thread a CPU
rank), waits for them, stops them all where one fails, and merges what the
ranks wrote into one ``.npz`` (keys ``"<rank>/<name>"``).  The tests run their
gloo worlds and ``chip_smoke.py --phases multichip`` its NCCL world through it,
so no rank process imports anything but this package.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]
#: seconds a world may take before its ranks are stopped
DEFAULT_TIMEOUT = 900


# ================================================================== launcher
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def save_spec(path, options: dict, **arrays) -> None:
    """The input of a world: ``options`` (JSON) and named arrays."""
    np.savez(path, options=np.array(json.dumps(options)), **arrays)


def load_spec(path) -> tuple:
    if path is None:
        return {}, {}
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "options"}
        options = json.loads(str(data["options"])) if "options" in data.files else {}
    return options, arrays


def launch(task: str, world: int, device: str = "cuda", spec=None, out=None,
           timeout: float = DEFAULT_TIMEOUT) -> Dict[str, np.ndarray]:
    """Run ``task`` in a world of ``world`` ranks and return what the ranks
    wrote, keyed ``"<rank>/<name>"`` (also saved to ``out`` where given).
    ``device="cuda"`` takes one card a rank over NCCL and raises where the
    machine has fewer cards; ``"cpu"`` runs gloo processes.  Any failing or
    hanging rank stops the whole world and raises ``RuntimeError`` with the
    ranks' last output."""
    if task not in TASKS:
        raise ValueError(f"unknown task '{task}' (one of {sorted(TASKS)})")
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(f"a world of {world} ranks over NCCL needs {world} CUDA "
                               f"devices; this machine has {have}")
    elif device != "cpu":
        raise ValueError(f"device is 'cuda' or 'cpu', not '{device}'")
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PACKAGE_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        env[var] = "1"
    with tempfile.TemporaryDirectory(prefix="mgmc_world_") as tmp:
        procs, logs = [], []
        try:
            for r in range(world):
                log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
                logs.append(log)
                cmd = [sys.executable, "-m", "multigridmc_tpu_torch.parallel.dryrun",
                       "--worker", task, "--rank", str(r), "--world", str(world),
                       "--port", str(port), "--device", device,
                       "--out", os.path.join(tmp, f"rank{r}.npz")]
                if spec is not None:
                    cmd += ["--spec", str(spec)]
                procs.append(subprocess.Popen(cmd, cwd=str(PACKAGE_ROOT), env=env,
                                              stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            failed = False
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(
                        p.poll() not in (None, 0) for p in procs):
                    failed = True
                    break
                time.sleep(0.05)
            failed = failed or any(p.returncode != 0 for p in procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        if failed:
            tails = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n"
                              + "\n".join(t.splitlines()[-40:])
                              for r, (p, t) in enumerate(zip(procs, texts)))
            raise RuntimeError(f"world of {world} ranks running '{task}' failed:\n{tails}")
        merged = {}
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.npz")
            if os.path.exists(path):
                with np.load(path) as data:
                    for k in data.files:
                        merged[f"{r}/{k}"] = data[k]
            merged[f"{r}/log"] = np.array(texts[r])
    if out is not None:
        np.savez(out, **merged)
    return merged


# ===================================================================== tasks
def _problem(name: str, device, dtype):
    """The dry run's posteriors, built by the port's models: ``"dryrun"`` the
    32x32 FD posterior of ``__graft_entry__._build`` (8 measurements of
    variance 1e-4 (1 + u)); ``"flagship"`` the 256x256 one of
    ``bench.py::build_problem`` (8 near-exact measurements)."""
    from ..lattice import Lattice
    from ..models.correlation import ConstantCorrelationLengthModel
    from ..models.posterior import MeasurementParameters, measured_operator
    from ..models.prior import shiftedlaplace_fd

    if name == "dryrun":
        nx, seed = 32, 5418513
        rng = np.random.default_rng(seed)
        params = MeasurementParameters(measurement_locations=rng.uniform(size=(8, 2)),
                                       mean=rng.normal(size=8),
                                       variance=1e-4 * (1.0 + rng.uniform(size=8)))
    elif name == "flagship":
        nx, seed = 256, 20260816
        rng = np.random.default_rng(seed)
        params = MeasurementParameters(measurement_locations=rng.uniform(0.1, 0.9, size=(8, 2)),
                                       mean=rng.normal(2.0, 1.0, size=8),
                                       variance=1e-6 * (1.0 + rng.uniform(size=8)))
    else:
        raise ValueError(f"unknown problem '{name}'")
    prior = shiftedlaplace_fd(Lattice((nx, nx)), ConstantCorrelationLengthModel(0.2),
                              device=device, dtype=dtype)
    return measured_operator(prior, params)


def _op_from_spec(arrays, prefix: str, device, dtype=torch.float64):
    """An operator a test wrote with :func:`operator_arrays`."""
    from ..convert import operator_from_numpy

    offsets = [tuple(int(o) for o in off) for off in arrays[prefix + "offsets"]]
    lowrank = prefix + "B" in arrays
    return operator_from_numpy(
        arrays[prefix + "coeffs"], offsets, arrays[prefix + "lattice"],
        B=arrays[prefix + "B"] if lowrank else None,
        Sigma_diag=arrays[prefix + "Sigma"] if lowrank else None, device=device, dtype=dtype)


def operator_arrays(prefix: str, coeffs, offsets, lattice_shape, B=None, Sigma=None) -> dict:
    """The arrays of one operator for a world's spec (see :func:`_op_from_spec`)."""
    out = {prefix + "coeffs": np.asarray(coeffs), prefix + "offsets": np.asarray(offsets),
           prefix + "lattice": np.asarray(lattice_shape)}
    if B is not None:
        out[prefix + "B"] = np.asarray(B)
        out[prefix + "Sigma"] = np.asarray(Sigma)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _lattice_agree(mesh, fields) -> float:
    """The largest difference between this rank's replicated fields and those
    of the other ranks of its lattice group (0.0 where they agree bitwise)."""
    import torch.distributed as dist

    worst = 0.0
    if mesh.lattice_group is None:
        return worst
    for t in fields:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in mesh.lattice_ranks]
        dist.all_gather(parts, t, group=mesh.lattice_group)
        worst = max(worst, max(float((p - t).abs().max()) for p in parts))
    return worst


def _moments(gather, step, x, nwarmup, nsteps, vshape):
    """Mean and covariance over ``nsteps`` steps after ``nwarmup`` of the
    chains' valid vertices (every rank takes part in the gathers; the result is
    the same on every rank)."""
    for _ in range(nwarmup):
        x = step(x)
    n = int(np.prod(vshape))
    sx = np.zeros(n)
    sxx = np.zeros((n, n))
    total = 0
    for _ in range(nsteps):
        x = step(x)
        xf = _np(gather(x))[(Ellipsis,) + tuple(slice(0, m) for m in vshape)]
        xf = xf.reshape(-1, n).astype(np.float64)
        sx += xf.sum(axis=0)
        sxx += xf.T @ xf
        total += xf.shape[0]
    mean = sx / total
    return mean, sxx / total - np.outer(mean, mean)


def _resumed(make, noise_of, f, x, steps: int, rank: int, device) -> Dict[str, np.ndarray]:
    """A checkpoint's resume, against the uninterrupted run: ``2 steps``
    steps of a sampler ``make()`` from ``x`` under ``noise_of()``; ``steps``
    steps of a fresh one, a save of this rank's
    :class:`~multigridmc_tpu_torch.utils.checkpoint.ChainState` (its block and
    the shared source, which carries the rank's streams) and a load, then
    ``steps`` more of a third sampler under the loaded source and, as the
    fault the streams repair, of a fourth under the loaded source with its
    streams dropped (this rank's arrays ``whole``, ``resumed``,
    ``unrepaired``, and the names of the saved streams)."""
    from ..utils.checkpoint import ChainState

    def run(sampler, noise, x):
        for _ in range(steps):
            x = sampler.apply(noise, f, x)
        return x

    noise = noise_of()
    sampler = make()
    whole = run(sampler, noise, run(sampler, noise, x.clone()))
    noise = noise_of()
    half = run(make(), noise, x.clone())
    with tempfile.TemporaryDirectory(prefix="mgmc_resume_") as tmp:
        path = os.path.join(tmp, f"rank{rank}.npz")
        ChainState(half, noise, steps).save(path)
        state, fresh = ChainState.load(path, device), ChainState.load(path, device)
    streams = sorted(state.noise.streams)
    fresh.noise.streams.clear()
    return {"whole": _np(whole), "resumed": _np(run(make(), state.noise, state.x)),
            "unrepaired": _np(run(make(), fresh.noise, fresh.x)),
            "streams": np.array(streams)}


def task_dryrun(rank: int, world: int, device: torch.device, options, arrays) -> dict:
    """The dry run (module docstring): both lattice noise modes and the chains
    path, checked on every rank (raises where a check fails)."""
    from ..samplers.base import GeneratorNoise
    from ..samplers.mgmc import MultigridMCSampler
    from .cycle import ShardedMGMCSampler, pad_field
    from .data_parallel import DataParallelMGMCSampler
    from .mesh import chains_mesh, factor_devices, fold_seed, multihost_lattice_mesh, single_mesh

    dtype = torch.float64 if device.type == "cpu" else torch.float32
    tol = 1e-10 if dtype == torch.float64 else FLOAT32_MESH_TOL
    op = _problem("dryrun", device, dtype)
    chains = 2 if world >= 8 and world % 2 == 0 else 1
    mesh = multihost_lattice_mesh(2, chains=chains,
                                  mesh_shape=factor_devices(world // chains, 2), device=device)
    kw = dict(nlevel=3, smoother="SOR", cycle=2, agglomerate_below=4)
    nchains = 2 * chains
    rng = np.random.default_rng(1)
    f = pad_field(torch.as_tensor(rng.normal(size=op.vshape), dtype=dtype, device=device),
                  op.vshape)
    x = torch.zeros((nchains,) + tuple(m + 1 for m in op.vshape), dtype=dtype, device=device)
    res = {}

    # 1. "global" noise against the world of one
    sh = ShardedMGMCSampler(op, mesh=mesh, noise_mode="global", **kw)
    out = sh.gather(sh.apply(GeneratorNoise(0, device), sh.scatter(f), sh.scatter(x)))
    one = ShardedMGMCSampler(op, mesh=single_mesh(2, device), noise_mode="global", **kw)
    ref = one.apply(GeneratorNoise(0, device), f, x.clone())
    scale = max(float(ref.abs().max()), 1.0)
    err = float((out - ref).abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"rank {rank}: global-noise cycle on {mesh.shape} is {err:.3e} "
                             f"from the world of one (limit {tol * scale:.3e})")
    res["global_err"] = err

    # 2. "sharded" noise: finite, replicated coarse fields equal on the lattice group
    prod = ShardedMGMCSampler(op, mesh=mesh, noise_mode="sharded", **kw)
    record = []
    outp = prod.apply(GeneratorNoise(0, device), prod.scatter(f), prod.scatter(x), record=record)
    if not bool(torch.isfinite(outp).all()):
        raise AssertionError(f"rank {rank}: sharded-noise output not finite")
    spread = _lattice_agree(mesh, record)
    if spread != 0.0 or not record:
        raise AssertionError(f"rank {rank}: replicated coarse fields differ across the "
                             f"lattice group by {spread} ({len(record)} recorded)")
    res["replicated_fields"] = len(record)

    # 3. the chains path
    cm = chains_mesh(device)
    dp = DataParallelMGMCSampler(op, 3, cm, smoother="SOR", cycle=2)
    xg = torch.zeros((2 * world,) + op.vshape, dtype=dtype, device=device)
    fu = f[(slice(0, op.vshape[0]), slice(0, op.vshape[1]))]
    a = dp.apply(GeneratorNoise(0, device), fu, dp.scatter(xg))
    b = dp.apply(GeneratorNoise(0, device), fu, dp.scatter(xg))
    single = MultigridMCSampler(op, 3, smoother="SOR", cycle=2, fused=True, distill=True,
                                device=device)
    c = single.apply(GeneratorNoise(fold_seed(0, rank), device), fu, dp.scatter(xg))
    if not (torch.equal(a, b) and torch.equal(a, c)):
        raise AssertionError(f"rank {rank}: chains path not deterministic or not the "
                             "single-device sampler under this rank's noise")
    firsts = dp.gather(a[:1].contiguous())
    for i in range(world):
        for j in range(i):
            if torch.equal(firsts[i], firsts[j]):
                raise AssertionError(f"ranks {i} and {j} drew the same chains")
    res["chains_ok"] = 1
    print(f"rank {rank}: OK - mesh {mesh.shape}, global-noise err {err:.2e} "
          f"(limit {tol * scale:.2e}), {len(record)} replicated fields equal on the lattice "
          f"group, chains path bitwise the single-device sampler", flush=True)
    return res


def task_halo(rank, world, device, options, arrays) -> dict:
    """``halo_exchange`` blocks of the spec's ``x`` at each pad of
    ``options["pads"]``, and one ``sharded_sor_sweep`` of each operator of
    ``options["sweeps"]`` (``omega``, forward colour order) on a lattice mesh
    of ``options["mesh_shape"]``."""
    from ..ops.coloring import coloring_for
    from .halo import halo_exchange, sharded_sor_sweep
    from .mesh import lattice_mesh, scatter_field

    mesh = lattice_mesh(2, mesh_shape=options["mesh_shape"], device=device)
    res = {}
    x = torch.as_tensor(arrays["x"])
    for pad in options["pads"]:
        res[f"halo{pad}"] = _np(halo_exchange(scatter_field(x, mesh, 2), pad, mesh))
    for name in options["sweeps"]:
        op = _op_from_spec(arrays, f"{name}/", device)
        coloring = coloring_for(op.offsets, op.vshape)
        order = tuple(range(coloring.n_colors))
        b = scatter_field(torch.as_tensor(arrays[f"{name}/b"]), mesh, 2)
        xs = scatter_field(torch.as_tensor(arrays[f"{name}/x"]), mesh, 2)
        res[f"sweep/{name}"] = _np(sharded_sor_sweep(op, coloring, options["omega"], order,
                                                     mesh, b, xs))
    return res


def task_cycle(rank, world, device, options, arrays) -> dict:
    """The spec's cases of :class:`~.cycle.ShardedMGMCSampler` (float64), each
    on its mesh: ``"deterministic"`` one cycle of ``b``; ``"global"`` steps
    from ``x`` under ``GeneratorNoise(seed)``; ``"resume"`` ``steps`` steps,
    a checkpoint of each rank and ``steps`` more against ``2 steps``
    uninterrupted ones (:func:`_resumed`, each rank's own blocks);
    ``"moments"`` the mean and covariance of ``nsteps`` steps after
    ``nwarmup`` under ``"sharded"`` noise.  Rank 0 returns the gathered global
    outputs."""
    from ..samplers.base import GeneratorNoise
    from .cycle import ShardedMGMCSampler, pad_field
    from .mesh import multihost_lattice_mesh

    res = {}
    meshes = {}
    for case in options["cases"]:
        key = (case["chains"], tuple(case["mesh_shape"]))
        if key not in meshes:
            meshes[key] = multihost_lattice_mesh(2, chains=case["chains"],
                                                 mesh_shape=case["mesh_shape"], device=device)
        mesh = meshes[key]
        op = _op_from_spec(arrays, case["op"] + "/", device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sampler = ShardedMGMCSampler(op, mesh=mesh, **case["sampler"])
        name = case["name"]
        res[f"{name}/warned_replicated"] = np.array(
            any("REPLICATED" in str(w.message) for w in caught))
        res[f"{name}/sharded"] = np.array([lv.sharded for lv in sampler.levels])
        res[f"{name}/distill_level"] = np.array(
            -1 if sampler.distill_level is None else sampler.distill_level)
        if sampler.distill_spread is not None:
            res[f"{name}/distill_spread"] = np.array(sampler.distill_spread)
        kind = case["kind"]
        if kind == "deterministic":
            b = pad_field(torch.as_tensor(arrays[case["b"]], device=device), op.vshape)
            out = sampler.gather(sampler.apply(None, sampler.scatter(b),
                                               sampler.scatter(torch.zeros_like(b))))
            res[f"{name}/out"] = _np(out)
        elif kind == "global":
            f = pad_field(torch.as_tensor(arrays[case["f"]], device=device), op.vshape)
            x = sampler.scatter(pad_field(torch.as_tensor(arrays[case["x"]], device=device),
                                          op.vshape))
            noise = GeneratorNoise(case["seed"], device)
            fl = sampler.scatter(f)
            for _ in range(case["steps"]):
                x = sampler.apply(noise, fl, x)
            res[f"{name}/out"] = _np(sampler.gather(x))
        elif kind == "resume":
            f = sampler.scatter(pad_field(torch.as_tensor(arrays[case["f"]], device=device),
                                          op.vshape))
            x = sampler.scatter(pad_field(torch.as_tensor(arrays[case["x"]], device=device),
                                          op.vshape))
            got = _resumed(lambda: ShardedMGMCSampler(op, mesh=mesh, **case["sampler"]),
                           lambda: GeneratorNoise(case["seed"], device), f, x, case["steps"],
                           rank, device)
            res.update({f"{name}/{k}": v for k, v in got.items()})
        elif kind == "moments":
            f = sampler.scatter(pad_field(torch.as_tensor(arrays[case["f"]], device=device),
                                          op.vshape))
            pn = tuple(m + 1 for m in op.vshape)
            x = sampler.scatter(torch.zeros((case["nchains"],) + pn, dtype=op.dtype,
                                            device=device))
            noise = GeneratorNoise(case["seed"], device)
            record = []

            def step(x, noise=noise, f=f, sampler=sampler, record=record):
                record.clear()
                return sampler.apply(noise, f, x, record=record)

            mean, cov = _moments(sampler.gather, step, x, case["nwarmup"], case["nsteps"],
                                 op.vshape)
            res[f"{name}/mean"] = mean
            res[f"{name}/cov"] = cov
            res[f"{name}/replicated_spread"] = np.array(_lattice_agree(mesh, record))
        else:
            raise ValueError(f"unknown case kind '{kind}'")
    return res


def task_chains(rank, world, device, options, arrays) -> dict:
    """The chains path on a chains mesh of the world (float64): one step of
    this rank's block of ``options["nchains"]`` chains from ``x`` under
    ``GeneratorNoise(seed)``, repeated from a fresh source; with
    ``resume_steps`` a checkpoint's resume against the uninterrupted run
    (:func:`_resumed`); and the moments gate's mean and covariance
    (``options["moments"]``)."""
    from ..samplers.base import GeneratorNoise
    from .data_parallel import DataParallelMGMCSampler
    from .mesh import chains_mesh

    mesh = chains_mesh(device)
    res = {}
    det = options["step"]
    op = _op_from_spec(arrays, "step_op/", device)
    dp = DataParallelMGMCSampler(op, det["nlevel"], mesh, **det["sampler"])
    f = torch.as_tensor(arrays["step_f"], device=device)
    x = dp.scatter(torch.as_tensor(arrays["step_x"], device=device))
    res["step/x_in"] = _np(x)
    res["step/out"] = _np(dp.apply(GeneratorNoise(det["seed"], device), f, x.clone()))
    res["step/again"] = _np(dp.apply(GeneratorNoise(det["seed"], device), f, x.clone()))
    res["step/distilled"] = np.array(dp.sampler.distilled is not None)
    if det.get("resume_steps"):
        got = _resumed(lambda: DataParallelMGMCSampler(op, det["nlevel"], mesh, **det["sampler"]),
                       lambda: GeneratorNoise(det["seed"], device), f, x, det["resume_steps"],
                       rank, device)
        res.update({f"resume/{k}": v for k, v in got.items()})
    try:
        dp.scatter(torch.zeros((world * 2 + 1,) + op.vshape, dtype=op.dtype, device=device))
        res["step/odd_chains_raised"] = np.array(False)
    except ValueError:
        res["step/odd_chains_raised"] = np.array(True)
    mom = options["moments"]
    op = _op_from_spec(arrays, "moments_op/", device)
    dp = DataParallelMGMCSampler(op, mom["nlevel"], mesh, **mom["sampler"])
    f = torch.as_tensor(arrays["moments_f"], device=device)
    x = dp.scatter(torch.zeros((mom["nchains"],) + op.vshape, dtype=op.dtype, device=device))
    noise = GeneratorNoise(mom["seed"], device)
    mean, cov = _moments(dp.gather, lambda x: dp.apply(noise, f, x), x, mom["nwarmup"],
                         mom["nsteps"], op.vshape)
    if rank == 0:
        res["moments/mean"] = mean
        res["moments/cov"] = cov
    return res


# ------------------------------------------------------- the four-card check
#: the flagship's seed (``bench.py``), its chains a card and its steps timed
FLAGSHIP_SEED = 20260816
MULTICHIP = {"problem": "flagship", "nlevel": 5, "chains": 256, "steps": 20,
             "lattice_mesh": [2, 2], "lattice_chains": 4, "lattice_steps": 5,
             "agglomerate_below": 8, "profile_steps": 3}
#: the world-of-one comparison of the lattice cycle in float32 (the order of
#: the ``B^T x`` all-reduce's sum differs), of the output's scale
FLOAT32_MESH_TOL = 1e-4


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nccl_device_ms(step, nsteps, device) -> Optional[dict]:
    """Device ms per step of the NCCL kernels (and of all kernels) over
    ``nsteps`` calls of ``step``, from torch.profiler; None where it shows no
    device time (or the ranks run on the CPU).  An NCCL kernel runs from its
    launch until its peers' data has arrived, so its device time includes the
    wait for the slowest rank."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(nsteps):
            step()
        torch.cuda.synchronize()
    total, nccl, names = 0.0, 0.0, set()
    for e in prof.key_averages():
        # the "nccl:all_reduce" rows are annotations spanning the kernels
        # they launch: counted, they would count those kernels twice
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("nccl:"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us / 1e3 / nsteps
        if e.key.startswith("nccl"):
            nccl += us / 1e3 / nsteps
            names.add(e.key[:60])
    if total == 0.0:
        return None
    return {"nccl_ms_per_step": nccl, "kernel_ms_per_step": total, "nccl_kernels": sorted(names)}


def _timed_steps(step, x, nsteps, device):
    """Host ms per step of ``nsteps`` steps ending in a synchronize."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(nsteps):
        x = step(x)
    _sync(device)
    return x, 1e3 * (time.perf_counter() - t0) / nsteps


def task_multichip(rank, world, device, options, arrays) -> dict:
    """The four-card check of ``chip_smoke.py --phases multichip``, one card a
    rank over NCCL, float32:

    * the chains path at the flagship's width, :data:`MULTICHIP` ``chains`` a
      card: a step bitwise the single-device sampler's under this rank's
      noise, the ranks' chains pairwise different, samples/s summed over the
      world;
    * the lattice cycle on a ``1 x 2 x 2`` mesh (``lattice_mesh``) at the flagship's 255^2
      (padded 256^2): ``"global"`` noise against the world of one on rank 0
      (:data:`FLOAT32_MESH_TOL` of the output's scale), ``"sharded"`` noise:
      ms per step, the NCCL kernels' device ms, the replicated levels bitwise
      equal across the lattice shards.

    ``options`` override :data:`MULTICHIP` (a small ``"problem": "dryrun"``
    rehearses the task in a gloo world on the CPU, in float64)."""
    import torch.distributed as dist

    from ..samplers.base import GeneratorNoise
    from ..samplers.mgmc import MultigridMCSampler
    from .cycle import ShardedMGMCSampler, pad_field
    from .data_parallel import DataParallelMGMCSampler, rank_noise
    from .mesh import chains_mesh, multihost_lattice_mesh, single_mesh

    cfg = dict(MULTICHIP, **options)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    op = _problem(cfg["problem"], device, dtype)
    nlevel, C = cfg["nlevel"], cfg["chains"]
    kw = dict(smoother="SOR", coarse_solver="Cholesky", omega=1.0, cycle=2)
    f = torch.as_tensor(np.random.default_rng(0).uniform(size=op.vshape), dtype=dtype,
                        device=device)
    res = {"card": np.array(torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu")}

    # the chains path
    cm = chains_mesh(device)
    dp = DataParallelMGMCSampler(op, nlevel, cm, **kw)
    single = MultigridMCSampler(op, nlevel, fused=True, distill=True, device=device, **kw)
    zeros = torch.zeros((C,) + op.vshape, dtype=dtype, device=device)
    noise = GeneratorNoise(FLAGSHIP_SEED, device)
    a = dp.apply(noise, f, zeros.clone())
    b = single.apply(rank_noise(GeneratorNoise(FLAGSHIP_SEED, device), cm), f, zeros.clone())
    res["chains_bitwise_single_device"] = np.array(bool(torch.equal(a, b)))
    firsts = dp.gather(a[:1].contiguous())
    res["chains_pairwise_distinct"] = np.array(all(
        not torch.equal(firsts[i], firsts[j]) for i in range(world) for j in range(i)))
    a, ms = _timed_steps(lambda x: dp.apply(noise, f, x), a, 2, device)
    a, ms = _timed_steps(lambda x: dp.apply(noise, f, x), a, cfg["steps"], device)
    rate = torch.tensor([C * 1e3 / ms], dtype=torch.float64, device=device)
    dist.all_reduce(rate)
    res["chains_ms_per_step"] = np.array(ms)
    res["chains_samples_per_s_world"] = np.array(float(rate.item()))
    res["chains_finite"] = np.array(bool(torch.isfinite(a).all()))
    res["chains_route_by_level"] = np.array(json.dumps(
        {li: dp.sampler.fused_levels[li].route(C) for li in sorted(dp.sampler.fused_levels)
         if dp.sampler.distilled is None or li < dp.sampler.distill_level}))

    # the lattice cycle on 2 x 2
    lm = multihost_lattice_mesh(2, chains=1, mesh_shape=cfg["lattice_mesh"], device=device)
    lkw = dict(nlevel=nlevel, smoother="SOR", cycle=2, agglomerate_below=cfg["agglomerate_below"])
    Cl = cfg["lattice_chains"]
    fp = pad_field(f, op.vshape)
    x0 = torch.zeros((Cl,) + tuple(m + 1 for m in op.vshape), dtype=dtype, device=device)
    glob = ShardedMGMCSampler(op, mesh=lm, noise_mode="global", **lkw)
    out = glob.gather(glob.apply(GeneratorNoise(FLAGSHIP_SEED, device), glob.scatter(fp),
                                 glob.scatter(x0)))
    if rank == 0:
        one = ShardedMGMCSampler(op, mesh=single_mesh(2, device), noise_mode="global", **lkw)
        ref = one.apply(GeneratorNoise(FLAGSHIP_SEED, device), fp, x0.clone())
        scale = max(float(ref.abs().max()), 1.0)
        res["lattice_global_err"] = np.array(float((out - ref).abs().max()))
        res["lattice_global_limit"] = np.array(FLOAT32_MESH_TOL * scale)
    prod = ShardedMGMCSampler(op, mesh=lm, noise_mode="sharded", **lkw)
    res["lattice_sharded_levels"] = np.array([lv.sharded for lv in prod.levels])
    res["lattice_distill_level"] = np.array(-1 if prod.distill_level is None
                                            else prod.distill_level)
    fl = prod.scatter(fp)
    noise = GeneratorNoise(FLAGSHIP_SEED, device)
    record = []
    xl = prod.apply(noise, fl, prod.scatter(x0), record=record)
    res["lattice_replicated_spread"] = np.array(_lattice_agree(lm, record))
    res["lattice_replicated_fields"] = np.array(len(record))
    xl, ms = _timed_steps(lambda x: prod.apply(noise, fl, x), xl, 1, device)
    xl, ms = _timed_steps(lambda x: prod.apply(noise, fl, x), xl, cfg["lattice_steps"], device)
    res["lattice_ms_per_step"] = np.array(ms)
    res["lattice_finite"] = np.array(bool(torch.isfinite(xl).all()))
    holder = [xl]

    def step():
        holder[0] = prod.apply(noise, fl, holder[0])

    res["lattice_profile"] = np.array(json.dumps(
        _nccl_device_ms(step, cfg["profile_steps"], device)))
    return res


#: the worker tasks :func:`launch` can start: ``fn(rank, world, device,
#: options, arrays) -> dict of arrays``
TASKS: Dict[str, Callable] = {
    "dryrun": task_dryrun,
    "halo": task_halo,
    "cycle": task_cycle,
    "chains": task_chains,
    "multichip": task_multichip,
}


# ===================================================================== main
def worker(task: str, rank: int, world: int, port: int, device: str, spec, out) -> None:
    from .mesh import init_distributed, rank_device
    import torch.distributed as dist

    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                     device=device)
    try:
        options, arrays = load_spec(spec)
        res = TASKS[task](rank, world, rank_device(device), options, arrays)
        if out is not None:
            np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=None, help="number of ranks")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda: one card a rank over NCCL (default); cpu: gloo")
    parser.add_argument("--out", default=None, help="write the ranks' results to this .npz")
    parser.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT)
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.rank, args.world, args.port, args.device, args.spec, args.out)
        return 0
    if args.world is None:
        parser.error("--world is required")
    try:
        res = launch("dryrun", args.world, device=args.device, out=args.out,
                     timeout=args.timeout)
    except RuntimeError as e:
        print(e)
        print("dryrun: FAILED")
        return 1
    for r in range(args.world):
        lines = [ln for ln in str(res[f"{r}/log"]).splitlines() if ln.startswith(f"rank {r}:")]
        print(lines[-1] if lines else f"rank {r}: (no report)")
    print("dryrun: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
