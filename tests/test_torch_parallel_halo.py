"""The port's halo exchange and sharded sweep (``multigridmc_tpu_torch/parallel``)
against the JAX package's ``parallel/halo.py`` and ``parallel/mesh.py``.

The port's ranks are processes: the cases share one 2x2 world of gloo ranks on
the CPU, started through the port's launcher (``parallel/dryrun.py``), which
writes each rank's blocks to an ``.npz``.  The JAX side runs here, on a 2x2
mesh of the virtual CPU devices of ``tests/conftest.py``, while the world
runs.  The padded blocks must be equal exactly; the sweeps to 1e-12 (float64).
"""

import concurrent.futures
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu.models.prior import (
    shiftedlaplace_fd,
    shiftedlaplace_fem,
    squared_shiftedlaplace_fd,
)
from multigridmc_tpu.ops.coloring import coloring_for
from multigridmc_tpu.parallel.halo import halo_exchange, shard_map_sor_sweep
from multigridmc_tpu.parallel.mesh import factor_devices as jax_factor_devices

from multigridmc_tpu_torch.parallel import dryrun
from multigridmc_tpu_torch.parallel.mesh import factor_devices

PADS = (1, 2)
PRIORS = {"fd": shiftedlaplace_fd, "fem": shiftedlaplace_fem,
          "biharm": squared_shiftedlaplace_fd}
OMEGA = 0.9
WORLD = (2, 2)


def _mesh22():
    return Mesh(np.asarray(jax.devices()[:4]).reshape(WORLD), ("ly", "lx"))


def _operators():
    lattice = Lattice((65, 65))  # vshape (64, 64) divides the 2x2 mesh
    return {name: make(lattice, ConstantCorrelationLengthModel(0.3))
            for name, make in PRIORS.items()}


def _assemble(res, key, block_shape):
    """The ranks' blocks of ``key`` laid out as shard_map lays out its
    per-shard outputs: rank (i, j) of the 2x2 world at block (i, j)."""
    h, w = block_shape
    out = np.zeros((WORLD[0] * h, WORLD[1] * w))
    for r in range(WORLD[0] * WORLD[1]):
        i, j = divmod(r, WORLD[1])
        out[i * h:(i + 1) * h, j * w:(j + 1) * w] = res[f"{r}/{key}"]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's results from one 2x2 world of gloo ranks, and the JAX
    package's on the same inputs (computed while the world runs)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 64))
    ops = _operators()
    arrays = {"x": x}
    for name, op in ops.items():
        arrays.update(dryrun.operator_arrays(f"{name}/", np.asarray(op.coeffs), op.offsets,
                                             op.lattice.shape))
        arrays[f"{name}/b"] = rng.normal(size=op.vshape)
        arrays[f"{name}/x"] = rng.normal(size=op.vshape)
    spec = tmp_path_factory.mktemp("halo") / "spec.npz"
    dryrun.save_spec(spec, {"mesh_shape": list(WORLD), "pads": list(PADS),
                            "sweeps": list(PRIORS), "omega": OMEGA}, **arrays)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(dryrun.launch, "halo", 4, device="cpu", spec=spec, timeout=600)
        mesh = _mesh22()
        ref = {}
        for pad in PADS:
            @functools.partial(shard_map, mesh=mesh, in_specs=(P("ly", "lx"),),
                               out_specs=P("ly", "lx"))
            def padded(xl, pad=pad):
                return halo_exchange(xl, pad, ("ly", "lx"))

            ref[f"halo{pad}"] = np.asarray(padded(jnp.asarray(x)))
        for name, op in ops.items():
            coloring = coloring_for(op.offsets, op.vshape)
            order = tuple(range(coloring.n_colors))
            ref[f"sweep/{name}"] = np.asarray(jax.jit(
                lambda b, xx, op=op, coloring=coloring, order=order: shard_map_sor_sweep(
                    op, coloring, OMEGA, order, mesh, b, xx))(
                jnp.asarray(arrays[f"{name}/b"]), jnp.asarray(arrays[f"{name}/x"])))
        res = running.result()
    return res, ref, x.shape


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_factor_devices_matches_jax(dim):
    for n in range(1, 17):
        assert factor_devices(n, dim) == jax_factor_devices(n, dim), (n, dim)


@pytest.mark.parametrize("pad", PADS)
def test_halo_exchange_matches_jax(world, pad):
    """Each rank's padded block (corners included: the axes one after
    another) equals the JAX ``halo_exchange``'s shard, exactly."""
    res, ref, shape = world
    block = (shape[0] // WORLD[0] + 2 * pad, shape[1] // WORLD[1] + 2 * pad)
    got = _assemble(res, f"halo{pad}", block)
    np.testing.assert_array_equal(got, ref[f"halo{pad}"])
    # the corners of an interior corner are the diagonal neighbour's values
    assert np.count_nonzero(res[f"0/halo{pad}"][-pad:, -pad:]) == pad * pad


@pytest.mark.parametrize("name", list(PRIORS), ids=["fd5pt", "fem9pt", "biharm13pt"])
def test_sharded_sweep_matches_jax(world, name):
    """The explicit-halo colour sweep on the 2x2 world equals the JAX
    ``shard_map_sor_sweep`` on a 2x2 mesh (width-1 and width-2 halos)."""
    res, ref, _ = world
    got = _assemble(res, f"sweep/{name}", (32, 32))
    np.testing.assert_allclose(got, ref[f"sweep/{name}"], rtol=1e-12, atol=1e-13)


def test_dryrun_cli_over_gloo():
    """``python -m multigridmc_tpu_torch.parallel.dryrun --world 2 --device
    cpu``: both noise modes of the lattice cycle and the chains path, OK on
    every rank."""
    out = subprocess.run(
        [sys.executable, "-m", "multigridmc_tpu_torch.parallel.dryrun", "--world", "2",
         "--device", "cpu"], cwd=str(dryrun.PACKAGE_ROOT), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "dryrun: OK"
    assert lines[0].startswith("rank 0: OK") and lines[1].startswith("rank 1: OK")
