"""The split route of the sweep kernels (``csrc/sor_sweep_cluster.cu``: each
chain's field split over a thread-block cluster, its bands in shared memory) on
the CPU, where it cannot run: a plain PyTorch emulation of its schedule, against

(a) ``sweep_batched_plain`` and, with the normals ``xi`` given,
    ``gibbs_sweep_batched_plain`` in float64, bitwise: the bands of
    ``split_layout``, every block's band in its own copy (its shared memory),
    the ``reach`` units outside a band read from the neighbouring band, and the
    colour phases separated by the cluster barrier - on 2-colour 5-point,
    4-colour 9-point Galerkin, 13-point reach-2, space-varying and 3d 7-point
    operators, a 15^2 level whose cluster size the route caps below 16, and a
    cluster size that does not divide the rows;
(b) the JAX package's ``sweep_batched_v2`` in interpret mode, as
    ``tests/test_torch_sor_sweep.py`` runs it (float32, ``rtol = atol = 2e-5``:
    another summation order); the Gibbs sweep as the sweep on
    ``c = f + sqrt(diag (2 - omega) / omega) xi``;
(c) the route: chosen before any launch from the chain count, the shape, the
    band layout's shared memory (the host's mirror of the kernel's) and the
    cluster's schedulability; the drivers' one-chain shapes take the split
    route, 256 chains, a 1023^2 field and the distillation's 28,529 basis
    fields one block per chain;
(d) the visit route against the shared memory a block is granted, passed in.

``chip_smoke.py`` holds the kernels themselves against the plain versions and
against each other on the card.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConstant
from multigridmc_tpu.models.correlation import PeriodicCorrelationLengthModel as JPeriodic
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshiftedlaplace_fd
from multigridmc_tpu.models.prior import squared_shiftedlaplace_fd as jsquared_fd
from multigridmc_tpu.ops.coarsen import galerkin_coarsen as jgalerkin
from multigridmc_tpu.ops.kernels import sor_pallas_v2 as v2

from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.kernels import sor_sweep as ss
from multigridmc_tpu_torch.smoothers import SORSmoother

from test_torch_common import CPU, F32, assert_close, to_port, tt

CSRC = Path(ss.__file__).resolve().parents[2] / "csrc"
OFFSETS5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
#: what a block of the H100 is granted (``mgmc_visit.SMEM_PER_BLOCK_OPTIN``)
H100_SMEM = mv.SMEM_PER_BLOCK_OPTIN


def _jax_operator(kind, dtype):
    if kind == "fd5pt":  # 23^2
        return jshiftedlaplace_fd(JLattice((24, 24)), JConstant(0.3), dtype=dtype)
    if kind == "fd5pt_15":  # 15^2
        return jshiftedlaplace_fd(JLattice((16, 16)), JConstant(0.3), dtype=dtype)
    if kind == "galerkin9pt":  # 15^2, 4 colours
        return jgalerkin(jshiftedlaplace_fd(JLattice((32, 32)), JConstant(0.3), dtype=dtype))
    if kind == "periodic5pt":  # coefficient planes (and the diagonal) vary in space
        return jshiftedlaplace_fd(JLattice((24, 24)), JPeriodic(0.2, 0.4), dtype=dtype)
    if kind == "3d7pt":  # 7 planes of 9 x 11
        return jshiftedlaplace_fd(JLattice((8, 10, 12)), JConstant(0.3), dtype=dtype)
    if kind == "reach2_13pt":  # 15^2, reach 2
        return jsquared_fd(JLattice((16, 16)), JConstant(0.3), dtype=dtype)
    raise ValueError(kind)


def _inputs(vshape, seed, C=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C,) + vshape), rng.normal(size=vshape),
            rng.normal(size=(C,) + vshape), rng.normal(size=(C,) + vshape))


def split_bounds(L, S):
    """``(u0, u1)`` of every rank: the first ``L % S`` ranks take one unit more,
    as ``band_of`` in the source."""
    base, rem = divmod(L, S)
    bounds, u = [], 0
    for k in range(S):
        nb = base + (k < rem)
        bounds.append((u, u + nb))
        u += nb
    return bounds


def split_sweep_emulation(plan, S, b, x, xi=None):
    """What ``cluster_sweep_kernel`` does, in plain PyTorch: one sweep of ``x``
    ``(C, *vshape)`` on ``b`` (or, with ``xi``, the Gibbs sweep on
    ``c = b + noise_scale * xi``) over clusters of ``S`` blocks.  Block ``k``
    keeps its band of ``x`` and ``c`` in a copy of its own; in each colour
    phase it computes its points of the colour from a field in which only its
    band and the ``reach`` units of the neighbouring bands next to it are
    visible (zeros elsewhere), all blocks from the state before the phase; then
    the new bands replace the old (the cluster barrier).  Returns a new tensor."""
    op = plan.op
    L, _, axis = ss.split_layout(op.vshape)
    assert axis == 0  # the fields here split along their first axis
    reach = ss.slow_reach(op.offsets, op.vshape)
    ss.split_smem_bytes(op.vshape, S, reach, 0)  # raises where the field does not split so
    bounds = split_bounds(L, S)
    c = b if xi is None else b + ss.noise_scale(op, plan.omega) * xi
    c = torch.broadcast_to(c, x.shape)
    bands = [x[:, u0:u1].clone() for u0, u1 in bounds]  # loaded once
    cbands = [c[:, u0:u1].clone() for u0, u1 in bounds]  # formed at load
    diag = op.diag_stencil()
    for ci in plan.order:
        new = []
        for k, (u0, u1) in enumerate(bounds):
            visible = torch.zeros_like(x)
            visible[:, u0:u1] = bands[k]
            if reach and k > 0:  # the lower halo, from rank k - 1
                visible[:, u0 - reach:u0] = bands[k - 1][:, -reach:]
            if reach and k + 1 < S:  # the upper halo, from rank k + 1
                visible[:, u1:u1 + reach] = bands[k + 1][:, :reach]
            ax = op.apply_stencil(visible)[:, u0:u1]
            new.append(bands[k] + plan.masks[ci][u0:u1]
                       * (plan.omega * (cbands[k] - ax) / diag[u0:u1]))
        bands = new  # cluster.sync()
    return torch.cat(bands, dim=1)  # written back once


# ------------------------------------------------- (a) the schedule, float64
# (case, operator, cluster size; None: the route's own choice at one chain)
SPLIT_CASES = {
    "2colour_5point": ("fd5pt", 4),
    "4colour_9point_galerkin": ("galerkin9pt", 8),
    "13point_reach2": ("reach2_13pt", 4),
    "varying_coefficients": ("periodic5pt", 8),
    "3d_7point": ("3d7pt", 4),
    "15x15_level_capped_by_rows": ("fd5pt_15", None),
    "S_does_not_divide_the_rows": ("fd5pt", 16),
}


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_schedule_is_the_sweep(case, direction):
    kind, S = SPLIT_CASES[case]
    a = _jax_operator(kind, jnp.float64)
    plan = SORSmoother(to_port(a), 1.3, 1, direction).plan
    L = ss.split_layout(plan.op.vshape)[0]
    if S is None:  # 16 blocks for 15 rows: the route caps the cluster at 8
        route = ss.sweep_route(1, plan, 1)
        assert route == ("split", 8)
        S = route[1]
        with pytest.raises(ValueError, match="does not split"):
            ss.split_smem_bytes(plan.op.vshape, 16, 1, 1)
    if case == "S_does_not_divide_the_rows":
        assert L % S and len({u1 - u0 for u0, u1 in split_bounds(L, S)}) == 2
    x, f, b, xi = (tt(v) for v in _inputs(plan.op.vshape, seed=11))
    want = ss.sweep_batched_plain(plan.op, plan.masks, plan.omega, plan.order, b, x)
    got = split_sweep_emulation(plan, S, b, x)
    assert torch.equal(got, want)
    want = ss.gibbs_sweep_batched_plain(plan.op, plan.masks, plan.omega, plan.order, f, x, xi)
    got = split_sweep_emulation(plan, S, f, x, xi)
    assert torch.equal(got, want)


def test_emulation_sees_a_halo_that_is_too_narrow():
    # reach 2 over bands of one row: the route refuses it, and the emulation
    # would miss the second halo row
    plan = SORSmoother(to_port(_jax_operator("reach2_13pt", jnp.float64)), 1.0, 1).plan
    assert ss.slow_reach(plan.op.offsets, plan.op.vshape) == 2
    with pytest.raises(ValueError, match="does not split"):
        ss.split_smem_bytes(plan.op.vshape, 8, 2, 0)
    # the cluster size the split route takes (reach-2 sweeps themselves take
    # one block per chain at every chain count: SPLIT_MAX_CHAINS)
    assert ss.split_size(1, plan.op.vshape, plan.op.offsets, 0, plan.op.device) == 4
    assert ss.sweep_route(1, plan, 0) == ss.BLOCK_ROUTE


# ----------------------------------- (b) against the interpreted Pallas kernel
@pytest.mark.parametrize("kind,S,direction", [("fd5pt", 4, "forward"),
                                              ("galerkin9pt", 8, "backward"),
                                              ("3d7pt", 4, "forward")])
def test_split_schedule_matches_interpreted_pallas_kernel(kind, S, direction):
    a = _jax_operator(kind, jnp.float32)
    plan = SORSmoother(to_port(a, torch.float32), 1.3, 1, direction).plan
    x, f, b, xi = _inputs(a.vshape, seed=12)
    kw = dict(offsets=a.offsets, diag_index=a.diag_index, omega=1.3, order=plan.order,
              color_weights=plan.coloring.weights, n_colors=plan.coloring.n_colors,
              interpret=True)
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    want = v2.sweep_batched_v2(a.coeffs, f32(b), f32(x), **kw)
    got = split_sweep_emulation(plan, S, tt(b, torch.float32), tt(x, torch.float32))
    assert_close(got, want, **F32)
    # the Gibbs sweep is the sweep on c = f + noise_scale * xi
    ns = np.asarray(plan.noise_scale, dtype=np.float64)
    want = v2.sweep_batched_v2(a.coeffs, f32(f + ns * xi), f32(x), **kw)
    got = split_sweep_emulation(plan, S, tt(f, torch.float32), tt(x, torch.float32),
                                tt(xi, torch.float32))
    assert_close(got, want, **F32)


# ------------------------------------------------------------- (c) the route
def _driver_plan(nx, galerkin=False):
    from multigridmc_tpu_torch.lattice import Lattice
    from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
    from multigridmc_tpu_torch.ops.coarsen import galerkin_coarsen

    op = shiftedlaplace_fd(Lattice((nx, nx)), ConstantCorrelationLengthModel(0.2),
                           device=CPU, dtype=torch.float32)
    return SORSmoother(galerkin_coarsen(op) if galerkin else op, 1.0, 1).plan


@pytest.mark.parametrize("limit", [None, H100_SMEM])
def test_drivers_shapes_take_the_split_route(limit):
    fine, coarse = _driver_plan(256), _driver_plan(256, galerkin=True)
    assert fine.op.vshape == (255, 255) and coarse.op.vshape == (127, 127)
    # drivers.mgmc's one-chain SSOR series (Gibbs) and drivers.mg's solve
    # (deterministic sweeps on 255^2; on its 127^2 Galerkin level the passes
    # body beats the split route at one chain, so one block)
    assert ss.sweep_route(1, fine, 1, limit) == ("split", 16)
    assert ss.sweep_route(1, fine, 0, limit) == ("split", 16)
    assert ss.sweep_route(1, coarse, 0, limit) == ss.BLOCK_ROUTE
    assert ss.sweep_route(1, coarse, 1, limit) == ("split", 16)
    # 256 replica chains (the convergence tables) and the distillation's basis
    # fields keep one block per chain
    for C in (256, 28529):
        assert ss.sweep_route(C, fine, 1, limit) == ss.BLOCK_ROUTE
    # the thresholds by kernel and stencil size (on the CPU every cluster is
    # taken to run at once: the largest size that fits)
    assert ss.SPLIT_MAX_CHAINS == {("sweep", "5-point"): 16, ("gibbs", "5-point"): 32,
                                   ("sweep", "9-point"): 0, ("gibbs", "9-point"): 16,
                                   ("sweep", "3d"): 0, ("gibbs", "3d"): 0,
                                   ("sweep", "3d 27-point"): 8, ("gibbs", "3d 27-point"): 16,
                                   ("sweep", "reach-2"): 0, ("gibbs", "reach-2"): 0}
    for plan in (fine, coarse):
        for noise_mode in (0, 1, 2):
            most = ss.split_max_chains(plan.op.vshape, plan.op.offsets, noise_mode)
            assert most == ss.SPLIT_MAX_CHAINS[("gibbs" if noise_mode else "sweep",
                                                "5-point" if plan is fine else "9-point")]
            for C in range(1, most + 1):
                assert ss.sweep_route(C, plan, noise_mode, limit) == ("split", 16)
            assert ss.sweep_route(most + 1, plan, noise_mode, limit) == ss.BLOCK_ROUTE
    # 3d 7-point and other 3d stencils and 2d stencils of reach 2 have
    # thresholds of their own
    offsets3 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
    box27 = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
    reach2 = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (0, -2), (2, 0), (-2, 0))
    for vshape, offsets, cls in (((63, 63, 63), offsets3, "3d"),
                                 ((31, 31, 31), box27, "3d 27-point"),
                                 ((63, 63), reach2, "reach-2")):
        assert ss.split_stencil(vshape, offsets) == cls
        for noise_mode, kernel in ((0, "sweep"), (1, "gibbs"), (2, "gibbs")):
            assert (ss.split_max_chains(vshape, offsets, noise_mode)
                    == ss.SPLIT_MAX_CHAINS[(kernel, cls)])


#: clusters of a 255^2 sweep that an H100 holds at once, by cluster size (the
#: split_layout line of chip_smoke.py; the Gibbs kernel's S = 2 does not fit)
ACTIVE_255 = {16: 7, 8: 15, 4: 30, 2: 66}


@pytest.mark.parametrize("C,deterministic,gibbs", [
    (1, 16, 16), (4, 16, 16), (8, 8, 8), (16, 16, 16), (32, 16, 16), (64, 2, 8)])
def test_cluster_size_minimises_the_waves(monkeypatch, C, deterministic, gibbs):
    # the cluster sizes the 255^2 rows of the sweep_routes table measured best
    # (or within a few per cent of it) at these chain counts
    def active(device, noise_mode, S, threads, nbytes):
        return 0 if (noise_mode and S == 2) else ACTIVE_255[S]

    monkeypatch.setattr(ss, "active_clusters", active)
    fine = _driver_plan(256)
    args = (fine.op.vshape, fine.op.offsets)
    assert ss.split_size(C, *args, 0, "cuda", H100_SMEM) == deterministic
    assert ss.split_size(C, *args, 1, "cuda", H100_SMEM) == gibbs
    want = (("split", deterministic) if C <= ss.split_max_chains(*args, 0)
            else ss.BLOCK_ROUTE)
    assert ss.sweep_route(C, fine, 0, H100_SMEM) == want
    assert ss.split_cost(8, 16, 7) == 2 * (1 / 16 + ss.SPLIT_WAVE_FIXED)


def test_wide_and_deep_fields_take_the_route_their_bands_allow():
    # 1023^2: 64 rows of 1023 floats at S = 16 exceed a block's shared memory
    # (the first-point table before them: 9 x 9 ints, up to 9 colours)
    assert ss.SPLIT_TABLE_INTS == 81
    assert ss.split_smem_bytes((1023, 1023), 16, 1, 0) == 4 * (81 + 64 * 1023)
    assert ss.split_route(1, (1023, 1023), OFFSETS5, 0, CPU, H100_SMEM) == ss.BLOCK_ROUTE
    # 63^3, 7-point: four planes of 63^2 per block, x and c: 127,332 B
    offsets3 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
    assert ss.split_smem_bytes((63, 63, 63), 16, 1, 1) == 127332
    assert ss.split_size(1, (63, 63, 63), offsets3, 1, CPU, H100_SMEM) == 16
    assert ss.split_size(1, (63, 63, 63), offsets3, 1, CPU) is None  # 48 KiB
    # (the field's sweeps take one block per chain at every count: the smem3d
    # body, SPLIT_MAX_CHAINS[(kernel, "3d")] = 0)
    assert ss.split_route(1, (63, 63, 63), offsets3, 1, CPU, H100_SMEM) == ss.BLOCK_ROUTE
    # the shared memory a block is granted decides where the route allows it
    need = ss.split_smem_bytes((255, 255), 16, 1, 1)
    assert need == 4 * (81 + 16 * 255 * 2) == 32964
    assert ss.split_route(1, (255, 255), OFFSETS5, 1, CPU, need) == ("split", 16)
    assert ss.split_route(1, (255, 255), OFFSETS5, 1, CPU, need - 4) == ss.BLOCK_ROUTE


def test_split_layout_follows_the_slowest_axis():
    assert ss.split_layout((255, 255)) == (255, 255, 0)
    assert ss.split_layout((7, 9, 11)) == (7, 99, 0)
    assert ss.split_layout((1, 9, 11)) == (9, 11, 1)  # one plane: split by rows
    assert ss.slow_reach(OFFSETS5, (9, 9)) == 1
    assert ss.split_threads((255, 255), 16) == 1024
    assert ss.split_threads((15, 15), 8) == 64
    assert ss.split_threads((127, 127), 16) == 256
    for S in ss.SPLIT_SIZES:
        assert ss.split_smem_bytes((255, 255), S, 1, 1) == 2 * ss.split_smem_bytes(
            (255, 255), S, 1, 0) - 4 * ss.SPLIT_TABLE_INTS
    for bad in (1, 17, 32):
        with pytest.raises(ValueError, match="does not split"):
            ss.split_smem_bytes((255, 255), bad, 1, 0)


def test_layout_mirror_constants_match_the_kernel_source():
    src = (CSRC / "sor_sweep_cluster.cu").read_text()
    assert re.search(r"#define MAX_CLUSTER (\d+)", src).group(1) == str(ss.SPLIT_SIZES[0])
    assert "#define SPLIT_TABLE_INTS (MAX_COLORS * MAX_COLORS)" in src
    header = (CSRC / "sor_sweep.cuh").read_text()
    assert int(re.search(r"#define MAX_COLORS (\d+)", header).group(1)) ** 2 == (
        ss.SPLIT_TABLE_INTS)
    assert "sor_sweep_cluster" in common.SOURCES and "sor_sweep.cuh" in common.HEADERS


def test_plan_decides_the_route_when_it_builds_its_parameter_block():
    plan = _driver_plan(256)
    assert plan._routes == {}
    P = plan.params(1, True, 1, (3, 4))
    assert plan._routes == {(1, True): ("split", 16)}
    assert plan.params(1, True, 2, None) is not P  # another launch configuration
    assert plan.route(1, 2) == ("split", 16) and len(plan._routes) == 1
    plan.params(300, False, 0, None)
    assert plan._routes[(300, False)] == ss.BLOCK_ROUTE


def test_launches_take_cuda_tensors_and_a_named_route():
    plan = _driver_plan(16)
    x = torch.zeros((1,) + plan.op.vshape)
    b = torch.zeros(plan.op.vshape)
    ss.reset_launch_counts()
    for route in (ss.BLOCK_ROUTE, ("split", 4)):
        with pytest.raises(ValueError, match="CUDA device"):
            ss.launch_sweep(plan, route, b, x)
        with pytest.raises(ValueError, match="CUDA device"):
            ss.launch_gibbs_sweep(plan, route, b, x, xi=x)
    with pytest.raises(ValueError, match="one of the two"):
        ss.launch_gibbs_sweep(plan, ("split", 4), b, x)
    for bad in (("split", 1), ("block", 4), ("cluster", 4)):
        with pytest.raises(ValueError, match="route must be"):
            ss._check_route(bad, _FakeCuda())
    assert all(v == 0 for v in ss.launch_counts.values())


class _FakeCuda:
    """Stands in for a CUDA tensor where only the device is asked."""

    device = torch.device("cuda", 0)


# ------------------------------------------------------ the generator's key
def test_kernels_philox_key_is_not_the_seed():
    src = (CSRC / "philox.cuh").read_text()
    assert int(re.search(r"#define PHILOX_KEY_MIX (0x[0-9A-F]+)ULL", src).group(1), 16) == (
        common.PHILOX_KEY_MIX)
    assert common.PHILOX_KEY_MIX.to_bytes(8, "big") == b"MGMC_KEY"
    seed = 0x0123_4567_89AB_CDEF
    assert common.philox_key(seed) == seed ^ common.PHILOX_KEY_MIX != seed
    mixed = common.philox_normals_reference(seed, 5, 2, (3, 8))
    np.testing.assert_array_equal(
        mixed, common.philox_normals_reference(seed, 5, 2, (3, 8), key=common.philox_key(seed)))
    bare = common.philox_normals_reference(seed, 5, 2, (3, 8), key=seed)
    assert not np.allclose(mixed, bare)


# ------------------------------------------------- (d) the visit route's limit
@pytest.mark.parametrize("limit", [48 * 1024, 100 * 1024, H100_SMEM])
def test_visit_route_compares_with_the_granted_shared_memory(monkeypatch, limit):
    # without a level shape the route has no stream threshold: the phase kernels
    assert mv.visit_route(256, 0, smem_limit=limit) == "phase"
    # the flagship's 255^2 stream launch needs 75,212 B plus the static part:
    # at its threshold of 256 chains it takes the stream kernels only where a
    # block is granted that much
    assert mv.stream_min_chains((255, 255), 0) == 256
    fine = {"vshape": (255, 255), "form": 0}
    need = 75212 + mv.STREAM_STATIC_SMEM
    assert mv.visit_route(256, 75212, smem_limit=limit, **fine) == (
        "stream" if need <= limit else "phase")
    assert mv.visit_route(256, limit - mv.STREAM_STATIC_SMEM, smem_limit=limit,
                          **fine) == "stream"
    assert mv.visit_route(256, limit - mv.STREAM_STATIC_SMEM + 4, smem_limit=limit,
                          **fine) == "phase"
    assert mv.visit_route(mv.stream_min_chains((255, 255), 0) - 1, 0, smem_limit=limit,
                          **fine) == "phase"
    # without a limit the route asks the device: on the CPU its default, 48 KiB
    assert mv.visit_route(256, 75212, device=CPU, **fine) == "phase"
    assert mv.visit_route(256, 40000, device=CPU, **fine) == "stream"
