"""The subtree kernel's plain version, its host-side plans and the shared-memory
probe, on the CPU.

The CUDA kernel itself runs on the card only (``chip_smoke.py`` holds it
against :func:`subtree_sample_plain` there).  Here the plain version is held

* in float32, noise off, against the JAX package's ``SubtreeKernel`` in
  interpret mode at ``rtol = atol = 5e-4`` (the tolerance of
  ``tests/test_mgmc_visit.py::test_subtree_kernel_matches_composed``: a whole
  W-cycle below the finest level in float32, the coarse sample by the inverse
  factor), and
* in float64 against the port's composed recursion under the same replayed
  noise at ``rtol = 1e-9`` (another summation order and the inverse factor in
  place of two triangular solves).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridmc_tpu.lattice import Lattice as JLattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel as JConstant
from multigridmc_tpu.models.posterior import MeasurementParameters as JMeasurementParameters
from multigridmc_tpu.models.posterior import measured_operator as jmeasured_operator
from multigridmc_tpu.models.prior import shiftedlaplace_fd as jshiftedlaplace_fd
from multigridmc_tpu.ops.kernels.mgmc_subtree_pallas import SubtreeKernel as JSubtreeKernel
from multigridmc_tpu.smoothers import BACKWARD, FORWARD
from multigridmc_tpu.smoothers import SORSmoother as JSORSmoother
from multigridmc_tpu.solvers.multigrid import MultigridHierarchy as JMultigridHierarchy

from multigridmc_tpu_torch.convert import subtree_kernel_from_numpy
from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
from multigridmc_tpu_torch.samplers.base import GeneratorNoise, NoiseSource, ReplayNoise
from multigridmc_tpu_torch.samplers.distill import _SubtreeSpec
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

from test_torch_common import CPU, jax_operator, to_port, tt


class RecordingNoise(NoiseSource):
    """Tensors from a generator, recorded in call order; no Philox stream."""

    def __init__(self, seed):
        self.inner = GeneratorNoise(seed, CPU)
        self.record = []

    def normal(self, shape, dtype, device):
        t = self.inner.normal(shape, dtype, device)
        self.record.append(t.numpy().copy())
        return t


def level_dicts(operators):
    return [dict(coeffs=np.asarray(o.coeffs), offsets=o.offsets, lattice_shape=o.lattice.shape,
                 B=np.asarray(o.lowrank.B), Sigma_diag=np.asarray(o.lowrank.Sigma_diag))
            for o in operators]


def test_plain_version_matches_jax_kernel_in_interpret_mode():
    """float32, noise off, 32x32 posterior, 3 levels, W-cycle, gamma = 0.75."""
    prior = jshiftedlaplace_fd(JLattice((32, 32)), JConstant(0.3), dtype=jnp.float32)
    rng = np.random.default_rng(5)
    op = jmeasured_operator(prior, JMeasurementParameters(
        measurement_locations=rng.uniform(0.1, 0.9, size=(4, 2)), mean=rng.normal(size=4),
        variance=0.5 + rng.uniform(size=4)))
    ops = JMultigridHierarchy(op, 3).operators
    cycle, gamma, omega = 2, 0.75, 1.0
    pres = [JSORSmoother(o, omega, 1, FORWARD) for o in ops[:-1]]
    posts = [JSORSmoother(o, omega, 1, BACKWARD) for o in ops[:-1]]
    L = jnp.linalg.cholesky(jnp.asarray(ops[-1].to_dense(), jnp.float32))
    jkernel = JSubtreeKernel(ops, pres, posts, L, omega, cycle, gamma, interpret=True)
    f = np.random.default_rng(8).normal(size=(4,) + ops[0].vshape).astype(np.float32)
    want = jkernel.sample(jax.random.key(0), jnp.asarray(f), noise=False)

    kernel = subtree_kernel_from_numpy(
        level_dicts(ops), [np.asarray(p.B_bar) for p in pres],
        [np.asarray(p.B_bar) for p in posts], np.asarray(L), omega, cycle, gamma,
        device=CPU, dtype=torch.float32)
    got = st.subtree_sample(kernel, torch.as_tensor(f))  # a CPU tensor: the plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(kernel.Linv.numpy(), np.asarray(jkernel.Linv), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def samplers():
    """A 4-level W-cycle on a 32x32 posterior in float64: with the subtree
    call and composed, each with fused and unfused level 0."""
    op = to_port(jax_operator(32, True, variance="small"))
    kw = dict(nlevel=4, smoother="SOR", cycle=2, coarse_scaling=0.9, distill=False)
    return {(sub, fused): MultigridMCSampler(op, subtree=sub, fused=fused, **kw)
            for sub in (False, True) for fused in (False, True)}


def test_plain_version_matches_composed_recursion(samplers):
    """float64: the subtree's plain version on levels 1.. against the composed
    recursion from level 1 under the same normals."""
    sub, composed = samplers[(True, False)], samplers[(False, False)]
    kernel = sub.subtree
    f = tt(np.random.default_rng(2).normal(size=(3,) + kernel.vshape))
    noise = RecordingNoise(4)
    got = kernel.sample(noise, f)
    assert [r.shape for r in noise.record] == kernel.draw_shapes(3)
    replay = ReplayNoise(noise.record)
    want = composed._sample(1, replay, f, torch.zeros_like(f))
    assert replay.exhausted
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    # the same normals as one (C, K) tensor, and the deterministic data path
    xi = torch.cat([tt(r).reshape(3, -1) for r in noise.record], dim=1)
    assert xi.shape == (3, kernel.count_noise())
    torch.testing.assert_close(st.subtree_sample_plain(kernel, f, xi), got, rtol=0, atol=0)
    precond_like = composed._sample(1, ReplayNoise([np.zeros(s) for s in kernel.draw_shapes(3)]),
                                    f, torch.zeros_like(f))
    torch.testing.assert_close(st.subtree_sample(kernel, f), precond_like, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("fused", [False, True], ids=["composed_level0", "fused_level0"])
@pytest.mark.parametrize("chain_shape", [(3,), (2, 2), ()], ids=["chains3", "chains2x2", "one"])
def test_mgmc_steps_with_subtree_equal_steps_without(samplers, fused, chain_shape):
    sub, composed = samplers[(True, fused)], samplers[(False, fused)]
    assert sub.subtree is not None and sub.distilled is None
    rng = np.random.default_rng(6)
    f = tt(rng.normal(size=sub.op.vshape))
    x0 = tt(rng.normal(size=chain_shape + sub.op.vshape))
    noise = RecordingNoise(7)
    got = x0.clone()
    for _ in range(2):
        got = sub.apply(noise, f, got)
    draws = noise.record  # drawn with the chain axes flattened to one
    if not fused:
        # without a kernel on any level the composed recursion keeps the caller's chain axes
        draws = [d.reshape(chain_shape + d.shape[1:]) for d in draws]
    replay = ReplayNoise(draws)
    want = x0.clone()
    for _ in range(2):
        want = composed.apply(replay, f, want)
    assert replay.exhausted
    assert got.shape == x0.shape
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


def test_count_noise_agrees_with_the_distiller(samplers):
    s = samplers[(True, False)]
    spec = _SubtreeSpec(s.hierarchy.operators[1:], s.presamplers[1:], s.postsamplers[1:],
                        s.coarse_sampler, s.cycle, s.coarse_scaling)
    assert s.subtree.count_noise() == spec.count_noise(True)
    # 15^2, 7^2 sub-levels and 3^2 coarsest, m = 4, W-cycle: 4 + 8 sweeps, 4 coarse samples
    assert s.subtree.count_noise() == 4 * (225 + 4) + 8 * (49 + 4) + 4 * 9
    assert s.subtree.count_draws() == 2 * 4 + 2 * 8 + 4


def test_schedule_of_the_flagship():
    """3 sub-levels under a W-cycle: 4, 8 and 16 visits and 8 coarse samples,
    x zeroed at every entry of a level."""
    sched = st.subtree_schedule(3, 2)
    assert len(sched) == 36
    for li, visits in enumerate((4, 8, 16)):
        ops = [op for op, l in sched if l == li]
        assert len(ops) == visits
        assert ops.count(st.OP_ASCEND) == visits // 2
        assert ops.count(st.OP_DESCEND_ZERO) == visits // 4
    assert sum(op == st.OP_COARSE for op, _ in sched) == 8
    assert sched[:4] == [(st.OP_DESCEND_ZERO, 0), (st.OP_DESCEND_ZERO, 1),
                         (st.OP_DESCEND_ZERO, 2), (st.OP_COARSE, 3)]
    assert sched[-1] == (st.OP_ASCEND, 0)
    assert st.subtree_schedule(1, 1) == [(st.OP_DESCEND_ZERO, 0), (st.OP_COARSE, 1),
                                         (st.OP_ASCEND, 0)]


def test_field_placement():
    """The flagship's sub-levels under 227 KB: 63^2, 31^2 and 15^2 in shared
    memory (61,860 bytes), 127^2 in the launch tensors and the workspace."""
    levels, coarse, smem, ws = st.place_fields([127 * 127, 63 * 63, 31 * 31], 225,
                                               232448 - st.STATIC_SMEM_RESERVE)
    assert 4 * smem == 61860 and ws == 127 * 127
    assert [loc[0] for loc in levels[0]] == [st.LOC_LAUNCH, st.LOC_WORKSPACE, st.LOC_LAUNCH]
    assert all(loc[0] == st.LOC_SHARED for lv in levels[1:] for loc in lv)
    assert all(loc[0] == st.LOC_SHARED for loc in coarse)
    # offsets do not overlap
    spans = sorted((off, off + n) for lv, n in zip(levels[1:], (3969, 961)) for _, off in lv)
    spans += [(off, off + 225) for _, off in coarse]
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] == smem
    # no shared memory at all: everything in the workspace
    levels, coarse, smem, ws = st.place_fields([961], 225, 0)
    assert smem == 0 and ws == 961 + 3 * 225
    assert all(loc[0] == st.LOC_WORKSPACE for loc in coarse)
    # room for everything: the finest sub-level is copied into shared memory too
    levels, _, smem, ws = st.place_fields([961], 225, 48 * 1024)
    assert ws == 0 and smem == 3 * (961 + 225)
    assert all(loc[0] == st.LOC_SHARED for loc in levels[0])


def test_kernel_parameter_blocks(samplers):
    """What the launch would hand the kernel, built on the CPU: struct sizes,
    the levels' plans and the placement in the parameter block."""
    import ctypes

    kernel = samplers[(True, False)].subtree
    assert ctypes.sizeof(st.FieldLoc) == 16
    # the reach-2 point lists' offsets (2 int64), heads (2 int), form and band
    assert ctypes.sizeof(st.SubLevel) == 2 * 8 + 3 * 16 + 14 * 4 + 2 * 8 + 4 * 4
    assert ctypes.sizeof(st.SubtreeParams) == 56 + 8 * ctypes.sizeof(st.SubLevel) + 48 + 16 + 16
    S = kernel._build_params(3, 2, False)
    assert (S.C, S.NL, S.n_sched, S.noise_mode, S.nc) == (3, 2, len(kernel.schedule), 2, 9)
    assert S.xi_stride == kernel.count_noise() and S.lv[0].n == 225 and S.lv[1].n == 49
    assert S.lv[0].x.where == st.LOC_SHARED  # 45 KB budget on the CPU: everything fits
    tables, sched, points = kernel._device_tables()
    assert points is None  # reach 1: no point lists
    assert tables.numel() == S.table_words and S.table_words % 4 == 0
    assert sched.numel() == 2 * S.n_sched
    # the parameter blocks come first, one per level and direction, 8-byte aligned
    words = ctypes.sizeof(st.VisitParams) // 4
    assert [list(S.lv[li].plan) for li in range(2)] == [[0, words], [2 * words, 3 * words]]
    assert S.warp_stride == 4 and S.warp_vec + 32 * 4 <= S.table_words
    placement = kernel.placement
    assert placement["threads"] == 256 and placement["workspace_bytes_per_chain"] == 0
    assert [row["vshape"] for row in placement["levels"]] == [[15, 15], [7, 7], [3, 3]]


def test_subtree_wrapper_rejects_bad_arguments(samplers):
    kernel = samplers[(True, False)].subtree
    f = torch.zeros((2,) + kernel.vshape, dtype=torch.float64)
    with pytest.raises(ValueError, match="f must be"):
        st.subtree_sample(kernel, f[0])
    with pytest.raises(ValueError, match="xi must be"):
        st.subtree_sample(kernel, f, xi=torch.zeros((2, 5), dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA kernel only"):
        st.subtree_sample(kernel, f, philox=(1, 0))
    with pytest.raises(ValueError, match="not both"):
        st.subtree_sample(kernel, f, xi=torch.zeros((2, kernel.count_noise())), philox=(1, 0))
    with pytest.raises(ValueError, match="record"):
        st.subtree_sample(kernel, f, record=True)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(smoother="SSOR"), NotImplementedError, "one pre- and one post-sweep"),
    (dict(npresmooth=2), NotImplementedError, "one pre- and one post-sweep"),
    (dict(coarse_solver="SSOR"), NotImplementedError, "dense Cholesky"),
    (dict(nlevel=2), ValueError, "at least 3 levels"),
    (dict(distill=True), ValueError, "excludes"),
], ids=["ssor", "two_presweeps", "ssor_coarse", "two_levels", "with_distill"])
def test_subtree_options_that_must_raise(kwargs, error, match):
    op = to_port(jax_operator(16, True))
    kw = dict(nlevel=3, subtree=True)
    kw.update(kwargs)
    with pytest.raises(error, match=match):
        MultigridMCSampler(op, **kw)


def test_subtree_needs_2d():
    op = shiftedlaplace_fd(Lattice((8, 8, 8)), ConstantCorrelationLengthModel(0.3), device=CPU,
                           dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="2d only"):
        MultigridMCSampler(op, nlevel=3, subtree=True)


def test_philox_streams_hands_out_consecutive_counters():
    noise = GeneratorNoise(9, CPU)
    assert noise.philox_streams(64) == (9, 0)
    assert noise.philox_stream() == (9, 64)
    assert noise.philox_streams(3) == (9, 65) and noise.launches == 68
    with pytest.raises(ValueError, match="at least one"):
        noise.philox_streams(0)
    assert ReplayNoise([]).philox_streams(4) is None


def test_shared_memory_probe_on_the_cpu():
    """On the CPU the probe's copy is its plain version and the limit is what
    needs no opt-in."""
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(common.PROBE_SHAPE)
    out = common.smem_copy(x, 64 * 1024)
    assert out is not x and torch.equal(out, x) and torch.equal(common.smem_copy_plain(x), x)
    with pytest.raises(ValueError, match="shape"):
        common.smem_copy(x.reshape(-1), 8192)
    with pytest.raises(ValueError, match="at least 4096 bytes"):
        common.smem_copy(x, 1024)
    assert common.dynamic_smem_limit(CPU) == common.DEFAULT_SMEM_BYTES == 48 * 1024
    assert common.probe_dynamic_smem(48 * 1024, CPU)
    assert not common.probe_dynamic_smem(48 * 1024 + 4, CPU)
    assert common.launch_counts["smem_probe"] == 0  # no kernel was launched here
    assert set(common.SOURCES) == {"mgmc_visit", "mgmc_visit_stream", "mgmc_visit_split",
                                   "mgmc_visit_smem", "mgmc_visit_smem3d", "sor_sweep", "sor_sweep_passes",
                                   "sor_sweep_smem", "sor_sweep_smem3d",
                                   "sor_sweep_cluster", "mgmc_subtree", "smem_probe"}
    for name in common.SOURCES:
        assert common.source_path(name).exists()
    for header in common.HEADERS:
        assert (common.CSRC_DIR / header).exists()
