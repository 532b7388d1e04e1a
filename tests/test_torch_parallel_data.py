"""The port's chains-data-parallel sampler (``multigridmc_tpu_torch/parallel/data_parallel.py``)
and its per-rank noise.

The cases share one world of four gloo ranks on the CPU, started through the
port's launcher, which writes each rank's chains to an ``.npz``.  A step of
the world must repeat bitwise from the same seed, the ranks' chains must
differ, and each rank's chains must be bitwise the single-device
``MultigridMCSampler`` under that rank's noise (``fold_seed(seed, rank)``),
run here.  The mean / covariance gate of ``tests/test_data_parallel.py`` is
held against the dense ``Q^-1`` of the JAX package's operator.  A checkpoint
of each rank resumes its stream: ``k`` steps, a save and a load, ``k`` more
are bitwise ``2 k`` uninterrupted steps on every rank.
"""

import numpy as np
import pytest
import torch

from multigridmc_tpu_torch.parallel import dryrun
from multigridmc_tpu_torch.parallel.data_parallel import DataParallelMGMCSampler, rank_noise
from multigridmc_tpu_torch.parallel.mesh import (chains_mesh, fold_seed, init_distributed,
                                                 single_mesh)
from multigridmc_tpu_torch.samplers.base import GeneratorNoise, ReplayNoise
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

from test_data_parallel import _posterior_f32
from test_sampler import make_posterior_2d

WORLD = 4
STEP = dict(nlevel=3, seed=0, nchains=16, resume_steps=2,
            sampler=dict(smoother="SOR", cycle=2, fused=True, distill=True))
#: the gate of tests/test_data_parallel.py (8x8 posterior, SSOR W-cycle,
#: distilled): tolerance and warm-up as there, its 1024 x 400 samples taken
#: as 4096 chains x 100 steps (every step gathers the chains over gloo)
MOMENTS = dict(nlevel=3, seed=1342517, nchains=4096, nwarmup=20, nsteps=100, tol=4e-3,
               sampler=dict(smoother="SSOR", cycle=2, fused=True, distill=True))


def _op_arrays(prefix, op):
    lr = op.lowrank
    return dryrun.operator_arrays(prefix, np.asarray(op.coeffs), op.offsets, op.lattice.shape,
                                  np.asarray(lr.B), np.asarray(lr.Sigma_diag))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    step_op = _posterior_f32()
    mom_op = make_posterior_2d(8)
    rng = np.random.default_rng(2)
    arrays = {**_op_arrays("step_op/", step_op), **_op_arrays("moments_op/", mom_op),
              "step_f": rng.normal(size=step_op.vshape),
              "step_x": rng.normal(size=(STEP["nchains"],) + step_op.vshape)}
    n = mom_op.lattice.nvertex
    mean_exact = np.random.default_rng(MOMENTS["seed"]).uniform(size=n)
    Q = mom_op.to_dense()
    arrays["moments_f"] = (Q @ mean_exact).reshape(mom_op.lattice.vshape)
    spec = tmp_path_factory.mktemp("chains") / "spec.npz"
    dryrun.save_spec(spec, {"step": STEP, "moments": MOMENTS}, **arrays)
    res = dryrun.launch("chains", WORLD, device="cpu", spec=spec, timeout=600)
    return {"res": res, "arrays": arrays, "mean": mean_exact, "cov": np.linalg.inv(Q)}


def test_chains_step_repeats_bitwise(world):
    """A step from the same seed and state gives the same chains."""
    res = world["res"]
    for r in range(WORLD):
        np.testing.assert_array_equal(res[f"{r}/step/out"], res[f"{r}/step/again"])
        assert bool(res[f"{r}/step/distilled"])


def test_ranks_draw_different_chains(world):
    """No two ranks share a noise stream: every pair's chains differ."""
    res = world["res"]
    for i in range(WORLD):
        for j in range(i):
            diff = np.abs(res[f"{i}/step/out"] - res[f"{j}/step/out"]).max()
            assert diff > 1e-3, (i, j, diff)


@pytest.mark.parametrize("rank", range(WORLD))
def test_each_rank_is_the_single_device_sampler(world, rank):
    """Rank ``r``'s chains are bitwise the single-device sampler's from its
    block of chains under ``GeneratorNoise(fold_seed(seed, r))`` (one thread,
    as in the rank)."""
    res, arrays = world["res"], world["arrays"]
    op = dryrun._op_from_spec(arrays, "step_op/", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = MultigridMCSampler(op, STEP["nlevel"], device="cpu", **STEP["sampler"])
        x = torch.as_tensor(res[f"{rank}/step/x_in"])
        blocks = np.split(arrays["step_x"], WORLD)
        np.testing.assert_array_equal(x.numpy(), blocks[rank])
        out = single.apply(GeneratorNoise(fold_seed(STEP["seed"], rank), "cpu"),
                           torch.as_tensor(arrays["step_f"]), x.clone())
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(out.numpy(), res[f"{rank}/step/out"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_chains_path_resumes_its_stream_bitwise(world, rank):
    """Each rank's checkpoint (its chains, the shared source and its stream)
    resumes the run: 2 steps, a save and a load into fresh samplers, 2 more
    are bitwise the 4 uninterrupted steps; with the loaded source's stream
    dropped, the rank redraws its first noise and the chains differ."""
    res = world["res"]
    whole = res[f"{rank}/resume/whole"]
    np.testing.assert_array_equal(res[f"{rank}/resume/resumed"], whole)
    assert np.abs(res[f"{rank}/resume/unrepaired"] - whole).max() > 1e-3
    assert list(res[f"{rank}/resume/streams"]) == ["rank"]


def test_chains_path_resume_refuses_another_ranks_stream(tmp_path):
    """A world of one: the checkpoint holds the rank's stream with the shared
    source (one file, loaded as saved), a fresh sampler draws on from the
    loaded stream, and a source that carries another seed's stream is
    refused."""
    from multigridmc_tpu_torch.utils.checkpoint import ChainState

    op = dryrun._op_from_spec(_op_arrays("", make_posterior_2d(8)), "", "cpu")
    dp = DataParallelMGMCSampler(op, 2, chains_mesh("cpu"), fused=False, distill=False)
    noise = GeneratorNoise(9, "cpu")
    f = torch.zeros(op.vshape, dtype=torch.float64)
    x = dp.apply(noise, f, torch.zeros((3,) + op.vshape, dtype=torch.float64))
    ChainState(x, noise, 1).save(tmp_path / "r0.npz")
    state = ChainState.load(tmp_path / "r0.npz", "cpu")
    assert set(state.noise.streams) == {"rank"}
    assert state.noise.streams["rank"].seed == fold_seed(9, 0) and state.noise.seed == 9
    mine = dp.rank_noise(noise)
    torch.testing.assert_close(state.noise.streams["rank"].normal((5,), torch.float64, "cpu"),
                               mine.normal((5,), torch.float64, "cpu"), rtol=0, atol=0)
    fresh = DataParallelMGMCSampler(op, 2, chains_mesh("cpu"), fused=False, distill=False)
    assert fresh.rank_noise(state.noise) is state.noise.streams["rank"]
    other = GeneratorNoise(10, "cpu")
    other.streams["rank"] = state.noise.streams["rank"]
    with pytest.raises(ValueError, match="another rank or seed"):
        fresh.rank_noise(other)


def test_chain_count_the_world_does_not_divide_raises(world):
    for r in range(WORLD):
        assert bool(world["res"][f"{r}/step/odd_chains_raised"])


def test_chains_statistical_gate(world):
    """Mean against ``Q^-1 f`` and covariance against ``Q^-1`` over the four
    ranks' chains (independent streams, distilled subtree on every rank)."""
    res = world["res"]
    em = np.max(np.abs(res["0/moments/mean"] - world["mean"]))
    ec = np.max(np.abs(res["0/moments/cov"] - world["cov"]))
    assert em < MOMENTS["tol"] and ec < MOMENTS["tol"], (em, ec)


def test_fold_seed_streams_do_not_collide():
    """The per-rank seeds of 256 seeds x 64 ranks are all distinct, and a
    seed's rank r is not the next seed's rank r - 1 (as ``seed + rank``
    would make it)."""
    seeds = {fold_seed(s, r) for s in range(256) for r in range(64)}
    assert len(seeds) == 256 * 64
    assert all(fold_seed(s, r) != fold_seed(s + 1, r - 1) for s in range(64)
               for r in range(1, 8))
    assert fold_seed(5, 0) != 5 and fold_seed(5, 1, 2) == fold_seed(fold_seed(5, 1), 2)


def test_data_parallel_sampler_contract():
    """A world of one: the rank's stream is ``fold_seed(seed, 0)``, made once
    per noise source; a lattice mesh, a non-generator noise source and a
    chain state without its chains axis are refused."""
    op = dryrun._op_from_spec(_op_arrays("", make_posterior_2d(8)), "", "cpu")
    dp = DataParallelMGMCSampler(op, 2, chains_mesh("cpu"), fused=False, distill=False)
    noise = GeneratorNoise(9, "cpu")
    mine = dp.rank_noise(noise)
    assert mine is dp.rank_noise(noise) and mine.seed == fold_seed(9, 0)
    assert rank_noise(noise, dp.mesh).seed == mine.seed
    f = torch.zeros(op.vshape, dtype=torch.float64)
    out = dp.apply(noise, f, torch.zeros((3,) + op.vshape, dtype=torch.float64))
    assert out.shape == (3,) + op.vshape and bool(torch.isfinite(out).all())
    with pytest.raises(TypeError):
        dp.apply(ReplayNoise([]), f, torch.zeros((3,) + op.vshape, dtype=torch.float64))
    with pytest.raises(ValueError):
        dp.apply(noise, f, torch.zeros(op.vshape, dtype=torch.float64))
    with pytest.raises(ValueError):
        DataParallelMGMCSampler(op, 2, single_mesh(2, "cpu"))


def test_cuda_default_has_no_fallback():
    """Without a card the parallel entry points raise, on their default CUDA
    device: no process group, and no silent move to gloo or the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-device path cannot be reached")
    with pytest.raises(RuntimeError):
        init_distributed("tcp://127.0.0.1:1", world_size=1, rank=0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError):
        chains_mesh()
    with pytest.raises(RuntimeError):
        dryrun.launch("dryrun", 4)
