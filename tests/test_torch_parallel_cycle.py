"""The port's lattice-decomposed MGMC cycle (``multigridmc_tpu_torch/parallel/cycle.py``)
against the JAX package's ``ShardedMGMCSampler``.

Every case runs in one world of four gloo ranks on the CPU, started through
the port's launcher, which writes the gathered outputs to an ``.npz``; the JAX
side runs here, on the virtual CPU devices of ``tests/conftest.py``, while the
world runs.  Float64 throughout:

1. deterministic mode (noise off) on a 2x2 world against the JAX sampler on a
   2x2 mesh, fd5pt / fem9pt / biharm13pt, V and W (rtol 1e-11, atol 1e-12),
   with the padding exactly zero - and the padded level arrays themselves;
2. ``"global"`` noise: a 2x2 world and a 2 (chains) x 1x2 world against a
   world of one run here (1e-10), and the replicated-finest fallback;
3. ``"sharded"`` noise: the statistical gates against the dense ``Q^-1``,
   with and without the distilled subtree (``tests/test_cycle.py``);
4. a checkpoint of each rank in both noise modes on a 2x2 world: ``k``
   steps, a save and a load, ``k`` more are bitwise ``2 k`` uninterrupted
   steps on every rank.
"""

import concurrent.futures
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from multigridmc_tpu.parallel.cycle import ShardedMGMCSampler as JaxSharded
from multigridmc_tpu.parallel.cycle import pad_field as jax_pad_field
from multigridmc_tpu.solvers.multigrid import MultigridHierarchy as JaxHierarchy

from multigridmc_tpu_torch.parallel import cycle, dryrun
from multigridmc_tpu_torch.parallel.mesh import single_mesh
from multigridmc_tpu_torch.samplers.base import GeneratorNoise

from test_cycle import make_posterior

KINDS = ("fd", "fem", "biharm")
KIND_IDS = ["fd5pt", "fem9pt", "biharm13pt"]
CYCLES = {"V": 1, "W": 2}
GLOBAL_MESHES = {"2x2": (1, [2, 2]), "2x1x2": (2, [1, 2])}
GLOBAL = dict(nlevel=3, smoother="SOR", cycle=2, agglomerate_below=4, noise_mode="global")
GLOBAL_STEPS, GLOBAL_SEED, GLOBAL_CHAINS = 3, 7, 4
REPLICATED = dict(nlevel=2, smoother="SOR", cycle=1, noise_mode="global")
#: the resume cases: noise mode -> the rank streams a checkpoint keeps; the
#: steps before and after the save
RESUME_STREAMS = {"sharded": ["chains", "lattice"], "global": []}
RESUME_STEPS = 2
#: the statistical gates of tests/test_cycle.py: posterior, sampler, mesh,
#: chains, warm-up, steps, tolerance on the mean and the covariance.  The
#: warm-ups and tolerances are the JAX tests'; the samples are at least theirs
#: (512 x 150), taken as more chains and fewer steps because every step of a
#: gloo world waits on some twenty collectives of a few ms each on the CPU, and
#: 4x theirs for the SSOR gate, whose 6e-3 the port's streams met at 512 x 150
#: with 0.0064 once: its error at 16x those samples is 0.0011-0.0019
#: (independent of the seed), so at 4x the limit is about 1.5 of its expected
#: maximum
GATES = {
    "no_distill": dict(nx=8, sampler=dict(nlevel=2, smoother="SSOR", cycle=1,
                                          agglomerate_below=2, noise_mode="sharded"),
                       chains=2, mesh_shape=[1, 2], nchains=4096, nwarmup=25, nsteps=75,
                       seed=99, tol=6e-3),
    "distill": dict(nx=16, sampler=dict(nlevel=3, smoother="SOR", cycle=2,
                                        agglomerate_below=8, noise_mode="sharded",
                                        distill=True),
                    chains=1, mesh_shape=[2, 2], nchains=2048, nwarmup=40, nsteps=40,
                    seed=55, tol=1.2e-2),
}


def _op_arrays(prefix, op):
    lr = op.lowrank
    return dryrun.operator_arrays(prefix, np.asarray(op.coeffs), op.offsets, op.lattice.shape,
                                  np.asarray(lr.B), np.asarray(lr.Sigma_diag))


def _port_op(op):
    """The port's operator on the same arrays (float64, CPU)."""
    spec = _op_arrays("", op)
    return dryrun._op_from_spec(spec, "", "cpu")


def _mesh22():
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("ly", "lx"))


def _gate_problem(gate):
    op = make_posterior(nx=gate["nx"])
    n = op.lattice.nvertex
    rng = np.random.default_rng(1342517)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = (Q @ mean_exact).reshape(op.lattice.vshape)
    return op, f, mean_exact, np.linalg.inv(Q)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's gathered output from one world of four gloo ranks, and
    the JAX deterministic references (computed while the world runs)."""
    ops = {k: make_posterior(nx=16, prior_kind=k) for k in KINDS}
    arrays, cases = {}, []
    rng = np.random.default_rng(3)
    b = rng.normal(size=ops["fd"].vshape)
    arrays["b"] = b
    for k in KINDS:
        arrays.update(_op_arrays(f"{k}/", ops[k]))
        for cname, cyc in CYCLES.items():
            cases.append(dict(name=f"det/{k}/{cname}", kind="deterministic", op=k, b="b",
                              chains=1, mesh_shape=[2, 2],
                              sampler=dict(nlevel=3, smoother="SOR", cycle=cyc,
                                           agglomerate_below=4, deterministic=True)))
    rng = np.random.default_rng(4)
    arrays["f"] = rng.normal(size=ops["fd"].vshape)
    arrays["x"] = rng.normal(size=(GLOBAL_CHAINS,) + ops["fd"].vshape)
    for k in ("fd", "biharm"):
        for mname, (chains, shape) in GLOBAL_MESHES.items():
            cases.append(dict(name=f"global/{k}/{mname}", kind="global", op=k, f="f", x="x",
                              chains=chains, mesh_shape=shape, seed=GLOBAL_SEED,
                              steps=GLOBAL_STEPS, sampler=GLOBAL))
    for mode in RESUME_STREAMS:
        cases.append(dict(name=f"resume/{mode}", kind="resume", op="fd", f="f", x="x",
                          chains=1, mesh_shape=[2, 2], seed=GLOBAL_SEED, steps=RESUME_STEPS,
                          sampler=dict(GLOBAL, noise_mode=mode)))
    cases.append(dict(name="replicated", kind="global", op="fd", f="f", x="x", chains=1,
                      mesh_shape=[2, 2], seed=3, steps=1,
                      sampler=dict(REPLICATED, agglomerate_below=64)))
    gates = {}
    for gname, gate in GATES.items():
        op, f, mean_exact, cov_exact = _gate_problem(gate)
        gates[gname] = (mean_exact, cov_exact)
        arrays.update(_op_arrays(f"gate_{gname}/", op))
        arrays[f"gate_{gname}/f"] = f
        cases.append(dict(name=f"gate/{gname}", kind="moments", op=f"gate_{gname}",
                          f=f"gate_{gname}/f", chains=gate["chains"],
                          mesh_shape=gate["mesh_shape"], nchains=gate["nchains"],
                          nwarmup=gate["nwarmup"], nsteps=gate["nsteps"], seed=gate["seed"],
                          sampler=gate["sampler"]))
    spec = tmp_path_factory.mktemp("cycle") / "spec.npz"
    dryrun.save_spec(spec, {"cases": cases}, **arrays)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(dryrun.launch, "cycle", 4, device="cpu", spec=spec, timeout=900)
        ref, levels = {}, {}
        bp = jax_pad_field(jnp.asarray(b), ops["fd"].vshape)
        for k in KINDS:
            sh = JaxSharded(ops[k], nlevel=3, mesh=_mesh22(), smoother="SOR", cycle=1,
                            agglomerate_below=4, deterministic=True,
                            hierarchy=JaxHierarchy(ops[k], 3))
            levels[k] = sh.levels
            for cname, cyc in CYCLES.items():
                # the levels do not depend on the cycle, only the traced
                # recursion does: one build serves V and W
                s = copy.copy(sh)
                s.cycle = cyc
                s._apply = s._make_apply()
                ref[f"det/{k}/{cname}"] = np.asarray(
                    s.apply(jax.random.PRNGKey(0), bp, jnp.zeros_like(bp)))
        res = running.result()
    return {"res": res, "ref": ref, "ops": ops, "levels": levels, "gates": gates,
            "arrays": arrays}


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("cname", list(CYCLES))
def test_deterministic_cycle_matches_jax(world, kind, cname):
    """The 2x2 world's deterministic cycle equals the JAX sampler's on a 2x2
    mesh - the padded layout, width-1 / width-2 halos, the all-reduced
    Woodbury correction, restriction, agglomeration, prolongation and the
    replicated coarse Cholesky - and keeps the padding exactly zero."""
    got = world["res"][f"0/det/{kind}/{cname}/out"]
    want = world["ref"][f"det/{kind}/{cname}"]
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)
    vshape = world["ops"][kind].vshape
    pad = np.ones(got.shape, dtype=bool)
    pad[tuple(slice(0, m) for m in vshape)] = False
    assert np.abs(got[pad]).max() == 0.0
    assert list(world["res"][f"0/det/{kind}/{cname}/sharded"]) == [True, True, False]


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_padded_level_arrays_match_jax(world, kind):
    """Padded coefficients, colour masks (as ``omega mask / diag``), noise
    scales, both directions' Woodbury factors and the coarse Cholesky factor
    equal the JAX sampler's (float64, 1e-12)."""
    op = _port_op(world["ops"][kind])
    mine = cycle.ShardedMGMCSampler(op, 3, single_mesh(2, "cpu"), agglomerate_below=4,
                                    deterministic=True)
    for lv, jlv in zip(mine.levels, world["levels"][kind]):
        assert lv.pn == jlv.pn and lv.n_colors == jlv.n_colors and lv.pad == jlv.pad
        want = {name: np.asarray(a) for name, a in jlv.arrays.items()}
        want["wmask"] = mine.omega * want["masks"] / want["diag"]
        for name in ("coeffs", "wmask", "noise_scale", "B", "B_bar_fwd", "B_bar_bwd",
                     "chol_L"):
            if name in want:
                np.testing.assert_allclose(lv.arrays[name].numpy(), want[name], rtol=1e-12,
                                           atol=1e-12, err_msg=name)


def _world_of_one(op_jax, sampler_kwargs, arrays, seed, steps):
    op = _port_op(op_jax)
    s = cycle.ShardedMGMCSampler(op, mesh=single_mesh(2, "cpu"), **sampler_kwargs)
    f = cycle.pad_field(torch.as_tensor(arrays["f"]), op.vshape)
    x = cycle.pad_field(torch.as_tensor(arrays["x"]), op.vshape)
    noise = GeneratorNoise(seed, "cpu")
    for _ in range(steps):
        x = s.apply(noise, f, x)
    return x.numpy()


@pytest.mark.parametrize("mname", list(GLOBAL_MESHES))
@pytest.mark.parametrize("kind", ["fd", "biharm"], ids=["fd5pt", "biharm13pt"])
def test_global_noise_world_shapes_agree(world, kind, mname):
    """Under ``"global"`` noise a 2x2 world and a 2 (chains) x 1x2 world run
    the trajectory of a world of one (three W-cycle steps; the biharmonic
    case through width-2 halos)."""
    want = _world_of_one(world["ops"][kind], GLOBAL, world["arrays"], GLOBAL_SEED,
                         GLOBAL_STEPS)
    got = world["res"][f"0/global/{kind}/{mname}/out"]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-11)


def test_replicated_finest_fallback(world):
    """A mesh that leaves the finest level unshardable runs fully replicated
    over the lattice, with a warning, and still runs the world of one's
    trajectory."""
    res = world["res"]
    assert bool(res["0/replicated/warned_replicated"])
    assert not res["0/replicated/sharded"].any()
    want = _world_of_one(world["ops"]["fd"], dict(REPLICATED, agglomerate_below=4),
                         world["arrays"], 3, 1)
    np.testing.assert_allclose(res["0/replicated/out"], want, rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("gname", list(GATES))
def test_sharded_sampler_statistics(world, gname):
    """``"sharded"`` noise (a stream per rank, the replicated levels' streams
    by chains index): chain mean against ``Q^-1 f`` and sample covariance
    against ``Q^-1``; the replicated coarse fields equal on every lattice
    shard; with ``distill=True`` the replicated subtree is the distilled map,
    the same on every rank."""
    res, gate = world["res"], GATES[gname]
    mean_exact, cov_exact = world["gates"][gname]
    em = np.max(np.abs(res[f"0/gate/{gname}/mean"] - mean_exact))
    ec = np.max(np.abs(res[f"0/gate/{gname}/cov"] - cov_exact))
    assert em < gate["tol"] and ec < gate["tol"], (em, ec)
    for r in range(4):
        assert float(res[f"{r}/gate/{gname}/replicated_spread"]) == 0.0
    if gname == "distill":
        assert list(res[f"0/gate/{gname}/sharded"]) == [True, False, False]
        assert int(res[f"0/gate/{gname}/distill_level"]) == 1
        assert float(res[f"0/gate/{gname}/distill_spread"]) == 0.0
    else:
        assert int(res[f"0/gate/{gname}/distill_level"]) == -1


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("mode", list(RESUME_STREAMS))
def test_resumed_cycle_is_the_uninterrupted_cycle(world, mode, rank):
    """A checkpoint of each rank of a 2x2 world - its blocks, the shared
    source and, in ``"sharded"`` mode, its lattice and chains streams -
    resumes the run: 2 W-cycle steps, a save and a load into fresh samplers,
    2 more are bitwise the 4 uninterrupted steps.  In ``"sharded"`` mode the
    loaded source with its streams dropped redraws the first noise, and the
    blocks differ; in ``"global"`` mode the shared source alone resumes it."""
    res = world["res"]
    key = f"{rank}/resume/{mode}"
    whole = res[f"{key}/whole"]
    np.testing.assert_array_equal(res[f"{key}/resumed"], whole)
    assert list(res[f"{key}/streams"]) == RESUME_STREAMS[mode]
    if mode == "sharded":
        assert np.abs(res[f"{key}/unrepaired"] - whole).max() > 1e-3
    else:
        np.testing.assert_array_equal(res[f"{key}/unrepaired"], whole)


def test_sharded_resume_refuses_other_streams(tmp_path):
    """The ``"sharded"`` streams live on the shared source: a checkpoint of it
    saves them and a fresh sampler draws on from the loaded ones; a source
    that carries another rank's or seed's stream is refused; ``"global"`` noise
    and the deterministic cycle keep none."""
    from multigridmc_tpu_torch.utils.checkpoint import ChainState

    op = _port_op(make_posterior(nx=8))
    kw = dict(nlevel=2, agglomerate_below=2)
    s = cycle.ShardedMGMCSampler(op, mesh=single_mesh(2, "cpu"), **kw)
    noise = GeneratorNoise(5, "cpu")
    streams = s._rank_streams(noise)
    assert set(streams) == {"lattice", "chains"} and noise.streams == streams
    streams["lattice"].normal((3,), torch.float64, "cpu")
    ChainState(torch.zeros(2), noise, 1).save(tmp_path / "r0.npz")
    state = ChainState.load(tmp_path / "r0.npz", "cpu")
    assert set(state.noise.streams) == {"lattice", "chains"}
    fresh = cycle.ShardedMGMCSampler(op, mesh=single_mesh(2, "cpu"), **kw)
    assert fresh._rank_streams(state.noise)["lattice"] is state.noise.streams["lattice"]
    torch.testing.assert_close(state.noise.streams["lattice"].normal((5,), torch.float64, "cpu"),
                               streams["lattice"].normal((5,), torch.float64, "cpu"),
                               rtol=0, atol=0)
    other = GeneratorNoise(6, "cpu")
    other.streams["lattice"] = streams["lattice"]
    with pytest.raises(ValueError, match="another rank or seed"):
        fresh._rank_streams(other)
    glob = cycle.ShardedMGMCSampler(op, mesh=single_mesh(2, "cpu"), noise_mode="global", **kw)
    plain = GeneratorNoise(5, "cpu")
    assert glob._rank_streams(plain) == {"global": plain} and plain.streams == {}
    det = cycle.ShardedMGMCSampler(op, mesh=single_mesh(2, "cpu"), deterministic=True, **kw)
    assert det._rank_streams(None) == {}


def test_distillation_only_in_sharded_mode():
    """The distilled map replaces the replicated subtree in ``"sharded"``
    mode only: ``"global"`` mode (mesh-shape equivalence) and the
    deterministic cycle keep the composed levels; ``distill="auto"`` is off
    on the CPU."""
    op = _port_op(make_posterior(nx=16))
    kw = dict(nlevel=3, smoother="SOR", cycle=2, agglomerate_below=16)
    s = cycle.ShardedMGMCSampler(op, mesh=single_mesh(2, "cpu"), distill=True, **kw)
    assert [lv.sharded for lv in s.levels] == [True, False, False]
    assert s.distill_level == 1 and s.distilled is not None and s.distill_spread == 0.0
    for extra in (dict(noise_mode="global", distill=True),
                  dict(deterministic=True, distill=True), dict(distill="auto")):
        s2 = cycle.ShardedMGMCSampler(op, mesh=single_mesh(2, "cpu"), **kw, **extra)
        assert s2.distilled is None, extra


def test_sharded_streams_per_rank():
    """``"sharded"`` mode derives a lattice stream and a chains stream from
    the seed once per noise source and keeps them running from call to call;
    a noise source of another kind is refused."""
    op = _port_op(make_posterior(nx=8))
    s = cycle.ShardedMGMCSampler(op, 2, single_mesh(2, "cpu"), agglomerate_below=2)
    noise = GeneratorNoise(5, "cpu")
    streams = s._rank_streams(noise)
    assert s._rank_streams(noise) is streams
    assert streams["lattice"].seed != streams["chains"].seed != noise.seed
    f = cycle.pad_field(torch.zeros(op.vshape, dtype=torch.float64), op.vshape)
    x0 = torch.zeros((2,) + f.shape, dtype=torch.float64)
    a = s.apply(noise, f, x0)
    b = s.apply(noise, f, x0)
    assert not torch.equal(a, b)  # the streams ran on
    c = s.apply(GeneratorNoise(5, "cpu"), f, x0)
    assert torch.equal(a, c)
    with pytest.raises(TypeError):
        s.apply(None, f, x0)
