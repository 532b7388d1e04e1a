"""The phase visit kernels' tables, block size and passes, on the CPU.

The phase route of the two level-visit kernels (``csrc/mgmc_visit.cu``) runs
the passes of ``csrc/level_passes.cuh``, which the subtree kernel runs too.  A
launch reads one level's tables for its sweep directions
(``mgmc_visit.phase_tables``: ``B`` and each direction's ``Y`` inside their
boxes, the boxes and the columns they span per row, each direction's ``W``
and colour rows, ``Sigma^1/2``) from each block's shared memory where they
fit, else from device memory.  Here, on the flagship's levels 0 (255^2,
5-point, red-black) and 1 (127^2, 9-point, 4 colours) and on a 64x64 case:

* the tables, decoded from the words the kernels receive, against the level,
  and equal to what the subtree kernel stages for the same level;
* the colour rows: each colour's points once;
* a numpy replay of the stencil in registers (``Stencil``, ``load_operands``,
  ``apply_operands``: offsets as address offsets, edge terms dropped by the
  up / down / left / right bits) bitwise equal to ``stencil_at``'s offset
  order, on the 5-point cross, the 3x3 box and a user-given 9-offset stencil
  with per-point planes;
* a float64 replay of a whole descend and ascend from the one-pass passes,
  reading the tables' geometry, against the plain versions (which
  ``tests/test_torch_mgmc_visit.py`` holds against the JAX package);
* the block size by chain count, the placement of a dense-``B`` level's
  tables in device memory, and the barriers of a visit counted from the
  source.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigridmc_tpu_torch.lattice import Lattice
from multigridmc_tpu_torch.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu_torch.models.prior import shiftedlaplace_fd
from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_subtree as st
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv
from multigridmc_tpu_torch.ops.stencil import LowRank
from multigridmc_tpu_torch.samplers.mgmc import MultigridMCSampler

from test_torch_common import CPU, jax_operator, to_port
from test_torch_subtree_tables import posterior

#: what an H100 grants a block
H100_BLOCK_LIMIT = 232448


def fused_levels(op, nlevel):
    return MultigridMCSampler(op, nlevel, cycle=2, fused=True, fused_min_vertices=0,
                              distill=False).fused_levels


def flagship(dtype=torch.float32, near_exact=True):
    """The flagship (``bench.py::build_problem``: 256x256, Lambda = 0.2, 8
    measurements, seed 20260816) cut to its levels 0 and 1."""
    op = posterior(256, 8, 20260816, near_exact).to(CPU, dtype)
    return fused_levels(op, 3)


def small(dtype=torch.float32):
    """A 64x64 posterior (4 measurements) from the JAX package's operator."""
    return fused_levels(to_port(jax_operator(64, True), dtype=dtype), 3)


CASES = {"flagship L0": lambda: flagship()[0], "flagship L1": lambda: flagship()[1],
         "64x64 L0": lambda: small()[0]}


@pytest.fixture(scope="module", params=list(CASES))
def level(request):
    return CASES[request.param]()


def decode(level, orders, d=0):
    """The tables of one phase launch with the sweep ``orders`` (one order is
    wrapped) as the kernel reads them for direction ``d``."""
    orders = mv._as_orders(orders)
    words, T = mv.phase_tables(level, orders)
    floats = words.view(np.float32)
    m, H = level.op.m_lowrank, level.op.vshape[0]
    K = level.coloring.n_colors
    order = orders[d]
    boff = words[T.boff:T.boff + m + 1]
    yoff = words[T.yoff[d]:T.yoff[d] + m + 1]
    return {"words": words, "T": T,
            "bval": floats[T.bval:T.bval + boff[-1]], "boff": boff,
            "yval": floats[T.yval[d]:T.yval[d] + yoff[-1]], "yoff": yoff,
            "wm": floats[T.wm[d]:T.wm[d] + m * m].reshape(m, m),
            "sroot": floats[T.sroot:T.sroot + m],
            "bbox": [tuple(b) for b in words[T.bbox:T.bbox + 4 * m].reshape(m, 4)],
            "ybox": [tuple(b) for b in words[T.ybox[d]:T.ybox[d] + 4 * m].reshape(m, 4)],
            "bspan": words[T.bspan:T.bspan + 2 * H].reshape(H, 2),
            "yspan": words[T.yspan[d]:T.yspan[d] + 2 * H].reshape(H, 2),
            "rows": words[T.rows[d]:T.rows[d] + len(order) * (1 + 2 * K)].reshape(len(order), -1)}


def spans_brute_force(boxes, H):
    out = np.tile(np.array([1 << 30, 0]), (H, 1))
    for i in range(H):
        holding = [(j0, j1) for i0, i1, j0, j1 in boxes if i0 <= i < i1]
        if holding:
            out[i] = (min(j0 for j0, _ in holding), max(j1 for _, j1 in holding))
    return out


DIRECTIONS = [("descend", True), ("ascend", False)]


@pytest.mark.parametrize("kind,descend", DIRECTIONS)
def test_phase_tables_against_the_level(level, kind, descend):
    order = level.pre_order if descend else level.post_order
    tab = decode(level, order)
    assert tab["words"].dtype == np.int32 and tab["words"].size % 4 == 0
    assert tab["T"].words == tab["words"].size and tab["T"].shared == 0 and tab["T"].ndir == 1
    m, H = level.op.m_lowrank, level.op.vshape[0]
    assert m in (4, 8)
    Y, W, ybox = level._woodbury[order]
    assert tab["bbox"] == list(level.bbox) and tab["ybox"] == list(ybox)
    assert np.array_equal(tab["bspan"], spans_brute_force(level.bbox, H))
    assert np.array_equal(tab["yspan"], spans_brute_force(ybox, H))
    for k, (i0, i1, j0, j1) in enumerate(level.bbox):
        staged = tab["bval"][tab["boff"][k]:tab["boff"][k + 1]]
        assert np.array_equal(staged, level.B[k, i0:i1, j0:j1].numpy().reshape(-1))
    for k, (i0, i1, j0, j1) in enumerate(ybox):
        staged = tab["yval"][tab["yoff"][k]:tab["yoff"][k + 1]]
        assert np.array_equal(staged, Y[k, i0:i1, j0:j1].numpy().reshape(-1))
        outside = Y[k].clone()
        outside[i0:i1, j0:j1] = 0
        assert not outside.any()
    assert np.array_equal(tab["wm"], W.numpy())
    # Sigma^1/2 for both kinds: the descend's residual term needs no other table
    assert np.array_equal(tab["sroot"], level.sigma_sqrt.numpy())
    # the other direction's factor is another table: neither stands in for the other
    other = decode(level, level.post_order if descend else level.pre_order)
    assert not np.array_equal(tab["yval"], other["yval"])
    # a two-sweep launch holds both directions' tables, each as its own launch has it
    both = (order, other_order := level.post_order if descend else level.pre_order)
    for d, alone in enumerate((tab, other)):
        two = decode(level, both, d)
        assert two["T"].ndir == 2
        for name in ("bval", "boff", "yval", "yoff", "wm", "sroot", "bbox", "ybox", "bspan",
                     "yspan", "rows"):
            assert np.array_equal(np.asarray(two[name]), np.asarray(alone[name])), (d, name)
    assert other_order != order


def subtree_decode(kernel, li, d):
    """The subtree kernel's staged tables of sub-level ``li``, direction ``d``."""
    words, off, lv = kernel._tables, kernel._table_offsets[li], kernel.levels[li]
    floats = words.view(np.float32)
    m, K = lv.op.m_lowrank, lv.coloring.n_colors
    order = (lv.pre_order, lv.post_order)[d]
    boff = words[off["boff"]:off["boff"] + m + 1]
    yoff = words[off["yoff"][d]:off["yoff"][d] + m + 1]
    return {"bval": floats[off["bval"]:off["bval"] + boff[-1]], "boff": boff,
            "yval": floats[off["yval"][d]:off["yval"][d] + yoff[-1]], "yoff": yoff,
            "wm": floats[off["wm"][d]:off["wm"][d] + m * m].reshape(m, m),
            "sroot": floats[off["sroot"]:off["sroot"] + m],
            "rows": words[off["rows"][d]:off["rows"][d] + len(order) * (1 + 2 * K)].reshape(
                len(order), -1)}


@pytest.mark.parametrize("case", ["flagship", "64x64"])
def test_phase_tables_equal_the_subtree_tables(case):
    """One staging for both kernels: a sub-level's phase tables hold what the
    subtree kernel stages for it, word for word, in both directions."""
    op = (posterior(256, 8, 20260816) if case == "flagship"
          else to_port(jax_operator(64, True), dtype=torch.float32))
    kernel = MultigridMCSampler(op, 4 if case == "flagship" else 3, cycle=2,
                                subtree=True).subtree
    for li, lv in enumerate(kernel.levels):
        for d, order in enumerate((lv.pre_order, lv.post_order)):
            got, want = decode(lv, order), subtree_decode(kernel, li, d)
            for name in ("bval", "boff", "yval", "yoff", "wm", "rows", "sroot"):
                assert np.array_equal(got[name], want[name]), (li, d, name)


@pytest.mark.parametrize("kind,descend", DIRECTIONS)
def test_colour_rows_cover_each_colour_once(level, kind, descend):
    order = level.pre_order if descend else level.post_order
    rows = decode(level, order)["rows"]
    H, W = level.op.vshape
    K = level.coloring.n_colors
    s = level._build_params(1, order, True, 0).jstride
    masks = level.masks.numpy()
    for o, colour in enumerate(order):
        R = rows[o, 0]
        got = np.zeros((H, W), int)
        for r in range(R * (H // K + 1)):  # the kernel's r = warp, warp + nwarps, ...
            i = (r // R) * K + rows[o, 1 + 2 * (r % R)]
            if i >= H:
                break
            got[i, rows[o, 2 + 2 * (r % R)]::s] += 1
        assert np.array_equal(got, masks[colour].astype(int)), (o, colour)
        # red-black: every row holds each colour; 4 colours: every other row
        assert R == (K if K == 2 else K // 2)


# ------------------------------------------------ the stencil in registers
def stencil_at_replay(offsets, coef, x):
    """``stencil_at`` of ``visit_phases.cuh`` in float32: per offset in order,
    the neighbour inside the field read and added, any other skipped."""
    H, W = x.shape
    ax = np.zeros((H, W), np.float32)
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for k, (dy, dx) in enumerate(offsets):
        inside = (ii + dy >= 0) & (ii + dy < H) & (jj + dx >= 0) & (jj + dx < W)
        nb = x[np.clip(ii + dy, 0, H - 1), np.clip(jj + dx, 0, W - 1)]
        ax = np.where(inside, (ax + coef[k] * nb).astype(np.float32), ax)
    return ax


def register_stencil_replay(offsets, coef, const, x):
    """``Stencil`` / ``load_operands`` / ``apply_operands`` of
    ``level_passes.cuh`` in float32: each offset as an address offset on the
    flat field, the terms a point adds from the bits (all, up, dn, lf, rt),
    neighbours and per-point planes loaded where the term is added, then the
    terms in offset order."""
    H, W = x.shape
    K = len(offsets)
    flat = x.reshape(-1)
    off = [dy * W + dx for dy, dx in offsets]
    bits = {name: sum(1 << k for k, (dy, dx) in enumerate(offsets) if test(dy, dx))
            for name, test in (("up", lambda dy, dx: dy < 0), ("dn", lambda dy, dx: dy > 0),
                               ("lf", lambda dy, dx: dx < 0), ("rt", lambda dy, dx: dx > 0))}
    all_ = (1 << K) - 1
    ax = np.zeros(H * W, np.float32)
    for p in range(H * W):
        i, j = divmod(p, W)
        row = all_ & ~(bits["up"] if i == 0 else 0) & ~(bits["dn"] if i == H - 1 else 0)
        terms = row & ~(bits["lf"] if j == 0 else 0) & ~(bits["rt"] if j == W - 1 else 0)
        v = [flat[p + off[k]] if (terms >> k) & 1 else np.float32(0) for k in range(K)]
        a = [coef[k][i, j] if not const[k] and (terms >> k) & 1 else coef[k][0, 0]
             for k in range(K)]
        acc = np.float32(0)
        for k in range(K):
            if (terms >> k) & 1:
                acc = np.float32(acc + np.float32(a[k] * v[k]))
        ax[p] = acc
    return ax.reshape(H, W)


STENCILS = {
    "5-point cross": ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
    "3x3 box": tuple((k // 3 - 1, k % 3 - 1) for k in range(9)),
    "user 9-offset": ((0, 0), (1, 1), (-1, 0), (0, -1), (1, -1), (-1, 1), (0, 1), (1, 0),
                      (-1, -1)),
}


@pytest.mark.parametrize("name", list(STENCILS))
def test_register_stencil_is_stencil_at_bitwise(name):
    offsets = STENCILS[name]
    rng = np.random.default_rng(12)
    H, W = 13, 11
    x = rng.normal(size=(H, W)).astype(np.float32)
    # the user-given stencil reads every other coefficient per point
    const = [not (name.startswith("user") and k % 2) for k in range(len(offsets))]
    coef = [np.full((H, W), np.float32(rng.normal())) if c
            else rng.normal(size=(H, W)).astype(np.float32) for c in const]
    got = register_stencil_replay(offsets, coef, const, x)
    want = stencil_at_replay(offsets, coef, x)
    assert np.array_equal(got, want)
    assert np.isfinite(got).all() and np.abs(got).max() > 0


# ------------------------------------------ a whole visit from the passes
def columns(boxes, fields, coef, sign, dst):
    """The owner of each point adds the columns whose box holds it, in column
    order (``add_columns``); one column after the other gives each point the
    same order."""
    out = dst.copy()
    for k, (i0, i1, j0, j1) in enumerate(boxes):
        out[i0:i1, j0:j1] += sign * coef[k] * fields[k, i0:i1, j0:j1]
    return out


def replay_stencil(level, x):
    """The stencil in registers in float64, terms in offset order."""
    H, W = x.shape
    coeffs = level.coeffs.numpy()
    ax = np.zeros_like(x)
    for k, (dy, dx) in enumerate(level.op.offsets):
        i0, i1, j0, j1 = max(0, -dy), H - max(0, dy), max(0, -dx), W - max(0, dx)
        ax[i0:i1, j0:j1] += coeffs[k, i0:i1, j0:j1] * x[i0 + dy:i1 + dy, j0 + dx:j1 + dx]
    return ax


def replay_sweep(level, tab, order, c, x):
    """``sweep_colours``: per colour the points of its rows, each from the
    field as the colour found it."""
    H, W = x.shape
    K = level.coloring.n_colors
    s = level._build_params(1, order, True, 0).jstride
    d = level.op.diag_index
    diag = level.coeffs.numpy()[d]
    x = x.copy()
    for o in range(len(order)):
        R = tab["rows"][o, 0]
        mask = np.zeros((H, W), bool)
        for t in range(R):
            mask[tab["rows"][o, 1 + 2 * t]::K, tab["rows"][o, 2 + 2 * t]::s] = True
        new = x + level.omega * (c - replay_stencil(level, x)) / diag
        x = np.where(mask, new, x)
    return x


def replay_woodbury(level, tab, Y, W, x, n):
    """``btx_pass`` and ``woodbury_pass``: B^T x per column over its box, u =
    W (B^T x - Sigma^1/2 n) with the sweep's low-rank normals n, x -= u_l Y_l
    over Y's boxes; returns (t = u + Sigma^-1/2 n, x)."""
    B = level.B.numpy()
    btx = np.array([(B[k, i0:i1, j0:j1] * x[i0:i1, j0:j1]).sum()
                    for k, (i0, i1, j0, j1) in enumerate(tab["bbox"])])
    sroot = level.sigma_sqrt.numpy()
    u = W.numpy() @ (btx - sroot * n)
    return u + n / sroot, columns(tab["ybox"], Y.numpy(), u, -1.0, x)


def replay_descend(level, f, x, xi, xi_lr):
    tab = decode(level, level.pre_order)
    Y, W, _ = level._woodbury[level.pre_order]
    B = level.B.numpy()
    c = f + level.noise_scale.numpy() * xi
    x = replay_sweep(level, tab, level.pre_order, c, x)
    t, x = replay_woodbury(level, tab, Y, W, x, xi_lr)
    r = columns(tab["bbox"], B, t, -1.0, f - replay_stencil(level, x))
    H, Wd = r.shape
    pad = np.zeros((H + 1, Wd + 1))
    pad[:H, :Wd] = r
    w = (0.5, 1.0, 0.5)
    fc = sum(w[a] * w[b] * pad[a:a + H - 1:2, b:b + Wd - 1:2][:H // 2, :Wd // 2]
             for a in range(3) for b in range(3))
    return x, fc


def replay_ascend(level, f, x, xc, xi, xi_lr):
    tab = decode(level, level.post_order)
    Y, W, _ = level._woodbury[level.post_order]
    H, Wd = x.shape
    # x += gamma P x_c: the coarse point I sits at fine 2I+1; the weights
    # {0.5, 1, 0.5} in each direction around it
    up = np.zeros((H + 2, Wd + 2))
    up[2:H:2, 2:Wd:2] = xc
    w = (0.5, 1.0, 0.5)
    px = sum(w[a] * w[b] * up[a:a + H, b:b + Wd] for a in range(3) for b in range(3))
    x = x + level.coarse_scaling * px
    c = f + level.noise_scale.numpy() * xi
    x = replay_sweep(level, tab, level.post_order, c, x)
    return replay_woodbury(level, tab, Y, W, x, xi_lr)[1]


F64_CASES = {"flagship L0": lambda: flagship(torch.float64, near_exact=False)[0],
             "flagship L1": lambda: flagship(torch.float64, near_exact=False)[1],
             "64x64 L0": lambda: small(torch.float64)[0]}


@pytest.mark.parametrize("case", list(F64_CASES))
def test_float64_replay_of_the_passes_is_the_plain_visit(case):
    """A descend and an ascend built from the passes (one-pass low-rank
    terms over the tables' boxes, the low-rank normals in the Woodbury
    correction, ``t = u + Sigma^-1/2 n``, the colour rows) agree with
    ``descend_visit_plain`` / ``ascend_visit_plain`` in float64 on one chain
    (order-one measurement variances)."""
    level = F64_CASES[case]()
    H, W = level.op.vshape
    rng = np.random.default_rng(21)
    f, x, xi = rng.normal(size=(3, H, W))
    xc = rng.normal(size=level.vc)
    xi_lr = rng.normal(size=level.op.m_lowrank)
    got_x, got_fc = replay_descend(level, f, x, xi, xi_lr)
    want_x, want_fc = mv.descend_visit_plain(
        level, torch.as_tensor(f), torch.as_tensor(x)[None], torch.as_tensor(xi)[None],
        torch.as_tensor(xi_lr)[None])
    np.testing.assert_allclose(got_x, want_x[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_fc, want_fc[0].numpy(), rtol=0, atol=1e-12)
    got = replay_ascend(level, f, x, xc, xi, xi_lr)
    want = mv.ascend_visit_plain(level, torch.as_tensor(f), torch.as_tensor(x)[None],
                                 torch.as_tensor(xc)[None], torch.as_tensor(xi)[None],
                                 torch.as_tensor(xi_lr)[None])
    np.testing.assert_allclose(got, want[0].numpy(), rtol=0, atol=1e-12)
    assert np.abs(got - x).max() > 1e-3


# --------------------------------------------- block size, placement, barriers
@pytest.mark.parametrize("n,alone", [(255 * 255, 1024), (127 * 127, 1024), (63 * 63, 512),
                                     (31 * 31, 256)])
def test_block_size_by_chain_count(n, alone):
    """1024 threads (from 16,000 points) while the chains fit one wave of one
    block per SM, two blocks of 512 per SM above that: at 264 chains and
    512 threads every chain still runs in the first wave."""
    sms = common.H100_SMS
    for C in (1, 64, 128, sms):
        assert mv.phase_threads(C, n, sms) == alone == common.default_threads(n)
    for C in (sms + 1, 200, 256, 264, 512):
        assert mv.phase_threads(C, n, sms) == min(alone, mv.PHASE_WAVE_THREADS)
    threads = mv.phase_threads(2 * sms, n, sms)
    assert (1024 // threads) * sms >= 2 * sms
    # the levels ask the rule with the card's SM count (an H100's on the CPU)
    lv = flagship()[0]
    assert lv.phase_threads(128) == 1024 and lv.phase_threads(200) == 512
    assert common.sm_count("cpu") == sms


def dense_b_level(nx, m):
    prior = shiftedlaplace_fd(Lattice((nx, nx)), ConstantCorrelationLengthModel(0.2),
                              device=CPU, dtype=torch.float32)
    rng = np.random.default_rng(9)
    B = torch.as_tensor(1e-3 * rng.normal(size=(m,) + prior.vshape), dtype=torch.float32)
    op = dataclasses.replace(prior, lowrank=LowRank(B=B, Sigma_diag=torch.ones(m)))
    return fused_levels(op, 3)[0]


def test_dense_b_tables_lie_in_device_memory():
    """A level whose 8 measurement columns are dense has tables of whole
    fields, more than a block's shared memory: every pass reads them from the
    device tensor.  The flagship's levels keep theirs in shared memory."""
    dense = dense_b_level(128, 8)
    assert all(box == (0, 127, 0, 127) for box in dense.bbox)
    for threads in (512, 1024):
        for order in (dense.pre_order, dense.post_order):
            words, _ = mv.phase_tables(dense, (order,))
            assert 4 * words.size > H100_BLOCK_LIMIT
            assert not mv.phase_tables_fit(4 * words.size, threads, H100_BLOCK_LIMIT)
            _, T, smem = dense.phase_launch((order,), threads)
            assert T.shared == 0 and smem == 0
        for lv in flagship().values():
            for order in (lv.pre_order, lv.post_order):
                words, _ = mv.phase_tables(lv, (order,))
                assert mv.phase_tables_fit(4 * words.size, threads, H100_BLOCK_LIMIT)
                _, T, smem = lv.phase_launch((order,), threads)
                assert T.shared == 1 and smem == 4 * words.size
    # two blocks of 512 per SM leave each about half an SM's shared memory,
    # less the kernels' static share
    half = 233472 // 2 - 1024 - mv.PHASE_STATIC_SMEM
    assert mv.phase_tables_fit(half, 512, H100_BLOCK_LIMIT)
    assert not mv.phase_tables_fit(half + 4, 512, H100_BLOCK_LIMIT)
    assert mv.phase_tables_fit(H100_BLOCK_LIMIT - mv.PHASE_STATIC_SMEM, 1024, H100_BLOCK_LIMIT)
    assert not mv.phase_tables_fit(H100_BLOCK_LIMIT - mv.PHASE_STATIC_SMEM + 4, 1024,
                                   H100_BLOCK_LIMIT)


SOURCE = Path(mv.__file__).resolve().parents[2] / "csrc" / "level_passes.cuh"


def function_body(src, name):
    """The text of the device function ``name`` up to the next definition."""
    start = re.search(r"\b" + name + r"\(", src).start()
    end = re.search(r"\n(template <|__device__|// -{10})", src[start:])
    return src[start:start + end.start()] if end else src[start:]


def test_barriers_of_a_visit_from_the_source():
    """The barriers the phase kernels pass, from ``level_passes.cuh``: one at
    the end of each pass (the first also publishes the table copy), one per
    colour in the sweep; so a descend has ``n_order + 5``, an ascend
    ``n_order + 3``, each 2 fewer without a low-rank term.  The stamps build
    counts them on the card and ``chip_smoke.py`` holds the two equal."""
    src = SOURCE.read_text()
    sync = "block_sync<COUNT>();"
    per_pass = {name: function_body(src, name).count(sync)
                for name in ("sweep_colours", "btx_pass", "woodbury_pass", "residual_pass",
                             "restrict_pass", "level_descend", "level_ascend")}
    assert per_pass == {"sweep_colours": 1, "btx_pass": 1, "woodbury_pass": 1,
                        "residual_pass": 1, "restrict_pass": 1, "level_descend": 1,
                        "level_ascend": 1}
    # the sweep's barrier is inside its loop over the colours
    sweep = function_body(src, "sweep_colours")
    assert sweep.index("for (int o = 0; o < P.n_order; ++o)") < sweep.index(sync)
    for lv in flagship().values():
        n = len(lv.pre_order)
        assert mv.phase_barrier_count(lv, "descend") == 1 + n + 2 + 1 + 1 == n + 5
        assert mv.phase_barrier_count(lv, "ascend") == 1 + n + 2 == n + 3
    prior = fused_levels(to_port(jax_operator(24, False), dtype=torch.float32), 2)[0]
    assert prior.op.m_lowrank == 0
    assert mv.phase_barrier_count(prior, "descend") == 2 + 3
    assert mv.phase_barrier_count(prior, "ascend") == 2 + 1
    assert len(mv.pass_names(prior, "descend")) == mv.phase_barrier_count(prior, "descend")


def test_stencil_form_picks_one_kernel_per_stencil():
    """The host picks the phase kernel of a level's stencil form, as
    ``stencil_form`` of ``level_passes.cuh`` finds it: the flagship's level 0
    (5-point, constant coefficients) form 0, its level 1 (the raster 3x3 box,
    whose planes float32 holds constant) form 2; any other 9-offset order 4;
    one more where a coefficient varies in space."""
    levels = flagship()
    assert (levels[0].stencil_form, levels[1].stencil_form) == (0, 2)
    box = STENCILS["3x3 box"]
    assert mv.stencil_form(box, [1.0] * 9) == 2
    assert mv.stencil_form(box, [1.0] * 8 + [None]) == 3
    assert mv.stencil_form(STENCILS["user 9-offset"], [1.0] * 9) == 4
    assert mv.stencil_form(STENCILS["5-point cross"], [None] + [1.0] * 4) == 1
    assert mv.stencil_form(((0, 0), (0, 1), (1, 0)), [1.0] * 3) == 0
    src = SOURCE.read_text()
    assert f"#define STENCIL_FORMS {mv.STENCIL_FORMS}" in src
    dispatch = src[src.index("#define STENCIL_DISPATCH"):]
    forms = re.findall(r"case (\d): CALL\((\d), (true|false), (true|false)\)", dispatch)
    assert [(int(f), int(k), b == "true", p == "true") for f, k, b, p in forms] == [
        (0, 5, False, False), (1, 5, False, True), (2, 9, True, False), (3, 9, True, True),
        (4, 9, False, False)]


@pytest.mark.parametrize("vshape", [(255, 255), (127, 127), (31, 31), (9, 1031), (13, 6)])
def test_rhs_stores_staged_span_by_span(vshape):
    """``rhs_pass`` with a staging buffer: a warp's 32 groups (4 points each,
    the last of a row shorter) lie in one span of memory, which the warp
    writes back lane-contiguous.  Replayed warp by warp: each span holds at
    most 128 points, each point's place in it is its offset from the span's
    first point, and the spans of all warps' turns cover the field once."""
    H, W = vshape
    G = (W + 3) // 4
    NG = H * G
    written = np.zeros(H * W, int)
    for threads in (256, 1024):
        written[:] = 0
        for warp in range(threads // 32):
            for q0 in range(32 * warp, NG, threads):  # the warp's turns: first group live
                qe = min(q0 + 31, NG - 1)
                p0 = (q0 // G) * W + 4 * (q0 % G)
                pe = (qe // G) * W + min(4 * (qe % G) + 3, W - 1)
                n = pe - p0 + 1
                assert 0 < n <= 128
                stage = np.full(128, -1)
                for lane in range(32):
                    q = q0 + lane
                    if q >= NG:
                        continue
                    i, g = divmod(q, G)
                    for c in range(4):
                        j = 4 * g + c
                        if j < W:
                            off = i * W + j - p0
                            assert 0 <= off < n and stage[off] == -1
                            stage[off] = i * W + j
                assert np.array_equal(stage[:n], np.arange(p0, p0 + n))
                written[p0:p0 + n] += 1
        assert (written == 1).all()


def test_the_stamps_build_is_a_library_of_its_own():
    """The phase kernels' stamps build is ``csrc/mgmc_visit.cu`` compiled once
    more with ``PHASE_STAMPS_BUILD`` set, a library beside the production one
    (each holds one build's kernels, so each compiles in about half the
    time, in parallel with the other sources); a launch with stamps takes it."""
    assert ("mgmc_visit", common.PHASE_STAMPS_FLAGS) in common.STAMPS_BUILDS
    assert common.BUILDS == common.SOURCES + common.STAMPS_BUILDS + common.VARIANT_BUILDS
    assert common.PHASE_STAMPS_FLAGS == ("-DPHASE_STAMPS_BUILD=1",)
    production = common.library_path("mgmc_visit")
    stamps = common.library_path("mgmc_visit", common.PHASE_STAMPS_FLAGS)
    assert production != stamps and production.parent == stamps.parent == common.BUILD_DIR
    src = common.source_path("mgmc_visit").read_text()
    assert "#ifndef PHASE_STAMPS_BUILD\n#define PHASE_STAMPS_BUILD 0" in src
    assert "stamps != (bool)PHASE_STAMPS_BUILD" in src
