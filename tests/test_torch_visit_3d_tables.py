"""The phase kernels' 3d build on the CPU: what a launch reads and computes.

A 3d level (7-point, 2 colours; 27-point Galerkin, 8 colours) takes
``csrc/mgmc_visit.cu -DVISIT_DIM=3``.  Here, on small posteriors:

* the 3d parameter block (``VolumeVisitParams``) against the level;
* the tables (3d boxes, the columns each row ``(z, y)`` spans, ``B`` and ``Y``
  staged box by box, ``W``) against a brute-force reading of the level, and
  the colour rows read slot by slot as the kernel's warps take them against
  the colouring: each point of each colour once;
* a float64 replay of a descend and an ascend that reads the tables as the 3d
  passes of ``csrc/level_passes.cuh`` do (the colour rows slot by slot, the
  low-rank terms box by box, the transfers point by point) against the plain
  versions (``atol = 1e-12``);
* the route (the phase kernels at every chain count; split and stream
  refuse), the names, the block bound, the barriers, the stencil forms and the
  build flags against the sources, and the 3d Philox numbering.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigridmc_tpu_torch.ops.kernels import common
from multigridmc_tpu_torch.ops.kernels import mgmc_visit as mv

from test_torch_visit_3d import levels

CSRC = Path(mv.__file__).resolve().parents[2] / "csrc"


# ------------------------------------------------------ parameters and tables
def test_3d_parameter_block_describes_the_level():
    _, _, _, port = levels((10, 12, 14), 1, True, torch.float32)
    P = port._params(5, port.post_order, True, 2, None)
    assert isinstance(P, mv.VolumeVisitParams)
    Z, Y, X = port.op.vshape
    assert (P.C, P.Z, P.Y, P.H, P.W) == (5, Z, Y, Z * Y, X)
    assert (P.Zc, P.Yc, P.Hc, P.Wc) == (Z // 2, Y // 2, (Z // 2) * (Y // 2), X // 2)
    assert P.K == 27 and P.n_colors == 8 and (P.wz, P.w0, P.w1) == port.coloring.weights
    assert [(P.dz[k], P.dy[k], P.dx[k]) for k in range(27)] == list(port.op.offsets)
    assert [P.order[i] for i in range(8)] == list(port.post_order)
    # the colour repeats every jstride columns
    field = port.coloring.field
    assert np.all(field[..., :-P.jstride] == field[..., P.jstride:])
    for k, box in enumerate(port.bbox):
        assert tuple(P.bbox[k]) == box
    assert P.m == 3 and P.noise_mode == 2 and P.f_batched == 1


def float64_values(level, order, tab):
    """``tab`` with the level's float64 values in place of the staged float32
    ones, at the offsets the tables give (the replay's arithmetic is
    float64)."""
    Y, W, _ = level._woodbury[order]
    for name, fields in (("b", level.B), ("y", Y)):
        vals = [fields[k][mv.box_slices(box)].numpy().reshape(-1)
                for k, box in enumerate(tab[name + "box"])]
        assert [v.size for v in vals] == list(np.diff(tab[name + "off"]))
        tab[name + "val"] = np.concatenate(vals)
    tab["wm"] = W.numpy()
    return tab


def decode(level, order):
    """The tables of one phase launch of a 3d level (one sweep) as the kernel
    reads them."""
    words, T = mv.phase_tables(level, (order,))
    floats = words.view(np.float32)
    m, K = level.op.m_lowrank, level.coloring.n_colors
    rows = int(np.prod(level.op.vshape[:-1]))
    boff = words[T.boff:T.boff + m + 1]
    yoff = words[T.yoff[0]:T.yoff[0] + m + 1]
    return {"bval": floats[T.bval:T.bval + boff[-1]], "boff": boff,
            "yval": floats[T.yval[0]:T.yval[0] + yoff[-1]], "yoff": yoff,
            "wm": floats[T.wm[0]:T.wm[0] + m * m].reshape(m, m),
            "sroot": floats[T.sroot:T.sroot + m],
            "bbox": [tuple(b) for b in words[T.bbox:T.bbox + 6 * m].reshape(m, 6)],
            "ybox": [tuple(b) for b in words[T.ybox[0]:T.ybox[0] + 6 * m].reshape(m, 6)],
            "bspan": words[T.bspan:T.bspan + 2 * rows].reshape(rows, 2),
            "yspan": words[T.yspan[0]:T.yspan[0] + 2 * rows].reshape(rows, 2),
            "rows": words[T.rows[0]:T.rows[0] + len(order) * (1 + 3 * K * K)].reshape(
                len(order), -1)}


def spans_brute_force(boxes, vshape):
    Z, Y = vshape[:2]
    out = np.tile(np.array([1 << 30, 0]), (Z * Y, 1))
    for z, y in itertools.product(range(Z), range(Y)):
        holding = [(j0, j1) for k0, k1, i0, i1, j0, j1 in boxes if k0 <= z < k1 and i0 <= y < i1]
        if holding:
            out[z * Y + y] = (min(j0 for j0, _ in holding), max(j1 for _, j1 in holding))
    return out


def colour_slots(level, rows, o):
    """The rows ``(z, y, first column)`` of colour ``o`` in the order the
    kernel's warps take them: slot ``r`` is (z block, y block, residue pair)."""
    Z, Y, _ = level.op.vshape
    K = level.coloring.n_colors
    R = rows[o, 0]
    nqy = -(-Y // K)
    out = []
    for r in itertools.count():
        q, t = divmod(r, R)
        qz, qy = divmod(q, nqy)
        if qz * K >= Z:
            return out
        z, y = qz * K + rows[o, 1 + 3 * t], qy * K + rows[o, 2 + 3 * t]
        if z < Z and y < Y:
            out.append((z, y, rows[o, 3 + 3 * t]))


@pytest.mark.parametrize("level", [0, 1], ids=["7pt", "27pt"])
@pytest.mark.parametrize("descend", [True, False], ids=["descend", "ascend"])
def test_3d_tables_against_a_brute_force_reading(level, descend):
    _, _, _, port = levels((10, 12, 14), level, True, torch.float32)
    order = port.pre_order if descend else port.post_order
    tab = decode(port, order)
    Y, W, ybox = port._woodbury[order]
    assert tab["bbox"] == list(port.bbox) and tab["ybox"] == list(ybox)
    assert np.array_equal(tab["bspan"], spans_brute_force(port.bbox, port.op.vshape))
    assert np.array_equal(tab["yspan"], spans_brute_force(ybox, port.op.vshape))
    for k, box in enumerate(port.bbox):
        assert np.array_equal(tab["bval"][tab["boff"][k]:tab["boff"][k + 1]],
                              port.B[k][mv.box_slices(box)].numpy().reshape(-1))
        outside = port.B[k].clone()
        outside[mv.box_slices(box)] = 0
        assert not outside.any()
    for k, box in enumerate(ybox):
        assert np.array_equal(tab["yval"][tab["yoff"][k]:tab["yoff"][k + 1]],
                              Y[k][mv.box_slices(box)].numpy().reshape(-1))
    assert np.array_equal(tab["wm"], W.numpy())
    assert np.array_equal(tab["sroot"], port.sigma_sqrt.numpy())
    # the colour rows: every point of each colour once, read slot by slot
    K, s = port.coloring.n_colors, port._build_params(1, order, True, 0).jstride
    masks = port.masks.numpy()
    for o, colour in enumerate(order):
        got = np.zeros(port.op.vshape, int)
        for z, y, j in colour_slots(port, tab["rows"], o):
            got[z, y, j::s] += 1
        assert np.array_equal(got, masks[colour].astype(int)), (o, colour)
        # red-black: every row holds each colour; 8 colours: a quarter of the rows
        assert tab["rows"][o, 0] == (K * K if K == 2 else K * K // 4)


def box_value(vals, off, boxes, k, z, y, j):
    """``add_columns``' read of column ``k`` at ``(z, y, j)``, or None."""
    k0, k1, i0, i1, j0, j1 = boxes[k]
    if not (k0 <= z < k1 and i0 <= y < i1 and j0 <= j < j1):
        return None
    return vals[off[k] + ((z - k0) * (i1 - i0) + (y - i0)) * (j1 - j0) + (j - j0)]


def add_columns(tab, prefix, coef, sign, z, y, j, v):
    for k in range(len(coef)):
        b = box_value(tab[prefix + "val"], tab[prefix + "off"], tab[prefix + "box"], k, z, y, j)
        if b is not None:
            v += sign * coef[k] * b
    return v


def stencil_point(level, x, z, y, j):
    """The stencil in registers at one point: the terms in offset order, a
    neighbour outside the field dropped."""
    coeffs = level.coeffs.numpy()
    ax = 0.0
    for k, (dz, dy, dx) in enumerate(level.op.offsets):
        zz, yy, jj = z + dz, y + dy, j + dx
        if all(0 <= v < n for v, n in zip((zz, yy, jj), x.shape)):
            ax += coeffs[k, z, y, j] * x[zz, yy, jj]
    return ax


def replay_sweep(level, tab, order, c, x):
    s = level._build_params(1, order, True, 0).jstride
    diag = level.coeffs.numpy()[level.op.diag_index]
    x = x.copy()
    for o in range(len(order)):
        new = {}
        for z, y, j0 in colour_slots(level, tab["rows"], o):
            for j in range(j0, x.shape[2], s):
                new[z, y, j] = x[z, y, j] + level.omega * (c[z, y, j] - stencil_point(
                    level, x, z, y, j)) / diag[z, y, j]
        for p, v in new.items():
            x[p] = v
    return x


def replay_btx(tab, x):
    """``btx_pass``: per column its box read row by row, q -> (z, y, j)."""
    out = []
    for k, (z0, _, i0, i1, j0, j1) in enumerate(tab["bbox"]):
        bh, bw = i1 - i0, j1 - j0
        vals = tab["bval"][tab["boff"][k]:tab["boff"][k + 1]]
        acc = 0.0
        for q in range(vals.size):
            row = q // bw
            zq = row // bh
            acc += x[z0 + zq, i0 + row - zq * bh, j0 + q - row * bw] * vals[q]
        out.append(acc)
    return np.array(out)


def points(shape):
    return itertools.product(*(range(n) for n in shape))


def replay_woodbury(level, tab, x, n):
    """``btx_pass`` and ``woodbury_pass``: u = W (B^T x - Sigma^1/2 n); returns
    (t = u + Sigma^-1/2 n, x - sum_l u_l Y_l)."""
    sroot = level.sigma_sqrt.numpy()
    u = tab["wm"] @ (replay_btx(tab, x) - sroot * n)
    x = x.copy()
    for z, y, j in points(x.shape):
        x[z, y, j] = add_columns(tab, "y", u, -1.0, z, y, j, x[z, y, j])
    return u + n / sroot, x


def replay_restrict(level, r):
    """``restrict_rows3``: 27 reads a coarse point, plane by row by point."""
    w = (0.5, 1.0, 0.5)
    fc = np.zeros(level.vc)
    for K_, I, J in points(level.vc):
        acc = 0.0
        for c in range(3):
            plane = 0.0
            for a in range(3):
                row = 0.0
                for b in range(3):
                    zz, yy, jj = 2 * K_ + c, 2 * I + a, 2 * J + b
                    inside = zz < r.shape[0] and yy < r.shape[1] and jj < r.shape[2]
                    row += w[b] * (r[zz, yy, jj] if inside else 0.0)
                plane += w[a] * row
            acc += w[c] * plane
        fc[K_, I, J] = acc
    return fc


def replay_prolong(level, x, xc):
    """``prolong_rows3``: per axis an odd index takes its coarse point, an even
    one its two coarse neighbours with 0.5 each."""
    def taps(v, n):
        return [(v >> 1, 1.0)] if v & 1 else [(u, 0.5) for u in (v // 2 - 1, v // 2)
                                                  if 0 <= u < n]
    out = x.copy()
    for z, y, j in points(x.shape):
        px = sum(wz * wy * wj * xc[a, b, c] for a, wz in taps(z, xc.shape[0])
                 for b, wy in taps(y, xc.shape[1]) for c, wj in taps(j, xc.shape[2]))
        out[z, y, j] += level.coarse_scaling * px
    return out


def replay_rhs(level, f, xi):
    """``rhs_pass``: c = f + ns xi (the low-rank noise enters the Woodbury
    correction)."""
    return f + level.noise_scale.numpy() * xi


def replay_descend(level, f, x, xi, xi_lr):
    tab = float64_values(level, level.pre_order, decode(level, level.pre_order))
    c = replay_rhs(level, f, xi)
    x = replay_sweep(level, tab, level.pre_order, c, x)
    t, x = replay_woodbury(level, tab, x, xi_lr)
    r = np.zeros_like(f)
    for z, y, j in points(f.shape):
        r[z, y, j] = add_columns(tab, "b", t, -1.0, z, y, j,
                                 f[z, y, j] - stencil_point(level, x, z, y, j))
    return x, replay_restrict(level, r)


def replay_ascend(level, f, x, xc, xi, xi_lr):
    tab = float64_values(level, level.post_order, decode(level, level.post_order))
    x = replay_prolong(level, x, xc)
    x = replay_sweep(level, tab, level.post_order, replay_rhs(level, f, xi), x)
    return replay_woodbury(level, tab, x, xi_lr)[1]


@pytest.mark.parametrize("level", [0, 1], ids=["7pt", "27pt"])
def test_float64_replay_of_the_3d_passes_is_the_plain_visit(level):
    """A descend and an ascend as the 3d passes compute them (the colour rows
    slot by slot, the low-rank terms box by box, the transfers point by point,
    in float64 on the tables' geometry) against the plain versions, one
    chain, noise tensors given."""
    _, _, _, port = levels((8, 10, 12), level, True)
    rng = np.random.default_rng(22)
    shape = port.op.vshape
    f, x, xi = rng.normal(size=(3,) + shape)
    xc = rng.normal(size=port.vc)
    xi_lr = rng.normal(size=port.op.m_lowrank)
    got_x, got_fc = replay_descend(port, f, x, xi, xi_lr)
    one = lambda v: torch.as_tensor(v)[None]  # noqa: E731
    want_x, want_fc = mv.descend_visit_plain(port, torch.as_tensor(f), one(x), one(xi),
                                             one(xi_lr))
    np.testing.assert_allclose(got_x, want_x[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_fc, want_fc[0].numpy(), rtol=0, atol=1e-12)
    got = replay_ascend(port, f, x, xc, xi, xi_lr)
    want = mv.ascend_visit_plain(port, torch.as_tensor(f), one(x), one(xc), one(xi), one(xi_lr))
    np.testing.assert_allclose(got, want[0].numpy(), rtol=0, atol=1e-12)
    assert np.abs(got - x).max() > 1e-3


# --------------------------------------------------- route, build and names
def test_3d_levels_take_the_phase_kernels_3d_build():
    """A 3d level the smem route's table (``mgmc_visit_smem3d.SMEM3D_ROUTES``)
    does not list takes the phase kernels' 3d build at every chain count; a
    shape it lists takes the smem kernels where the table says; split and
    stream refuse 3d; both 3d builds have a stamps build."""
    from multigridmc_tpu_torch.ops.kernels import mgmc_visit_smem3d as v3

    _, _, _, fine = levels((10, 12, 14), 0, True, torch.float32)
    _, _, _, coarse = levels((10, 12, 14), 1, True, torch.float32)
    for port, form, size in ((fine, 10, "7"), (coarse, 12, "27")):
        assert port.dim == 3 and port.stencil_form == form
        assert {port.route(C) for C in (1, 16, 32, 256)} == {"phase"}
        assert port.split_cluster(1) is None
        for route in ("split", "stream"):
            assert "2d levels only" in mv.route_support_error(port, route)
        assert mv.route_support_error(port, "phase") is None
        assert mv.route_support_error(port, "smem") is None
        for kind in ("descend", "ascend"):
            assert mv.kernel_name(port, "phase", kind) == f"{kind}_visit_3d_{size}pt"
            assert mv.launch_counts[mv.kernel_name(port, "phase", kind)] == 0
        assert all(port.phase_threads(C) <= mv.DIM3_MAX_THREADS for C in (1, 32, 256))
        assert mv.phase_barrier_count(port, "descend") == len(port.pre_order) + 5
        assert mv.phase_barrier_count(port, "ascend") == len(port.post_order) + 3
        assert mv.pass_names(port, "ascend")[0] == "prolongation + rhs"
    # the 64^3 posterior's levels: the table's route at each count
    for (Z, Y, W, form, ndir), rows in v3.SMEM3D_ROUTES.items():
        assert form in (10, 12) and ndir in (1, 2)
        for C in (1, 32, 128):
            listed = any(C >= a and (b is None or C <= b) for a, b, *_ in rows)
            assert mv.visit_route(C, 0, torch.device("cpu"), vshape=(Z, Y, W), form=form,
                                  ndir=ndir) == ("smem" if listed else "phase")
    # a stencil of 8..27 offsets that is not the raster box takes form 14
    cross = tuple(o for o in itertools.product((-1, 0, 1), repeat=3) if sum(map(abs, o)) <= 2)
    assert mv.stencil_form(cross, [1.0] * len(cross)) == 14
    assert mv.stencil_form(cross, [None] + [1.0] * (len(cross) - 1)) == 15
    x = torch.zeros((1,) + fine.op.vshape, dtype=torch.float32)
    mv._check_stamps(fine, "phase", torch.zeros((1, mv.PHASE_STAMP_WIDTH), dtype=torch.int64), x)
    with pytest.raises(ValueError, match="stamps must be"):
        mv._check_stamps(fine, "phase", torch.zeros((1, mv.PHASE_STAMP_WIDTH - 1),
                                                    dtype=torch.int64), x)
    assert ("mgmc_visit", common.PHASE_DIM3_STAMPS_FLAGS) in common.STAMPS_BUILDS
    assert ("mgmc_visit_smem3d", common.SMEM_VISIT_STAMPS_FLAGS) in common.STAMPS_BUILDS


def test_3d_build_flags_forms_and_source_agree():
    assert ("mgmc_visit", common.PHASE_DIM3_FLAGS) in common.BUILDS
    assert mv.PHASE_BUILDS[(1, 3)][0] == common.PHASE_DIM3_FLAGS == ("-DVISIT_DIM=3",)
    passes = (CSRC / "level_passes.cuh").read_text()
    assert f"#define DIM3_FORM0 {mv.DIM3_FORM0}" in passes
    assert f"#define DIM3_FORMS {mv.DIM3_FORMS}" in passes
    visit = (CSRC / "mgmc_visit.cu").read_text()
    cases = {int(v) for v in re.findall(r"case (\d+): return FORM_KERNEL", visit)}
    assert set(range(mv.DIM3_FORM0, mv.DIM3_FORM0 + mv.DIM3_FORMS)) <= cases
    with pytest.raises(ValueError, match="a 3d build"):
        mv.load_library(stamps=True, reach=2, dim=3)


def test_3d_philox_groups_number_rows_z_y():
    """The kernels' 3d noise: row ``z Y + y``, group ``g`` of a row numbered
    ``row * ceil(X / 4) + g`` - the 2d numbering of the ``(Z Y, X)`` field."""
    z3 = common.philox_normals_reference(7, 3, 2, (5, 6, 9))
    z2 = common.philox_normals_reference(7, 3, 2, (30, 9))
    assert np.array_equal(z3.reshape(2, 30, 9), z2)
