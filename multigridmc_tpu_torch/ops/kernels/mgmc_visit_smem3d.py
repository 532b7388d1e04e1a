"""The 3d level visits with each chain's field in shared memory: the
``"smem"`` route of :func:`~.mgmc_visit.visit_route` for a 3d level
(``csrc/mgmc_visit_smem3d.cu``).

Replace, for the 7-point FD levels and the 27-point Galerkin levels of a 3d
lattice (stencil forms 10-15), ``descend_visit`` / ``ascend_visit`` of
``multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py`` in their flat-3d form, and
compute what the phase kernels' 3d build computes (the same
``VolumeVisitParams`` per sweep direction, the same noise modes, one or two
sweeps).  A cluster of ``S`` blocks holds one chain: block ``k`` its slab of
z-planes (:func:`slabs`), each plane padded with a zero row and column a side,
and a ghost plane a side (zero at the field's faces); ``S = 1`` where the chain
fits one block.  After each cluster barrier that precedes a pass reading
across a cut, each block copies the neighbours' edge planes from their shared
memory into its ghost planes.  The rhs ``c`` and the residual sit in shared
memory where the layout says so, else in a scratch field.  Each thread takes its points from
the tables of :func:`visit_tables`: colour after colour, first the interior
points (the coefficients as scalars), then the edge points, each part dealt
round the 32 banks.

Here: the tables and the parameter block (:func:`visit_tables`,
:func:`interior_plan`, :class:`SmemVolumeParams`), the shared-memory size's
mirror (:func:`smem_bytes`), the barriers and the stamps' passes
(:func:`barrier_count`, :func:`pass_names`, :func:`pass_times`), the library
(:func:`load_library`, and its stamps build), the route's table
(:data:`SMEM3D_ROUTES`, :func:`route_config`, :func:`smem_cluster`), the
default placement of a configuration it does not list (:func:`placement`) and
the launch (:func:`launch`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import mgmc_visit as mv
from . import sor_sweep as ss
from .common import SMEM_VISIT_STAMPS_FLAGS as STAMPS_FLAGS
from .common import open_library, stamp_breakdown
from .common import tensor_ptr as _ptr

#: the CUDA source under ``csrc/``
SOURCE_NAME = "mgmc_visit_smem3d"
#: the largest cluster (``SMEM_MAX_CLUSTER``) and the sizes the rule tries
MAX_CLUSTER = 16
CLUSTER_SIZES = (16, 8, 4, 2, 1)
#: ints of the tables' head per (direction, rank): the ``n_order + 1`` starts
#: of the colours' entries, then each colour's interior points
#: (``SMEM_HEAD_INTS``)
HEAD_INTS = 2 * mv.MAX_COLORS + 1
#: int64 words per block of the stamps (``SMEM_STAMP_WIDTH``): the timer at
#: entry, after the copy-in, after up to ``MAX_COLORS + 2`` barriers of each
#: direction and the descend's 3, at exit, the barriers passed, the SM
STAMP_WIDTH = 1 + 1 + mv.MAX_DIRS * (mv.MAX_COLORS + 2) + 3 + 3
#: the kernels' block bound (``SMEM_VISIT_MAX_THREADS``): 64 registers a
#: thread, two blocks of 512 an SM
MAX_THREADS = 1024
#: registers a thread under that bound
REGISTERS = 64
#: the kernels' static shared memory: a slab's share of ``B^T x``, a slot of
#: ``LANE_SLOTS`` floats per warp, the barrier count and the stamps pointer
STATIC_SMEM = 4 * (mv.LANE_SLOTS + 32 * mv.LANE_SLOTS) + 16
#: entries pack (padded index << 16) | index in the slab
INDEX_LIMIT = 1 << 16

#: Per level shape, stencil form and sweeps per visit ``(Z, Y, W, form,
#: ndir)``: the chain counts ``(least, most)`` (``most`` None: no upper bound)
#: at which a visit takes these kernels, each with its launch configuration
#: ``(S, c_shared, threads)``; a count or a level not listed takes the phase
#: kernels' 3d build.  Set from the ``volume_table`` of ``chip_smoke.py``
#: (``--phases volume_table``): device ms per descend plus ascend of both
#: routes at 1, 4, 8, 32, 64 and 128 chains, every cluster size that fits with
#: ``c`` in shared memory or not, 512 or 1024 threads, on the 64^3 posterior's
#: 63^3 7-point and 31^3 27-point levels, one and two sweeps, NVIDIA H100 80GB
#: HBM3, 700.00 W; ``PERF.md`` section 6 holds the table.  The smem kernels
#: win at every count measured (63^3: 0.05-0.67 of the phase kernels' device
#: time, 31^3: 0.18-0.76).  A range runs from a measured count to the next
#: one's predecessor and takes the configuration that was fastest at its
#: first count: clusters of 16 one block an SM up to 4 chains (no more such
#: clusters fit the card at once), then fewer or smaller blocks.
SMEM3D_ROUTES: Dict[Tuple[int, int, int, int, int],
                    Tuple[Tuple[int, Optional[int], int, bool, int], ...]] = {
    (63, 63, 63, 10, 1): ((1, 7, 16, True, 1024), (8, 31, 8, False, 1024),
                          (32, None, 16, False, 512)),
    (63, 63, 63, 10, 2): ((1, 7, 16, True, 1024), (8, 31, 8, False, 1024),
                          (32, 127, 16, False, 512), (128, None, 8, False, 1024)),
    (31, 31, 31, 12, 1): ((1, 7, 16, True, 1024), (8, 31, 8, True, 1024),
                          (32, 127, 2, True, 1024), (128, None, 1, False, 1024)),
    (31, 31, 31, 12, 2): ((1, 7, 16, True, 1024), (8, 31, 8, True, 1024),
                          (32, 127, 2, True, 1024), (128, None, 1, False, 1024))}

#: Threads per block of :func:`placement`: this many where a block's slab
#: leaves no room for a second on its SM, else half as many (two blocks an SM)
SMEM_ALONE_THREADS = 1024


class SmemVolumeParams(ctypes.Structure):
    """Mirror of ``struct SmemVolumeParams`` in ``csrc/mgmc_visit_smem3d.cu``:
    a ``VolumeVisitParams`` per sweep direction and their number, the cluster
    size, the padded row and plane, the widest slab, whether ``c`` lies in
    shared memory, the interior margin, the padded offsets, the interior
    coefficients and the planes that vary."""

    _fields_ = [("v", mv.VolumeVisitParams * mv.MAX_DIRS), ("ndir", ctypes.c_int),
                ("S", ctypes.c_int), ("PX", ctypes.c_int), ("PP", ctypes.c_int),
                ("nz_max", ctypes.c_int), ("c_shared", ctypes.c_int), ("margin", ctypes.c_int),
                ("soff", ctypes.c_int * mv.DIM3_MAX_OFFSETS),
                ("cval", ctypes.c_float * mv.DIM3_MAX_OFFSETS), ("planes", ctypes.c_uint)]


# ------------------------------------------------------------------ the layout
def pitch(W: int) -> int:
    """A padded row: ``W`` and a zero column a side."""
    return int(W) + 2


def plane(Y: int, W: int) -> int:
    """A padded plane: ``Y + 2`` padded rows."""
    return (int(Y) + 2) * pitch(W)


def slabs(Z: int, S: int) -> Tuple[Tuple[int, int], ...]:
    """The planes ``[z0, z1)`` of each block of a cluster of ``S`` on ``Z``
    planes, rank by rank: the first ``Z % S`` ranks take one plane more
    (``slab_of`` in the source).  Coarse plane ``I`` belongs to the rank whose
    slab holds fine plane ``2I + 1``."""
    return mv.split_bands(Z, S)


def smem_bytes(Z: int, Y: int, W: int, S: int, c_shared: bool) -> int:
    """Dynamic shared memory of one block with clusters of ``S`` on a ``Z x Y
    x W`` level: the widest slab of ``x`` in padded planes with a ghost plane
    a side and, with ``c_shared``, its planes of ``c`` and ``r``; the host's
    mirror of ``mgmc_smem3d_smem_bytes``.  ``ValueError`` where the level does
    not split so (``S`` outside 1 .. 16, more blocks than planes)."""
    if not 1 <= S <= MAX_CLUSTER or Z // S < 1:
        raise ValueError(f"a level of {Z} planes does not split over {S} blocks")
    nz = -(-int(Z) // S)
    return 4 * ((nz + 2) * plane(Y, W) + (nz * int(Y) * int(W) if c_shared else 0))


def fits_indices(Z: int, Y: int, W: int, S: int) -> bool:
    """Whether the tables' 16-bit indices hold the level: every index in the
    widest slab and every padded index of it below :data:`INDEX_LIMIT`."""
    nz = -(-int(Z) // S)
    return nz * int(Y) * int(W) <= INDEX_LIMIT and (nz + 2) * plane(Y, W) <= INDEX_LIMIT


def kmax(form: int) -> int:
    """The stencil size a form's kernel is compiled for: 7 (forms 10, 11), 27
    (12-15)."""
    if not mv.DIM3_FORM0 <= form < mv.DIM3_FORM0 + mv.DIM3_FORMS:
        raise ValueError(f"the 3d smem route takes the 3d forms, not form {form}")
    return 7 if form < 12 else 27


def _grid(shape):
    return [g.reshape(-1) for g in np.meshgrid(*(np.arange(int(s)) for s in shape),
                                                indexing="ij")]


def interior_plan(level) -> dict:
    """What the level's coefficient planes give the kernels: ``cval``, the
    interior coefficients (the centre point's, float32); ``plain``, per point
    whether every coefficient whose neighbour lies in the field equals them;
    ``margin``, the least distance from the field's faces from which on every
    point is plain; ``planes``, bit ``k`` where coefficient ``k`` differs from
    ``cval[k]`` at a point whose neighbour ``k`` lies in the field."""
    op = level.op
    Z, Y, W = (int(v) for v in op.vshape)
    K, n = len(op.offsets), Z * Y * W
    c = level.coeffs.detach().cpu().to(torch.float32).numpy().reshape(K, n)
    cval = c[:, ((Z // 2) * Y + Y // 2) * W + W // 2].copy()
    zz, yy, jj = _grid((Z, Y, W))
    inside = np.stack([(zz + dz >= 0) & (zz + dz < Z) & (yy + dy >= 0) & (yy + dy < Y)
                       & (jj + dx >= 0) & (jj + dx < W) for dz, dy, dx in op.offsets])
    plain = np.all((c == cval[:, None]) | ~inside, axis=0)
    dist = np.minimum.reduce([zz, Z - 1 - zz, yy, Y - 1 - yy, jj, W - 1 - jj])
    margin = int(dist[~plain].max()) + 1 if (~plain).any() else 0
    varies = np.any((c != cval[:, None]) & inside, axis=1)
    return {"cval": cval, "plain": plain, "margin": margin,
            "planes": int(sum(1 << int(k) for k in np.flatnonzero(varies)))}


def visit_tables(level, orders, S: int) -> dict:
    """The tables of a launch with the sweep ``orders`` and clusters of
    ``S``:

    * ``words``: int32, the heads, then the entries.  Head ``(d, k)`` (at
      ``(d S + k) HEAD_INTS``): the starts of the colours of order ``d`` in
      the slab of rank ``k`` (``n_order + 1`` word indices into ``words``),
      then from word ``MAX_COLORS + 1`` on each colour's interior points.
      An entry is ``(q << 16) | e``: ``q`` the point's index in the slab's
      padded planes (slab plane ``l``, row ``y``, column ``j``: ``((l + 1)
      (Y + 2) + y + 1) (W + 2) + j + 1``), ``e`` its index in the slab (``p -
      z0 Y W``);
    * within a colour the interior points first - every coefficient is the
      interior value (:func:`interior_plan`; a plane beyond a cut lies in a
      ghost plane) - then the edge points, each part dealt round the banks
      (``sor_sweep.bank_order``);
    * ``entries[d][k]``, ``starts[d][k]``, ``interior[d][k]``: the same per
      (direction, rank), starts relative to the slab's first entry, and each
      colour's interior points;
    * the level's :func:`interior_plan`, ``PX`` and ``PP``, the padded row and
      plane."""
    orders = mv._as_orders(orders)
    Z, Y, W = (int(v) for v in level.op.vshape)
    if not fits_indices(Z, Y, W, S):
        raise ValueError(f"a {Z}x{Y}x{W} level over {S} blocks exceeds the tables' 16-bit "
                         "indices")
    plan = interior_plan(level)
    PX, PP = pitch(W), plane(Y, W)
    zz, yy, jj = _grid((Z, Y, W))
    wz, w0, w1 = (int(w) for w in level.coloring.weights)
    colour = (wz * zz + w0 * yy + w1 * jj) % level.coloring.n_colors
    heads = np.zeros((len(orders), S, HEAD_INTS), np.int32)
    parts, pos = [], len(orders) * S * HEAD_INTS
    out = {"entries": [], "starts": [], "interior": []}
    for d, order in enumerate(orders):
        out["entries"].append([])
        out["starts"].append([])
        out["interior"].append([])
        for k, (z0, z1) in enumerate(slabs(Z, S)):
            slab = (zz >= z0) & (zz < z1)
            plain = plan["plain"]
            q = ((zz - z0 + 1) * (Y + 2) + yy + 1) * PX + jj + 1
            e = np.arange(zz.size) - z0 * Y * W
            band_entries, starts, nplain = [], [0], []
            for o, col in enumerate(order):
                sel = slab & (colour == int(col))
                a, b = np.flatnonzero(sel & plain), np.flatnonzero(sel & ~plain)
                idx = np.concatenate([a[ss.bank_order(q[a])], b[ss.bank_order(q[b])]])
                heads[d, k, o] = pos + starts[-1]
                heads[d, k, mv.MAX_COLORS + 1 + o] = a.size
                nplain.append(int(a.size))
                starts.append(starts[-1] + int(idx.size))
                band_entries.append((q[idx].astype(np.int64) << 16) | e[idx])
            heads[d, k, len(order)] = pos + starts[-1]
            entries = np.concatenate(band_entries).astype(np.int64)
            parts.append(entries)
            pos += entries.size
            out["entries"][d].append(entries)
            out["starts"][d].append(starts)
            out["interior"][d].append(nplain)
    words = np.concatenate([heads.reshape(-1).astype(np.int64)] + parts)
    out["words"] = words.astype(np.uint32).view(np.int32)
    return {**plan, **out, "PX": PX, "PP": PP}


# ------------------------------------------------------------ barriers, stamps
def barrier_count(level, kind: str) -> int:
    """Barriers of one launch as ``csrc/mgmc_visit_smem3d.cu`` places them
    (its ``smem_sync`` calls; a ghost copy's block barrier is not counted): an
    ascend's copy-in; per sweep direction the rhs, each colour and (``m >
    0``) the slabs' shares of ``B^T x``; then a descend 3 (the corrected
    ``x``, the residual, the end) and an ascend 1 (the corrected ``x``).  The
    stamps build counts them on the card."""
    share = 1 if level.op.m_lowrank else 0
    return (sum(1 + len(order) + share for order in level.orders(kind))
            + (3 if kind == "descend" else 2))


def pass_names(level, kind: str):
    """The passes of a launch in the order the stamps time them (each ends
    with a barrier); a two-sweep visit names its directions' passes ``d0:
    ...`` and ``d1: ...``."""
    orders, m = level.orders(kind), level.op.m_lowrank
    names = ["copy-in"] if kind == "ascend" else []
    for d, order in enumerate(orders):
        first = ("prolongation + rhs" if kind == "ascend" and d == 0
                 else "copy-in + rhs" if d == 0
                 else "Woodbury + rhs" if m else "rhs")
        own = [first] + [f"colour {c}" for c in order] + (["B^T x shares"] if m else [])
        names += own if len(orders) == 1 else [f"d{d}: {name}" for name in own]
    names.append("Woodbury" if m else "last colour")
    if kind == "descend":
        names += ["write-back + residual", "restriction"]
    return names


def pass_times(level, kind: str, stamps) -> dict:
    """Where one launch went, from the stamps it wrote (per block, ``C S``
    rows; :func:`~.common.stamp_breakdown`)."""
    return stamp_breakdown(stamps, pass_names(level, kind), STAMP_WIDTH)


# ------------------------------------------------------------------ the library
@functools.lru_cache(maxsize=None)
def load_library(stamps: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library, or with
    ``stamps`` their stamps build; raises where the library's layout differs
    from this module's."""
    lib = open_library(SOURCE_NAME, STAMPS_FLAGS if stamps else ())
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    for fn in (lib.mgmc_smem3d_params_size, lib.mgmc_smem3d_stamp_width,
               lib.mgmc_smem3d_stamps_build, lib.mgmc_smem3d_head_ints,
               lib.mgmc_smem3d_max_threads, lib.mgmc_smem3d_static_smem):
        fn.argtypes = []
        fn.restype = i32
    if lib.mgmc_smem3d_stamps_build() != int(stamps):
        raise RuntimeError("the 3d smem visit library is not the build asked for")
    if lib.mgmc_smem3d_params_size() != ctypes.sizeof(SmemVolumeParams):
        raise RuntimeError("SmemVolumeParams layout differs between Python and CUDA")
    if (lib.mgmc_smem3d_stamp_width(), lib.mgmc_smem3d_head_ints(),
            lib.mgmc_smem3d_max_threads()) != (STAMP_WIDTH, HEAD_INTS, MAX_THREADS):
        raise RuntimeError("the 3d smem visit kernels' stamps, heads or block bound differ "
                           "between Python and CUDA")
    static = lib.mgmc_smem3d_static_smem()
    if not 0 <= static <= STATIC_SMEM:
        raise RuntimeError(f"the 3d smem visit kernels declare {static} bytes of static shared "
                           f"memory, more than the {STATIC_SMEM} the layout keeps")
    lib.mgmc_smem3d_smem_bytes.argtypes = [i32] * 6  # Z, Y, W, S, PP, c_shared
    lib.mgmc_smem3d_smem_bytes.restype = i32
    lib.mgmc_smem3d_kernel_attributes.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.mgmc_smem3d_kernel_attributes.restype = i32
    # descend, kmax, threads, bytes
    lib.mgmc_smem3d_blocks_per_sm.argtypes = [i32] * 4
    lib.mgmc_smem3d_blocks_per_sm.restype = i32
    # descend, kmax, S, threads, bytes, out clusters
    lib.mgmc_smem3d_max_active.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.mgmc_smem3d_max_active.restype = i32
    # P, tables, x, f, scratch, fc (descend) or xc (ascend), coeffs, ns, B, Y0, W0, Y1, W1,
    # xilr, sroot, xi, kmax, threads, bytes, stamps, stream
    for fn in (lib.mgmc_smem3d_descend, lib.mgmc_smem3d_ascend):
        # ..., kmax, threads, bytes, stamps, boxes0, boxes1, stream
        fn.argtypes = [ctypes.POINTER(SmemVolumeParams)] + [ptr] * 15 + [i32] * 3 + [ptr] * 4
        fn.restype = i32
    return lib


# ------------------------------------------------------------------- the route
def route_config(vshape, form: int, ndir: int, C: int) -> Optional[Tuple[int, bool, int]]:
    """``(S, c_shared, threads)`` of a visit of ``C`` chains on a level
    of shape ``vshape``, stencil form and sweeps per visit where
    :data:`SMEM3D_ROUTES` gives it these kernels; ``None`` where the table
    leaves the visit to the phase kernels."""
    rows = SMEM3D_ROUTES.get(tuple(int(v) for v in vshape) + (int(form), int(ndir)), ())
    for least, most, S, c_shared, threads in rows:
        if C >= least and (most is None or C <= most):
            return S, c_shared, threads
    return None


def blocks_by_smem(nbytes: int) -> int:
    """Blocks of ``nbytes`` of dynamic shared memory (and the static part) one
    SM holds by its shared memory."""
    return mv.SM_SHARED_BYTES // (int(nbytes) + STATIC_SMEM + mv.BLOCK_RESERVED_BYTES)


def placement(level, S: int) -> Tuple[bool, int]:
    """``(c_shared, threads)`` of clusters of ``S`` where the table does not
    give them (a launch that names its cluster size): threads
    :data:`SMEM_ALONE_THREADS` where the slab of ``x`` alone leaves room for
    one block an SM, else half as many (64 registers a thread: two blocks an
    SM); ``c`` (and ``r``) in shared memory where that keeps as many blocks an
    SM as the registers and the slab of ``x`` allow, the low-rank scratch of a
    level of more than ``LANE_SLOTS`` measurements counted with both
    (``mgmc_visit.lowrank_scratch_bytes``)."""
    Z, Y, W = (int(v) for v in level.op.vshape)
    alone = blocks_by_smem(smem_bytes(Z, Y, W, S, False)) <= 1
    threads = min(SMEM_ALONE_THREADS if alone else SMEM_ALONE_THREADS // 2, MAX_THREADS)
    lowrank = mv.lowrank_scratch_bytes(level.op.m_lowrank, threads)
    by_regs = mv.SM_REGISTERS // (REGISTERS * threads)
    keep = min(by_regs, blocks_by_smem(smem_bytes(Z, Y, W, S, False) + lowrank))
    with_c = smem_bytes(Z, Y, W, S, True) + lowrank
    return (with_c + STATIC_SMEM <= ss.CPU_SMEM_LIMIT and blocks_by_smem(with_c) >= keep,
            threads)



def fits(level, S: int, c_shared: bool, threads: int) -> bool:
    """Whether a block of clusters of ``S`` with ``threads`` (and ``c`` in
    shared memory or not) holds its slab and the level's low-rank scratch
    under the shared memory the card grants a block."""
    Z, Y, W = (int(v) for v in level.op.vshape)
    need = (smem_bytes(Z, Y, W, S, c_shared) + mv.lowrank_scratch_bytes(level.op.m_lowrank, threads)
            + STATIC_SMEM)
    return need <= ss.smem_limit_of(level.op.device)


@functools.lru_cache(maxsize=None)
def _max_active(device, descend: int, km: int, S: int, threads: int, nbytes: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = load_library().mgmc_smem3d_max_active(descend, km, S, threads, nbytes,
                                                    ctypes.byref(out))
    return int(out.value) if err == 0 else 0


def active_clusters(level, S: int, c_shared: bool, threads: int) -> int:
    """Clusters of ``S`` blocks the card holds at once, the fewer of the
    descend and the ascend kernel's (``cudaOccupancyMaxActiveClusters``); on
    the CPU every cluster counts as running at once."""
    device = torch.device(level.op.device)
    if device.type != "cuda":
        return 1 << 30
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    Z, Y, W = (int(v) for v in level.op.vshape)
    nbytes = (smem_bytes(Z, Y, W, S, c_shared)
              + mv.lowrank_scratch_bytes(level.op.m_lowrank, threads))
    km = kmax(level.stencil_form)
    return min(_max_active(device, kind, km, S, threads, nbytes) for kind in (1, 0))


def smem_cluster(level, C: int) -> Optional[int]:
    """The cluster size of a launch of ``C`` chains: the table's
    (:func:`route_config`), ``None`` where it does not list the visit or
    where its configuration's slab and the level's low-rank scratch do not
    fit a block (:func:`fits`: a level of many measurements), so that the
    visit takes the phase kernels."""
    conf = route_config(level.op.vshape, level.stencil_form, level.ndir, C)
    return None if conf is None or not fits(level, *conf) else conf[0]


# ------------------------------------------------------------------ the launch
class SmemLayout:
    """One launch configuration of a level: the tables on the device, the
    fields of :class:`SmemVolumeParams` beside the directions' blocks, the
    block size and the dynamic shared memory."""

    def __init__(self, level, orders, S: int, c_shared: bool, threads: int):
        Z, Y, W = (int(v) for v in level.op.vshape)
        t = visit_tables(level, orders, S)
        self.tables = torch.from_numpy(t["words"]).to(level.op.device)
        self.S, self.c_shared, self.threads = int(S), bool(c_shared), int(threads)
        self.nbytes = (smem_bytes(Z, Y, W, S, c_shared)
                       + mv.lowrank_scratch_bytes(level.op.m_lowrank, threads))
        self.kmax = kmax(level.stencil_form)
        self.fields = {"ndir": len(orders), "S": int(S), "PX": t["PX"], "PP": t["PP"],
                       "nz_max": -(-Z // S), "c_shared": int(c_shared), "margin": t["margin"],
                       "planes": t["planes"]}
        self.soff = [int(dz) * t["PP"] + int(dy) * t["PX"] + int(dx)
                     for dz, dy, dx in level.op.offsets]
        self.cval = [float(v) for v in t["cval"]]

    def params(self, level, C: int, orders, f_batched: bool, noise_mode: int):
        P = SmemVolumeParams()
        for d, order in enumerate(orders):
            P.v[d] = level._build_params(C, order, f_batched, noise_mode)
        for name, value in self.fields.items():
            setattr(P, name, value)
        # offsets from K to the kernel's size stay (0, 0, 0) with coefficient 0
        # and no plane: each adds +-0 at the centre
        for k, (off, c) in enumerate(zip(self.soff, self.cval)):
            P.soff[k], P.cval[k] = off, c
        return P


def layout(level, orders, S: Optional[int] = None, c_shared: Optional[bool] = None,
           threads: Optional[int] = None, C: int = 1) -> SmemLayout:
    """The level's launch configuration for the sweep ``orders``: the table's
    for ``C`` chains (:func:`route_config`), each item replaced where named; a
    cluster size the table does not give takes :func:`placement`'s ``c`` and
    block size; kept per configuration on the level."""
    orders = mv._as_orders(orders)
    conf = route_config(level.op.vshape, level.stencil_form, len(orders), C)
    if S is None:
        if conf is None:
            raise ValueError(f"the table lists no smem launch of {C} chains on a "
                             f"{tuple(level.op.vshape)} level; name the cluster size")
        S = conf[0]
    S = int(S)
    rule_c, rule_threads = conf[1:] if conf is not None and conf[0] == S else placement(level, S)
    c_sh = rule_c if c_shared is None else bool(c_shared)
    threads = rule_threads if threads is None else int(threads)
    key = (orders, S, c_sh, threads)
    cache = level.__dict__.setdefault("_smem_layouts", {})
    if key not in cache:
        cache[key] = SmemLayout(level, orders, S, c_sh, threads)
    return cache[key]


def launch(level, kind: str, P, L: SmemLayout, f, x, coarse, xi, xi_lr, stamps, stream) -> int:
    """One launch of ``kind`` with the parameter block ``P`` (its Philox
    stream set) and the configuration ``L``; ``coarse`` is ``f_c`` (written)
    or ``x_c`` (read).  Returns the CUDA error."""
    descend = kind == "descend"
    orders = level.orders(kind)
    noise = P.v[0].noise_mode != 0
    scratch = torch.empty_like(x) if (not L.c_shared and (noise or descend)) else x
    factors = [level._woodbury[order][:2] for order in orders] + [(None, None)]
    lib = load_library(stamps is not None)
    fn = lib.mgmc_smem3d_descend if descend else lib.mgmc_smem3d_ascend
    return fn(ctypes.byref(P), L.tables.data_ptr(), x.data_ptr(), f.data_ptr(),
              scratch.data_ptr(), coarse.data_ptr(), level.coeffs.data_ptr(),
              level.noise_scale.data_ptr(), _ptr(level.B), _ptr(factors[0][0]),
              _ptr(factors[0][1]), _ptr(factors[1][0]), _ptr(factors[1][1]), _ptr(xi_lr),
              _ptr(level.sigma_sqrt), _ptr(xi), L.kmax, L.threads, L.nbytes, _ptr(stamps),
              *mv.box_pointers(level, orders), stream)
