"""The 2d level visits with each chain's field in shared memory: the
``"smem"`` route of :func:`~.mgmc_visit.visit_route`
(``csrc/mgmc_visit_smem.cu``).

Replace, for the squared shifted-Laplace prior's 13-point levels and the 5x5
box of its Galerkin levels (stencil forms 6-9), and for the reach-1 levels of
two sweeps a visit (SSOR; forms 0-5: the FD prior's 5-point level, the 3x3 box
of its Galerkin levels) that :data:`SMEM_CHAINS` lists, ``descend_visit`` /
``ascend_visit`` of ``multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py``, and
compute what the phase kernels' reach-2 and reach-1 builds compute (the same
parameter block per sweep direction - a reach-1 level's ``VisitParams``
widened to the ``WideVisitParams`` the kernels take, :func:`widen` -, the
same noise modes, one or two sweeps).  A cluster of ``S`` blocks holds one chain: block ``k`` its band of
rows (:func:`~.mgmc_visit.split_bands`) with a zero halo two deep, the rows
beyond a cut read from the neighbour's shared memory; ``S = 1`` where the
chain fits one block.  The rhs ``c`` and the residual sit in shared memory
where :func:`placement` says so, else in a scratch field.  Each thread takes
its points from the tables of :func:`visit_tables`: colour after colour, first
the interior points (the coefficients as scalars, the stencil inside the
band), then the edge points, each part dealt round the 32 banks.

Here: the tables and the parameter block (:func:`visit_tables`,
:func:`interior_plan`, :class:`SmemVisitParams`), the shared-memory size's
mirror (:func:`smem_bytes`), the barriers and the stamps' passes
(:func:`barrier_count`, :func:`pass_names`, :func:`pass_times`), the library
(:func:`load_library`, and its stamps build), the rules of the route
(:data:`SMEM_CHAINS`, :func:`smem_cluster`, :func:`placement`) and the launch
(:func:`launch`).
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
from .common import open_library, sm_count, stamp_breakdown
from .common import tensor_ptr as _ptr

#: the CUDA source under ``csrc/``
SOURCE_NAME = "mgmc_visit_smem"
#: the zero halo of a band: the stencils' reach (``SMEM_HALO``)
HALO = 2
#: the largest cluster (``SMEM_MAX_CLUSTER``) and the sizes the rule tries
MAX_CLUSTER = 16
CLUSTER_SIZES = (16, 8, 4, 2, 1)
#: ints of the tables' head per (direction, rank): the ``n_order + 1`` starts
#: of the colours' entries, then each colour's interior points
#: (``SMEM_HEAD_INTS``)
HEAD_INTS = 2 * mv.WIDE_MAX_COLORS + 1
#: int64 words per block of the stamps (``SMEM_STAMP_WIDTH``): the timer at
#: entry, after the copy-in, after up to ``MAX_COLORS + 2`` barriers of each
#: direction and the descend's 3, at exit, the barriers passed, the SM
STAMP_WIDTH = 1 + 1 + mv.MAX_DIRS * (mv.WIDE_MAX_COLORS + 2) + 3 + 3
#: the kernels' block bound (``SMEM_VISIT_MAX_THREADS``): 64 registers a
#: thread, two blocks of 512 an SM
MAX_THREADS = 1024
#: registers a thread under that bound
REGISTERS = 64
#: the kernels' static shared memory: a band's share of ``B^T x``, a slot of
#: ``LANE_SLOTS`` floats per warp, the barrier count and the stamps pointer (a
#: level of more measurements takes its scratch after the band:
#: ``mgmc_visit.lowrank_scratch_bytes``)
STATIC_SMEM = 4 * (mv.LANE_SLOTS + 32 * mv.LANE_SLOTS) + 16
#: entries pack (padded index << 16) | field index
INDEX_LIMIT = 1 << 16

#: Per level shape, stencil form and sweeps per visit ``(H, W, form, ndir)``
#: the chain counts ``(least, most)`` (``most`` None: no upper bound) at which
#: a visit takes these kernels; a level not listed takes the phase kernels
#: (reach 2) or the reach-1 routes (split, stream, phase; a reach-1 level of
#: one sweep is never listed).  The reach-2 entries are set from the
#: ``smem_routes`` table of ``chip_smoke.py`` (phase ``biharmonic``): device ms
#: per descend plus ascend of both routes at 1, 16 and 256 chains on the
#: biharmonic posterior's 255^2 13-point and 127^2 25-point levels, one and two
#: sweeps.  The reach-1 entries, two sweeps, from its ``ssor_table``
#: (``--phases ssor_table``): device ms per descend plus ascend of the phase,
#: split and smem routes at 1, 4, 8, 16, 32, 64, 128 and 256 chains on the
#: flagship's 255^2 5-point and 127^2 3x3-box levels; the smem kernels took
#: the least at every count on both (255^2: 0.0661 against split 0.0746 at one
#: chain, 0.7913 against phase 1.1002 at 256; 127^2: 0.0788 against 0.0995,
#: 0.1246 against phase 0.1270 at 128, 0.1932 against 0.2432 at 256).  NVIDIA
#: H100 80GB HBM3, 700.00 W; ``PERF.md`` section 6 holds both tables.
SMEM_CHAINS: Dict[Tuple[int, int, int, int], Tuple[int, Optional[int]]] = {
    (255, 255, 7, 1): (1, None), (255, 255, 7, 2): (1, None),
    (127, 127, 9, 1): (1, None), (127, 127, 9, 2): (1, None),
    (255, 255, 0, 2): (1, None), (127, 127, 2, 2): (1, None)}

#: Threads per block: this many where a block's band leaves no room for a
#: second on its SM, else half as many, two blocks an SM (the block-size and
#: placement table of ``chip_smoke.py --phases smem_table``); at most the
#: kernel's bound (:data:`MAX_THREADS`).
SMEM_ALONE_THREADS = 1024


class SmemVisitParams(ctypes.Structure):
    """Mirror of ``struct SmemVisitParams`` in ``csrc/mgmc_visit_smem.cu``:
    a ``WideVisitParams`` per sweep direction and their number, the cluster
    size, the padded pitch, the widest band, whether ``c`` lies in shared
    memory, the interior margin, the padded offsets, the interior
    coefficients and the planes that vary."""

    _fields_ = [("v", mv.WideVisitParams * mv.MAX_DIRS), ("ndir", ctypes.c_int),
                ("S", ctypes.c_int), ("PX", ctypes.c_int), ("nb_max", ctypes.c_int),
                ("c_shared", ctypes.c_int), ("margin", ctypes.c_int),
                ("soff", ctypes.c_int * mv.WIDE_MAX_OFFSETS),
                ("cval", ctypes.c_float * mv.WIDE_MAX_OFFSETS), ("planes", ctypes.c_uint)]


# ------------------------------------------------------------------ the layout
def pitch(W: int) -> int:
    """A padded row: ``W`` and two zero columns a side."""
    return int(W) + 2 * HALO


def smem_bytes(H: int, W: int, S: int, c_shared: bool) -> int:
    """Dynamic shared memory of one block with clusters of ``S`` on an ``H x
    W`` level: the widest band of ``x`` padded with two rows and columns a
    side and, with ``c_shared``, its rows of ``c`` and ``r``; the host's
    mirror of ``mgmc_smem_visit_smem_bytes``.  ``ValueError`` where the level
    does not split so (``S`` outside 1 .. 16, a band of fewer than two
    rows)."""
    if not 1 <= S <= MAX_CLUSTER or H // S < HALO:
        raise ValueError(f"a level of {H} rows does not split over {S} blocks")
    nb = -(-int(H) // S)
    return 4 * ((nb + 2 * HALO) * pitch(W) + (nb * int(W) if c_shared else 0))


def fits_indices(H: int, W: int, S: int) -> bool:
    """Whether the tables' 16-bit indices hold the level: every field index
    and every padded index of the widest band below :data:`INDEX_LIMIT`."""
    nb = -(-int(H) // S)
    return int(H) * int(W) <= INDEX_LIMIT and (nb + 2 * HALO) * pitch(W) <= INDEX_LIMIT


def kmax(form: int) -> int:
    """The stencil size a form's kernel is compiled for: 5 (reach 1 up to 5
    offsets, forms 0, 1), 9 (the 3x3 box and any other reach-1 stencil, forms
    2-5), 13 (forms 6, 7), 25 (the 5x5 box, 8, 9)."""
    if not 0 <= form < mv.WIDE_FORM0 + mv.WIDE_FORMS:
        raise ValueError(f"the 2d smem kernels take the forms 0-9, not form {form}")
    if form < mv.WIDE_FORM0:
        return 5 if form < 2 else 9
    return 13 if form < 8 else 25


def widen(P) -> "mv.WideVisitParams":
    """A level's parameter block as the kernels take it: a reach-2 level's
    ``WideVisitParams`` as it is, a reach-1 level's ``VisitParams`` (9 offsets,
    8 colours) copied field by field into one (the offsets and colours beyond
    stay 0: a kernel reads ``K`` offsets and ``n_order`` colours)."""
    if isinstance(P, mv.WideVisitParams):
        return P
    Q = mv.WideVisitParams()
    for name, _ in mv.VisitParams._fields_:
        value = getattr(P, name)
        if isinstance(value, ctypes.Array):
            target = getattr(Q, name)
            for k, item in enumerate(value):
                if isinstance(item, ctypes.Array):
                    for q, v in enumerate(item):
                        target[k][q] = v
                else:
                    target[k] = item
        else:
            setattr(Q, name, value)
    return Q


def interior_plan(level) -> dict:
    """What the level's coefficient planes give the kernels: ``cval``, the
    interior coefficients (the centre point's, float32); ``plain``, per point
    whether every coefficient whose neighbour lies in the field equals them;
    ``margin``, the least distance from the field's edge from which on every
    point is plain; ``planes``, bit ``k`` where coefficient ``k`` differs from
    ``cval[k]`` at a point whose neighbour ``k`` lies in the field (elsewhere
    it multiplies the zero halo)."""
    op = level.op
    H, W = (int(v) for v in op.vshape)
    K, n = len(op.offsets), H * W
    c = level.coeffs.detach().cpu().to(torch.float32).numpy().reshape(K, n)
    cval = c[:, (H // 2) * W + W // 2].copy()
    ii, jj = (g.reshape(-1) for g in np.meshgrid(np.arange(H), np.arange(W), indexing="ij"))
    inside = np.stack([(ii + dy >= 0) & (ii + dy < H) & (jj + dx >= 0) & (jj + dx < W)
                       for dy, dx in op.offsets])
    plain = np.all((c == cval[:, None]) | ~inside, axis=0)
    dist = np.minimum(np.minimum(ii, H - 1 - ii), np.minimum(jj, W - 1 - jj))
    margin = int(dist[~plain].max()) + 1 if (~plain).any() else 0
    varies = np.any((c != cval[:, None]) & inside, axis=1)
    return {"cval": cval, "plain": plain, "margin": margin,
            "planes": int(sum(1 << int(k) for k in np.flatnonzero(varies)))}


def visit_tables(level, orders, S: int) -> dict:
    """The tables of a launch with the sweep ``orders`` and clusters of ``S``:

    * ``words``: int32, the heads, then the entries.  Head ``(d, k)`` (at
      ``(d S + k) HEAD_INTS``): the starts of the colours of order ``d`` in
      the band of rank ``k`` (``n_order + 1`` word indices into ``words``),
      then from word ``MAX_COLORS + 1`` on each colour's interior points.
      An entry is ``(q << 16) | p``: ``q`` the point's index in the band's
      padded rows (band row ``r``, column ``j``: ``(r + 2) PX + j + 2``),
      ``p`` its field index;
    * within a colour the interior points first - every coefficient is the
      interior value (:func:`interior_plan`) and every row the stencil reads
      lies in the band or outside the field - then the edge points, each part
      dealt round the banks (``sor_sweep.bank_order``);
    * ``entries[d][k]``, ``starts[d][k]``, ``interior[d][k]``: the same per
      (direction, rank), starts relative to the band's first entry, and each
      colour's interior points;
    * the level's :func:`interior_plan` and ``PX``, the padded pitch."""
    orders = mv._as_orders(orders)
    H, W = (int(v) for v in level.op.vshape)
    if not fits_indices(H, W, S):
        raise ValueError(f"a {H}x{W} level over {S} blocks exceeds the tables' 16-bit indices")
    plan = interior_plan(level)
    PX, n = pitch(W), H * W
    ii, jj = (g.reshape(-1) for g in np.meshgrid(np.arange(H), np.arange(W), indexing="ij"))
    w0, w1 = (int(w) for w in level.coloring.weights[-2:])
    colour = (w0 * ii + w1 * jj) % level.coloring.n_colors
    dys = sorted({int(dy) for dy, _ in level.op.offsets})
    heads = np.zeros((len(orders), S, HEAD_INTS), np.int32)
    parts, pos = [], len(orders) * S * HEAD_INTS
    out = {"entries": [], "starts": [], "interior": []}
    for d, order in enumerate(orders):
        for key in out:
            out[key].append([])
        for k, (u0, u1) in enumerate(mv.split_bands(H, S)):
            band = (ii >= u0) & (ii < u1)
            cut = np.zeros(n, bool)
            for dy in dys:
                r = ii + dy
                cut |= ((r >= 0) & (r < u0)) | ((r >= u1) & (r < H))
            plain = plan["plain"] & ~cut
            q = (ii - u0 + HALO) * PX + jj + HALO
            band_entries, starts, nplain = [], [0], []
            for o, col in enumerate(order):
                sel = band & (colour == int(col))
                a, b = np.flatnonzero(sel & plain), np.flatnonzero(sel & ~plain)
                idx = np.concatenate([a[ss.bank_order(q[a])], b[ss.bank_order(q[b])]])
                heads[d, k, o] = pos + starts[-1]
                heads[d, k, mv.WIDE_MAX_COLORS + 1 + o] = a.size
                nplain.append(int(a.size))
                starts.append(starts[-1] + int(idx.size))
                band_entries.append((q[idx] << 16) | idx)
            heads[d, k, len(order)] = pos + starts[-1]
            entries = np.concatenate(band_entries).astype(np.int64)
            parts.append(entries)
            pos += entries.size
            out["entries"][d].append(entries)
            out["starts"][d].append(starts)
            out["interior"][d].append(nplain)
    words = np.concatenate([heads.reshape(-1).astype(np.int64)] + parts)
    out["words"] = words.astype(np.uint32).view(np.int32)
    return {**plan, **out, "PX": PX}


# ------------------------------------------------------------ barriers, stamps
def barrier_count(level, kind: str) -> int:
    """Barriers of one launch as ``csrc/mgmc_visit_smem.cu`` places them: an
    ascend's copy-in (after its first rhs, drawn while the copy lands; a
    descend's copy lands behind its first rhs barrier); per sweep direction
    the rhs, each colour and (``m > 0``) the bands' shares of ``B^T x``; then
    a descend 3 (the corrected ``x``, the residual, the end) and an ascend 1
    (the corrected ``x``).  The stamps build counts them on the card."""
    share = 1 if level.op.m_lowrank else 0
    return (sum(1 + len(order) + share for order in level.orders(kind))
            + (3 if kind == "descend" else 2))


def pass_names(level, kind: str):
    """The passes of a launch in the order the stamps time them (each ends
    with a barrier); a two-sweep visit names its directions' passes ``d0:
    ...`` and ``d1: ...`` (a later direction's rhs pass holds the previous
    one's Woodbury patch)."""
    orders, m = level.orders(kind), level.op.m_lowrank
    names = []
    for d, order in enumerate(orders):
        first = (["rhs + copy-in", "prolongation"] if kind == "ascend" and d == 0
                 else ["copy-in + rhs"] if d == 0
                 else ["Woodbury + rhs"] if m else ["rhs"])
        own = first + [f"colour {c}" for c in order] + (["B^T x shares"] if m else [])
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
    for fn in (lib.mgmc_smem_visit_params_size, lib.mgmc_smem_visit_stamp_width,
               lib.mgmc_smem_visit_stamps_build, lib.mgmc_smem_visit_head_ints,
               lib.mgmc_smem_visit_max_threads, lib.mgmc_smem_visit_static_smem):
        fn.argtypes = []
        fn.restype = i32
    if lib.mgmc_smem_visit_stamps_build() != int(stamps):
        raise RuntimeError("the smem visit library is not the build asked for")
    if lib.mgmc_smem_visit_params_size() != ctypes.sizeof(SmemVisitParams):
        raise RuntimeError("SmemVisitParams layout differs between Python and CUDA")
    if (lib.mgmc_smem_visit_stamp_width(), lib.mgmc_smem_visit_head_ints(),
            lib.mgmc_smem_visit_max_threads()) != (STAMP_WIDTH, HEAD_INTS, MAX_THREADS):
        raise RuntimeError("the smem visit kernels' stamps, heads or block bound differ "
                           "between Python and CUDA")
    static = lib.mgmc_smem_visit_static_smem()
    if not 0 <= static <= STATIC_SMEM:
        raise RuntimeError(f"the smem visit kernels declare {static} bytes of static shared "
                           f"memory, more than the {STATIC_SMEM} the layout keeps")
    lib.mgmc_smem_visit_smem_bytes.argtypes = [i32] * 5  # H, W, S, PX, c_shared
    lib.mgmc_smem_visit_smem_bytes.restype = i32
    lib.mgmc_smem_visit_kernel_attributes.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.mgmc_smem_visit_kernel_attributes.restype = i32
    # descend, kmax, threads, bytes
    lib.mgmc_smem_visit_blocks_per_sm.argtypes = [i32] * 4
    lib.mgmc_smem_visit_blocks_per_sm.restype = i32
    # descend, kmax, S, threads, bytes, out clusters
    lib.mgmc_smem_visit_max_active.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.mgmc_smem_visit_max_active.restype = i32
    # P, tables, x, f, scratch, fc (descend) or xc (ascend), coeffs, ns, B, Y0, W0, Y1, W1,
    # xilr, sroot, xi, kmax, threads, bytes, stamps, stream
    for fn in (lib.mgmc_smem_descend, lib.mgmc_smem_ascend):
        # ..., kmax, threads, bytes, stamps, boxes0, boxes1, stream
        fn.argtypes = [ctypes.POINTER(SmemVisitParams)] + [ptr] * 15 + [i32] * 3 + [ptr] * 4
        fn.restype = i32
    return lib


# ------------------------------------------------------------------- the rules
def blocks_by_smem(nbytes: int) -> int:
    """Blocks of ``nbytes`` of dynamic shared memory (and the static part) one
    SM holds by its shared memory."""
    return mv.SM_SHARED_BYTES // (int(nbytes) + STATIC_SMEM + mv.BLOCK_RESERVED_BYTES)


def placement(level, S: int) -> Tuple[bool, int]:
    """``(c_shared, threads)`` of clusters of ``S`` on ``level``: threads
    :data:`SMEM_ALONE_THREADS` where the band of ``x`` alone leaves room for
    one block an SM, else half as many (64 registers a thread: two blocks an
    SM), at most the kernel's bound; ``c`` (and ``r``) in shared memory where
    that keeps as many blocks an SM as the registers and the band of ``x``
    allow, the low-rank scratch of a level of more than ``LANE_SLOTS``
    measurements counted with both (``mgmc_visit.lowrank_scratch_bytes``)."""
    H, W = (int(v) for v in level.op.vshape)
    alone = blocks_by_smem(smem_bytes(H, W, S, False)) <= 1
    threads = min(SMEM_ALONE_THREADS if alone else SMEM_ALONE_THREADS // 2, MAX_THREADS)
    lowrank = mv.lowrank_scratch_bytes(level.op.m_lowrank, threads)
    by_regs = mv.SM_REGISTERS // (REGISTERS * threads)
    keep = min(by_regs, blocks_by_smem(smem_bytes(H, W, S, False) + lowrank))
    with_c = smem_bytes(H, W, S, True) + lowrank
    return (with_c + STATIC_SMEM <= ss.CPU_SMEM_LIMIT and blocks_by_smem(with_c) >= keep,
            threads)



@functools.lru_cache(maxsize=None)
def _max_active(device, descend: int, km: int, S: int, threads: int, nbytes: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = load_library().mgmc_smem_visit_max_active(descend, km, S, threads, nbytes,
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
    H, W = (int(v) for v in level.op.vshape)
    nbytes = smem_bytes(H, W, S, c_shared) + mv.lowrank_scratch_bytes(level.op.m_lowrank,
                                                                       threads)
    km = kmax(level.stencil_form)
    return min(_max_active(device, kind, km, S, threads, nbytes) for kind in (1, 0))


def candidates(level, smem_limit: Optional[int] = None) -> Dict[int, Tuple[bool, int]]:
    """``{S: (c_shared, threads)}`` of the cluster sizes whose bands, with the
    low-rank scratch of a level of more than ``LANE_SLOTS`` measurements
    (``mgmc_visit.lowrank_scratch_bytes``), fit a block (:func:`placement`) and the tables'
    indices; a level none fits takes the phase kernels."""
    H, W = (int(v) for v in level.op.vshape)
    limit = ss.smem_limit_of(level.op.device) if smem_limit is None else int(smem_limit)
    out = {}
    for S in CLUSTER_SIZES:
        if H // S < HALO or not fits_indices(H, W, S):
            continue
        c_sh, threads = placement(level, S)
        lowrank = mv.lowrank_scratch_bytes(level.op.m_lowrank, threads)
        if smem_bytes(H, W, S, c_sh) + lowrank + STATIC_SMEM <= limit:
            out[S] = (c_sh, threads)
    return out


def smem_cluster(level, C: int, smem_limit: Optional[int] = None) -> Optional[int]:
    """The cluster size of a launch of ``C`` chains: of :func:`candidates`
    whose clusters schedule, the one of least wave-counted cost
    (``sor_sweep.cheapest_cluster`` with the split visits' fixed share,
    ``mgmc_visit.SPLIT_WAVE_POINTS`` over the level's points), counting as
    running at once the clusters that have an SM a block (``min(active, SMs //
    S)``: blocks that share an SM share its instruction throughput); ``None`` where none
    fits.  On the biharmonic levels every positive fixed share picks the same
    sizes: 16 at one chain, 2 (255^2) and 1 (127^2) at 256 - the best the
    placement table measured."""
    H, W = (int(v) for v in level.op.vshape)
    sms = sm_count(level.op.device)
    active = {S: min(active_clusters(level, S, c_sh, t), sms // S)
              for S, (c_sh, t) in candidates(level, smem_limit).items()}
    return ss.cheapest_cluster(C, active, mv.SPLIT_WAVE_POINTS / (H * W))


# ------------------------------------------------------------------ the launch
class SmemLayout:
    """One launch configuration of a level: the tables on the device, the
    fields of :class:`SmemVisitParams` beside the directions' blocks, the
    block size and the dynamic shared memory."""

    def __init__(self, level, orders, S: int, c_shared: bool, threads: int):
        H, W = (int(v) for v in level.op.vshape)
        t = visit_tables(level, orders, S)
        self.tables = torch.from_numpy(t["words"]).to(level.op.device)
        self.S, self.c_shared, self.threads = int(S), bool(c_shared), int(threads)
        self.nbytes = (smem_bytes(H, W, S, c_shared)
                       + mv.lowrank_scratch_bytes(level.op.m_lowrank, threads))
        self.kmax = kmax(level.stencil_form)
        self.fields = {"ndir": len(orders), "S": int(S), "PX": t["PX"],
                       "nb_max": -(-H // S), "c_shared": int(c_shared), "margin": t["margin"],
                       "planes": t["planes"]}
        self.soff = [int(dy) * t["PX"] + int(dx) for dy, dx in level.op.offsets]
        self.cval = [float(v) for v in t["cval"]]

    def params(self, level, C: int, orders, f_batched: bool, noise_mode: int):
        P = SmemVisitParams()
        for d, order in enumerate(orders):
            P.v[d] = widen(level._build_params(C, order, f_batched, noise_mode))
        for name, value in self.fields.items():
            setattr(P, name, value)
        # offsets from K to the kernel's size stay (0, 0) with coefficient 0 and
        # no plane: each adds +-0 at the centre
        for k, (off, c) in enumerate(zip(self.soff, self.cval)):
            P.soff[k], P.cval[k] = off, c
        return P


def layout(level, orders, S: Optional[int] = None, c_shared: Optional[bool] = None,
           threads: Optional[int] = None, C: int = 1) -> SmemLayout:
    """The level's launch configuration for the sweep ``orders``: clusters of
    ``S`` (default: :func:`smem_cluster` of ``C`` chains), ``c`` in shared
    memory and the block size by the rules unless named; kept per
    configuration on the level."""
    orders = mv._as_orders(orders)
    if S is None:
        S = smem_cluster(level, C)
        if S is None:
            raise ValueError(f"no cluster size holds a {tuple(level.op.vshape)} level")
    S = int(S)
    H, W = (int(v) for v in level.op.vshape)
    rule_c, rule_threads = placement(level, S)
    c_sh = rule_c if c_shared is None else c_shared
    threads = rule_threads if threads is None else int(threads)
    key = (orders, S, bool(c_sh), threads)
    cache = level.__dict__.setdefault("_smem_layouts", {})
    if key not in cache:
        cache[key] = SmemLayout(level, orders, S, bool(c_sh), threads)
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
    fn = lib.mgmc_smem_descend if descend else lib.mgmc_smem_ascend
    return fn(ctypes.byref(P), L.tables.data_ptr(), x.data_ptr(), f.data_ptr(),
              scratch.data_ptr(), coarse.data_ptr(), level.coeffs.data_ptr(),
              level.noise_scale.data_ptr(), _ptr(level.B), _ptr(factors[0][0]),
              _ptr(factors[0][1]), _ptr(factors[1][0]), _ptr(factors[1][1]), _ptr(xi_lr),
              _ptr(level.sigma_sqrt), _ptr(xi), L.kmax, L.threads, L.nbytes, _ptr(stamps),
              *mv.box_pointers(level, orders), stream)
