"""The MGMC coarse subtree as one CUDA kernel launch.

Replaces ``subtree_sample`` / ``SubtreeKernel`` of
``multigridmc_tpu/ops/kernels/mgmc_subtree_pallas.py``.  One call runs, for all
chains, everything below the finest level of an MGMC hierarchy: with the
sub-levels ``l = 0 .. NL-1`` (the hierarchy's levels ``1 .. nlevel-2``) and the
coarsest level ``NL``,

    sample(l):   x_l = 0
                 repeat ``cycle`` times:
                     descend visit of level l   -> f_{l+1}
                     sample(l + 1)
                     ascend visit of level l    (x_l += gamma P x_{l+1}, ...)
    sample(NL):  x = Linv^T (xi + Linv f)       (Linv the inverse Cholesky factor)

where the visits are those of :mod:`.mgmc_visit` (forward Gibbs sweep, Woodbury
with the sweep's low-rank noise, residual, restriction; prolongate-add,
backward Gibbs sweep, Woodbury).  The coarse sample by the inverse factor has the same
law as the triangular solves of ``DenseCholeskySampler`` and, fed the same
normals, the same value up to rounding; the factor is inverted in float64.

The CUDA source is ``csrc/mgmc_subtree.cu`` with the visits of
``csrc/level_passes.cuh`` (one thread block per chain walking a host-made
schedule; the header comments state the design), the passes the phase visit
kernels run too.  At launch start the block
copies the tables of :func:`launch_tables` (the levels' parameter blocks, ``B``
and both directions' ``Y`` inside their bounding boxes, ``W``,
``Sigma^{1/2}``, the sweeps' :func:`colour_rows`) into its shared
memory; each low-rank term is one pass in which the owner of a point adds the
columns that hold it, in column order, the stencil is read with its
coefficients in registers, and the warps take the rows of each colour in turn.
Sub-levels of reach 2 (the squared shifted-Laplace prior's 25-point Galerkin
levels, 9 colours) take a build of their own, the source compiled with
``-DVISIT_REACH=2`` (``common.SUBTREE_REACH2_PARTS``: the production kernel,
its stamps build and a 1024-thread instance, a library each):
parameter blocks of 25 offsets and 9 colours
(:class:`~.mgmc_visit.WideVisitParams`) in the tables, the reach-2 passes of
``level_passes.cuh`` (forms 6-9, the level's form found by the host), the
sweeps from the colours' point lists (:func:`point_tables`), two blocks of
:data:`REACH2_THREADS` an SM (:func:`reach2_limit`); the reach-1 library
stays as it is.  The host decides where each level's three fields (``x``,
the rhs scratch, ``f``) lie (:func:`place_fields`): in dynamic shared memory
after the tables, from the coarsest level upwards while the granted size
(:func:`~.common.dynamic_smem_limit`, less :func:`field_budget`'s shares)
allows, else in a global workspace; the size the launch needs is confirmed with
the probe kernel (:func:`~.common.probe_dynamic_smem`) and
:attr:`SubtreeKernel.placement` says what lies where.

**Bound.**  By bytes the launch must read ``f`` and write ``x`` of the finest
sub-level once per chain (``2 C n_0 4`` bytes); by operations it does
``cycle^(l+1)`` visits of each level ``l``.  The kernel pays the instructions
it executes per point and, on the finest sub-level, the L2's latency.  A descend
is ``n_order + 5`` barrier-separated phases, an ascend ``n_order + 3`` (2 fewer
each without a low-rank term), a coarse sample 2, the table copy 1
(:func:`barrier_count`).  :func:`operation_times` reads where a launch's time
went from its ``stamps``, with the barriers each block passed and the SM it
ran on.

**Shared memory.**  The tables stay in shared memory whatever the placement of
the fields (up to ``LANE_SLOTS`` measurements; more below), so the tables and
the kernel's static share must fit a block's limit: 19,296 B on the flagship's sub-levels (m = 8); at m = 32 (the most the
kernel takes) some 21.5 KB a sub-level, most of it the part that does not
depend on the level's size (two ``W``, the two parameter blocks), so some
172 KB at 8 sub-levels (172,048 B for a 1024^2 lattice of 10 levels with 32
point measurements, the case of ``tests/test_torch_subtree_tables.py``), under
the H100's 232,448 B with the 4,096 B static share.  At reach 2 a parameter
block is 1,552 B (not 1,296 B) and the Woodbury factors' boxes are wider (9
colours of reach 2): the biharmonic posterior's three sub-levels of the 255^2
bench (m = 8) take 61,904 B of tables, which leaves the fields of 63^2 and
below room beside them in one block of an SM; the 4,096 B static share holds
for both builds (``mgmc_subtree_static_smem``, checked at load).  A card with
less raises at construction; on the CPU nothing is launched and the placement
is not probed.  Sub-levels of more than ``LANE_SLOTS`` (32) measurements take
an instance of their own (``wide``): each warp's slot holds ``2 m`` floats
and the block's ``m``-vector follows the slots (:func:`slot_words`,
``csrc/visit_phases.cuh``), each level's boxes are staged after its
``Sigma^{1/2}``, and where the tables do not fit a block (each sub-level's two
``W`` are ``m^2`` floats: 256 KiB each at m = 256) they stay in the table
tensor, read there by every pass, and only the slots and the vector lie at
the front of shared memory (:attr:`SubtreeKernel.tables_shared`).

Beside the kernel stands its **plain PyTorch version**
(:func:`subtree_sample_plain`), the same schedule walked with
``descend_visit_plain`` / ``ascend_visit_plain`` and two matrix products for the
coarse sample, taking all normals as one tensor.  :func:`subtree_sample` takes
the plain version only for tensors that lie on the CPU; for a CUDA tensor it
launches the kernel or raises.

Noise: off, the in-kernel Philox generator (``philox=(seed, first counter)``,
one launch counter per draw, see ``csrc/mgmc_subtree.cu``), or all normals from
one tensor ``xi`` of shape ``(C, K)`` with ``K = kernel.count_noise()`` normals
per chain in draw order: per sweep the field (``n_l``) then the ``m`` low-rank
scalars, per coarse sample ``n_c``.  That is the order in which the composed
recursion draws, so the same draws give the same step.

Supported: 2d, float32 on the card (the plain version runs in any dtype), SOR
with one pre- and one post-sweep per visit, sub-levels of one reach, 1 (up to 9
offsets, 8 colours) or 2 (at most 13 offsets or the 5x5 box in raster order, 9
colours), any ``m`` whose slots a block holds, up to 8 sub-levels, a dense Cholesky factor of the
coarsest level.  Reach 3 and above raise before any launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.linalg
import torch

from .common import (DEFAULT_SMEM_BYTES, SUBTREE_REACH2_PARTS, default_threads,
                     dynamic_smem_limit, open_library, probe_dynamic_smem)
from .common import tensor_ptr as _ptr
from .mgmc_visit import (LANE_SLOTS, FusedVisitLevel, TableWords, VisitParams,  # noqa: F401
                         WideVisitParams, ascend_visit_plain, colour_rows, descend_visit_plain,
                         stage_level)

MAX_SUB_LEVELS = 8

#: the CUDA source under ``csrc/`` (see :mod:`.common` for the build)
SOURCE_NAME = "mgmc_subtree"

#: operations of the schedule (``csrc/mgmc_subtree.cu``)
OP_DESCEND, OP_DESCEND_ZERO, OP_COARSE, OP_ASCEND = 0, 1, 2, 3
#: where a field lies
LOC_SHARED, LOC_WORKSPACE, LOC_LAUNCH = 0, 1, 2
LOC_NAMES = {LOC_SHARED: "shared", LOC_WORKSPACE: "workspace", LOC_LAUNCH: "launch tensor"}
OP_NAMES = {OP_DESCEND: "descend", OP_DESCEND_ZERO: "descend", OP_COARSE: "coarse",
            OP_ASCEND: "ascend"}

#: shared memory the kernel declares statically (the level's parameter block
#: and the reduction scratch), kept out of the dynamic budget
STATIC_SMEM_RESERVE = 4096

#: largest block size.  Measured on an NVIDIA H100 80GB HBM3 (700 W) with
#: ``chip_smoke.py`` (``subtree_timing.variants``) at 256 chains below a 255^2
#: level: 512 threads (two blocks per SM, all chains in one wave) take 1.13 ms
#: per launch, 1024 threads (one block per SM) 1.42 ms, 256 threads 1.54 ms.
#: The kernel's ``__launch_bounds__`` admit 1024 (``MAX_THREADS`` of
#: ``csrc/visit_phases.cuh``), which caps a thread at 64 registers, as two
#: blocks of 512 do.
MAX_THREADS = 512
#: largest block size of the reach-2 build, whose production kernel is
#: bounded to 512 threads (128 registers a thread: ``SUBTREE_THREADS`` of
#: ``csrc/mgmc_subtree.cu``; 1024 threads take an instance bounded to 1024, 64
#: registers, which only the measurement launches).  Measured as MAX_THREADS
#: was, on an NVIDIA H100 80GB HBM3 (700 W) with ``chip_smoke.py``
#: (``biharmonic.subtree_timing.variants``) on the biharmonic bench's
#: sub-levels at 256 chains: 512 threads 4.218 device ms a launch, 1024
#: threads 4.258 (160 B spilled a thread), 256 threads 6.495, or 4.320 with
#: the 63^2 fields in the workspace so that two blocks share an SM.
REACH2_MAX_THREADS = 512
#: Block size and placement of a reach-2 launch: two blocks of
#: :data:`REACH2_THREADS` an SM, the fields placed under the share of an SM's
#: shared memory that two blocks leave each (:func:`reach2_limit`; the
#: bench's 63^2 fields go to the workspace).  Since the sweeps take the
#: colours' point lists, measured on an NVIDIA H100 80GB HBM3 (700 W) by
#: ``chip_smoke.py`` (``biharmonic.subtree_timing.variants``) at 256 chains:
#: 1.816 device ms a launch, against 2.156 with one block of 512 threads and
#: every field of 63^2 and below in shared memory (the rule that measured best
#: with the row sweeps), 2.747 with one block of 256.
REACH2_THREADS = 256
REACH2_BLOCKS_PER_SM = 2

#: per reach: the parameter block in the launch tables, and the build's
#: libraries by part (the reach-1 build: one library of every instance; the
#: reach-2 build: ``common.SUBTREE_REACH2_PARTS``)
REACH_BUILDS = {1: (VisitParams, {"production": ()}),
                2: (WideVisitParams, SUBTREE_REACH2_PARTS)}
#: the library part of each reach-2 instance, by its number in the source
PART_NUMBERS = {"production": 0, "stamps": 1, "block1024": 2}

#: words the kernel's stamps hold per block after the schedule's times: the
#: timer at kernel entry and at exit, the barriers passed, the SM
STAMP_EXTRA = 4

#: the name a launch counts under, by the build's reach
KERNEL_NAMES = {1: "subtree_sample", 2: "subtree_sample_reach2"}

#: kernel launches made by the wrapper (and only where it launches)
launch_counts: Dict[str, int] = {name: 0 for name in KERNEL_NAMES.values()}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class FieldLoc(ctypes.Structure):
    _fields_ = [("where", ctypes.c_int), ("pad", ctypes.c_int), ("off", ctypes.c_longlong)]


class SubLevel(ctypes.Structure):
    """Mirror of ``struct SubLevel`` in ``csrc/mgmc_subtree.cu``: the planes read
    per point, where the fields lie, and the word offsets of the level's
    tables in shared memory (:func:`launch_tables`)."""

    _fields_ = [
        ("coeffs", ctypes.c_void_p), ("ns", ctypes.c_void_p),
        ("x", FieldLoc), ("scr", FieldLoc), ("f", FieldLoc),
        ("n", ctypes.c_int), ("plan", ctypes.c_int * 2), ("bval", ctypes.c_int),
        ("boff", ctypes.c_int), ("yval", ctypes.c_int * 2), ("yoff", ctypes.c_int * 2),
        ("wm", ctypes.c_int * 2), ("sroot", ctypes.c_int), ("rows", ctypes.c_int * 2),
        ("pts", ctypes.c_longlong * 2), ("phead", ctypes.c_int * 2),
        ("form", ctypes.c_int), ("pad", ctypes.c_int),
    ]


class SubtreeParams(ctypes.Structure):
    """Mirror of ``struct SubtreeParams`` in ``csrc/mgmc_subtree.cu``."""

    _fields_ = [
        ("C", ctypes.c_int), ("NL", ctypes.c_int), ("n_sched", ctypes.c_int),
        ("noise_mode", ctypes.c_int), ("nc", ctypes.c_int), ("record", ctypes.c_int),
        ("ws_stride", ctypes.c_longlong), ("xi_stride", ctypes.c_longlong),
        ("seed", ctypes.c_ulonglong), ("counter", ctypes.c_ulonglong),
        ("lv", SubLevel * MAX_SUB_LEVELS),
        ("cx", FieldLoc), ("cscr", FieldLoc), ("cf", FieldLoc),
        ("table_words", ctypes.c_int), ("warp_vec", ctypes.c_int),
        ("warp_stride", ctypes.c_int), ("pass_width", ctypes.c_int),
        ("stamps", ctypes.c_void_p), ("pass_stamps", ctypes.c_void_p),
    ]


@functools.lru_cache(maxsize=None)
def load_library(reach: int = 1, part: str = "production") -> ctypes.CDLL:
    """Build (at first use) and load one of the kernel's shared libraries: the
    reach-1 build, or with ``reach=2`` the reach-2 build's library ``part``
    (:data:`REACH_BUILDS`; :func:`launch_library` picks the one a launch
    takes)."""
    if reach not in REACH_BUILDS:
        raise ValueError(f"the subtree kernel has a reach-1 and a reach-2 build, not {reach}")
    params, parts = REACH_BUILDS[reach]
    if part not in parts:
        raise ValueError(f"the reach-{reach} build has the libraries {sorted(parts)}, not {part}")
    lib = open_library(SOURCE_NAME, parts[part])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.mgmc_subtree_params_size, lib.mgmc_subtree_visit_params_size,
               lib.mgmc_subtree_static_smem, lib.mgmc_subtree_reach,
               lib.mgmc_subtree_max_threads, lib.mgmc_subtree_part):
        fn.argtypes = []
        fn.restype = i32
    most = REACH2_MAX_THREADS if reach == 2 else 1024
    number = PART_NUMBERS[part] if reach == 2 else 0
    if (lib.mgmc_subtree_reach(), lib.mgmc_subtree_max_threads(),
            lib.mgmc_subtree_part()) != (reach, most, number):
        raise RuntimeError(f"the library of reach {reach}, part {part} reports reach "
                           f"{lib.mgmc_subtree_reach()}, {lib.mgmc_subtree_max_threads()} "
                           f"threads, part {lib.mgmc_subtree_part()}")
    if lib.mgmc_subtree_params_size() != ctypes.sizeof(SubtreeParams):
        raise RuntimeError("SubtreeParams layout differs between Python and CUDA")
    if lib.mgmc_subtree_visit_params_size() != ctypes.sizeof(params):
        raise RuntimeError(f"{params.__name__} layout differs between Python and CUDA")
    static = lib.mgmc_subtree_static_smem()
    if not 0 <= static <= STATIC_SMEM_RESERVE:
        raise RuntimeError(f"the subtree kernel declares {static} bytes of static shared "
                           f"memory, more than the {STATIC_SMEM_RESERVE} kept for it")
    lib.mgmc_subtree_blocks_per_sm.argtypes = [i32, i32]
    lib.mgmc_subtree_blocks_per_sm.restype = i32
    lib.mgmc_subtree_attributes.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.mgmc_subtree_attributes.restype = i32
    # S, tables, sched, Linv, LinvT, f, x, ws, xi, points, threads, smem_bytes, stream
    # S, tables, sched, Linv, LinvT, f, x, ws, xi, points, threads, smem bytes, wide, stream
    lib.mgmc_subtree_sample.argtypes = (
        [ctypes.POINTER(SubtreeParams)] + [ptr] * 9 + [i32, i32, i32, ptr])
    lib.mgmc_subtree_sample.restype = i32
    return lib


def launch_library(reach: int, stamps: bool, threads: int) -> ctypes.CDLL:
    """The library that holds the instance a launch takes: at reach 2 the
    stamps build for a launch with stamps, the 1024-thread instance above
    :data:`REACH2_MAX_THREADS` threads, else the production kernel."""
    if reach != 2:
        return load_library(reach)
    if stamps and threads > REACH2_MAX_THREADS:
        raise ValueError(f"the reach-2 stamps build takes at most {REACH2_MAX_THREADS} threads")
    return load_library(2, "stamps" if stamps else
                        "block1024" if threads > REACH2_MAX_THREADS else "production")


# ------------------------------------------------------------ host-side plans
def subtree_schedule(n_sub: int, cycle: int) -> List[Tuple[int, int]]:
    """The recursion below the finest level, flattened: ``[(operation,
    sub-level), ...]`` in execution order."""
    sched: List[Tuple[int, int]] = []

    def sample(li: int) -> None:
        if li == n_sub:
            sched.append((OP_COARSE, li))
            return
        for j in range(cycle):
            sched.append((OP_DESCEND_ZERO if j == 0 else OP_DESCEND, li))
            sample(li + 1)
            sched.append((OP_ASCEND, li))

    sample(0)
    return sched


def place_fields(level_sizes: Sequence[int], nc: int, budget_bytes: int):
    """Where the fields of one chain lie.  ``level_sizes`` are the sub-levels'
    point counts (finest first), ``nc`` the coarsest level's; every level has
    three fields (x, rhs scratch, f).  From the coarsest level upwards a
    level's three fields go to dynamic shared memory while ``budget_bytes``
    allows; the others go to the global workspace, except ``x`` and ``f`` of
    the finest sub-level, which are then the launch's own tensors.

    Returns ``(levels, coarse, smem_floats, ws_floats)``: per level and for
    the coarsest the three ``(where, offset in floats)`` pairs."""
    smem = ws = 0
    budget = budget_bytes // 4

    def take_shared(n):
        nonlocal smem
        off = smem
        smem += n
        return (LOC_SHARED, off)

    def take_ws(n):
        nonlocal ws
        off = ws
        ws += n
        return (LOC_WORKSPACE, off)

    shared_ok = 3 * nc <= budget
    coarse = tuple((take_shared if shared_ok else take_ws)(nc) for _ in range(3))
    levels: List[Optional[tuple]] = [None] * len(level_sizes)
    for li in reversed(range(len(level_sizes))):
        n = level_sizes[li]
        shared_ok = shared_ok and smem + 3 * n <= budget  # no level above one that did not fit
        if shared_ok:
            levels[li] = tuple(take_shared(n) for _ in range(3))
        elif li == 0:
            levels[li] = ((LOC_LAUNCH, 0), take_ws(n), (LOC_LAUNCH, 0))
        else:
            levels[li] = tuple(take_ws(n) for _ in range(3))
    return levels, coarse, smem, ws


def point_tables(level: FusedVisitLevel, order) -> dict:
    """The colours' point lists of one sweep direction of a reach-2
    sub-level (``PointTables`` of ``csrc/level_passes.cuh``), from the level's
    float32 coefficient planes:

    * ``entries``: int32, every point once, colour after colour of ``order``:
      ``(i << 16) | j``; within a colour first the *interior* points, whose
      every coefficient whose neighbour lies in the field equals the level's
      interior value (the centre point's), then the others, each part in
      storage order;
    * ``head``: int32, the ``n_order + 1`` starts of the colours in
      ``entries``, then per colour its number of interior points;
    * ``cval``: float32, the interior values, which the launch's parameter
      blocks hold as ``coeff_val`` of every offset."""
    op = level.op
    H, W = (int(v) for v in op.vshape)
    K, n = len(op.offsets), H * W
    if H >= 1 << 15 or W >= 1 << 16:
        raise ValueError(f"a level of {op.vshape} does not fit the point lists' 16-bit indices")
    c = level.coeffs.detach().cpu().to(torch.float32).numpy().reshape(K, n)
    cval = c[:, (H // 2) * W + W // 2].copy()
    ii, jj = (g.reshape(-1) for g in np.meshgrid(np.arange(H), np.arange(W), indexing="ij"))
    inside = np.stack([(ii + dy >= 0) & (ii + dy < H) & (jj + dx >= 0) & (jj + dx < W)
                       for dy, dx in ((int(a), int(b)) for a, b in op.offsets)])
    plain = np.all((c == cval[:, None]) | ~inside, axis=0)
    w0, w1 = (int(w) for w in level.coloring.weights[-2:])
    colour = (w0 * ii + w1 * jj) % level.coloring.n_colors
    p = np.arange(n)
    entries, start, nplain = [], [0], []
    for col in order:
        sel = colour == int(col)
        part = np.concatenate([p[sel & plain], p[sel & ~plain]])
        entries.append((ii[part] << 16) | jj[part])
        nplain.append(int(np.count_nonzero(sel & plain)))
        start.append(start[-1] + part.size)
    return {"entries": np.concatenate(entries).astype(np.int32),
            "head": np.asarray(start + nplain, np.int32), "cval": cval}


def launch_tables(levels: Sequence[FusedVisitLevel]):
    """What the kernel copies into shared memory once per launch, as 32-bit
    words: per sub-level the ``VisitParams`` of both directions (the pre sweep
    of the descend, the post sweep of the ascend; their chain count is not
    read), then per sub-level its tables for both directions as the phase
    visit kernels stage one (``mgmc_visit.stage_level``): both directions'
    ``colour_rows``, ``B_k`` inside ``bbox_k`` and ``Y_k`` of both directions
    inside their ``ybox_k`` (each box row major, column after column, with the
    ``m + 1`` starts of the columns), ``W`` of both directions and
    ``Sigma^{1/2}``, and where the level has more than ``LANE_SLOTS``
    measurements its boxes right after (``m x 4`` int32: ``B``'s, then each
    direction's ``Y``'s; the wide kernel reads them there); then 32 warps'
    slots of :func:`slot_words` words each and, where a level has more than
    ``LANE_SLOTS``, the block's vector of the largest ``m`` words right after
    them.

    Reach-2 sub-levels also get their colours' point lists (:func:`point_tables`):
    the parameter blocks hold the interior values as ``coeff_val`` of every
    offset (a plane's ``coeff_val`` is read nowhere else), the tables each
    direction's ``head``, and the entries go to a table of their own in device
    memory.

    Returns ``(words, offsets, warp_vec, warp_stride, points)``: ``words`` an
    int32 array whose length is a multiple of 4, ``offsets`` per level a dict
    of the word offsets that ``SubLevel`` holds (``plan``, ``yval``, ``yoff``,
    ``wm``, ``rows`` and ``phead`` per direction; ``pts`` per direction the
    offset of its entries in ``points``, -1 for none),
    ``points`` the int32 entries of every reach-2 sub-level, one direction
    after the other."""
    words = TableWords()
    plans = [[lv._build_params(1, order, True, 0) for order in (lv.pre_order, lv.post_order)]
             for lv in levels]
    lists = [[point_tables(lv, order) for order in (lv.pre_order, lv.post_order)]
             if lv.reach == 2 else None for lv in levels]
    for P2, L2 in zip(plans, lists):
        for P, pl in zip(P2, L2 or ()):
            for k, v in enumerate(pl["cval"]):
                P.coeff_val[k] = float(v)
    # first the parameter blocks: 8-byte aligned
    offsets = [{"plan": [words.put(np.frombuffer(bytes(P), np.int32)) for P in P2]}
               for P2 in plans]
    points, used = [], 0
    for lv, off, L2 in zip(levels, offsets, lists):
        orders = (lv.pre_order, lv.post_order)
        off.update(stage_level(words, lv, orders))
        if lv.op.m_lowrank > LANE_SLOTS:  # at sroot + m, where the wide kernel reads them
            for boxes in [lv.bbox] + [lv._woodbury[o][2] for o in orders]:
                words.put(np.asarray(boxes, np.int32).reshape(-1))
        off["pts"], off["phead"] = [-1, -1], [0, 0]
        for d, pl in enumerate(L2 or ()):
            off["phead"][d] = words.put(pl["head"])
            off["pts"][d] = used
            points.append(pl["entries"])
            used += pl["entries"].size
    warp_stride = max([slot_words(lv.op.m_lowrank) for lv in levels] + [1])
    warp_vec = words.put(np.zeros(32 * warp_stride, np.float32))
    most = max(lv.op.m_lowrank for lv in levels)
    if most > LANE_SLOTS:
        words.put(np.zeros(most, np.float32))  # the block's vector
    points = np.concatenate(points) if points else np.zeros(0, np.int32)
    return words.words(), offsets, warp_vec, warp_stride, points


def slot_words(m: int) -> int:
    """Words of one warp's slot for a level of ``m`` measurements: ``m`` (n,
    then u, then t) up to ``LANE_SLOTS``, else ``2 m`` (u and t, n)."""
    return 2 * m if m > LANE_SLOTS else m


def reach2_limit(limit_bytes: int) -> int:
    """The dynamic shared memory a reach-2 block may take: what the card
    grants a block (``limit_bytes``), at most the share of an SM that leaves
    room for :data:`REACH2_BLOCKS_PER_SM` blocks (``mgmc_visit.SM_SHARED_BYTES``
    less ``BLOCK_RESERVED_BYTES`` a block)."""
    from .mgmc_visit import BLOCK_RESERVED_BYTES, SM_SHARED_BYTES

    return min(int(limit_bytes), SM_SHARED_BYTES // REACH2_BLOCKS_PER_SM - BLOCK_RESERVED_BYTES)


def field_budget(limit_bytes: int, table_words: int) -> int:
    """Bytes of dynamic shared memory left for the fields when a block may
    have ``limit_bytes``: less the kernel's static share and the tables."""
    return max(int(limit_bytes) - STATIC_SMEM_RESERVE - 4 * int(table_words), 0)


class SubtreeKernel:
    """Precomputed arrays and statics of the subtree below the finest level.

    ``operators``: the hierarchy's levels ``1 .. nlevel-1`` (coarsest last);
    ``presmoothers`` / ``postsmoothers``: one directed ``SORSmoother`` per
    operator but the last (forward / backward); ``coarse_L``: the Cholesky
    factor of the coarsest level's full precision.  Per sub-level a
    :class:`~.mgmc_visit.FusedVisitLevel` holds what the visits need: the
    coefficient plan, the noise scale, ``B``, both directions' Woodbury factors
    in factored form and ``Sigma^{1/2}``; :func:`launch_tables` stages them.
    ``smem_budget`` (bytes; default: what the card grants, less the kernel's
    static share and the tables) bounds the fields placed in shared memory."""

    def __init__(self, operators, presmoothers, postsmoothers, coarse_L, omega: float,
                 cycle: int, coarse_scaling: float, smem_budget: Optional[int] = None):
        if len(operators) < 2:
            raise ValueError("the subtree needs at least one sub-level above the coarsest")
        if len(operators) - 1 > MAX_SUB_LEVELS:
            raise NotImplementedError(f"more than {MAX_SUB_LEVELS} sub-levels")
        if len(presmoothers) != len(operators) - 1 or len(postsmoothers) != len(operators) - 1:
            raise ValueError("one pre- and one post-smoother per sub-level")
        self.cycle = int(cycle)
        self.levels = [
            FusedVisitLevel(op, pre.coloring, omega, pre.order, post.order,
                            pre.B_bar, post.B_bar, coarse_scaling)
            for op, pre, post in zip(operators[:-1], presmoothers, postsmoothers)]
        reaches = sorted({level.reach for level in self.levels})
        if reaches[-1] > 2:
            raise NotImplementedError(
                f"the subtree kernel takes stencils of reach 1 or 2, a sub-level has reach "
                f"{reaches[-1]}")
        if len(reaches) > 1:
            raise NotImplementedError("the subtree kernel takes sub-levels of one reach, "
                                      f"these have reaches {reaches}")
        #: the stencils' reach: 2 takes the reach-2 build
        self.reach = reaches[0]
        top = operators[0]
        self.vshape = top.vshape
        self.device, self.dtype = top.device, top.dtype
        self.coarse_vshape = operators[-1].vshape
        self.nc = int(np.prod(self.coarse_vshape))
        if self.levels[-1].vc != tuple(self.coarse_vshape):
            raise ValueError("the coarsest operator is not the coarsening of the level above it")
        L = np.asarray(coarse_L.detach().cpu().numpy() if isinstance(coarse_L, torch.Tensor)
                       else coarse_L, dtype=np.float64)
        if L.shape != (self.nc, self.nc):
            raise ValueError(f"coarse_L must be ({self.nc}, {self.nc}), got {L.shape}")
        Linv = scipy.linalg.solve_triangular(L, np.eye(self.nc), lower=True)
        self.Linv = torch.as_tensor(Linv, dtype=self.dtype, device=self.device).contiguous()
        self.LinvT = self.Linv.T.contiguous()
        self.schedule = subtree_schedule(len(self.levels), self.cycle)
        self.level_sizes = [int(np.prod(lv.op.vshape)) for lv in self.levels]
        #: threads per block: by the finest sub-level's size, as the visit kernels
        self.threads = (REACH2_THREADS if self.reach == 2 else
                        min(default_threads(self.level_sizes[0]), MAX_THREADS))
        (self._tables, self._table_offsets, self._warp_vec, self._warp_stride,
         self._points) = launch_tables(self.levels)
        limit = dynamic_smem_limit(self.device)
        block = reach2_limit(limit) if self.reach == 2 else limit
        #: sub-levels of more than ``LANE_SLOTS`` measurements: the kernel's
        #: wide instance
        self.wide = max(lv.op.m_lowrank for lv in self.levels) > LANE_SLOTS
        #: whether each block copies the tables into its shared memory (always
        #: up to ``LANE_SLOTS`` measurements); else they stay in the table
        #: tensor and only the warps' slots and the block's vector lie at the
        #: front of shared memory, ``warp_vec`` 0 telling the kernel so
        self.tables_shared = (not self.wide
                              or 4 * self._tables.size + STATIC_SMEM_RESERVE <= block)
        #: words of shared memory before the fields, the slots' offset there
        self._front = (self._tables.size, self._warp_vec)
        if not self.tables_shared:
            words = 32 * self._warp_stride + max(lv.op.m_lowrank for lv in self.levels)
            self._front = (words + (-words % 4), 0)
        # the placement under the card's limit; if the probe is refused the
        # shared memory this placement needs, the one that needs no opt-in
        table_words = self._front[0]
        budgets = [smem_budget] if smem_budget is not None else [
            field_budget(block, table_words), field_budget(DEFAULT_SMEM_BYTES, table_words)]
        for budget in budgets:
            self.smem_budget = max(int(budget), 0)
            (self._level_locs, self._coarse_locs, self._smem_floats,
             self._ws_floats) = place_fields(self.level_sizes, self.nc, self.smem_budget)
            # on the CPU the plain version runs: nothing to probe
            if self.device.type == "cpu" or probe_dynamic_smem(
                    self.smem_bytes + STATIC_SMEM_RESERVE, self.device):
                break
        else:
            raise RuntimeError(
                f"{self.smem_bytes} bytes of dynamic shared memory for the subtree kernel's "
                f"tables ({4 * table_words} bytes, which stay in shared memory) and fields "
                "were refused")
        self._device_cache = {}

    # ------------------------------------------------------------- statics
    def count_noise(self) -> int:
        """Normals one chain consumes in one call."""
        return sum(self._draw_sizes())

    def count_draws(self) -> int:
        """Draws (= Philox launch counters) of one call: per sweep the field and,
        with a low-rank term, its scalars; one per coarse sample."""
        return len(self._draw_sizes())

    def _draw_sizes(self) -> List[int]:
        return [int(np.prod(shape[1:])) for shape in self.draw_shapes(1)]

    def draw_shapes(self, C: int) -> List[Tuple[int, ...]]:
        """The shapes of the draws of one call, in order, as the composed
        recursion makes them."""
        shapes = []
        for op, li in self.schedule:
            if op == OP_COARSE:
                shapes.append((C, self.nc))
            else:
                shapes.append((C,) + tuple(self.levels[li].op.vshape))
                m = self.levels[li].op.m_lowrank
                if m:
                    shapes.append((C, m))
        return shapes

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a launch: the tables (where they are
        copied there; else the warps' slots and the block's vector), then the
        fields placed there."""
        return 4 * (self._front[0] + self._smem_floats)

    @property
    def placement(self) -> dict:
        """Where the kernel keeps each level's fields, and the bytes of
        dynamic shared memory and workspace per chain."""
        rows = [{"vshape": list(lv.op.vshape),
                 **{name: LOC_NAMES[loc[0]] for name, loc in zip(("x", "scratch", "f"), locs)}}
                for lv, locs in zip(self.levels, self._level_locs)]
        rows.append({"vshape": list(self.coarse_vshape),
                     **{name: LOC_NAMES[loc[0]]
                        for name, loc in zip(("x", "scratch", "f"), self._coarse_locs)}})
        return {"levels": rows, "shared_bytes": 4 * self._smem_floats,
                "table_bytes": 4 * self._tables.size, "tables_shared": self.tables_shared,
                "dynamic_shared_bytes": self.smem_bytes,
                "workspace_bytes_per_chain": 4 * self._ws_floats,
                "shared_budget_bytes": self.smem_budget, "threads": self.threads}

    # --------------------------------------------------------------- calls
    def sample(self, noise, f: torch.Tensor) -> torch.Tensor:
        """One subtree sample for ``f`` of shape ``(C, *vshape)``; ``noise`` is
        a noise source or ``None`` for the deterministic data path.  On a CUDA
        device a source with a Philox stream feeds the in-kernel generator;
        otherwise the normals are drawn as tensors in the composed recursion's
        order."""
        if noise is None:
            return subtree_sample(self, f)
        philox = noise.philox_streams(self.count_draws()) if f.is_cuda else None
        if philox is not None:
            return subtree_sample(self, f, philox=philox)
        C = f.shape[0]
        xi = torch.cat([noise.normal(shape, f.dtype, f.device).reshape(C, -1)
                        for shape in self.draw_shapes(C)], dim=1)
        return subtree_sample(self, f, xi=xi)

    # -------------------------------------------------- kernel parameters
    def _device_tables(self):
        """The launch tables, the schedule and the reach-2 point lists (None
        for none) as device tensors."""
        if "tables" not in self._device_cache:
            self._device_cache["tables"] = (
                torch.from_numpy(self._tables).to(self.device),
                torch.tensor(self.schedule, dtype=torch.int32).reshape(-1).to(self.device),
                torch.from_numpy(self._points).to(self.device) if self._points.size else None)
        return self._device_cache["tables"]

    def _params(self, C: int, noise_mode: int, record: bool, philox) -> SubtreeParams:
        key = ("params", C, noise_mode, bool(record))
        S = self._device_cache.get(key)
        if S is None:
            S = self._device_cache[key] = self._build_params(C, noise_mode, record)
        S.seed, S.counter = philox if philox is not None else (0, 0)
        return S

    def _build_params(self, C: int, noise_mode: int, record: bool) -> SubtreeParams:
        S = SubtreeParams()
        S.C, S.NL, S.n_sched = C, len(self.levels), len(self.schedule)
        S.noise_mode, S.nc, S.record = noise_mode, self.nc, int(record)
        S.ws_stride, S.xi_stride = self._ws_floats, self.count_noise()
        S.table_words, S.warp_vec = self._front
        S.warp_stride = self._warp_stride
        S.pass_width = barrier_count(self) + 1
        for li, (lv, locs, offs) in enumerate(zip(self.levels, self._level_locs,
                                                  self._table_offsets)):
            D = S.lv[li]
            D.coeffs, D.ns = _ptr(lv.coeffs), _ptr(lv.noise_scale)
            for name, value in offs.items():
                if isinstance(value, list):
                    getattr(D, name)[:] = value
                else:
                    setattr(D, name, value)
            for name, (where, off) in zip(("x", "scr", "f"), locs):
                loc = getattr(D, name)
                loc.where, loc.off = where, off
            D.n = self.level_sizes[li]
            D.form = lv.stencil_form
        for name, (where, off) in zip(("cx", "cscr", "cf"), self._coarse_locs):
            loc = getattr(S, name)
            loc.where, loc.off = where, off
        return S


def barrier_count(kernel: "SubtreeKernel", noise: bool = True) -> int:
    """Block barriers of one launch as ``csrc/level_passes.cuh`` places them:
    the table copy, per descend the rhs pass (where noise is on or x is
    zeroed), one per colour, ``B^T x`` and the Woodbury pass (where m > 0),
    the residual and the restriction, per ascend the same without the last
    two (its rhs pass always), per coarse sample two.  The kernel counts the
    barriers it passes into its stamps; ``chip_smoke.py`` holds the two
    equal."""
    count = 1
    for op, li in kernel.schedule:
        if op == OP_COARSE:
            count += 2
            continue
        lv = kernel.levels[li]
        colours = len(lv.post_order if op == OP_ASCEND else lv.pre_order)
        lowrank = 2 if lv.op.m_lowrank else 0
        if op == OP_ASCEND:
            count += 1 + colours + lowrank
        else:
            count += int(noise or op == OP_DESCEND_ZERO) + colours + lowrank + 2
    return count


def pass_names(kernel: "SubtreeKernel", noise: bool = True) -> List[Tuple[int, str]]:
    """The passes of one launch in the order the blocks pass their barriers
    (:func:`barrier_count` of them): ``(s, name)``, ``s`` the operation's index
    in the schedule (-1 for the table copy), ``name`` the pass that ends at the
    barrier: a descend's ``rhs`` (where noise is on or x is zeroed), ``colour
    o`` per colour of its order (by position), ``B^T x`` and ``Woodbury``
    (where m > 0), ``residual`` and ``restriction``; an ascend's
    ``prolongation and rhs``, its colours and the two low-rank passes; a coarse
    sample's two products."""
    names = [(-1, "table copy")]
    for s, (op, li) in enumerate(kernel.schedule):
        if op == OP_COARSE:
            names += [(s, "coarse g = xi + Linv f"), (s, "coarse x = Linv^T g")]
            continue
        lv = kernel.levels[li]
        colours = [f"colour {o}" for o in range(len(lv.post_order if op == OP_ASCEND
                                                    else lv.pre_order))]
        lowrank = ["B^T x", "Woodbury"] if lv.op.m_lowrank else []
        if op == OP_ASCEND:
            passes = ["prolongation and rhs"] + colours + lowrank
        else:
            passes = (["rhs"] if noise or op == OP_DESCEND_ZERO else []) + colours + lowrank + [
                "residual", "restriction"]
        names += [(s, name) for name in passes]
    return names


def pass_times(kernel: "SubtreeKernel", pass_stamps, noise: bool = True) -> dict:
    """Where one launch's time went by pass, from the ``pass_stamps`` it
    wrote (:func:`subtree_sample`; the timer at entry and after each barrier),
    in microseconds: per (operation, level shape) of the schedule and per pass
    of :func:`pass_names` the median over the operations of the pass's time
    (each the median over the blocks), their number and their sum; per
    (operation, level shape) ``visit_us``, the sum of those medians (one
    operation's time)."""
    raw = np.asarray(torch.as_tensor(pass_stamps).cpu().numpy()).astype(np.float64)
    names = pass_names(kernel, noise)
    per = np.median(np.diff(raw[:, :len(names) + 1], axis=1), axis=0) / 1e3
    groups: Dict[str, Dict[str, List[float]]] = {}
    for (s, name), us in zip(names, per):
        if s < 0:
            key = "table copy"
        else:
            op, li = kernel.schedule[s]
            shape = kernel.coarse_vshape if op == OP_COARSE else kernel.levels[li].op.vshape
            key = f"{OP_NAMES[op]} {'x'.join(map(str, shape))}"
        groups.setdefault(key, {}).setdefault(name, []).append(float(us))
    out = {}
    for key, passes in groups.items():
        rows = {name: {"count": len(v), "median_us": float(np.median(v)),
                       "total_us": float(np.sum(v))} for name, v in passes.items()}
        out[key] = {"passes": rows, "visit_us": sum(r["median_us"] for r in rows.values())}
    return out


def operation_times(kernel: "SubtreeKernel", stamps) -> dict:
    """Where one launch's time went, from the ``stamps`` it wrote (see
    :func:`subtree_sample`), in microseconds.

    ``operations``: per (operation, level shape) of the schedule the number of
    such operations, the median over them of their time (each the median over
    the blocks) and the sum of those; ``table_copy_us`` / ``copy_out_us`` the
    medians of the time before the first operation and after the last;
    ``sum_us`` the sum of all of these, the breakdown's total.  Per block the
    time from entry to exit: its median (``block_span_us``, what ``sum_us``
    breaks down) and its largest (``slowest_block_us``), and by the number k
    of blocks its SM ran in the launch (``block_span_by_sm_share_us``: per k
    the number of such SMs and, per rank on the SM from the shortest, the
    median span); ``start_skew_us`` from the first block's entry to the last
    one's, ``launch_span_us`` from the first entry to the last exit.  Measured, not modelled: ``barriers_per_block`` (the distinct
    counts the blocks report), ``blocks_per_sm`` (the most blocks that ran on
    one SM at once) and ``sms`` (the SMs used)."""
    raw = np.asarray(torch.as_tensor(stamps).cpu().numpy())
    n = len(kernel.schedule)
    t = raw[:, :n + 1].astype(np.float64)
    entry, exit_ = raw[:, n + 1].astype(np.float64), raw[:, n + 2].astype(np.float64)
    barriers, sm = raw[:, n + 3], raw[:, n + 4]
    per_op = np.median(np.diff(t, axis=1), axis=0) / 1e3
    groups: Dict[str, List[float]] = {}
    for s, (op, li) in enumerate(kernel.schedule):
        shape = kernel.coarse_vshape if op == OP_COARSE else kernel.levels[li].op.vshape
        groups.setdefault(f"{OP_NAMES[op]} {'x'.join(map(str, shape))}", []).append(per_op[s])
    table_copy = float(np.median(t[:, 0] - entry) / 1e3)
    copy_out = float(np.median(exit_ - t[:, -1]) / 1e3)
    span = (exit_ - entry) / 1e3
    at_once = 0
    by_share: Dict[int, List[np.ndarray]] = {}
    for q in np.unique(sm):
        ev = sorted([(e, 1) for e in entry[sm == q]] + [(e, -1) for e in exit_[sm == q]],
                    key=lambda v: (v[0], v[1]))
        at_once = max(at_once, int(np.max(np.cumsum([d for _, d in ev]))))
        by_share.setdefault(int(np.sum(sm == q)), []).append(np.sort(span[sm == q]))
    return {"operations": {key: {"count": len(v), "median_us": float(np.median(v)),
                                 "total_us": float(np.sum(v))} for key, v in groups.items()},
            "table_copy_us": table_copy, "copy_out_us": copy_out,
            "sum_us": float(per_op.sum()) + table_copy + copy_out,
            "block_span_us": float(np.median(span)),
            "slowest_block_us": float(span.max()),
            "block_span_by_sm_share_us": {
                str(k): {"sms": len(v), "median_by_rank": np.median(v, axis=0).tolist()}
                for k, v in sorted(by_share.items())},
            "start_skew_us": float((entry.max() - entry.min()) / 1e3),
            "launch_span_us": float((exit_.max() - entry.min()) / 1e3),
            "barriers_per_block": sorted(int(v) for v in np.unique(barriers)),
            "blocks_per_sm": at_once, "sms": int(np.unique(sm).size)}


# ------------------------------------------------------------- plain version
def subtree_sample_plain(kernel: SubtreeKernel, f: torch.Tensor,
                         xi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the subtree kernel: the schedule walked with
    the visits' plain versions and ``x = (xi + f Linv^T) Linv`` on the coarsest
    level.  ``xi`` is ``(C, kernel.count_noise())`` (see the module docstring)
    or ``None`` for the deterministic data path.  Returns a new tensor."""
    C = f.shape[0]
    nsub = len(kernel.levels)
    fs: List[Optional[torch.Tensor]] = [f] + [None] * nsub
    xs: List[Optional[torch.Tensor]] = [None] * (nsub + 1)
    cur = 0

    def take(n):
        nonlocal cur
        if xi is None:
            return None
        out = xi[:, cur:cur + n]
        cur += n
        return out

    for op, li in kernel.schedule:
        if op == OP_COARSE:
            g = fs[li].reshape(C, kernel.nc) @ kernel.Linv.T
            z = take(kernel.nc)
            if z is not None:
                g = g + z
            xs[li] = (g @ kernel.Linv).reshape((C,) + tuple(kernel.coarse_vshape))
            continue
        level = kernel.levels[li]
        z = take(kernel.level_sizes[li])
        z = None if z is None else z.reshape((C,) + tuple(level.op.vshape))
        z_lr = None
        if xi is not None and level.op.m_lowrank:
            z_lr = take(level.op.m_lowrank)
        if op == OP_DESCEND_ZERO:
            xs[li] = torch.zeros_like(fs[li])
        if op in (OP_DESCEND, OP_DESCEND_ZERO):
            xs[li], fs[li + 1] = descend_visit_plain(level, fs[li], xs[li], z, z_lr)
        else:
            xs[li] = ascend_visit_plain(level, fs[li], xs[li], xs[li + 1], z, z_lr)
    return xs[0]


# ------------------------------------------------------------------ wrapper
def subtree_sample(kernel: SubtreeKernel, f: torch.Tensor, xi: Optional[torch.Tensor] = None,
                   philox: Optional[Tuple[int, int]] = None, record: bool = False,
                   stamps: Optional[torch.Tensor] = None,
                   pass_stamps: Optional[torch.Tensor] = None):
    """One subtree sample of all chains; ``f`` is ``(C, *kernel.vshape)``.

    Noise: ``philox=(seed, first counter)`` for the in-kernel generator (CUDA
    only; the call uses ``kernel.count_draws()`` consecutive counters) or all
    normals as ``xi`` of shape ``(C, kernel.count_noise())``; neither runs the
    deterministic data path.  With ``record=True`` (Philox only) the normals
    the kernel drew come back too: ``(x, xi)``.

    ``stamps`` (CUDA only, a measurement aid): an int64 tensor of shape
    ``(C, len(kernel.schedule) + 1 + STAMP_EXTRA)`` that receives, per chain,
    the card's global timer in ns before the first operation of the schedule
    and after each, then at kernel entry and at exit, the barriers the block
    passed and the SM it ran on (:func:`operation_times`); ``None`` on every
    production call.  ``pass_stamps`` (with ``stamps`` only): an int64 tensor
    of shape ``(C, barrier_count(kernel) + 1)`` that receives per chain the
    timer at entry and after each barrier (:func:`pass_times`).

    CPU tensors go to :func:`subtree_sample_plain`.  CUDA tensors launch the
    kernel or raise."""
    if xi is not None and philox is not None:
        raise ValueError("give the normals as a tensor or as a Philox stream, not both")
    if record and philox is None:
        raise ValueError("record=True returns the in-kernel normals: it needs a Philox stream")
    if f.ndim != 3 or tuple(f.shape[1:]) != tuple(kernel.vshape):
        raise ValueError(f"f must be (C, {kernel.vshape[0]}, {kernel.vshape[1]}), "
                         f"got {tuple(f.shape)}")
    C, K = f.shape[0], kernel.count_noise()
    if xi is not None and tuple(xi.shape) != (C, K):
        raise ValueError(f"xi must be ({C}, {K}), got {tuple(xi.shape)}")
    if f.device.type == "cpu":
        if philox is not None or stamps is not None:
            raise ValueError("the Philox stream and the stamps exist in the CUDA kernel only")
        return subtree_sample_plain(kernel, f, xi)
    width = len(kernel.schedule) + 1 + STAMP_EXTRA
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != f.device
                               or tuple(stamps.shape) != (C, width)
                               or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be a contiguous int64 ({C}, {width}) tensor on {f.device}")
    pass_width = barrier_count(kernel) + 1
    if pass_stamps is not None and (stamps is None or pass_stamps.dtype != torch.int64
                                    or pass_stamps.device != f.device
                                    or tuple(pass_stamps.shape) != (C, pass_width)
                                    or not pass_stamps.is_contiguous()):
        raise ValueError(f"pass_stamps (with stamps) must be a contiguous int64 ({C}, "
                         f"{pass_width}) tensor on {f.device}")
    tensors = {"f": f} if xi is None else {"f": f, "xi": xi}
    for name, t in tensors.items():
        if t.device != kernel.Linv.device:
            raise ValueError(f"{name} lies on {t.device}, the kernel's arrays on "
                             f"{kernel.Linv.device}")
        if t.dtype != torch.float32 or kernel.dtype != torch.float32:
            raise TypeError("the subtree kernel is float32 only "
                            f"({name} is {t.dtype}, the levels {kernel.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    noise_mode = 1 if philox is not None else (2 if xi is not None else 0)
    S = kernel._params(C, noise_mode, record, philox)
    S.stamps, S.pass_stamps = _ptr(stamps), _ptr(pass_stamps)
    tables, sched, points = kernel._device_tables()
    lib = launch_library(kernel.reach, stamps is not None, kernel.threads)
    x = torch.empty_like(f)
    ws = torch.empty((C, max(kernel._ws_floats, 1)), dtype=torch.float32, device=f.device)
    if record:
        xi = torch.empty((C, K), dtype=torch.float32, device=f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mgmc_subtree_sample(
            ctypes.byref(S), tables.data_ptr(), sched.data_ptr(), kernel.Linv.data_ptr(),
            kernel.LinvT.data_ptr(), f.data_ptr(), x.data_ptr(), ws.data_ptr(), _ptr(xi),
            _ptr(points), kernel.threads, kernel.smem_bytes, int(kernel.wide), stream)
    launch_counts[KERNEL_NAMES[kernel.reach]] += 1
    if err != 0:
        raise RuntimeError(f"subtree kernel launch failed: CUDA error {err}")
    return (x, xi) if record else x
