"""Fused MGMC level-visit kernels: the whole descend / ascend of one level in
one CUDA kernel launch.

Replaces ``descend_visit`` / ``ascend_visit`` / ``FusedVisitLevel`` of
``multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py``.  One **descend visit** of
level l is

    c   = f + sqrt(D (2-omega)/omega) xi + B Sigma^{-1/2} xi'   (Gibbs noise)
    x  <- colour-ordered SOR sweep(c, x)                        (pre direction)
    x  <- x - B_bar (B^T x)                                     (Woodbury)
    r   = f - A x            (A = stencil + B Sigma^{-1} B^T)
    f_c = R r                (full-weighting restriction)

and one **ascend visit** is

    x  <- x + gamma * P x_c                                     (prolongate_add)
    c   = f + noise                                             (as above)
    x  <- colour-ordered SOR sweep(c, x)                        (post direction)
    x  <- x - B_bar_post (B^T x)

Three hand-written CUDA kernels compute each visit, and the launch takes one
of them by the number of chains (:data:`SPLIT_MAX_CHAINS`,
:data:`STREAM_MIN_CHAINS`), by the level's shape and by whether the kernel's
shared memory fits a block and its cluster schedules (:func:`visit_route`,
:func:`split_smem_bytes`, :func:`stream_smem_bytes`):

* the **split kernels** of ``csrc/mgmc_visit_split.cu`` (each chain's level
  split over a thread-block cluster of ``S`` blocks, each block's band of rows
  of ``x`` and of the rhs / residual in shared memory, halo rows and the
  partial sums of ``B^T x`` read from the neighbouring blocks' shared memory, a
  cluster barrier between phases; :func:`split_cluster` picks ``S``) - for
  few chains (at most :data:`SPLIT_MAX_CHAINS`), where one block per chain
  leaves the card idle and a visit is latency;
* the **phase kernels** of ``csrc/mgmc_visit.cu`` (one thread block per chain,
  whole-field phases over a field in global memory, ``__syncthreads()``
  between them; the phases live in ``csrc/visit_phases.cuh``, shared with the
  subtree kernel) - for the chain counts between the two thresholds, and for
  levels the other two do not fit;
* the **stream kernels** of ``csrc/mgmc_visit_stream.cu`` (one thread block per
  chain, the sweep as a wavefront of row blocks through a ring of rows in
  shared memory, every colour phase of a step at once; :func:`wavefront_lags`
  gives the schedule) - for many chains, where each chain's field crosses the
  memory bus twice and not ten times.

All three compute the same visit from the same Philox stream; the route is
chosen from the level's shape and the chain count when a level builds its
parameter block for a launch configuration (``FusedVisitLevel._params``), never
after a launch, and a failing build or launch raises.  The sources are compiled with
``nvcc`` for ``sm_90a`` at first use into the package's ``build/`` directory and
loaded with ``ctypes`` (the mechanism of :mod:`.common`, shared with the sweep
kernels of :mod:`.sor_sweep`).

**Bound.**  A visit is bound by bytes: per chain it must read ``f`` (unless
shared), ``x`` and ``x_c`` and write ``x`` and ``f_c`` once - for the descend
visit of a 255^2 level with shared ``f`` that is ``C * (2 * 255^2 + 127^2) * 4``
bytes, about 150 MB at 256 chains.  Everything else the kernels touch
(coefficient planes, the few points where ``B`` and ``M^{-1} B`` are nonzero)
is meant to stay in L2.  Both kernels are several times off that bound, the
stream kernels by the instructions they issue (the Philox draws, an IEEE
division per point) on few warps per SM; ``PERF.md`` has their times.

Beside each kernel stands its **plain PyTorch version**
(:func:`descend_visit_plain`, :func:`ascend_visit_plain`), built from
``sor_sweep``, ``restrict`` and ``prolongate_add`` and taking the noise as
tensors.  The wrappers :func:`descend_visit` / :func:`ascend_visit` take the
plain version only for tensors that lie on the CPU; for a CUDA tensor they
launch the kernel or raise - there is no fallback.  The kernels update ``x`` in
place; the plain versions return new tensors.

The field noise of the kernels is an in-kernel Philox4x32-10 stream addressed
by ``(seed, launch counter, chain, point group)`` (see
:func:`philox_normals_reference`); alternatively the wrappers accept the field
noise ``xi`` as a tensor, so kernel and plain version can be fed the same
normals.  The ``m`` low-rank normals per chain are always drawn outside and
passed in pre-scaled by ``Sigma^{-1/2}``.

Supported by the kernels: 2d, float32, one directed sweep per visit (SOR), any
reach-1 stencil (up to 9 offsets, per-point coefficient planes, up to 8
colours), ``0 <= m <= 32`` with dense ``B``, ``f`` shared or per chain, noise
on or off, any ``coarse_scaling``.  Two sweeps per visit (SSOR), 3d, reach-2
stencils and reduced-precision transfers belong to later slices; the wrapper
raises on them.  SSOR levels run the composed visit, whose sweeps are the
kernels of :mod:`.sor_sweep`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...smoothers import sor_sweep, woodbury_factors
from ..intergrid import prolongate_add, restrict
from ..stencil import StencilOperator
from . import sor_sweep as ss
from .common import (compress_plan, default_threads, dynamic_smem_limit,  # noqa: F401
                     open_library, philox_normals_reference, support_boxes)
from .common import tensor_ptr as _ptr

MAX_OFFSETS = 9
MAX_COLORS = 8
MAX_LOWRANK = 32

#: threads per block of the stream kernels (``MAX_STREAM_THREADS`` in the source)
MAX_STREAM_THREADS = 256
#: rows per step of the stream kernels' wavefront (``STREAM_ROWS`` in the source)
STREAM_ROWS = 4
#: the rest of the stream kernels' shared-memory layout (``STREAM_PREFETCH``,
#: ``STREAM_TILE``, ``STREAM_COL0`` in the source; see :func:`stream_smem_bytes`)
STREAM_PREFETCH = 1
STREAM_TILE = 4
STREAM_COL0 = 4
#: shared memory a block may opt in to on an H100 (``sharedMemPerBlockOptin``);
#: the route asks the probe (:func:`~.common.dynamic_smem_limit`), and
#: ``chip_smoke.py`` holds the probe's answer against this value
SMEM_PER_BLOCK_OPTIN = 232448
#: the stream kernels' static shared memory (``s_btx``, ``s_lr``, ``s_u``, ``s_j0``)
STREAM_STATIC_SMEM = 4 * (3 * 32 + 8 * 8)

#: the CUDA sources under ``csrc/`` (see :mod:`.common` for the build)
SOURCE_NAME = "mgmc_visit"
STREAM_SOURCE_NAME = "mgmc_visit_stream"
SPLIT_SOURCE_NAME = "mgmc_visit_split"

#: the three routes of a visit launch: the phase kernels of ``mgmc_visit.cu``,
#: the stream kernels of ``mgmc_visit_stream.cu`` and the split kernels of
#: ``mgmc_visit_split.cu``
ROUTES = ("phase", "stream", "split")

#: ints of the split kernels' first-point table before the bands
#: (``SPLIT_TABLE_INTS`` in the source)
SPLIT_TABLE_INTS = MAX_COLORS * MAX_COLORS
#: the split kernels' static shared memory (``s_part``, ``s_all``, ``s_btx``,
#: ``s_lr``, ``s_u``; ``MAX_CLUSTER`` = 16 in the source)
SPLIT_STATIC_SMEM = 4 * (MAX_LOWRANK + 16 * MAX_LOWRANK + 3 * MAX_LOWRANK)

#: Launches with at least this many chains take the stream kernels, fewer the
#: phase kernels (where the stream kernels' rings fit a block: :func:`visit_route`).
#: Set from the ``visit_routes`` table of ``chip_smoke.py``, which fails if the
#: table supports another value: both kernels' device time per descend plus
#: ascend at 1, 16, 64, 132, 256 and 512 chains on the 255^2 and 127^2 flagship
#: levels, and at 132, 256 and 512 on the 511^2 and 255^2 (9-point) levels of a
#: 512x512 lattice, NVIDIA H100 80GB HBM3, 700.00 W.  The stream kernels win at
#: 256 and 512 chains on every level, at 132 on all but the 127^2 level, and lose
#: at 1-64; wider levels and more chains than that were not measured.  PERF.md
#: section 6 holds the table.
STREAM_MIN_CHAINS = 256

#: Launches of at most this many chains take the split kernels where their bands
#: fit a block and their cluster schedules (:func:`split_cluster`).  Set from the
#: split column of the ``visit_routes`` table of ``chip_smoke.py``, which fails
#: if the table supports another value: device time per descend plus ascend of
#: all three routes at 1, 4, 8, 16, 32, 64 and 132 chains on the flagship's 255^2
#: and 127^2 levels, the split kernels at every cluster size that fits, NVIDIA
#: H100 80GB HBM3, 700.00 W (the split kernels at the rule's cluster size take at
#: most 0.84 of the phase kernels' time up to 64 chains on both levels, and lose
#: at 132).  PERF.md section 6 holds the table.
SPLIT_MAX_CHAINS = 64

#: The fixed part of a wave of split visit clusters (the load, the cluster
#: barriers, the launch) lasts about as long as a band of this many points takes
#: to visit: the rule's cost (``sor_sweep.split_cost``) takes ``fixed =
#: SPLIT_WAVE_POINTS / (H * W)``.  From the same table: one chain (one wave) at
#: every cluster size fits ``a + b / S`` with ``a / b`` = 0.067 of a 255^2 field
#: and 0.28 of a 127^2 field (4,376 and 4,509 points), so the share is a number
#: of points, not a constant share as the sweeps' 0.04 (which picks clusters of
#: 16 at 64 chains on 127^2, where clusters of 2 run in one wave and take 0.75 of
#: the time).  Every value from about 2,530 to 4,060 points picks the best measured
#: size at every count the route splits (1-64) on both levels; 4,400 would pick
#: 4 for 8 at 64 chains on 255^2 (5% slower).
SPLIT_WAVE_POINTS = 3300

#: kernel launches made by the wrappers (and only where they launch)
launch_counts: Dict[str, int] = {"descend_visit": 0, "ascend_visit": 0,
                                 "descend_visit_stream": 0, "ascend_visit_stream": 0,
                                 "descend_visit_split": 0, "ascend_visit_split": 0}

#: the kernel counted by each launch, by route and kind
KERNEL_NAMES = {(route, kind): f"{kind}_visit" + ("" if route == "phase" else f"_{route}")
                for route in ROUTES for kind in ("descend", "ascend")}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class VisitParams(ctypes.Structure):
    """Mirror of ``struct VisitParams`` in ``csrc/mgmc_visit.cu``."""

    _fields_ = [
        ("C", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("Hc", ctypes.c_int), ("Wc", ctypes.c_int),
        ("K", ctypes.c_int), ("diag_index", ctypes.c_int),
        ("dy", ctypes.c_int * MAX_OFFSETS),
        ("dx", ctypes.c_int * MAX_OFFSETS),
        ("coeff_const", ctypes.c_int * MAX_OFFSETS),
        ("coeff_val", ctypes.c_float * MAX_OFFSETS),
        ("n_colors", ctypes.c_int), ("w0", ctypes.c_int), ("w1", ctypes.c_int),
        ("jstride", ctypes.c_int),
        ("n_order", ctypes.c_int),
        ("order", ctypes.c_int * MAX_COLORS),
        ("omega", ctypes.c_float),
        ("gamma", ctypes.c_float),
        ("m", ctypes.c_int),
        ("bbox", (ctypes.c_int * 4) * MAX_LOWRANK),
        ("ybox", (ctypes.c_int * 4) * MAX_LOWRANK),
        ("noise_mode", ctypes.c_int),
        ("ns_const", ctypes.c_int),
        ("ns_val", ctypes.c_float),
        ("f_batched", ctypes.c_int),
        ("seed", ctypes.c_ulonglong),
        ("counter", ctypes.c_ulonglong),
    ]


class StreamParams(ctypes.Structure):
    """Mirror of ``struct StreamParams`` in ``csrc/mgmc_visit_stream.cu``: the
    phase kernels' parameter block and the wavefront's lag table."""

    _fields_ = [
        ("v", VisitParams),
        ("lag", ctypes.c_int * MAX_COLORS),
        ("max_lag", ctypes.c_int),
    ]


def visit_route(C: int, stream_bytes: int = 0, device=None,
                smem_limit: Optional[int] = None, vshape=None) -> str:
    """The kernel a visit of ``C`` chains launches: ``"stream"`` from
    :data:`STREAM_MIN_CHAINS` chains on where the stream kernels' shared memory
    (``stream_bytes``, :func:`stream_smem_bytes`) fits a block; ``"split"`` for
    a level of shape ``vshape`` where :func:`split_cluster` finds a cluster size
    (at most :data:`SPLIT_MAX_CHAINS` chains); ``"phase"`` otherwise (and
    always without a shape below the stream threshold).  A block is granted
    ``smem_limit`` bytes, by default what the probe finds on ``device``
    (:func:`~.common.dynamic_smem_limit`; on the CPU its default).  All of it
    is known before any launch."""
    if smem_limit is None:
        smem_limit = dynamic_smem_limit(device)
    if C >= STREAM_MIN_CHAINS and stream_bytes + STREAM_STATIC_SMEM <= smem_limit:
        return "stream"
    if vshape is not None and split_cluster(C, vshape, device, smem_limit) is not None:
        return "split"
    return "phase"


def split_smem_bytes(H: int, W: int, S: int) -> int:
    """Dynamic shared memory of one block of a split launch with clusters of
    ``S`` blocks on an ``H x W`` level: the first-point table, the widest band
    of ``x`` and the scratch band of the rhs and the residual.  The host's
    mirror of ``mgmc_split_smem_bytes`` in ``csrc/mgmc_visit_split.cu``;
    ``ValueError`` where the level cannot be split so (``S`` outside 2 .. 16,
    more blocks than rows)."""
    if not 2 <= S <= ss.SPLIT_SIZES[0] or S > H:
        raise ValueError(f"a level of {H} rows does not split over {S} blocks")
    widest = max(u1 - u0 for u0, u1 in split_bands(H, S))
    return 4 * (SPLIT_TABLE_INTS + 2 * widest * W)


def split_bands(H: int, S: int) -> Tuple[Tuple[int, int], ...]:
    """The rows ``[u0, u1)`` of each block of a cluster of ``S`` on an ``H``-row
    level, rank by rank: the first ``H % S`` ranks take one row more
    (``band_of`` in ``csrc/mgmc_visit_split.cu``).  Coarse row ``I`` belongs to
    the rank whose band holds fine row ``2I + 1``."""
    base, rem = divmod(H, S)
    bands, u0 = [], 0
    for k in range(S):
        u1 = u0 + base + (k < rem)
        bands.append((u0, u1))
        u0 = u1
    return tuple(bands)


def _split_occupancy_query():
    """The split kernels' ``cudaOccupancyMaxActiveClusters`` entry point."""
    return load_split_library().mgmc_split_max_active


def split_active_clusters(S: int, vshape, device=None) -> int:
    """How many clusters of ``S`` blocks of the split kernels on a level of
    shape ``vshape`` the card holds at once, the fewer of the descend and the
    ascend kernel's (``sor_sweep.active_clusters`` through the split kernels'
    own ``cudaOccupancyMaxActiveClusters`` entry point; on the CPU every
    cluster counts as running at once); 0 where such a cluster never
    schedules."""
    H, W = (int(v) for v in vshape)
    nbytes = split_smem_bytes(H, W, S)
    threads = ss.split_threads((H, W), S)
    device = "cuda" if device is None else device
    # kind 1 asks for the descend kernel, 0 for the ascend kernel
    return min(ss.active_clusters(device, kind, S, threads, nbytes, _split_occupancy_query)
               for kind in (1, 0))


def split_cluster(C: int, vshape, device=None, smem_limit: Optional[int] = None,
                  capped: bool = True) -> Optional[int]:
    """The cluster size of a split launch of ``C`` chains on a level of shape
    ``vshape``: for at most :data:`SPLIT_MAX_CHAINS` chains (any number with
    ``capped=False``), of the sizes of ``sor_sweep.SPLIT_SIZES`` whose bands
    (and the static part) fit ``smem_limit`` (default: what the probe grants a
    block on ``device``) and whose clusters schedule, the one of least
    wave-counted cost (``sor_sweep.cheapest_cluster`` over
    :func:`split_active_clusters`, the fixed share of a wave
    :data:`SPLIT_WAVE_POINTS` over the level's points); ``None`` otherwise."""
    if capped and C > SPLIT_MAX_CHAINS:
        return None
    H, W = (int(v) for v in vshape)
    if smem_limit is None:
        smem_limit = dynamic_smem_limit(device)
    active = {S: split_active_clusters(S, vshape, device) for S in ss.SPLIT_SIZES
              if S <= H and split_smem_bytes(H, W, S) + SPLIT_STATIC_SMEM <= smem_limit}
    return ss.cheapest_cluster(C, active, SPLIT_WAVE_POINTS / (H * W))


def stream_pitch(w: int) -> int:
    return (w + STREAM_COL0 + 4) & ~3


def stream_smem_bytes(H: int, W: int, max_lag: int, m: int, threads: int,
                      ascend: bool) -> int:
    """Dynamic shared memory of one stream-kernel launch, as ``stream_layout``
    in ``csrc/mgmc_visit_stream.cu`` lays it out (``mgmc_stream_smem_bytes``
    there gives the same number): the x and c rings of rows of ``W`` points,
    their length the least power of two that holds the live row blocks of a
    step (``max_lag`` grows it), reused by pass 2's tiles; a zero row; the
    coarse rows of an ascend visit; a word per row; the per-warp partial sums
    of ``B^T x``."""
    pitch = stream_pitch(W)
    nring = STREAM_ROWS
    while nring < (max_lag + STREAM_PREFETCH + 5) * STREAM_ROWS:
        nring *= 2
    rows = 2 * nring
    if not ascend:
        rows = max(rows, 2 * ((2 * STREAM_TILE + 3) + (2 * STREAM_TILE + 1)))
    floats = (rows + 1) * pitch
    if ascend:
        floats += (STREAM_PREFETCH + 2) * (STREAM_ROWS // 2 + 2) * stream_pitch(W // 2)
    floats += H + m * (threads // 32)
    return 4 * floats


def stream_threads(W: int) -> int:
    """Threads per block of the stream kernels for rows of ``W`` points: half of
    them sweep, the other half form the entering row block (Philox point
    groups); 256 from 97 points a row on."""
    return min(MAX_STREAM_THREADS, 64 * max(1, -(-W // 32)))


def wavefront_lags(offsets, weights, n_colors: int, order) -> Tuple[int, ...]:
    """The stream kernels' schedule: the rows are taken :data:`STREAM_ROWS` at a
    time (a row block), and at step ``s`` colour phase ``o`` (the ``o``-th
    colour of ``order``) runs on row block ``s - lag[o]``, all phases of a step
    at once.

    Returns the least non-negative lags for which that is the colour-ordered
    sweep: a point of phase ``o`` that reads a neighbour of the colour of phase
    ``o'`` in row block ``b + db`` must find it updated (``o' < o``:
    ``lag[o] >= lag[o'] + db + 1``) or not yet updated (``o' > o``:
    ``lag[o'] >= lag[o] - db + 1``), and two phases of one step then never share
    a point.  A neighbour ``dy`` rows away lies in the block ``db = dy`` or in
    the same block.  Colours ``c = (w0 i + w1 j) mod K``; reach-1 stencils
    (``|dy| <= 1``), for which ``lag[o] = 2 o`` always satisfies the
    constraints."""
    w0, w1 = (int(w) for w in weights)
    pos = {int(c): o for o, c in enumerate(order)}
    constraints = []  # (a, b, w): lag[a] >= lag[b] + w
    for o, c in enumerate(order):
        for dy, dx in offsets:
            if dy == 0 and dx == 0:
                continue
            other = pos.get((int(c) + w0 * dy + w1 * dx) % n_colors)
            if other is None:
                continue
            if other == o:
                raise ValueError(f"offset {(dy, dx)} couples colour {c} to itself: "
                                 "the colouring is not proper")
            for db in {dy, 0}:
                constraints.append((o, other, db + 1) if other < o else (other, o, 1 - db))
    lag = [0] * len(order)
    for _ in range(len(order) + 1):
        changed = False
        for a, b, w in constraints:
            if lag[a] < lag[b] + w:
                lag[a], changed = lag[b] + w, True
        if not changed:
            return tuple(lag)
    raise ValueError("the wavefront constraints have no solution (a stencil of reach > 1?)")


# ------------------------------------------------------------------- the build
@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    lib = open_library(SOURCE_NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mgmc_visit_params_size.argtypes = []
    lib.mgmc_visit_params_size.restype = i32
    if lib.mgmc_visit_params_size() != ctypes.sizeof(VisitParams):
        raise RuntimeError("VisitParams layout differs between Python and CUDA")
    # P, x, f, scratch, fc, coeffs, ns, B, Y, W, xilr, sinv, G, xi, threads, stream
    lib.mgmc_descend_visit.argtypes = [ctypes.POINTER(VisitParams)] + [ptr] * 13 + [i32, ptr]
    lib.mgmc_descend_visit.restype = i32
    # P, x, f, scratch, xc, coeffs, ns, B, Y, W, xilr, xi, threads, stream
    lib.mgmc_ascend_visit.argtypes = [ctypes.POINTER(VisitParams)] + [ptr] * 11 + [i32, ptr]
    lib.mgmc_ascend_visit.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def load_stream_library() -> ctypes.CDLL:
    """Build (at first use) and load the stream kernels' shared library."""
    lib = open_library(STREAM_SOURCE_NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mgmc_stream_params_size.argtypes = []
    lib.mgmc_stream_params_size.restype = i32
    if lib.mgmc_stream_params_size() != ctypes.sizeof(StreamParams):
        raise RuntimeError("StreamParams layout differs between Python and CUDA")
    lib.mgmc_stream_smem_bytes.argtypes = [ctypes.POINTER(StreamParams), i32, i32]
    lib.mgmc_stream_smem_bytes.restype = i32
    lib.mgmc_stream_static_smem_bytes.argtypes = []
    lib.mgmc_stream_static_smem_bytes.restype = i32
    # P, x, f, fc, coeffs, ns, B, Y, W, xilr, sinv, G, xi, threads, stream
    lib.mgmc_stream_descend.argtypes = [ctypes.POINTER(StreamParams)] + [ptr] * 12 + [i32, ptr]
    lib.mgmc_stream_descend.restype = i32
    # P, x, f, xc, coeffs, ns, B, Y, W, xilr, xi, threads, stream
    lib.mgmc_stream_ascend.argtypes = [ctypes.POINTER(StreamParams)] + [ptr] * 10 + [i32, ptr]
    lib.mgmc_stream_ascend.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def load_split_library() -> ctypes.CDLL:
    """Build (at first use) and load the split kernels' shared library."""
    lib = open_library(SPLIT_SOURCE_NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mgmc_split_params_size.argtypes = []
    lib.mgmc_split_params_size.restype = i32
    if lib.mgmc_split_params_size() != ctypes.sizeof(VisitParams):
        raise RuntimeError("VisitParams layout differs between Python and CUDA")
    lib.mgmc_split_smem_bytes.argtypes = [i32] * 3  # H, W, S
    lib.mgmc_split_smem_bytes.restype = i32
    lib.mgmc_split_static_smem_bytes.argtypes = []
    lib.mgmc_split_static_smem_bytes.restype = i32
    # descend, S, threads, bytes, out clusters
    lib.mgmc_split_max_active.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.mgmc_split_max_active.restype = i32
    # P, x, f, fc, coeffs, ns, B, Y, W, xilr, sinv, G, xi, S, threads, stream
    lib.mgmc_split_descend.argtypes = [ctypes.POINTER(VisitParams)] + [ptr] * 12 + [i32, i32, ptr]
    lib.mgmc_split_descend.restype = i32
    # P, x, f, xc, coeffs, ns, B, Y, W, xilr, xi, S, threads, stream
    lib.mgmc_split_ascend.argtypes = [ctypes.POINTER(VisitParams)] + [ptr] * 10 + [i32, i32, ptr]
    lib.mgmc_split_ascend.restype = i32
    return lib


def kernel_support_error(op: StencilOperator, n_colors: int) -> Optional[str]:
    """Why the CUDA kernels cannot take this level, or None if they can."""
    if len(op.vshape) != 2:
        return "the fused level-visit kernels are 2d only (3d: later slice)"
    if len(op.offsets) > MAX_OFFSETS or any(abs(o) > 1 for off in op.offsets for o in off):
        return "the fused level-visit kernels take reach-1 stencils only (reach 2: later slice)"
    if n_colors > MAX_COLORS:
        return f"more than {MAX_COLORS} colours"
    if op.m_lowrank > MAX_LOWRANK:
        return f"more than {MAX_LOWRANK} measurements"
    return None


class FusedVisitLevel:
    """Per-level bundle of buffers and static configuration for the fused
    visit kernels: ``coeffs``, ``noise_scale``, ``B``, ``B_bar`` (pre and post
    direction - the Woodbury factor is direction dependent), ``lr_scale``,
    ``sigma_inv`` and the Gram matrix ``G_pre`` of the residual shortcut.  The
    plain versions apply ``B_bar``; the CUDA kernels its factors ``Y = M^{-1} B``
    (compact support, ``ybox``) and ``W`` with ``B_bar_k = sum_l W[l, k] Y_l``."""

    def __init__(self, op: StencilOperator, coloring, omega: float, pre_order, post_order,
                 Bbar_pre, Bbar_post, coarse_scaling: float):
        if len(op.vshape) != 2:
            raise NotImplementedError(
                "fused level visits are 2d only; the 3d (flat-storage) kernels "
                "belong to a later slice of the port")
        if pre_order and isinstance(pre_order[0], (tuple, list)):
            raise NotImplementedError(
                "two sweeps per visit (SSOR) are not ported yet (later slice)")
        self.op = op
        self.omega = float(omega)
        self.coarse_scaling = float(coarse_scaling)
        self.coloring = coloring
        self.pre_order = tuple(int(c) for c in pre_order)
        self.post_order = tuple(int(c) for c in post_order)
        dt, dev = op.dtype, op.device
        self.masks = torch.as_tensor(coloring.masks(), dtype=dt, device=dev)
        self.coeffs = op.coeffs.contiguous()
        self.noise_scale = torch.sqrt(
            op.diag_stencil() * ((2.0 - self.omega) / self.omega)).contiguous()
        self.vc = tuple(n // 2 for n in op.vshape)
        m = op.m_lowrank
        if m:
            for name, bb in (("pre", Bbar_pre), ("post", Bbar_post)):
                if bb is None or bb.shape[0] != m:
                    raise ValueError(
                        f"B_bar ({name}) must hold {m} fields, one direction's "
                        "factor cannot stand in for the other's")
            self.B = op.lowrank.B.contiguous()
            self.Bbar_pre = Bbar_pre.to(device=dev, dtype=dt).contiguous()
            self.Bbar_post = Bbar_post.to(device=dev, dtype=dt).contiguous()
            self.lr_scale = 1.0 / torch.sqrt(op.lowrank.Sigma_diag)
            self.sigma_inv = (1.0 / op.lowrank.Sigma_diag).contiguous()
            # Gram matrix of the kernel's (I - G) B^T x residual shortcut
            self.G_pre = (self.B.reshape(m, -1) @ self.Bbar_pre.reshape(m, -1).T).contiguous()
            self._woodbury = {}
            for order in {self.pre_order, self.post_order}:
                Y, W = woodbury_factors(op, self.masks, self.omega, order)
                self._woodbury[order] = (Y.contiguous(), W.contiguous(), support_boxes(Y))
        else:
            self.B = self.Bbar_pre = self.Bbar_post = None
            self.lr_scale = self.sigma_inv = self.G_pre = None
            self._woodbury = {self.pre_order: (None, None, ()), self.post_order: (None, None, ())}
        self.const_coeffs, self.ns_const, self.bbox = compress_plan(op, self.omega)
        self.threads = default_threads(int(np.prod(op.vshape)))
        self.stream_threads = stream_threads(op.vshape[-1])
        self._params_cache = {}
        self._stream_bytes = None
        self._routes = {}
        self._split_launches = {}

    # ------------------------------------------------------------ noise
    def _draw(self, noise, x):
        """(xi, xi_lr, philox) for one visit.  Draw order of the tensor path:
        the field, then the low-rank scalars (as the composed sampler)."""
        if noise is None:
            return None, None, None
        philox = noise.philox_stream() if x.is_cuda else None
        xi = None if philox is not None else noise.normal(x.shape, x.dtype, x.device)
        xi_lr = None
        if self.B is not None:
            m = self.B.shape[0]
            xi_lr = noise.normal((x.shape[0], m), x.dtype, x.device) * self.lr_scale
        return xi, xi_lr, philox

    def descend(self, noise, f, x):
        """One descend visit; returns ``(x, f_coarse)``.  ``noise`` is a noise
        source or ``None`` for the deterministic data path.  On a CUDA device
        ``x`` is updated in place."""
        xi, xi_lr, philox = self._draw(noise, x)
        return descend_visit(self, f, x, xi=xi, xi_lr=xi_lr, philox=philox)

    def ascend(self, noise, f, x, x_coarse):
        """One ascend visit; returns ``x``.  On a CUDA device ``x`` is updated
        in place."""
        xi, xi_lr, philox = self._draw(noise, x)
        return ascend_visit(self, f, x, x_coarse, xi=xi, xi_lr=xi_lr, philox=philox)

    # -------------------------------------------------- kernel parameters
    @property
    def stream_bytes(self) -> int:
        """Dynamic shared memory of this level's larger stream launch (the
        descend in the pre order or the ascend in the post order)."""
        if self._stream_bytes is None:
            err = kernel_support_error(self.op, self.coloring.n_colors)
            if err is not None:
                raise NotImplementedError(err)
            H, W = self.op.vshape
            self._stream_bytes = max(
                stream_smem_bytes(H, W, max(self._lags(order)), self.op.m_lowrank,
                                  self.stream_threads, ascend)
                for order, ascend in ((self.pre_order, False), (self.post_order, True)))
        return self._stream_bytes

    def route(self, C: int) -> str:
        """The kernel a visit of ``C`` chains on this level launches
        (:func:`visit_route`): from the chain count and the level's shape,
        decided once per chain count."""
        return self._route(C)[0]

    def split_cluster(self, C: int) -> Optional[int]:
        """The cluster size of this level's split launches of ``C`` chains
        (:func:`split_cluster`); ``None`` where the route is not split."""
        return self._route(C)[1]

    def _route(self, C: int) -> Tuple[str, Optional[int]]:
        if C not in self._routes:
            route = visit_route(C, self.stream_bytes, self.op.device, vshape=self.op.vshape)
            S = split_cluster(C, self.op.vshape, self.op.device) if route == "split" else None
            self._routes[C] = (route, S)
        return self._routes[C]

    def _lags(self, order) -> Tuple[int, ...]:
        return wavefront_lags(self.op.offsets, self.coloring.weights,
                              self.coloring.n_colors, order)

    def _params(self, C: int, order, f_batched: bool, noise_mode: int, philox,
                route: Optional[str] = None):
        """The kernel's parameter block: a ``VisitParams`` for the phase and the
        split kernels, a ``StreamParams`` for the stream kernels.  ``route`` defaults to
        :meth:`route` of ``C``, so the kernel is chosen here, before the launch,
        once per launch configuration (the host's share of a launch matters on
        the small levels); only the Philox stream changes from launch to
        launch."""
        route = self.route(C) if route is None else route
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        key = (route, C, tuple(order), bool(f_batched), noise_mode)
        P = self._params_cache.get(key)
        if P is None:
            build = self._build_stream_params if route == "stream" else self._build_params
            P = self._params_cache[key] = build(*key[1:])
        visit = P.v if route == "stream" else P
        visit.seed, visit.counter = philox if philox is not None else (0, 0)
        return P

    def _build_stream_params(self, C: int, order, f_batched: bool,
                             noise_mode: int) -> StreamParams:
        S = StreamParams()
        S.v = self._build_params(C, order, f_batched, noise_mode)
        lags = self._lags(order)
        for o, lag in enumerate(lags):
            S.lag[o] = lag
        S.max_lag = max(lags)
        return S

    def _build_params(self, C: int, order, f_batched: bool, noise_mode: int) -> VisitParams:
        op = self.op
        err = kernel_support_error(op, self.coloring.n_colors)
        if err is not None:
            raise NotImplementedError(err)
        P = VisitParams()
        P.C = C
        P.H, P.W = op.vshape
        P.Hc, P.Wc = self.vc
        P.K, P.diag_index = len(op.offsets), op.diag_index
        for k, (off, cval) in enumerate(zip(op.offsets, self.const_coeffs)):
            P.dy[k], P.dx[k] = off
            P.coeff_const[k] = int(cval is not None)
            P.coeff_val[k] = 0.0 if cval is None else cval
        K = self.coloring.n_colors
        P.n_colors = K
        P.w0, P.w1 = (int(w) for w in self.coloring.weights)
        P.jstride = K // math.gcd(P.w1, K)
        P.n_order = len(order)
        for o, c in enumerate(order):
            P.order[o] = c
        P.omega, P.gamma = self.omega, self.coarse_scaling
        P.m = op.m_lowrank
        for k, (box, ybox) in enumerate(zip(self.bbox, self._woodbury[tuple(order)][2])):
            for q in range(4):
                P.bbox[k][q] = box[q]
                P.ybox[k][q] = ybox[q]
        P.noise_mode = noise_mode
        P.ns_const = int(self.ns_const is not None)
        P.ns_val = 0.0 if self.ns_const is None else self.ns_const
        P.f_batched = int(f_batched)
        return P


# ------------------------------------------------------------- plain versions
def _noisy_rhs_plain(level: FusedVisitLevel, f, xi, xi_lr):
    c = f + level.noise_scale * xi
    if xi_lr is not None:
        c = c + level.op.lowrank.expand(xi_lr)
    return c


def _woodbury_plain(level: FusedVisitLevel, Bbar, x):
    bt_x = level.op.lowrank.bt(x)
    m = bt_x.shape[-1]
    return x - (bt_x @ Bbar.reshape(m, -1)).reshape(x.shape)


def descend_visit_plain(level: FusedVisitLevel, f, x, xi=None, xi_lr=None):
    """Plain PyTorch version of the descend kernel: noisy rhs, ``sor_sweep``,
    Woodbury, residual, ``restrict``.  ``xi`` (shape of ``x``) and ``xi_lr``
    (``(C, m)``, pre-scaled by ``Sigma^{-1/2}``) are the normals; both ``None``
    runs the deterministic data path.  Returns new tensors ``(x, f_coarse)``."""
    op = level.op
    c = f if xi is None else _noisy_rhs_plain(level, f, xi, xi_lr)
    x = sor_sweep(op, level.masks, level.omega, level.pre_order, c, x)
    if level.B is not None:
        x = _woodbury_plain(level, level.Bbar_pre, x)
    r = f - op.apply(x)
    return x, restrict(r, dim=2)


def ascend_visit_plain(level: FusedVisitLevel, f, x, x_coarse, xi=None, xi_lr=None):
    """Plain PyTorch version of the ascend kernel: ``prolongate_add``, noisy
    rhs, ``sor_sweep`` in the post direction, Woodbury.  Returns a new ``x``."""
    x = prolongate_add(level.coarse_scaling, x_coarse, x, dim=2)
    c = f if xi is None else _noisy_rhs_plain(level, f, xi, xi_lr)
    x = sor_sweep(level.op, level.masks, level.omega, level.post_order, c, x)
    if level.B is not None:
        x = _woodbury_plain(level, level.Bbar_post, x)
    return x


# ------------------------------------------------------------------ wrappers
def _check_visit_args(level: FusedVisitLevel, f, x, xi, xi_lr, philox, x_coarse=None):
    """Validate what goes to the kernel by pointer; returns (C, f_batched,
    noise_mode)."""
    vshape = level.op.vshape
    if x.ndim != 3 or tuple(x.shape[1:]) != vshape:
        raise ValueError(f"x must be (C, {vshape[0]}, {vshape[1]}), got {tuple(x.shape)}")
    C = x.shape[0]
    f_batched = f.ndim == 3
    if tuple(f.shape) not in (vshape, (C,) + vshape):
        raise ValueError(f"f must be {vshape} or {(C,) + vshape}, got {tuple(f.shape)}")
    tensors = {"x": x, "f": f}
    if x_coarse is not None:
        if tuple(x_coarse.shape) != (C,) + level.vc:
            raise ValueError(f"x_coarse must be {(C,) + level.vc}, got {tuple(x_coarse.shape)}")
        tensors["x_coarse"] = x_coarse
    if xi is not None and philox is not None:
        raise ValueError("give the field noise as a tensor or as a Philox stream, not both")
    noise_mode = 0
    if philox is not None:
        noise_mode = 1
    elif xi is not None:
        noise_mode = 2
        if xi.shape != x.shape:
            raise ValueError(f"xi must have the shape of x, got {tuple(xi.shape)}")
        tensors["xi"] = xi
    m = level.op.m_lowrank
    if noise_mode and m:
        if xi_lr is None or tuple(xi_lr.shape) != (C, m):
            raise ValueError(f"xi_lr must be ({C}, {m}) when noise is on")
        tensors["xi_lr"] = xi_lr
    elif xi_lr is not None and not noise_mode:
        raise ValueError("xi_lr given without field noise")
    for name, t in tensors.items():
        if t.device != level.coeffs.device:
            raise ValueError(f"{name} lies on {t.device}, the level on {level.coeffs.device}")
        if t.dtype != torch.float32 or level.coeffs.dtype != torch.float32:
            raise TypeError("the fused level-visit kernels are float32 only "
                            f"({name} is {t.dtype}, the level {level.coeffs.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return C, f_batched, noise_mode


def descend_visit(level: FusedVisitLevel, f, x, xi=None, xi_lr=None,
                  philox: Optional[Tuple[int, int]] = None):
    """One fused descend visit; returns ``(x, f_coarse)``.

    ``f`` is ``(H, W)`` (shared) or ``(C, H, W)``; ``x`` is ``(C, H, W)``.  Field
    noise: ``philox=(seed, counter)`` for the in-kernel generator (CUDA only) or
    ``xi`` as a tensor; ``xi_lr`` is ``(C, m)`` pre-scaled by ``Sigma^{-1/2}``.
    No noise argument runs the deterministic data path.

    CPU tensors go to :func:`descend_visit_plain`.  CUDA tensors launch the
    kernel of ``level.route(C)``, which updates ``x`` in place, or raise."""
    if x.device.type == "cpu":
        if philox is not None:
            raise ValueError("the Philox stream exists in the CUDA kernel only")
        return descend_visit_plain(level, f, x, xi, xi_lr)
    return launch_descend(level, level.route(x.shape[0]), f, x, xi, xi_lr, philox)


def ascend_visit(level: FusedVisitLevel, f, x, x_coarse, xi=None, xi_lr=None,
                 philox: Optional[Tuple[int, int]] = None):
    """One fused ascend visit: ``x += gamma P x_c`` then the post Gibbs sweep
    and its Woodbury correction; returns ``x``.  Arguments as in
    :func:`descend_visit`; ``x_coarse`` is ``(C, H // 2, W // 2)``.

    CPU tensors go to :func:`ascend_visit_plain`.  CUDA tensors launch the
    kernel of ``level.route(C)``, which updates ``x`` in place, or raise."""
    if x.device.type == "cpu":
        if philox is not None:
            raise ValueError("the Philox stream exists in the CUDA kernel only")
        return ascend_visit_plain(level, f, x, x_coarse, xi, xi_lr)
    return launch_ascend(level, level.route(x.shape[0]), f, x, x_coarse, xi, xi_lr, philox)


def _on_card(x):
    if x.device.type != "cuda":
        raise ValueError("a visit kernel runs on a CUDA device; CPU tensors go to "
                         "the plain versions (descend_visit / ascend_visit choose)")


def _split_launch(level: FusedVisitLevel, C: int, cluster: Optional[int]) -> Tuple[int, int]:
    """``(S, threads)`` of a split launch of ``C`` chains: the level's rule
    unless ``cluster`` names the size; raises where the level does not split
    so.  Kept per launch configuration: the host's share of a launch matters
    at one chain."""
    key = (C, cluster)
    if key not in level._split_launches:
        S = level.split_cluster(C) if cluster is None else int(cluster)
        if S is None:
            raise ValueError(f"the split route takes no launch of {C} chains on a "
                             f"{level.op.vshape} level; name the cluster size")
        split_smem_bytes(*level.op.vshape, S)  # raises where the level does not split so
        level._split_launches[key] = (S, ss.split_threads(level.op.vshape, S))
    return level._split_launches[key]


def launch_descend(level: FusedVisitLevel, route: str, f, x, xi=None, xi_lr=None,
                   philox: Optional[Tuple[int, int]] = None, cluster: Optional[int] = None):
    """One descend visit through the kernel of ``route`` (one of
    :data:`ROUTES`), on CUDA tensors only; :func:`descend_visit` takes
    ``level.route(C)``, ``chip_smoke.py`` names it to hold the kernels against
    each other.  ``cluster`` sets the split route's cluster size (default: the
    level's rule, :meth:`FusedVisitLevel.split_cluster`).  Updates ``x`` in
    place; returns ``(x, f_coarse)``."""
    _on_card(x)
    C, f_batched, noise_mode = _check_visit_args(level, f, x, xi, xi_lr, philox)
    P = level._params(C, level.pre_order, f_batched, noise_mode, philox, route)
    Y, W, _ = level._woodbury[level.pre_order]
    fc = torch.empty((C,) + level.vc, dtype=x.dtype, device=x.device)
    common = (level.coeffs.data_ptr(), level.noise_scale.data_ptr(), _ptr(level.B), _ptr(Y),
              _ptr(W), _ptr(xi_lr), _ptr(level.sigma_inv), _ptr(level.G_pre), _ptr(xi))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "stream":
            lib = load_stream_library()
            err = lib.mgmc_stream_descend(ctypes.byref(P), x.data_ptr(), f.data_ptr(),
                                          fc.data_ptr(), *common, level.stream_threads, stream)
        elif route == "split":
            S, threads = _split_launch(level, C, cluster)
            err = load_split_library().mgmc_split_descend(
                ctypes.byref(P), x.data_ptr(), f.data_ptr(), fc.data_ptr(), *common, S, threads,
                stream)
        else:
            lib = load_library()
            scratch = torch.empty_like(x)
            err = lib.mgmc_descend_visit(ctypes.byref(P), x.data_ptr(), f.data_ptr(),
                                         scratch.data_ptr(), fc.data_ptr(), *common,
                                         level.threads, stream)
    name = KERNEL_NAMES[(route, "descend")]
    launch_counts[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return x, fc


def launch_ascend(level: FusedVisitLevel, route: str, f, x, x_coarse, xi=None, xi_lr=None,
                  philox: Optional[Tuple[int, int]] = None, cluster: Optional[int] = None):
    """One ascend visit through the kernel of ``route``, as
    :func:`launch_descend`.  Updates ``x`` in place and returns it."""
    _on_card(x)
    C, f_batched, noise_mode = _check_visit_args(level, f, x, xi, xi_lr, philox, x_coarse)
    P = level._params(C, level.post_order, f_batched, noise_mode, philox, route)
    Y, W, _ = level._woodbury[level.post_order]
    common = (level.coeffs.data_ptr(), level.noise_scale.data_ptr(), _ptr(level.B), _ptr(Y),
              _ptr(W), _ptr(xi_lr))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "stream":
            lib = load_stream_library()
            err = lib.mgmc_stream_ascend(ctypes.byref(P), x.data_ptr(), f.data_ptr(),
                                         x_coarse.data_ptr(), *common, _ptr(xi),
                                         level.stream_threads, stream)
        elif route == "split":
            S, threads = _split_launch(level, C, cluster)
            err = load_split_library().mgmc_split_ascend(
                ctypes.byref(P), x.data_ptr(), f.data_ptr(), x_coarse.data_ptr(), *common,
                _ptr(xi), S, threads, stream)
        else:
            lib = load_library()
            scratch = torch.empty_like(x) if noise_mode else x  # unused without noise
            err = lib.mgmc_ascend_visit(ctypes.byref(P), x.data_ptr(), f.data_ptr(),
                                        scratch.data_ptr(), x_coarse.data_ptr(), *common,
                                        _ptr(xi), level.threads, stream)
    name = KERNEL_NAMES[(route, "ascend")]
    launch_counts[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return x


# ---------------------------------------------------------------- the gating
def _sweep_spec(obj):
    """Normalise a smoother / sampler object into the fused-visit sweep spec
    ``(order, B_bar, coloring, omega)``, or None if a visit of it is not one
    directed SOR sweep."""
    if hasattr(obj, "smoother"):  # SORSampler
        return _sweep_spec(obj.smoother) if obj.nsmooth == 1 else None
    if hasattr(obj, "order"):  # SORSmoother
        if obj.nsmooth != 1:
            return None
        return obj.order, obj.B_bar, obj.coloring, obj.omega
    return None


def fused_levels_for(operators, presmoothers, postsmoothers, coarse_scaling,
                     min_vertices: int, force: Optional[bool] = None) -> dict:
    """Gating and construction of the per-level fused visits:
    ``{level: FusedVisitLevel}`` for every non-coarsest level with at least
    ``min_vertices`` unknowns.

    ``force=None`` (auto): on when the operators lie on a CUDA device - the
    kernels then serve batched chains - and off on the CPU.  In auto mode only
    two kinds of level are left to the composed path on the card: 3d levels
    (their kernels belong to a later slice) and levels in a dtype other than
    float32, which the caller chose.  A 2d float32 level that exceeds the
    kernels' own limits (measurements, colours, offsets, reach) raises
    ``NotImplementedError``: it never runs through the plain path unasked.
    ``force=True`` builds the levels on any device (on the CPU their plain
    versions run; the tests use this) and raises on every level the kernels
    cannot take; ``force=False`` turns them off."""
    if force is False:
        return {}
    if force is None and operators[0].device.type != "cuda":
        return {}
    levels = {}
    for level in range(len(operators) - 1):
        op = operators[level]
        pre = _sweep_spec(presmoothers[level])
        post = _sweep_spec(postsmoothers[level])
        if pre is None or post is None or op.lattice.nvertex < min_vertices:
            continue
        on_card = op.device.type == "cuda"
        err = kernel_support_error(op, pre[2].n_colors)
        if err is None and on_card and op.dtype != torch.float32:
            err = "the fused level-visit kernels are float32 only"
        if err is not None:
            if force or (on_card and len(op.vshape) == 2 and op.dtype == torch.float32):
                raise NotImplementedError(err)
            continue
        levels[level] = FusedVisitLevel(op, pre[2], pre[3], pre[0], post[0],
                                        pre[1], post[1], coarse_scaling)
    return levels
