"""Fused MGMC level-visit kernels: the whole descend / ascend of one level in
one CUDA kernel launch.

Replaces ``descend_visit`` / ``ascend_visit`` / ``FusedVisitLevel`` of
``multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py``.  One **descend visit** of
level l is, per directed sweep ``d`` of the pre visit (one: SOR; forward then
backward: SSOR), with fresh normals ``xi_d``, ``n_d``,

    c   = f + sqrt(D (2-omega)/omega) xi_d                      (Gibbs noise)
    x  <- colour-ordered SOR sweep(c, x)                        (direction d)
    x  <- x - Y_d u,  u = W_d (B^T x - Sigma^{1/2} n_d)         (Woodbury)

then, after the last,

    r   = f - A_stencil x - B t,  t = u + Sigma^{-1/2} n_d      (= f - A x)
    f_c = R r                                                   (full weighting)

and one **ascend visit** is

    x  <- x + gamma * P x_c                                     (prolongate_add)
    per directed sweep of the post visit, as above

with ``Y_d = M_d^{-1} B``, ``W_d = (Sigma + B^T Y_d)^{-1}`` and ``B_bar_d = Y_d
W_d``.  The TPU kernel adds ``B Sigma^{-1/2} n_d`` to the rhs and corrects with
``B_bar_d (B^T x)``, and forms ``t`` as ``Sigma^{-1} (I - G) B^T x`` with a
Gram matrix ``G``.  The sweep is linear, so the port's form gives the same
``x`` (``Y (I - W B^T Y) = Y W Sigma``) and ``t = Sigma^{-1} B^T x`` exactly
(``B^T x = Sigma u + Sigma^{1/2} n_d``).  The port's float32 visits and sweeps
no longer follow the TPU kernel's arithmetic at measured vertices; they compute
the same function, and in float64 they agree with the JAX package to rounding.
In float32 the TPU form cancels a term of about ``Sigma^{-1/2}`` (1e3 where
``Sigma`` is 1e-6) down to the size of ``x``.

Three hand-written CUDA kernels compute each visit, and the launch takes one
of them by the number of chains (:data:`SPLIT_MAX_CHAINS`, and
:data:`STREAM_MIN_CHAINS` per level shape), by the level's shape and stencil and by whether the kernel's
shared memory fits a block and its cluster schedules (:func:`visit_route`,
:func:`split_smem_bytes`, :func:`stream_smem_bytes`):

* the **split kernels** of ``csrc/mgmc_visit_split.cu`` (each chain's level
  split over a thread-block cluster of ``S`` blocks, each block's band of rows
  of ``x`` and of the rhs / residual in shared memory, halo rows and the
  partial sums of ``B^T x`` read from the neighbouring blocks' shared memory, a
  cluster barrier between phases; :func:`split_cluster` picks ``S``) - for
  few chains (at most :data:`SPLIT_MAX_CHAINS`), where one block per chain
  leaves the card idle and a visit is latency;
* the **phase kernels** of ``csrc/mgmc_visit.cu`` (one thread block per
  chain, whole-field passes over fields in device memory with a barrier
  between them: the passes of ``csrc/level_passes.cuh``, which the subtree
  kernel runs too - each low-rank term in one pass, the stencil in registers,
  each colour's rows over all warps; the level's tables of the launch's
  directions, :func:`phase_tables`, in each block's shared memory where they
  fit (:func:`phase_tables_fit`), else read from the device; the block size
  by the chain count, :func:`phase_threads`) - for the chain counts between
  the two thresholds, for levels the other two do not fit, and for two-sweep
  (SSOR) levels at every chain count the split kernels do not take;
* the **stream kernels** of ``csrc/mgmc_visit_stream.cu`` (one thread block per
  chain, the sweep as a wavefront of row blocks through a ring of rows in
  shared memory, every colour phase of a step at once; :func:`wavefront_lags`
  gives the schedule) - from the chain count of :data:`STREAM_MIN_CHAINS` for
  the level's shape and stencil form on, where each chain's field crosses the
  memory bus twice and not ten times; since the phase kernels run the passes
  of ``level_passes.cuh`` that is the flagship's 255^2 level from 256 chains,
  and no other level.

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
division per point) on few warps per SM, the phase kernels by the traffic of
their passes; ``PERF.md`` has their times.  The phase kernels have a stamps
build that times each pass (:func:`pass_times`).

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
normals.  The ``m`` low-rank normals per chain and sweep are always drawn
outside and passed in as drawn, ``(C, ndir m)``; a two-sweep launch takes two
Philox launch counters, one per direction (``NoiseSource.philox_streams(2)``),
and its field noise as a tensor is ``(2, C, ...)``.

Supported by the kernels: 2d, float32, one directed sweep per visit (SOR) or
two, forward then backward (SSOR; the phase and the split kernels, and the
smem kernels of :data:`SMEM_ROUTE` on the reach-1 levels of two sweeps that
``mgmc_visit_smem.SMEM_CHAINS`` lists: each chain's field in shared memory
through both sweeps), any reach-1 stencil (up to 9 offsets, per-point
coefficient planes, up to 8 colours), any number ``m`` of measurements whose
low-rank scratch a block can hold (:func:`max_lowrank`: 814 on a 2d reach-1
level, 1,604 on a reach-2 or 3d level) with dense ``B``, ``f`` shared or per
chain, noise on or off, any ``coarse_scaling``.  Up to :data:`LANE_SLOTS`
measurements the kernels keep the low-rank vectors one entry a lane in static
shared memory and the boxes in the parameter block; a level of more takes
an instance of each kernel compiled for it, with scratch in dynamic shared
memory sized by its ``m`` (:func:`lowrank_scratch_bytes`), which the phase
kernels place after their tables, the split and smem kernels after their
bands (so that their rules fit it before they take the route), and every box
read from the level's device tables (:meth:`FusedVisitLevel.box_table`; the
phase kernels' own tables hold them).  The stream kernels have no such
instance: they keep their cap, :data:`STREAM_MAX_LOWRANK`, and
:func:`visit_route` never hands them a level above it.  Reach-2 stencils (the squared
shifted-Laplace prior's 13-point diamond, up to 13 offsets, and the 5x5 box of
its Galerkin levels, up to 9 colours) take a route of their own,
:data:`SMEM_ROUTE` (``csrc/mgmc_visit_smem.cu``, :mod:`.mgmc_visit_smem`: each
chain's field in shared memory, in bands over a cluster where one block cannot
hold it), where its table lists the level's shape, form and sweeps, and
elsewhere the phase kernels of a third build of ``csrc/mgmc_visit.cu``
(``common.PHASE_REACH2_FLAGS``, :class:`WideVisitParams`, stencil forms 6-9).
3d levels (reach-1 stencils of up to 27 offsets, up to 8 colours: the FD
prior's 7-point level and its 27-point Galerkin levels) take :data:`SMEM_ROUTE`
too, from a source of their own (``csrc/mgmc_visit_smem3d.cu``,
:mod:`.mgmc_visit_smem3d`: each chain's field in shared memory, in slabs of
z-planes over a cluster) where its table lists the level's shape, form and
sweeps at the chain count, and elsewhere the phase kernels of a fourth build
(``common.PHASE_DIM3_FLAGS``, :class:`VolumeVisitParams`, stencil forms
10-15): the fields ``(C, Z, Y, X)`` row major as they are, a row ``(z, y)``,
3d measurement boxes and 3d transfers.  The split and stream kernels take 2d
reach-1 levels only, the stream kernels one sweep per visit.  Reach 3 and
reduced-precision transfers belong to later slices; the wrapper raises on
them.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...smoothers import sor_sweep, woodbury_factors
from ..intergrid import prolongate_add, restrict
from ..stencil import StencilOperator
from . import sor_sweep as ss
from .common import (PHASE_DIM3_FLAGS, PHASE_REACH2_FLAGS, PHASE_STAMPS_FLAGS,  # noqa: F401
                     compress_plan, default_threads, dynamic_smem_limit, open_library,
                     philox_normals_reference, sm_count, stamp_breakdown, support_boxes)
from .common import tensor_ptr as _ptr

MAX_OFFSETS = 9
MAX_COLORS = 8
#: measurements whose low-rank vectors the kernels keep one entry a lane in
#: static shared memory (``LANE_SLOTS`` in ``csrc/visit_phases.cuh``); a level
#: of more takes scratch in dynamic shared memory (:func:`lowrank_scratch_bytes`)
LANE_SLOTS = 32
#: the most measurements the stream kernels take (``STREAM_MAX_LOWRANK``: a bit
#: of a row's column mask each); :func:`visit_route` sends a level of more
#: to the phase kernels
STREAM_MAX_LOWRANK = LANE_SLOTS
#: directed sweeps per visit: one (SOR) or two, forward then backward (SSOR)
MAX_DIRS = 2
#: the limits of the phase kernels' reach-2 build (``VISIT_REACH 2`` in
#: ``csrc/mgmc_visit.cu``): the 5x5 box and the 9 colours ``coloring_for``
#: gives it, 512 threads a block
WIDE_MAX_OFFSETS = 25
WIDE_MAX_COLORS = 9
WIDE_MAX_THREADS = 512
#: the limits of the phase kernels' 3d build (``VISIT_DIM 3``): the 3x3x3 box,
#: 8 colours, 512 threads a block
DIM3_MAX_OFFSETS = 27
DIM3_MAX_THREADS = 512

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

#: ints of the split kernels' first-point table before the bands, per
#: direction, order index and row colour (``SPLIT_TABLE_INTS`` in the source)
SPLIT_TABLE_INTS = MAX_DIRS * MAX_COLORS * MAX_COLORS
#: the split kernels' static shared memory (``s_part``, ``s_all``, ``s_btx``,
#: ``s_lr``, ``s_u``; ``MAX_CLUSTER`` = 16 in the source)
SPLIT_STATIC_SMEM = 4 * (LANE_SLOTS + 16 * LANE_SLOTS + 3 * LANE_SLOTS)

#: the phase kernels' static shared memory (``s_btx``, per warp a slot of
#: ``LANE_SLOTS`` floats and 128 floats that stage the rhs pass's stores, the
#: barrier count and the stamps pointer); the library refuses to load where
#: the kernels declare more
PHASE_STATIC_SMEM = 4 * (LANE_SLOTS + 32 * LANE_SLOTS + 32 * 128) + 16
#: an H100 SM's shared memory and what the card keeps of it per block
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
#: an H100 SM's 32-bit registers
SM_REGISTERS = 65536

#: Threads per block of the phase kernels above one wave of one block per SM:
#: two blocks per SM, so that up to twice the SMs' chains run in one wave (264
#: on an H100); :func:`phase_threads` takes 1024 at and below 132 chains.
#: Measured with ``chip_smoke.py --phases threads``: device ms per descend plus
#: ascend on the flagship's 255^2 / 127^2 levels, 256 / 512 / 1024 threads,
#: NVIDIA H100 80GB HBM3, 700.00 W:
#:
#: ======  =========================  =========================
#: chains  255^2                      127^2
#: ======  =========================  =========================
#:     64  0.5125 / 0.3231 / 0.2621   0.1343 / 0.0921 / 0.0790
#:    128  0.6587 / 0.4248 / 0.3356   0.1371 / 0.0933 / 0.0799
#:    132  0.6580 / 0.4203 / 0.3413   0.1380 / 0.0929 / 0.0806
#:    200  0.7622 / 0.5857 / 0.5952   0.1885 / 0.1572 / 0.1578
#:    256  0.8054 / 0.6287 / 0.6602   0.2039 / 0.1603 / 0.1633
#: ======  =========================  =========================
#:
#: 1024 is fastest up to 132 chains, 512 at 200 and 256, on both levels.
PHASE_WAVE_THREADS = 512

#: Per level shape ``(H, W, stencil form)`` (:func:`stencil_form`) the least
#: chain count from which on a visit takes the stream kernels (where their
#: rings fit a block: :func:`visit_route`); a level shape not listed takes them
#: at no chain count.  Set from the ``visit_routes`` table of ``chip_smoke.py``,
#: which fails if the table supports another value for any level it times:
#: both kernels' device time per descend plus ascend at 1-512 chains on the
#: 255^2 and 127^2 flagship levels, and at 132, 256 and 512 on the 511^2 and
#: 255^2 (9-point) levels of a 512x512 lattice, NVIDIA H100 80GB HBM3, 700.00 W.
#: Since the phase kernels run the passes of ``csrc/level_passes.cuh`` the
#: stream kernels win only on the flagship's 255^2 5-point level, from 256
#: chains (0.6028 against 0.6479 ms, at 512 1.197 against 1.2526), and lose on
#: 127^2 (256 chains: 0.3338 against 0.1608), on the 511^2 level (2.9472
#: against 2.576) and on the 255^2 9-point level (1.3174 against 0.7702), so
#: no single chain count serves every level.  PERF.md section 6 holds the table.
#: The threshold holds for both sweep orders: the alternating schedule's odd
#: steps descend backward and ascend forward, and there the stream kernels win
#: by as much (0.5975 against 0.6426 ms at 256 chains, where the fixed orders
#: give 0.5977 against 0.6421; phase ``alternating``), so it is not keyed by
#: order.
STREAM_MIN_CHAINS: Dict[Tuple[int, int, int], int] = {(255, 255, 0): 256}

#: Launches of at most this many chains take the split kernels where their bands
#: fit a block and their cluster schedules (:func:`split_cluster`).  Set from the
#: split column of the ``visit_routes`` table of ``chip_smoke.py``, which fails
#: if the table supports another value: device time per descend plus ascend of
#: all three routes at 1, 4, 8, 16, 32, 64 and 132 chains on the flagship's 255^2
#: and 127^2 levels, the split kernels at every cluster size that fits, NVIDIA
#: H100 80GB HBM3, 700.00 W.  The split kernels at the rule's cluster size take
#: less than 0.90 of the phase kernels' time up to 8 chains on both levels (127^2
#: at 8: 0.0622 against 0.0718 ms) and not at 16 on 127^2 (0.0652 against 0.0722,
#: 0.903-0.908 in three runs), since the phase kernels take the low-rank noise
#: into the Woodbury correction (4.5-7.5% faster than with it in the rhs; 16
#: before, when 127^2 at 16 read 0.0664 against 0.0784).  On 255^2 they would win
#: up to 32 chains (0.30 of the phase kernels' time at 8, 0.51 at 16, 0.88 at
#: 32): one count for every level.  PERF.md section 6 holds the table.
SPLIT_MAX_CHAINS = 8

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

#: int64 words per block of the phase kernels' stamps (``PHASE_STAMP_WIDTH``
#: in ``csrc/mgmc_visit.cu``): the timer at entry, after each of up to
#: ``MAX_COLORS + 3`` passes of each of two directions and the descend's two
#: and at exit, the barriers passed, the SM
PHASE_STAMP_WIDTH = 1 + MAX_DIRS * (MAX_COLORS + 3) + 2 + 3
#: the same in the reach-2 build and its stamps build
WIDE_STAMP_WIDTH = 1 + MAX_DIRS * (WIDE_MAX_COLORS + 3) + 2 + 3

#: the route of the kernels with each chain's field in shared memory: 2d
#: (``csrc/mgmc_visit_smem.cu``, :mod:`.mgmc_visit_smem`) for the reach-2
#: levels, beside the phase kernels' reach-2 build, and for the reach-1 levels
#: of two sweeps a visit (SSOR) that its table lists, beside the phase and
#: split kernels; 3d (``csrc/mgmc_visit_smem3d.cu``, :mod:`.mgmc_visit_smem3d`).
#: The reach-1 routes of :data:`ROUTES` do not take a reach-2 or 3d level
SMEM_ROUTE = "smem"
#: the kernel counted by each launch on a 2d reach-1 level, by route (of
#: :data:`ROUTES` and :data:`SMEM_ROUTE`) and kind
KERNEL_NAMES = {(route, kind): f"{kind}_visit" + ("" if route == "phase" else f"_{route}")
                for route in ROUTES + (SMEM_ROUTE,) for kind in ("descend", "ascend")}
#: the kernel counted by a launch on a reach-2 level, by kind, whether the
#: stencil is the 5x5 box (forms 8, 9) or of at most 13 offsets, and route
#: (the phase kernels' reach-2 build or :data:`SMEM_ROUTE`)
REACH2_NAMES = {(kind, box, route): f"{kind}_visit_reach2_{'25' if box else '13'}pt"
                + ("_smem" if route == SMEM_ROUTE else "")
                for kind in ("descend", "ascend") for box in (False, True)
                for route in ("phase", SMEM_ROUTE)}
#: the kernel counted by a launch on a 3d level, by kind, whether the stencil
#: has more than 7 offsets (forms 12-15) and route (the phase kernels' 3d
#: build or :data:`SMEM_ROUTE`, ``csrc/mgmc_visit_smem3d.cu``)
DIM3_NAMES = {(kind, wide, route): f"{kind}_visit_3d_{'27' if wide else '7'}pt"
              + ("_smem" if route == SMEM_ROUTE else "")
              for kind in ("descend", "ascend") for wide in (False, True)
              for route in ("phase", SMEM_ROUTE)}
#: a launch of two sweeps (SSOR) counts as its one-sweep name with this ending
#: (the stream kernels take no such launch)
SSOR_SUFFIX = "_ssor"

#: kernel launches made by the wrappers (and only where they launch); the
#: reach-2 and 3d forms count apart, by the size of their stencil and route
#: (:data:`REACH2_NAMES`, :data:`DIM3_NAMES`), and each two-sweep (SSOR) form
#: apart from its one-sweep form (:data:`SSOR_SUFFIX`)
launch_counts: Dict[str, int] = {
    name + suffix: 0
    for name in (list(KERNEL_NAMES.values()) + list(REACH2_NAMES.values())
                 + list(DIM3_NAMES.values()))
    for suffix in (("",) if "stream" in name else ("", SSOR_SUFFIX))}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def lowrank_scratch_bytes(m: int, threads: int) -> int:
    """Dynamic shared memory the low-rank scratch of a level of ``m``
    measurements takes in a block of ``threads`` (``lowrank_scratch_floats``
    in ``csrc/visit_phases.cuh``): none up to :data:`LANE_SLOTS`, else the
    block's ``m``-vector and two per warp, each lane holding the entries
    ``lane, lane + 32, ...`` (the phase, smem and subtree kernels; the split
    kernels size theirs in :func:`split_smem_bytes`)."""
    return 4 * m * (1 + 2 * (int(threads) // 32)) if m > LANE_SLOTS else 0


def max_lowrank(threads: int) -> int:
    """The most measurements whose low-rank scratch (:func:`lowrank_scratch_bytes`)
    a phase block of ``threads`` holds beside the kernels' static share
    (:data:`PHASE_STATIC_SMEM`) under the shared memory a block may opt in to
    on an H100 (:data:`SMEM_PER_BLOCK_OPTIN`)."""
    return (SMEM_PER_BLOCK_OPTIN - PHASE_STATIC_SMEM) // (4 * (1 + 2 * (int(threads) // 32)))


def _visit_params_fields(max_offsets: int, max_colors: int, box_ints: int = 4):
    return [
        ("C", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("Hc", ctypes.c_int), ("Wc", ctypes.c_int),
        ("K", ctypes.c_int), ("diag_index", ctypes.c_int),
        ("dy", ctypes.c_int * max_offsets),
        ("dx", ctypes.c_int * max_offsets),
        ("coeff_const", ctypes.c_int * max_offsets),
        ("coeff_val", ctypes.c_float * max_offsets),
        ("n_colors", ctypes.c_int), ("w0", ctypes.c_int), ("w1", ctypes.c_int),
        ("jstride", ctypes.c_int),
        ("n_order", ctypes.c_int),
        ("order", ctypes.c_int * max_colors),
        ("omega", ctypes.c_float),
        ("gamma", ctypes.c_float),
        ("m", ctypes.c_int),
        # the first LANE_SLOTS boxes (a level of more: FusedVisitLevel.box_table)
        ("bbox", (ctypes.c_int * box_ints) * LANE_SLOTS),
        ("ybox", (ctypes.c_int * box_ints) * LANE_SLOTS),
        ("noise_mode", ctypes.c_int),
        ("ns_const", ctypes.c_int),
        ("ns_val", ctypes.c_float),
        ("f_batched", ctypes.c_int),
        ("seed", ctypes.c_ulonglong),
        ("counter", ctypes.c_ulonglong),
    ]


class VisitParams(ctypes.Structure):
    """Mirror of ``struct VisitParams`` in ``csrc/visit_phases.cuh``."""

    _fields_ = _visit_params_fields(MAX_OFFSETS, MAX_COLORS)


class WideVisitParams(ctypes.Structure):
    """Mirror of ``struct VisitParams`` in the phase kernels' reach-2 build
    (:data:`WIDE_MAX_OFFSETS` offsets, :data:`WIDE_MAX_COLORS` colours)."""

    _fields_ = _visit_params_fields(WIDE_MAX_OFFSETS, WIDE_MAX_COLORS)


class VolumeVisitParams(ctypes.Structure):
    """Mirror of ``struct VisitParams`` in the phase kernels' 3d build: 27
    offsets, 8 colours, boxes ``(k0, k1, i0, i1, j0, j1)``, and after the
    2d fields the z extents ``Z``, ``Zc``, the rows' extent ``Y``, ``Yc``
    (``H = Z Y``, ``Hc = Zc Yc``), the offsets ``dz`` and the colour weight
    ``wz`` of z (``w0`` is y's, ``w1`` x's)."""

    _fields_ = _visit_params_fields(DIM3_MAX_OFFSETS, MAX_COLORS, 6) + [
        ("Z", ctypes.c_int), ("Y", ctypes.c_int), ("Zc", ctypes.c_int), ("Yc", ctypes.c_int),
        ("dz", ctypes.c_int * DIM3_MAX_OFFSETS), ("wz", ctypes.c_int)]


class StreamParams(ctypes.Structure):
    """Mirror of ``struct StreamParams`` in ``csrc/mgmc_visit_stream.cu``: the
    phase kernels' parameter block and the wavefront's lag table."""

    _fields_ = [
        ("v", VisitParams),
        ("lag", ctypes.c_int * MAX_COLORS),
        ("max_lag", ctypes.c_int),
    ]


class PhaseTables(ctypes.Structure):
    """Mirror of ``struct PhaseTables`` in ``csrc/mgmc_visit.cu``: the word
    offsets of one level's tables for a launch's ``ndir`` sweep directions
    (:func:`phase_tables`; ``B``'s and ``Sigma^{1/2}`` shared, the rest per
    direction) and whether each block copies them into its shared memory."""

    _fields_ = ([(name, ctypes.c_int) for name in ("bval", "boff", "sroot", "bbox", "bspan",
                                                    "ndir")]
                + [(name, ctypes.c_int * MAX_DIRS) for name in
                   ("yval", "yoff", "wm", "ybox", "yspan", "rows")]
                + [(name, ctypes.c_int) for name in ("words", "shared")])


class SplitParams(ctypes.Structure):
    """Mirror of ``struct SplitParams`` in ``csrc/mgmc_visit_split.cu``: one
    ``VisitParams`` per sweep direction (its order, its ``Y`` boxes, its Philox
    counter) and their number."""

    _fields_ = [("v", VisitParams * MAX_DIRS), ("ndir", ctypes.c_int)]


def phase_threads(C: int, n: int, sms: int, reach: int = 1, dim: int = 2) -> int:
    """Threads per block of a phase launch of ``C`` chains on a level of ``n``
    points, on a card of ``sms`` SMs: ``default_threads(n)`` (1024 from 16,000
    points) while the chains fit one wave of one block per SM, at most
    :data:`PHASE_WAVE_THREADS` (two blocks per SM) above that; at most
    :data:`WIDE_MAX_THREADS` for a reach-2 or a 3d level, whose kernels are
    bounded to it."""
    threads = default_threads(n)
    threads = threads if C <= sms else min(threads, PHASE_WAVE_THREADS)
    return threads if reach < 2 and dim < 3 else min(threads, WIDE_MAX_THREADS)


#: the stencil forms the phase kernels are compiled for, one kernel each
#: (``STENCIL_FORMS`` in ``csrc/level_passes.cuh``): :func:`stencil_form`;
#: the reach-2 build's forms follow them (``WIDE_FORM0``, ``WIDE_FORMS``),
#: then the 3d build's (``DIM3_FORM0``, ``DIM3_FORMS``)
STENCIL_FORMS = 6
WIDE_FORM0 = 6
WIDE_FORMS = 4
DIM3_FORM0 = 10
DIM3_FORMS = 6


def stencil_reach(offsets) -> int:
    """The largest offset of a stencil along any axis."""
    return max(abs(int(v)) for off in offsets for v in off)


def raster_box(offsets, reach: int) -> bool:
    """Whether ``offsets`` are the ``(2 reach + 1)^d`` box in raster order."""
    dim = len(offsets[0])
    return tuple(tuple(int(v) for v in off) for off in offsets) == tuple(
        itertools.product(range(-reach, reach + 1), repeat=dim))


def stencil_form(offsets, const_coeffs) -> int:
    """The phase kernel a level's stencil takes (``stencil_form`` and the
    reach-2 and 3d forms of ``csrc/level_passes.cuh``): reach 1, 0 up to 5
    offsets, 2 the 3x3 box in raster order, 4 any other of up to 9; reach 2, 6
    up to 13 offsets, 8 the 5x5 box in raster order; 3d, 10 up to 7 offsets,
    12 the 3x3x3 box in raster order, 14 any other of up to 27; one more where
    a coefficient varies in space (``const_coeffs`` holds ``None`` for it,
    :func:`~.common.compress_plan`)."""
    if len(offsets[0]) == 3:
        base = 10 if len(offsets) <= 7 else (12 if raster_box(offsets, 1) else 14)
    elif stencil_reach(offsets) > 1:
        base = 8 if raster_box(offsets, 2) else WIDE_FORM0
    else:
        base = 0 if len(offsets) <= 5 else (2 if raster_box(offsets, 1) else 4)
    return base + int(any(c is None for c in const_coeffs))


def phase_tables_fit(table_bytes: int, threads: int, smem_limit: int) -> bool:
    """Whether a phase launch of ``threads`` per block keeps its tables
    (``table_bytes``) in each block's shared memory: they and the kernel's
    static share must fit both the block's limit ``smem_limit`` and the share
    of an SM's shared memory that leaves room for the blocks per SM the block
    size allows (a thread holds at most 64 registers: 1024 threads per SM)."""
    blocks = max(1, 1024 // threads)
    share = min(int(smem_limit), SM_SHARED_BYTES // blocks - BLOCK_RESERVED_BYTES)
    return table_bytes + PHASE_STATIC_SMEM <= share


# ----------------------------------------------------------------- the tables
class TableWords:
    """32-bit words of staged tables, put one part after the other; the offset
    of each part in words is what the kernels are handed."""

    def __init__(self):
        self.parts: list = []
        self.size = 0

    def put(self, a: np.ndarray) -> int:
        a = np.ascontiguousarray(a).view(np.int32).reshape(-1)
        self.parts.append(a)
        self.size += a.size
        return self.size - a.size

    def words(self) -> np.ndarray:
        """All words, padded to a multiple of 4 (the kernels copy int4s)."""
        self.put(np.zeros(-self.size % 4, np.int32))
        return np.concatenate(self.parts)


def box_slices(box) -> Tuple[slice, ...]:
    """The slices of a box ``(i0, i1, j0, j1)`` or ``(k0, k1, i0, i1, j0, j1)``."""
    return tuple(slice(box[a], box[a + 1]) for a in range(0, len(box), 2))


def staged_boxes(fields, boxes) -> Tuple[np.ndarray, np.ndarray]:
    """The values of each 2d or 3d field ``fields[k]`` inside ``boxes[k]`` (row
    major, column after column) as float32, and the ``m + 1`` starts of the
    columns."""
    vals = [np.zeros(0, np.float32)]
    if fields is not None:
        F = fields.detach().cpu().to(torch.float32).numpy()
        vals += [F[k][box_slices(box)].reshape(-1) for k, box in enumerate(boxes)]
    starts = np.cumsum([0] + [v.size for v in vals[1:]]).astype(np.int32)
    return np.concatenate(vals), starts


def small_table(t) -> np.ndarray:
    """A small matrix or vector as float32 words (none for ``None``)."""
    return np.zeros(0, np.float32) if t is None else (
        t.detach().cpu().to(torch.float32).numpy().reshape(-1))


def colour_rows(P: "VisitParams") -> np.ndarray:
    """Which rows of a sweep hold each colour: per colour of ``P.order``, ``1 +
    2 n_colors`` int32 words, the number ``R`` of row residues ``rho`` mod
    ``n_colors`` whose rows hold it, then ``R`` pairs ``(rho, first column of
    the colour in such a row)``, residues ascending.  The colour of ``(i, j)``
    is ``(w0 i + w1 j) mod n_colors``, as in the kernels' sweeps.  A 3d level
    (:class:`VolumeVisitParams`): ``1 + 3 n_colors^2`` words, ``R`` triples
    ``(z residue, y residue, first column)`` of the rows ``(z, y)`` whose
    residues mod ``n_colors`` are those, the colour of ``(z, y, j)`` being
    ``(wz z + w0 y + w1 j) mod n_colors``."""
    K, s = P.n_colors, P.jstride
    if isinstance(P, VolumeVisitParams):
        out = np.zeros((P.n_order, 1 + 3 * K * K), np.int32)
        for o in range(P.n_order):
            triples = []
            for zr, yr in itertools.product(range(K), repeat=2):
                first = [jj for jj in range(s) if (P.wz * zr + P.w0 * yr + P.w1 * jj) % K
                         == P.order[o]]
                triples += [(zr, yr, first[0])] if first else []
            out[o, 0] = len(triples)
            out[o, 1:1 + 3 * len(triples)] = np.asarray(triples, np.int32).reshape(-1)
        return out
    out = np.zeros((P.n_order, 1 + 2 * K), np.int32)
    for o in range(P.n_order):
        pairs = [(rho, next(jj for jj in range(s) if (P.w0 * rho + P.w1 * jj) % K == P.order[o]))
                 for rho in range(K)
                 if any((P.w0 * rho + P.w1 * jj) % K == P.order[o] for jj in range(s))]
        out[o, 0] = len(pairs)
        out[o, 1:1 + 2 * len(pairs)] = np.asarray(pairs, np.int32).reshape(-1)
    return out


def stage_level(words: TableWords, level: "FusedVisitLevel", orders) -> dict:
    """Put one level's tables into ``words``: per sweep order of ``orders``
    its :func:`colour_rows`, ``Y`` inside its boxes and ``W``; ``B`` inside its
    boxes; ``Sigma^{1/2}``.  Returns the word offsets: ``rows``, ``yval``,
    ``yoff`` and ``wm`` as lists by order, ``bval``, ``boff`` and ``sroot``."""
    off = {"rows": [], "yval": [], "yoff": [], "wm": []}
    for order in orders:
        off["rows"].append(words.put(colour_rows(level._build_params(1, order, True, 0))))
    bval, boff = staged_boxes(level.B, level.bbox)
    off["bval"], off["boff"] = words.put(bval), words.put(boff)
    for order in orders:
        Y, W, ybox = level._woodbury[tuple(order)]
        yval, yoff = staged_boxes(Y, ybox)
        off["yval"].append(words.put(yval))
        off["yoff"].append(words.put(yoff))
        off["wm"].append(words.put(small_table(W)))
    off["sroot"] = words.put(small_table(level.sigma_sqrt))
    return off


def row_spans(boxes, vshape) -> np.ndarray:
    """Per row of a level of shape ``vshape`` (row ``i < H`` in 2d, ``z Y + y``
    in 3d) the columns ``(lo, hi)`` that the boxes holding the row span,
    ``(2^30, 0)`` where none does (``row_span`` in ``csrc/level_passes.cuh``
    finds the same from a 2d level's boxes), as int32."""
    rows = tuple(vshape[:-1])
    out = np.tile(np.array([1 << 30, 0], np.int32), rows + (1,))
    for box in boxes:
        sl, (j0, j1) = box_slices(box[:-2]), box[-2:]
        out[sl + (0,)] = np.minimum(out[sl + (0,)], j0)
        out[sl + (1,)] = np.maximum(out[sl + (1,)], j1)
    return out.reshape(-1)


def phase_tables(level: "FusedVisitLevel", orders):
    """What a phase launch of ``level`` with the sweep ``orders`` (one order:
    SOR; forward and backward: SSOR) reads besides its fields:
    :func:`stage_level` for those orders, then ``B``'s and each order's ``Y``
    boxes (``m x 4`` int32 each, as ``VisitParams.bbox`` / ``ybox``) and per row
    the columns each set spans (:func:`row_spans`).  Returns ``(words,
    PhaseTables)``, the offsets filled in and ``shared`` left 0."""
    orders = tuple(tuple(o) for o in orders)
    if not 1 <= len(orders) <= MAX_DIRS:
        raise ValueError(f"a visit sweeps once or twice, got {len(orders)} orders")
    words = TableWords()
    off = stage_level(words, level, orders)
    T = PhaseTables()
    T.ndir = len(orders)
    T.bbox = words.put(np.asarray(level.bbox, np.int32).reshape(-1))
    T.bspan = words.put(row_spans(level.bbox, level.op.vshape))
    for d, order in enumerate(orders):
        ybox = level._woodbury[order][2]
        T.ybox[d] = words.put(np.asarray(ybox, np.int32).reshape(-1))
        T.yspan[d] = words.put(row_spans(ybox, level.op.vshape))
        for name in ("rows", "yval", "yoff", "wm"):
            getattr(T, name)[d] = off[name][d]
    for name in ("bval", "boff", "sroot"):
        setattr(T, name, off[name])
    out = words.words()
    T.words = out.size
    return out, T


def phase_barrier_count(level: "FusedVisitLevel", kind: str) -> int:
    """Barriers of one phase launch as ``csrc/level_passes.cuh`` places them:
    per sweep direction ``n_order + 3`` (the rhs - a descend's first is there
    with or without noise: it publishes the table copy -, the colours, ``B^T
    x``, the Woodbury correction), 2 fewer where ``m = 0``, and a descend 2
    more (the residual, the restriction); the stamps build counts them on the
    card."""
    lowrank = 2 if level.op.m_lowrank else 0
    return (sum(1 + len(order) + lowrank for order in level.orders(kind))
            + (2 if kind == "descend" else 0))


def stream_min_chains(vshape, form: int) -> Optional[int]:
    """The chain count from which on a visit of a level of shape ``vshape``
    and stencil form ``form`` takes the stream kernels
    (:data:`STREAM_MIN_CHAINS`); ``None``: at no count."""
    H, W = (int(v) for v in vshape)
    return STREAM_MIN_CHAINS.get((H, W, int(form)))


def visit_route(C: int, stream_bytes: int = 0, device=None,
                smem_limit: Optional[int] = None, vshape=None,
                form: Optional[int] = None, ndir: int = 1, m: int = 0) -> str:
    """The kernel a visit of ``C`` chains launches: for a reach-2 stencil form
    (forms 6-9) :data:`SMEM_ROUTE` where the level's shape ``vshape``, form and
    sweeps per visit ``ndir`` are listed in ``mgmc_visit_smem.SMEM_CHAINS``
    with ``C`` in their range (the level checks that a cluster fits:
    :meth:`FusedVisitLevel.route`), else ``"phase"``; for a reach-1 form
    (0-5) of two sweeps (``ndir`` 2) :data:`SMEM_ROUTE` where the same table
    lists it with ``C`` in range (one sweep: never), else as below; for a 3d form (10-15)
    :data:`SMEM_ROUTE` where ``mgmc_visit_smem3d.SMEM3D_ROUTES`` lists the
    shape, form and sweeps with ``C`` in a range
    (``mgmc_visit_smem3d.route_config``), else ``"phase"`` (the split and
    stream kernels take 2d reach-1 levels); ``"stream"`` for a
    visit of one sweep (``ndir``
    1: the stream kernels do not take two) from the threshold of the level's
    shape ``vshape`` and stencil form ``form`` on
    (:func:`stream_min_chains`; without both, never) where the stream kernels'
    shared memory (``stream_bytes``, :func:`stream_smem_bytes`) fits a block;
    ``"split"`` for a level of shape ``vshape`` where :func:`split_cluster`
    finds a cluster size (at most :data:`SPLIT_MAX_CHAINS` chains); ``"phase"``
    otherwise.  A level of ``m`` measurements takes the stream kernels only up
    to their cap, :data:`STREAM_MAX_LOWRANK` (above it the phase kernels at
    those chain counts), and the split kernels where their bands and the
    low-rank vectors of ``m`` fit (:func:`split_smem_bytes`).  A block is
    granted ``smem_limit`` bytes, by default what the probe finds on ``device``
    (:func:`~.common.dynamic_smem_limit`; on the CPU its default).  All of it
    is known before any launch."""
    if form is not None and form >= DIM3_FORM0:
        from .mgmc_visit_smem3d import route_config

        if vshape is not None and route_config(vshape, form, ndir, C) is not None:
            return SMEM_ROUTE
        return "phase"
    if form is not None and (form >= WIDE_FORM0 or ndir == 2):
        from .mgmc_visit_smem import SMEM_CHAINS

        span = None if vshape is None else SMEM_CHAINS.get(
            tuple(int(v) for v in vshape) + (int(form), int(ndir)))
        if span is not None and C >= span[0] and (span[1] is None or C <= span[1]):
            return SMEM_ROUTE
        if form >= WIDE_FORM0:
            return "phase"
    if smem_limit is None:
        smem_limit = dynamic_smem_limit(device)
    threshold = None if vshape is None or form is None else stream_min_chains(vshape, form)
    if (ndir == 1 and threshold is not None and C >= threshold and m <= STREAM_MAX_LOWRANK
            and stream_bytes + STREAM_STATIC_SMEM <= smem_limit):
        return "stream"
    if vshape is not None and split_cluster(C, vshape, device, smem_limit, m=m) is not None:
        return "split"
    return "phase"


def split_smem_bytes(H: int, W: int, S: int, m: int = 0) -> int:
    """Dynamic shared memory of one block of a split launch with clusters of
    ``S`` blocks on an ``H x W`` level of ``m`` measurements: the first-point
    table, the widest band of ``x``, the scratch band of the rhs and the
    residual and, above :data:`LANE_SLOTS` measurements, the ``(S + 4) m``
    floats of the low-rank vectors (the band's share of ``B^T x``, every
    rank's, ``B^T x - Sigma^1/2 n``, the normals, ``u``).  The host's mirror of
    ``mgmc_split_smem_bytes`` in ``csrc/mgmc_visit_split.cu``; ``ValueError``
    where the level cannot be split so (``S`` outside 2 .. 16, more blocks than
    rows)."""
    if not 2 <= S <= ss.SPLIT_SIZES[0] or S > H:
        raise ValueError(f"a level of {H} rows does not split over {S} blocks")
    widest = max(u1 - u0 for u0, u1 in split_bands(H, S))
    lowrank = (S + 4) * m if m > LANE_SLOTS else 0
    return 4 * (SPLIT_TABLE_INTS + 2 * widest * W + lowrank)


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


def split_active_clusters(S: int, vshape, device=None, m: int = 0) -> int:
    """How many clusters of ``S`` blocks of the split kernels on a level of
    shape ``vshape`` and ``m`` measurements the card holds at once, the fewer
    of the descend and the ascend kernel's (``sor_sweep.active_clusters``
    through the split kernels' own ``cudaOccupancyMaxActiveClusters`` entry
    point; on the CPU every cluster counts as running at once); 0 where such a
    cluster never schedules."""
    H, W = (int(v) for v in vshape)
    nbytes = split_smem_bytes(H, W, S, m)
    threads = ss.split_threads((H, W), S)
    device = "cuda" if device is None else device
    # kind 1 asks for the descend kernel, 0 for the ascend kernel
    return min(ss.active_clusters(device, kind, S, threads, nbytes, _split_occupancy_query)
               for kind in (1, 0))


def split_cluster(C: int, vshape, device=None, smem_limit: Optional[int] = None,
                  capped: bool = True, m: int = 0) -> Optional[int]:
    """The cluster size of a split launch of ``C`` chains on a level of shape
    ``vshape``: for at most :data:`SPLIT_MAX_CHAINS` chains (any number with
    ``capped=False``), of the sizes of ``sor_sweep.SPLIT_SIZES`` whose bands
    (and the static part) fit ``smem_limit`` (default: what the probe grants a
    block on ``device``) and whose clusters schedule, the one of least
    wave-counted cost (``sor_sweep.cheapest_cluster`` over
    :func:`split_active_clusters`, the fixed share of a wave
    :data:`SPLIT_WAVE_POINTS` over the level's points); ``None`` otherwise.
    ``m``: the level's measurements, whose low-rank vectors take shared
    memory above :data:`LANE_SLOTS` (:func:`split_smem_bytes`)."""
    if capped and C > SPLIT_MAX_CHAINS:
        return None
    H, W = (int(v) for v in vshape)
    if smem_limit is None:
        smem_limit = dynamic_smem_limit(device)
    active = {S: split_active_clusters(S, vshape, device, m) for S in ss.SPLIT_SIZES
              if S <= H and split_smem_bytes(H, W, S, m) + SPLIT_STATIC_SMEM <= smem_limit}
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
#: per build of the phase kernels, ``(reach, dim)``: the flags, the parameter
#: block, the first stencil form and the number of forms, the block bound and
#: the stamps' width
PHASE_BUILDS = {
    (1, 2): ((), VisitParams, 0, STENCIL_FORMS, 1024, PHASE_STAMP_WIDTH),
    (2, 2): (PHASE_REACH2_FLAGS, WideVisitParams, WIDE_FORM0, WIDE_FORMS, WIDE_MAX_THREADS,
             WIDE_STAMP_WIDTH),
    (1, 3): (PHASE_DIM3_FLAGS, VolumeVisitParams, DIM3_FORM0, DIM3_FORMS, DIM3_MAX_THREADS,
             PHASE_STAMP_WIDTH),
}


@functools.lru_cache(maxsize=None)
def load_library(stamps: bool = False, reach: int = 1, dim: int = 2) -> ctypes.CDLL:
    """Build (at first use) and load the phase kernels' shared library, or
    with ``reach=2`` their reach-2 build (``common.PHASE_REACH2_FLAGS``), or
    with ``dim=3`` their 3d build (``common.PHASE_DIM3_FLAGS``); with
    ``stamps`` the stamps build (``common.PHASE_STAMPS_FLAGS`` beside the
    build's flags) of any of the three."""
    if (reach, dim) not in PHASE_BUILDS:
        raise ValueError("the phase kernels have a reach-1 build, a reach-2 build and a 3d "
                         f"build, each with its stamps build; asked for reach {reach}, dim {dim}, "
                         f"stamps {stamps}")
    flags, params, form0, nforms, most, width = PHASE_BUILDS[(reach, dim)]
    lib = open_library(SOURCE_NAME, flags + PHASE_STAMPS_FLAGS if stamps else flags)
    i32 = ctypes.c_int
    for fn in (lib.mgmc_visit_stamps_build, lib.mgmc_visit_reach, lib.mgmc_visit_dim,
               lib.mgmc_visit_params_size, lib.mgmc_visit_tables_size,
               lib.mgmc_visit_stamp_width, lib.mgmc_visit_static_smem,
               lib.mgmc_visit_stencil_forms, lib.mgmc_visit_first_form,
               lib.mgmc_visit_max_threads):
        fn.argtypes = []
        fn.restype = i32
    if (lib.mgmc_visit_stamps_build(), lib.mgmc_visit_reach(), lib.mgmc_visit_dim()) != (
            int(stamps), reach, dim):
        raise RuntimeError("the phase kernels' library is not the build asked for")
    if lib.mgmc_visit_params_size() != ctypes.sizeof(params):
        raise RuntimeError(f"{params.__name__} layout differs between Python and CUDA")
    if lib.mgmc_visit_tables_size() != ctypes.sizeof(PhaseTables):
        raise RuntimeError("PhaseTables layout differs between Python and CUDA")
    if lib.mgmc_visit_stamp_width() != width:
        raise RuntimeError("the phase kernels' stamps differ in width between Python and CUDA")
    static = lib.mgmc_visit_static_smem()
    if not 0 <= static <= PHASE_STATIC_SMEM:
        raise RuntimeError(f"the phase kernels declare {static} bytes of static shared memory, "
                           f"more than the {PHASE_STATIC_SMEM} the table placement keeps")
    if (lib.mgmc_visit_first_form(), lib.mgmc_visit_stencil_forms()) != (form0, nforms):
        raise RuntimeError("the phase kernels' stencil forms differ between Python and CUDA")
    if lib.mgmc_visit_max_threads() != most:
        raise RuntimeError("the phase kernels' block bound differs between Python and CUDA")
    # descend, form, sweeps per visit (1 or 2), out
    lib.mgmc_visit_kernel_attributes.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    lib.mgmc_visit_kernel_attributes.restype = i32
    # descend, form, sweeps per visit, threads, dynamic shared bytes
    lib.mgmc_visit_blocks_per_sm.argtypes = [i32] * 5
    lib.mgmc_visit_blocks_per_sm.restype = i32
    ptr = ctypes.c_void_p
    # P, L, tables, x, f, scratch, fc, coeffs, ns, xilr, xi, form, threads, smem, stamps, stream
    lib.mgmc_descend_visit.argtypes = ([ctypes.POINTER(params), ctypes.POINTER(PhaseTables)]
                                       + [ptr] * 9 + [i32, i32, i32, ptr, ptr])
    lib.mgmc_descend_visit.restype = i32
    # P, L, tables, x, f, scratch, xc, coeffs, ns, xilr, xi, form, threads, smem, stamps, stream
    lib.mgmc_ascend_visit.argtypes = ([ctypes.POINTER(params), ctypes.POINTER(PhaseTables)]
                                      + [ptr] * 9 + [i32, i32, i32, ptr, ptr])
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
    # P, x, f, fc (descend) or xc (ascend), coeffs, ns, B, Y, W, xilr, sroot, xi, threads,
    # stream
    lib.mgmc_stream_descend.argtypes = [ctypes.POINTER(StreamParams)] + [ptr] * 11 + [i32, ptr]
    lib.mgmc_stream_descend.restype = i32
    lib.mgmc_stream_ascend.argtypes = [ctypes.POINTER(StreamParams)] + [ptr] * 11 + [i32, ptr]
    lib.mgmc_stream_ascend.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def load_split_library() -> ctypes.CDLL:
    """Build (at first use) and load the split kernels' shared library."""
    lib = open_library(SPLIT_SOURCE_NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mgmc_split_params_size.argtypes = []
    lib.mgmc_split_params_size.restype = i32
    if lib.mgmc_split_params_size() != ctypes.sizeof(SplitParams):
        raise RuntimeError("SplitParams layout differs between Python and CUDA")
    lib.mgmc_split_smem_bytes.argtypes = [i32] * 4  # H, W, S, m
    lib.mgmc_split_smem_bytes.restype = i32
    lib.mgmc_split_static_smem_bytes.argtypes = []
    lib.mgmc_split_static_smem_bytes.restype = i32
    # descend, S, threads, bytes, out clusters
    lib.mgmc_split_max_active.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.mgmc_split_max_active.restype = i32
    # P, x, f, fc (descend) or xc (ascend), coeffs, ns, B, Y0, W0, Y1, W1, xilr, sroot, xi,
    # boxes0, boxes1, S, threads, stream
    lib.mgmc_split_descend.argtypes = [ctypes.POINTER(SplitParams)] + [ptr] * 15 + [i32, i32, ptr]
    lib.mgmc_split_descend.restype = i32
    lib.mgmc_split_ascend.argtypes = [ctypes.POINTER(SplitParams)] + [ptr] * 15 + [i32, i32, ptr]
    lib.mgmc_split_ascend.restype = i32
    return lib


def kernel_support_error(op: StencilOperator, n_colors: int) -> Optional[str]:
    """Why the CUDA kernels cannot take this level, or None if they can: 2d,
    reach 1 (at most :data:`MAX_OFFSETS` offsets, :data:`MAX_COLORS` colours)
    or reach 2 (at most 13 offsets or the 5x5 box in raster order, at most
    :data:`WIDE_MAX_COLORS` colours; the phase kernels alone); 3d, reach 1
    (at most :data:`DIM3_MAX_OFFSETS` offsets, :data:`MAX_COLORS` colours; the
    phase kernels alone); at most as many measurements as the phase kernels'
    low-rank scratch at their largest block holds (:func:`max_lowrank`: 814 at
    1,024 threads, the reach-1 2d build's bound; 1,604 at 512, the reach-2 and
    3d builds')."""
    dim = len(op.vshape)
    if dim not in (2, 3):
        return f"the fused level-visit kernels take 2d and 3d levels ({dim}d)"
    reach = stencil_reach(op.offsets)
    if reach > 4 - dim:
        return (f"the fused level-visit kernels take {dim}d stencils of reach up to "
                f"{4 - dim} only (reach {reach})")
    if dim == 3 and len(op.offsets) > DIM3_MAX_OFFSETS:
        return f"a 3d stencil of more than {DIM3_MAX_OFFSETS} offsets"
    if dim == 2 and reach == 1 and len(op.offsets) > MAX_OFFSETS:
        return f"a reach-1 stencil of more than {MAX_OFFSETS} offsets"
    if reach == 2 and len(op.offsets) > 13 and not raster_box(op.offsets, 2):
        return "a reach-2 stencil of more than 13 offsets that is not the 5x5 box in raster order"
    most = WIDE_MAX_COLORS if reach == 2 else MAX_COLORS
    if n_colors > most:
        return f"more than {most} colours at reach {reach}"
    threads = 1024 if reach == 1 and dim == 2 else WIDE_MAX_THREADS
    most = max_lowrank(threads)
    if op.m_lowrank > most:
        return (f"more than {most} measurements: the low-rank scratch of a block of {threads} "
                f"threads ({lowrank_scratch_bytes(op.m_lowrank, threads)} bytes) and the kernels' "
                f"static {PHASE_STATIC_SMEM} bytes exceed the {SMEM_PER_BLOCK_OPTIN} bytes of "
                "shared memory a block may opt in to on an H100")
    return None


def route_support_error(level: "FusedVisitLevel", route: str, ndir: int = 1) -> Optional[str]:
    """Why the kernels of ``route`` cannot take a visit of ``ndir`` sweeps on
    ``level``, or None: the split and stream kernels take 2d reach-1 stencils
    only, the stream kernels one sweep and at most
    :data:`STREAM_MAX_LOWRANK` measurements; the smem kernels every level the
    kernels take (:func:`visit_route` gives them the levels their tables
    list: a 2d reach-1 level only with two sweeps, but a caller may name the
    route for one).  :func:`visit_route` never gives a route a visit it
    cannot take; this holds a route a caller names to it."""
    if route == "stream" and level.op.m_lowrank > STREAM_MAX_LOWRANK:
        return (f"the stream kernels take at most {STREAM_MAX_LOWRANK} measurements (a bit of "
                f"a row's column mask each), this level has {level.op.m_lowrank}: it takes the "
                "phase kernels")
    if route == "stream" and ndir > 1:
        return ("the stream kernels take one sweep per visit: a two-sweep (SSOR) level takes "
                "the phase or the split kernels")
    if route not in ("phase", SMEM_ROUTE) and level.reach > 1:
        return (f"the {route} kernels take reach-1 stencils only: a reach-2 level takes "
                "the phase or the smem kernels")
    if route not in ("phase", SMEM_ROUTE) and level.dim == 3:
        return (f"the {route} kernels take 2d levels only: a 3d level takes the phase or "
                "the smem kernels")
    return None


def smem_module(level: "FusedVisitLevel"):
    """The host side of the smem route for ``level``: :mod:`.mgmc_visit_smem`
    (2d reach 2) or :mod:`.mgmc_visit_smem3d` (3d)."""
    if level.dim == 3:
        from . import mgmc_visit_smem3d as module
    else:
        from . import mgmc_visit_smem as module
    return module


def _as_orders(orders) -> Tuple[Tuple[int, ...], ...]:
    """A visit's sweep orders as a tuple of orders; one order is wrapped, as
    the JAX package wraps it."""
    if orders and not isinstance(orders[0], (tuple, list)):
        orders = (orders,)
    return tuple(tuple(int(c) for c in order) for order in orders)


class FusedVisitLevel:
    """Per-level bundle of buffers and static configuration for the fused
    visit kernels: ``coeffs``, ``noise_scale``, ``B``, ``B_bar`` of the pre and
    the post visit (one directed sweep each: SOR; two, forward then backward:
    SSOR; ``len(orders) * m`` fields stacked, the Woodbury factor is direction
    dependent) and ``sigma_sqrt`` (``Sigma^{1/2}``).  The CUDA kernels and the
    plain versions apply ``B_bar`` of each direction as its factors ``Y =
    M^{-1} B`` (compact support, ``ybox``) and ``W``, ``B_bar_k = sum_l W[l, k]
    Y_l``.

    ``pre_orders`` / ``post_orders``: the colour order of each directed sweep
    of a descend / ascend visit, a tuple of orders (one order is wrapped)."""

    def __init__(self, op: StencilOperator, coloring, omega: float, pre_orders, post_orders,
                 Bbar_pre, Bbar_post, coarse_scaling: float):
        if len(op.vshape) not in (2, 3):
            raise NotImplementedError("fused level visits take 2d and 3d levels")
        self.op = op
        self.omega = float(omega)
        self.coarse_scaling = float(coarse_scaling)
        self.coloring = coloring
        self.pre_orders = _as_orders(pre_orders)
        self.post_orders = _as_orders(post_orders)
        for orders in (self.pre_orders, self.post_orders):
            if not 1 <= len(orders) <= MAX_DIRS:
                raise ValueError(f"a visit sweeps once or twice, got {len(orders)} orders")
        dt, dev = op.dtype, op.device
        self.masks = torch.as_tensor(coloring.masks(), dtype=dt, device=dev)
        self.coeffs = op.coeffs.contiguous()
        self.noise_scale = torch.sqrt(
            op.diag_stencil() * ((2.0 - self.omega) / self.omega)).contiguous()
        self.vc = tuple(n // 2 for n in op.vshape)
        m = op.m_lowrank
        if m:
            for name, bb, orders in (("pre", Bbar_pre, self.pre_orders),
                                     ("post", Bbar_post, self.post_orders)):
                if bb is None or bb.shape[0] != len(orders) * m:
                    raise ValueError(
                        f"B_bar ({name}) must stack {len(orders)} x {m} fields, one per "
                        "sweep: one direction's factor cannot stand in for the other's")
            self.B = op.lowrank.B.contiguous()
            self.Bbar_pre = Bbar_pre.to(device=dev, dtype=dt).contiguous()
            self.Bbar_post = Bbar_post.to(device=dev, dtype=dt).contiguous()
            self.sigma_sqrt = torch.sqrt(op.lowrank.Sigma_diag).contiguous()
            self._woodbury = {}
            for order in set(self.pre_orders + self.post_orders):
                Y, W = woodbury_factors(op, self.masks, self.omega, order)
                self._woodbury[order] = (Y.contiguous(), W.contiguous(), support_boxes(Y))
        else:
            self.B = self.Bbar_pre = self.Bbar_post = self.sigma_sqrt = None
            self._woodbury = {order: (None, None, ())
                              for order in self.pre_orders + self.post_orders}
        self.const_coeffs, self.ns_const, self.bbox = compress_plan(op, self.omega)
        #: the stencil's reach: 2 takes the phase kernels' reach-2 build
        self.reach = stencil_reach(op.offsets)
        #: the level's dimension: 3 takes the phase kernels' 3d build
        self.dim = len(op.vshape)
        #: the phase kernel of this level's stencil (:func:`stencil_form`)
        self.stencil_form = stencil_form(op.offsets, self.const_coeffs)
        self.stream_threads = stream_threads(op.vshape[-1])
        self._params_cache = {}
        self._phase_cache = {}
        self._phase_threads = {}
        self._stream_bytes = None
        self._routes = {}
        self._split_launches = {}
        self._smem_layouts = {}
        self._box_tables = {}

    @property
    def ndir(self) -> int:
        """Directed sweeps per visit: 1 (SOR) or 2 (SSOR), the larger of the
        pre and the post visit's."""
        return max(len(self.pre_orders), len(self.post_orders))

    @property
    def pre_order(self) -> Tuple[int, ...]:
        """The colour order of a one-sweep (SOR) level's descend."""
        return self._one_order(self.pre_orders)

    @property
    def post_order(self) -> Tuple[int, ...]:
        """The colour order of a one-sweep (SOR) level's ascend."""
        return self._one_order(self.post_orders)

    @staticmethod
    def _one_order(orders):
        if len(orders) != 1:
            raise ValueError(f"a visit of {len(orders)} sweeps has no single order: "
                             "pre_orders / post_orders hold them")
        return orders[0]

    def orders(self, kind: str) -> Tuple[Tuple[int, ...], ...]:
        """The sweep orders of a ``"descend"`` or an ``"ascend"`` visit."""
        return self.pre_orders if kind == "descend" else self.post_orders

    def woodbury_u(self, order, bt_x: torch.Tensor) -> torch.Tensor:
        """``u = W (B^T x - Sigma^{1/2} n)`` of the sweep ``order`` from its
        argument ``bt_x`` (``(C, m)``), as the kernels form it."""
        return bt_x @ self._woodbury[tuple(order)][1].T

    # ------------------------------------------------------------ noise
    def _draw(self, noise, x, kind: str = "descend"):
        """(xi, xi_lr, philox) for one visit of ``kind``: per directed sweep
        the field, then the ``m`` low-rank scalars (as the composed sampler
        draws them; :meth:`SSORSampler.apply` draws forward then backward).
        ``xi`` is ``x.shape`` for one sweep and ``(ndir,) + x.shape`` for two,
        ``xi_lr`` ``(C, ndir m)`` as drawn; on a CUDA device the field comes
        from ``ndir`` Philox launch counters where the source has them."""
        if noise is None:
            return None, None, None
        nd = len(self.orders(kind))
        philox = None
        if x.is_cuda:
            philox = noise.philox_stream() if nd == 1 else noise.philox_streams(nd)
        fields, lowrank = [], []
        for _ in range(nd):
            if philox is None:
                fields.append(noise.normal(x.shape, x.dtype, x.device))
            if self.B is not None:
                lowrank.append(noise.normal((x.shape[0], self.B.shape[0]), x.dtype, x.device))
        xi = None
        if fields:
            xi = fields[0] if nd == 1 else torch.stack(fields)
        xi_lr = torch.cat(lowrank, dim=1).contiguous() if lowrank else None
        return xi, xi_lr, philox

    def descend(self, noise, f, x):
        """One descend visit; returns ``(x, f_coarse)``.  ``noise`` is a noise
        source or ``None`` for the deterministic data path.  On a CUDA device
        ``x`` is updated in place."""
        xi, xi_lr, philox = self._draw(noise, x, "descend")
        return descend_visit(self, f, x, xi=xi, xi_lr=xi_lr, philox=philox)

    def ascend(self, noise, f, x, x_coarse):
        """One ascend visit; returns ``x``.  On a CUDA device ``x`` is updated
        in place."""
        xi, xi_lr, philox = self._draw(noise, x, "ascend")
        return ascend_visit(self, f, x, x_coarse, xi=xi, xi_lr=xi_lr, philox=philox)

    # -------------------------------------------------- kernel parameters
    @property
    def stream_bytes(self) -> int:
        """Dynamic shared memory of this level's larger stream launch (the
        descend in the pre order or the ascend in the post order; one-sweep
        levels only)."""
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
        (:func:`visit_route`): from the chain count, the level's shape and its
        sweeps per visit, decided once per chain count."""
        return self._route(C)[0]

    def split_cluster(self, C: int) -> Optional[int]:
        """The cluster size of this level's split or smem launches of ``C``
        chains (:func:`split_cluster`,
        ``mgmc_visit_smem.smem_cluster``, ``mgmc_visit_smem3d.smem_cluster``);
        ``None`` on another route."""
        return self._route(C)[1]

    def _route(self, C: int) -> Tuple[str, Optional[int]]:
        if C not in self._routes:
            # a reach-2 or 3d level takes neither the split nor the stream
            # kernels, a two-sweep level never the stream kernels: no stream
            # layout to size
            one = self.stencil_form < WIDE_FORM0 and self.ndir == 1
            route = visit_route(C, self.stream_bytes if one else 0, self.op.device,
                                vshape=self.op.vshape, form=self.stencil_form, ndir=self.ndir,
                                m=self.op.m_lowrank)
            S = None
            if route == "split":
                S = split_cluster(C, self.op.vshape, self.op.device, m=self.op.m_lowrank)
            elif route == SMEM_ROUTE:
                S = smem_module(self).smem_cluster(self, C)
                route = "phase" if S is None else route
            self._routes[C] = (route, S)
        return self._routes[C]

    def phase_threads(self, C: int) -> int:
        """Threads per block of this level's phase launches of ``C`` chains
        (:func:`phase_threads` on the card's SM count), decided once per chain
        count."""
        if C not in self._phase_threads:
            self._phase_threads[C] = phase_threads(C, int(np.prod(self.op.vshape)),
                                                   sm_count(self.op.device), self.reach, self.dim)
        return self._phase_threads[C]

    def phase_launch(self, orders, threads: int):
        """``(tables, PhaseTables, dynamic shared bytes)`` of a phase launch with
        the sweep ``orders`` and ``threads`` per block: the tables of
        :func:`phase_tables` as a device tensor, uploaded once, whether each
        block copies them into its shared memory (:func:`phase_tables_fit`,
        with the low-rank scratch beside them, against what the card grants a
        block) and the low-rank scratch of a level of more than
        :data:`LANE_SLOTS` measurements (:func:`lowrank_scratch_bytes`), after
        the tables; all decided before the launch and kept per launch
        configuration."""
        orders = _as_orders(orders)
        key = (orders, int(threads))
        if key not in self._phase_cache:
            words, T = phase_tables(self, orders)
            tensor = torch.from_numpy(words).to(self.op.device)
            lowrank = lowrank_scratch_bytes(self.op.m_lowrank, threads)
            T.shared = int(phase_tables_fit(4 * T.words + lowrank, threads,
                                             dynamic_smem_limit(self.op.device)))
            self._phase_cache[key] = (tensor, T, (4 * T.words if T.shared else 0) + lowrank)
        return self._phase_cache[key]

    def box_table(self, order):
        """The boxes of ``B``'s columns and of ``Y``'s of the sweep ``order``
        (``m x 4`` int32 each, 3d ``m x 6``) as one tensor on the level's
        device: the split and smem kernels of a level of more than
        :data:`LANE_SLOTS` measurements read them there (the parameter block
        holds the first :data:`LANE_SLOTS`); made once per order."""
        order = tuple(order)
        if order not in self._box_tables:
            ybox = self._woodbury[order][2]
            ints = np.asarray(list(self.bbox) + list(ybox), np.int32).reshape(-1)
            self._box_tables[order] = torch.from_numpy(ints).to(self.op.device)
        return self._box_tables[order]

    def _lags(self, order) -> Tuple[int, ...]:
        return wavefront_lags(self.op.offsets, self.coloring.weights,
                              self.coloring.n_colors, order)

    def _params(self, C: int, orders, f_batched: bool, noise_mode: int, philox,
                route: Optional[str] = None, smem=None):
        """The kernel's parameter block: a ``VisitParams`` (of the first order)
        for the phase kernels, a ``SplitParams`` for the split kernels, a
        ``StreamParams`` for the stream kernels, a ``SmemVisitParams`` for the
        smem kernels (the launch configuration ``smem``, a
        ``mgmc_visit_smem.SmemLayout`` or, 3d, a ``SmemVolumeParams`` from a
        ``mgmc_visit_smem3d.SmemLayout``; default: the rules' for ``C``).
        ``route`` defaults to :meth:`route` of ``C``, so the kernel is chosen
        here, before the launch, once per launch configuration (the host's
        share of a launch matters on the small levels); only the Philox stream
        changes from launch to launch (direction ``d`` of the split and smem
        kernels takes the counter ``+ d``; the phase kernels add it
        themselves)."""
        route = self.route(C) if route is None else route
        if route not in ROUTES + (SMEM_ROUTE,):
            raise ValueError(f"route must be one of {ROUTES + (SMEM_ROUTE,)}, got {route!r}")
        orders = _as_orders(orders)
        key = (route, C, orders, bool(f_batched), noise_mode, smem)
        P = self._params_cache.get(key)
        if P is None:
            err = route_support_error(self, route, len(orders))
            if err is not None:
                raise NotImplementedError(err)
            if route == SMEM_ROUTE:
                smem = smem_module(self).layout(self, orders, C=C) if smem is None else smem
                P = smem.params(self, C, orders, f_batched, noise_mode)
            elif route == "stream":
                P = self._build_stream_params(C, orders[0], f_batched, noise_mode)
            elif route == "split":
                P = SplitParams()
                P.ndir = len(orders)
                for d, order in enumerate(orders):
                    P.v[d] = self._build_params(C, order, f_batched, noise_mode)
            else:
                P = self._build_params(C, orders[0], f_batched, noise_mode)
            self._params_cache[key] = P
        seed, counter = philox if philox is not None else (0, 0)
        if route in ("split", SMEM_ROUTE):
            for d in range(P.ndir):
                P.v[d].seed, P.v[d].counter = seed, counter + (d if philox is not None else 0)
        else:
            visit = P.v if route == "stream" else P
            visit.seed, visit.counter = seed, counter
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

    def _build_params(self, C: int, order, f_batched: bool, noise_mode: int):
        op = self.op
        err = kernel_support_error(op, self.coloring.n_colors)
        if err is not None:
            raise NotImplementedError(err)
        P = PHASE_BUILDS[(self.reach, self.dim)][1]()
        P.C = C
        # a 3d level's rows are (z, y): H = Z Y rows of W points
        P.H, P.W = int(np.prod(op.vshape[:-1])), op.vshape[-1]
        P.Hc, P.Wc = int(np.prod(self.vc[:-1])), self.vc[-1]
        P.K, P.diag_index = len(op.offsets), op.diag_index
        for k, (off, cval) in enumerate(zip(op.offsets, self.const_coeffs)):
            P.dy[k], P.dx[k] = off[-2:]
            if self.dim == 3:
                P.dz[k] = off[0]
            P.coeff_const[k] = int(cval is not None)
            P.coeff_val[k] = 0.0 if cval is None else cval
        K = self.coloring.n_colors
        P.n_colors = K
        P.w0, P.w1 = (int(w) for w in self.coloring.weights[-2:])
        if self.dim == 3:
            P.Z, P.Y = op.vshape[:2]
            P.Zc, P.Yc = self.vc[:2]
            P.wz = int(self.coloring.weights[0])
        P.jstride = K // math.gcd(P.w1, K)
        P.n_order = len(order)
        for o, c in enumerate(order):
            P.order[o] = c
        P.omega, P.gamma = self.omega, self.coarse_scaling
        P.m = op.m_lowrank
        boxes = zip(self.bbox, self._woodbury[tuple(order)][2])
        for k, (box, ybox) in zip(range(LANE_SLOTS), boxes):
            for q in range(2 * self.dim):
                P.bbox[k][q] = box[q]
                P.ybox[k][q] = ybox[q]
        P.noise_mode = noise_mode
        P.ns_const = int(self.ns_const is not None)
        P.ns_val = 0.0 if self.ns_const is None else self.ns_const
        P.f_batched = int(f_batched)
        return P


# ------------------------------------------------------------- plain versions
def _sweeps_plain(level: FusedVisitLevel, orders, Bbar, f, x, xi, xi_lr):
    """The directed sweeps of one visit, each with its noise and its Woodbury
    correction ``x - Y_d u``, ``u = W_d (B^T x - Sigma^{1/2} n_d)`` (applied as
    ``B_bar_d`` to ``B^T x - Sigma^{1/2} n_d``).  Returns ``(x, t)``: ``t = u +
    Sigma^{-1/2} n_d`` of the last sweep, ``Sigma^{-1} B^T x`` of the returned
    ``x`` (``None`` without measurements)."""
    op, m, t = level.op, level.op.m_lowrank, None
    for d, order in enumerate(orders):
        c = f
        if xi is not None:
            c = f + level.noise_scale * (xi if len(orders) == 1 else xi[d])
        x = sor_sweep(op, level.masks, level.omega, order, c, x)
        if m:
            n = None if xi_lr is None else xi_lr[:, d * m:(d + 1) * m]
            bt_x = op.lowrank.bt(x)
            if n is not None:
                bt_x = bt_x - level.sigma_sqrt * n
            x = x - (bt_x @ Bbar[d * m:(d + 1) * m].reshape(m, -1)).reshape(x.shape)
            t = level.woodbury_u(order, bt_x)
            if n is not None:
                t = t + n / level.sigma_sqrt
    return x, t


def descend_visit_plain(level: FusedVisitLevel, f, x, xi=None, xi_lr=None):
    """Plain PyTorch version of the descend kernel: per directed sweep the
    noisy rhs, ``sor_sweep`` and the Woodbury correction, then the residual
    ``f - A_stencil x - B t`` and ``restrict``.  ``xi`` (the shape of ``x``;
    ``(2,) + x.shape`` for two sweeps) and ``xi_lr`` (``(C, ndir m)``, as
    drawn) are the normals; both ``None`` runs the deterministic data path.
    Returns new tensors ``(x, f_coarse)``."""
    op = level.op
    x, t = _sweeps_plain(level, level.pre_orders, level.Bbar_pre, f, x, xi, xi_lr)
    r = f - op.apply_stencil(x)
    if t is not None:
        r = r - op.lowrank.expand(t)
    return x, restrict(r, dim=level.dim)


def ascend_visit_plain(level: FusedVisitLevel, f, x, x_coarse, xi=None, xi_lr=None):
    """Plain PyTorch version of the ascend kernel: ``prolongate_add``, then per
    directed sweep of the post visit the noisy rhs, ``sor_sweep`` and the
    Woodbury correction.  Returns a new ``x``."""
    x = prolongate_add(level.coarse_scaling, x_coarse, x, dim=level.dim)
    return _sweeps_plain(level, level.post_orders, level.Bbar_post, f, x, xi, xi_lr)[0]


# ------------------------------------------------------------------ wrappers
def _check_visit_args(level: FusedVisitLevel, f, x, xi, xi_lr, philox, x_coarse=None,
                      nd: int = 1):
    """Validate what goes to the kernel by pointer for a visit of ``nd``
    directed sweeps; returns (C, f_batched, noise_mode)."""
    vshape = level.op.vshape
    if x.ndim != 1 + len(vshape) or tuple(x.shape[1:]) != vshape:
        raise ValueError(f"x must be (C, {', '.join(map(str, vshape))}), got {tuple(x.shape)}")
    C = x.shape[0]
    f_batched = f.ndim == x.ndim
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
        want = tuple(x.shape) if nd == 1 else (nd,) + tuple(x.shape)
        if tuple(xi.shape) != want:
            raise ValueError(f"xi must be {want} (one field per sweep), got {tuple(xi.shape)}")
        tensors["xi"] = xi
    m = level.op.m_lowrank
    if noise_mode and m:
        if xi_lr is None or tuple(xi_lr.shape) != (C, nd * m):
            raise ValueError(f"xi_lr must be ({C}, {nd * m}) when noise is on")
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

    ``f`` is ``(H, W)`` (shared) or ``(C, H, W)``; ``x`` is ``(C, H, W)`` (a 3d
    level: ``(Z, Y, X)`` or ``(C, Z, Y, X)``, and ``(C, Z, Y, X)``).  Field
    noise: ``philox=(seed, counter)`` for the in-kernel generator (CUDA only;
    direction ``d`` of a two-sweep visit takes the counter ``+ d``) or ``xi``
    as a tensor (two sweeps: ``(2, C, ...)``); ``xi_lr`` is ``(C, ndir m)``, the
    low-rank normals as drawn.  No noise argument runs the deterministic data
    path.

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
    :func:`descend_visit`; ``x_coarse`` is ``(C, H // 2, W // 2)`` (3d: every
    extent halved).

    CPU tensors go to :func:`ascend_visit_plain`.  CUDA tensors launch the
    kernel of ``level.route(C)``, which updates ``x`` in place, or raise."""
    if x.device.type == "cpu":
        if philox is not None:
            raise ValueError("the Philox stream exists in the CUDA kernel only")
        return ascend_visit_plain(level, f, x, x_coarse, xi, xi_lr)
    return launch_ascend(level, level.route(x.shape[0]), f, x, x_coarse, xi, xi_lr, philox)


def box_pointers(level: FusedVisitLevel, orders) -> Tuple[int, int]:
    """The device box tables of a launch's sweep orders (``box_table``; the
    second 0 for one sweep) that the split and smem kernels of a level of more
    than :data:`LANE_SLOTS` measurements read; 0, 0 for a level of fewer,
    whose boxes the parameter blocks hold."""
    if level.op.m_lowrank <= LANE_SLOTS:
        return 0, 0
    ptrs = [level.box_table(order).data_ptr() for order in orders]
    return ptrs[0], (ptrs[1] if len(ptrs) > 1 else 0)


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


def stamp_shape(level: FusedVisitLevel, route: str, C: int, S: int = 1) -> Tuple[int, int]:
    """The stamps tensor of a launch of ``C`` chains: a row per block, of the
    width of its build (the phase kernels' reach-1, reach-2 and 3d builds,
    the smem kernels with clusters of ``S``).  ``ValueError`` where the
    kernels have no stamps build (the split and stream kernels)."""
    if route == SMEM_ROUTE:
        return C * S, smem_module(level).STAMP_WIDTH
    if route != "phase":
        raise ValueError("no stamps build for this launch: the phase kernels (every build) "
                         "and the smem kernels have a stamps build, the split and stream "
                         "kernels none")
    return C, (WIDE_STAMP_WIDTH if level.reach > 1 else PHASE_STAMP_WIDTH)


def _check_stamps(level: FusedVisitLevel, route: str, stamps, x, S: int = 1) -> None:
    if stamps is None:
        return
    want = stamp_shape(level, route, x.shape[0], S)
    if (stamps.dtype != torch.int64 or stamps.device != x.device
            or tuple(stamps.shape) != want or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be a contiguous int64 {want} tensor on {x.device}")


def kernel_name(level: FusedVisitLevel, route: str, kind: str) -> str:
    """The kernel a launch of ``kind`` through ``route`` on ``level`` counts
    (:data:`KERNEL_NAMES`; a reach-2 level's :data:`REACH2_NAMES`, a 3d
    level's :data:`DIM3_NAMES`; with :data:`SSOR_SUFFIX` for two sweeps)."""
    if level.dim == 3:
        name = DIM3_NAMES[(kind, level.stencil_form >= 12,
                           SMEM_ROUTE if route == SMEM_ROUTE else "phase")]
    elif level.reach > 1:
        name = REACH2_NAMES[(kind, level.stencil_form >= 8,
                             SMEM_ROUTE if route == SMEM_ROUTE else "phase")]
    else:
        name = KERNEL_NAMES[(route, kind)]
    return name + (SSOR_SUFFIX if len(level.orders(kind)) > 1 else "")


def launch_descend(level: FusedVisitLevel, route: str, f, x, xi=None, xi_lr=None,
                   philox: Optional[Tuple[int, int]] = None, cluster: Optional[int] = None,
                   stamps: Optional[torch.Tensor] = None, threads: Optional[int] = None,
                   c_shared: Optional[bool] = None):
    """One descend visit through the kernel of ``route`` (one of
    :data:`ROUTES`, or :data:`SMEM_ROUTE`), on CUDA tensors only;
    :func:`descend_visit` takes ``level.route(C)``, ``chip_smoke.py`` names it
    to hold the kernels against each other.  ``cluster`` sets the split and
    smem routes' cluster size (default: the level's rule,
    :meth:`FusedVisitLevel.split_cluster`).  Measurement aids that production
    calls leave ``None``: ``threads`` sets the block size of the phase and
    smem routes (default: their rules); ``c_shared`` whether the smem route
    keeps ``c`` in shared memory (default: the route's table or rules);
    ``stamps`` takes the phase or smem kernels' stamps build, an int64 tensor
    of :func:`stamp_shape` that receives per block the timer at entry, after
    each pass and at exit, the barriers passed and the SM (:func:`pass_times`).
    Updates ``x`` in place; returns ``(x, f_coarse)``."""
    return _launch(level, route, "descend", f, x, None, xi, xi_lr, philox, cluster, stamps,
                   threads, c_shared)


def launch_ascend(level: FusedVisitLevel, route: str, f, x, x_coarse, xi=None, xi_lr=None,
                  philox: Optional[Tuple[int, int]] = None, cluster: Optional[int] = None,
                  stamps: Optional[torch.Tensor] = None, threads: Optional[int] = None,
                  c_shared: Optional[bool] = None):
    """One ascend visit through the kernel of ``route``, as
    :func:`launch_descend`.  Updates ``x`` in place and returns it."""
    return _launch(level, route, "ascend", f, x, x_coarse, xi, xi_lr, philox, cluster, stamps,
                   threads, c_shared)


def _launch(level: FusedVisitLevel, route: str, kind: str, f, x, x_coarse, xi, xi_lr, philox,
            cluster, stamps, threads, c_shared=None):
    _on_card(x)
    descend = kind == "descend"
    orders = level.orders(kind)
    smem = None
    if route == SMEM_ROUTE:
        err = route_support_error(level, route, len(orders))
        if err is not None:
            raise NotImplementedError(err)
        S = level.split_cluster(x.shape[0]) if cluster is None and level.route(
            x.shape[0]) == SMEM_ROUTE else cluster
        smem = smem_module(level).layout(level, orders, S, c_shared, threads, x.shape[0])
    _check_stamps(level, route, stamps, x, smem.S if smem is not None else 1)
    C, f_batched, noise_mode = _check_visit_args(level, f, x, xi, xi_lr, philox,
                                                 None if descend else x_coarse, len(orders))
    P = level._params(C, orders, f_batched, noise_mode, philox, route, smem)
    out = torch.empty((C,) + level.vc, dtype=x.dtype, device=x.device) if descend else x_coarse
    coarse = out.data_ptr()  # f_c written by a descend, x_c read by an ascend
    ns, sroot = level.noise_scale.data_ptr(), _ptr(level.sigma_sqrt)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == SMEM_ROUTE:
            err = smem_module(level).launch(level, kind, P, smem, f, x, out, xi, xi_lr, stamps,
                                            stream)
        elif route == "phase":
            threads = level.phase_threads(C) if threads is None else int(threads)
            tables, L, smem = level.phase_launch(orders, threads)
            scratch = torch.empty_like(x) if (descend or noise_mode) else x  # unused otherwise
            lib = load_library(stamps is not None, level.reach, level.dim)
            fn = lib.mgmc_descend_visit if descend else lib.mgmc_ascend_visit
            err = fn(ctypes.byref(P), ctypes.byref(L), tables.data_ptr(), x.data_ptr(),
                     f.data_ptr(), scratch.data_ptr(), coarse, level.coeffs.data_ptr(), ns,
                     _ptr(xi_lr), _ptr(xi), level.stencil_form, threads, smem, _ptr(stamps),
                     stream)
        elif route == "stream":
            Y, W, _ = level._woodbury[orders[0]]
            lib = load_stream_library()
            fn = lib.mgmc_stream_descend if descend else lib.mgmc_stream_ascend
            err = fn(ctypes.byref(P), x.data_ptr(), f.data_ptr(), coarse,
                     level.coeffs.data_ptr(), ns, _ptr(level.B), _ptr(Y), _ptr(W), _ptr(xi_lr),
                     sroot, _ptr(xi), level.stream_threads, stream)
        else:
            S, nthreads = _split_launch(level, C, cluster)
            factors = [level._woodbury[order][:2] for order in orders] + [(None, None)]
            lib = load_split_library()
            fn = lib.mgmc_split_descend if descend else lib.mgmc_split_ascend
            err = fn(ctypes.byref(P), x.data_ptr(), f.data_ptr(), coarse,
                     level.coeffs.data_ptr(), ns, _ptr(level.B), _ptr(factors[0][0]),
                     _ptr(factors[0][1]), _ptr(factors[1][0]), _ptr(factors[1][1]),
                     _ptr(xi_lr), sroot, _ptr(xi), *box_pointers(level, orders), S, nthreads,
                     stream)
    name = kernel_name(level, route, kind)
    launch_counts[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return (x, out) if descend else x


def pass_names(level: FusedVisitLevel, kind: str):
    """The passes of a phase visit with noise on, in the order the kernel's
    stamps time them (each ends with a barrier); a two-sweep visit names its
    directions' passes ``d0: ...`` and ``d1: ...``."""
    orders = level.orders(kind)
    names = []
    for d, order in enumerate(orders):
        first = "prolongation + rhs" if kind == "ascend" and d == 0 else "rhs"
        own = [first] + [f"colour {c}" for c in order]
        if level.op.m_lowrank:
            own += ["B^T x", "Woodbury"]
        names += own if len(orders) == 1 else [f"d{d}: {name}" for name in own]
    if kind == "descend":
        names += ["residual", "restriction"]
    return names


def pass_times(level: FusedVisitLevel, kind: str, stamps) -> dict:
    """Where one phase launch (noise on) went, from the ``stamps`` it wrote,
    in microseconds: per pass the median over the blocks (``passes``; the
    first pass from the block's entry), ``exit_us`` after the last, ``sum_us``
    their sum; per block the span from entry to exit, its median
    (``block_span_us``) and the largest; ``launch_span_us`` from the first
    entry to the last exit; measured on the card, not modelled: the barriers
    each block passed (``barriers_per_block``, the distinct counts), the most
    blocks one SM ran at once and the SMs used."""
    return stamp_breakdown(stamps, pass_names(level, kind),
                           stamp_shape(level, "phase", 1)[1])


# ---------------------------------------------------------------- the gating
def _sweep_spec(obj):
    """Normalise a smoother / sampler object into the fused-visit sweep spec
    ``(orders, B_bar, coloring, omega)`` - one directed sweep (SOR) or two,
    forward then backward (SSOR), with the directions' ``B_bar`` stacked - or
    None if a visit of it is neither."""
    if hasattr(obj, "smoother"):  # SORSampler
        return _sweep_spec(obj.smoother) if obj.nsmooth == 1 else None
    if hasattr(obj, "order"):  # SORSmoother
        if obj.nsmooth != 1:
            return None
        return (obj.order,), obj.B_bar, obj.coloring, obj.omega
    if hasattr(obj, "forward"):  # SSORSmoother / SSORSampler
        if obj.nsmooth != 1:
            return None
        fw, bw = _sweep_spec(obj.forward), _sweep_spec(obj.backward)
        if fw is None or bw is None:
            return None
        Bbar = None if fw[1] is None else torch.cat([fw[1], bw[1]], dim=0)
        return fw[0] + bw[0], Bbar, fw[2], fw[3]
    return None


def fused_levels_for(operators, presmoothers, postsmoothers, coarse_scaling,
                     min_vertices: int, force: Optional[bool] = None) -> dict:
    """Gating and construction of the per-level fused visits:
    ``{level: FusedVisitLevel}`` for every non-coarsest level with at least
    ``min_vertices`` unknowns.

    A level's visits are one directed sweep (SOR) or two, forward then
    backward (SSOR), as :func:`_sweep_spec` finds them.

    ``force=None`` (auto): on when the operators lie on a CUDA device - the
    kernels then serve batched chains - and off on the CPU.  In auto mode only
    levels in a dtype other than float32, which the caller chose, are left to
    the composed path on the card.  A float32 level, 2d or 3d, that exceeds the kernels' own
    limits (dimension, measurements, colours, offsets, reach) raises
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
            if force or (on_card and op.dtype == torch.float32):
                raise NotImplementedError(err)
            continue
        levels[level] = FusedVisitLevel(op, pre[2], pre[3], pre[0], post[0],
                                        pre[1], post[1], coarse_scaling)
    return levels
