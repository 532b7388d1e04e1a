"""Colour-ordered SOR and Gibbs sweep kernels: one sweep of all chains in one
CUDA kernel launch.

Replaces ``sweep_batched_v2`` / ``gibbs_sweep_batched_v2`` of
``multigridmc_tpu/ops/kernels/sor_pallas_v2.py`` and, through the raw-array
entry points at the end of this module, the four first-generation kernels
``fused_sor_sweep``, ``fused_sor_sweep_batched``, ``fused_gibbs_sweep_batched``
and ``fused_gibbs_sweep`` of ``multigridmc_tpu/ops/kernels/sor_pallas.py``.  One
**deterministic sweep** is

    for colour c in order:   x <- x + [colour == c] * omega * (b - A_stencil x) / diag

and one **Gibbs sweep** is the same sweep on

    c = f + sqrt(diag (2 - omega) / omega) * xi,      xi ~ N(0, I)

with ``diag`` the stencil's diagonal *plane* (it varies in space when the
coefficients do).  The low-rank noise term and the Woodbury correction of a
posterior operator stay outside the kernel, in the callers
(:mod:`multigridmc_tpu_torch.smoothers`, :mod:`multigridmc_tpu_torch.samplers.sor`).

Two hand-written CUDA implementations compute the same sweep, and the launch
takes one of them by its **route** (:func:`sweep_route`):

* ``"block"``: one thread block per chain, a block barrier between colour
  phases - for many chains, where one block per chain fills the card.  Its
  kernels have three bodies (:func:`sweep_body`):

  - ``"passes"``, the passes of ``csrc/level_passes.cuh``
    (``csrc/sor_sweep_passes.cu``: the fields in device memory, the stencil in
    registers, several points per lane in flight, each colour's rows over all
    warps from a rows table, one kernel per stencil form, the block size by
    chain count, :func:`sweep_threads`) for 2d stencils of reach 1 with at
    most 9 offsets, and, in that source's reach-2 and 3d builds
    (:func:`passes_build`), for the reach-2 fields and the 3d fields of more
    than 7 offsets that do not fit shared memory (255^2 and 127^2 reach 2,
    31^3 27-point);
  - ``"smem"``, ``csrc/sor_sweep_smem.cu`` for the reach-2 and 3d fields whose
    chain fits a block's shared memory (:func:`smem_fits`: the distillation
    set-up's 63^2, 31^2 and 15^3): ``x`` with a zero halo and the rhs copied in
    once, every colour phase on shared memory, each colour's points over all
    threads from a table the host builds (:func:`smem_tables`), ``x`` written
    back once;
  - ``"smem3d"``, ``csrc/sor_sweep_smem3d.cu`` for the 3d fields of at most 7
    offsets (reach 1) that do not fit one block's shared memory but whose
    chain fits a cluster of at most 16 blocks (:func:`smem3d_fits`) and whose
    launch configurations were measured (:data:`SMEM3D_SWEEPS`: the 64^3
    posterior's 63^3, a 32^3 lattice's 31^3): each chain's field in slabs of
    z-planes over a thread-block cluster, the neighbours' edge planes copied
    into ghost planes after each cluster barrier, each colour's points from
    the 3d visits' tables (``mgmc_visit_smem3d.visit_tables``), the cluster
    size, the rhs's place and the block size by chain count
    (:func:`smem3d_config`);
  - ``"generic"``, ``csrc/sor_sweep.cu``: every stencil the others do not
    take (2d reach 3 and more, 3d reach 2, 3d 7-point fields too large for a
    cluster or not in :data:`SMEM3D_SWEEPS`), and the reference that ``chip_smoke.py`` holds the others
    against (``1e-6``);
* ``"split"``: ``csrc/sor_sweep_cluster.cu``, each chain split over a
  thread-block cluster of ``S`` blocks, each block's band of rows (2d) or
  planes (3d) in shared memory, the halo read from the neighbouring blocks'
  shared memory, a cluster barrier between colour phases - for few chains
  (at most :func:`split_max_chains`, by the kernel and the stencil), where
  one block per chain leaves the card idle and a sweep is latency.

The route is chosen before any launch, when a plan builds its parameter block
for a launch configuration (:meth:`SweepPlan.params`), from the chain count,
the shape, whether the bands fit a block's shared memory
(:func:`split_smem_bytes`, the host's mirror of the kernel's layout, against
:func:`~.common.dynamic_smem_limit`) and whether such a cluster schedules
(``cudaOccupancyMaxActiveClusters``, asked once per configuration).  Both
agree bitwise under one Philox stream.  The sources are compiled with
``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``
(:mod:`.common`); their header comments state the designs.

**Bound.**  A sweep is bound by bytes: per chain it must read ``b`` (unless
shared) and ``x`` and write ``x`` once - three passes over the field,
``3 * C * n * 4`` bytes with ``b`` per chain - plus the coefficient planes that
vary in space once.  The Gibbs kernel's scratch field for ``c`` and whatever
the colour phases read again are traffic to L2 on top of that.

The one-block sources have a stamps build, a library of its own
(``common.SWEEP_STAMPS_FLAGS``; the passes body's reach-1 build only), that
times the Gibbs rhs pass (the shared-memory bodies: the copy-in) and each
colour phase of a launch (:func:`sweep_pass_times`).

Beside each kernel stands its **plain PyTorch version**
(:func:`sweep_batched_plain`, which is ``smoothers.sor_sweep``, and
:func:`gibbs_sweep_batched_plain`, which takes ``xi`` as a tensor).  The
wrappers :func:`sweep_batched` / :func:`gibbs_sweep_batched` take the plain
version only for tensors that lie on the CPU; for a CUDA tensor they launch the
kernel or raise - there is no fallback.  The kernels update ``x`` in place; the
plain versions return new tensors.

The gate is the device, the dtype and the shape: float32, 2d or 3d, up to 27
offsets of any reach, up to 9 colours; a single chain is a batch of one.  The
Gibbs kernel draws ``xi`` from the Philox stream ``(seed, launch counter)`` of
``csrc/philox.cuh`` (see :func:`~.common.philox_normals_reference`) or reads it
from a tensor.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..coloring import Coloring
from ..stencil import StencilOperator
from .common import (SWEEP_STAMPS_FLAGS, compress_plan, default_threads, dynamic_smem_limit,
                     open_library, sm_count, stamp_breakdown, tensor_ptr)

MAX_OFFSETS = 27
#: the most colours of a sweep: ``(s + 1)^2`` = 9, what ``coloring_for`` gives a
#: 2d stencil of reach 2 (the 25-point Galerkin levels of the 13-point prior)
MAX_COLORS = 9

#: the CUDA sources under ``csrc/`` (see :mod:`.common` for the build): one
#: thread block per chain, and each chain split over a thread-block cluster
SOURCE_NAME = "sor_sweep"
PASSES_SOURCE_NAME = "sor_sweep_passes"
SMEM_SOURCE_NAME = "sor_sweep_smem"
SMEM3D_SOURCE_NAME = "sor_sweep_smem3d"
SPLIT_SOURCE_NAME = "sor_sweep_cluster"

#: the four bodies of the one-block route: the passes of ``level_passes.cuh``
#: (``sor_sweep_passes.cu``), the shared-memory body (``sor_sweep_smem.cu``),
#: its 3d slabs over a cluster (``sor_sweep_smem3d.cu``) and the generic body
#: (``sor_sweep.cu``)
BODIES = ("passes", "smem", "smem3d", "generic")
#: the most offsets and colours the passes' reach-1 build takes
#: (``MAX_OFFSETS``, ``MAX_COLORS`` of ``visit_phases.cuh``)
PASSES_MAX_OFFSETS = 9
PASSES_MAX_COLORS = 8
#: the most offsets of a reach-2 stencil that is not the 5x5 box (the reach-2
#: forms 6 / 7 of ``level_passes.cuh``)
WIDE_MAX_OFFSETS = 13
#: the block bound of the passes' reach-2 and 3d builds (``PASSES_MAX_THREADS``)
PASSES_WIDE_MAX_THREADS = 512
#: the fewest offsets of a 3d stencil the passes' 3d build takes where the field
#: does not fit shared memory (fewer take the smem3d body where a cluster
#: holds the chain, else the generic body): a 7-point 63^3 sweep at 32 chains
#: took 0.74 ms a launch on it (1024 threads; 0.86 at 512) against the
#: generic body's 0.64, and 0.869 against the smem3d body's 0.112 (at 128
#: chains 0.896 against 0.382), the 27-point 31^3 0.115 against the generic
#: body's 0.481, on an H100 80GB HBM3, 700.00 W (PERF.md; the
#: ``sweep3d_table`` of ``chip_smoke.py``)
PASSES_DIM3_MIN_OFFSETS = 8

#: The shared-memory body takes a field whose block needs at most
#: ``1 / SMEM_BLOCKS_PER_SM`` of the dynamic shared memory the card grants a
#: block (:func:`smem_fits`), so that at least that many blocks share an SM;
#: on an H100, 58,112 bytes: the 63^2 (51,852 bytes with its halo of 2, the
#: widest padding and the table), 31^2 and 15^3 (55,900) fields of the
#: distillation set-ups fit, 127^2 at reach 2 and 31^3 do not.
SMEM_BLOCKS_PER_SM = 4
#: the largest block of the shared-memory body (``SMEM_MAX_THREADS``), and the
#: largest the host takes where the chains take more than one wave
#: (:func:`smem_threads`)
SMEM_MAX_THREADS = 512
SMEM_WAVES_THREADS = 256
#: the shared-memory body's static shared memory at most (``SMEM_STATIC_BOUND``:
#: the stamps build's barrier count and stamps pointer); the launcher opts in
#: to dynamic shared memory where that and the dynamic bytes pass 48 KiB, and
#: the library refuses to load where the kernels declare more
SMEM_STATIC_SMEM = 16
#: the most columns of zeros the shared-memory body's padded ``x`` may add on
#: the right beyond its halo, so that a warp's points of a colour fall on
#: distinct banks (:func:`smem_tables` picks the width); the fit rule counts
#: them all
SMEM_PITCH_SLACK = 8
#: what a plan on the CPU, where nothing is launched, takes as the card's
#: grant: an H100's (232,448 bytes), so that it names the body the card takes
CPU_SMEM_LIMIT = 232448
#: int64 words per block of the one-block kernels' stamps (``SWEEP_STAMP_WIDTH``
#: of ``block_stamps.cuh``): the timer at entry, after the rhs pass and up to
#: ``MAX_COLORS`` colour phases and at exit, the barriers passed, the SM; the
#: generic body's (``sor_sweep.cuh``: 9 colours) and the passes body's
#: (``visit_phases.cuh``: 8)
SWEEP_STAMP_WIDTH = 2 + MAX_COLORS + 3
PASSES_STAMP_WIDTH = 2 + PASSES_MAX_COLORS + 3
#: the stamps width of each one-block body (the shared-memory body's is the
#: generic body's: ``sor_sweep.cuh``, 9 colours)
#: int64 words per block of the smem3d body's stamps (``SWEEP3D_STAMP_WIDTH``
#: of ``sor_sweep_smem3d.cu``): the timer at entry, after the copy-in and up
#: to 8 colours, at exit, the barriers passed, the SM; one row per block,
#: ``C S`` rows
SMEM3D_STAMP_WIDTH = 2 + 8 + 3
STAMP_WIDTHS = {"generic": SWEEP_STAMP_WIDTH, "smem": SWEEP_STAMP_WIDTH,
                "passes": PASSES_STAMP_WIDTH, "smem3d": SMEM3D_STAMP_WIDTH}

#: The smem3d body (``sor_sweep_smem3d.cu``): the stencil size its kernels
#: are compiled for, the largest cluster and block, and its kernels' static
#: shared memory at most (the stamps build's barrier count and stamps
#: pointer)
SMEM3D_KMAX = 7
SMEM3D_MAX_CLUSTER = 16
SMEM3D_MAX_THREADS = 1024
SMEM3D_STATIC_SMEM = 16

#: Per field shape and kernel ``(Z, Y, X, kernel)``: the chain counts
#: ``(least, most)`` (``most`` None: no upper bound) of each launch
#: configuration ``(S, c_shared, threads)`` of the smem3d body
#: (:func:`smem3d_config`), every count from one chain on.  A shape not listed
#: takes the generic body (:func:`sweep_body`) until its rows are measured, as
#: a 3d level that ``mgmc_visit_smem3d.SMEM3D_ROUTES`` does not list takes the
#: phase kernels.  From the ``sweep3d_table`` of ``chip_smoke.py``
#: (``--phases sweep3d_table``): device ms per launch at 1 .. 256 chains of
#: every cluster size that fits, the rhs in shared memory or not, 512 or 1024
#: threads, ``b`` per chain, on the 64^3 posterior's 63^3 and a 32^3
#: lattice's 31^3 7-point fields, NVIDIA H100 80GB HBM3, 700.00 W (PERF.md
#: section 6 holds the table).  A range runs from a measured count to the next
#: one's predecessor and takes the configuration that was fastest at its first
#: count.  Few chains take clusters of 16 (63^3 at one chain: 0.0266 ms a
#: deterministic sweep, the generic body 0.5505), many take the fewest blocks a
#: chain that fill the card, the rhs in device memory (63^3 at 128 chains:
#: clusters of 8, one block an SM, 0.3819 ms against 0.6629; 31^3 at 128: one
#: block a chain, 0.0440 against 0.1359).
SMEM3D_SWEEPS: Dict[Tuple[int, int, int, str],
                    Tuple[Tuple[int, Optional[int], int, bool, int], ...]] = {
    (63, 63, 63, "sweep"): ((1, 7, 16, False, 1024), (8, 15, 8, False, 1024),
                            (16, 63, 6, False, 1024), (64, None, 8, False, 1024)),
    (63, 63, 63, "gibbs"): ((1, 7, 16, True, 1024), (8, 15, 8, False, 1024),
                            (16, 63, 6, False, 1024), (64, None, 16, False, 512)),
    (31, 31, 31, "sweep"): ((1, 7, 16, False, 512), (8, 15, 8, False, 512),
                            (16, 31, 4, False, 1024), (32, 127, 2, False, 1024),
                            (128, None, 1, False, 1024)),
    (31, 31, 31, "gibbs"): ((1, 7, 16, True, 512), (8, 15, 8, True, 1024),
                            (16, 31, 4, True, 1024), (32, 127, 2, True, 1024),
                            (128, None, 2, False, 512))}

#: Block sizes of the passes body (:func:`sweep_threads`), from ``chip_smoke.py
#: --phases sweep_threads`` (device ms per launch at 256 / 512 / 1024 threads,
#: the deterministic kernel, NVIDIA H100 80GB HBM3, 700.00 W; the Gibbs kernel
#: picks the same within 4%):
#:
#: ======  ========================  ========================
#: chains  255^2 5-point             127^2 9-point Galerkin
#: ======  ========================  ========================
#:     64  0.0853 / 0.0551 / 0.0460  0.0230 / 0.0174 / 0.0161
#:    132  0.1136 / 0.0817 / 0.0771  0.0239 / 0.0178 / 0.0167
#:    200  0.1389 / 0.1205 / 0.1224  0.0319 / 0.0280 / 0.0312
#:    256  0.1559 / 0.1462 / 0.1458  0.0343 / 0.0287 / 0.0323
#:    512  0.2945 / 0.2846 / 0.2826  0.0922 / 0.0660 / 0.0775
#: ======  ========================  ========================
#:
#: ======  ========================  ========================
#: chains  63^2 9-point Galerkin     31^2 9-point Galerkin
#: ======  ========================  ========================
#:     64  0.0121 / 0.0096 / 0.0093  0.0073 / 0.0061 / 0.0068
#:    132  0.0122 / 0.0098 / 0.0096  0.0075 / 0.0063 / 0.0069
#:    200  0.0154 / 0.0144 / 0.0173  0.0090 / 0.0086 / 0.0123
#:    256  0.0155 / 0.0145 / 0.0175  0.0090 / 0.0086 / 0.0124
#:    512  0.0256 / 0.0269 / 0.0334  0.0143 / 0.0159 / 0.0233
#: 28,529  1.1562 / 1.4166 / 1.8432  0.6144 / 0.7680 / 1.3067
#: ======  ========================  ========================
#:
#: A block of 1024 threads is one an SM (64 registers a thread), 512 two, 256
#: four: the block size that holds the chains in one wave, no larger than
#: :data:`SWEEP_MOST_THREADS` and no smaller than :data:`SWEEP_LEAST_THREADS`
#: allow for the field's points.
SWEEP_WAVE_THREADS = (1024, 512, 256)
#: the largest block size by the field's points: (least points, threads),
#: largest first (31^2: 32 warps leave most idle on its 8 rows a colour)
SWEEP_MOST_THREADS = ((3000, 1024), (900, 512), (0, 256))
#: the smallest block size by the field's points (127^2 at 512 chains: 256
#: threads take 1.4 times as long as 512)
SWEEP_LEAST_THREADS = ((16000, 512), (0, 256))

#: the one-block route; the split route is ``("split", S)``
BLOCK_ROUTE = ("block", 1)
ROUTES = ("block", "split")
#: cluster sizes of the split route, largest first (``MAX_CLUSTER`` = 16 in the
#: source; above 8 a cluster is not portable and needs the card's consent)
SPLIT_SIZES = (16, 8, 4, 2)
#: ints of the split kernels' first-point table before the bands
#: (``SPLIT_TABLE_INTS`` in the source)
SPLIT_TABLE_INTS = MAX_COLORS * MAX_COLORS

#: Launches of at most this many chains take the split route where its bands
#: fit and its cluster schedules, more take one block per chain, by kernel and
#: by the stencil's class (:func:`split_stencil`: the passes body's stencils of
#: at most 5 offsets, its stencils of 6-9 offsets, 3d stencils of fewer than
#: :data:`PASSES_DIM3_MIN_OFFSETS` offsets, the other 3d stencils, and 2d
#: stencils of reach 2 and wider; :func:`split_max_chains`).  Of the cluster
#: sizes that fit, the route takes the one of least
#: ``waves * (1 / S + SPLIT_WAVE_FIXED)``: a launch of ``C`` chains runs in
#: ``waves = ceil(C / active)`` waves of clusters (``active``: the clusters of
#: that size the card holds at once, ``cudaOccupancyMaxActiveClusters``), and a
#: wave lasts as long as a block takes for its band, about ``1 / S`` of a field,
#: plus a fixed part (the load, the barriers, the launch), here a 40th of a
#: whole field's time (a 25th before the passes body: it took clusters of 4 at
#: 16 chains of 255^2, where 16 measured 0.0417 against 0.0491 ms and 0.0420
#: against 0.0429 in two runs).  The constants come from the ``sweep_routes`` table of
#: ``chip_smoke.py``, which fails if the table supports other values: device
#: time per sweep of both routes (the split route at every cluster size that
#: fits) at 1 .. 256 chains on two fields of each class (255^2 5-point and
#: 127^2 5-point space-varying; 255^2 and 127^2 9-point Galerkin; 63^3
#: 7-point, 31^3 27-point Galerkin and 63^2 13-point of reach 2; a field's
#: counts end where both kernels' split route has lost), NVIDIA H100 80GB
#: HBM3, 700.00 W.
#: Against the passes body the split route takes less than 0.9 of its time up
#: to 16 chains for the 5-point sweep (255^2 at 16: 0.0382 against 0.0445 ms;
#: at 32 0.0630 against 0.0447), up to 32 for the 5-point Gibbs sweep (255^2 at
#: 32: 0.0707 against 0.0829), up to 16 for the 9-point Gibbs sweep (127^2:
#: 0.0218 against 0.0261), and at no count for the 9-point sweep (127^2, one
#: chain: 0.0194 against 0.0159, where 255^2 takes 0.0244 against 0.0440: a
#: class's threshold is the least of its fields'); on 3d 7-point fields (the
#: 63^3 field, against the smem3d body; the generic body, which it
#: replaced, gave 64 chains) at no count (one chain: 0.0462 against 0.0266
#: ms); on the other 3d stencils (the 31^3 27-point Galerkin level, against the
#: passes' 3d build; once one class "3d" with the 7-point fields)
#: up to 8 chains for the sweep (8: 0.0761 against 0.1126, 16: 0.1217 against
#: 0.1132) and up to 16 for the Gibbs sweep (16: 0.1145 against 0.1580, 32:
#: 0.1799 against 0.1591); on 2d stencils of reach 2 (the 63^2 13-point field,
#: against the shared-memory body) at no count.  (The reach-2 and 3d fields
#: were one class, measured on the generic body, up to 64 chains both, until
#: the shared-memory body took the reach-2 field: on it the field's sweep took
#: the split route within 0.90 of one block's time at 32 chains and
#: 0.898-0.902 at 64, a threshold no table decides.)  PERF.md section 6 holds
#: the table.
SPLIT_MAX_CHAINS: Dict[Tuple[str, str], int] = {
    ("sweep", "5-point"): 16, ("gibbs", "5-point"): 32,
    ("sweep", "9-point"): 0, ("gibbs", "9-point"): 16,
    ("sweep", "3d"): 0, ("gibbs", "3d"): 0,
    ("sweep", "3d 27-point"): 8, ("gibbs", "3d 27-point"): 16,
    ("sweep", "reach-2"): 0, ("gibbs", "reach-2"): 0}
SPLIT_WAVE_FIXED = 0.025

#: kernel launches made by the wrappers (and only where they launch); the
#: ``_split`` entries count the split route, the ``_smem`` entries the
#: one-block route's shared-memory body, the ``_smem3d`` entries its 3d
#: slabs over a cluster, the ``_generic`` entries its generic body, the
#: entries without a suffix its passes body (every build)
launch_counts: Dict[str, int] = {
    "sweep_batched": 0, "gibbs_sweep_batched": 0,
    "sweep_batched_smem": 0, "gibbs_sweep_batched_smem": 0,
    "sweep_batched_smem3d": 0, "gibbs_sweep_batched_smem3d": 0,
    "sweep_batched_generic": 0, "gibbs_sweep_batched_generic": 0,
    "sweep_batched_split": 0, "gibbs_sweep_batched_split": 0,
    "fused_sor_sweep": 0, "fused_sor_sweep_batched": 0,
    "fused_gibbs_sweep_batched": 0, "fused_gibbs_sweep": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class SweepParams(ctypes.Structure):
    """Mirror of ``struct SweepParams`` in ``csrc/sor_sweep.cu``."""

    _fields_ = [
        ("C", ctypes.c_int), ("Z", ctypes.c_int), ("Y", ctypes.c_int), ("X", ctypes.c_int),
        ("K", ctypes.c_int), ("diag_index", ctypes.c_int),
        ("dz", ctypes.c_int * MAX_OFFSETS),
        ("dy", ctypes.c_int * MAX_OFFSETS),
        ("dx", ctypes.c_int * MAX_OFFSETS),
        ("coeff_const", ctypes.c_int * MAX_OFFSETS),
        ("coeff_val", ctypes.c_float * MAX_OFFSETS),
        ("n_colors", ctypes.c_int), ("wz", ctypes.c_int), ("wy", ctypes.c_int),
        ("wx", ctypes.c_int), ("jstride", ctypes.c_int),
        ("n_order", ctypes.c_int),
        ("order", ctypes.c_int * MAX_COLORS),
        ("omega", ctypes.c_float),
        ("noise_mode", ctypes.c_int),
        ("ns_const", ctypes.c_int),
        ("ns_val", ctypes.c_float),
        ("b_batched", ctypes.c_int),
        ("seed", ctypes.c_ulonglong),
        ("counter", ctypes.c_ulonglong),
    ]


class SmemSweepParams(ctypes.Structure):
    """Mirror of ``struct SmemSweepParams`` in ``csrc/sor_sweep_smem.cu``."""

    _fields_ = [
        ("C", ctypes.c_int), ("Z", ctypes.c_int), ("Y", ctypes.c_int), ("X", ctypes.c_int),
        ("RZ", ctypes.c_int), ("R", ctypes.c_int),
        ("PZ", ctypes.c_int), ("PY", ctypes.c_int), ("PX", ctypes.c_int),
        ("K", ctypes.c_int), ("diag_index", ctypes.c_int),
        ("soff", ctypes.c_int * MAX_OFFSETS),
        ("cval", ctypes.c_float * MAX_OFFSETS),
        ("rdiag", ctypes.c_float),
        ("planes", ctypes.c_uint),
        ("n_order", ctypes.c_int),
        ("start", ctypes.c_int * (MAX_COLORS + 1)),
        ("plain", ctypes.c_int * MAX_COLORS),
        ("omega", ctypes.c_float),
        ("noise_mode", ctypes.c_int),
        ("ns_const", ctypes.c_int),
        ("ns_val", ctypes.c_float),
        ("b_batched", ctypes.c_int),
        ("seed", ctypes.c_ulonglong),
        ("counter", ctypes.c_ulonglong),
    ]


class Smem3dSweepParams(ctypes.Structure):
    """Mirror of ``struct Smem3dSweepParams`` in ``csrc/sor_sweep_smem3d.cu``."""

    _fields_ = [
        ("C", ctypes.c_int), ("Z", ctypes.c_int), ("Y", ctypes.c_int), ("X", ctypes.c_int),
        ("S", ctypes.c_int), ("PX", ctypes.c_int), ("PP", ctypes.c_int),
        ("nz_max", ctypes.c_int), ("c_shared", ctypes.c_int),
        ("K", ctypes.c_int), ("diag_index", ctypes.c_int),
        ("soff", ctypes.c_int * SMEM3D_KMAX),
        ("cval", ctypes.c_float * SMEM3D_KMAX),
        ("rdiag", ctypes.c_float),
        ("planes", ctypes.c_uint),
        ("n_order", ctypes.c_int),
        ("omega", ctypes.c_float),
        ("noise_mode", ctypes.c_int),
        ("ns_const", ctypes.c_int),
        ("ns_val", ctypes.c_float),
        ("b_batched", ctypes.c_int),
        ("seed", ctypes.c_ulonglong),
        ("counter", ctypes.c_ulonglong),
    ]


def _check_stamps_library(lib, prefix: str, stamps: bool, width: int) -> None:
    """The library's build (stamps or production) and stamp width against
    what the host expects."""
    for fn in (getattr(lib, f"{prefix}_stamps_build"), getattr(lib, f"{prefix}_stamp_width")):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if getattr(lib, f"{prefix}_stamps_build")() != int(stamps):
        raise RuntimeError(f"the {prefix} library is not the build asked for")
    if getattr(lib, f"{prefix}_stamp_width")() != width:
        raise RuntimeError(f"the {prefix} kernels' stamps differ in width between Python and CUDA")


@functools.lru_cache(maxsize=None)
def load_library(stamps: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the generic one-block sweep kernels'
    shared library, or with ``stamps`` their stamps build."""
    lib = open_library(SOURCE_NAME, SWEEP_STAMPS_FLAGS if stamps else ())
    _check_stamps_library(lib, "sor_sweep", stamps, SWEEP_STAMP_WIDTH)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sor_sweep_params_size.argtypes = []
    lib.sor_sweep_params_size.restype = i32
    if lib.sor_sweep_params_size() != ctypes.sizeof(SweepParams):
        raise RuntimeError("SweepParams layout differs between Python and CUDA")
    # P, x, b, coeffs, threads, stamps, stream
    lib.sor_sweep_batched.argtypes = [ctypes.POINTER(SweepParams)] + [ptr] * 3 + [i32, ptr, ptr]
    lib.sor_sweep_batched.restype = i32
    # P, x, f, scratch, coeffs, ns, xi, threads, stamps, stream
    lib.sor_gibbs_sweep_batched.argtypes = (
        [ctypes.POINTER(SweepParams)] + [ptr] * 6 + [i32, ptr, ptr])
    lib.sor_gibbs_sweep_batched.restype = i32
    return lib


def passes_flags(reach: int = 1, dim: int = 2) -> Tuple[str, ...]:
    """The compiler flags of the passes body's build of ``(reach, dim)``: the
    phase kernels' flags of the same build (``mgmc_visit.PHASE_BUILDS``)."""
    from .mgmc_visit import PHASE_BUILDS

    return PHASE_BUILDS[(reach, dim)][0]


@functools.lru_cache(maxsize=None)
def load_passes_library(stamps: bool = False, reach: int = 1, dim: int = 2) -> ctypes.CDLL:
    """Build (at first use) and load the one-block sweep kernels on the passes
    of ``level_passes.cuh``, or with ``stamps`` their stamps build; with
    ``reach=2`` or ``dim=3`` the source's reach-2 or 3d build (no stamps
    build), whose parameter block and stencil forms are the phase kernels' of
    the same build."""
    from .mgmc_visit import PHASE_BUILDS

    if (reach, dim) not in PHASE_BUILDS or (stamps and (reach, dim) != (1, 2)):
        raise ValueError("the passes body has a reach-1 build, its stamps build, a reach-2 "
                         f"build and a 3d build; asked for reach {reach}, dim {dim}, "
                         f"stamps {stamps}")
    flags, params, form0, nforms, _, _ = PHASE_BUILDS[(reach, dim)]
    lib = open_library(PASSES_SOURCE_NAME, SWEEP_STAMPS_FLAGS if stamps else flags)
    _check_stamps_library(lib, "sor_passes", stamps,
                          PASSES_STAMP_WIDTH if (reach, dim) == (1, 2) else
                          2 + (MAX_COLORS if reach == 2 else PASSES_MAX_COLORS) + 3)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.sor_passes_params_size, lib.sor_passes_stencil_forms,
               lib.sor_passes_first_form, lib.sor_passes_reach, lib.sor_passes_dim,
               lib.sor_passes_max_threads):
        fn.argtypes = []
        fn.restype = i32
    if (lib.sor_passes_reach(), lib.sor_passes_dim()) != (reach, dim):
        raise RuntimeError("the passes sweep library is not the build asked for")
    if lib.sor_passes_params_size() != ctypes.sizeof(params):
        raise RuntimeError(f"{params.__name__} layout differs between Python and CUDA")
    if (lib.sor_passes_first_form(), lib.sor_passes_stencil_forms()) != (form0, nforms):
        raise RuntimeError("the sweep kernels' stencil forms differ between Python and CUDA")
    if lib.sor_passes_max_threads() != passes_max_threads((reach, dim)):
        raise RuntimeError("the sweep kernels' block bound differs between Python and CUDA")
    lib.sor_passes_kernel_attributes.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.sor_passes_kernel_attributes.restype = i32
    lib.sor_passes_blocks_per_sm.argtypes = [i32] * 3
    lib.sor_passes_blocks_per_sm.restype = i32
    # P, rows, x, b, coeffs, form, threads, stamps, stream
    lib.sor_passes_sweep.argtypes = ([ctypes.POINTER(params)] + [ptr] * 4
                                     + [i32, i32, ptr, ptr])
    lib.sor_passes_sweep.restype = i32
    # P, rows, x, f, scratch, coeffs, ns, xi, form, threads, stamps, stream
    lib.sor_passes_gibbs_sweep.argtypes = ([ctypes.POINTER(params)] + [ptr] * 7
                                           + [i32, i32, ptr, ptr])
    lib.sor_passes_gibbs_sweep.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def load_smem_library(stamps: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the shared-memory one-block sweep
    kernels' library, or with ``stamps`` their stamps build."""
    lib = open_library(SMEM_SOURCE_NAME, SWEEP_STAMPS_FLAGS if stamps else ())
    _check_stamps_library(lib, "sor_smem", stamps, SWEEP_STAMP_WIDTH)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.sor_smem_params_size, lib.sor_smem_max_threads, lib.sor_smem_static_smem):
        fn.argtypes = []
        fn.restype = i32
    if lib.sor_smem_params_size() != ctypes.sizeof(SmemSweepParams):
        raise RuntimeError("SmemSweepParams layout differs between Python and CUDA")
    if lib.sor_smem_max_threads() != SMEM_MAX_THREADS:
        raise RuntimeError("the shared-memory sweep's block bound differs between Python and CUDA")
    static = lib.sor_smem_static_smem()
    if not 0 <= static <= SMEM_STATIC_SMEM:
        raise RuntimeError(f"the shared-memory sweep declares {static} bytes of static shared "
                           f"memory, more than the {SMEM_STATIC_SMEM} its launcher counts")
    lib.sor_smem_kernel_attributes.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.sor_smem_kernel_attributes.restype = i32
    lib.sor_smem_blocks_per_sm.argtypes = [i32] * 4
    lib.sor_smem_blocks_per_sm.restype = i32
    # P, table, x, b, coeffs, rdiag, kmax, threads, bytes, stamps, stream
    lib.sor_smem_sweep.argtypes = ([ctypes.POINTER(SmemSweepParams)] + [ptr] * 5
                                   + [i32, i32, i32, ptr, ptr])
    lib.sor_smem_sweep.restype = i32
    # P, table, x, f, coeffs, rdiag, ns, xi, kmax, threads, bytes, stamps, stream
    lib.sor_smem_gibbs_sweep.argtypes = ([ctypes.POINTER(SmemSweepParams)] + [ptr] * 7
                                         + [i32, i32, i32, ptr, ptr])
    lib.sor_smem_gibbs_sweep.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def load_smem3d_library(stamps: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the smem3d body's library (the 3d 7-point
    sweeps in slabs over a cluster), or with ``stamps`` its stamps build."""
    from . import mgmc_visit_smem3d as v3

    lib = open_library(SMEM3D_SOURCE_NAME, SWEEP_STAMPS_FLAGS if stamps else ())
    _check_stamps_library(lib, "sor_smem3d", stamps, SMEM3D_STAMP_WIDTH)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.sor_smem3d_params_size, lib.sor_smem3d_head_ints, lib.sor_smem3d_max_threads,
               lib.sor_smem3d_kmax, lib.sor_smem3d_static_smem):
        fn.argtypes = []
        fn.restype = i32
    if lib.sor_smem3d_params_size() != ctypes.sizeof(Smem3dSweepParams):
        raise RuntimeError("Smem3dSweepParams layout differs between Python and CUDA")
    if (lib.sor_smem3d_head_ints(), lib.sor_smem3d_max_threads(), lib.sor_smem3d_kmax()) != (
            v3.HEAD_INTS, SMEM3D_MAX_THREADS, SMEM3D_KMAX):
        raise RuntimeError("the smem3d sweep's table heads, block bound or stencil size differ "
                           "between Python and CUDA")
    static = lib.sor_smem3d_static_smem()
    if not 0 <= static <= SMEM3D_STATIC_SMEM:
        raise RuntimeError(f"the smem3d sweep declares {static} bytes of static shared memory, "
                           f"more than the {SMEM3D_STATIC_SMEM} its layout keeps")
    lib.sor_smem3d_smem_bytes.argtypes = [i32] * 6  # Z, Y, X, S, PP, c_shared
    lib.sor_smem3d_smem_bytes.restype = i32
    lib.sor_smem3d_kernel_attributes.argtypes = [i32, ctypes.POINTER(i32)]
    lib.sor_smem3d_kernel_attributes.restype = i32
    lib.sor_smem3d_blocks_per_sm.argtypes = [i32] * 3  # gibbs, threads, bytes
    lib.sor_smem3d_blocks_per_sm.restype = i32
    # gibbs, S, threads, bytes, out clusters
    lib.sor_smem3d_max_active.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.sor_smem3d_max_active.restype = i32
    # P, tables, x, b, coeffs, rdiag, threads, bytes, stamps, stream
    lib.sor_smem3d_sweep.argtypes = ([ctypes.POINTER(Smem3dSweepParams)] + [ptr] * 5
                                     + [i32, i32, ptr, ptr])
    lib.sor_smem3d_sweep.restype = i32
    # P, tables, x, f, scratch, coeffs, rdiag, ns, xi, threads, bytes, stamps, stream
    lib.sor_smem3d_gibbs_sweep.argtypes = ([ctypes.POINTER(Smem3dSweepParams)] + [ptr] * 8
                                           + [i32, i32, ptr, ptr])
    lib.sor_smem3d_gibbs_sweep.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def load_split_library() -> ctypes.CDLL:
    """Build (at first use) and load the split route's shared library."""
    lib = open_library(SPLIT_SOURCE_NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sor_sweep_cluster_smem_bytes.argtypes = [i32] * 6  # Z, Y, X, S, reach, noise_mode
    lib.sor_sweep_cluster_smem_bytes.restype = i32
    # gibbs, S, threads, bytes, out clusters
    lib.sor_sweep_cluster_max_active.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.sor_sweep_cluster_max_active.restype = i32
    # P, x, b, coeffs, S, threads, stream
    lib.sor_sweep_cluster.argtypes = [ctypes.POINTER(SweepParams)] + [ptr] * 3 + [i32, i32, ptr]
    lib.sor_sweep_cluster.restype = i32
    # P, x, f, coeffs, ns, xi, S, threads, stream
    lib.sor_gibbs_sweep_cluster.argtypes = (
        [ctypes.POINTER(SweepParams)] + [ptr] * 5 + [i32, i32, ptr])
    lib.sor_gibbs_sweep_cluster.restype = i32
    return lib


# ------------------------------------------------------------ the two routes
def split_layout(vshape) -> Tuple[int, int, int]:
    """How the split route cuts a field into bands: ``(units, points per unit,
    axis)``, the units being planes of the slowest axis in 3d and rows in 2d
    (a 3d field of one plane splits by rows), as ``split_layout`` in
    ``csrc/sor_sweep_cluster.cu``."""
    Z, Y, X = (1,) * (3 - len(vshape)) + tuple(int(v) for v in vshape)
    if Z > 1:
        return Z, Y * X, 0
    return Y, X, len(vshape) - 2


def slow_reach(offsets, vshape) -> int:
    """Reach of the stencil along the axis the bands split."""
    axis = split_layout(vshape)[2]
    return max(abs(int(off[axis])) for off in offsets)


def split_smem_bytes(vshape, S: int, reach: int, noise_mode: int) -> int:
    """Dynamic shared memory of one block of the split route with clusters of
    ``S`` blocks: the first-point table, the widest band of ``x`` and, for the
    Gibbs kernel (``noise_mode`` 1 or 2), the band of ``c``.  The host's mirror
    of ``sor_sweep_cluster_smem_bytes`` in the source; ``ValueError`` where the
    field cannot be split so (a band narrower than ``reach`` units, more blocks
    than units, ``S`` outside 2 .. 16)."""
    L, plane, _ = split_layout(vshape)
    if not 2 <= S <= SPLIT_SIZES[0] or S > L or L // S < reach:
        raise ValueError(f"a field of {L} units at reach {reach} does not split over {S} blocks")
    nb_max = -(-L // S)
    return 4 * (SPLIT_TABLE_INTS + nb_max * plane * (2 if noise_mode else 1))


def split_threads(vshape, S: int) -> int:
    """Threads per block of the split route: about four points of the band per
    thread, 64 to 1024."""
    L, plane, _ = split_layout(vshape)
    band = -(-L // S) * plane
    return min(1024, max(64, 32 * -(-band // 128)))


@functools.lru_cache(maxsize=None)
def max_active_clusters(device: torch.device, gibbs: bool, S: int, threads: int,
                        nbytes: int, query=None) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the split kernel for clusters of
    ``S`` blocks of ``threads`` threads and ``nbytes`` of shared memory, asked
    once per configuration; 0 where such a cluster never schedules (a refused
    configuration included).  ``query``, a function without arguments that
    loads and returns another kernel's entry point of the same signature
    (first argument an int that picks one of two kernels, here ``gibbs``),
    asks that kernel instead: the split visit kernels pass theirs, whose first
    argument picks the descend kernel."""
    entry = load_split_library().sor_sweep_cluster_max_active if query is None else query()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = entry(int(gibbs), S, threads, nbytes, ctypes.byref(out))
    return int(out.value) if err == 0 else 0


def active_clusters(device, noise_mode: int, S: int, threads: int, nbytes: int,
                    query=None) -> int:
    """How many clusters of the split kernel (or of ``query``'s, see
    :func:`max_active_clusters`) ``device`` holds at once (0: such a cluster
    never schedules).  On the CPU there is no card to ask, and every cluster
    is taken to run at once: a CPU plan's route then follows from the shape
    and the shared memory alone."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1 << 30
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return max_active_clusters(device, noise_mode != 0, S, threads, nbytes, query)


def split_cost(C: int, S: int, active: int, fixed: float = SPLIT_WAVE_FIXED) -> float:
    """The route's measure of a launch of ``C`` chains over clusters of ``S``
    blocks of which ``active`` run at once: waves times a wave's length, ``1 /
    S`` of a whole field's time plus the ``fixed`` share (see
    :data:`SPLIT_WAVE_FIXED`, the sweeps' value)."""
    return -(-C // active) * (1.0 / S + fixed)


def cheapest_cluster(C: int, active: Dict[int, int],
                     fixed: float = SPLIT_WAVE_FIXED) -> Optional[int]:
    """Of the cluster sizes ``{S: clusters the card holds at once}`` (largest
    first), the one of least :func:`split_cost` (with the fixed share
    ``fixed``) for ``C`` chains, the larger on a tie; ``None`` where none
    schedules."""
    best = None
    for S, a in active.items():
        if a > 0 and (best is None or split_cost(C, S, a, fixed)
                      < split_cost(C, best, active[best], fixed)):
            best = S
    return best


def split_size(C: int, vshape, offsets, noise_mode: int, device,
               smem_limit: Optional[int] = None) -> Optional[int]:
    """The cluster size of :data:`SPLIT_SIZES` of least :func:`split_cost` for
    ``C`` chains of fields ``vshape`` among those that leave every band at
    least the stencil's reach wide, fit their bands in ``smem_limit`` (default:
    what the probe grants a block on ``device``) and schedule; ``None`` where
    none does."""
    L = split_layout(vshape)[0]
    reach = slow_reach(offsets, vshape)
    if smem_limit is None:
        smem_limit = dynamic_smem_limit(device)
    active = {}
    for S in SPLIT_SIZES:
        if S > L or L // S < reach:
            continue
        nbytes = split_smem_bytes(vshape, S, reach, noise_mode)
        if nbytes <= smem_limit:
            active[S] = active_clusters(device, noise_mode, S, split_threads(vshape, S), nbytes)
    return cheapest_cluster(C, active)


def split_stencil(vshape, offsets) -> str:
    """The stencil's class in :data:`SPLIT_MAX_CHAINS`: ``"3d"`` for 3d
    stencils of fewer than :data:`PASSES_DIM3_MIN_OFFSETS` offsets (the
    7-point stencil: the smem3d body's), ``"3d 27-point"`` for the other 3d
    stencils (up to the 3x3x3 box), ``"reach-2"`` for the 2d stencils the
    passes' reach-1 build does not take (reach 2 and wider), else
    ``"5-point"`` for at most 5 offsets and ``"9-point"`` for more."""
    if len(vshape) == 3:
        return "3d" if len(offsets) < PASSES_DIM3_MIN_OFFSETS else "3d 27-point"
    if passes_build(vshape, offsets) != (1, 2):
        return "reach-2"
    return "5-point" if len(offsets) <= 5 else "9-point"


def split_max_chains(vshape, offsets, noise_mode: int) -> int:
    """The most chains a sweep of fields ``vshape`` with a stencil of
    ``offsets`` takes the split route for (:data:`SPLIT_MAX_CHAINS`);
    ``noise_mode`` 0 is the deterministic kernel, 1 and 2 the Gibbs kernel."""
    return SPLIT_MAX_CHAINS[("gibbs" if noise_mode else "sweep", split_stencil(vshape, offsets))]


def split_route(C: int, vshape, offsets, noise_mode: int, device,
                smem_limit: Optional[int] = None) -> Tuple[str, int]:
    """The route of a sweep of ``C`` chains of fields ``vshape``: ``("split",
    S)`` for at most :func:`split_max_chains` chains where :func:`split_size`
    finds a cluster size ``S``, :data:`BLOCK_ROUTE` otherwise."""
    if C > split_max_chains(vshape, offsets, noise_mode):
        return BLOCK_ROUTE
    S = split_size(C, vshape, offsets, noise_mode, device, smem_limit)
    return BLOCK_ROUTE if S is None else ("split", S)


def sweep_route(C: int, plan: "SweepPlan", noise_mode: int = 0,
                smem_limit: Optional[int] = None) -> Tuple[str, int]:
    """The route a sweep of ``C`` chains on ``plan`` launches
    (:func:`split_route` at the plan's shape and device); ``noise_mode`` 0 is
    the deterministic kernel, 1 and 2 the Gibbs kernel."""
    return split_route(C, plan.op.vshape, plan.op.offsets, noise_mode, plan.op.device,
                       smem_limit)


def passes_build(vshape, offsets) -> Optional[Tuple[int, int]]:
    """``(reach, dim)`` of the passes body's build that takes fields
    ``vshape`` with a stencil of ``offsets`` (the phase kernels' forms of the
    same build, ``mgmc_visit.stencil_form``): ``(1, 2)`` 2d stencils of reach 1
    with at most :data:`PASSES_MAX_OFFSETS` offsets; ``(2, 2)`` 2d stencils of
    reach 2 with at most :data:`WIDE_MAX_OFFSETS` offsets or the 5x5 box in
    raster order; ``(1, 3)`` 3d stencils of reach 1; ``None`` for anything
    else.  (The passes' 3d build is launched for stencils of at least
    :data:`PASSES_DIM3_MIN_OFFSETS` only, :func:`sweep_body`.)"""
    from .mgmc_visit import raster_box, stencil_reach

    reach, K = stencil_reach(offsets), len(offsets)
    if len(vshape) == 2 and reach <= 1 and K <= PASSES_MAX_OFFSETS:
        return (1, 2)
    if len(vshape) == 2 and reach == 2 and (K <= WIDE_MAX_OFFSETS or raster_box(offsets, 2)):
        return (2, 2)
    if len(vshape) == 3 and reach <= 1 and K <= MAX_OFFSETS:
        return (1, 3)
    return None


def smem_halo(vshape, offsets) -> Tuple[int, int]:
    """The zero halo of the shared-memory body's padded ``x``: ``(RZ, R)``,
    along z (0 for a 2d field) and along y and x, the stencil's reach."""
    from .mgmc_visit import stencil_reach

    R = stencil_reach(offsets)
    return (R if len(vshape) == 3 else 0), R


def smem_padded(vshape, offsets, extra: int = 0) -> Tuple[int, int, int]:
    """``(PZ, PY, PX)``: the padded ``x``'s extents (``PZ`` = 1 in 2d), with
    ``extra`` columns of zeros beyond the halo on the right."""
    RZ, R = smem_halo(vshape, offsets)
    Z, Y, X = (1,) * (3 - len(vshape)) + tuple(int(v) for v in vshape)
    return Z + 2 * RZ, Y + 2 * R, X + 2 * R + int(extra)


def smem_sweep_bytes(vshape, offsets, extra: int = SMEM_PITCH_SLACK) -> int:
    """Dynamic shared memory of one block of the shared-memory body: the
    padded ``x`` (``extra`` columns beyond the halo; the fit rule counts the
    most, :data:`SMEM_PITCH_SLACK`), the rhs and the block's copy of the table,
    4 bytes a word (the host's mirror of the launch's ``smem_bytes``)."""
    return 4 * (int(np.prod(smem_padded(vshape, offsets, extra))) + 2 * int(np.prod(vshape)))


def smem_fits(vshape, offsets, smem_limit: int) -> bool:
    """The rule of the shared-memory body: a chain's block takes at most
    ``smem_limit // SMEM_BLOCKS_PER_SM`` bytes (``smem_limit``: what the card
    grants a block, :func:`~.common.dynamic_smem_limit`), so that
    :data:`SMEM_BLOCKS_PER_SM` blocks share an SM."""
    return smem_sweep_bytes(vshape, offsets) <= int(smem_limit) // SMEM_BLOCKS_PER_SM


def smem_limit_of(device) -> int:
    """The grant :func:`smem_fits` holds a plan on ``device`` to: the probe's
    answer on a CUDA device, :data:`CPU_SMEM_LIMIT` on the CPU."""
    device = torch.device(device)
    return dynamic_smem_limit(device) if device.type == "cuda" else CPU_SMEM_LIMIT


def smem3d_sizes(vshape, smem_limit: int) -> Tuple[int, ...]:
    """The cluster sizes ``S`` (1 .. :data:`SMEM3D_MAX_CLUSTER`) over which a
    3d field ``vshape`` splits for the smem3d body: every slab at least one
    plane, the widest slab's padded ``x`` (the rhs in device memory) and the
    kernels' static share in ``smem_limit``, its indices within the tables'
    16 bits (``mgmc_visit_smem3d.fits_indices``)."""
    from . import mgmc_visit_smem3d as v3

    Z, Y, X = (int(v) for v in vshape)
    return tuple(S for S in range(1, SMEM3D_MAX_CLUSTER + 1)
                 if Z // S >= 1 and v3.fits_indices(Z, Y, X, S)
                 and v3.smem_bytes(Z, Y, X, S, False) + SMEM3D_STATIC_SMEM <= int(smem_limit))


def smem3d_fits(vshape, offsets, smem_limit: int) -> bool:
    """The rule of the smem3d body: a 3d stencil of reach 1 with fewer than
    :data:`PASSES_DIM3_MIN_OFFSETS` offsets on a field whose chain fits a
    cluster of at most :data:`SMEM3D_MAX_CLUSTER` blocks
    (:func:`smem3d_sizes`)."""
    from .mgmc_visit import stencil_reach

    return (len(vshape) == 3 and stencil_reach(offsets) <= 1
            and len(offsets) < PASSES_DIM3_MIN_OFFSETS
            and bool(smem3d_sizes(vshape, smem_limit)))


def sweep_body(vshape, offsets, smem_limit: Optional[int] = None) -> str:
    """The body of the one-block route's kernels for fields ``vshape`` and a
    stencil of ``offsets``: ``"passes"`` (``csrc/sor_sweep_passes.cu``) for 2d
    stencils of reach 1 with at most :data:`PASSES_MAX_OFFSETS` offsets, every
    level of the flagship and of the drivers; for the reach-2 and 3d stencils
    of :func:`passes_build`, ``"smem"`` (``csrc/sor_sweep_smem.cu``) where a
    chain fits shared memory (:func:`smem_fits` under ``smem_limit``, default
    :data:`CPU_SMEM_LIMIT`) and ``"passes"`` (that source's reach-2 or 3d
    build) where it does not, but for 3d stencils of fewer than
    :data:`PASSES_DIM3_MIN_OFFSETS`, which take ``"smem3d"``
    (``csrc/sor_sweep_smem3d.cu``) where a cluster holds a chain
    (:func:`smem3d_fits`) and :data:`SMEM3D_SWEEPS` lists the shape, and the
    generic body where not;
    ``"generic"`` (``csrc/sor_sweep.cu``) for every other stencil."""
    build = passes_build(vshape, offsets)
    if build is None:
        return "generic"
    if build == (1, 2):
        return "passes"
    limit = CPU_SMEM_LIMIT if smem_limit is None else smem_limit
    if smem_fits(vshape, offsets, limit):
        return "smem"
    if build == (1, 3) and len(offsets) < PASSES_DIM3_MIN_OFFSETS:
        return ("smem3d" if smem3d_fits(vshape, offsets, limit)
                and smem3d_listed(vshape, limit) else "generic")
    return "passes"


def smem3d_listed(vshape, smem_limit: int) -> bool:
    """Whether :data:`SMEM3D_SWEEPS` gives the smem3d body's configurations of
    both kernels on fields ``vshape``, each within ``smem_limit`` and the
    cluster sizes the field splits over (:func:`smem3d_sizes`)."""
    from . import mgmc_visit_smem3d as v3

    shape = tuple(int(v) for v in vshape)
    rows = [SMEM3D_SWEEPS.get(shape + (kernel,)) for kernel in ("sweep", "gibbs")]
    if not all(rows):
        return False
    sizes = smem3d_sizes(shape, smem_limit)
    return all(S in sizes and v3.smem_bytes(*shape, S, c_shared) + SMEM3D_STATIC_SMEM
               <= int(smem_limit) for row in rows for _, _, S, c_shared, _ in row)


def smem3d_config(vshape, C: int, noise_mode: int) -> Tuple[int, bool, int]:
    """``(S, c_shared, threads)`` of the smem3d body for a sweep of ``C``
    chains (``noise_mode`` 0: the deterministic kernel, else the Gibbs
    kernel), as :data:`SMEM3D_SWEEPS` gives it; a shape it does not list
    raises ``ValueError`` (a launch there names its configuration)."""
    key = tuple(int(v) for v in vshape) + ("gibbs" if noise_mode else "sweep",)
    for least, most, S, c_shared, threads in SMEM3D_SWEEPS.get(key, ()):
        if C >= least and (most is None or C <= most):
            return S, c_shared, threads
    raise ValueError(f"no configuration of the smem3d body is measured for {C} chains of "
                     f"{key[:3]} (SMEM3D_SWEEPS); name one (smem3d=)")


def passes_max_threads(build: Tuple[int, int]) -> int:
    """The block bound of the passes body's kernels in ``build``: 1024 in the
    reach-1 build, :data:`PASSES_WIDE_MAX_THREADS` in the reach-2 and 3d
    builds."""
    return 1024 if tuple(build) == (1, 2) else PASSES_WIDE_MAX_THREADS


def sweep_threads(C: int, n: int, sms: int, most_threads: int = 1024) -> int:
    """Threads per block of a launch of the passes body of ``C`` chains of
    ``n`` points, on a card of ``sms`` SMs: the largest of
    :data:`SWEEP_WAVE_THREADS` whose blocks run all chains in one wave (the
    smallest where none does), bounded by the field's
    :data:`SWEEP_MOST_THREADS` and :data:`SWEEP_LEAST_THREADS`, and by the
    kernel's bound ``most_threads`` (:func:`passes_max_threads`)."""
    wave = next((t for t in SWEEP_WAVE_THREADS if C <= sms * (1024 // t)), SWEEP_WAVE_THREADS[-1])
    most = next(t for points, t in SWEEP_MOST_THREADS if n >= points)
    least = next(t for points, t in SWEEP_LEAST_THREADS if n >= points)
    return min(max(least, min(most, wave)), most_threads)


def _sweep_offsets(P: SweepParams):
    """The stencil's offsets of a parameter block, ``(dy, dx)`` of a 2d field
    (``Z`` = 1) and ``(dz, dy, dx)`` of a 3d one."""
    if P.Z == 1:
        return tuple((P.dy[k], P.dx[k]) for k in range(P.K))
    return tuple((P.dz[k], P.dy[k], P.dx[k]) for k in range(P.K))


def _sweep_vshape(P: SweepParams) -> Tuple[int, ...]:
    return (P.Y, P.X) if P.Z == 1 else (P.Z, P.Y, P.X)


def pass_params(P: SweepParams):
    """The passes' parameter block (``VisitParams`` of ``visit_phases.cuh``
    in the build of :func:`passes_build`: ``mgmc_visit.VisitParams``,
    ``WideVisitParams`` or ``VolumeVisitParams``) of a sweep: the sweep's own
    parameter block with no low-rank term (``m = 0``) and no coarse level
    (a 3d field's rows are ``(z, y)``, ``H = Z Y``); ``f_batched`` says whether
    ``b`` is per chain.  The Philox stream is set per launch."""
    from .mgmc_visit import PHASE_BUILDS

    build = passes_build(_sweep_vshape(P), _sweep_offsets(P))
    if build is None or (build == (1, 2) and P.n_order > PASSES_MAX_COLORS):
        raise ValueError("the passes take 2d stencils of reach 1 with at most "
                         f"{PASSES_MAX_OFFSETS} offsets and {PASSES_MAX_COLORS} colours, 2d "
                         f"stencils of reach 2 with at most {WIDE_MAX_OFFSETS} offsets or the "
                         "5x5 box, and 3d stencils of reach 1")
    V = PHASE_BUILDS[build][1]()
    V.C, V.H, V.W = P.C, P.Z * P.Y, P.X
    V.K, V.diag_index = P.K, P.diag_index
    for k in range(P.K):
        V.dy[k], V.dx[k] = P.dy[k], P.dx[k]
        V.coeff_const[k], V.coeff_val[k] = P.coeff_const[k], P.coeff_val[k]
    V.n_colors, V.w0, V.w1, V.jstride = P.n_colors, P.wy, P.wx, P.jstride
    if build[1] == 3:
        V.Z, V.Y, V.wz = P.Z, P.Y, P.wz
        for k in range(P.K):
            V.dz[k] = P.dz[k]
    V.n_order = P.n_order
    for o in range(P.n_order):
        V.order[o] = P.order[o]
    V.omega = P.omega
    V.noise_mode, V.ns_const, V.ns_val = P.noise_mode, P.ns_const, P.ns_val
    V.f_batched = P.b_batched
    return V


class PassLaunch:
    """What a launch of the passes body takes besides the fields: the build
    (:func:`passes_build`), the parameter block (:func:`pass_params`), the rows
    table of the sweep's order (``mgmc_visit.colour_rows``) on the device, the
    stencil form (one kernel each) and the block size."""

    def __init__(self, P: SweepParams, const_coeffs, device, threads: int):
        from .mgmc_visit import colour_rows, stencil_form

        offsets = _sweep_offsets(P)
        self.build = passes_build(_sweep_vshape(P), offsets)
        self.params = pass_params(P)
        # per colour of the order the row residues that hold it and its first column
        self.rows = torch.from_numpy(colour_rows(self.params)).to(device)
        self.form = stencil_form(offsets, const_coeffs)
        self.threads = int(threads)

    def scratch_floats(self) -> int:
        """Floats of the Gibbs kernel's rhs scratch a chain, packed by colour:
        ``n_colors`` fields of ``H`` rows of ``ceil(W / jstride)``
        (``packed_index`` of ``level_passes.cuh``)."""
        V = self.params
        return V.n_colors * V.H * -(-V.W // V.jstride)

    def at(self, P: SweepParams) -> "PassLaunch":
        """This launch under ``P``'s Philox stream."""
        self.params.seed, self.params.counter = P.seed, P.counter
        return self


def smem_kmax(vshape, offsets) -> int:
    """The stencil size the shared-memory body's kernel is compiled for (one
    kernel each): 13 or 25 in 2d (the reach-2 forms 6 / 7 and 8 / 9), 7 or 27
    in 3d (the forms 10 / 11 and 12-15)."""
    K = len(offsets)
    if len(vshape) == 3:
        return 7 if K <= 7 else 27
    return WIDE_MAX_OFFSETS if K <= WIDE_MAX_OFFSETS else 25


#: banks of an SM's shared memory (4 bytes each)
SMEM_BANKS = 32


def bank_order(q: np.ndarray) -> np.ndarray:
    """The positions of the padded indices ``q`` dealt round the banks: one
    of each bank in turn (each bank's in storage order), so that a warp's 32
    consecutive entries fall on as many banks as there are."""
    bank = q % SMEM_BANKS
    rank = np.zeros(q.size, np.int64)
    for b in np.unique(bank):
        at = np.flatnonzero(bank == b)
        rank[at] = np.arange(at.size)
    return np.lexsort((bank, rank))


def bank_conflicts(q: np.ndarray, start) -> int:
    """Shared-memory wavefronts of one stencil term over a sweep: per warp
    of 32 consecutive entries of a colour the most that fall on one bank,
    summed (the ideal is the number of warps)."""
    total = 0
    for a, b in zip(start[:-1], start[1:]):
        for w in range(a, b, 32):
            total += int(np.bincount(q[w:min(w + 32, b)] % SMEM_BANKS).max())
    return total


def smem_tables(vshape, offsets, color_weights, n_colors: int, order, coeffs) -> dict:
    """The shared-memory body's tables of one sweep direction, from the
    coefficient planes ``coeffs`` (``(K, *vshape)``, as the kernel reads them):

    * ``table``: int32, every point once, colour after colour of ``order``:
      ``(q << 16) | p``, ``q`` its index in the padded ``x``
      (:func:`smem_padded`), ``p`` its index in the field; within a colour
      first the *interior* points, whose every coefficient whose neighbour lies
      in the field equals the level's interior value (the centre point's),
      then the others, each part dealt round the banks (:func:`bank_order`);
    * ``extra``: the columns of zeros beyond the halo, of ``0 ..
      SMEM_PITCH_SLACK`` the width whose table has the fewest bank conflicts
      (:func:`bank_conflicts`; the narrowest of equals);
    * ``start``: colour ``o`` of the order holds ``table[start[o] :
      start[o + 1]]``; ``plain[o]``: of which the first ``plain[o]`` are
      interior;
    * ``cval``: the interior coefficients (float32), ``rdiag``: ``1 /
      cval[diag]`` in float32, as the kernel's reciprocal plane holds it for
      the other points; ``planes``: bit ``k`` where coefficient ``k`` varies
      over the field (the other points read those planes, the rest are
      ``cval``)."""
    vshape = tuple(int(v) for v in vshape)
    dim, K = len(vshape), len(offsets)
    RZ, R = smem_halo(vshape, offsets)
    n = int(np.prod(vshape))
    if int(np.prod(smem_padded(vshape, offsets, SMEM_PITCH_SLACK))) >= 1 << 15 or n >= 1 << 16:
        raise ValueError(f"a field of {vshape} does not fit the table's 16-bit indices")
    coords = [g.reshape(-1) for g in np.meshgrid(*[np.arange(v) for v in vshape], indexing="ij")]
    z3 = coords[0] if dim == 3 else np.zeros(n, np.int64)
    colour = sum(int(w) * c for w, c in zip(color_weights, coords)) % n_colors
    c = np.asarray(coeffs, np.float32).reshape(K, n)
    cval = c[:, int(np.ravel_multi_index(tuple(v // 2 for v in vshape), vshape))].copy()
    inside = np.stack([np.all([(0 <= x + int(d)) & (x + int(d) < v) for x, d, v in
                               zip(coords, off, vshape)], axis=0) for off in offsets])
    plain = np.all((c == cval[:, None]) | ~inside, axis=0)
    p = np.arange(n)
    parts, start, nplain = [], [0], []
    for col in order:
        sel = colour == int(col)
        parts += [p[sel & plain], p[sel & ~plain]]
        nplain.append(int(np.count_nonzero(sel & plain)))
        start.append(start[-1] + int(np.count_nonzero(sel)))
    best = None
    for extra in range(SMEM_PITCH_SLACK + 1):
        _, PY, PX = smem_padded(vshape, offsets, extra)
        q = ((z3 + RZ) * PY + coords[-2] + R) * PX + coords[-1] + R
        table = np.concatenate([part[bank_order(q[part])] for part in parts])
        conflicts = bank_conflicts(q[table], start)
        if best is None or conflicts < best[0]:
            best = (conflicts, extra, (q[table] << 16) | table)
    diag = cval[[k for k, off in enumerate(offsets) if all(int(v) == 0 for v in off)][0]]
    varies = ~np.all(c == c[:, :1], axis=1)
    return {"table": best[2].astype(np.int32), "extra": best[1], "conflicts": best[0],
            "start": start, "plain": nplain, "cval": cval,
            "rdiag": np.float32(1.0) / np.float32(diag),
            "planes": int(sum(1 << k for k in np.flatnonzero(varies)))}


def smem_threads(start, C: int, sms: int) -> int:
    """Threads per block of the shared-memory body for ``C`` chains on a card
    of ``sms`` SMs: the largest colour's points in whole warps, at least 64,
    at most :data:`SMEM_WAVES_THREADS` where the chains take more than one
    wave of one block an SM (several blocks then share an SM and hide each
    other's latency), else at most :data:`SMEM_MAX_THREADS` (a block alone on
    its SM: a colour in one turn)."""
    most = max(b - a for a, b in zip(start[:-1], start[1:]))
    cap = SMEM_MAX_THREADS if C <= sms else SMEM_WAVES_THREADS
    return min(cap, max(64, 32 * -(-most // 32)))


def smem_params(P: SweepParams, tables: dict) -> SmemSweepParams:
    """The shared-memory body's parameter block of a sweep: its extents, the
    padded offsets, the interior coefficients and the colours' parts of the
    table (:func:`smem_tables`), and the sweep's own parameters.  The Philox
    stream is set per launch."""
    vshape, offsets = _sweep_vshape(P), _sweep_offsets(P)
    S = SmemSweepParams()
    S.C, S.Z, S.Y, S.X = P.C, P.Z, P.Y, P.X
    S.RZ, S.R = smem_halo(vshape, offsets)
    S.PZ, S.PY, S.PX = smem_padded(vshape, offsets, tables["extra"])
    S.K, S.diag_index = P.K, P.diag_index
    for k in range(P.K):
        S.soff[k] = (P.dz[k] * S.PY + P.dy[k]) * S.PX + P.dx[k]
        S.cval[k] = float(tables["cval"][k])
    S.rdiag = float(tables["rdiag"])
    S.planes = tables["planes"]
    S.n_order = P.n_order
    for o in range(P.n_order + 1):
        S.start[o] = tables["start"][o]
    for o in range(P.n_order):
        S.plain[o] = tables["plain"][o]
    S.omega = P.omega
    S.noise_mode, S.ns_const, S.ns_val = P.noise_mode, P.ns_const, P.ns_val
    S.b_batched = P.b_batched
    return S


class SmemLaunch:
    """What a launch of the shared-memory body takes besides the fields: the
    parameter block (:func:`smem_params`), the table on the device, the
    reciprocal of the diagonal plane, the compiled stencil size
    (:func:`smem_kmax`), the block size (:func:`smem_threads` on ``sms`` SMs)
    and the dynamic shared memory (:func:`smem_sweep_bytes`)."""

    def __init__(self, P: SweepParams, tables: dict, table: torch.Tensor, rdiag: torch.Tensor,
                 sms: int):
        vshape, offsets = _sweep_vshape(P), _sweep_offsets(P)
        self.params = smem_params(P, tables)
        self.table, self.rdiag = table, rdiag
        self.kmax = smem_kmax(vshape, offsets)
        self.threads = smem_threads(tables["start"], P.C, sms)
        self.nbytes = smem_sweep_bytes(vshape, offsets, tables["extra"])

    def at(self, P: SweepParams) -> "SmemLaunch":
        """This launch under ``P``'s Philox stream."""
        self.params.seed, self.params.counter = P.seed, P.counter
        return self


def smem3d_params(P: SweepParams, tables: dict, S: int, c_shared: bool) -> Smem3dSweepParams:
    """The smem3d body's parameter block of a sweep over clusters of ``S``:
    its extents, the padded row and plane, the widest slab, the rhs's place,
    the padded offsets and interior coefficients of ``tables``
    (``mgmc_visit_smem3d.visit_tables`` of the sweep's order), and the sweep's
    own parameters.  A stencil of fewer than :data:`SMEM3D_KMAX` offsets is
    padded with zero coefficients at the centre.  The Philox stream is set per
    launch."""
    Z, Y, X = P.Z, P.Y, P.X
    M = Smem3dSweepParams()
    M.C, M.Z, M.Y, M.X = P.C, Z, Y, X
    M.S, M.PX, M.PP = int(S), tables["PX"], tables["PP"]
    M.nz_max, M.c_shared = -(-Z // int(S)), int(c_shared)
    M.K, M.diag_index = P.K, P.diag_index
    for k in range(P.K):
        M.soff[k] = (P.dz[k] * M.PP + P.dy[k] * M.PX + P.dx[k])
        M.cval[k] = float(tables["cval"][k])
    M.rdiag = float(np.float32(1.0) / np.float32(tables["cval"][P.diag_index]))
    M.planes = tables["planes"]
    M.n_order = P.n_order
    M.omega = P.omega
    M.noise_mode, M.ns_const, M.ns_val = P.noise_mode, P.ns_const, P.ns_val
    M.b_batched = P.b_batched
    return M


class Smem3dLaunch:
    """What a launch of the smem3d body takes besides the fields: the
    parameter block (:func:`smem3d_params`), the tables on the device, the
    reciprocal of the diagonal plane, the cluster size, the rhs's place, the
    block size and the dynamic shared memory
    (``mgmc_visit_smem3d.smem_bytes``)."""

    def __init__(self, P: SweepParams, tables: dict, words: torch.Tensor, rdiag: torch.Tensor,
                 S: int, c_shared: bool, threads: int):
        from . import mgmc_visit_smem3d as v3

        self.params = smem3d_params(P, tables, S, c_shared)
        self.tables, self.rdiag = words, rdiag
        self.S, self.c_shared, self.threads = int(S), bool(c_shared), int(threads)
        self.nbytes = v3.smem_bytes(P.Z, P.Y, P.X, self.S, self.c_shared)

    def at(self, P: SweepParams) -> "Smem3dLaunch":
        """This launch under ``P``'s Philox stream."""
        self.params.seed, self.params.counter = P.seed, P.counter
        return self


def kernel_support_error(op: StencilOperator, n_colors: int) -> Optional[str]:
    """Why the sweep kernels cannot take this operator, or None if they can."""
    if len(op.vshape) not in (2, 3):
        return "the sweep kernels take 2d and 3d fields only"
    if len(op.offsets) > MAX_OFFSETS:
        return f"more than {MAX_OFFSETS} stencil offsets"
    if n_colors > MAX_COLORS:
        return f"more than {MAX_COLORS} colours"
    return None


class SweepPlan:
    """Static configuration of one sweep direction on one operator: the
    coefficient planes, the colour order, the Gibbs noise scale and (built at
    first launch) the kernels' parameter blocks."""

    def __init__(self, op: StencilOperator, coloring: Coloring, omega: float,
                 order: Tuple[int, ...], masks: Optional[torch.Tensor] = None):
        self.op = op
        self.coloring = coloring
        self.omega = float(omega)
        self.order = tuple(int(c) for c in order)
        self.masks = masks if masks is not None else torch.as_tensor(
            coloring.masks(), dtype=op.dtype, device=op.device)
        self.coeffs = op.coeffs.contiguous()
        self.noise_scale = noise_scale(op, self.omega).contiguous()
        #: the one-block route's body (:func:`sweep_body`, the card's grant
        #: on a CUDA device)
        self.body = sweep_body(op.vshape, op.offsets, smem_limit_of(op.device))
        #: threads per block of the generic body
        self.threads = default_threads(int(np.prod(op.vshape)))
        self._compressed = None
        self._params_cache = {}
        self._pass_cache = {}
        self._smem_cache = {}
        self._smem_tables = None
        self._smem3d_tables = {}
        self._smem3d_cache = {}
        self._rdiag = None
        self._routes = {}

    def on_kernel_device(self) -> bool:
        """Whether sweeps of this plan go through the CUDA kernels: the
        operator is 2d or 3d and lies on a CUDA device in float32.  Everything
        else (the CPU, float64 on the card) is the caller's explicit choice of
        the plain version."""
        return (self.op.device.type == "cuda" and self.op.dtype == torch.float32
                and len(self.op.vshape) in (2, 3))

    def params(self, C: int, b_batched: bool, noise_mode: int, philox) -> SweepParams:
        """The kernels' parameter block (both routes take the same); built once
        per launch configuration, together with the configuration's route
        (:meth:`route`); only the Philox stream changes from launch to launch."""
        key = (C, bool(b_batched), noise_mode)
        P = self._params_cache.get(key)
        if P is None:
            P = self._params_cache[key] = self._build_params(*key)
            self.route(C, noise_mode)
        P.seed, P.counter = philox if philox is not None else (0, 0)
        return P

    def route(self, C: int, noise_mode: int = 0) -> Tuple[str, int]:
        """The route a sweep of ``C`` chains launches (:func:`sweep_route`),
        decided once per chain count and kernel."""
        key = (C, noise_mode != 0)
        if key not in self._routes:
            self._routes[key] = sweep_route(C, self, noise_mode)
        return self._routes[key]

    def pass_launch(self, P: SweepParams) -> PassLaunch:
        """The passes body's launch of the configuration of ``P`` (built by
        :meth:`params`), kept per configuration; block size
        :func:`sweep_threads` on the card's SM count."""
        key = (P.C, bool(P.b_batched), P.noise_mode)
        if key not in self._pass_cache:
            launch = PassLaunch(P, self._compressed[0], self.op.device, 0)
            launch.threads = sweep_threads(P.C, int(np.prod(self.op.vshape)),
                                           sm_count(self.op.device),
                                           passes_max_threads(launch.build))
            self._pass_cache[key] = launch
        return self._pass_cache[key].at(P)

    def smem_launch(self, P: SweepParams) -> SmemLaunch:
        """The shared-memory body's launch of the configuration of ``P``
        (built by :meth:`params`), kept per configuration; the table
        (:func:`smem_tables`) and the reciprocal diagonal plane are built once
        per plan."""
        if self._smem_tables is None:
            op = self.op
            tables = smem_tables(op.vshape, op.offsets, self.coloring.weights,
                                 self.coloring.n_colors, self.order,
                                 self.coeffs.detach().cpu().numpy())
            self._smem_tables = (tables, torch.from_numpy(tables["table"]).to(op.device),
                                 self._reciprocal_diag())
        key = (P.C, bool(P.b_batched), P.noise_mode)
        if key not in self._smem_cache:
            self._smem_cache[key] = SmemLaunch(P, *self._smem_tables, sm_count(self.op.device))
        return self._smem_cache[key].at(P)

    def smem3d_launch(self, P: SweepParams,
                      config: Optional[Tuple[int, bool, int]] = None) -> Smem3dLaunch:
        """The smem3d body's launch of the configuration of ``P`` (built by
        :meth:`params`) as :func:`smem3d_config` gives it for the card, or
        ``config`` ``(S, c_shared, threads)`` where named, kept per
        configuration; the tables of a cluster size
        (``mgmc_visit_smem3d.visit_tables``) and the reciprocal diagonal
        plane are built once per plan."""
        from . import mgmc_visit_smem3d as v3

        op = self.op
        if config is None:
            config = smem3d_config(op.vshape, P.C, P.noise_mode)
        S, c_shared, threads = int(config[0]), bool(config[1]), int(config[2])
        if S not in self._smem3d_tables:
            tables = v3.visit_tables(self, [self.order], S)
            self._smem3d_tables[S] = (tables, torch.from_numpy(tables["words"]).to(op.device))
        key = (P.C, bool(P.b_batched), P.noise_mode, S, c_shared, threads)
        if key not in self._smem3d_cache:
            tables, words = self._smem3d_tables[S]
            self._smem3d_cache[key] = Smem3dLaunch(P, tables, words, self._reciprocal_diag(), S,
                                                   c_shared, threads)
        return self._smem3d_cache[key].at(P)

    def _reciprocal_diag(self) -> torch.Tensor:
        """``1 / diag``, the plane the shared-memory bodies read where the
        diagonal varies; built once per plan."""
        if self._rdiag is None:
            self._rdiag = torch.reciprocal(self.coeffs[self.op.diag_index]).contiguous()
        return self._rdiag

    def _build_params(self, C: int, b_batched: bool, noise_mode: int) -> SweepParams:
        op = self.op
        err = kernel_support_error(op, self.coloring.n_colors)
        if err is not None:
            raise NotImplementedError(err)
        if self._compressed is None:
            self._compressed = compress_plan(op, self.omega)[:2]
        const_coeffs, ns_const = self._compressed
        return build_sweep_params(
            op.vshape, op.offsets, op.diag_index, self.coloring.n_colors,
            self.coloring.weights, self.order, self.omega, const_coeffs, ns_const,
            C, b_batched, noise_mode)


def build_sweep_params(vshape, offsets, diag_index: int, n_colors: int, color_weights,
                       order, omega: float, const_coeffs, ns_const: Optional[float],
                       C: int, b_batched: bool, noise_mode: int) -> SweepParams:
    """The kernels' parameter block from plain values.  ``const_coeffs`` holds
    per offset a float where the coefficient plane travels as a scalar, else
    ``None`` (the plane is then read from the coefficient tensor); ``ns_const``
    likewise for the noise scale."""
    lead = 3 - len(vshape)  # 2d fields are 3d fields with Z = 1
    P = SweepParams()
    P.C = C
    P.Z, P.Y, P.X = (1,) * lead + tuple(vshape)
    P.K, P.diag_index = len(offsets), diag_index
    for k, (off, cval) in enumerate(zip(offsets, const_coeffs)):
        P.dz[k], P.dy[k], P.dx[k] = (0,) * lead + tuple(off)
        P.coeff_const[k] = int(cval is not None)
        P.coeff_val[k] = 0.0 if cval is None else cval
    P.n_colors = n_colors
    P.wz, P.wy, P.wx = (0,) * lead + tuple(int(w) for w in color_weights)
    P.jstride = n_colors // math.gcd(P.wx, n_colors)
    P.n_order = len(order)
    for o, c in enumerate(order):
        P.order[o] = c
    P.omega = omega
    P.noise_mode = noise_mode
    P.ns_const = int(ns_const is not None)
    P.ns_val = 0.0 if ns_const is None else ns_const
    P.b_batched = int(b_batched)
    return P


def noise_scale(op: StencilOperator, omega: float) -> torch.Tensor:
    """``sqrt(diag (2 - omega) / omega)`` as a grid field: the standard
    deviation of the Gibbs sweep's diagonal noise term."""
    return torch.sqrt(op.diag_stencil() * ((2.0 - omega) / omega))


# ------------------------------------------------------------- plain versions
def sweep_batched_plain(op: StencilOperator, masks: torch.Tensor, omega: float,
                        order: Tuple[int, ...], b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the deterministic kernel: one multi-colour SOR
    sweep on the stencil part, ``x[l] += omega*(b[l] - (Ax)[l]) / a_ll`` colour
    by colour.  Any leading batch dims; returns a new tensor, ``x`` is not
    modified."""
    diag = op.diag_stencil()
    for c in order:
        ax = op.apply_stencil(x)
        x = x + masks[c] * (omega * (b - ax) / diag)
    return x


def gibbs_sweep_batched_plain(op: StencilOperator, masks: torch.Tensor, omega: float,
                              order: Tuple[int, ...], f: torch.Tensor, x: torch.Tensor,
                              xi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the Gibbs kernel: the sweep on
    ``c = f + sqrt(diag (2 - omega) / omega) xi`` with the normals ``xi`` (shape
    of ``x``) given.  Returns a new tensor."""
    return sweep_batched_plain(op, masks, omega, order, f + noise_scale(op, omega) * xi, x)


# ------------------------------------------------------------------ wrappers
def flatten_chains(vshape: Tuple[int, ...], b: torch.Tensor, x: torch.Tensor):
    """``(b, x, batch)`` in the kernels' layout: ``x`` with its leading chain
    axes flattened to one (a single field becomes a batch of one), ``b`` shared
    (``vshape``) or flattened like ``x``, both contiguous; ``batch`` is the
    chain shape to restore with ``reshape(batch + vshape)``."""
    vdim = len(vshape)
    batch = tuple(x.shape[: x.ndim - vdim])
    xf = x.reshape((-1,) + tuple(vshape)).contiguous()
    if b.ndim == vdim:
        bf = b.contiguous()
    else:
        bf = torch.broadcast_to(b, x.shape).reshape(xf.shape).contiguous()
    return bf, xf, batch


def _check_sweep_args(plan: SweepPlan, b, x, xi=None):
    """Validate what goes to the kernel by pointer; returns ``(C, b_batched)``."""
    vshape = plan.op.vshape
    vdim = len(vshape)
    if x.ndim != vdim + 1 or tuple(x.shape[1:]) != vshape:
        raise ValueError(f"x must be (C, {', '.join(map(str, vshape))}), got {tuple(x.shape)}")
    C = x.shape[0]
    if tuple(b.shape) not in (vshape, (C,) + vshape):
        raise ValueError(f"b must be {vshape} or {(C,) + vshape}, got {tuple(b.shape)}")
    tensors = {"x": x, "b": b}
    if xi is not None:
        if xi.shape != x.shape:
            raise ValueError(f"xi must have the shape of x, got {tuple(xi.shape)}")
        tensors["xi"] = xi
    for name, t in tensors.items():
        if t.device != plan.coeffs.device:
            raise ValueError(f"{name} lies on {t.device}, the operator on {plan.coeffs.device}")
        if t.dtype != torch.float32 or plan.coeffs.dtype != torch.float32:
            raise TypeError("the sweep kernels are float32 only "
                            f"({name} is {t.dtype}, the operator {plan.coeffs.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return C, b.ndim == vdim + 1


def sweep_batched(plan: SweepPlan, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One deterministic colour-ordered SOR sweep of all chains; returns ``x``.

    ``x`` is ``(C, *vshape)``, ``b`` is ``vshape`` (shared) or ``(C, *vshape)``.
    CPU tensors go to :func:`sweep_batched_plain`.  CUDA tensors launch the
    kernel of ``plan.route(C)``, which updates ``x`` in place, or raise."""
    if x.device.type == "cpu":
        return sweep_batched_plain(plan.op, plan.masks, plan.omega, plan.order, b, x)
    return launch_sweep(plan, plan.route(x.shape[0]), b, x)


def gibbs_sweep_batched(plan: SweepPlan, f: torch.Tensor, x: torch.Tensor,
                        xi: Optional[torch.Tensor] = None,
                        philox: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One colour-ordered Gibbs sweep of all chains on
    ``c = f + sqrt(diag (2 - omega) / omega) xi``; returns ``x``.

    The normals: ``philox=(seed, counter)`` for the in-kernel generator (CUDA
    only) or ``xi`` as a tensor of the shape of ``x`` - exactly one of the two.
    CPU tensors go to :func:`gibbs_sweep_batched_plain`.  CUDA tensors launch
    the kernel of ``plan.route(C)``, which updates ``x`` in place, or raise."""
    if (xi is None) == (philox is None):
        raise ValueError("give the field noise as a tensor or as a Philox stream, one of the two")
    if x.device.type == "cpu":
        if philox is not None:
            raise ValueError("the Philox stream exists in the CUDA kernel only")
        return gibbs_sweep_batched_plain(plan.op, plan.masks, plan.omega, plan.order, f, x, xi)
    return launch_gibbs_sweep(plan, plan.route(x.shape[0], 1), f, x, xi, philox)


def _check_route(route, x: torch.Tensor) -> Tuple[str, int]:
    if x.device.type != "cuda":
        raise ValueError("a kernel launch takes tensors on a CUDA device")
    kind, S = route
    if kind not in ROUTES or (kind == "block") != (S == 1):
        raise ValueError(f"route must be {BLOCK_ROUTE} or ('split', S), got {route!r}")
    return kind, int(S)


def _check_body(body: str, vshape, offsets, route, stamps, x, blocks: int = 1) -> None:
    """The one-block body asked for against what it takes; the stamps tensor
    against the launch (the one-block route only; a row per block, ``blocks``
    a chain for the smem3d body)."""
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    build = passes_build(vshape, offsets)
    if body == "passes" and build is None:
        raise ValueError("the passes body takes 2d stencils of reach 1 with at most "
                         f"{PASSES_MAX_OFFSETS} offsets, 2d stencils of reach 2 with at most "
                         f"{WIDE_MAX_OFFSETS} offsets or the 5x5 box, and 3d stencils of reach 1")
    if body == "smem" and (build in (None, (1, 2))
                           or not smem_fits(vshape, offsets, smem_limit_of(x.device))):
        raise ValueError("the shared-memory body takes the reach-2 and 3d stencils of the "
                         "passes' builds on fields that fit shared memory (smem_fits)")
    if body == "smem3d" and not smem3d_fits(vshape, offsets, smem_limit_of(x.device)):
        raise ValueError("the smem3d body takes 3d stencils of reach 1 and fewer than "
                         f"{PASSES_DIM3_MIN_OFFSETS} offsets on fields whose chain fits a "
                         "cluster (smem3d_fits)")
    if stamps is None:
        return
    if route[0] != "block":
        raise ValueError("only the one-block route has a stamps build")
    if body == "passes" and build != (1, 2):
        raise ValueError("the passes body's reach-2 and 3d builds have no stamps build")
    width = STAMP_WIDTHS[body]
    rows = x.shape[0] * (blocks if body == "smem3d" else 1)
    if (stamps.dtype != torch.int64 or stamps.device != x.device or not stamps.is_contiguous()
            or tuple(stamps.shape) != (rows, width)):
        raise ValueError(f"stamps must be a contiguous int64 ({rows}, {width}) tensor on "
                         f"{x.device}")


def _launch(P: SweepParams, route: Tuple[str, int], vshape, threads: int, x: torch.Tensor,
            b: torch.Tensor, coeffs: torch.Tensor, ns: Optional[torch.Tensor] = None,
            xi: Optional[torch.Tensor] = None, passes: Optional[PassLaunch] = None,
            stamps: Optional[torch.Tensor] = None, smem: Optional[SmemLaunch] = None,
            smem3d: Optional[Smem3dLaunch] = None) -> int:
    """Launch the deterministic kernel (``P.noise_mode == 0``) or the Gibbs
    kernel of ``route`` on the current stream of ``x``'s device; returns the
    CUDA error.  On the one-block route ``passes`` takes the passes body,
    ``smem`` the shared-memory body, ``smem3d`` its 3d slabs over a cluster
    (none: the generic body, with ``threads`` per block); ``stamps`` takes the
    body's stamps build."""
    kind, S = route
    gibbs = P.noise_mode != 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "split":
            lib, t = load_split_library(), split_threads(vshape, S)
            if gibbs:
                return lib.sor_gibbs_sweep_cluster(
                    ctypes.byref(P), x.data_ptr(), b.data_ptr(), coeffs.data_ptr(),
                    ns.data_ptr(), tensor_ptr(xi), S, t, stream)
            return lib.sor_sweep_cluster(ctypes.byref(P), x.data_ptr(), b.data_ptr(),
                                         coeffs.data_ptr(), S, t, stream)
        if smem is not None:
            lib = load_smem_library(stamps is not None)
            M, table, rdiag = ctypes.byref(smem.params), smem.table.data_ptr(), smem.rdiag
            if gibbs:
                return lib.sor_smem_gibbs_sweep(
                    M, table, x.data_ptr(), b.data_ptr(), coeffs.data_ptr(), rdiag.data_ptr(),
                    ns.data_ptr(), tensor_ptr(xi), smem.kmax, smem.threads, smem.nbytes,
                    tensor_ptr(stamps), stream)
            return lib.sor_smem_sweep(M, table, x.data_ptr(), b.data_ptr(), coeffs.data_ptr(),
                                      rdiag.data_ptr(), smem.kmax, smem.threads, smem.nbytes,
                                      tensor_ptr(stamps), stream)
        if smem3d is not None:
            lib = load_smem3d_library(stamps is not None)
            M, words, rdiag = ctypes.byref(smem3d.params), smem3d.tables.data_ptr(), smem3d.rdiag
            if gibbs:
                scratch = None if smem3d.c_shared else torch.empty_like(x)
                return lib.sor_smem3d_gibbs_sweep(
                    M, words, x.data_ptr(), b.data_ptr(), tensor_ptr(scratch), coeffs.data_ptr(),
                    rdiag.data_ptr(), ns.data_ptr(), tensor_ptr(xi), smem3d.threads,
                    smem3d.nbytes, tensor_ptr(stamps), stream)
            return lib.sor_smem3d_sweep(M, words, x.data_ptr(), b.data_ptr(), coeffs.data_ptr(),
                                        rdiag.data_ptr(), smem3d.threads, smem3d.nbytes,
                                        tensor_ptr(stamps), stream)
        if passes is not None:
            lib = load_passes_library(stamps is not None, *passes.build)
            V, rows = ctypes.byref(passes.params), passes.rows.data_ptr()
            if gibbs:
                scratch = torch.empty((x.shape[0], passes.scratch_floats()), dtype=x.dtype,
                                      device=x.device)
                return lib.sor_passes_gibbs_sweep(
                    V, rows, x.data_ptr(), b.data_ptr(), scratch.data_ptr(), coeffs.data_ptr(),
                    ns.data_ptr(), tensor_ptr(xi), passes.form, passes.threads,
                    tensor_ptr(stamps), stream)
            return lib.sor_passes_sweep(V, rows, x.data_ptr(), b.data_ptr(), coeffs.data_ptr(),
                                        passes.form, passes.threads, tensor_ptr(stamps), stream)
        lib = load_library(stamps is not None)
        if gibbs:
            scratch = torch.empty_like(x)  # c, written before the first phase
            return lib.sor_gibbs_sweep_batched(
                ctypes.byref(P), x.data_ptr(), b.data_ptr(), scratch.data_ptr(),
                coeffs.data_ptr(), ns.data_ptr(), tensor_ptr(xi), threads, tensor_ptr(stamps),
                stream)
        return lib.sor_sweep_batched(ctypes.byref(P), x.data_ptr(), b.data_ptr(),
                                     coeffs.data_ptr(), threads, tensor_ptr(stamps), stream)


def _count_name(base: str, route, body: str) -> str:
    """The launch count of ``base`` through ``route`` and ``body``."""
    if route[0] == "split":
        return base + "_split"
    return base if body == "passes" else f"{base}_{body}"


def _passes_of(plan: SweepPlan, P: SweepParams, route, body: str,
               threads: Optional[int]) -> Optional[PassLaunch]:
    """The passes body's launch where the one-block route takes that body,
    with ``threads`` per block where given (else :func:`sweep_threads`)."""
    if body != "passes" or route[0] != "block":
        return None
    passes = plan.pass_launch(P)
    if threads is not None:
        passes = copy.copy(passes)
        passes.threads = int(threads)
    return passes


def _smem_of(plan: SweepPlan, P: SweepParams, route, body: str) -> Optional[SmemLaunch]:
    """The shared-memory body's launch where the one-block route takes that
    body."""
    return plan.smem_launch(P) if body == "smem" and route[0] == "block" else None


def _smem3d_of(plan: SweepPlan, P: SweepParams, route, body: str,
               config: Optional[Tuple[int, bool, int]]) -> Optional[Smem3dLaunch]:
    """The smem3d body's launch (its configuration ``config`` where named)
    where the one-block route takes that body."""
    if body != "smem3d" or route[0] != "block":
        return None
    return plan.smem3d_launch(P, config)


def launch_sweep(plan: SweepPlan, route: Tuple[str, int], b: torch.Tensor,
                 x: torch.Tensor, body: Optional[str] = None,
                 stamps: Optional[torch.Tensor] = None,
                 threads: Optional[int] = None,
                 smem3d: Optional[Tuple[int, bool, int]] = None) -> torch.Tensor:
    """One deterministic sweep through the kernel of ``route``
    (:data:`BLOCK_ROUTE` or ``("split", S)``); :func:`sweep_batched` takes
    ``plan.route(C)``, ``chip_smoke.py`` names the route to hold the two
    against each other.  ``body`` names the one-block route's body (default:
    ``plan.body``; ``chip_smoke.py`` holds the two against each other),
    ``stamps`` takes its stamps build, an int64 tensor of shape ``(C,
    STAMP_WIDTHS[body])`` that the launch fills (:func:`sweep_pass_times`);
    ``threads`` sets the passes body's block size (default:
    :func:`sweep_threads`; the shared-memory body's is
    :func:`smem_threads`), ``smem3d`` the smem3d body's ``(S, c_shared,
    threads)`` (default: :func:`smem3d_config`; its stamps have a row per
    block, ``C S``).  Updates ``x`` in place and returns it, or raises."""
    route = _check_route(route, x)
    body = plan.body if body is None else body
    _check_body(body, plan.op.vshape, plan.op.offsets, route, None, x)
    C, b_batched = _check_sweep_args(plan, b, x)
    P = plan.params(C, b_batched, 0, None)
    cluster = _smem3d_of(plan, P, route, body, smem3d)
    if stamps is not None:
        _check_body(body, plan.op.vshape, plan.op.offsets, route, stamps, x,
                    cluster.S if cluster is not None else 1)
    passes = _passes_of(plan, P, route, body, threads)
    err = _launch(P, route, plan.op.vshape, plan.threads, x, b, plan.coeffs, passes=passes,
                  stamps=stamps, smem=_smem_of(plan, P, route, body), smem3d=cluster)
    name = _count_name("sweep_batched", route, body)
    launch_counts[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err}")
    return x


def launch_gibbs_sweep(plan: SweepPlan, route: Tuple[str, int], f: torch.Tensor,
                       x: torch.Tensor, xi: Optional[torch.Tensor] = None,
                       philox: Optional[Tuple[int, int]] = None, body: Optional[str] = None,
                       stamps: Optional[torch.Tensor] = None,
                       threads: Optional[int] = None,
                       smem3d: Optional[Tuple[int, bool, int]] = None) -> torch.Tensor:
    """One Gibbs sweep through the kernel of ``route``, as :func:`launch_sweep`;
    the normals as :func:`gibbs_sweep_batched` takes them.  The generic and
    passes bodies write ``c`` to a scratch field (the passes body packs it by
    colour), the split kernel and the shared-memory bodies form it in shared
    memory (the smem3d body in a scratch field where its configuration keeps
    the rhs in device memory)."""
    if (xi is None) == (philox is None):
        raise ValueError("give the field noise as a tensor or as a Philox stream, one of the two")
    route = _check_route(route, x)
    body = plan.body if body is None else body
    _check_body(body, plan.op.vshape, plan.op.offsets, route, None, x)
    C, f_batched = _check_sweep_args(plan, f, x, xi)
    P = plan.params(C, f_batched, 1 if philox is not None else 2, philox)
    cluster = _smem3d_of(plan, P, route, body, smem3d)
    if stamps is not None:
        _check_body(body, plan.op.vshape, plan.op.offsets, route, stamps, x,
                    cluster.S if cluster is not None else 1)
    passes = _passes_of(plan, P, route, body, threads)
    err = _launch(P, route, plan.op.vshape, plan.threads, x, f, plan.coeffs,
                  plan.noise_scale, xi, passes, stamps, _smem_of(plan, P, route, body), cluster)
    name = _count_name("gibbs_sweep_batched", route, body)
    launch_counts[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err}")
    return x


def sweep_pass_names(order, gibbs: bool, body: str = "passes"):
    """The passes of a one-block sweep in the order its stamps time them (each
    ends with a barrier): the Gibbs rhs (the shared-memory bodies: the
    copy-in, with the Gibbs rhs), then one per colour of ``order``."""
    if body in ("smem", "smem3d"):
        return ["copy-in and rhs" if gibbs else "copy-in"] + [f"colour {c}" for c in order]
    return (["rhs"] if gibbs else []) + [f"colour {c}" for c in order]


def barrier_count(order, gibbs: bool, body: str = "passes") -> int:
    """Barriers of one one-block sweep launch: the passes and generic bodies
    place one after the Gibbs rhs pass, the shared-memory bodies one after the
    copy-in (and rhs) of both kernels (the smem3d body's a cluster barrier);
    then one after each colour of ``order``.  The stamps builds count them on
    the card."""
    return len(order) + int(gibbs or body in ("smem", "smem3d"))


def sweep_pass_times(order, gibbs: bool, stamps, body: str = "passes") -> dict:
    """Where one one-block sweep launch went, from the ``stamps`` it wrote
    (``common.stamp_breakdown``; any body's, by the width of its rows): us
    per pass, their sum, the spans, the barriers each block passed and the
    blocks one SM ran at once."""
    return stamp_breakdown(stamps, sweep_pass_names(order, gibbs, body), int(stamps.shape[1]))


# ------------------------------------------- entry points on raw arrays (v1)
# The JAX package's first-generation sweeps take the operator as raw arrays
# (``coeffs``, ``offsets``, ``diag_index``, the linear colouring's weights) and
# were four kernels because of the TPU's one-tile and chain-block limits.  On
# this card they are entry points over the two kernels above: a single chain is
# a batch of one, every coefficient plane is read from ``coeffs``, the noise
# scale ``sqrt(diag (2 - omega) / omega)`` is a plane computed here, and a seed
# becomes the Philox ``(seed, counter)`` pair; chains are told apart by the
# chain index in the Philox counter, not by one seed per chain block.
def _raw_masks(vshape, color_weights, n_colors: int, like: torch.Tensor) -> torch.Tensor:
    """Colour masks ``(n_colors, *vshape)`` of the linear colouring
    ``(sum_d w_d i_d) mod n_colors``."""
    grids = torch.meshgrid(*[torch.arange(n, device=like.device) for n in vshape], indexing="ij")
    color = sum(int(w) * g for w, g in zip(color_weights, grids)) % n_colors
    return torch.stack([(color == c) for c in range(n_colors)]).to(like.dtype)


def _raw_stencil(coeffs, offsets, x):
    from ..stencil import shift

    y = None
    for k, off in enumerate(offsets):
        t = coeffs[k] * shift(x, tuple(off))
        y = t if y is None else y + t
    return y


def _raw_noise_scale(coeffs, diag_index: int, omega: float) -> torch.Tensor:
    return torch.sqrt(coeffs[diag_index] * ((2.0 - omega) / omega))


def philox_from_seed(seed) -> Tuple[int, int]:
    """The Philox ``(seed, counter)`` pair of a v1 seed: an int is the seed
    with counter 0; a sequence of 32-bit key words gives the seed from the
    first two words and the counter from the next two."""
    if isinstance(seed, torch.Tensor):
        seed = seed.detach().cpu().numpy()
    words = [int(w) & 0xFFFFFFFF for w in np.atleast_1d(np.asarray(seed)).reshape(-1)]
    if np.ndim(seed) == 0:
        return int(seed) & 0xFFFFFFFFFFFFFFFF, 0
    if not 1 <= len(words) <= 4:
        raise ValueError("a seed is an int or one to four 32-bit key words")
    words += [0] * (4 - len(words))
    return words[0] | (words[1] << 32), words[2] | (words[3] << 32)


def fused_sor_sweep_batched_plain(coeffs, b, x, *, offsets, diag_index, omega, order,
                                  color_weights, n_colors):
    """Plain PyTorch version of :func:`fused_sor_sweep_batched` (and, on one
    field, of :func:`fused_sor_sweep`).  Returns a new tensor."""
    vshape = tuple(coeffs.shape[1:])
    masks = _raw_masks(vshape, color_weights, n_colors, coeffs)
    diag = coeffs[diag_index]
    for c in order:
        x = x + masks[c] * (omega * (b - _raw_stencil(coeffs, offsets, x)) / diag)
    return x


fused_sor_sweep_plain = fused_sor_sweep_batched_plain


def fused_gibbs_sweep_batched_plain(xi, coeffs, f, x, *, offsets, diag_index, omega, order,
                                    color_weights, n_colors):
    """Plain PyTorch version of :func:`fused_gibbs_sweep_batched` (and of
    :func:`fused_gibbs_sweep`): the sweep on ``f + sqrt(diag (2 - omega) /
    omega) xi`` with the normals ``xi`` (shape of ``x``) given in place of the
    seed."""
    c = f + _raw_noise_scale(coeffs, diag_index, omega) * xi
    return fused_sor_sweep_batched_plain(
        coeffs, c, x, offsets=offsets, diag_index=diag_index, omega=omega, order=order,
        color_weights=color_weights, n_colors=n_colors)


fused_gibbs_sweep_plain = fused_gibbs_sweep_batched_plain


def _launch_raw(name, coeffs, b, x, xi, philox, *, offsets, diag_index, omega, order,
                color_weights, n_colors):
    """Validate raw arrays, build the parameter block and launch the
    deterministic kernel (``xi`` and ``philox`` both ``None``) or the Gibbs
    kernel of the route of ``C`` chains (:func:`split_route`); ``x`` is
    ``(C, *vshape)`` and updated in place."""
    vshape = tuple(coeffs.shape[1:])
    if len(vshape) not in (2, 3) or coeffs.shape[0] != len(offsets):
        raise ValueError(f"coeffs {tuple(coeffs.shape)} do not match {len(offsets)} offsets "
                         "on a 2d or 3d field")
    if len(offsets) > MAX_OFFSETS or n_colors > MAX_COLORS:
        raise NotImplementedError(f"more than {MAX_OFFSETS} offsets or {MAX_COLORS} colours")
    C = x.shape[0]
    if tuple(x.shape[1:]) != vshape or tuple(b.shape) not in (vshape, (C,) + vshape):
        raise ValueError(f"x {tuple(x.shape)} / b {tuple(b.shape)} do not match the "
                         f"coefficients' field shape {vshape}")
    tensors = {"coeffs": coeffs, "b": b, "x": x}
    if xi is not None:
        if xi.shape != x.shape:
            raise ValueError(f"xi must have the shape of x, got {tuple(xi.shape)}")
        tensors["xi"] = xi
    for tname, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{tname} lies on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the sweep kernels are float32 only ({tname} is {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
    noise_mode = 0 if (xi is None and philox is None) else (1 if philox is not None else 2)
    P = build_sweep_params(vshape, offsets, diag_index, n_colors, color_weights, order,
                           float(omega), (None,) * len(offsets), None, C,
                           b.ndim == len(vshape) + 1, noise_mode)
    P.seed, P.counter = philox if philox is not None else (0, 0)
    route = split_route(C, vshape, offsets, noise_mode, x.device)
    ns = _raw_noise_scale(coeffs, diag_index, omega).contiguous() if noise_mode else None
    n = int(np.prod(vshape))
    passes = None
    # raw arrays read every coefficient plane: the passes' reach-1 build where
    # it takes the stencil, else the generic body
    if route[0] == "block" and passes_build(vshape, offsets) == (1, 2):
        # every coefficient plane is read from the tensor
        passes = PassLaunch(P, (None,) * len(offsets), x.device,
                            sweep_threads(C, n, sm_count(x.device))).at(P)
    err = _launch(P, route, vshape, default_threads(n), x, b, coeffs, ns, xi, passes)
    launch_counts[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err}")
    return x


def fused_sor_sweep_batched(coeffs, b, x, *, offsets, diag_index, omega, order,
                            color_weights, n_colors):
    """One deterministic colour-ordered SOR sweep of ``x (C, *vshape)`` on raw
    arrays: ``coeffs (K, *vshape)``, ``b`` shaped like ``x``.  CPU tensors go to
    :func:`fused_sor_sweep_batched_plain`; CUDA tensors launch the deterministic
    kernel of their route on a copy of ``x`` or raise.  Returns a new tensor."""
    kw = dict(offsets=offsets, diag_index=diag_index, omega=omega, order=order,
              color_weights=color_weights, n_colors=n_colors)
    if x.device.type == "cpu":
        return fused_sor_sweep_batched_plain(coeffs, b, x, **kw)
    return _launch_raw("fused_sor_sweep_batched", coeffs, b, x.clone(), None, None, **kw)


def fused_sor_sweep(coeffs, b, x, *, offsets, diag_index, omega, order, color_weights,
                    n_colors):
    """One deterministic sweep of one field ``x (*vshape)``: a batch of one
    through the deterministic kernel.  Returns a new tensor."""
    kw = dict(offsets=offsets, diag_index=diag_index, omega=omega, order=order,
              color_weights=color_weights, n_colors=n_colors)
    if x.device.type == "cpu":
        return fused_sor_sweep_plain(coeffs, b, x, **kw)
    if x.ndim != coeffs.ndim - 1:
        raise ValueError(f"x must be one field of shape {tuple(coeffs.shape[1:])}")
    out = _launch_raw("fused_sor_sweep", coeffs, b, x.clone()[None], None, None, **kw)
    return out[0]


def fused_gibbs_sweep_batched(seed, coeffs, f, x, *, offsets, diag_index, omega, order,
                              color_weights, n_colors, xi=None):
    """One Gibbs sweep of ``x (C, *vshape)`` on raw arrays.  ``seed`` (an int
    or up to four 32-bit key words, see :func:`philox_from_seed`) feeds the
    in-kernel generator; alternatively ``seed=None`` and the normals ``xi``
    (shape of ``x``).  CPU tensors go to the plain version, which needs ``xi``;
    CUDA tensors launch the Gibbs kernel of their route on a copy of ``x`` or
    raise."""
    kw = dict(offsets=offsets, diag_index=diag_index, omega=omega, order=order,
              color_weights=color_weights, n_colors=n_colors)
    if (seed is None) == (xi is None):
        raise ValueError("give a seed or the normals xi, one of the two")
    if x.device.type == "cpu":
        if xi is None:
            raise ValueError("the Philox stream exists in the CUDA kernel only: pass xi")
        return fused_gibbs_sweep_batched_plain(xi, coeffs, f, x, **kw)
    philox = None if seed is None else philox_from_seed(seed)
    return _launch_raw("fused_gibbs_sweep_batched", coeffs, f, x.clone(), xi, philox, **kw)


def fused_gibbs_sweep(seed, coeffs, f, x, *, offsets, diag_index, omega, order, color_weights,
                      n_colors, xi=None):
    """One Gibbs sweep of one field ``x (*vshape)``: a batch of one through
    the Gibbs kernel.  Arguments as :func:`fused_gibbs_sweep_batched`."""
    kw = dict(offsets=offsets, diag_index=diag_index, omega=omega, order=order,
              color_weights=color_weights, n_colors=n_colors)
    if (seed is None) == (xi is None):
        raise ValueError("give a seed or the normals xi, one of the two")
    if x.device.type == "cpu":
        if xi is None:
            raise ValueError("the Philox stream exists in the CUDA kernel only: pass xi")
        return fused_gibbs_sweep_plain(xi, coeffs, f, x, **kw)
    if x.ndim != coeffs.ndim - 1:
        raise ValueError(f"x must be one field of shape {tuple(coeffs.shape[1:])}")
    philox = None if seed is None else philox_from_seed(seed)
    out = _launch_raw("fused_gibbs_sweep", coeffs, f, x.clone()[None],
                      None if xi is None else xi[None].contiguous(), philox, **kw)
    return out[0]
