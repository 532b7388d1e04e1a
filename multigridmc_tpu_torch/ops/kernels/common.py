"""What the hand-written CUDA kernels of the port share on the host side.

* **The build.**  Every kernel source of ``csrc/`` is compiled by ``nvcc`` for
  ``sm_90a`` at first use into the package's ``build/`` directory as a shared
  library with a plain C interface, and loaded with ``ctypes``
  (:func:`build_library`, :func:`build_libraries`, :func:`open_library`).  A
  library is named by the hash of its source, the headers it includes and the
  compiler flags, so a stale one is never loaded.  A missing compiler or a
  failing build raises; nothing falls back to another path.
* **Resident-set compression** (:func:`compress_plan`, :func:`support_boxes`):
  what a kernel need not read per point.
* **The generator's reference** (:func:`philox_normals_reference`): the
  in-kernel Philox4x32-10 field noise of ``csrc/philox.cuh``, recomputed with
  numpy.
* **The shared-memory probe** (:func:`smem_copy`, :func:`probe_dynamic_smem`,
  :func:`dynamic_smem_limit`): a copy kernel (``csrc/smem_probe.cu``) that tells
  how much dynamic shared memory the card grants a thread block.  Replaces
  ``_probe_limit_compiles`` of
  ``multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py``; the subtree kernel
  sizes its shared-memory placement with it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..stencil import StencilOperator, interior_mask

_PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "build"

#: headers under ``csrc/`` that the kernel sources include
HEADERS = ("philox.cuh", "visit_phases.cuh", "level_passes.cuh", "sor_sweep.cuh",
           "block_stamps.cuh", "slab3d.cuh")

#: every kernel source under ``csrc/`` (``<name>.cu``)
SOURCES = ("mgmc_visit", "mgmc_visit_stream", "mgmc_visit_split", "mgmc_visit_smem",
           "mgmc_visit_smem3d", "sor_sweep", "sor_sweep_passes", "sor_sweep_smem",
           "sor_sweep_smem3d", "sor_sweep_cluster", "mgmc_subtree", "smem_probe")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: the flags of the phase visit kernels' stamps build, a second library of
#: ``csrc/mgmc_visit.cu`` (a measurement aid; production launches take the
#: first)
PHASE_STAMPS_FLAGS = ("-DPHASE_STAMPS_BUILD=1",)
#: the flags of the sweep kernels' stamps builds, second libraries of
#: ``csrc/sor_sweep_passes.cu``, ``csrc/sor_sweep_smem.cu``,
#: ``csrc/sor_sweep_smem3d.cu`` and ``csrc/sor_sweep.cu``
SWEEP_STAMPS_FLAGS = ("-DSWEEP_STAMPS_BUILD=1",)

#: the flags of the phase visit kernels' reach-2 build, a third library of
#: ``csrc/mgmc_visit.cu``: a parameter block of 25 offsets and 9 colours and
#: the reach-2 stencil forms (the squared shifted-Laplace prior's levels)
PHASE_REACH2_FLAGS = ("-DVISIT_REACH=2",)
#: the flags of the reach-2 build's stamps build (a measurement aid)
PHASE_REACH2_STAMPS_FLAGS = PHASE_REACH2_FLAGS + PHASE_STAMPS_FLAGS
#: the flags of the smem visit kernels' stamps builds, a second library of
#: ``csrc/mgmc_visit_smem.cu`` and of ``csrc/mgmc_visit_smem3d.cu``
SMEM_VISIT_STAMPS_FLAGS = ("-DSMEM_VISIT_STAMPS_BUILD=1",)
#: the flags of the phase visit kernels' 3d build, a fourth library of
#: ``csrc/mgmc_visit.cu``: a parameter block of 27 offsets with the z extents,
#: and the 3d passes and stencil forms (7-point and 27-point levels)
PHASE_DIM3_FLAGS = ("-DVISIT_DIM=3",)
#: the flags of the 3d build's stamps build (a measurement aid)
PHASE_DIM3_STAMPS_FLAGS = PHASE_DIM3_FLAGS + PHASE_STAMPS_FLAGS
#: the flags of the subtree kernel's reach-2 build, a second library of
#: ``csrc/mgmc_subtree.cu``: the same parameter block and forms as
#: :data:`PHASE_REACH2_FLAGS`
SUBTREE_REACH2_FLAGS = ("-DVISIT_REACH=2",)
#: the reach-2 build's three libraries, one instance of the kernel each so that
#: they compile in parallel: the production kernel, its stamps build (a
#: measurement aid) and the kernel bounded to 1024 threads (the block-size
#: measurement's)
SUBTREE_REACH2_PARTS = {"production": SUBTREE_REACH2_FLAGS,
                        "stamps": SUBTREE_REACH2_FLAGS + ("-DSUBTREE_PART=1",),
                        "block1024": SUBTREE_REACH2_FLAGS + ("-DSUBTREE_PART=2",)}

#: every library the port builds: each source of :data:`SOURCES`, the stamps
#: builds of ``mgmc_visit`` (reach 1, reach 2 and 3d), ``mgmc_visit_smem``,
#: ``mgmc_visit_smem3d``,
#: ``sor_sweep_passes``, ``sor_sweep_smem``, ``sor_sweep_smem3d`` and
#: ``sor_sweep``, the reach-2 and 3d builds of ``mgmc_visit`` and of
#: ``sor_sweep_passes`` and the reach-2 build of ``mgmc_subtree`` in its three
#: libraries (:data:`VARIANT_BUILDS`);
#: :func:`build_libraries` compiles them in parallel (``chip_smoke.py`` checks
#: the stamps by default, and beside the production libraries their builds
#: add no wall time)
STAMPS_BUILDS = (("mgmc_visit", PHASE_STAMPS_FLAGS), ("sor_sweep_passes", SWEEP_STAMPS_FLAGS),
                 ("sor_sweep_smem", SWEEP_STAMPS_FLAGS), ("sor_sweep", SWEEP_STAMPS_FLAGS),
                 ("mgmc_visit", PHASE_REACH2_STAMPS_FLAGS),
                 ("mgmc_visit_smem", SMEM_VISIT_STAMPS_FLAGS),
                 ("mgmc_visit", PHASE_DIM3_STAMPS_FLAGS),
                 ("mgmc_visit_smem3d", SMEM_VISIT_STAMPS_FLAGS),
                 ("sor_sweep_smem3d", SWEEP_STAMPS_FLAGS))
VARIANT_BUILDS = (("mgmc_visit", PHASE_REACH2_FLAGS), ("mgmc_visit", PHASE_DIM3_FLAGS),
                  ("sor_sweep_passes", PHASE_REACH2_FLAGS),
                  ("sor_sweep_passes", PHASE_DIM3_FLAGS)) + tuple(
    ("mgmc_subtree", flags) for flags in SUBTREE_REACH2_PARTS.values())
BUILDS = SOURCES + STAMPS_BUILDS + VARIANT_BUILDS


# ------------------------------------------------------------------- the build
def source_path(name: str) -> Path:
    """``csrc/<name>.cu``."""
    return CSRC_DIR / f"{name}.cu"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            f"{CSRC_DIR} at first use and need the CUDA toolkit")
    return found


def library_path(name: str, extra_flags: Tuple[str, ...] = ()) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: named by the hash of the
    source, the shared headers and the flags."""
    digest = hashlib.sha1(source_path(name).read_bytes())
    for header in HEADERS:
        digest.update((CSRC_DIR / header).read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build_libraries(builds: Iterable, extra_flags: Tuple[str, ...] = ()) -> Dict:
    """Compile the given sources, one ``nvcc`` process each, all started
    together: each item a source's name, or ``(name, flags)`` for a source
    compiled with flags of its own as well (:data:`BUILDS`); returns ``{item:
    library path}``.  Raises when the compiler is missing or any build fails."""
    jobs, paths = [], {}
    for item in builds:
        name, flags = (item, ()) if isinstance(item, str) else item
        flags = tuple(extra_flags) + tuple(flags)
        out = paths[item] = library_path(name, flags)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(source_path(name))]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for cmd, tmp, out, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({' '.join(cmd)}):\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def build_library(name: str, extra_flags: Tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/`` and return the library's path."""
    return build_libraries([name], extra_flags)[name]


@functools.lru_cache(maxsize=None)
def open_library(name: str, extra_flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (at first use) and load the shared library of ``csrc/<name>.cu``
    compiled with ``extra_flags``.  The caller sets the argument types of the
    entry points it uses."""
    return ctypes.CDLL(str(build_library(name, extra_flags)))


def stamp_breakdown(stamps, names, width: int) -> dict:
    """Where one launch of a one-block-per-chain kernel went, from the timer
    stamps of its stamps build (``csrc/block_stamps.cuh``: per block a row of
    ``width`` words, the timer at entry, after each barrier and at exit, then
    the barriers passed and the SM), in microseconds: per pass ``names[k]``
    (the one that ends at barrier ``k + 1``) the median over the blocks
    (``passes``; the first from the block's entry), ``exit_us`` after the
    last, ``sum_us`` their sum; per block the span from entry to exit, its
    median (``block_span_us``) and the largest; ``launch_span_us`` from the
    first entry to the last exit; measured on the card, not modelled: the
    barriers each block passed (``barriers_per_block``, the distinct counts),
    the most blocks one SM ran at once and the SMs used."""
    raw = np.asarray(torch.as_tensor(stamps).cpu().numpy())
    t = raw[:, :1 + len(names)].astype(np.float64)
    exit_ = raw[:, width - 3].astype(np.float64)
    barriers, sm = raw[:, width - 2], raw[:, width - 1]
    per_pass = np.median(np.diff(t, axis=1), axis=0) / 1e3
    span = (exit_ - t[:, 0]) / 1e3
    at_once = 0
    for q in np.unique(sm):
        ev = sorted([(e, 1) for e in t[sm == q, 0]] + [(e, -1) for e in exit_[sm == q]])
        at_once = max(at_once, int(np.max(np.cumsum([d for _, d in ev]))))
    exit_us = float(np.median(exit_ - t[:, -1]) / 1e3)
    return {"passes": dict(zip(names, per_pass.tolist())), "exit_us": exit_us,
            "sum_us": float(per_pass.sum()) + exit_us,
            "block_span_us": float(np.median(span)), "slowest_block_us": float(span.max()),
            "launch_span_us": float((exit_.max() - t[:, 0].min()) / 1e3),
            "barriers_per_block": sorted(int(v) for v in np.unique(barriers)),
            "blocks_per_sm": at_once, "sms": int(np.unique(sm).size)}


def default_threads(n: int) -> int:
    """Threads per block (= per chain; one warp works on one row at a time)
    for a field of ``n`` points.  Measured on an H100 with
    ``chip_smoke.py --phases threads`` at 256 chains."""
    if n >= 16000:
        return 1024
    return 512 if n >= 3000 else 256


#: streaming multiprocessors of an H100 SXM, the card the port targets: what
#: :func:`sm_count` answers on the CPU, where nothing is launched
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    if device.type == "cpu":
        return H100_SMS
    return int(torch.cuda.get_device_properties(device).multi_processor_count)


def sm_count(device=None) -> int:
    """Streaming multiprocessors of ``device`` (default: the current CUDA
    device); :data:`H100_SMS` on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _sm_count(device)


def tensor_ptr(t):
    """``data_ptr`` of a tensor, ``None`` (a null pointer) for ``None``."""
    return None if t is None else t.data_ptr()


# ------------------------------------------------- resident-set compression
def compress_plan(op: StencilOperator, omega: float):
    """What the CUDA kernels need not read per point.

    Returns ``(const_coeffs, ns_const, bbox)``:

    * ``const_coeffs`` - per offset a float where the coefficient plane is
      spatially constant on the region where it acts (``None`` where it
      varies).  Constant-kappa FD priors have all planes constant;
      Galerkin-coarsened levels generally do not.
    * ``ns_const`` - the constant Gibbs noise scale ``sqrt(D (2-omega)/omega)``
      when the stencil diagonal is constant (computed in float32), else None.
    * ``bbox`` - per measurement column its support's bounding box
      (:func:`support_boxes`: ``(i0, i1, j0, j1)`` in 2d, ``(k0, k1, i0, i1,
      j0, j1)`` in 3d, half open); the visit kernels read ``B_k`` only there.

    Of the TPU kernel's ``compress_plan`` this keeps the two devices that save
    L2 traffic here; one-hot columns become bounding boxes (which also cover
    the 3x3 columns of coarser levels and degrade gracefully to dense ``B``).
    """
    coeffs = op.coeffs.detach().cpu().numpy()
    cc = []
    for k, off in enumerate(op.offsets):
        vals = coeffs[k][interior_mask(op.vshape, off) > 0]
        if vals.size and bool(np.all(vals == vals.flat[0])):
            cc.append(float(vals.flat[0]))
        else:
            cc.append(None)
    ns_const = None
    dval = cc[op.diag_index]
    if dval is not None:
        ns_const = float(np.sqrt(np.float32(dval) * np.float32((2.0 - omega) / omega)))
    bbox = ()
    if op.lowrank is not None:
        bbox = support_boxes(op.lowrank.B)
    return tuple(cc), ns_const, bbox


def support_boxes(fields: torch.Tensor) -> Tuple[Tuple[int, ...], ...]:
    """Per field of ``(m, *vshape)`` the bounding box of its nonzeros, half
    open, axis after axis: ``(i0, i1, j0, j1)`` of a 2d field, ``(k0, k1, i0,
    i1, j0, j1)`` of a 3d one; an all-zero field gets the empty box."""
    boxes = []
    for col in fields.detach().cpu().numpy():
        nz = np.nonzero(col)
        boxes.append(tuple(v for axis in nz for v in (
            (int(axis.min()), int(axis.max()) + 1) if axis.size else (0, 0))))
    return tuple(boxes)


# ------------------------------------------------- reference of the generator
#: the kernels' Philox key is ``seed ^ PHILOX_KEY_MIX`` ("MGMC_KEY" in ASCII;
#: ``PHILOX_KEY_MIX`` in ``csrc/philox.cuh``).  torch's CUDA generator seeded with
#: ``seed`` runs the same Philox4x32-10 under the key ``seed`` with the counter
#: ``(offset / 4, 0, thread, 0)``; under that key the kernels' normals of chain 0
#: would be torch's own draws of the same run.
PHILOX_KEY_MIX = 0x4D474D435F4B4559


def philox_key(seed: int) -> int:
    """The kernels' 64-bit Philox key for ``seed``."""
    return (int(seed) & 0xFFFFFFFFFFFFFFFF) ^ PHILOX_KEY_MIX


def philox_normals_reference(seed: int, counter: int, chains: int,
                             vshape: Tuple[int, ...], key: Optional[int] = None,
                             first_chain: int = 0) -> np.ndarray:
    """The kernels' field noise, recomputed on the host with numpy:
    ``(chains, *vshape)`` float32 normals of launch ``counter`` under ``seed``,
    of the chains ``first_chain .. first_chain + chains - 1``.

    Philox4x32-10 with counter words ``(point group, chain, counter lo,
    counter hi)`` and key ``(key lo, key hi)``, ``key = philox_key(seed)``
    unless given (``key=seed`` is torch's own generator's key, against which
    ``chip_smoke.py`` shows why the kernels mix theirs).  A row is a line of the
    field along its last (fastest) axis, rows numbered in storage order
    (``i`` in 2d, ``z * Y + y`` in 3d).  Group ``g`` of row ``i`` has the
    number ``i * ceil(W / 4) + g``; its four output words give the normals of
    the points ``(i, 4g .. 4g+3)`` by two Box-Muller transforms (cosine, sine,
    cosine, sine), ``u1 = ((w >> 8) + 1) / 2^24`` in (0, 1],
    ``u2 = (w >> 8) / 2^24``.  Philox is a bijection of the counter for a fixed
    key, so two launches, chains or groups never share a stream.  Agrees with
    the kernel up to the last bits of ``log`` / ``sincos``."""
    vshape = tuple(int(v) for v in vshape)
    H, W = int(np.prod(vshape[:-1])), vshape[-1]
    M0, M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    mask = np.uint64(0xFFFFFFFF)
    ngroups = H * ((W + 3) // 4)
    c0 = np.broadcast_to(np.arange(ngroups, dtype=np.uint64), (chains, ngroups)).copy()
    c1 = np.broadcast_to(np.arange(first_chain, first_chain + chains, dtype=np.uint64)[:, None],
                         (chains, ngroups)).copy()
    c2 = np.full((chains, ngroups), counter & 0xFFFFFFFF, dtype=np.uint64)
    c3 = np.full((chains, ngroups), (counter >> 32) & 0xFFFFFFFF, dtype=np.uint64)
    key = philox_key(seed) if key is None else int(key)
    k0, k1 = key & 0xFFFFFFFF, (key >> 32) & 0xFFFFFFFF
    for _ in range(10):
        p0, p1 = M0 * c0, M1 * c2
        hi0, lo0 = p0 >> np.uint64(32), p0 & mask
        hi1, lo1 = p1 >> np.uint64(32), p1 & mask
        c0, c1, c2, c3 = hi1 ^ c1 ^ np.uint64(k0), lo1, hi0 ^ c3 ^ np.uint64(k1), lo0
        k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
    scale = np.float32(1.0 / 16777216.0)

    def pair(a, b):
        u1 = ((a >> np.uint64(8)) + np.uint64(1)).astype(np.float32) * scale
        u2 = (b >> np.uint64(8)).astype(np.float32) * scale
        r = np.sqrt(np.float32(-2.0) * np.log(u1))
        ang = np.float32(2.0 * np.pi) * u2
        return r * np.cos(ang), r * np.sin(ang)

    z0, z1 = pair(c0, c1)
    z2, z3 = pair(c2, c3)
    z = np.stack([z0, z1, z2, z3], axis=-1).reshape(chains, H, -1)
    return z[:, :, :W].astype(np.float32).reshape((chains,) + vshape)


# --------------------------------------------------- the shared-memory probe
#: dynamic shared memory a block may use without asking (bytes)
DEFAULT_SMEM_BYTES = 48 * 1024

#: shape of the tensor the probe copies, as the TPU probe's
PROBE_SHAPE = (8, 128)

#: launches of the probe kernel made by :func:`smem_copy`
launch_counts: Dict[str, int] = {"smem_probe": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class SharedMemoryRefused(RuntimeError):
    """The card does not grant a block the dynamic shared memory asked for."""


@functools.lru_cache(maxsize=None)
def load_probe_library() -> ctypes.CDLL:
    lib = open_library("smem_probe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.smem_probe.argtypes = [ptr, ptr, i32, i32, ptr]  # in, out, n, bytes, stream
    lib.smem_probe.restype = i32
    return lib


def smem_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the probe kernel: a copy."""
    return x.clone()


def smem_copy(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Copy the float32 tensor ``x`` (shape :data:`PROBE_SHAPE`) through
    ``nbytes`` of a block's dynamic shared memory and return the copy.

    A CPU tensor goes to :func:`smem_copy_plain`.  A CUDA tensor launches the
    probe kernel; when the card refuses the size, :class:`SharedMemoryRefused`
    is raised (that answer is the probe's purpose), any other failure is a
    ``RuntimeError``."""
    if tuple(x.shape) != PROBE_SHAPE or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"the probe copies a contiguous float32 tensor of shape {PROBE_SHAPE}")
    if nbytes < 4 * x.numel():
        raise ValueError(f"the probe needs at least {4 * x.numel()} bytes of shared memory")
    if x.device.type == "cpu":
        return smem_copy_plain(x)
    lib = load_probe_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.smem_probe(x.data_ptr(), out.data_ptr(), x.numel(), int(nbytes), stream)
    if err >= 1000:  # refused before any launch
        raise SharedMemoryRefused(
            f"{nbytes} bytes of dynamic shared memory refused: CUDA error {err - 1000}")
    launch_counts["smem_probe"] += 1
    if err != 0:
        raise SharedMemoryRefused(
            f"launch with {nbytes} bytes of dynamic shared memory refused: CUDA error {err}")
    return out


def probe_dynamic_smem(nbytes: int, device=None) -> bool:
    """Whether a thread block on ``device`` (default: the current CUDA device)
    is granted ``nbytes`` of dynamic shared memory: the probe kernel is
    launched with that size and its copy compared with its input.  On the CPU
    there is no shared memory; the answer is whether ``nbytes`` stays within
    :data:`DEFAULT_SMEM_BYTES`."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return nbytes <= DEFAULT_SMEM_BYTES
    x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.float32,
                     device=device).reshape(PROBE_SHAPE)
    try:
        out = smem_copy(x, nbytes)
    except SharedMemoryRefused:
        return False
    if not torch.equal(out, x):
        raise RuntimeError(f"the shared-memory probe with {nbytes} bytes returned a wrong copy")
    return True


@functools.lru_cache(maxsize=None)
def _dynamic_smem_limit(device: torch.device) -> int:
    if device.type == "cpu":
        return DEFAULT_SMEM_BYTES
    props = torch.cuda.get_device_properties(device)
    top = int(getattr(props, "shared_memory_per_block_optin", 0)) or 227 * 1024
    return top if probe_dynamic_smem(top, device) else DEFAULT_SMEM_BYTES


def dynamic_smem_limit(device=None) -> int:
    """The largest dynamic shared memory (bytes) a block is granted on
    ``device``, found once per device with :func:`probe_dynamic_smem`: what the
    device reports as its opt-in maximum (227 KiB where it reports none) if the
    probe is granted it, else :data:`DEFAULT_SMEM_BYTES`, which needs no
    asking.  On the CPU: :data:`DEFAULT_SMEM_BYTES`."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _dynamic_smem_limit(device)
