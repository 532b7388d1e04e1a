"""The process mesh of the multi-device samplers.

Counterpart of ``multigridmc_tpu/parallel/mesh.py``.  The JAX package lays its
devices out as a ``jax.sharding.Mesh`` inside one program and lets
``shard_map`` hand every device its block; here every device is a process of
its own (one rank a GPU over NCCL, or a CPU process over gloo where the caller
asks for it), and a :class:`Mesh` names each rank's place in a
``chains x lattice`` grid of ranks:

* the axis names are ``"chains"`` (data parallel: independent chains) followed
  by up to three lattice axes ``lz`` / ``ly`` / ``lx`` (domain decomposition,
  slowest grid axis first), ranks laid out row-major over them;
* per axis a process group, the line of ranks along that axis through this
  rank (a halo exchange and the coarse agglomeration run along one axis);
* the **lattice group**: the ranks that share this rank's chains index and
  hold the blocks of one global field.  The ``B^T x`` of the Woodbury
  correction is reduced over it and over nothing else.

Groups are made with ``torch.distributed.new_group``, which every rank calls
for every group in the same order; a group of one rank is never made (nothing
is ever sent in it).  A world of one needs no process group at all.

:func:`scatter_field` / :func:`gather_field` cut a global field into this
rank's block and put the blocks back together; they stand where
``field_spec`` / ``shard_field`` / ``replicated`` stand in the JAX package,
whose arrays are global and sharded implicitly.
"""

from __future__ import annotations

import datetime
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: mesh axis names for lattice dims, slowest array axis first (z, y, x)
AXIS_NAMES = ("lz", "ly", "lx")
#: the data-parallel axis, always the first (slowest) axis of a mesh
CHAINS = "chains"

#: how long a collective may wait for its peers before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def factor_devices(n: int, dim: int) -> Tuple[int, ...]:
    """Factor n devices into a near-square mesh over up to ``dim`` lattice axes."""
    shape = [1] * dim
    remaining = n
    # greedily split by smallest prime factors, round-robin over axes
    primes = []
    d = 2
    while remaining > 1:
        while remaining % d == 0:
            primes.append(d)
            remaining //= d
        d += 1
    for i, p in enumerate(sorted(primes, reverse=True)):
        shape[i % dim] *= p
    return tuple(sorted(shape, reverse=True))


# ----------------------------------------------------------------- the world
def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _local_rank(rank: int) -> int:
    """This process's card: ``LOCAL_RANK`` where a launcher set it, else the
    global rank modulo the cards of this host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``cuda:<local rank>`` by default, the CPU only
    where ``device`` says so.  Raises where a CUDA device is asked for and none
    is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the parallel samplers run on CUDA devices by default and "
                               "none is available; pass device='cpu' to run over gloo")
        if dev.index is None:
            dev = torch.device("cuda", _local_rank(world_rank()))
    return dev


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> int:
    """Initialise the default process group and return the world size.

    ``init_method`` is ``"env://"`` by default (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) or an explicit address such as
    ``"tcp://localhost:29500"`` with ``world_size`` and ``rank``.  On a CUDA
    device (the default) the backend is NCCL and this process takes the card
    ``LOCAL_RANK`` (else ``rank`` modulo the host's cards); gloo only where the
    caller passes ``device="cpu"``.  A failed initialisation raises: nothing
    falls back to another backend or device.  Safe to call twice.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    dev = torch.device("cuda" if device is None else device)
    if init_method is None:
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for the NCCL backend; "
                               "pass device='cpu' to run over gloo")
        local = dev.index if dev.index is not None else _local_rank(rank)
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"init_distributed: rank {rank} wants card {local} of "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: no backend for device '{dev}'")
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank), timeout=TIMEOUT)
    # one collective now, so that a broken backend fails here and not mid-cycle
    probe = torch.ones(1, device=rank_device(dev) if dev.type == "cuda" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"init_distributed: all_reduce over {world_size} ranks gave "
                           f"{probe.item()}")
    return dist.get_world_size()


# ------------------------------------------------------------------ the mesh
class Mesh:
    """This rank's place in a ``chains x lattice`` grid of ranks.

    ``shape`` maps the axis names, ``"chains"`` first and then the lattice
    axes, to their sizes; their product is the world size.  Ranks are laid out
    row-major over the axes, so the rank is this process's linear index over
    ``chains x lattice``.  Every rank of the world constructs the same mesh at
    the same point of its program (the groups are made collectively).
    ``solo=True`` makes a mesh of this process alone (every axis of size 1,
    no group), whatever the world: the world of one that a mesh is held
    against (:func:`single_mesh`).
    """

    def __init__(self, shape: Dict[str, int], device=None, solo: bool = False):
        names = tuple(shape)
        if not names or names[0] != CHAINS:
            raise ValueError(f"a mesh's first axis is '{CHAINS}', got {names}")
        for name in names[1:]:
            if name not in AXIS_NAMES:
                raise ValueError(f"unknown lattice axis '{name}' (one of {AXIS_NAMES})")
        if list(names[1:]) != sorted(names[1:], key=AXIS_NAMES.index):
            raise ValueError(f"lattice axes out of order: {names[1:]}")
        self.axis_names = names
        self.shape = {n: int(shape[n]) for n in names}
        self.size = int(np.prod(list(self.shape.values())))
        world = 1 if solo else world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks, the world {world}")
        self.device = rank_device(device)
        self.rank = 0 if solo else world_rank()
        sizes = [self.shape[n] for n in names]
        grid = np.arange(self.size).reshape(sizes)
        here = np.unravel_index(self.rank, sizes)
        self.coords = {n: int(c) for n, c in zip(names, here)}
        # every rank makes every group, in one order: per axis each line, then
        # each chains index's lattice group
        self.axis_ranks: Dict[str, Tuple[int, ...]] = {}
        self.groups: Dict[str, Optional[object]] = {}
        for ax, name in enumerate(names):
            line_of_mine = None
            others = [range(s) for i, s in enumerate(sizes) if i != ax]
            for idx in itertools.product(*others):
                sel = list(idx)
                sel.insert(ax, slice(None))
                ranks = tuple(int(r) for r in grid[tuple(sel)])
                group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
                if self.rank in ranks:
                    line_of_mine = (ranks, group)
            self.axis_ranks[name], self.groups[name] = line_of_mine
        self.lattice_ranks: Tuple[int, ...] = ()
        self.lattice_group = None
        for c in range(self.shape[CHAINS]):
            ranks = tuple(int(r) for r in grid[c].reshape(-1))
            group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if c == self.coords[CHAINS]:
                self.lattice_ranks, self.lattice_group = ranks, group

    # ------------------------------------------------------------- properties
    @property
    def lattice_axes(self) -> Tuple[str, ...]:
        return self.axis_names[1:]

    @property
    def lattice_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.lattice_axes)

    @property
    def lattice_size(self) -> int:
        return int(np.prod(self.lattice_shape)) if self.lattice_axes else 1

    @property
    def chains_size(self) -> int:
        return self.shape[CHAINS]

    @property
    def chains_index(self) -> int:
        return self.coords[CHAINS]

    def __repr__(self) -> str:  # pragma: no cover
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"


def lattice_mesh(dim: int, mesh_shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A mesh of the whole world over the last ``min(dim, 2)`` lattice axes
    (or ``len(mesh_shape)`` of them), chains axis of size 1."""
    return multihost_lattice_mesh(dim, chains=1, mesh_shape=mesh_shape, device=device)


def multihost_lattice_mesh(dim: int, chains: int = 1,
                           mesh_shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A ``chains x lattice`` mesh over every rank of the world: ``chains``
    data-parallel shards, each a lattice decomposition over the rest (near
    square, :func:`factor_devices`, over ``min(dim, 2)`` axes by default).
    Call :func:`init_distributed` first on every process."""
    n = world_size()
    if n % chains:
        raise ValueError(f"{chains} chains shards do not divide {n} ranks")
    lat = n // chains
    if mesh_shape is None:
        mesh_shape = factor_devices(lat, min(dim, 2))
    mesh_shape = tuple(int(s) for s in mesh_shape)
    names = AXIS_NAMES[-dim:][-len(mesh_shape):] if mesh_shape else ()
    return Mesh({CHAINS: chains, **dict(zip(names, mesh_shape))}, device=device)


def single_mesh(dim: int, device=None) -> Mesh:
    """A mesh of this process alone over ``dim`` lattice axes of size 1."""
    return Mesh({CHAINS: 1, **{a: 1 for a in AXIS_NAMES[-dim:]}}, device=device, solo=True)


def chains_mesh(device=None) -> Mesh:
    """A 1d mesh of the whole world over the chains (data-parallel) axis."""
    return Mesh({CHAINS: world_size()}, device=device)


# -------------------------------------------------------- global <-> blocks
def _block_slices(mesh: Mesh, grid_shape: Sequence[int]):
    """Per lattice axis of ``mesh`` the slice of this rank's block of a grid
    whose trailing ``len(mesh.lattice_axes)`` extents are ``grid_shape``'s."""
    axes = mesh.lattice_axes
    extents = tuple(grid_shape)[len(grid_shape) - len(axes):]
    out = []
    for name, n in zip(axes, extents):
        s = mesh.shape[name]
        if n % s:
            raise ValueError(f"grid extent {n} does not divide {s} shards along '{name}'")
        b = n // s
        out.append(slice(mesh.coords[name] * b, (mesh.coords[name] + 1) * b))
    return out


def scatter_field(x: torch.Tensor, mesh: Mesh, grid_ndim: int, lattice: bool = True,
                  chains: bool = True) -> torch.Tensor:
    """This rank's block of a global field ``x`` of shape ``(*batch, *grid)``
    (``grid_ndim`` trailing grid axes): the first batch axis cut over the
    chains axis where ``chains`` and ``x`` has one, the trailing grid axes
    over the lattice axes where ``lattice``.  A chain count or grid extent
    that the mesh does not divide raises ``ValueError``.  Returns a contiguous
    copy on the mesh's device."""
    idx = [slice(None)] * x.ndim
    nbatch = x.ndim - grid_ndim
    if chains and nbatch > 0:
        s = mesh.chains_size
        if x.shape[0] % s:
            raise ValueError(f"{x.shape[0]} chains do not divide {s} chains shards")
        b = x.shape[0] // s
        idx[0] = slice(mesh.chains_index * b, (mesh.chains_index + 1) * b)
    if lattice and mesh.lattice_axes:
        sl = _block_slices(mesh, x.shape[nbatch:])
        idx[x.ndim - len(sl):] = sl
    return x[tuple(idx)].to(mesh.device).contiguous()


def _all_gather_cat(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The blocks of the ``n`` ranks of ``group`` (in group-rank order)
    concatenated along ``dim``; a list all-gather, which NCCL and gloo both
    take."""
    if group is None or n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_field(x: torch.Tensor, mesh: Mesh, grid_ndim: int, lattice: bool = True,
                 chains: bool = True) -> torch.Tensor:
    """The inverse of :func:`scatter_field`: the global field, on every rank
    (an all-gather along each lattice axis, then along the chains axis)."""
    if lattice:
        axes = mesh.lattice_axes
        for d, name in enumerate(axes):
            ax = x.ndim - len(axes) + d
            x = _all_gather_cat(x, mesh.groups[name], mesh.shape[name], ax)
    if chains and x.ndim > grid_ndim:
        x = _all_gather_cat(x, mesh.groups[CHAINS], mesh.chains_size, 0)
    return x


# ------------------------------------------------------------ noise per rank
_MASK64 = (1 << 64) - 1
#: added to an index before it is scrambled, so that index 0 is no fixed point
FOLD_TAG = 0x632BE59BD9B4E019


def _splitmix64(z: int) -> int:
    """The splitmix64 finaliser: a bijection of 64-bit integers that mixes
    every input bit into every output bit."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_seed(seed: int, *indices: int) -> int:
    """The seed of a stream derived from ``seed`` and the ``indices`` (a
    rank, a stream's tag), the counterpart of ``jax.random.fold_in``:
    ``s <- splitmix64(s ^ splitmix64(i + FOLD_TAG))`` for each index in turn.
    Two (seed, index) pairs meet only where ``s ^ s'`` equals the difference
    of two scrambled indices, a pseudo-random 64-bit number: unlike ``seed +
    rank``, whose rank 1 is the next seed's rank 0, or a symmetric mix, which
    swaps seed and rank, small seeds and ranks never collide."""
    s = int(seed) & _MASK64
    for i in indices:
        s = _splitmix64(s ^ _splitmix64((int(i) + FOLD_TAG) & _MASK64))
    return s
