"""The full Multigrid Monte Carlo cycle over a lattice-decomposed mesh of ranks.

Counterpart of ``multigridmc_tpu/parallel/cycle.py``: the entire MGMC step -
stochastic pre/post sweeps with per-rank noise, the low-rank ``B^T x``
all-reduce, residual and restriction, prolongation, and the agglomerated
coarse-level sample - runs on every rank of a ``chains x lattice`` mesh
(:class:`~multigridmc_tpu_torch.parallel.mesh.Mesh`), each rank holding one
block of every sharded level, with the halos exchanged explicitly
(:func:`~multigridmc_tpu_torch.parallel.halo.halo_exchange`).

The recursion is that of the single-device sampler: below an agglomeration
threshold the (small) coarse fields are gathered to every rank of the lattice
group, and all of them run the identical replicated coarse computation - the
structured-grid analogue of handing the coarsest operator to one Cholesky
factorisation.

Padded layout
-------------
Interior-vertex grids have odd extents (``n_cells - 1`` per dim), which do not
divide a mesh.  Every level-``l`` field is stored on a ``n_cells(l)``-per-dim
*padded* grid: the last entry per dim is padding, kept exactly zero (the
homogeneous-Dirichlet ghost) by per-level validity masks folded into the colour
masks and noise scales.  Padded fine extents are exactly twice the padded coarse
extents, so the fine-vertex correspondence ``fine = 2 coarse + 1`` makes
restriction and prolongation local up to width-1 halos.

Why the fused level-visit kernels do not run on lattice-sharded levels
----------------------------------------------------------------------
The single-device engine fuses noise, colour sweep, Woodbury correction,
residual and restriction into one kernel launch.  Under lattice sharding that
fusion is blocked by the algorithm: the Woodbury correction needs ``B^T x``
reduced over the *global* lattice between the sweep and the residual, and each
colour phase needs its neighbours' values from the previous phase, a fresh
halo between phases.  So the sharded levels run plain PyTorch here, as the JAX
package runs them outside Pallas, with the exchanges and the reduction at
their algebraically required places.  Chains-only meshes run the complete
single-device engine per rank instead
(:class:`~multigridmc_tpu_torch.parallel.data_parallel.DataParallelMGMCSampler`).
The replicated distilled subtree below the agglomeration level is built by
:func:`~multigridmc_tpu_torch.samplers.distill.distill_subtree`, whose set-up
runs the sweep kernels on a CUDA device.

Noise
-----
``apply(noise, f, x)`` takes a
:class:`~multigridmc_tpu_torch.samplers.base.GeneratorNoise` built from the
same seed on every rank (``None`` when ``deterministic``).

* ``"sharded"`` (production): the sharded levels draw this rank's block from
  a stream of its own, the seed folded with the rank (its linear index over
  ``chains x lattice``, :func:`~multigridmc_tpu_torch.parallel.mesh.fold_seed`);
  the replicated levels, the distilled map and the low-rank draws fold only
  the chains index, so every lattice shard of one chains index draws the
  same numbers there and the replicated coarse levels agree between shards.
* ``"global"`` (validation): every rank draws the whole global field from the
  given generator, in the same order of calls, and slices its block - the same
  trajectory on every mesh shape, used to hold a mesh against a world of one.

In ``"sharded"`` mode the rank's two streams are kept on the shared source
(``GeneratorNoise.stream``), so that a checkpoint of the rank
(:class:`~multigridmc_tpu_torch.utils.checkpoint.ChainState`: its block of
``x`` and the shared source) saves them, and a run loaded from it draws on from
where the saved one stopped; ``"global"`` noise resumes through the shared
source itself.

A sweep's low-rank noise enters its Woodbury correction (``x -= B_bar (B^T x -
Sigma^{1/2} n)``), as in the single-device port; it gives the same ``x'`` as
the JAX package's ``B Sigma^{-1/2} n`` in the right-hand side.
"""

from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.coloring import coloring_for
from ..ops.stencil import StencilOperator
from ..samplers.base import GeneratorNoise
from ..samplers.cholesky import DenseCholeskySampler
from ..samplers.distill import distill_subtree, pick_distill_level
from ..samplers.sor import SORSampler, SSORSampler
from ..smoothers import BACKWARD, FORWARD, color_order, compute_B_bar
from ..solvers.multigrid import MultigridHierarchy
from .halo import halo_exchange, local_apply, stencil_reach
from .mesh import Mesh, fold_seed, gather_field, scatter_field

#: the tags of the two per-rank streams of ``"sharded"`` noise
LATTICE_STREAM = 0
CHAINS_STREAM = 1


# --------------------------------------------------------------------- padding
def padded_extents(vshape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Vertex grid (n-1 per dim) -> padded grid (n per dim)."""
    return tuple(m + 1 for m in vshape)


def pad_field(x: torch.Tensor, vshape: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad a vertex field (trailing ``len(vshape)`` axes) by one per dim."""
    return F.pad(x, (0, 1) * len(vshape))


def unpad_field(x: torch.Tensor, vshape: Tuple[int, ...]) -> torch.Tensor:
    return x[(Ellipsis,) + tuple(slice(0, m) for m in vshape)]


def _valid_mask(pn: Tuple[int, ...]) -> np.ndarray:
    m = np.ones(pn)
    for d in range(len(pn)):
        idx = [slice(None)] * len(pn)
        idx[d] = pn[d] - 1
        m[tuple(idx)] = 0.0
    return m


def _np64(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64) if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float64)


def _pad_coeffs(op: StencilOperator, pn: Tuple[int, ...]) -> np.ndarray:
    """Padded stencil coefficients: valid coefficients masked so that no entry
    reads a padding vertex (making the padded dense matrix blockdiag(Q, I)),
    diagonal = 1 on padding."""
    nk = len(op.offsets)
    out = np.zeros((nk,) + pn)
    valid = _valid_mask(pn)
    coeffs = _np64(op.normalized().coeffs)
    core = tuple(slice(0, m) for m in op.vshape)
    for k, off in enumerate(op.offsets):
        plane = np.zeros(pn)
        plane[core] = coeffs[k]
        # zero entries whose target i+off is a padding vertex
        tgt_valid = np.ones(pn)
        for d, o in enumerate(off):
            idx_d = np.arange(pn[d]) + o
            v = (idx_d >= 0) & (idx_d <= pn[d] - 2)  # pn[d]-1 is padding
            shp = [1] * len(pn)
            shp[d] = pn[d]
            tgt_valid = tgt_valid * v.reshape(shp)
        out[k] = plane * tgt_valid * valid
    out[op.diag_index] += 1.0 - valid  # unit diagonal on padding
    return out


def _dense_from_padded(coeffs: np.ndarray, offsets, pn) -> np.ndarray:
    """Dense matrix of a padded stencil (lexicographic padded order)."""
    n = int(np.prod(pn))
    A = np.zeros((n, n))
    idx = np.arange(n).reshape(pn)
    for k, off in enumerate(offsets):
        src_sl, tgt_sl = [], []
        for o, m in zip(off, pn):
            if o >= 0:
                src_sl.append(slice(0, m - o))
                tgt_sl.append(slice(o, m))
            else:
                src_sl.append(slice(-o, m))
                tgt_sl.append(slice(0, m + o))
        rows = idx[tuple(src_sl)].ravel()
        cols = idx[tuple(tgt_sl)].ravel()
        A[rows, cols] += coeffs[k][tuple(src_sl)].ravel()
    return A


# ---------------------------------------------------------------- level params
#: arrays with a leading non-grid axis (offsets, colours, measurements)
_STACKED = ("coeffs", "wmask", "B", "B_bar_fwd", "B_bar_bwd")
#: grid fields
_FIELDS = ("diag", "valid", "noise_scale")


@dataclasses.dataclass
class _Level:
    """Per-level padded arrays (this rank's block where sharded) and static
    metadata."""

    offsets: Tuple[Tuple[int, ...], ...]
    n_colors: int
    pad: int  # halo width = max |offset|
    sharded: bool
    pn: Tuple[int, ...]  # padded global extents
    arrays: dict  # name -> tensor on the mesh's device
    has_lowrank: bool


def _level_arrays(op: StencilOperator, omega: float) -> Tuple[dict, int]:
    """The padded global float64 arrays of one level, and its colour count."""
    pn = padded_extents(op.vshape)
    coloring = coloring_for(op.offsets, op.vshape)
    valid = _valid_mask(pn)
    # colour field over *global padded* indices with the same linear-mod
    # weights as the unsharded colouring (padding sits at the end, so valid
    # vertices keep their colours); folded with validity so padded entries are
    # never updated
    grids = np.meshgrid(*[np.arange(m) for m in pn], indexing="ij")
    cfield = np.zeros(pn, dtype=np.int64)
    for g, w in zip(grids, coloring.weights):
        cfield += w * g
    cfield %= coloring.n_colors
    masks = np.stack([(cfield == c) * valid for c in range(coloring.n_colors)])
    coeffs = _pad_coeffs(op, pn)
    diag = coeffs[op.diag_index]
    arrays = {
        "coeffs": coeffs,
        "diag": diag,
        # a colour's update x += omega mask_c (b - A x) / diag as one product
        "wmask": omega * masks / diag,
        "valid": valid,
        # sqrt(D (2-omega)/omega) on valid vertices, 0 on padding
        "noise_scale": np.sqrt(np.maximum(diag * (2.0 - omega) / omega, 0.0)) * valid,
    }
    if op.lowrank is not None:
        m = op.m_lowrank
        core = (slice(None),) + tuple(slice(0, s) for s in op.vshape)
        B = np.zeros((m,) + pn)
        B[core] = _np64(op.lowrank.B)
        arrays["B"] = B
        Sigma = _np64(op.lowrank.Sigma_diag)
        arrays["Sigma_inv"] = 1.0 / Sigma
        arrays["Sigma_sqrt"] = np.sqrt(Sigma)
        # Woodbury correction factors for both sweep directions, computed on
        # the unpadded operator and zero-padded (corrections never touch
        # padding)
        unp_masks = torch.as_tensor(coloring.masks(), dtype=op.dtype, device=op.device)
        for name, direction in (("B_bar_fwd", FORWARD), ("B_bar_bwd", BACKWARD)):
            bb = compute_B_bar(op, unp_masks, omega, color_order(coloring.n_colors, direction))
            pb = np.zeros((m,) + pn)
            pb[core] = _np64(bb)
            arrays[name] = pb
    return arrays, coloring.n_colors


class ShardedMGMCSampler:
    """Multigrid Monte Carlo sampler whose levels are cut over a lattice mesh.

    Counterpart of the JAX package's ``ShardedMGMCSampler``, on padded local
    blocks: ``apply(noise, f, x)`` takes this rank's blocks of the padded
    fields (:meth:`scatter` cuts them from global padded fields,
    :meth:`gather` puts them back; :func:`pad_field` / :func:`unpad_field`
    convert to and from vertex fields) and returns this rank's block of the
    next chain state.  ``x`` is ``(*batch, *padded block)``; a chains axis of
    the mesh cuts the first batch axis.  ``f`` is this rank's block of the
    padded rhs, unbatched or batched like ``x``.

    Parameters mirror ``MultigridParameters``; ``agglomerate_below`` is the
    per-dim local-block extent under which a level is replicated on every
    rank of the lattice group instead of sharded.  ``distill``: the replicated
    subtree below the agglomeration level becomes the distilled map ``x = T f
    + S xi`` in ``"sharded"`` mode (``True`` on any device, ``"auto"`` on a
    CUDA device, ``False`` never); ``T`` and ``S`` are built on every rank and
    rank 0's are broadcast, and :attr:`distill_spread` holds how far the
    ranks' own builds were from them.
    """

    def __init__(
        self,
        op: StencilOperator,
        nlevel: int,
        mesh: Mesh,
        *,
        smoother: str = "SOR",
        coarse_solver: str = "Cholesky",
        npresmooth: int = 1,
        npostsmooth: int = 1,
        ncoarsesmooth: int = 1,
        omega: float = 1.0,
        cycle: int = 1,
        coarse_scaling: float = 1.0,
        agglomerate_below: int = 8,
        noise_mode: str = "sharded",
        deterministic: bool = False,
        hierarchy: Optional[MultigridHierarchy] = None,
        distill: object = "auto",
    ):
        if smoother.upper() not in ("SOR", "SSOR"):
            raise ValueError(f"invalid smoother '{smoother}'")
        if noise_mode not in ("sharded", "global"):
            raise ValueError(f"invalid noise_mode '{noise_mode}' ('sharded' or 'global')")
        self.mesh = mesh
        self.op = op = op.to(mesh.device)
        self.smoother = smoother.upper()
        self.coarse_solver = coarse_solver.lower()
        if self.coarse_solver not in ("cholesky", "ssor"):
            raise ValueError(f"invalid coarse sampler '{coarse_solver}'")
        self.npresmooth = int(npresmooth)
        self.npostsmooth = int(npostsmooth)
        self.ncoarsesmooth = int(ncoarsesmooth)
        self.omega = float(omega)
        self.cycle = int(cycle)
        self.coarse_scaling = float(coarse_scaling)
        self.noise_mode = noise_mode
        self.deterministic = bool(deterministic)
        self.dtype = op.dtype
        self.dim = len(op.vshape)
        if len(mesh.lattice_axes) != self.dim:
            raise ValueError(f"mesh lattice axes {mesh.lattice_axes} do not match lattice "
                             f"dim {self.dim}")

        hierarchy = hierarchy or MultigridHierarchy(op, nlevel)
        self.hierarchy = hierarchy
        self.nlevel = hierarchy.nlevel
        S = mesh.lattice_shape
        flags = [all(p % s == 0 and p // s >= agglomerate_below
                     for p, s in zip(padded_extents(lop.vshape), S))
                 for lop in hierarchy.operators]
        # the dense-Cholesky coarse sample is replicated by construction; levels
        # go sharded -> replicated once (prolongation assumes the finer level
        # of a transition is the sharded one)
        if self.coarse_solver == "cholesky":
            flags[-1] = False
        for i in range(1, len(flags)):
            flags[i] = flags[i] and flags[i - 1]
        if not flags[0]:
            warnings.warn(
                f"finest level {hierarchy.operators[0].vshape} is not shardable over "
                f"lattice mesh {list(S)} with agglomerate_below={agglomerate_below}: the "
                f"cycle will run fully REPLICATED over the lattice axes (correct, but each "
                f"rank repeats the full lattice work); lower agglomerate_below, shrink the "
                f"lattice mesh, or use the chains-data-parallel sampler", stacklevel=2)
        self.levels: List[_Level] = []
        for lop, flag in zip(hierarchy.operators, flags):
            arrays, n_colors = _level_arrays(lop, self.omega)
            if self.coarse_solver == "cholesky" and lop is hierarchy.operators[-1]:
                # blockdiag(Q_valid, I) by construction of _pad_coeffs
                pn = padded_extents(lop.vshape)
                Q = _dense_from_padded(arrays["coeffs"], lop.offsets, pn)
                if "B" in arrays:
                    Bp = arrays["B"].reshape(lop.m_lowrank, -1)
                    Q = Q + Bp.T @ np.diag(arrays["Sigma_inv"]) @ Bp
                arrays["chol_L"] = np.linalg.cholesky(Q)
            self.levels.append(_Level(
                offsets=lop.offsets, n_colors=n_colors, pad=stencil_reach(lop.offsets),
                sharded=flag, pn=padded_extents(lop.vshape),
                arrays=self._to_rank(arrays, flag), has_lowrank=lop.lowrank is not None))

        self.distilled = None
        self.distill_level: Optional[int] = None
        self.distill_spread: Optional[float] = None
        self._build_distilled(flags, distill)
        self._streams = weakref.WeakKeyDictionary()

    def _to_rank(self, arrays: dict, sharded: bool) -> dict:
        """The level's arrays on this rank's device in the sampler's dtype,
        cut to this rank's block where the level is sharded."""
        out = {}
        for name, a in arrays.items():
            t = torch.as_tensor(a, dtype=self.dtype)
            if sharded and name in _STACKED + _FIELDS:
                out[name] = scatter_field(t, self.mesh, self.dim, chains=False)
            else:
                out[name] = t.to(self.mesh.device)
        return out

    # ----------------------------------------------------------- distillation
    def _build_distilled(self, flags, distill) -> None:
        """Distil the *replicated* coarse subtree: below the agglomeration
        threshold every rank runs the identical replicated recursion, which is
        exactly the single-device affine-Gaussian subtree - so it is swapped
        for the replicated ``x = T f + S xi`` map.  Only in ``"sharded"``
        mode: the map draws its noise differently from the composed recursion,
        and ``"global"`` mode's trajectory must not depend on the mesh
        shape."""
        if self.deterministic or self.coarse_solver != "cholesky":
            return
        if self.noise_mode != "sharded":
            return
        if distill is False or distill is None:
            return
        if distill is not True and distill != "auto":
            raise ValueError(f"invalid distill '{distill}' (False, True or 'auto')")
        if distill == "auto" and self.mesh.device.type != "cuda":
            return
        ops = self.hierarchy.operators
        li = pick_distill_level(ops)
        if li is None:
            return
        # the map executes replicated: advance to the first replicated level
        while li < self.nlevel - 1 and flags[li]:
            li += 1
        if li >= self.nlevel - 1:
            return  # only the coarsest qualifies: a matmul replaces a matmul
        pres, posts = [], []
        for lop in ops[li:]:
            if self.smoother == "SOR":
                pres.append(SORSampler(lop, self.omega, self.npresmooth, FORWARD))
                posts.append(SORSampler(lop, self.omega, self.npostsmooth, BACKWARD))
            else:
                pres.append(SSORSampler(lop, self.omega, self.npresmooth))
                posts.append(SSORSampler(lop, self.omega, self.npostsmooth))
        d = distill_subtree(ops[li:], pres, posts, DenseCholeskySampler(ops[-1]),
                            self.cycle, self.coarse_scaling, noise=True)
        # every rank built its own map; rank 0's is the one all of them use
        spread = 0.0
        if dist.is_initialized() and self.mesh.size > 1:
            for t in (d.Tm, d.S_T):
                mine = t.clone()
                dist.broadcast(t, src=0)
                spread = max(spread, float((mine - t).abs().max()))
        self.distilled = d
        self.distill_level = li
        self.distill_spread = spread

    def _distilled_apply(self, fc: torch.Tensor, streams) -> torch.Tensor:
        """One replicated subtree invocation ``x = T f + S xi`` on the padded
        layout, its normals from the replicated stream."""
        d = self.distilled
        fc_u = unpad_field(fc, d.vshape)
        batch = fc_u.shape[: fc_u.ndim - self.dim]
        fl = fc_u.reshape(batch + (d.n,))
        x = torch.matmul(fl, d.Tm)
        xi = self._replicated_noise(streams, batch + (d.n,), fc)
        x = x + torch.matmul(xi, d.S_T)
        return pad_field(x.reshape(batch + d.vshape), d.vshape)

    # ---------------------------------------------------------------- layout
    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global padded field (``(*batch, *pn)`` or an
        unbatched rhs), cut as level 0 is: over the lattice axes where level 0
        is sharded, the first batch axis over the chains axis."""
        return scatter_field(x, self.mesh, self.dim, lattice=self.levels[0].sharded)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global padded field from this rank's block (on every rank)."""
        return gather_field(x, self.mesh, self.dim, lattice=self.levels[0].sharded)

    # ----------------------------------------------------------------- noise
    def _rank_streams(self, noise) -> dict:
        """The noise sources of one ``apply``: in ``"global"`` mode ``noise``
        itself; in ``"sharded"`` mode this rank's lattice-block stream and its
        chains index's replicated stream, derived from ``noise``'s seed once
        and kept on ``noise`` (``GeneratorNoise.stream``: a loaded checkpoint's
        source carries the saved ones), so that they run on from call to call
        as ``noise`` itself would."""
        if self.deterministic:
            return {}
        if not isinstance(noise, GeneratorNoise):
            raise TypeError("ShardedMGMCSampler draws from a GeneratorNoise (the same seed "
                            f"on every rank), not {type(noise).__name__}")
        if self.noise_mode == "global":
            return {"global": noise}
        streams = self._streams.get(noise)
        if streams is None:
            seeds = {"lattice": fold_seed(noise.seed, LATTICE_STREAM, self.mesh.rank),
                     "chains": fold_seed(noise.seed, CHAINS_STREAM, self.mesh.chains_index)}
            streams = self._streams[noise] = {
                name: noise.stream(name, seed, self.mesh.device) for name, seed in seeds.items()}
        return streams

    def _chains_total(self, batch) -> Tuple[int, ...]:
        """The global batch shape of a local batch (the chains axis cuts the
        first batch axis)."""
        if not batch:
            return batch
        return (batch[0] * self.mesh.chains_size,) + tuple(batch[1:])

    def _global_slice(self, xi: torch.Tensor, nbatch: int, lattice: bool) -> torch.Tensor:
        """This rank's part of a globally drawn ``xi``."""
        return scatter_field(xi, self.mesh, xi.ndim - nbatch, lattice=lattice)

    def _field_noise(self, streams, lv: _Level, x: torch.Tensor) -> torch.Tensor:
        """A sweep's Gaussian field of ``x``'s (local) shape."""
        batch = tuple(x.shape[: x.ndim - self.dim])
        if self.noise_mode == "global":
            xi = streams["global"].normal(self._chains_total(batch) + lv.pn, x.dtype, x.device)
            return self._global_slice(xi, len(batch), lv.sharded)
        stream = streams["lattice"] if lv.sharded else streams["chains"]
        return stream.normal(x.shape, x.dtype, x.device)

    def _replicated_noise(self, streams, shape, like: torch.Tensor) -> torch.Tensor:
        """Normals of ``shape`` = ``(*batch, k)`` that every lattice shard of
        one chains index draws identically (the low-rank draws, the distilled
        map's)."""
        batch = tuple(shape[:-1])
        if self.noise_mode == "global":
            xi = streams["global"].normal(self._chains_total(batch) + tuple(shape[-1:]),
                                          like.dtype, like.device)
            return self._global_slice(xi, len(batch), False)
        return streams["chains"].normal(tuple(shape), like.dtype, like.device)

    # ------------------------------------------------------------ the level
    def _apply_stencil(self, lv: _Level, x: torch.Tensor) -> torch.Tensor:
        p = lv.arrays
        if lv.sharded:
            xp = halo_exchange(x, lv.pad, self.mesh)
            return local_apply(p["coeffs"], xp, lv.offsets, lv.pad, self.dim)
        return local_apply(p["coeffs"], F.pad(x, (lv.pad, lv.pad) * self.dim), lv.offsets,
                           lv.pad, self.dim)

    def _bt_allreduce(self, lv: _Level, x: torch.Tensor) -> torch.Tensor:
        """``B^T x`` (``(*batch, m)``), all-reduced over the lattice group
        where the level is sharded."""
        B = lv.arrays["B"]
        m = B.shape[0]
        batch = x.shape[: x.ndim - self.dim]
        bt = x.reshape(batch + (-1,)) @ B.reshape(m, -1).T
        if lv.sharded and self.mesh.lattice_group is not None:
            bt = bt.contiguous()
            dist.all_reduce(bt, group=self.mesh.lattice_group)
        return bt

    def _expand(self, w: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
        """``sum_k w[..., k] fields[k]``."""
        m = fields.shape[0]
        return (w @ fields.reshape(m, -1)).reshape(w.shape[:-1] + fields.shape[1:])

    def _sweep(self, lv: _Level, order, b, x, lr_shift=None):
        """One multi-colour SOR sweep and its Woodbury correction (the
        splitting of :func:`~multigridmc_tpu_torch.smoothers.sor_sweep` under
        explicit halos); ``lr_shift`` is the Gibbs sweep's ``Sigma^{1/2} n``."""
        p = lv.arrays
        for c in order:
            x = torch.addcmul(x, p["wmask"][c], b - self._apply_stencil(lv, x))
        if lv.has_lowrank:
            bb = p["B_bar_fwd"] if order[0] == 0 else p["B_bar_bwd"]
            bt = self._bt_allreduce(lv, x)
            if lr_shift is not None:
                bt = bt - lr_shift
            x = x - self._expand(bt, bb)
        return x

    def _gibbs_sweeps(self, lv: _Level, streams, f, x, direction, nsmooth):
        orders = ([color_order(lv.n_colors, direction)] if self.smoother == "SOR"
                  else [color_order(lv.n_colors, FORWARD), color_order(lv.n_colors, BACKWARD)])
        p = lv.arrays
        batch = tuple(x.shape[: x.ndim - self.dim])
        for _ in range(nsmooth):
            for order in orders:
                c, lr_shift = f, None
                if not self.deterministic:  # the field, then the low-rank scalars
                    c = f + p["noise_scale"] * self._field_noise(streams, lv, x)
                    if lv.has_lowrank:
                        n = self._replicated_noise(streams, batch + (p["B"].shape[0],), x)
                        lr_shift = n * p["Sigma_sqrt"]
                x = self._sweep(lv, order, c, x, lr_shift)
        return x

    # ------------------------------------------------------------ intergrid
    def _restrict(self, fine: _Level, coarse: _Level, r: torch.Tensor) -> torch.Tensor:
        """Full-weighting restriction on the padded layout: coarse c <- fine
        2c+1, local up to a width-1 halo; gathered to every rank of the
        lattice group where the coarse level is replicated."""
        dim = self.dim
        if fine.sharded:
            rp = halo_exchange(r, 1, self.mesh)
        else:
            rp = F.pad(r, (1, 1) * dim)
        # per axis: out[..., c, ...] = 0.5 rp[2c+1] + rp[2c+2] + 0.5 rp[2c+3]
        # (rp index = fine local index + 1)
        out = rp
        for d in range(dim):
            ax = out.ndim - dim + d
            bc = (out.shape[ax] - 2) // 2
            sl = lambda start: out.narrow(ax, start, 2 * bc - 1)[  # noqa: E731
                (slice(None),) * ax + (slice(None, None, 2),)]
            out = 0.5 * sl(1) + sl(2) + 0.5 * sl(3)
        if fine.sharded and not coarse.sharded:
            # agglomerate: gather the (small) coarse field to every rank
            out = gather_field(out, self.mesh, dim, chains=False)
        # zero the padding vertices (their gathered values are not a restriction)
        return out * coarse.arrays["valid"]

    def _prolongate_add(self, fine: _Level, coarse: _Level, xc: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
        """``x += coarse_scaling * P xc`` on the padded layout."""
        dim = self.dim
        if fine.sharded and not coarse.sharded:
            # this rank's coarse block (+1 halo) out of the replicated field;
            # pad first so boundary ranks read zero ghosts
            xcp = F.pad(xc, (1, 1) * dim)
            for a, pdim in zip(self.mesh.lattice_axes, coarse.pn):
                ax = xcp.ndim - dim + self.mesh.lattice_axes.index(a)
                b = pdim // self.mesh.shape[a]
                xcp = xcp.narrow(ax, self.mesh.coords[a] * b, b + 2)
        elif fine.sharded:
            xcp = halo_exchange(xc, 1, self.mesh)
        else:
            xcp = F.pad(xc, (1, 1) * dim)
        # per axis bc -> 2 bc: fine odd 2k+1 <- coarse k = xcp[k+1];
        # fine even 2k <- 0.5 (coarse k-1 + coarse k) = 0.5 (xcp[k] + xcp[k+1])
        out = xcp
        for d in range(dim):
            ax = out.ndim - dim + d
            bc = out.shape[ax] - 2
            odd = out.narrow(ax, 1, bc)
            even = 0.5 * (out.narrow(ax, 0, bc) + odd)
            stacked = torch.stack([even, odd], dim=ax + 1)
            shape = list(stacked.shape)
            shape[ax] = 2 * bc
            del shape[ax + 1]
            out = stacked.reshape(shape)
        return x + self.coarse_scaling * out

    # ------------------------------------------------------------ coarse level
    def _coarse_apply(self, lv: _Level, streams, f, x):
        if self.coarse_solver == "ssor":
            return self._gibbs_sweeps(lv, streams, f, x, FORWARD, self.ncoarsesmooth)
        L = lv.arrays["chol_L"]
        n = L.shape[0]
        batch = tuple(f.shape[: f.ndim - self.dim])
        fv = f.reshape((-1, n)).T  # (n, nbatch)
        g = torch.linalg.solve_triangular(L, fv, upper=False)
        if self.deterministic:
            rhs = g
        else:
            xi = self._field_noise(streams, lv, f)
            rhs = xi.reshape((-1, n)).T + g
        y = torch.linalg.solve_triangular(L.T, rhs, upper=True)
        y = y.T.reshape(batch + lv.pn)
        return y * lv.arrays["valid"]

    # ----------------------------------------------------------------- cycle
    def _sample(self, level: int, streams, f, x, record):
        lv = self.levels[level]
        if level == self.nlevel - 1:
            return self._coarse_apply(lv, streams, f, x)
        nxt = self.levels[level + 1]
        p = lv.arrays
        ncycle = self.cycle if level > 0 else 1
        for _ in range(ncycle):
            x = self._gibbs_sweeps(lv, streams, f, x, FORWARD, self.npresmooth)
            r = f - self._apply_stencil(lv, x)
            if lv.has_lowrank:
                bt = self._bt_allreduce(lv, x) * p["Sigma_inv"]
                r = r - self._expand(bt, p["B"])
            f_c = self._restrict(lv, nxt, r)
            if self.distilled is not None and level + 1 == self.distill_level:
                x_c = self._distilled_apply(f_c, streams)
            else:
                x_c = self._sample(level + 1, streams, f_c, torch.zeros_like(f_c), record)
            if record is not None and lv.sharded and not nxt.sharded:
                record.append(x_c.clone())
            x = self._prolongate_add(lv, nxt, x_c, x)
            x = self._gibbs_sweeps(lv, streams, f, x, BACKWARD, self.npostsmooth)
        return x

    def apply(self, noise, f: torch.Tensor, x: torch.Tensor,
              record: Optional[list] = None) -> torch.Tensor:
        """One MGMC step on this rank's padded blocks (the chain state ``x``
        is carried, not zeroed).  ``record``, a list, receives the replicated
        coarse field of every visit of the first replicated level (what every
        rank of a lattice group must hold identically)."""
        return self._sample(0, self._rank_streams(noise), f, x, record)
