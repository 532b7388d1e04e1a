"""Explicit halo exchange between the ranks of a lattice mesh.

Counterpart of ``multigridmc_tpu/parallel/halo.py``.  The JAX package shifts
slices between neighbouring shards with ``jax.lax.ppermute`` inside
``shard_map``; here each rank sends its boundary slices to its neighbours and
receives theirs with point-to-point operations:

* :func:`halo_exchange` - pad this rank's block with width-``pad`` halos from
  its mesh neighbours.  A rank on the domain boundary receives zeros there,
  which is exactly the homogeneous Dirichlet ghost of the interior-vertex
  fields.  The axes are exchanged one after another, each on the block already
  padded along the earlier axes, so the corner values arrive too (the 3x3 box
  and the 13-point stencil read them).  The two neighbours' sends and receives
  along one axis go out as one ``torch.distributed.batch_isend_irecv``, so
  NCCL cannot deadlock on their order.
* :func:`sharded_sor_sweep` - the multi-colour SOR sweep of
  :func:`multigridmc_tpu_torch.smoothers.sor_sweep` on the blocks of a lattice
  mesh, a fresh halo before every colour: algebraically the global
  colour-ordered sweep, including the couplings across block boundaries.

Block extents must divide the mesh (e.g. 65 cells -> 64 interior vertices over
4 ranks); :mod:`multigridmc_tpu_torch.parallel.cycle` pads odd vertex grids to
make them so.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.coloring import Coloring
from ..ops.stencil import StencilOperator
from .mesh import Mesh, scatter_field


def halo_exchange(x: torch.Tensor, pad: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block ``x`` padded with width-``pad`` halos from its
    neighbours along every lattice axis of ``mesh``.  The last
    ``len(mesh.lattice_axes)`` axes of ``x`` are the sharded grid axes
    (slowest first); leading axes ride along.  Boundary ranks receive zeros."""
    axes = mesh.lattice_axes
    offset = x.ndim - len(axes)
    for d, name in enumerate(axes):
        ax = offset + d
        n_ax = x.shape[ax]
        if pad > n_ax:
            raise ValueError(f"halo of {pad} wider than the block's {n_ax} along '{name}'")
        # zero halos on both sides (F.pad lists the last axis first), then
        # the neighbours' rows over them
        pads = [0, 0] * (x.ndim - 1 - ax) + [pad, pad]
        xp = F.pad(x, pads)
        ranks, i = mesh.axis_ranks[name], mesh.coords[name]
        ops, fills = [], []
        for peer, send_at, recv_at in ((i - 1, 0, 0), (i + 1, n_ax - pad, n_ax + pad)):
            if 0 <= peer < len(ranks):
                send = x.narrow(ax, send_at, pad).contiguous()
                recv = torch.empty_like(send)
                ops += [dist.P2POp(dist.isend, send, ranks[peer]),
                        dist.P2POp(dist.irecv, recv, ranks[peer])]
                fills.append((recv_at, recv))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for at, recv in fills:
                xp.narrow(ax, at, pad).copy_(recv)
        x = xp
    return x


def local_apply(coeffs: torch.Tensor, xp: torch.Tensor, offsets, pad: int,
                grid_ndim: int) -> torch.Tensor:
    """Stencil apply on a halo-padded block: ``sum_k coeffs[k] * x[i + off_k]``
    over the block's core (``xp`` without its width-``pad`` halo)."""
    core = xp.shape[xp.ndim - grid_ndim:]
    out = None
    for k, off in enumerate(offsets):
        idx = (Ellipsis,) + tuple(slice(pad + o, pad + o + (n - 2 * pad))
                                  for o, n in zip(off, core))
        if out is None:
            out = coeffs[k] * xp[idx]
        else:
            out.addcmul_(coeffs[k], xp[idx])
    return out


def stencil_reach(offsets) -> int:
    """The halo width a stencil needs: its largest ``|offset|``."""
    return max(max(abs(o) for o in off) for off in offsets)


def sharded_sor_sweep(op: StencilOperator, coloring: Coloring, omega: float,
                      order: Tuple[int, ...], mesh: Mesh, b: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """One multi-colour SOR sweep on this rank's blocks ``b`` and ``x`` of a
    field sharded over ``mesh``'s lattice axes (counterpart of the JAX
    package's ``shard_map_sor_sweep``): every colour phase takes a fresh halo
    and then updates its block, so it sees the previous colours' values across
    block boundaries too."""
    dim = len(op.vshape)
    pad = stencil_reach(op.offsets)
    block = lambda a: scatter_field(a, mesh, dim, chains=False)  # noqa: E731
    coeffs = block(op.coeffs)
    diag = coeffs[op.diag_index]
    masks = block(torch.as_tensor(coloring.masks(), dtype=op.dtype, device=op.device))
    for c in order:
        xp = halo_exchange(x, pad, mesh)
        ax = local_apply(coeffs, xp, op.offsets, pad, dim)
        x = x + masks[c] * (omega * (b - ax) / diag)
    return x
