# SPDX-License-Identifier: Apache-2.0
"""Batch-sharded PME: the uniform ``[B, n]`` batch pipeline over ranks
(counterpart of ``nvalchemiops_tpu.parallel.batch_pme``).

Per-system PME is independent across the batch, so each rank of the mesh
axis runs :func:`~nvalchemiops_torch.interactions.electrostatics.pme.
batch_pme_reciprocal` (the dense kernels 5 and 6 up to 32^3, the windowed
kernels 3 and 2 above) on its contiguous run of ``B / D`` systems, and the
outputs are all-gathered, so every rank returns the whole batch.
Complements the tile-split domain PME (``domain.domain_pme_reciprocal``),
which splits one large system instead.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.interactions.electrostatics.pme import (
    batch_pme_reciprocal,
)
from nvalchemiops_torch.parallel._dist import (
    all_gather_cat,
    axis_group,
    slab_rows,
)

__all__ = ["sharded_batch_pme_reciprocal"]


def sharded_batch_pme_reciprocal(mesh, positions, charges, cells,
                                 alpha, mesh_dimensions,
                                 spline_order: int = 4,
                                 compute_forces: bool = False,
                                 axis: str = "dp", **kw):
    """Split ``batch_pme_reciprocal`` over the ranks of ``mesh`` axis
    ``axis``.

    ``positions [B, n, 3]``, ``charges [B, n]``; ``cells`` ``[3, 3]``
    shared or ``[B, 3, 3]``; ``alpha`` scalar or ``[B]``; ``kw`` go to
    ``batch_pme_reciprocal``.  B must divide over the axis
    (``ValueError`` otherwise).  Returns per-atom energies ``[B, n]`` (and
    forces ``[B, n, 3]`` with ``compute_forces``), whole on every rank.
    """
    group, size, rank = axis_group(mesh, axis)
    b = positions.shape[0]
    if b % size:
        raise ValueError(
            f"batch size {b} does not divide over mesh axis {axis!r} "
            f"({size} shards)")
    dtype, device = positions.dtype, positions.device
    cells = torch.as_tensor(cells, dtype=dtype, device=device)
    if cells.dim() == 2:
        cells = cells.expand(b, 3, 3)
    alphas = torch.broadcast_to(torch.as_tensor(
        alpha, dtype=dtype, device=device).reshape(-1), (b,))
    charges = torch.as_tensor(charges, dtype=dtype, device=device)
    own = slab_rows(rank, size, b)
    out = batch_pme_reciprocal(
        positions[own], charges[own], cells[own], alphas[own],
        tuple(int(d) for d in mesh_dimensions), spline_order=spline_order,
        compute_forces=compute_forces, **kw)
    if isinstance(out, tuple):
        return tuple(all_gather_cat(o, group) for o in out)
    return all_gather_cat(out, group)
