# SPDX-License-Identifier: Apache-2.0
"""Every ordered atom pair within a cutoff in an orthorhombic periodic box.

A plain cell list: the box is cut into ``nb = floor(L / cutoff)`` cells an
axis (cells at least a cutoff wide), each atom's candidates are the atoms
of the cells within ``m = ceil(cutoff / cell width)`` cells of its own,
with the image shift the offset implies, and a candidate is kept where
``0 < |d| < cutoff``.  Each image of each pair is found once, from both
ends: the pair list is ordered (``(i, j)`` and ``(j, i)`` both appear).
"""

from __future__ import annotations

import itertools
import math

import torch


def box_lengths(cell) -> torch.Tensor:
    """The edge lengths of an orthorhombic ``cell [3, 3]``; raises on a
    cell with off-diagonal entries."""
    cell = torch.as_tensor(cell, dtype=torch.float64).reshape(3, 3)
    if torch.count_nonzero(cell - torch.diag(torch.diagonal(cell))):
        raise ValueError("the reference takes orthorhombic cells only")
    return torch.diagonal(cell).clone()


def ordered_pairs(pos, cell, cutoff: float, chunk_entries: int = 1 << 25):
    """``(i, j, d)``: every ordered pair with ``0 < |d| < cutoff``, where
    ``d = r_j + shift - r_i`` (float64, on ``pos``'s device) and ``i``,
    ``j`` are int64 atom indices.  ``pos [n, 3]``."""
    device = pos.device
    pos = pos.to(torch.float64)
    n = pos.shape[0]
    length = box_lengths(cell).to(device)
    nb = torch.clamp(torch.floor(length / cutoff), min=1).to(torch.int64)
    width = length / nb
    reach = [int(math.ceil(cutoff / float(w))) for w in width]
    p = pos - torch.floor(pos / length) * length          # wrapped into the box
    c = torch.minimum(torch.floor(p / width).to(torch.int64), nb - 1)
    nbx, nby, nbz = (int(v) for v in nb)
    lin = c[:, 0] + nbx * (c[:, 1] + nby * c[:, 2])
    ncells = nbx * nby * nbz
    order = torch.argsort(lin, stable=True)
    counts = torch.bincount(lin, minlength=ncells)
    cap = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=device) - starts[lin[order]]
    table = torch.full((ncells, cap), -1, dtype=torch.int64, device=device)
    table[lin[order], slot] = order

    offsets = torch.tensor(
        list(itertools.product(*(range(-r, r + 1) for r in reach))),
        dtype=torch.int64, device=device)                  # [O, 3] (x, y, z)
    cell_xyz = torch.stack(torch.meshgrid(
        torch.arange(nbx, device=device), torch.arange(nby, device=device),
        torch.arange(nbz, device=device), indexing="ij"), -1)
    cell_xyz = cell_xyz.permute(2, 1, 0, 3).reshape(-1, 3)  # lin order
    raw = cell_xyz[:, None, :] + offsets[None]             # [cells, O, 3]
    shift = torch.div(raw, nb, rounding_mode="floor")
    wrapped = raw - shift * nb
    nbr = wrapped[..., 0] + nbx * (wrapped[..., 1] + nby * wrapped[..., 2])
    n_off = offsets.shape[0]

    per_atom = n_off * cap
    step = max(1, chunk_entries // per_atom)
    out_i, out_j, out_d = [], [], []
    cut2 = float(cutoff) ** 2
    for a0 in range(0, n, step):
        own = torch.arange(a0, min(n, a0 + step), device=device)
        oc = lin[own]
        cand = table[nbr[oc]].reshape(len(own), per_atom)  # [A, O*cap]
        sh = (shift[oc].to(torch.float64) * length)        # [A, O, 3]
        sh = sh[:, :, None, :].expand(-1, -1, cap, -1).reshape(
            len(own), per_atom, 3)
        valid = cand >= 0
        cj = torch.where(valid, cand, 0)
        d = p[cj] + sh - p[own][:, None, :]
        d2 = (d * d).sum(-1)
        self_img = (cj == own[:, None]) & (sh == 0).all(-1)
        keep = valid & (d2 < cut2) & ~self_img
        ii, kk = torch.nonzero(keep, as_tuple=True)
        out_i.append(own[ii])
        out_j.append(cj[ii, kk])
        out_d.append(d[ii, kk])
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_d)
