# SPDX-License-Identifier: Apache-2.0
"""Carry the JAX package's state into the port, as numpy arrays.

The caller converts each JAX array with ``np.asarray``; nothing here
imports JAX.  Tests use these to feed one identical grid, tile set or table
set to both packages and compare each stage in isolation.  Like every entry
point of the port, these put their tensors on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from nvalchemiops_torch.grid import AtomGrid
from nvalchemiops_torch.spline_windowed import MeshTiles
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["ATOM_GRID_FIELDS", "MESH_TILES_FIELDS", "atom_grid_from_numpy",
           "batch_atom_grid_from_numpy", "mesh_tiles_from_numpy",
           "d3_tables_from_numpy"]

#: array fields of an AtomGrid (both packages use these names)
ATOM_GRID_FIELDS = ("ext_px", "ext_py", "ext_pz", "ext_valid", "ext_aid",
                    "ext_shift_code", "flat_slot", "counts_max")
#: array fields of a MeshTiles (both packages use these names)
MESH_TILES_FIELDS = ("smat", "flat_slot", "aid", "counts_max", "inv")


def atom_grid_from_numpy(fields: Mapping[str, np.ndarray], dims, radius,
                         cap: int, dtype=None, device="cuda") -> AtomGrid:
    """AtomGrid from the JAX grid's fields (numpy) plus its geometry.

    Positions take ``dtype`` (default: the arrays' own float dtype); ids,
    codes and slots become int32 (the JAX grid's ``ext_aid`` may be any
    integer type), validity bool.  Fields of a batched grid keep their
    leading system axis (see :func:`batch_atom_grid_from_numpy`).
    """
    def fl(a):
        t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    def ix(a):
        return torch.from_numpy(np.array(a)).to(device=device,
                                                 dtype=INDEX_DTYPE)

    return AtomGrid(
        ext_px=fl(fields["ext_px"]),
        ext_py=fl(fields["ext_py"]),
        ext_pz=fl(fields["ext_pz"]),
        ext_valid=torch.from_numpy(np.array(fields["ext_valid"],
                                            dtype=bool)).to(device),
        ext_aid=ix(fields["ext_aid"]),
        ext_shift_code=ix(fields["ext_shift_code"]),
        flat_slot=ix(fields["flat_slot"]),
        counts_max=ix(fields["counts_max"]),
        dims=dims, radius=radius, cap=cap,
    )


def batch_atom_grid_from_numpy(fields: Mapping[str, np.ndarray], dims,
                               radius, cap: int, dtype=None,
                               device="cuda") -> AtomGrid:
    """Batched AtomGrid (every array field ``[B, ..]``, ``counts_max [B]``)
    from the JAX package's ``batch_build_atom_grid`` fields; take one
    system with ``grid.system_grid``."""
    if np.ndim(fields["counts_max"]) != 1:
        raise ValueError("batched grid fields need a leading system axis "
                         "(counts_max [B])")
    return atom_grid_from_numpy(fields, dims, radius, cap, dtype=dtype,
                                device=device)


def mesh_tiles_from_numpy(fields: Mapping[str, np.ndarray], mesh_dims,
                          tile: int, cap: int, order: int, has_grad: bool,
                          dtype=None, device="cuda") -> MeshTiles:
    """MeshTiles from the JAX tiles' fields (numpy) plus their metadata."""
    def fl(a):
        t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    def ix(a):
        return torch.from_numpy(np.array(a)).to(device=device,
                                                 dtype=INDEX_DTYPE)

    return MeshTiles(
        smat=fl(fields["smat"]).contiguous(),
        flat_slot=ix(fields["flat_slot"]),
        aid=ix(fields["aid"]),
        counts_max=ix(fields["counts_max"]).reshape(()),
        inv=fl(fields["inv"]),
        mesh_dims=mesh_dims, tile=tile, cap=cap, order=order,
        has_grad=has_grad,
    )


def d3_tables_from_numpy(rcov, r4r2, c6ab, cn_ref_elem, dtype=torch.float64,
                         device="cuda") -> dict:
    """The D3 tables (``rcov, r4r2, c6ab, cn_ref_elem``) as tensors of
    ``dtype`` on ``device``, keyed by those names."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return {"rcov": t(rcov), "r4r2": t(r4r2), "c6ab": t(c6ab),
            "cn_ref_elem": t(cn_ref_elem)}

