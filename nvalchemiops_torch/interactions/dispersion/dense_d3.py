# SPDX-License-Identifier: Apache-2.0
"""Dense DFT-D3(BJ) for many small periodic systems, and the batched
router (counterpart of
``nvalchemiops_tpu.interactions.dispersion.dense_d3``).

Every system is swept as all its atom pairs, in upper-triangle tile pairs
seen once (kernels/dense_pairs.py): minimum-image displacements, plus the
second image per axis when ``width/2 < cutoff < width``, distance-pruned to
the image combos that can reach the cutoff (``_image_combos``).  Three
passes, as on the grid: coordination numbers; the C6 interpolation with
BJ-damped energy, direct forces and dE/dCN; the CN chain-rule forces.
Between passes 1 and 2 the per-atom interpolation features are the grid
engine's (``grid_d3._d3_plane_features``) with the factored compensation
``edc = e (d - a_cn)``, prescaled by ``1 / w`` so the pair kernel reads
C6 and its derivatives straight from three mesh-term dots.

``numbers == 0`` marks padding atoms: they carry no CN, energy or force.
D3 parameters are runtime floats.  Returns follow the JAX package: energy
summed over pairs once, forces and CNs per atom.
"""

from __future__ import annotations

import numpy as np
import torch

from nvalchemiops_torch.grid import estimate_grid_geometry
from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
    _SQRT3,
    _d3_plane_features,
    _np,
    batch_grid_dftd3,
    element_c6_mask,
)
from nvalchemiops_torch.kernels.dense_pairs import TILE, dense_pairs
from nvalchemiops_torch.kernels.window_sweep import SweepParams
from nvalchemiops_torch.mathops.math import apply_mat3_batched
from nvalchemiops_torch.trace import host_read, span, spanned, upload
from nvalchemiops_torch.types import INDEX_DTYPE, default_device

__all__ = ["BATCH_DENSE_MAX_ATOMS", "min_perpendicular_width",
           "element_rows", "dense_dftd3", "batch_dense_dftd3", "batch_dftd3"]

#: dense <-> grid routing bound of :func:`batch_dftd3`, atoms per system.
#: Measured on the TPU (the JAX package's crossover probe); kept as the
#: default so both packages route alike until it is re-measured on the
#: H100 (ROADMAP.md, queue 1 item 10).
BATCH_DENSE_MAX_ATOMS = 8192


def _cell_widths(cell_np):
    vol = abs(np.linalg.det(cell_np))
    return np.array([vol / np.linalg.norm(np.cross(cell_np[j], cell_np[k]))
                     for j, k in ((1, 2), (2, 0), (0, 1))])


def _image_combos(images: bool, cell_np=None, cutoff: float | None = None):
    """Image combos (second-image bit per axis), distance-pruned.

    A combo whose bit set S puts the second image on every axis in S has
    pair distance at least ``sqrt(sum_{a in S} (w_a/2)^2)`` for orthogonal
    cells and ``max_{a in S} w_a/2`` otherwise; combos whose bound reaches
    the cutoff are dropped.  The same host-side rule as the JAX package, so
    both keep the same combos (4 of 8 at 41.2 A boxes and a 21.2 A cutoff).
    """
    if not images:
        return [(0, 0, 0)]
    combos = [(bx, by, bz)
              for bx in (0, 1) for by in (0, 1) for bz in (0, 1)]
    if cell_np is None or cutoff is None:
        return combos
    cell_np = np.asarray(cell_np, dtype=np.float64).reshape(3, 3)
    widths = _cell_widths(cell_np)
    off = cell_np @ cell_np.T - np.diag(np.sum(cell_np * cell_np, axis=1))
    orthogonal = np.all(np.abs(off) < 1e-9 * np.max(np.abs(cell_np)) ** 2)
    kept = []
    for bits in combos:
        sel = (widths * 0.5)[np.array(bits, dtype=bool)]
        if sel.size == 0:
            kept.append(bits)
            continue
        bound = np.sqrt(np.sum(sel ** 2)) if orthogonal else np.max(sel)
        if bound < float(cutoff):
            kept.append(bits)
    return kept


def element_rows(numbers, table, device="cuda"):
    """Per-atom element-table rows ``table[numbers]`` (``numbers [..]``
    integer, ``table [Z, ...]`` -> ``[.., ...]``) by indexing; the JAX
    package's one-hot contraction is a layout for the TPU's matrix unit.
    Runs on the device of a tensor input, else on ``device`` (the D3
    tables are numpy)."""
    dev = default_device(
        table if isinstance(table, torch.Tensor) else numbers, device)
    table = torch.as_tensor(table, device=dev)
    idx = torch.as_tensor(numbers, device=dev).long()
    return table[idx]


def min_perpendicular_width(cell) -> float:
    """Smallest perpendicular cell width (host-side): the minimum-image
    bound is ``cutoff <= w/2``, the image sweep's ``cutoff < w``."""
    return float(min(_cell_widths(
        np.asarray(_np(cell), dtype=np.float64).reshape(3, 3))))


def _resolve_images(images, cell, cutoff):
    """Image mode from a concrete cell; raises when ``cutoff >= width``."""
    if images is not None:
        return bool(images)
    w = min_perpendicular_width(cell)
    cut = float(cutoff)
    if cut <= 0.5 * w:
        return False
    if cut < w:
        return True
    raise ValueError(
        f"dense D3 requires cutoff < min cell width ({cut} >= {w}); "
        "use the grid path")


def _batch_combos(cells_np, cutoff, images):
    """Images flag and combos for a batch of cells ``[B, 3, 3]``: resolved
    from the narrowest cell, combos the union over systems (a combo is
    dropped only when every system's bound excludes it).  Each distinct
    cell is examined once."""
    if images is None:
        cells_np = np.unique(np.asarray(cells_np, dtype=np.float64).reshape(
            -1, 9), axis=0).reshape(-1, 3, 3)
        widths = [min_perpendicular_width(c) for c in cells_np]
        images = _resolve_images(None, np.eye(3) * min(widths), cutoff)
        if images:
            union = set()
            for c in cells_np:
                union.update(_image_combos(True, c, float(cutoff)))
            return images, sorted(union)
    return images, _image_combos(images)


def _dense_impl(positions, numbers, cells, cutoff, tables, params, combos):
    """The three dense passes over a batch ``positions [S, n, 3]``; returns
    ``(energy [S], forces [S, n, 3], cn [S, n])``."""
    dtype, device = positions.dtype, positions.device
    s_count, n = positions.shape[:2]
    n_pad = -(-n // TILE) * TILE
    pad = n_pad - n
    rcov, r4r2, cna, mask, c6p = tables
    with span("d3.inputs"):
        if pad:
            positions = torch.nn.functional.pad(positions, (0, 0, 0, pad))
            numbers = torch.nn.functional.pad(numbers, (0, pad))
        zl = numbers.long()
        alive = (numbers != 0).to(dtype)
        with host_read("d3_dense_inv", device):
            frac = apply_mat3_batched(positions, torch.linalg.inv(cells))
        rcov_a = rcov[zl] * alive                   # dead rows: rc = 0
        si_a = torch.sqrt(r4r2 * _SQRT3)[zl]
        cells9 = cells.reshape(s_count, 9).contiguous()

    def sweep(body, cols, lw=None):
        feats = torch.cat([c if c.dim() == 3 else c[..., None] for c in cols],
                          dim=-1).contiguous()
        return dense_pairs(body, feats, cells9, combos, params, lw)

    # pass 1: coordination numbers
    with span("d3.cn"):
        (cn,) = sweep("cn", [frac, rcov_a, alive])

    # per-atom features, w-prescaled: zacc = l0w_i . ew_j is C6 itself
    with span("d3.features"):
        lf, e, edc, w = _d3_plane_features(numbers, cn, cna, mask, c6p,
                                           params.k3)
        pos_w = w > 0.0
        w_inv = torch.where(pos_w, 1.0 / torch.where(pos_w, w,
                                                     torch.ones_like(w)),
                            torch.zeros_like(w))
        lw = (lf * w_inv[..., None]).contiguous()

    # pass 2: energy, direct forces, dE/dCN
    with span("d3.direct"):
        e_rows, de, fx, fy, fz = sweep(
            "direct", [frac, si_a, numbers.to(dtype), e * w_inv[..., None],
                       edc * w_inv[..., None]], lw)
        energy = -e_rows.sum(-1)

    # pass 3: CN chain-rule forces (dead rows masked)
    with span("d3.chain"):
        fx3, fy3, fz3 = sweep("chain", [frac, rcov_a, alive, de * alive])
    with span("d3.gather"):
        forces = torch.stack([fx + fx3, fy + fy3, fz + fz3], dim=-1)
        return energy, forces[:, :n], cn[:, :n]


def _tables(rcov, r4r2, c6ab, cn_ref_elem, dtype, device):
    """Element tables as tensors: ``(rcov, r4r2, cna, mask, c6p)`` with the
    p-major C6 rows ``c6p[z_i, p, (z, q)] = c6ab[z_i, z, p, q]``."""
    def table(a):
        return upload(_np(a), device, dtype, "d3_tables")

    rcov_t, r4r2_t, c6_t, cna_t = (table(a) for a in
                                   (rcov, r4r2, c6ab, cn_ref_elem))
    zmax1, mesh = rcov_t.shape[0], cna_t.shape[1]
    c6p = c6_t.permute(0, 2, 1, 3).reshape(zmax1, mesh, zmax1 * mesh)
    return rcov_t, r4r2_t, cna_t, table(element_c6_mask(c6ab)), c6p


def _params(cutoff, a1, a2, s6, s8, k1, k3):
    return SweepParams(cutoff=float(cutoff), a1=float(a1), a2=float(a2),
                       s6=float(s6), s8=float(s8), k1=float(k1),
                       k3=float(k3))


def _check_dense_knobs(engine, block, interpret):
    """The JAX dense engines' knobs, checked; none changes the route.
    ``engine`` ``"auto"``, ``"pallas"`` or ``"xla"`` runs the port's
    triangle sweep (kernel 4, the Pallas sweep's counterpart; the JAX XLA
    engine's pair planes give its results to rounding); ``block`` (the
    Pallas tile) and ``interpret`` change nothing (kernel 4 has its own
    tiles, and the wrappers take the plain version on CPU tensors)."""
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown dense engine {engine!r}")
    if block is not None and (isinstance(block, bool)
                              or not isinstance(block, (int, np.integer))
                              or block <= 0):
        raise ValueError(f"block must be None or a positive int, got "
                         f"{block!r}")
    if not isinstance(interpret, (bool, np.bool_)):
        raise ValueError(f"interpret must be a bool, got {interpret!r}")


def _check_combos(combos):
    """Explicit image combos: a non-empty list of second-image bit
    triples."""
    combos = [tuple(int(b) for b in c) for c in combos]
    if not combos or any(len(c) != 3 or set(c) - {0, 1} for c in combos):
        raise ValueError(f"combos must be (bx, by, bz) bit triples, got "
                         f"{combos!r}")
    return combos


@spanned("d3")
def dense_dftd3(positions, numbers, cell, cutoff, rcov, r4r2, c6ab,
                cn_ref_elem, a1, a2, s8, s6=1.0, k1=16.0, k3=-4.0,
                images: bool | None = None, combos=None,
                engine: str = "auto", block: int | None = None,
                interpret: bool = False):
    """DFT-D3(BJ) of one periodic system by dense pair tiles.

    ``images=None`` picks the minimum image when ``cutoff <= width/2`` and
    the second-image sweep when ``width/2 < cutoff < width``.  ``combos``
    (second-image bit triples) replaces the distance-pruned combos, as in
    the JAX package.  Tables may be numpy arrays or tensors.  Returns
    ``(energy, forces [n, 3], cn [n])`` in the positions' dtype on their
    device.  ``engine``, ``block`` and ``interpret``: see
    :func:`_check_dense_knobs`.
    """
    _check_dense_knobs(engine, block, interpret)
    dtype, device = positions.dtype, positions.device
    with span("d3.inputs"):
        cell = upload(cell, device, dtype, "d3_cells").reshape(3, 3)
        images = _resolve_images(images, cell, cutoff)
        if combos is None:
            combos = _image_combos(
                images, _np(cell, "d3_combos") if images else None,
                float(cutoff))
        else:
            combos = _check_combos(combos)
        numbers = upload(_np(numbers), device, INDEX_DTYPE, "d3_numbers")
        tables = _tables(rcov, r4r2, c6ab, cn_ref_elem, dtype, device)
    e, f, cn = _dense_impl(
        positions[None], numbers[None], cell[None], cutoff, tables,
        _params(cutoff, a1, a2, s6, s8, k1, k3), combos)
    return e[0], f[0], cn[0]


@spanned("d3")
def batch_dense_dftd3(positions, numbers, cells, cutoff, rcov, r4r2, c6ab,
                      cn_ref_elem, a1, a2, s8, s6=1.0, k1=16.0, k3=-4.0,
                      system_chunk: int | None = None,
                      images: bool | None = None, engine: str = "auto",
                      block: int | None = None, interpret: bool = False):
    """Batched dense D3: ``positions [B, n, 3]``, ``numbers [B, n]``,
    ``cells`` ``[3, 3]`` shared or ``[B, 3, 3]``.  Returns ``(energy [B],
    forces [B, n, 3], cn [B, n])``.

    ``images`` is resolved on the host from the narrowest cell of the
    batch and applied to all systems, with the union of their combos.
    ``system_chunk`` runs the batch ``system_chunk`` systems at a time (one
    launch of each pass per chunk); it must divide ``B``, as in the JAX
    package.  By default the whole batch is one chunk: the kernel streams
    its tiles, so the batch needs no more memory than its inputs.
    ``engine``, ``block`` and ``interpret``: see :func:`_check_dense_knobs`.
    """
    _check_dense_knobs(engine, block, interpret)
    dtype, device = positions.dtype, positions.device
    b = positions.shape[0]
    chunk = b if system_chunk is None else int(system_chunk)
    if chunk < 1 or b % chunk:
        raise ValueError(f"B={b} must divide by system_chunk={system_chunk}")
    with span("d3.inputs"):
        cells = upload(cells, device, dtype, "d3_cells")
        if cells.dim() == 2:
            cells = cells.expand(b, 3, 3)
        cells = cells.contiguous()
        images, combos = _batch_combos(_np(cells, "d3_combos"), cutoff,
                                       images)
        numbers = upload(_np(numbers), device, INDEX_DTYPE, "d3_numbers")
        tables = _tables(rcov, r4r2, c6ab, cn_ref_elem, dtype, device)
    params = _params(cutoff, a1, a2, s6, s8, k1, k3)
    outs = [_dense_impl(positions[c:c + chunk], numbers[c:c + chunk],
                        cells[c:c + chunk], cutoff, tables, params, combos)
            for c in range(0, b, chunk)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(o) for o in zip(*outs))


def batch_route(cells, pbc, cutoff, n_atoms: int) -> str:
    """The engine :func:`batch_dftd3` picks: ``"dense"`` when every system
    has at most ``BATCH_DENSE_MAX_ATOMS`` atoms and full PBC, or when the
    halo grid cannot represent the cutoff; ``"grid"`` otherwise."""
    cells_np = np.asarray(_np(cells), dtype=np.float64)
    cell0 = cells_np if cells_np.ndim == 2 else cells_np[0]
    pbc_np = np.asarray(_np(pbc), dtype=bool).reshape(-1)[:3]
    try:
        estimate_grid_geometry(cell0, pbc_np, float(cutoff), n_atoms)
    except ValueError:
        return "dense"
    if pbc_np.all() and n_atoms <= BATCH_DENSE_MAX_ATOMS:
        return "dense"
    return "grid"


@spanned("d3")
def batch_dftd3(positions, numbers, cells, pbc, cutoff, rcov, r4r2, c6ab,
                cn_ref_elem, a1, a2, s8, s6=1.0, k1=16.0, k3=-4.0,
                engine: str = "auto", **kwargs):
    """Batched DFT-D3(BJ) with dense <-> grid routing.

    ``engine="auto"`` takes :func:`batch_route`; ``"dense"`` and
    ``"grid"`` force a path, and remaining keyword arguments go to the
    chosen engine (:func:`batch_dense_dftd3` or
    ``grid_d3.batch_grid_dftd3``).  The dense engine assumes full PBC: a
    batch routed or forced to it with mixed ``pbc`` raises ``ValueError``
    (where the JAX package routes a grid-infeasible mixed-PBC batch to an
    engine that then refuses it).
    """
    with span("d3.route"):
        pbc_np = np.asarray(_np(pbc), dtype=bool).reshape(-1)[:3]
        if engine == "auto":
            engine = batch_route(cells, pbc_np, cutoff,
                                 int(positions.shape[1]))
    if engine == "dense":
        if not pbc_np.all():
            raise ValueError(
                f"batch dense D3 assumes full PBC, got pbc {pbc_np.tolist()}; "
                "engine='grid' takes mixed pbc where the halo grid can "
                f"represent cutoff {float(cutoff)}")
        return batch_dense_dftd3(positions, numbers, cells, cutoff, rcov,
                                 r4r2, c6ab, cn_ref_elem, a1, a2, s8, s6=s6,
                                 k1=k1, k3=k3, **kwargs)
    if engine != "grid":
        raise ValueError(f"unknown engine {engine!r}")
    return batch_grid_dftd3(positions, numbers, cells, pbc_np, cutoff, rcov,
                            r4r2, c6ab, cn_ref_elem, a1, a2, s8, s6=s6,
                            k1=k1, k3=k3, **kwargs)
