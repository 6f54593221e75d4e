# SPDX-License-Identifier: Apache-2.0
"""DFT-D3(BJ) dispersion over neighbour matrices and pair lists: energies,
analytical forces, coordination numbers and per-system virials.

Counterpart of ``nvalchemiops_tpu.interactions.dispersion.dftd3``, the
reference library's own D3 entry point: the element tables come as
:class:`D3Parameters`, a dict or explicit arrays; the pairs as a padded
neighbour matrix with shifts or a CSR-ordered COO list with unit shifts,
as ``neighbor_list`` gives them.  Two-body only (no ATM C9), padding atoms
are ``numbers == 0``, outputs f32 by default as in the reference.  The
sweeps are plain PyTorch (``_kernels.py``); no hand-written kernel backs
them, as no Pallas kernel backs the JAX ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nvalchemiops_torch.interactions.dispersion._kernels import (  # noqa: F401
    _c6_interpolate,    # the JAX module's helpers, shared with the sweeps
    _s5_switch,
    dftd3_list_kernel,
    dftd3_matrix_kernel,
)
from nvalchemiops_torch.neighborlist.neighbor_utils import shifts_to_aos
from nvalchemiops_torch.types import INDEX_DTYPE, _as_torch_dtype, \
    default_device

__all__ = ["D3Parameters", "dftd3"]

_TABLES = ("rcov", "r4r2", "c6ab", "cn_ref")


def _table(x, device):
    """``x`` as a tensor on ``device`` (a tensor keeps its own where
    ``device`` is None)."""
    return torch.as_tensor(x, device=default_device(x, device))


@dataclass
class D3Parameters:
    """Validated container for the DFT-D3 element tables.

    Shapes: ``rcov [Zmax+1]``, ``r4r2 [Zmax+1]``, ``c6ab [Zmax+1, Zmax+1,
    5, 5]``, ``cn_ref [Zmax+1, Zmax+1, 5, 5]``; index 0 is the padding
    element.  The tables become tensors on ``device`` (port-only): numpy
    tables (as ``d3_data`` gives them) go to the card unless ``device``
    names another, tensors stay where they are unless it is given.
    """

    rcov: torch.Tensor
    r4r2: torch.Tensor
    c6ab: torch.Tensor
    cn_ref: torch.Tensor
    interp_mesh: int = 5
    device: str | torch.device | None = None

    def __post_init__(self):
        for name in _TABLES:
            setattr(self, name, _table(getattr(self, name), self.device))
        zmax = self.rcov.shape[0]
        if self.rcov.ndim != 1 or tuple(self.r4r2.shape) != (zmax,):
            raise ValueError(
                f"rcov/r4r2 must be 1-D with matching length, got "
                f"{tuple(self.rcov.shape)} / {tuple(self.r4r2.shape)}")
        m = self.interp_mesh
        expected = (zmax, zmax, m, m)
        for name in ("c6ab", "cn_ref"):
            shape = tuple(getattr(self, name).shape)
            if shape != expected:
                raise ValueError(f"{name} must have shape {expected}, got "
                                 f"{shape}")

    def as_dict(self):
        return {name: getattr(self, name) for name in _TABLES}


def _resolve_parameters(d3_params, covalent_radii, r4r2, c6_reference,
                        coord_num_ref):
    """The four tables from a :class:`D3Parameters`, a dict or the explicit
    arrays (explicit ones override); ``ValueError`` naming any missing."""
    tables = {}
    if isinstance(d3_params, D3Parameters):
        tables = d3_params.as_dict()
    elif isinstance(d3_params, dict):
        tables = {name: d3_params.get(name) for name in _TABLES}
    for name, given in zip(_TABLES, (covalent_radii, r4r2, c6_reference,
                                     coord_num_ref)):
        if given is not None:
            tables[name] = given
    missing = [k for k in _TABLES if tables.get(k) is None]
    if missing:
        raise ValueError(
            f"DFT-D3 parameters missing: {missing}. Provide d3_params or the "
            "explicit covalent_radii/r4r2/c6_reference/coord_num_ref arrays.")
    return tuple(tables[name] for name in _TABLES)


def _output_dtype(output_dtype):
    """``output_dtype`` as a torch floating dtype (None stays): a torch
    dtype, or a numpy/JAX dtype or its name."""
    if output_dtype is None:
        return None
    try:
        dt = _as_torch_dtype(output_dtype)
    except (TypeError, ValueError):
        dt = None
    if dt is None or not dt.is_floating_point:
        raise ValueError(f"output_dtype must be a floating dtype, got "
                         f"{output_dtype!r}")
    return dt


def dftd3(
    positions,
    numbers,
    a1: float,
    a2: float,
    s8: float,
    k1: float = 16.0,
    k3: float = -4.0,
    s6: float = 1.0,
    s5_smoothing_on: float = 1e10,
    s5_smoothing_off: float = 1e10,
    fill_value: int | None = None,
    d3_params: D3Parameters | dict | None = None,
    covalent_radii=None,
    r4r2=None,
    c6_reference=None,
    coord_num_ref=None,
    batch_idx=None,
    cell=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    neighbor_list=None,
    neighbor_ptr=None,
    unit_shifts=None,
    compute_virial: bool = False,
    num_systems: int | None = None,
    output_dtype=torch.float32,
    device=None,
):
    """DFT-D3(BJ) dispersion energy, forces and coordination numbers.

    The JAX package's entry point and parameters: the tables via
    ``d3_params`` (dataclass or dict) or the explicit arrays, and one
    neighbour format, the padded ``neighbor_matrix [N, K]`` (entries >=
    ``fill_value``, default N, are empty) with ``neighbor_matrix_shifts``
    packed ``[N, K]`` or ``[N, K, 3]``, or the CSR-ordered
    ``neighbor_list [2, P]`` with ``unit_shifts`` ``[P, 3]`` or packed
    ``[P]`` (``neighbor_ptr`` is accepted and not needed).  ``batch_idx``
    assigns atoms to systems, with one ``[3, 3]`` cell or one per system
    ``[B, 3, 3]``; ``num_systems`` is the cell's leading axis, else read
    once from ``batch_idx.max()``.  Outputs are cast to ``output_dtype``
    (f32 as in the reference; None keeps the positions' dtype).

    Runs on the device of ``positions`` when it is a tensor, else on
    ``device`` (port-only; the card unless it names another).  Returns
    ``(energy [num_systems], forces [N, 3], coord_num [N])`` and, with
    ``compute_virial`` (which needs ``cell``), ``virial [num_systems, 3,
    3]``.
    """
    dev = default_device(positions, device)
    positions = torch.as_tensor(positions, device=dev)
    numbers = torch.as_tensor(numbers, device=dev).to(INDEX_DTYPE)
    num_atoms = positions.shape[0]
    dtype = positions.dtype
    out_dtype = _output_dtype(output_dtype) or dtype

    tables = [torch.as_tensor(t, device=dev).to(dtype)
              for t in _resolve_parameters(d3_params, covalent_radii, r4r2,
                                           c6_reference, coord_num_ref)]

    use_matrix = neighbor_matrix is not None
    use_list = neighbor_list is not None
    if use_matrix == use_list:
        raise ValueError("Provide exactly one of neighbor_matrix or "
                         "neighbor_list")
    periodic = cell is not None
    if compute_virial and not periodic:
        raise ValueError("Virial computation requires periodic boundary "
                         "conditions")
    cell_b = (torch.as_tensor(cell, device=dev).to(dtype).reshape(-1, 3, 3)
              if periodic else torch.zeros((1, 3, 3), dtype=dtype,
                                           device=dev))
    bidx = (None if batch_idx is None
            else torch.as_tensor(batch_idx, device=dev).to(INDEX_DTYPE))
    if num_systems is None:
        if bidx is None:
            num_systems = 1
        elif periodic and cell_b.shape[0] > 1:
            num_systems = cell_b.shape[0]
        else:
            num_systems = int(bidx.max().item()) + 1
    num_systems = int(num_systems)

    def outputs(energy, forces, coord_num, virial):
        out = (energy, forces, coord_num) + ((virial,) if compute_virial
                                             else ())
        return tuple(x.to(out_dtype) for x in out)

    if num_atoms == 0:
        return outputs(
            torch.zeros(num_systems, dtype=dtype, device=dev),
            torch.zeros((0, 3), dtype=dtype, device=dev),
            torch.zeros(0, dtype=dtype, device=dev),
            torch.zeros((num_systems, 3, 3), dtype=dtype, device=dev))

    scalars = (a1, a2, s8, k1, k3, s6, s5_smoothing_on, s5_smoothing_off)
    if use_list:
        if periodic and unit_shifts is None:
            raise ValueError("unit_shifts required with cell")
        pairs = torch.as_tensor(neighbor_list, device=dev).to(INDEX_DTYPE)
        shifts = None
        if periodic:
            shifts = torch.as_tensor(unit_shifts, device=dev).to(INDEX_DTYPE)
            if shifts.ndim != 2:                      # bit-packed [P]
                shifts = shifts_to_aos(shifts)
        return outputs(*dftd3_list_kernel(
            positions, numbers, pairs[0], pairs[1], shifts, cell_b, bidx,
            *tables, *scalars, periodic, num_systems, compute_virial))

    nm = torch.as_tensor(neighbor_matrix, device=dev).to(INDEX_DTYPE)
    if fill_value is None:
        fill_value = num_atoms
    if periodic and neighbor_matrix_shifts is None:
        raise ValueError("neighbor_matrix_shifts/unit_shifts required with "
                         "cell")
    shifts = None
    if periodic:
        shifts = torch.as_tensor(neighbor_matrix_shifts,
                                 device=dev).to(INDEX_DTYPE)
        if shifts.ndim == 2:                          # bit-packed [N, K]
            shifts = shifts_to_aos(shifts)
    return outputs(*dftd3_matrix_kernel(
        positions, numbers, nm, shifts, cell_b, bidx, *tables, *scalars,
        int(fill_value), periodic, num_systems, compute_virial))
