# SPDX-License-Identifier: Apache-2.0
"""Particle mesh Ewald (counterpart of
``nvalchemiops_tpu.interactions.electrostatics.pme``): the reciprocal space
for one system, for concatenated systems (``batch_idx``) and for uniform
batches; the full PME over a neighbor structure
(:func:`particle_mesh_ewald`) and over the halo grid
(:func:`grid_particle_mesh_ewald`).

Pipeline: spread the charges (tile-windowed or dense separable spline) ->
``torch.fft.rfftn`` -> divide by the B-spline dealiasing factor, multiply
by the Green's function -> ``irfftn`` -> gather the potential and its
spline-derivative gradient at the atoms -> self/background corrections.
With ``fft_mode="matmul"`` the transform, convolution and inverse are the
matrix products of ``mathops.matmul_dft``.
Forces are the analytic gradient of the discrete energy (one inverse FFT),
with the mesh-accuracy net force removed per system.

Two spline engines, each on its CUDA kernels:

- tile-windowed (``spline_windowed.py``, kernels/windowed_gather.py): the
  single-system default, and ``batch_pme_reciprocal(engine="windowed")``;
- dense separable (``spline.py`` dense path, kernels/separable_spline.py):
  ``batch_pme_reciprocal(engine="dense")`` (auto for meshes up to 32^3, a
  TPU-fit gate kept as the default) and the route of
  :func:`pme_reciprocal_space` for one system when a mesh tile holds more
  atoms than its capacity or the mesh does not suit the windows.

Concatenated systems (``batch_idx``) take the scatter spline path of
``spline.py`` (``index_add_`` and indexing), as the JAX package runs them
as XLA scatter and gather.

Conventions as in the JAX package: ``G(k) = 2 pi exp(-k^2/(4 alpha^2)) /
(V k^2)``, dealiasing ``[sinc(mx/nx) sinc(my/ny) sinc(mz/nz)]^order``
squared, unscaled forward and inverse transforms, and ``E_i -= (alpha /
sqrt(pi)) q_i^2 + (pi / (2 alpha^2 V)) q_i Q``.
"""

from __future__ import annotations

import math

import torch

from nvalchemiops_torch import spline_windowed as sw
from nvalchemiops_torch.grid import grid_coulomb_energy_forces
from nvalchemiops_torch.interactions.electrostatics.ewald import (
    ewald_real_space, returns,
)
from nvalchemiops_torch.interactions.electrostatics.k_vectors import (
    generate_k_vectors_pme,
)
from nvalchemiops_torch.interactions.electrostatics.parameters import (
    estimate_ewald_parameters,
    estimate_pme_mesh_dimensions,
    mesh_spacing_to_dimensions,
)
from nvalchemiops_torch.kernels.separable_spline import (
    separable_gather,
    separable_spread,
)
from nvalchemiops_torch.mathops.math import (
    apply_mat3_batched, sinc_normalized,
)
from nvalchemiops_torch.mathops.matmul_dft import matmul_rfft_convolve
from nvalchemiops_torch.spline import (
    _stencil, spline_gather, spline_gather_gradient, spline_spread,
)
from nvalchemiops_torch.trace import host_read, span, spanned, upload

__all__ = ["pme_green_structure_factor", "pme_reciprocal_space",
           "particle_mesh_ewald", "grid_particle_mesh_ewald",
           "batch_pme_reciprocal"]

TWOPI = 2.0 * math.pi
SQRT_PI = math.sqrt(math.pi)

#: per-system mesh points up to which ``batch_pme_reciprocal(engine=
#: "auto")`` takes the dense engine (fit on the TPU; kept so both packages
#: route alike, ROADMAP.md, queue 1 item 10)
DENSE_MESH_MAX_POINTS = 32 * 32 * 32


def pme_green_structure_factor(k_squared, mesh_dimensions, alpha, cell,
                               spline_order: int):
    """Green's function and ``|B(k)|^2`` dealiasing factor on the rfft grid.

    ``k_squared [nx, ny, nz//2+1]`` with ``cell [3, 3]`` and a scalar
    ``alpha``, or a leading batch axis on ``k_squared`` with ``cell [B, 3,
    3]`` and ``alpha`` scalar or ``[B]``.  Returns ``(green, sf_sq)``.
    """
    nx, ny, nz = (int(d) for d in mesh_dimensions)
    dtype, device = k_squared.dtype, k_squared.device
    batched = k_squared.dim() == 4
    cell_b = torch.as_tensor(cell, dtype=dtype, device=device).reshape(-1, 3,
                                                                       3)
    volume = torch.abs(torch.linalg.det(cell_b))
    alpha = torch.broadcast_to(torch.as_tensor(
        alpha, dtype=dtype, device=device).reshape(-1), volume.shape)
    if batched:
        volume = volume.reshape(-1, 1, 1, 1)
        alpha = alpha.reshape(-1, 1, 1, 1)
    else:
        volume, alpha = volume[0], alpha[0]
    good = k_squared > 1e-10
    ks_safe = torch.where(good, k_squared, torch.ones_like(k_squared))
    green = torch.where(
        good,
        TWOPI * torch.exp(-(0.25 / (alpha * alpha)) * ks_safe)
        / (ks_safe * volume),
        torch.zeros_like(k_squared),
    )
    mx = torch.fft.fftfreq(nx, dtype=dtype, device=device) * nx
    my = torch.fft.fftfreq(ny, dtype=dtype, device=device) * ny
    mz = torch.fft.rfftfreq(nz, dtype=dtype, device=device) * nz
    sinc3 = (sinc_normalized(mx / nx)[:, None, None]
             * sinc_normalized(my / ny)[None, :, None]
             * sinc_normalized(mz / nz)[None, None, :])
    sf = torch.clamp(sinc3 ** spline_order, min=1e-10)
    return green, sf * sf


def _potential(mesh, cell, alpha, mesh_dimensions, spline_order: int,
               k_squared=None, fft_mode: str = "xla"):
    """Convolve charge meshes ``[.., nx, ny, nz]`` with the Green's
    function (``torch.fft``, or the matrix-product DFT for ``fft_mode=
    "matmul"``); returns the potential meshes (contiguous)."""
    if k_squared is None:
        _, k_squared = generate_k_vectors_pme(cell, mesh_dimensions)
    green, sf_sq = pme_green_structure_factor(k_squared, mesh_dimensions,
                                              alpha, cell, spline_order)
    if fft_mode == "matmul":
        return matmul_rfft_convolve(mesh, green / sf_sq)
    axes = (-3, -2, -1)
    mesh_fft = torch.fft.rfftn(mesh, dim=axes, norm="backward")
    return torch.fft.irfftn(mesh_fft / sf_sq * green, s=mesh_dimensions,
                            dim=axes, norm="forward").to(
                                mesh.dtype).contiguous()


def _finish(charges, raw, grad_frac, inv, alpha, cell, compute_forces,
            compute_charge_gradients):
    """Self/background corrections, charge gradients and forces from the
    gathered potential ``raw [.., N]`` and fractional gradient ``grad_frac
    [.., N, 3]`` (leading system axes allowed)."""
    lead = tuple(charges.shape[:-1])
    dtype, device = charges.dtype, charges.device
    alpha = torch.broadcast_to(
        torch.as_tensor(alpha, dtype=dtype, device=device).reshape(-1),
        (max(1, math.prod(lead)),)).reshape(lead + (1,))
    volume = torch.abs(torch.linalg.det(cell)).reshape(lead + (1,))
    q_tot = charges.sum(-1, keepdim=True)
    energies = (charges * raw
                - (alpha / SQRT_PI) * charges * charges
                - (math.pi / (2.0 * alpha ** 2)) * charges * q_tot / volume)
    charge_grads = None
    if compute_charge_gradients:
        # d(sum E)/dq_k: the spread side doubles raw_k by the symmetry of
        # the convolution (the identity of the force path)
        charge_grads = (2.0 * raw - 2.0 * (alpha / SQRT_PI) * charges
                        - (math.pi / alpha ** 2) * q_tot / volume)
    forces = None
    if compute_forces:
        forces = 2.0 * apply_mat3_batched(-charges[..., None] * grad_frac,
                                          inv.transpose(-1, -2))
        # smooth-PME gradient forces carry a mesh-accuracy net force;
        # remove it uniformly per system (the standard SPME remedy)
        forces = forces - forces.mean(dim=-2, keepdim=True)
    return energies, forces, charge_grads


def _windowed_pme(tiles, charges, cell, alpha, spline_order: int,
                  compute_forces: bool, compute_charge_gradients: bool,
                  k_squared=None, fft_mode: str = "xla"):
    """One system through the tile-windowed pipeline on built tiles."""
    with span("pme.spread"):
        mesh = sw.windowed_spread(tiles, charges)
    with span("pme.fft"):
        potential = _potential(mesh, cell, alpha, tiles.mesh_dims,
                               spline_order, k_squared, fft_mode)
    with span("pme.gather"):
        grad_frac = None
        if compute_forces:
            raw, grad_frac = sw.windowed_gather(tiles, potential,
                                                with_gradient=True)
        else:
            raw = sw.windowed_gather(tiles, potential)
        return _finish(charges, raw, grad_frac, tiles.inv, alpha, cell,
                       compute_forces, compute_charge_gradients)


def _windowed_pme_single(positions, charges, cell, alpha, mesh_dimensions,
                         spline_order: int, cap: int, compute_forces: bool,
                         compute_charge_gradients: bool = False,
                         tile: int = 8, fft_mode: str = "xla"):
    """One system through the tile-windowed pipeline.  Raises when a tile
    holds more than ``cap`` atoms (the JAX package's lean version drops
    them silently)."""
    tiles = sw.build_mesh_tiles(positions, cell, mesh_dimensions,
                                spline_order, cap, tile=tile,
                                need_grad=compute_forces)
    with host_read("pme_tile_cap", positions.device):
        counts_max = int(tiles.counts_max)
    if counts_max > cap:
        raise ValueError(f"PME mesh tile overflow: {counts_max} atoms in one "
                         f"tile, capacity {cap}; pass a larger tile_capacity")
    return _windowed_pme(tiles, charges, cell, alpha, spline_order,
                         compute_forces, compute_charge_gradients,
                         fft_mode=fft_mode)


def _batch_windowed_pme_impl(positions, charges, cells, alphas,
                             mesh_dimensions, spline_order: int, cap: int,
                             compute_forces: bool,
                             compute_charge_gradients: bool = False,
                             tile: int = 8, fft_mode: str = "xla"):
    """The windowed pipeline per system, stacked (``[B, ..]`` outputs)."""
    outs = [_windowed_pme_single(positions[b], charges[b], cells[b],
                                 alphas[b], mesh_dimensions, spline_order,
                                 cap, compute_forces,
                                 compute_charge_gradients, tile=tile,
                                 fft_mode=fft_mode)
            for b in range(positions.shape[0])]
    return tuple(None if o[0] is None else torch.stack(o)
                 for o in zip(*outs))


def _batch_dense_pme_impl(positions, charges, cells, alphas, mesh_dimensions,
                          spline_order: int, compute_forces: bool,
                          compute_charge_gradients: bool = False,
                          k_squared=None, fft_mode: str = "xla"):
    """Systems ``[B, N, 3]`` through the dense separable pipeline: one
    stencil, one spread launch, one batched convolution, one gather
    launch."""
    gidx, w, dw, inv = _stencil(positions, cells, mesh_dimensions,
                                spline_order)
    mesh = separable_spread(gidx, w, charges, mesh_dimensions)
    potential = _potential(mesh, cells, alphas, mesh_dimensions,
                           spline_order, k_squared, fft_mode)
    grad_frac = None
    if compute_forces:
        raw, grad_frac = separable_gather(potential, gidx, w, dw)
    else:
        raw = separable_gather(potential, gidx, w)
    return _finish(charges, raw, grad_frac, inv, alphas, cells,
                   compute_forces, compute_charge_gradients)


def _dense_pme_single(positions, charges, cell, alpha, mesh_dimensions,
                      spline_order: int, compute_forces: bool,
                      compute_charge_gradients: bool = False,
                      k_squared=None, fft_mode: str = "xla"):
    """One system through the dense separable pipeline."""
    out = _batch_dense_pme_impl(
        positions[None], charges[None], cell[None], alpha, mesh_dimensions,
        spline_order, compute_forces, compute_charge_gradients,
        None if k_squared is None else k_squared[None], fft_mode)
    return tuple(None if o is None else o[0] for o in out)


def _check_pme_knobs(fft_mode, spread_engine, gather_engine,
                     fft_modes=("xla", "matmul")):
    """``fft_mode`` is ``"xla"`` (``torch.fft``) or ``"matmul"`` (the
    matrix-product DFT); the spline engine strings name the JAX package's
    two implementations of one per-tile contraction, which the port runs on
    its kernels whichever is named."""
    if fft_mode not in fft_modes:
        raise ValueError(f"fft_mode must be one of {list(fft_modes)}, got "
                         f"{fft_mode!r}")
    for name, value in (("spread_engine", spread_engine),
                        ("gather_engine", gather_engine)):
        if value not in ("xla", "pallas"):
            raise ValueError(f"{name} must be 'xla' or 'pallas', got "
                             f"{value!r}")


def _mesh_dims(cell_b, alpha, mesh_dimensions, mesh_spacing, accuracy):
    """The mesh: as given, else from ``mesh_spacing``, else from the
    accuracy estimate (host side, static FFT shapes)."""
    if mesh_dimensions is not None:
        return tuple(int(d) for d in mesh_dimensions)
    if mesh_spacing is not None:
        return mesh_spacing_to_dimensions(cell_b, mesh_spacing)
    return estimate_pme_mesh_dimensions(cell_b, alpha, accuracy)


def _batch_idx_pme(positions, charges, cell_b, alpha_b, mesh_dimensions,
                   spline_order: int, batch_idx, compute_forces: bool,
                   compute_charge_gradients: bool, k_squared=None,
                   fft_mode: str = "xla"):
    """Concatenated systems through the scatter spline path: per-system
    ``Q``, ``alpha`` and volume in the corrections, and each system's net
    force removed."""
    num_systems = cell_b.shape[0]
    b_of = torch.as_tensor(batch_idx, device=positions.device).long()
    mesh = spline_spread(positions, charges, cell_b, mesh_dimensions,
                         spline_order, batch_idx=b_of)
    if mesh.dim() == 3:
        mesh = mesh[None]
    if k_squared is None:
        _, k_squared = generate_k_vectors_pme(cell_b, mesh_dimensions)
    potential = _potential(mesh, cell_b, alpha_b, mesh_dimensions,
                           spline_order, k_squared.reshape(
                               (-1,) + tuple(k_squared.shape[-3:])),
                           fft_mode)
    raw = spline_gather(positions, potential, cell_b, spline_order,
                        batch_idx=b_of)

    def per_system(v):
        return torch.zeros((num_systems,) + tuple(v.shape[1:]),
                           dtype=v.dtype, device=v.device).index_add(0, b_of,
                                                                     v)

    volume = torch.abs(torch.linalg.det(cell_b))
    alpha_a, vol_a = alpha_b[b_of], volume[b_of]
    q_tot_a = per_system(charges)[b_of]
    energies = (charges * raw - (alpha_a / SQRT_PI) * charges * charges
                - (math.pi / (2.0 * alpha_a ** 2)) * charges * q_tot_a
                / vol_a)
    charge_grads = None
    if compute_charge_gradients:
        charge_grads = (2.0 * raw - 2.0 * (alpha_a / SQRT_PI) * charges
                        - (math.pi / alpha_a ** 2) * q_tot_a / vol_a)
    forces = None
    if compute_forces:
        forces = 2.0 * spline_gather_gradient(
            positions, charges, potential, cell_b, spline_order,
            batch_idx=b_of)
        counts = per_system(torch.ones_like(charges))
        net = per_system(forces)
        forces = forces - net[b_of] / torch.clamp(counts[b_of],
                                                  min=1.0)[:, None]
    return energies, forces, charge_grads


@spanned("pme")
def pme_reciprocal_space(
    positions,
    charges,
    cell,
    alpha,
    mesh_dimensions=None,
    mesh_spacing=None,
    spline_order: int = 4,
    batch_idx=None,
    k_vectors=None,
    k_squared=None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    accuracy: float = 1e-6,
    tile_capacity: int | None = None,
    fft_mode: str = "xla",
    gather_engine: str = "xla",
    spread_engine: str = "xla",
):
    """FFT-based reciprocal-space PME.

    Return patterns: ``energies``, ``(energies, forces)``,
    ``(energies, charge_grads)``, ``(energies, forces, charge_grads)``.
    The mesh is ``mesh_dimensions``, else chosen from ``mesh_spacing``,
    else from ``accuracy`` (:mod:`parameters`).

    One system takes the tile-windowed pipeline; ``tile_capacity``
    overrides its Poisson-safe tile capacity with an observed one
    (:func:`spline_windowed.observed_tile_capacity`).  Where a tile holds
    more atoms than its capacity, or the mesh does not suit the windows
    (a dimension not a multiple of 8), the spread and gathers take the
    dense separable path.  Concatenated systems (``batch_idx``, with
    ``cell [B, 3, 3]`` and ``alpha`` scalar or ``[B]``) take the scatter
    path of ``spline.py``.

    The parameters are the JAX package's, in its order.  ``fft_mode``,
    ``spread_engine`` / ``gather_engine``: see :func:`_check_pme_knobs`.
    """
    _check_pme_knobs(fft_mode, spread_engine, gather_engine)
    dtype, device = positions.dtype, positions.device
    cell_b = upload(cell, device, dtype, "pme_cell").reshape(-1, 3, 3)
    alpha_b = torch.broadcast_to(upload(alpha, device, dtype,
                                        "pme_alpha").reshape(-1),
                                 (cell_b.shape[0],))
    mesh_dimensions = _mesh_dims(cell_b, alpha_b, mesh_dimensions,
                                 mesh_spacing, accuracy)
    if batch_idx is not None:
        out = _batch_idx_pme(positions, charges, cell_b, alpha_b,
                             mesh_dimensions, spline_order, batch_idx,
                             compute_forces, compute_charge_gradients,
                             k_squared, fft_mode)
        return returns(*out)
    n = positions.shape[0]
    cell = cell_b[0]
    alpha = alpha_b[0]
    if k_squared is None:
        _, k_squared = generate_k_vectors_pme(cell, mesh_dimensions)
    k_squared = k_squared.reshape(tuple(k_squared.shape[-3:]))
    if sw.windowed_applicable(mesh_dimensions, spline_order):
        cap = tile_capacity or sw.mesh_tile_capacity(n, mesh_dimensions)
        with span("pme.tiles"):
            tiles = sw.build_mesh_tiles(positions, cell, mesh_dimensions,
                                        spline_order, cap,
                                        need_grad=compute_forces)
            with host_read("pme_tile_cap", device):
                fits = int(tiles.counts_max) <= cap
        if fits:
            return returns(*_windowed_pme(
                tiles, charges, cell, alpha, spline_order, compute_forces,
                compute_charge_gradients, k_squared, fft_mode))
    return returns(*_dense_pme_single(
        positions, charges, cell, alpha, mesh_dimensions, spline_order,
        compute_forces, compute_charge_gradients, k_squared, fft_mode))


def particle_mesh_ewald(
    positions,
    charges,
    cell,
    alpha=None,
    mesh_spacing=None,
    mesh_dimensions=None,
    spline_order: int = 4,
    batch_idx=None,
    k_vectors=None,
    k_squared=None,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    mask_value: int | None = None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    accuracy: float = 1e-6,
):
    """Full PME: the real space over the neighbor data
    (:func:`ewald.ewald_real_space`) plus :func:`pme_reciprocal_space`.
    ``alpha`` defaults to the Kolafa-Perram estimate; the mesh as in
    :func:`pme_reciprocal_space`.  Per-atom energies, in the return
    patterns of :func:`pme_reciprocal_space`."""
    dtype, device = positions.dtype, positions.device
    cell_b = torch.as_tensor(cell, dtype=dtype, device=device).reshape(
        -1, 3, 3)
    if mask_value is None:
        mask_value = positions.shape[0]
    if alpha is None:
        alpha = estimate_ewald_parameters(positions, cell_b, batch_idx,
                                          accuracy).alpha
    alpha_arr = torch.as_tensor(alpha, dtype=dtype, device=device).reshape(
        -1)
    mesh_dimensions = _mesh_dims(cell_b, alpha_arr, mesh_dimensions,
                                 mesh_spacing, accuracy)
    rs = ewald_real_space(
        positions, charges, cell_b, alpha_arr,
        neighbor_list=neighbor_list, neighbor_ptr=neighbor_ptr,
        neighbor_shifts=neighbor_shifts, neighbor_matrix=neighbor_matrix,
        neighbor_matrix_shifts=neighbor_matrix_shifts,
        mask_value=mask_value, batch_idx=batch_idx,
        compute_forces=compute_forces,
        compute_charge_gradients=compute_charge_gradients)
    rec = pme_reciprocal_space(
        positions, charges, cell_b, alpha_arr,
        mesh_dimensions=mesh_dimensions, spline_order=spline_order,
        batch_idx=batch_idx, compute_forces=compute_forces,
        compute_charge_gradients=compute_charge_gradients,
        k_vectors=k_vectors, k_squared=k_squared)
    if compute_forces or compute_charge_gradients:
        return tuple(a + b for a, b in zip(rs, rec))
    return rs + rec


def batch_pme_reciprocal(positions, charges, cells, alpha, mesh_dimensions,
                         spline_order: int = 4, compute_forces: bool = False,
                         tile_capacity: int | None = None,
                         fft_mode: str = "auto",
                         compute_charge_gradients: bool = False,
                         engine: str = "auto",
                         spread_engine: str = "xla",
                         gather_engine: str = "xla",
                         tile: int | None = None):
    """Batched reciprocal-space PME on uniform ``[B, n, 3]`` system stacks.

    ``engine``: ``"dense"`` (the separable-spline kernels over the whole
    batch at once), ``"windowed"`` (the tile-windowed pipeline per system,
    on tiles of ``tile`` mesh points; by default 16 for small meshes when
    no ``tile_capacity`` is given, else 8), or ``"auto"``: dense for
    per-system meshes up to ``DENSE_MESH_MAX_POINTS``, windowed above.
    ``alpha`` scalar or ``[B]``; ``cells`` ``[3, 3]`` shared or ``[B, 3,
    3]``.  Returns per-atom energies ``[B, n]``, plus forces ``[B, n, 3]``
    and/or ``d(sum E)/dq [B, n]``, in the return patterns of
    :func:`pme_reciprocal_space`.  The parameters are the JAX package's,
    in its order: ``fft_mode="auto"`` convolves with ``torch.fft`` (the
    JAX package picks its matrix-unit DFT for meshes up to 32^3, a choice
    for the TPU); ``"matmul"`` takes the matrix-product DFT, ``"xla"``
    ``torch.fft``; ``spread_engine`` / ``gather_engine``: see
    :func:`_check_pme_knobs`.
    """
    _check_pme_knobs(fft_mode, spread_engine, gather_engine,
                     ("auto", "xla", "matmul"))
    mesh_dimensions = tuple(int(d) for d in mesh_dimensions)
    if tile is None:
        # small meshes: 16-point tiles (the JAX package's rule, fit on the
        # TPU)
        ntiles8 = math.prod(d // 8 for d in mesh_dimensions)
        tile = (16 if (tile_capacity is None and ntiles8 <= 512
                       and all(d % 16 == 0 for d in mesh_dimensions))
                else 8)
    if not sw.windowed_applicable(mesh_dimensions, spline_order, tile=tile):
        raise ValueError(
            f"mesh {mesh_dimensions} / order {spline_order} not supported "
            "by the batched path")
    b, n = positions.shape[0], positions.shape[1]
    dtype, device = positions.dtype, positions.device
    cells = torch.as_tensor(cells, dtype=dtype, device=device)
    if cells.dim() == 2:
        cells = cells.expand(b, 3, 3)
    cells = cells.contiguous()
    alphas = torch.broadcast_to(torch.as_tensor(
        alpha, dtype=dtype, device=device).reshape(-1), (b,))
    charges = torch.as_tensor(charges, dtype=dtype,
                              device=device).contiguous()
    fft_mode = "matmul" if fft_mode == "matmul" else "xla"
    if engine == "auto":
        engine = ("dense" if math.prod(mesh_dimensions)
                  <= DENSE_MESH_MAX_POINTS else "windowed")
    if engine == "dense":
        out = _batch_dense_pme_impl(
            positions, charges, cells, alphas, mesh_dimensions,
            int(spline_order), bool(compute_forces),
            bool(compute_charge_gradients), fft_mode=fft_mode)
    elif engine == "windowed":
        cap = tile_capacity or sw.mesh_tile_capacity(n, mesh_dimensions,
                                                     tile=tile)
        out = _batch_windowed_pme_impl(
            positions, charges, cells, alphas, mesh_dimensions,
            int(spline_order), int(cap), bool(compute_forces),
            bool(compute_charge_gradients), tile=tile, fft_mode=fft_mode)
    else:
        raise ValueError(f"unknown batched PME engine {engine!r}; one of "
                         "'auto', 'dense', 'windowed'")
    return returns(*out)


def grid_particle_mesh_ewald(grid, positions, charges, cell, cutoff,
                             alpha=None, mesh_dimensions=None,
                             spline_order: int = 4, accuracy: float = 1e-6,
                             tile_capacity: int | None = None,
                             fft_mode: str = "xla"):
    """Full PME at scale: the erfc-damped real space on the halo grid
    (``grid.grid_coulomb_energy_forces``, the window engine) plus the
    tile-windowed reciprocal space.  ``grid`` must have been built from
    ``positions`` with a radius of at least ``cutoff``.  ``alpha``
    defaults to ``sqrt(-ln(accuracy)) / cutoff``; the mesh to the accuracy
    estimate.  Returns per-atom ``(energies, forces)``."""
    dtype = positions.dtype
    cell_b = torch.as_tensor(cell, dtype=dtype,
                             device=positions.device).reshape(-1, 3, 3)
    if alpha is None:
        alpha = math.sqrt(-math.log(accuracy)) / float(cutoff)
    alpha_f = float(torch.as_tensor(alpha).reshape(()))
    if mesh_dimensions is None:
        mesh_dimensions = estimate_pme_mesh_dimensions(cell_b, [alpha_f],
                                                       accuracy)
    e_real, f_real = grid_coulomb_energy_forces(grid, charges, float(cutoff),
                                                alpha_f)
    e_rec, f_rec = pme_reciprocal_space(
        positions, charges, cell_b, alpha_f,
        mesh_dimensions=mesh_dimensions, spline_order=spline_order,
        compute_forces=True, tile_capacity=tile_capacity, fft_mode=fft_mode)
    return e_real + e_rec, f_real + f_rec
