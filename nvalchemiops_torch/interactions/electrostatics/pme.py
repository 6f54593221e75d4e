# SPDX-License-Identifier: Apache-2.0
"""PME reciprocal-space electrostatics (counterpart of
``nvalchemiops_tpu.interactions.electrostatics.pme``): one system, and
uniform batches of systems.

Pipeline: spread the charges (tile-windowed or dense separable spline) ->
``torch.fft.rfftn`` -> divide by the B-spline dealiasing factor, multiply
by the Green's function -> ``irfftn`` -> gather the potential and its
spline-derivative gradient at the atoms -> self/background corrections.
Forces are the analytic gradient of the discrete energy (one inverse FFT),
with the mesh-accuracy net force removed per system.

Two spline engines, each on its CUDA kernels:

- tile-windowed (``spline_windowed.py``, kernels/windowed_gather.py): the
  single-system default, and ``batch_pme_reciprocal(engine="windowed")``;
- dense separable (``spline.py`` dense path, kernels/separable_spline.py):
  ``batch_pme_reciprocal(engine="dense")`` (auto for meshes up to 32^3, a
  TPU-fit gate kept as the default) and the fallback of
  :func:`pme_reciprocal_space` when a mesh tile holds more atoms than its
  capacity.

Conventions as in the JAX package: ``G(k) = 2 pi exp(-k^2/(4 alpha^2)) /
(V k^2)``, dealiasing ``[sinc(mx/nx) sinc(my/ny) sinc(mz/nz)]^order``
squared, unscaled forward and inverse transforms, and ``E_i -= (alpha /
sqrt(pi)) q_i^2 + (pi / (2 alpha^2 V)) q_i Q``.  A mesh the windowed path
does not support raises ``NotImplementedError`` in
:func:`pme_reciprocal_space` (the JAX package's scatter-add path is a
ROADMAP item).
"""

from __future__ import annotations

import math

import torch

from nvalchemiops_torch import spline_windowed as sw
from nvalchemiops_torch.interactions.electrostatics.k_vectors import (
    generate_k_vectors_pme,
)
from nvalchemiops_torch.kernels.separable_spline import (
    separable_gather,
    separable_spread,
)
from nvalchemiops_torch.mathops.math import (
    apply_mat3_batched, sinc_normalized,
)
from nvalchemiops_torch.spline import _stencil

__all__ = ["pme_green_structure_factor", "pme_reciprocal_space",
           "batch_pme_reciprocal"]

TWOPI = 2.0 * math.pi
SQRT_PI = math.sqrt(math.pi)

#: per-system mesh points up to which ``batch_pme_reciprocal(engine=
#: "auto")`` takes the dense engine (fit on the TPU; kept so both packages
#: route alike, ROADMAP item 15)
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
               k_squared=None):
    """Convolve charge meshes ``[.., nx, ny, nz]`` with the Green's
    function; returns the potential meshes (contiguous)."""
    if k_squared is None:
        _, k_squared = generate_k_vectors_pme(cell, mesh_dimensions)
    green, sf_sq = pme_green_structure_factor(k_squared, mesh_dimensions,
                                              alpha, cell, spline_order)
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


def _returns(energies, forces, charge_grads):
    """The four return patterns of the JAX package."""
    if forces is not None and charge_grads is not None:
        return energies, forces, charge_grads
    if forces is not None:
        return energies, forces
    if charge_grads is not None:
        return energies, charge_grads
    return energies


def _windowed_pme(tiles, charges, cell, alpha, spline_order: int,
                  compute_forces: bool, compute_charge_gradients: bool,
                  k_squared=None):
    """One system through the tile-windowed pipeline on built tiles."""
    mesh = sw.windowed_spread(tiles, charges)
    potential = _potential(mesh, cell, alpha, tiles.mesh_dims, spline_order,
                           k_squared)
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
                         tile: int = 8):
    """One system through the tile-windowed pipeline.  Raises when a tile
    holds more than ``cap`` atoms (the JAX package's lean version drops
    them silently)."""
    tiles = sw.build_mesh_tiles(positions, cell, mesh_dimensions,
                                spline_order, cap, tile=tile,
                                need_grad=compute_forces)
    counts_max = int(tiles.counts_max)
    if counts_max > cap:
        raise ValueError(f"PME mesh tile overflow: {counts_max} atoms in one "
                         f"tile, capacity {cap}; pass a larger tile_capacity")
    return _windowed_pme(tiles, charges, cell, alpha, spline_order,
                         compute_forces, compute_charge_gradients)


def _batch_windowed_pme_impl(positions, charges, cells, alphas,
                             mesh_dimensions, spline_order: int, cap: int,
                             compute_forces: bool,
                             compute_charge_gradients: bool = False,
                             tile: int = 8):
    """The windowed pipeline per system, stacked (``[B, ..]`` outputs)."""
    outs = [_windowed_pme_single(positions[b], charges[b], cells[b],
                                 alphas[b], mesh_dimensions, spline_order,
                                 cap, compute_forces,
                                 compute_charge_gradients, tile=tile)
            for b in range(positions.shape[0])]
    return tuple(None if o[0] is None else torch.stack(o)
                 for o in zip(*outs))


def _batch_dense_pme_impl(positions, charges, cells, alphas, mesh_dimensions,
                          spline_order: int, compute_forces: bool,
                          compute_charge_gradients: bool = False,
                          k_squared=None):
    """Systems ``[B, N, 3]`` through the dense separable pipeline: one
    stencil, one spread launch, one batched FFT pair, one gather launch."""
    gidx, w, dw, inv = _stencil(positions, cells, mesh_dimensions,
                                spline_order)
    mesh = separable_spread(gidx, w, charges, mesh_dimensions)
    potential = _potential(mesh, cells, alphas, mesh_dimensions,
                           spline_order, k_squared)
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
                      k_squared=None):
    """One system through the dense separable pipeline."""
    out = _batch_dense_pme_impl(
        positions[None], charges[None], cell[None], alpha, mesh_dimensions,
        spline_order, compute_forces, compute_charge_gradients,
        None if k_squared is None else k_squared[None])
    return tuple(None if o is None else o[0] for o in out)


def pme_reciprocal_space(
    positions,
    charges,
    cell,
    alpha,
    mesh_dimensions,
    spline_order: int = 4,
    k_vectors=None,
    k_squared=None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    tile_capacity: int | None = None,
):
    """FFT-based reciprocal-space PME for one system.

    Return patterns: ``energies``, ``(energies, forces)``,
    ``(energies, charge_grads)``, ``(energies, forces, charge_grads)``.
    ``tile_capacity`` overrides the Poisson-safe tile capacity with an
    observed one (:func:`spline_windowed.observed_tile_capacity`).  When a
    tile holds more atoms than its capacity, the spread and gathers take
    the dense separable path (as the JAX package's fallback does).  Raises
    ``NotImplementedError`` for a mesh the windowed path does not support.
    """
    dtype = positions.dtype
    n = positions.shape[0]
    mesh_dimensions = tuple(int(d) for d in mesh_dimensions)
    cell = torch.as_tensor(cell, dtype=dtype,
                           device=positions.device).reshape(3, 3)
    if not sw.windowed_applicable(mesh_dimensions, spline_order):
        raise NotImplementedError(
            f"mesh {mesh_dimensions} / order {spline_order}: only the "
            "tile-windowed path (every mesh dim a multiple of 8, order <= 4) "
            "is ported; the scatter-add spline path is a ROADMAP item")
    cap = tile_capacity or sw.mesh_tile_capacity(n, mesh_dimensions)
    tiles = sw.build_mesh_tiles(positions, cell, mesh_dimensions,
                                spline_order, cap, need_grad=compute_forces)
    if k_squared is None:
        _, k_squared = generate_k_vectors_pme(cell, mesh_dimensions)
    if int(tiles.counts_max) <= cap:
        out = _windowed_pme(tiles, charges, cell, alpha, spline_order,
                            compute_forces, compute_charge_gradients,
                            k_squared)
    else:
        out = _dense_pme_single(positions, charges, cell, alpha,
                                mesh_dimensions, spline_order,
                                compute_forces, compute_charge_gradients,
                                k_squared)
    return _returns(*out)


def batch_pme_reciprocal(positions, charges, cells, alpha, mesh_dimensions,
                         spline_order: int = 4, compute_forces: bool = False,
                         tile_capacity: int | None = None,
                         compute_charge_gradients: bool = False,
                         engine: str = "auto"):
    """Batched reciprocal-space PME on uniform ``[B, n, 3]`` system stacks.

    ``engine``: ``"dense"`` (the separable-spline kernels over the whole
    batch at once), ``"windowed"`` (the tile-windowed pipeline per system;
    tiles of 16 mesh points for small meshes when no ``tile_capacity`` is
    given, else 8), or ``"auto"``: dense for per-system meshes up to
    ``DENSE_MESH_MAX_POINTS``, windowed above.  ``alpha`` scalar or
    ``[B]``; ``cells`` ``[3, 3]`` shared or ``[B, 3, 3]``.  Returns
    per-atom energies ``[B, n]``, plus forces ``[B, n, 3]`` and/or
    ``d(sum E)/dq [B, n]``, in the return patterns of
    :func:`pme_reciprocal_space`.
    """
    mesh_dimensions = tuple(int(d) for d in mesh_dimensions)
    ntiles8 = math.prod(d // 8 for d in mesh_dimensions)
    # small meshes: 16-point tiles (the JAX package's rule, fit on the TPU)
    tile = (16 if (tile_capacity is None and ntiles8 <= 512
                   and all(d % 16 == 0 for d in mesh_dimensions)) else 8)
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
    if engine == "auto":
        engine = ("dense" if math.prod(mesh_dimensions)
                  <= DENSE_MESH_MAX_POINTS else "windowed")
    if engine == "dense":
        out = _batch_dense_pme_impl(
            positions, charges, cells, alphas, mesh_dimensions,
            int(spline_order), bool(compute_forces),
            bool(compute_charge_gradients))
    elif engine == "windowed":
        cap = tile_capacity or sw.mesh_tile_capacity(n, mesh_dimensions,
                                                     tile=tile)
        out = _batch_windowed_pme_impl(
            positions, charges, cells, alphas, mesh_dimensions,
            int(spline_order), int(cap), bool(compute_forces),
            bool(compute_charge_gradients), tile=tile)
    else:
        raise ValueError(f"unknown batched PME engine {engine!r}; one of "
                         "'auto', 'dense', 'windowed'")
    return _returns(*out)
