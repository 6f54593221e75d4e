# SPDX-License-Identifier: Apache-2.0
"""Shared inputs and JAX-side helpers for the PyTorch-port tests.

Inputs are made with numpy from a seed and handed to both packages; JAX
state crosses over as numpy arrays through ``nvalchemiops_torch.interop``.
"""

import numpy as np
import jax.numpy as jnp
import torch

from nvalchemiops_torch import interop

F64 = torch.float64


def synthetic_tables(seed=17, zmax=4):
    """Random element-structured D3 tables whose reference CNs (0.3-5)
    keep the test systems' CNs off saturation, so dE/dCN is not ~0."""
    rng = np.random.default_rng(seed)
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)),
                          np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    return rcov, r4r2, c6, cna


def random_system(seed, n, box, zmax=4):
    """Uniform random positions, element ids 1..zmax and normal charges."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (n, 3))
    numbers = rng.integers(1, zmax + 1, n).astype(np.int32)
    charges = rng.normal(size=n)
    return pos, np.eye(3) * box, numbers, charges


def grid_fields(g):
    """A JAX AtomGrid's array fields as numpy."""
    return {f: np.asarray(getattr(g, f)) for f in interop.ATOM_GRID_FIELDS}


def port_grid(g, dtype=F64):
    """The port's AtomGrid holding exactly the JAX grid's state."""
    return interop.atom_grid_from_numpy(grid_fields(g), g.dims, g.radius,
                                        g.cap, dtype=dtype, device="cpu")


def jax_d3_planes(g, numbers, rcov, r4r2, c6, cna, cutoff, a1, a2, s8,
                  s6=1.0, k1=16.0, k3=-4.0, skip_chain=False):
    """The JAX xla engine's D3 planes, prepared as ``grid_dftd3`` does.

    ``skip_chain=True``: ``(e, fx, fy, fz, cn, decn)`` after pass 2;
    otherwise ``(e, fx, fy, fz, cn)`` after pass 3.
    """
    from nvalchemiops_tpu.grid import _extend_like, scatter_rows_to_grid
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        _grid_d3_impl, element_c6_mask,
    )

    dtype = g.ext_px.dtype
    numbers = jnp.asarray(numbers, jnp.int32)
    rcov, r4r2, c6, cna = (jnp.asarray(a, dtype) for a in (rcov, r4r2, c6,
                                                          cna))
    zmax1, mesh = rcov.shape[0], cna.shape[1]
    mask = element_c6_mask(c6)
    c6p = jnp.transpose(c6, (0, 2, 1, 3)).reshape(zmax1, mesh, zmax1 * mesh)
    zf, rcov_p, r4r2_p = scatter_rows_to_grid(
        g, (numbers.astype(dtype), rcov[numbers], r4r2[numbers]))
    z_plane = zf.astype(jnp.int32)
    out = _grid_d3_impl(
        g, z_plane, _extend_like(g, z_plane, 0),
        rcov_p, _extend_like(g, rcov_p, 0.0),
        r4r2_p, _extend_like(g, r4r2_p, 0.0),
        cna[numbers], mask.astype(dtype)[numbers], c6p[numbers],
        *(jnp.asarray(v, dtype) for v in (cutoff, a1, a2, s6, s8, k1, k3)),
        g.dims, g.radius, g.cap, int(mesh), int(zmax1), None,
        skip_chain=skip_chain, numbers_a=numbers,
    )
    return tuple(np.asarray(a) for a in out)


def assert_close(actual, desired, rtol, atol_scale=None, err_msg=""):
    """``|a - d| <= rtol * |d| + atol_scale * max|d|`` (atol_scale defaults
    to rtol): a relative check that tolerates entries near zero."""
    a = np.asarray(actual.detach().cpu() if isinstance(actual, torch.Tensor)
                   else actual, dtype=np.float64)
    d = np.asarray(desired, dtype=np.float64)
    scale = float(np.abs(d).max()) if d.size else 0.0
    atol = (rtol if atol_scale is None else atol_scale) * scale
    np.testing.assert_allclose(a, d, rtol=rtol, atol=atol, err_msg=err_msg)
