# SPDX-License-Identifier: Apache-2.0
"""The port's list/matrix electrostatics against the JAX package's, on the
CPU: Coulomb (list and matrix, single and ``batch_idx``), Ewald, the
parameter estimators, the ``batch_idx`` spline path, PME with
``batch_idx`` / ``mesh_spacing`` / ``accuracy`` and the full PME entry
points.

f64 outputs are held at 1e-10 of each output's scale, integer outputs
exactly; one f32 case per entry point at 1.25x the JAX package's own
f32-vs-f64 error; autograd forces equal the analytic ones, and cell
gradients equal ``jax.grad``.  Neighbor matrices come from the JAX package
(as numpy), so each entry point is compared on identical pairs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvalchemiops_tpu.interactions.electrostatics as je
import nvalchemiops_tpu.neighborlist as jnl
import nvalchemiops_torch.interactions.electrostatics as te
from nvalchemiops_tpu import grid as jgrid
from nvalchemiops_tpu import spline as jspline
from nvalchemiops_tpu.interactions.electrostatics import coulomb as jcoul
from nvalchemiops_tpu.interactions.electrostatics.k_vectors import (
    _miller_ranges,
)
from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch import spline as tspline
from nvalchemiops_torch.interactions.electrostatics import coulomb as tcoul

from tests._torch_port import assert_close, port_grid

F64 = torch.float64
RTOL = 1e-10
CUTOFF = 5.0
ALPHA = 0.4
BOXES = (9.0, 10.0, 11.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _system(kind):
    """``dict`` of numpy inputs: ``single`` is 120 atoms in a triclinic
    10 A cell, ``batch`` three neutral systems of 40 atoms in cubic boxes
    of 9, 10 and 11 A, each with its JAX neighbor matrix (``CUTOFF``) and
    COO list."""
    rng = np.random.default_rng({"single": 21, "batch": 22}[kind])
    if kind == "single":
        cell = np.eye(3) * 10.0
        cell[0, 1], cell[1, 2] = 0.5, -0.3
        pos = rng.uniform(0, 1, (120, 3)) @ cell
        q = rng.normal(size=120)
        q -= q.mean()
        bidx = None
    else:
        pos = np.concatenate([rng.uniform(0, b, (40, 3)) for b in BOXES])
        q = rng.normal(size=(3, 40))
        q = (q - q.mean(1, keepdims=True)).reshape(-1)
        cell = np.stack([np.eye(3) * b for b in BOXES])
        bidx = np.repeat(np.arange(3), 40).astype(np.int32)
    extra = {} if bidx is None else {"batch_idx": jnp.asarray(bidx)}
    pbc = np.array([True] * 3)
    if bidx is not None:
        pbc = np.broadcast_to(pbc, (3, 3))
    nm, num, sh = (np.asarray(a) for a in jnl.neighbor_list(
        jnp.asarray(pos), CUTOFF, cell=jnp.asarray(cell), pbc=pbc,
        max_neighbors=128, **extra))
    lst, ptr, lsh = (np.asarray(a) for a in jnl.neighbor_list(
        jnp.asarray(pos), CUTOFF, cell=jnp.asarray(cell), pbc=pbc,
        max_neighbors=128, return_neighbor_list=True, **extra))
    return dict(pos=pos, q=q, cell=cell, bidx=bidx, nm=nm, sh=sh, lst=lst,
                ptr=ptr, lsh=lsh)


def _args(kind, pkg, dtype=np.float64):
    """``(positions, charges, cell)`` and the neighbor keywords of one
    package (``form``: ``"matrix"`` or ``"list"``) for :func:`_system`."""
    s = _system(kind)
    if pkg == "jax":
        conv, iconv = (lambda a: jnp.asarray(a, dtype)), jnp.asarray
    else:
        tdt = {np.float64: F64, np.float32: torch.float32}[dtype]

        def conv(a):
            return torch.as_tensor(np.asarray(a, dtype), dtype=tdt)

        def iconv(a):
            return torch.as_tensor(np.array(a))

    base = (conv(s["pos"]), conv(s["q"]), conv(s["cell"]))
    matrix = dict(neighbor_matrix=iconv(s["nm"]),
                  neighbor_matrix_shifts=iconv(s["sh"]))
    listed = dict(neighbor_list=iconv(s["lst"]), neighbor_ptr=iconv(s["ptr"]),
                  neighbor_shifts=iconv(s["lsh"]))
    bidx = None if s["bidx"] is None else iconv(s["bidx"])
    return base, matrix, listed, bidx


def _close(out, ref, rtol=RTOL):
    if isinstance(ref, (tuple, list)):
        assert isinstance(out, tuple) and len(out) == len(ref)
        for o, r in zip(out, ref):
            _close(o, r, rtol)
        return
    assert isinstance(out, torch.Tensor)
    assert_close(out, np.asarray(ref), rtol=rtol)


def _err(a, ref):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    r = np.asarray(ref, np.float64)
    return np.abs(a - r).max() / np.abs(r).max()


def _f32_within_jax_bar(call):
    """``call(pkg, dtype)`` in both packages: the port's f32 error against
    JAX f64 within 1.25x JAX's own f32 error, output by output."""
    ref = call("jax", np.float64)
    j32 = call("jax", np.float32)
    t32 = call("torch", np.float32)
    ref, j32, t32 = ((x,) if not isinstance(x, tuple) else x
                     for x in (ref, j32, t32))
    for r, j, t in zip(ref, j32, t32):
        assert t.dtype == torch.float32
        bar = 1.25 * _err(j, r)
        assert 0.0 < _err(t, r) <= bar, (_err(t, r), bar)


# ---------------------------------------------------------------------------
# Coulomb
# ---------------------------------------------------------------------------


COULOMB = ["coulomb_energy", "coulomb_energy_forces", "coulomb_forces",
           "coulomb_charge_gradients"]


@pytest.mark.parametrize("kind", ["single", "batch"])
@pytest.mark.parametrize("form", ["matrix", "list"])
@pytest.mark.parametrize("alpha", [0.0, ALPHA])
@pytest.mark.parametrize("fn", COULOMB)
def test_coulomb_matches_jax(kind, form, alpha, fn):
    outs = []
    for pkg, mod in (("jax", jcoul), ("torch", tcoul)):
        base, matrix, listed, bidx = _args(kind, pkg)
        kw = matrix if form == "matrix" else listed
        outs.append(getattr(mod, fn)(*base, 4.5, alpha, **kw,
                                     batch_idx=bidx))
    _close(outs[1], outs[0])


def test_coulomb_f32_within_jax_bar():
    def call(pkg, dtype):
        base, matrix, _, _ = _args("single", pkg, dtype)
        mod = jcoul if pkg == "jax" else tcoul
        return mod.coulomb_energy_forces(*base, 4.5, ALPHA, **matrix)

    _f32_within_jax_bar(call)


def test_coulomb_needs_one_neighbor_format():
    base, matrix, listed, _ = _args("single", "torch")
    with pytest.raises(ValueError, match="exactly one"):
        te.coulomb_energy(*base, 4.5, **matrix, **listed)
    with pytest.raises(ValueError, match="exactly one"):
        te.coulomb_energy(*base, 4.5)


# ---------------------------------------------------------------------------
# Ewald
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["single", "batch"])
@pytest.mark.parametrize("form", ["matrix", "list"])
@pytest.mark.parametrize("outputs", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_ewald_real_space_matches_jax(kind, form, outputs):
    alpha = [0.3, 0.35, 0.4] if kind == "batch" else ALPHA
    outs = []
    for pkg, mod in (("jax", je), ("torch", te)):
        base, matrix, listed, bidx = _args(kind, pkg)
        a = jnp.asarray(alpha) if pkg == "jax" else torch.tensor(alpha, dtype=F64)
        outs.append(mod.ewald_real_space(
            *base, a, **(matrix if form == "matrix" else listed),
            batch_idx=bidx, compute_forces=outputs[0],
            compute_charge_gradients=outputs[1]))
    _close(outs[1], outs[0])


def _kvecs(pkg, kind, cell):
    mod = je if pkg == "jax" else te
    return mod.generate_k_vectors_ewald_summation(cell, 4.0)


@pytest.mark.parametrize("kind", ["single", "batch"])
@pytest.mark.parametrize("outputs", [(False, False), (True, True)])
def test_ewald_reciprocal_space_matches_jax(kind, outputs):
    alpha = [0.3, 0.35, 0.4] if kind == "batch" else ALPHA
    outs = []
    for pkg, mod in (("jax", je), ("torch", te)):
        base, _, _, bidx = _args(kind, pkg)
        a = jnp.asarray(alpha) if pkg == "jax" else torch.tensor(alpha, dtype=F64)
        outs.append(mod.ewald_reciprocal_space(
            *base, _kvecs(pkg, kind, base[2]), a, batch_idx=bidx,
            compute_forces=outputs[0], compute_charge_gradients=outputs[1]))
    _close(outs[1], outs[0])


@pytest.mark.parametrize("kind", ["single", "batch"])
@pytest.mark.parametrize("given", [False, True])
def test_ewald_summation_matches_jax(kind, given):
    """Estimated alpha and k-vectors, or given ones (``k_cutoff``)."""
    outs = []
    for pkg, mod in (("jax", je), ("torch", te)):
        base, matrix, _, bidx = _args(kind, pkg)
        kw = dict(alpha=0.45, k_cutoff=4.5) if given else {}
        outs.append(mod.ewald_summation(*base, batch_idx=bidx, **matrix,
                                        compute_forces=True, **kw))
        outs.append(mod.ewald_summation(*base, batch_idx=bidx, **matrix,
                                        **kw))
    _close(outs[2], outs[0])
    _close(outs[3], outs[1])


def test_ewald_f32_within_jax_bar():
    def real(pkg, dtype):
        base, matrix, _, _ = _args("single", pkg, dtype)
        mod = je if pkg == "jax" else te
        return mod.ewald_real_space(*base, ALPHA, **matrix,
                                    compute_forces=True)

    def recip(pkg, dtype):
        base, _, _, bidx = _args("batch", pkg, dtype)
        mod = je if pkg == "jax" else te
        return mod.ewald_reciprocal_space(
            *base, mod.generate_k_vectors_ewald_summation(base[2], 4.0),
            ALPHA, batch_idx=bidx, compute_forces=True)

    def full(pkg, dtype):
        base, matrix, _, _ = _args("single", pkg, dtype)
        mod = je if pkg == "jax" else te
        return mod.ewald_summation(*base, **matrix, compute_forces=True)

    for call in (real, recip, full):
        _f32_within_jax_bar(call)


# ---------------------------------------------------------------------------
# Parameters and k-vectors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["single", "batch"])
def test_parameter_estimators_match_jax(kind):
    jb, _, _, jbidx = _args(kind, "jax")
    tb, _, _, tbidx = _args(kind, "torch")
    for acc in (1e-4, 1e-6):
        jp = je.estimate_ewald_parameters(jb[0], jb[2], jbidx, acc)
        tp = te.estimate_ewald_parameters(tb[0], tb[2], tbidx, acc)
        for f in ("alpha", "real_space_cutoff", "reciprocal_space_cutoff"):
            _close(getattr(tp, f), getattr(jp, f), rtol=1e-14)
        assert te.estimate_pme_mesh_dimensions(tb[2], tp.alpha, acc) == \
            je.estimate_pme_mesh_dimensions(jb[2], jp.alpha, acc)
        jpp = je.estimate_pme_parameters(jb[0], jb[2], jbidx, acc)
        tpp = te.estimate_pme_parameters(tb[0], tb[2], tbidx, acc)
        assert isinstance(tpp, te.PMEParameters)
        assert tpp.mesh_dimensions == jpp.mesh_dimensions
        for f in ("alpha", "mesh_spacing", "real_space_cutoff"):
            _close(getattr(tpp, f), getattr(jpp, f), rtol=1e-14)
    assert isinstance(tp, te.EwaldParameters)
    b = 1 if kind == "single" else 3
    for spacing in (0.7, np.full(b, 0.9), np.full((b, 3), 1.1)):
        assert te.mesh_spacing_to_dimensions(tb[2], spacing) == \
            je.mesh_spacing_to_dimensions(jb[2], spacing)
    with pytest.raises(ValueError):
        te.mesh_spacing_to_dimensions(tb[2], np.full(b + 1, 0.9))


@pytest.mark.parametrize("kind", ["single", "batch"])
def test_ewald_k_vectors_match_jax(kind):
    jc, tc = _args(kind, "jax")[0][2], _args(kind, "torch")[0][2]
    for k_cutoff, max_hkl in ((4.0, None), (6.0, None), (4.0, (2, 3, 1))):
        ref = np.asarray(je.generate_k_vectors_ewald_summation(
            jc, k_cutoff, max_hkl=max_hkl))
        out = te.generate_k_vectors_ewald_summation(tc, k_cutoff,
                                                    max_hkl=max_hkl)
        assert out.shape == ref.shape
        np.testing.assert_array_equal(out.numpy(), ref)


# ---------------------------------------------------------------------------
# Splines with batch_idx, PME
# ---------------------------------------------------------------------------


MESH = (16, 16, 16)


@pytest.mark.parametrize("kind,mesh,order", [
    ("batch", MESH, 4), ("batch", (12,) * 3, 4), ("batch", MESH, 1),
    ("batch", MESH, 2), ("batch", MESH, 3), ("single", MESH, 4),
    ("single", (12, 12, 12), 4)])
def test_spline_spread_and_gathers_match_jax(kind, mesh, order):
    """``batch_idx``: the scatter path (its local-form weights at every
    order); one system: the windowed route (16^3) and the dense one
    (12^3)."""
    outs = []
    for pkg, mod in (("jax", jspline), ("torch", tspline)):
        (pos, q, cell), _, _, bidx = _args(kind, pkg)
        spread = mod.spline_spread(pos, q, cell, mesh, order, batch_idx=bidx)
        gathered = mod.spline_gather(pos, spread, cell, order,
                                     batch_idx=bidx)
        grad = mod.spline_gather_gradient(pos, q, spread, cell, order,
                                          batch_idx=bidx)
        outs.append((spread, gathered, grad))
    assert tuple(outs[1][0].shape) == tuple(outs[0][0].shape)
    _close(outs[1], outs[0])


@pytest.mark.parametrize("mesh_kw", [dict(mesh_dimensions=MESH),
                                     dict(mesh_spacing=0.8),
                                     dict(accuracy=1e-4)])
@pytest.mark.parametrize("kind", ["single", "batch"])
def test_pme_reciprocal_space_matches_jax(kind, mesh_kw):
    alpha = [0.3, 0.35, 0.4] if kind == "batch" else ALPHA
    outs = []
    for pkg, mod in (("jax", je), ("torch", te)):
        base, _, _, bidx = _args(kind, pkg)
        a = jnp.asarray(alpha) if pkg == "jax" else torch.tensor(alpha, dtype=F64)
        outs.append(mod.pme_reciprocal_space(
            *base, a, batch_idx=bidx, compute_forces=True,
            compute_charge_gradients=True, **mesh_kw))
    _close(outs[1], outs[0])


def test_pme_mesh_off_the_windows_takes_the_dense_route():
    """A 12^3 mesh (not a multiple of 8) for one system: the dense
    separable path, as the JAX package's dense branch."""
    outs = []
    for pkg, mod in (("jax", je), ("torch", te)):
        base, _, _, _ = _args("single", pkg)
        outs.append(mod.pme_reciprocal_space(*base, ALPHA, (12, 12, 12),
                                             compute_forces=True))
    _close(outs[1], outs[0])


@pytest.mark.parametrize("kind", ["single", "batch"])
@pytest.mark.parametrize("outputs", [(False, False), (True, True)])
def test_particle_mesh_ewald_matches_jax(kind, outputs):
    outs = []
    for pkg, mod in (("jax", je), ("torch", te)):
        base, matrix, _, bidx = _args(kind, pkg)
        outs.append(mod.particle_mesh_ewald(
            *base, mesh_dimensions=MESH, batch_idx=bidx, **matrix,
            compute_forces=outputs[0], compute_charge_gradients=outputs[1]))
    _close(outs[1], outs[0])


def test_particle_mesh_ewald_estimates_alpha_and_mesh():
    outs = []
    for pkg, mod in (("jax", je), ("torch", te)):
        base, matrix, _, bidx = _args("batch", pkg)
        outs.append(mod.particle_mesh_ewald(*base, batch_idx=bidx, **matrix,
                                            compute_forces=True,
                                            accuracy=1e-4))
    _close(outs[1], outs[0])


def test_pme_f32_within_jax_bar():
    """On concatenated systems (``batch_idx``): the scatter path, whose
    stencil weights are the local forms of ``spline._stencil``."""
    def recip(pkg, dtype):
        base, _, _, bidx = _args("batch", pkg, dtype)
        mod = je if pkg == "jax" else te
        return mod.pme_reciprocal_space(*base, ALPHA, MESH, batch_idx=bidx,
                                        compute_forces=True)

    def full(pkg, dtype):
        base, matrix, _, bidx = _args("batch", pkg, dtype)
        mod = je if pkg == "jax" else te
        return mod.particle_mesh_ewald(*base, ALPHA, mesh_dimensions=MESH,
                                       batch_idx=bidx, **matrix,
                                       compute_forces=True)

    for call in (recip, full):
        _f32_within_jax_bar(call)


def test_grid_particle_mesh_ewald_matches_jax():
    """The halo-grid real space (JAX xla engine; the port's window engine
    on its plain version here) plus the windowed reciprocal space."""
    s = _system("single")
    pbc = np.array([True] * 3)
    dims, radius, cap = jgrid.estimate_grid_geometry(
        s["cell"], pbc, CUTOFF, 120, target_occupancy=0.4)
    g = jgrid.build_atom_grid(jnp.asarray(s["pos"]), jnp.asarray(s["cell"]),
                              pbc, dims, radius, cap)
    ref = je.grid_particle_mesh_ewald(
        g, jnp.asarray(s["pos"]), jnp.asarray(s["q"]),
        jnp.asarray(s["cell"]), CUTOFF, mesh_dimensions=MESH)
    out = te.grid_particle_mesh_ewald(
        port_grid(g), torch.as_tensor(s["pos"]), torch.as_tensor(s["q"]),
        torch.as_tensor(s["cell"]), CUTOFF, mesh_dimensions=MESH)
    _close(out, ref, rtol=1e-9)
    tg = tgrid.build_atom_grid(torch.as_tensor(s["pos"]),
                               torch.as_tensor(s["cell"]), pbc, dims, radius,
                               cap)
    _close(te.grid_particle_mesh_ewald(
        tg, torch.as_tensor(s["pos"]), torch.as_tensor(s["q"]),
        torch.as_tensor(s["cell"]), CUTOFF, mesh_dimensions=MESH), ref,
        rtol=1e-9)


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


def _energy(term, pos, compute_forces=False):
    """Per-atom energies (and forces) of one term on the single system."""
    (_, q, cell), matrix, _, _ = _args("single", "torch")
    kv = te.generate_k_vectors_ewald_summation(cell, 4.0)
    if term == "coulomb":
        if compute_forces:
            return te.coulomb_energy_forces(pos, q, cell, 4.5, ALPHA,
                                            **matrix)
        return te.coulomb_energy(pos, q, cell, 4.5, ALPHA, **matrix)
    if term == "ewald_real":
        return te.ewald_real_space(pos, q, cell, ALPHA, **matrix,
                                   compute_forces=compute_forces)
    if term == "ewald_recip":
        return te.ewald_reciprocal_space(pos, q, cell, kv, ALPHA,
                                         compute_forces=compute_forces)
    return te.ewald_summation(pos, q, cell, ALPHA, kv, **matrix,
                              compute_forces=compute_forces)


@pytest.mark.parametrize("term", ["coulomb", "ewald_real", "ewald_recip",
                                  "ewald_summation"])
def test_autograd_forces_equal_analytic(term):
    """``-dE/dr`` by autograd equals the analytic forces."""
    pos = _args("single", "torch")[0][0].clone().requires_grad_(True)
    _energy(term, pos).sum().backward()
    _, forces = _energy(term, pos.detach(), compute_forces=True)
    assert_close(-pos.grad, forces, rtol=1e-10)


def _cell_grad_case():
    """``tests/interactions/electrostatics/test_cell_gradients.py``'s
    slightly triclinic 12-atom crystal."""
    rng = np.random.default_rng(3)
    a = 4.5
    pos = rng.uniform(0, a, (12, 3))
    q = rng.normal(size=12)
    q -= q.mean()
    cell = np.eye(3) * a
    cell[0, 1], cell[1, 2] = 0.3, -0.2
    nm, _, sh = jnl.naive_neighbor_list(
        jnp.asarray(pos), 4.3, pbc=np.array([True] * 3),
        cell=jnp.asarray(cell), max_neighbors=128)
    return pos, q, cell, np.asarray(nm), np.asarray(sh)


@pytest.mark.parametrize("term", ["coulomb_energy", "ewald_real_space",
                                  "ewald_reciprocal_space"])
def test_cell_gradient_equals_jax_grad(term):
    pos, q, cell, nm, sh = _cell_grad_case()
    max_hkl = _miller_ranges(jnp.asarray(cell).reshape(1, 3, 3), 9.0)

    def energy(mod, c, conv, iconv):
        p, qq = conv(pos), conv(q)
        m = dict(neighbor_matrix=iconv(np.array(nm)),
                 neighbor_matrix_shifts=iconv(np.array(sh)))
        if term == "coulomb_energy":
            return mod.coulomb_energy(p, qq, c, 3.8, alpha=0.7, **m).sum()
        if term == "ewald_real_space":
            return mod.ewald_real_space(p, qq, c, 0.9, **m,
                                        cutoff=3.8).sum()
        kv = mod.generate_k_vectors_ewald_summation(c, 9.0, max_hkl=max_hkl)
        return mod.ewald_reciprocal_space(p, qq, c, kv, 0.9).sum()

    ref = np.asarray(jax.grad(lambda c: energy(
        je, c, jnp.asarray, jnp.asarray))(jnp.asarray(cell)))
    c_t = torch.as_tensor(cell).clone().requires_grad_(True)
    energy(te, c_t, torch.as_tensor, torch.as_tensor).backward()
    assert np.abs(ref).max() > 1e-6
    assert_close(c_t.grad, ref, rtol=1e-10)
