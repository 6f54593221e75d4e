# SPDX-License-Identifier: Apache-2.0
"""The port's neighbor lists against the JAX package's, f64 on the CPU.

Inputs come from ``numpy.random.default_rng(seed)``; both packages get the
same arrays.  Integer outputs must be equal: ``num_neighbors``, the cell
list artifacts, and each row as a set of ``(j, shift)``.  JAX results are
computed once per module.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvalchemiops_tpu.neighborlist as jnl
import nvalchemiops_torch.neighborlist as tnl
from nvalchemiops_torch import interop

CUTOFF = 3.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PBCS = {"full": [True, True, True], "mixed": [True, False, True],
        "none": [False, False, False]}


@functools.lru_cache(maxsize=None)
def _system(name):
    """``(positions, cell)``: 120 atoms in a triclinic 9 A cell, 30 atoms
    in a 3 A box (smaller than the cutoff: periodic self-images), or three
    systems of 40 atoms in boxes of 8, 9 and 10 A."""
    rng = np.random.default_rng({"tri": 11, "small": 12, "batch": 13}[name])
    if name == "tri":
        cell = np.eye(3) * 9.0
        cell[0, 1], cell[2, 0] = 0.6, -0.4
        frac = rng.uniform(0, 1, (120, 3))
        return frac @ cell, cell
    if name == "small":
        return rng.uniform(0, 3.0, (30, 3)), np.eye(3) * 3.0
    boxes = (8.0, 9.0, 10.0)
    pos = np.concatenate([rng.uniform(0, b, (40, 3)) for b in boxes])
    return pos, np.stack([np.eye(3) * b for b in boxes])


BATCH_IDX = np.repeat(np.arange(3), 40).astype(np.int32)


def _call(pkg, name, pbc, **kw):
    """``neighbor_list`` of one package on a system of :func:`_system`."""
    pos, cell = _system(name)
    pbc = np.array(PBCS[pbc])
    if name == "batch":
        pbc = np.broadcast_to(pbc, (3, 3))
    if pkg == "jax":
        extra = ({"batch_idx": jnp.asarray(BATCH_IDX)} if name == "batch"
                 else {})
        return jnl.neighbor_list(jnp.asarray(pos), kw.pop("cutoff", CUTOFF),
                                 cell=jnp.asarray(cell), pbc=pbc, **extra,
                                 **kw)
    extra = ({"batch_idx": torch.as_tensor(BATCH_IDX)} if name == "batch"
             else {})
    return tnl.neighbor_list(torch.as_tensor(pos), kw.pop("cutoff", CUTOFF),
                             cell=torch.as_tensor(cell), pbc=pbc, **extra,
                             **kw)


@functools.lru_cache(maxsize=None)
def _jax(name, pbc, items):
    return tuple(np.asarray(a) for a in _call("jax", name, pbc,
                                              **dict(items)))


def _rows(nm, sh, fill):
    """Each row as a set of ``(j, shift)`` (``shift`` () without shifts)."""
    nm = np.asarray(nm)
    sh = None if sh is None else np.asarray(sh)
    return [{(int(j),) + (() if sh is None else tuple(int(v) for v in
                                                      sh[i, s]))
             for s, j in enumerate(row) if j != fill}
            for i, row in enumerate(nm)]


def _check_matrix(ref, out, n):
    """Same pattern length, equal counts, equal rows as sets."""
    out = tuple(o.numpy() for o in out)
    assert len(out) == len(ref)
    step = 3 if len(ref) in (3, 6) else 2
    for g in range(0, len(ref), step):
        r, o = ref[g:g + step], out[g:g + step]
        assert o[0].dtype == np.int32 and o[1].dtype == np.int32
        np.testing.assert_array_equal(o[1], r[1])
        sh_r = r[2] if step == 3 else None
        sh_o = o[2] if step == 3 else None
        assert _rows(o[0], sh_o, n) == _rows(r[0], sh_r, n)


CASES = [(m, name, pbc, hf)
         for m in ("naive", "cell_list")
         for name, pbc in (("tri", "full"), ("tri", "mixed"),
                           ("tri", "none"), ("small", "full"))
         for hf in (False, True)]


@pytest.mark.parametrize("method,name,pbc,half_fill", CASES)
def test_single_system_rows_match_jax(method, name, pbc, half_fill):
    kw = (("half_fill", half_fill), ("max_neighbors", 160),
          ("method", method))
    ref = _jax(name, pbc, kw)
    out = _call("torch", name, pbc, **dict(kw))
    _check_matrix(ref, out, _system(name)[0].shape[0])


@pytest.mark.parametrize("method", ["batch_naive", "batch_cell_list"])
@pytest.mark.parametrize("pbc", ["full", "mixed"])
@pytest.mark.parametrize("half_fill", [False, True])
def test_batched_rows_match_jax(method, pbc, half_fill):
    kw = (("half_fill", half_fill), ("max_neighbors", 96),
          ("method", method))
    _check_matrix(_jax("batch", pbc, kw),
                  _call("torch", "batch", pbc, **dict(kw)), 120)


@pytest.mark.parametrize("name,pbc", [("tri", "full"), ("tri", "none"),
                                      ("batch", "full")])
def test_dual_cutoff_matches_jax(name, pbc):
    kw = (("cutoff", 2.5), ("cutoff2", 4.0), ("max_neighbors", 64),
          ("max_neighbors2", 160))
    ref = _jax(name, pbc, kw)
    assert len(ref) == (6 if pbc == "full" else 4)
    _check_matrix(ref, _call("torch", name, pbc, **dict(kw)),
                  _system(name)[0].shape[0])


@pytest.mark.parametrize("method", ["naive", "cell_list", "batch_naive"])
def test_neighbor_list_form_matches_jax(method):
    name = "batch" if method.startswith("batch") else "tri"
    kw = (("max_neighbors", 160), ("method", method),
          ("return_neighbor_list", True))
    ref = _jax(name, "full", kw)
    out = [o.numpy() for o in _call("torch", name, "full", **dict(kw))]
    pairs, ptr, shifts = out
    np.testing.assert_array_equal(ptr, ref[1])
    assert pairs.shape[1] == ptr[-1] == shifts.shape[0]

    def by_row(p, s):
        rows = [set() for _ in range(len(ptr) - 1)]
        for (i, j), sh in zip(p.T, s):
            rows[i].add((int(j),) + tuple(int(v) for v in sh))
        return rows

    assert by_row(pairs, shifts) == by_row(ref[0], ref[2])


def test_dual_cutoff_neighbor_list_form():
    kw = dict(cutoff=2.5, cutoff2=4.0, max_neighbors=64, max_neighbors2=160,
              return_neighbor_list=True)
    out = _call("torch", "tri", "full", **kw)
    full = _call("torch", "tri", "full", cutoff=2.5, cutoff2=4.0,
                 max_neighbors=64, max_neighbors2=160)
    assert len(out) == 6
    for lst, ptr, (nm, num) in ((out[0], out[1], full[:2]),
                                (out[3], out[4], full[3:5])):
        assert lst.shape[1] == int(num.sum()) == int(ptr[-1])


@pytest.mark.parametrize("method", ["naive", "cell_list", "batch_naive",
                                    "batch_cell_list"])
def test_overflow_counts_stay_exact(method):
    """With room for 8 entries a row: counts equal JAX's (exact, above the
    capacity), the kept entries are true neighbors, and
    ``assert_max_neighbors`` raises."""
    name = "batch" if method.startswith("batch") else "tri"
    n = _system(name)[0].shape[0]
    kw = (("max_neighbors", 8), ("method", method))
    ref = _jax(name, "full", kw)
    nm, num, sh = _call("torch", name, "full", **dict(kw))
    np.testing.assert_array_equal(num.numpy(), ref[1])
    assert int(num.max()) > 8
    full_nm, full_num, full_sh = _call("torch", name, "full",
                                       max_neighbors=160, method=method)
    for kept, every in zip(_rows(nm, sh, n), _rows(full_nm, full_sh, n)):
        assert kept <= every and len(kept) == min(len(every), 8)
    with pytest.raises(tnl.NeighborOverflowError):
        tnl.assert_max_neighbors(nm, num)
    tnl.assert_max_neighbors(full_nm, full_num)


@pytest.mark.parametrize("pbc", ["full", "mixed", "none"])
def test_cell_list_build_equals_jax(pbc):
    pos, cell = _system("tri")
    p = np.array(PBCS[pbc])
    cells, radius = jnl.estimate_cell_list_sizes(jnp.asarray(cell), p,
                                                 CUTOFF)
    tcells, tradius = tnl.estimate_cell_list_sizes(torch.as_tensor(cell), p,
                                                   CUTOFF)
    assert tcells == cells
    np.testing.assert_array_equal(tradius.numpy(), np.asarray(radius))
    ref = jnl.build_cell_list(jnp.asarray(pos), CUTOFF, jnp.asarray(cell),
                              p, cells)
    out = tnl.build_cell_list(torch.as_tensor(pos), CUTOFF,
                              torch.as_tensor(cell), p, cells)
    for f in tnl.CellList._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    # the JAX build carried over, queried by the port: JAX's query rows
    cl = interop.cell_list_from_numpy(
        {f: np.asarray(getattr(ref, f)) for f in ref._fields}, device="cpu")
    r = tuple(int(v) for v in np.asarray(radius))
    jq = jnl.query_cell_list(jnp.asarray(pos), CUTOFF, jnp.asarray(cell), p,
                             ref, r, 24, 160)
    tq = tnl.query_cell_list(torch.as_tensor(pos), CUTOFF,
                             torch.as_tensor(cell), p, cl, r, 24, 160)
    _check_matrix(tuple(np.asarray(a) for a in jq), tq, 120)


def test_batch_cell_list_build_equals_jax():
    pos, cells = _system("batch")
    pbc = np.array([[True] * 3, [True, False, True], [False] * 3])
    stride, total, radius = jnl.estimate_batch_cell_list_sizes(
        jnp.asarray(cells), pbc, CUTOFF)
    ts, tt, tr = tnl.estimate_batch_cell_list_sizes(torch.as_tensor(cells),
                                                    pbc, CUTOFF)
    assert (ts, tt) == (stride, total)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(radius))
    ref = jnl.batch_build_cell_list(jnp.asarray(pos), CUTOFF,
                                    jnp.asarray(cells), pbc,
                                    jnp.asarray(BATCH_IDX), stride)
    out = tnl.batch_build_cell_list(torch.as_tensor(pos), CUTOFF,
                                    torch.as_tensor(cells), pbc,
                                    torch.as_tensor(BATCH_IDX), stride)
    for f in tnl.BatchCellList._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    cl = interop.batch_cell_list_from_numpy(
        {f: np.asarray(getattr(ref, f)) for f in ref._fields}, device="cpu")
    r = tuple(int(v) for v in np.asarray(radius).max(0))
    jq = jnl.batch_query_cell_list(jnp.asarray(pos), CUTOFF,
                                   jnp.asarray(cells), pbc,
                                   jnp.asarray(BATCH_IDX), ref, stride, r,
                                   24, 96, half_fill=True)
    tq = tnl.batch_query_cell_list(torch.as_tensor(pos), CUTOFF,
                                   torch.as_tensor(cells), pbc,
                                   torch.as_tensor(BATCH_IDX), cl, stride,
                                   r, 24, 96, half_fill=True)
    _check_matrix(tuple(np.asarray(a) for a in jq), tq, 120)


def test_simple_cubic_crystal_has_18_neighbors():
    """a = 3.0 A, cutoff 4.5 A: 6 neighbors at 3.0 A and 12 at 4.24 A; the
    half-filled lists hold exactly 9 N pairs; naive and cell list agree."""
    n_rep, a = 6, 3.0
    grid = np.stack(np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"),
                    -1).reshape(-1, 3) * a
    pos = torch.as_tensor(grid, dtype=torch.float64)
    cell = torch.eye(3, dtype=torch.float64) * n_rep * a
    pbc = np.array([True] * 3)
    rows = {}
    for method in ("naive", "cell_list"):
        nm, num, sh = tnl.neighbor_list(pos, 4.5, cell=cell, pbc=pbc,
                                        method=method, max_neighbors=32)
        assert (num == 18).all()
        rows[method] = _rows(nm, sh, pos.shape[0])
        _, half, _ = tnl.neighbor_list(pos, 4.5, cell=cell, pbc=pbc,
                                       method=method, max_neighbors=32,
                                       half_fill=True)
        assert int(half.sum()) == 9 * pos.shape[0]
    assert rows["naive"] == rows["cell_list"]


def test_dispatcher_rejects_unknown_method():
    pos, cell = _system("tri")
    with pytest.raises(ValueError, match="Invalid method"):
        tnl.neighbor_list(torch.as_tensor(pos), CUTOFF,
                          cell=torch.as_tensor(cell),
                          pbc=np.array([True] * 3), method="octree")


def test_capacity_estimate_matches_jax():
    for cutoff in (0.0, 3.5, 9.6):
        for density, safety in ((0.35, 5.0), (0.03, 2.0)):
            assert tnl.estimate_max_neighbors(cutoff, density, safety) == \
                jnl.estimate_max_neighbors(cutoff, density, safety)


@pytest.mark.parametrize("moved", [0.0, 0.05, 0.8])
def test_rebuild_detectors_match_jax(moved):
    pos, cell = _system("tri")
    p = np.array(PBCS["mixed"])
    cells, _ = jnl.estimate_cell_list_sizes(jnp.asarray(cell), p, CUTOFF)
    ref = jnl.build_cell_list(jnp.asarray(pos), CUTOFF, jnp.asarray(cell),
                              p, cells)
    new = pos + np.random.default_rng(14).uniform(-moved, moved, pos.shape)
    cl = tnl.build_cell_list(torch.as_tensor(pos), CUTOFF,
                             torch.as_tensor(cell), p, cells)
    want = bool(np.asarray(jnl.cell_list_needs_rebuild(
        jnp.asarray(new), ref.atom_to_cell_mapping, ref.cells_per_dimension,
        jnp.asarray(cell), p))[0])
    got = tnl.cell_list_needs_rebuild(
        torch.as_tensor(new), cl.atom_to_cell_mapping,
        cl.cells_per_dimension, torch.as_tensor(cell), p)
    assert got.shape == (1,) and bool(got[0]) == want
    assert tnl.check_cell_list_rebuild_needed(
        *cl, torch.as_tensor(new), torch.as_tensor(cell), p,
        CUTOFF) == want
    for skin in (0.1, 1.0):
        want_nl = jnl.check_neighbor_list_rebuild_needed(
            jnp.asarray(pos), jnp.asarray(new), skin)
        assert tnl.check_neighbor_list_rebuild_needed(
            torch.as_tensor(pos), torch.as_tensor(new), skin) == want_nl
        assert bool(tnl.neighbor_list_needs_rebuild(
            torch.as_tensor(pos), torch.as_tensor(new), skin)[0]) == want_nl
    if moved == 0.0:
        assert not want
